"""accl_tpu_torch.utils: timing, leveled logging, platform selection and
the profiler hooks — the counterpart of ``accl_tpu/utils``, with the
same names."""

from .timing import Timer  # noqa: F401
from .logging import Log, LogLevel  # noqa: F401
from .platform import mirror_platform_env  # noqa: F401
from .profiling import (  # noqa: F401
    annotate,
    device_memory_profile,
    device_scope,
    start_server,
    trace,
)
