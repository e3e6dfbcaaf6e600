"""accl_tpu_torch — the collective library of ``accl_tpu`` ported to
PyTorch and hand-written CUDA kernels for an NVIDIA H100.

The JAX package ``accl_tpu`` is the reference; this package imports
nothing of it (nor JAX).  Entry points run on the card unless the caller
asks for the CPU: ``cuda_group(4)`` builds four rank handles whose buffers
share the current CUDA device, ``cuda_group(4, device="cpu")`` runs the
same path on the CPU with each kernel's plain PyTorch version.
"""

from .buffer import DeviceBuffer, DummyBuffer  # noqa: F401
from .constants import (  # noqa: F401
    ACCLError,
    AllreduceAlgorithm,
    DataType,
    ErrorCode,
    ReduceFunction,
    TuningKey,
)
from .core import ACCL, cuda_group  # noqa: F401
from .request import Request  # noqa: F401
