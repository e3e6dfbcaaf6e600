"""accl_tpu_torch.parallel: the topology bootstrap, the multi-host meshes
and ZeRO-1 Adam over virtual dp ranks on one device — the counterpart of
``accl_tpu/parallel``, exporting the same names."""

from .topology import (  # noqa: F401
    Design,
    bootstrap,
    device_memory_report,
    generate_ranks,
    mesh_from_topology,
)
from .multihost import (  # noqa: F401
    MultihostContext,
    bootstrap_multihost,
    dp_over_dcn_mesh,
    hybrid_mesh,
)
from .zero import (  # noqa: F401
    AdamConfig,
    clip_by_global_norm,
    init_zero_state,
    make_zero_train_step,
    reshard_plan,
    schedule_lr,
    zero_adam_update,
    zero_state_specs,
)
