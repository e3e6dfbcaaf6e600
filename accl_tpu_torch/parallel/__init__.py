"""accl_tpu_torch.parallel: ZeRO-1 Adam over virtual dp ranks on one
device — the counterpart of ``accl_tpu/parallel/zero.py`` as
``accl_tpu/parallel/__init__.py:15-23`` exports it.  The JAX package's
topology and multi-host modules come with the platform and multi-process
tiers (ROADMAP A7, A6)."""

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
