"""accl_tpu_torch.models: the transformer LM's single-device serving path
(forward, prefill, KV-cache generate), the counterpart of
``accl_tpu/models/transformer.py`` at tp = 1."""

from .transformer import (  # noqa: F401
    TransformerConfig,
    forward,
    generate,
    init_params,
    params_from_numpy,
    prefill,
)
