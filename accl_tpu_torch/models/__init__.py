"""accl_tpu_torch.models: the transformer LM on one device — forward,
prefill, KV-cache generate, the loss and the SGD train step — the
counterpart of ``accl_tpu/models/transformer.py`` at tp = 1."""

from .transformer import (  # noqa: F401
    TransformerConfig,
    forward,
    generate,
    init_params,
    loss_fn,
    make_sharded_train_step,
    params_from_numpy,
    params_to_numpy,
    prefill,
)
