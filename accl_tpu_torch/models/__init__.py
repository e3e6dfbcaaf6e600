"""accl_tpu_torch.models: the transformer LM on one device — forward,
prefill, KV-cache generate, the loss and the SGD train step — the
counterpart of ``accl_tpu/models/transformer.py`` at tp = 1; and the
sequence-parallel attention over P ranks on one device (ring, striped and
Ulysses attention, and row 15's kernel as ``ring_attention_pallas``), the
counterpart of ``accl_tpu/models/__init__.py:23-33``."""

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
from .ring_attention import (  # noqa: F401
    reference_attention,
    ring_attention,
    stripe_sequence,
    striped_attention,
    unstripe_sequence,
)
from ..ops.cuda.attention import (  # noqa: F401
    ring_attention as ring_attention_pallas,
)
from .ulysses_attention import ulysses_attention  # noqa: F401
