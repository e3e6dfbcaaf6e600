"""accl_tpu_torch.models: the transformer LM on one device — forward,
prefill, KV-cache generate, the loss, the SGD train step and the sharded
forward and generate, with context and expert parallelism over virtual
ranks — the counterpart of ``accl_tpu/models/transformer.py`` at tp = 1
or a cp ring; the sequence-parallel attention over P ranks on one device
(ring, striped and Ulysses attention, and row 15's kernel as
``ring_attention_pallas``); the mixture-of-experts FFN
(``models/moe.py``) and the bidirectional encoder family
(``models/encoder.py``) — the counterpart of
``accl_tpu/models/__init__.py:12-42``.  The pipeline and composed
modules come with the next slice (ROADMAP A9d)."""

from .transformer import (  # noqa: F401
    TransformerConfig,
    forward,
    generate,
    init_params,
    loss_fn,
    make_sharded_forward,
    make_sharded_generate,
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
from .moe import init_moe_params, moe_ffn  # noqa: F401
from .encoder import (  # noqa: F401
    encode,
    encoder_forward,
    make_sharded_encoder_step,
    mlm_loss,
)
