"""The hand-written CUDA kernel tier — the counterpart of
``accl_tpu/ops/pallas``.

* ``combine`` — K4, the reduce_ops arithmetic plugin (elementwise SUM/MAX
  with an optional result cast, in place or not).
* ``ring`` — K1-K3, the segmented ring allreduce, reduce-scatter and
  allgather over ranks that share one device.
* ``rooted`` — rows 9-11, the rooted ring relays (bcast, reduce,
  scatter), and the rooted gather over K3.
* ``cmdring`` — row 14, the command-ring sequencer: one launch runs a
  window of collectives whose slot words it decodes on the device.
* ``attention`` — rows 16-18, the single-device flash attention: the
  forward (the transformer's ``attention="flash"`` lowering) and the
  backward's delta pass and dQ and dK/dV kernels behind its
  ``torch.autograd.Function``.
* ``compression`` — rows 5-8, the wire compression kernels (cast,
  stochastic cast, int8 quantize and dequantize) under the compressed
  collectives' wire lanes, the error feedback and ``ring.int8_allreduce``.
* ``put`` — row 13, the fused compute-and-put (``fused_shift``: every
  rank's ``compute(x)`` stored into the rank ``distance`` away, one
  launch), the kernel of ``examples.vadd_put.vadd_put_kernel``.
* ``probe`` — row 19, the copy kernel behind ``accl_tpu_torch.compat``'s
  kernel-load probe.
* ``alltoall`` — row 12, the all-to-all block transpose across P ranks
  (``models.ulysses_attention``'s ``use_pallas_alltoall`` re-shard).
* ``attention.ring_attention`` — row 15, ring attention's forward over P
  ranks, contiguous or striped shards (``models.ring_attention_pallas``).

Kernels are built from ``accl_tpu_torch/csrc`` on first use
(:func:`build_all` builds them all at once).  Every wrapper takes its
plain PyTorch version for CPU tensors and launches its kernel for CUDA
tensors, counting launches in ``<wrapper>.launches``.
"""

from ._build import build_all  # noqa: F401
from .alltoall import alltoall, alltoall_plain  # noqa: F401
from .attention import (  # noqa: F401
    flash_attention,
    flash_attention_bwd_delta,
    flash_attention_bwd_delta_plain,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_plain,
    ring_attention,
    ring_attention_plain,
)
from .cmdring import sequencer, sequencer_plain  # noqa: F401
from .combine import combine, combine_plain  # noqa: F401
from .compression import (  # noqa: F401
    cast,
    cast_plain,
    cast_rows,
    dequantize_int8,
    dequantize_plain,
    dequantize_rows,
    quantize_int8,
    quantize_plain,
    quantize_rows,
    stochastic_cast_plain,
    stochastic_cast_rows,
)
from .probe import probe_copy, probe_copy_plain  # noqa: F401
from .put import Add, Mul, fused_shift, fused_shift_plain  # noqa: F401
from .ring import (  # noqa: F401
    int8_allreduce,
    ring_allgather,
    ring_allgather_plain,
    ring_allreduce,
    ring_allreduce_plain,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
)
from .rooted import (  # noqa: F401
    ring_bcast,
    ring_bcast_plain,
    ring_gather,
    ring_gather_plain,
    ring_reduce,
    ring_reduce_plain,
    ring_scatter,
    ring_scatter_plain,
)

#: every kernel wrapper of the tier (each carries a ``launches`` counter;
#: ``ring_gather`` counts K3's root-only kernel, and its all-rank tables
#: count under ``ring_allgather``)
KERNELS = {
    "ring_allreduce": ring_allreduce,
    "ring_reduce_scatter": ring_reduce_scatter,
    "ring_allgather": ring_allgather,
    "ring_gather": ring_gather,
    "combine": combine,
    "ring_bcast": ring_bcast,
    "ring_reduce": ring_reduce,
    "ring_scatter": ring_scatter,
    "sequencer": sequencer,
    "flash_attention": flash_attention,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "flash_attention_bwd_delta": flash_attention_bwd_delta,
    "cast": cast_rows,
    "stochastic_cast": stochastic_cast_rows,
    "quantize_int8": quantize_rows,
    "dequantize_int8": dequantize_rows,
    "fused_shift": fused_shift,
    "probe_copy": probe_copy,
    "alltoall": alltoall,
    "ring_attention": ring_attention,
}
