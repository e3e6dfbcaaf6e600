"""Blockwise online-softmax attention, the XLA tile fold.

The counterpart of ``accl_tpu/ops/attention.py::blockwise_attention``
(:102): attention as a fold of (block_q x block_k) tiles with the running
(max, denominator, numerator) state of online softmax, so no (T, T)
score matrix is formed.  The same fold as the flash kernel's plain
version (``ops/cuda/attention.py::online_softmax_fold``), with this
function's own block sizes, padding rule and GQA expansion.  Plain
PyTorch on any device: in the JAX package this lowering is XLA's, not a
Pallas kernel's.
"""

from __future__ import annotations

import torch

from .cuda.attention import online_softmax_fold


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_q: int = 256,
                        block_k: int = 256) -> torch.Tensor:
    """Causal (or full) attention over ``(B, H, T, Dh)`` operands without
    materializing the (T, T) score matrix; exact, not approximate.

    Grouped-query attention: k/v may carry fewer heads (``H % Hkv ==
    0``); they are expanded per group before the fold, as the JAX form
    expands them.  The key tile is the JAX form's: ``block_k`` clamped to
    T, or the whole padded sequence where the blocks do not divide it.
    Every query block folds every key tile there, so folding all query
    rows at once is the same computation; the padded keys the JAX form
    masks are cut off instead."""
    B, H, T, Dh = q.shape
    Hkv = k.shape[1]
    if Hkv != H:
        if Hkv <= 0 or H % Hkv:
            raise ValueError(
                f"q heads ({H}) must be a multiple of kv heads ({Hkv})"
            )
        G = H // Hkv
        k = k[:, :, None].expand(B, Hkv, G, T, Dh).reshape(B, H, T, Dh)
        v = v[:, :, None].expand(B, Hkv, G, T, Dh).reshape(B, H, T, Dh)
    if T == 0:
        return q.clone()
    bq, bk = min(block_q, T), min(block_k, T)
    Tp = T + (-T) % max(bq, bk)
    if Tp % min(bk, Tp):
        bk = Tp  # tiny sequences: a single tile
    out, _ = online_softmax_fold(q, k, v, causal, min(bk, Tp))
    return out
