"""Ulysses-style sequence parallelism: all-to-all context parallelism.

The counterpart of ``accl_tpu/models/ulysses_attention.py``: two
all-to-alls re-shard q/k/v from sequence-sharded (every rank T / P
timesteps of all H heads) to head-sharded (H / P heads of the full
sequence), each rank runs dense attention over its heads, and a third
all-to-all brings the output back to sequence shards.  As in
:mod:`.ring_attention`, the ranks are a list of per-rank tensors on one
device (``lax.axis_size`` is ``len(qs)``).

The re-shard is the tiled ``lax.all_to_all`` in plain PyTorch by default,
or row 12's kernel (``accl_tpu_torch.ops.cuda.alltoall``) with
``use_pallas_alltoall=True``: four launches a call on CUDA tensors.
Requires ``H % P == 0``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.cuda.alltoall import alltoall
from .ring_attention import reference_attention

Ranks = Sequence[torch.Tensor]


def _a2a(xs: Ranks, split: int, concat: int) -> List[torch.Tensor]:
    """``lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)`` over the ranks: each rank's operand is cut into P
    chunks along ``split``; rank r gets every rank's chunk r,
    concatenated along ``concat`` in rank order."""
    P = len(xs)
    chunks = [torch.chunk(x, P, dim=split) for x in xs]
    return [torch.cat([c[r] for c in chunks], dim=concat) for r in range(P)]


def _a2a_pallas(xs: Ranks, split: int, concat: int) -> List[torch.Tensor]:
    """The same re-shard through row 12 (``_a2a_pallas`` :48): move the
    split axis to the front, flatten, block-transpose, reshape, move the
    axis back, then stitch the P blocks along the concat axis."""
    P = len(xs)
    moved = [torch.movedim(x, split, 0) for x in xs]
    flat = [t.reshape(t.shape[0], -1) for t in moved]
    outs = alltoall(flat)
    res = []
    for o, t in zip(outs, moved):
        # block p (along dim 0) is rank p's block for this rank
        o = torch.movedim(o.reshape(t.shape), 0, split)
        res.append(torch.cat(torch.chunk(o, P, dim=split), dim=concat))
    return res


def ulysses_attention(qs: Ranks, ks: Ranks, vs: Ranks, causal: bool = True,
                      *, use_pallas_alltoall: bool = False
                      ) -> List[torch.Tensor]:
    """Attention over the full sequence with q/k/v sequence-sharded
    (``ulysses_attention`` :65): qs[r], ks[r], vs[r] are rank r's
    ``(B, H, T_local, D)`` shards, contiguous in rank order; returns one
    ``(B, H, T_local, D)`` output per rank.  H must divide by P.  The
    ranks' dense attention runs one rank after another (each holds a
    (B, H / P, T, T) float32 score tensor)."""
    P = len(qs)
    if len(ks) != P or len(vs) != P:
        raise ValueError(f"{P} q shards but {len(ks)} k and {len(vs)} v")
    H = qs[0].shape[1]
    if H % P:
        raise ValueError(f"heads {H} not divisible by axis size {P}")
    if P == 1:
        return [reference_attention(qs[0], ks[0], vs[0], causal=causal)]
    a2a = _a2a_pallas if use_pallas_alltoall else _a2a
    # seq-sharded (H, T/P) -> head-sharded (H/P, T): split heads, gather seq
    qh, kh, vh = (a2a(t, 1, 2) for t in (qs, ks, vs))
    oh = [reference_attention(q, k, v, causal=causal)
          for q, k, v in zip(qh, kh, vh)]
    # head-sharded -> seq-sharded: split seq, gather heads
    return a2a(oh, 2, 1)
