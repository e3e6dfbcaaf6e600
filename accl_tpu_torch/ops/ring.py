"""The explicit segmented ring pipeline — the ``ring`` lowering.

The counterpart of ``accl_tpu/ops/ring.py``, whose ppermute pipeline is
XLA's to compile (no Pallas kernel).  Here it is plain PyTorch over the
per-rank operands, with the reference's block layout and fold order:
``num_segments`` zero-padded segments of ``ceil(n / S)`` elements, each
cut into P blocks of ``ceil(seg / P)``; block b is folded along the ring
starting at rank b+1, ``op(received, local)`` at every hop, and relayed
to every rank unchanged.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..arithconfig import reduce_op
from ..constants import ReduceFunction


def ring_reduce_scatter(xs: Sequence[torch.Tensor],
                        function: ReduceFunction = ReduceFunction.SUM
                        ) -> List[torch.Tensor]:
    """P-1 recv-reduce-send hops; rank i ends with reduced block i of the
    operand zero-padded to P equal blocks."""
    size = len(xs)
    op = reduce_op(function)
    n = xs[0].shape[0]
    block = -(-n // size)
    padded = []
    for x in xs:
        p = torch.zeros(block * size, dtype=x.dtype, device=x.device)
        p[:n] = x
        padded.append(p.view(size, block))
    out = []
    for b in range(size):
        r = (b + 1) % size
        acc = padded[r][b]
        for _ in range(1, size):
            r = (r + 1) % size
            acc = op(acc, padded[r][b])
        out.append(acc.clone())
    return out


def ring_allgather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Store-and-relay: every rank ends with all blocks in rank order."""
    full = torch.cat(list(xs))
    return [full.clone() for _ in xs]


def ring_allreduce(xs: Sequence[torch.Tensor],
                   function: ReduceFunction = ReduceFunction.SUM,
                   num_segments: int = 1) -> List[torch.Tensor]:
    """Segmented ring allreduce = ring reduce-scatter + ring allgather,
    each segment an independent ring."""
    size = len(xs)
    n = xs[0].shape[0]
    if size == 1:
        return [xs[0].clone()]
    seg = max(-(-n // num_segments), 1)
    outs = [torch.empty_like(x) for x in xs]
    for lo in range(0, n, seg):
        hi = min(lo + seg, n)
        # every segment is padded to the same width, as the reference's
        part = [torch.nn.functional.pad(x[lo:hi], (0, seg - (hi - lo)))
                for x in xs]
        full = ring_allgather(ring_reduce_scatter(part, function))[0]
        for o in outs:
            o[lo:hi] = full[:hi - lo]
    return outs
