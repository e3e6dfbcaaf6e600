"""Collective primitives over ranks that share one process — the ``xla``
lowering.

The counterpart of ``accl_tpu/ops/collectives.py``.  There XLA's
collectives (psum, psum_scatter, all_gather) run inside ``shard_map``;
here each function takes every rank's operand at once (a sequence of
per-rank tensors) and returns one result tensor per rank, in plain
PyTorch.  XLA's TPU kernels for these are the compiler's, not the
repository's, so none of them has a hand-written kernel in the port.
Reductions fold in rank order, which need not be XLA's order: results
agree with the JAX package to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..arithconfig import reduce_op
from ..constants import ReduceFunction, as_datatype
from ..wire import dropped_mantissa_bits, is_scaled
from .cuda.compression import cast_rows
from .wire import wire_lane_roundtrip_rows


def _fold(xs: Sequence[torch.Tensor], function: ReduceFunction) -> torch.Tensor:
    op = reduce_op(function)
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x)
    return acc if len(xs) > 1 else acc.clone()


def allreduce(xs: Sequence[torch.Tensor],
              function: ReduceFunction = ReduceFunction.SUM
              ) -> List[torch.Tensor]:
    """ref ``ACCL::allreduce`` — every rank gets the reduction."""
    full = _fold(xs, function)
    return [full.clone() for _ in xs]


def _zeros_like(t: torch.Tensor) -> torch.Tensor:
    """A zero tensor of ``t``'s shape that allocates no memory (a
    stride-0 view): copying it out writes zeros, discarding it costs
    nothing."""
    return t.new_zeros(()).expand(t.shape)


def reduce(xs: Sequence[torch.Tensor], root: int = 0,
           function: ReduceFunction = ReduceFunction.SUM
           ) -> List[torch.Tensor]:
    """ref ``ACCL::reduce`` — the full reduction on ``root``, zeros
    elsewhere (the JAX lowering's stand-in for a non-root DummyBuffer)."""
    full = _fold(xs, function)
    return [full if r == root else _zeros_like(full) for r in range(len(xs))]


def reduce_scatter(xs: Sequence[torch.Tensor],
                   function: ReduceFunction = ReduceFunction.SUM
                   ) -> List[torch.Tensor]:
    """ref ``ACCL::reduce_scatter`` — rank i gets block i of the
    reduction along the leading axis (which must divide by the rank
    count)."""
    size = len(xs)
    if xs[0].shape[0] % size:
        raise ValueError(
            f"reduce_scatter: leading length {xs[0].shape[0]} is not "
            f"divisible by {size} ranks"
        )
    full = _fold(xs, function)
    return [b.clone() for b in full.chunk(size)]


def allgather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """ref ``ACCL::allgather`` — every rank's block, concatenated."""
    full = torch.cat(list(xs))
    return [full.clone() for _ in xs]


def bcast(xs: Sequence[torch.Tensor], root: int = 0) -> List[torch.Tensor]:
    """ref ``ACCL::bcast`` — root's block everywhere."""
    return [xs[root].clone() for _ in xs]


def _blocks(x: torch.Tensor, size: int, what: str) -> List[torch.Tensor]:
    if x.shape[0] % size:
        raise ValueError(
            f"{what}: leading length {x.shape[0]} is not divisible by "
            f"{size} ranks"
        )
    return list(x.chunk(size))


def scatter(xs: Sequence[torch.Tensor], root: int = 0) -> List[torch.Tensor]:
    """ref ``ACCL::scatter`` — rank r gets block r of the root's operand
    (the other ranks' operands are not read)."""
    return [b.clone() for b in _blocks(xs[root], len(xs), "scatter")]


def gather(xs: Sequence[torch.Tensor], root: int = 0) -> List[torch.Tensor]:
    """ref ``ACCL::gather`` — every rank's block, concatenated in rank
    order, on ``root``; zeros elsewhere."""
    full = torch.cat(list(xs))
    return [full if r == root else _zeros_like(full) for r in range(len(xs))]


def alltoall(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """ref ``ACCL::alltoall`` — block transpose: rank r's block p is rank
    p's block r."""
    size = len(xs)
    blocks = [_blocks(x, size, "alltoall") for x in xs]
    return [torch.cat([blocks[p][r] for p in range(size)])
            for r in range(size)]


def compressed_allreduce(
    xs: Sequence[torch.Tensor],
    wire_dtype: torch.dtype = torch.bfloat16,
    function: ReduceFunction = ReduceFunction.SUM,
) -> List[torch.Tensor]:
    """Allreduce with operands narrowed to ``wire_dtype`` on the wire.

    The f16 / bf16 lanes reduce in the wire dtype and the reduced block
    is widened (its trip back to every rank through the wire is exact:
    it already holds wire values).  The fp8 lanes (20+ dropped mantissa
    bits) and the scaled int8 lane round each CONTRIBUTION through the
    wire once, then reduce in the operand dtype, as the JAX program and
    the command ring's decode loop do; the rounding is deterministic
    (the JAX program carries no per-call seed).  On the card the casts
    are row 5, the fp8 narrowing row 6 at seed 0, the int8 lane rows
    7-8, each one launch for all ranks."""
    dt = as_datatype(wire_dtype)
    if is_scaled(dt) or (dropped_mantissa_bits(dt) or 0) >= 20:
        return allreduce(wire_lane_roundtrip_rows(xs, dt), function)
    orig = xs[0].dtype
    narrow = cast_rows(xs, wire_dtype)
    full = cast_rows([_fold(narrow, function)], orig)[0]
    return [full.clone() for _ in xs]
