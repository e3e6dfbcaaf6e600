"""Rows 9-11: the rooted ring relays over ranks that share one device —
bcast, reduce and scatter — and the rooted gather over K3.

The counterpart of ``accl_tpu/ops/pallas/rooted.py``.  Where the JAX
entry points run inside ``shard_map`` on one rank's shard, these take
every rank's operand at once (per-rank tensors, each its own allocation)
and return one result per rank.  The bcast and reduce kernels
(``csrc/rooted.cu``) reach the ranks through the per-rank pointer table
of inputs and outputs.  The two rooted copies take one side of it alone,
with the root's side a plain pointer: ``ring_gather`` is K3's root-only
form (``csrc/ring.cu``'s ``accl_ring_gather_root``: the ranks' inputs in
a table, the root's output its one output pointer, so only the root's
result is written), and ``ring_scatter`` its mirror (the root's operand
the one input pointer, the ranks' outputs in a table; only the root's
operand is read).  Both copy on the streaming tile core
(``csrc/common.cuh``) and decide per rank whether its block and output
are 16-byte aligned, so a misaligned rank takes the scalar path alone.

The relays fold ELEMENTWISE: no element's value depends on the block or
segment it lies in, so neither ``num_segments`` nor the TPU's lane
packing (``pack_lanes``) changes any value.  The wrappers keep and
validate ``num_segments`` for the JAX signatures but need no ``ring_len``
partition.  Only the reduce has a fold order: the rank at root-distance
``rel`` ends with ``op(x_rel, partial_{rel+1})``, so the root holds
``op(x_root, op(x_root+1, ... x_root+P-1))`` and every other rank its
suffix partial, as the JAX kernel leaves them.

Each ``*_plain`` function is the kernel's plain PyTorch version, walking
the same hop schedule with the same fold order; CPU tensors take it, and
the card's checks compare against it.  An ``out`` entry of None (reduce
and gather) is a rank that takes no result: no kernel writes it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ...arithconfig import reduce_op
from ...constants import ReduceFunction, torch_to_dtype
from . import _build
from ._build import INT, LL, PTR
from ._common import (
    LaunchCounter,
    aligned16,
    check_launch,
    on_cuda,
    overlaps,
    pointer_table,
    pointers,
    stream_of,
)
from .ring import _flat, _kernel_dtype, _outputs, _vec, ring_allgather
from .ring import _lib as ring_lib

#: ``csrc/rooted.cu``'s C prototypes (declared once, at load)
PROTOTYPES = {"rooted": {
    "accl_ring_bcast": (PTR, PTR, INT, INT, LL, INT, INT, PTR),
    "accl_ring_reduce": (PTR, PTR, INT, INT, LL, INT, INT, INT, PTR),
    "accl_ring_scatter": (PTR, PTR, INT, LL, INT, PTR),
}}


def _lib():
    return _build.library("rooted", PROTOTYPES["rooted"])


def _check(P: int, root: int, num_segments: int, what: str) -> None:
    if not 0 <= root < P:
        raise ValueError(f"{what}: root {root} outside 0..{P - 1}")
    if num_segments < 1:
        raise ValueError("num_segments must be >= 1")


def _refuse_aliases(outs, reads, what: str) -> None:
    """Refuse an output that shares memory with an operand the kernel
    reads (``reads``: (rank, tensor) pairs), unless it IS that rank's own
    operand (in place)."""
    for q, o in enumerate(outs):
        if o is None:
            continue
        for p, x in reads:
            same = (p == q and o.data_ptr() == x.data_ptr()
                    and o.numel() == x.numel())
            if not same and overlaps(o, x):
                raise ValueError(
                    f"{what}: out[{q}] overlaps rank {p}'s operand"
                )


def _scatter_block(flat, P: int) -> int:
    total = flat[0].numel()
    if total % P:
        raise ValueError(
            f"ring_scatter: operand of {total} elements is not divisible "
            f"by {P} ranks"
        )
    return total // P


# ---------------------------------------------------------------------------
# row 9: bcast
# ---------------------------------------------------------------------------


def ring_bcast_plain(xs: Sequence[torch.Tensor], root: int = 0,
                     num_segments: int = 1) -> List[torch.Tensor]:
    """The relay of row 9: the root's payload reaches root-distance d at
    hop d, and every rank keeps it."""
    flat = _flat(xs, "ring_bcast")
    P = len(flat)
    _check(P, root, num_segments, "ring_bcast")
    outs = [None] * P
    for d in range(1, P + 1):  # relay order, the root last
        outs[(root + d) % P] = flat[root].clone().reshape(xs[0].shape)
    return outs


def ring_bcast(
    xs: Sequence[torch.Tensor],
    root: int = 0,
    num_segments: int = 1,
    *,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Every rank gets the root's operand.  ``out`` may be ``xs`` itself
    (the facade's in-place form): the root's buffer is then never written
    and the other ranks' operands are not read.  An ``out`` entry that
    overlaps the root's operand otherwise is refused."""
    flat = _flat(xs, "ring_bcast")
    P, n = len(flat), flat[0].numel()
    _check(P, root, num_segments, "ring_bcast")
    outs = _outputs(flat, out, n, "ring_bcast")
    src = flat[root]
    _refuse_aliases(outs, [(root, src)], "ring_bcast")
    if not on_cuda(flat + outs):
        for o, r in zip(outs, ring_bcast_plain(flat, root, num_segments)):
            o.copy_(r)
        return [o.reshape(xs[0].shape) for o in outs]
    # in place, the root's buffer already holds the payload
    dst = [None if q == root and o.data_ptr() == src.data_ptr() else o
           for q, o in enumerate(outs)]
    if n and any(d is not None for d in dst):
        lib = _lib()
        esize = src.element_size()
        pin, pout = pointers(flat), pointers(dst)
        rc = lib.accl_ring_bcast(
            pointer_table(pin), pointer_table(pout), P, root, n, esize,
            int(aligned16([pin[root]] + pout) and (n * esize) % 16 == 0),
            stream_of(src.device),
        )
        check_launch(lib, rc, "ring_bcast")
        ring_bcast.launches.bump()
    return [o.reshape(xs[0].shape) for o in outs]


ring_bcast.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# row 10: reduce
# ---------------------------------------------------------------------------


def ring_reduce_plain(
    xs: Sequence[torch.Tensor],
    root: int = 0,
    function: ReduceFunction = ReduceFunction.SUM,
    num_segments: int = 1,
) -> List[torch.Tensor]:
    """The relay of row 10: the partial starts at root-distance P-1 and
    each rank toward the root folds ``op(own, incoming)``; every rank
    keeps its partial."""
    flat = _flat(xs, "ring_reduce")
    P = len(flat)
    _check(P, root, num_segments, "ring_reduce")
    op = reduce_op(function)
    outs = [None] * P
    r = (root + P - 1) % P
    acc = flat[r].clone()
    outs[r] = acc
    for rel in range(P - 2, -1, -1):
        r = (root + rel) % P
        acc = op(flat[r], acc)
        outs[r] = acc
    return [o.reshape(xs[0].shape) for o in outs]


def ring_reduce(
    xs: Sequence[torch.Tensor],
    root: int = 0,
    function: ReduceFunction = ReduceFunction.SUM,
    num_segments: int = 1,
    *,
    out: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> List[Optional[torch.Tensor]]:
    """Reduce toward ``root``: the root's result is the full reduction,
    every other rank's its partial (the JAX kernel's).  With ``out``
    None every rank's result is allocated; a None ``out`` entry takes no
    result (the facade names the root's alone).  ``out[r]`` may be
    ``xs[r]`` (in place)."""
    flat = _flat(xs, "ring_reduce")
    P, n, dtype = len(flat), flat[0].numel(), flat[0].dtype
    _check(P, root, num_segments, "ring_reduce")
    reduce_op(function)
    outs = _outputs(flat, out, n, "ring_reduce", optional=True)
    _refuse_aliases(outs, list(enumerate(flat)), "ring_reduce")
    if not on_cuda(flat + outs):
        res = ring_reduce_plain(flat, root, function, num_segments)
        for o, r in zip(outs, res):
            if o is not None:
                o.copy_(r)
    elif n and any(o is not None for o in outs):
        _kernel_dtype(dtype, "ring_reduce")
        lib = _lib()
        pin, pout = pointers(flat), pointers(outs)
        rc = lib.accl_ring_reduce(
            pointer_table(pin), pointer_table(pout), P, root, n,
            int(torch_to_dtype(dtype)), int(function),
            _vec(pin + pout, n, dtype), stream_of(flat[0].device),
        )
        check_launch(lib, rc, "ring_reduce")
        ring_reduce.launches.bump()
    return [None if o is None else o.reshape(xs[0].shape) for o in outs]


ring_reduce.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# row 11: scatter
# ---------------------------------------------------------------------------


def ring_scatter_plain(xs: Sequence[torch.Tensor], root: int = 0,
                       num_segments: int = 1) -> List[torch.Tensor]:
    """The relay of row 11: the root keeps its own block, then injects
    the others farthest-first (hop t carries the block of root-distance
    P-t)."""
    flat = _flat(xs, "ring_scatter")
    P = len(flat)
    _check(P, root, num_segments, "ring_scatter")
    n = _scatter_block(flat, P)
    src = flat[root]
    outs = [None] * P
    for t in range(P):
        q = (root + P - t) % P  # t = 0: the root's own block
        outs[q] = src[q * n:(q + 1) * n].clone()
    return outs


def ring_scatter(
    xs: Sequence[torch.Tensor],
    root: int = 0,
    num_segments: int = 1,
    *,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Rank r gets block r of the root's ``P * n`` operand (in JAX, root-
    distance d gets block ``(root + d) % P``: the same block).  Only the
    root's operand is read, so the other ranks may pass any tensor of the
    same shape (the engine passes the root's own)."""
    flat = _flat(xs, "ring_scatter")
    P = len(flat)
    _check(P, root, num_segments, "ring_scatter")
    n = _scatter_block(flat, P)
    outs = _outputs(flat, out, n, "ring_scatter")
    src = flat[root]
    _refuse_aliases(outs, [(root, src)], "ring_scatter")
    if not on_cuda(flat + outs):
        for o, r in zip(outs, ring_scatter_plain(flat, root, num_segments)):
            o.copy_(r)
    elif n:
        lib = _lib()
        rc = lib.accl_ring_scatter(
            src.data_ptr(), pointer_table(pointers(outs)), P, n,
            src.element_size(), stream_of(src.device),
        )
        check_launch(lib, rc, "ring_scatter")
        ring_scatter.launches.bump()
    return outs


ring_scatter.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# the rooted gather: K3, root only
# ---------------------------------------------------------------------------


def ring_gather_plain(xs: Sequence[torch.Tensor], root: int = 0,
                      num_segments: int = 1) -> List[Optional[torch.Tensor]]:
    """Every rank's block concatenated in rank order at the root; None
    for the other ranks."""
    flat = _flat(xs, "ring_gather")
    P = len(flat)
    _check(P, root, num_segments, "ring_gather")
    shape = (P * xs[0].shape[0],) + tuple(xs[0].shape[1:])
    full = torch.cat(flat).reshape(shape)
    return [full if r == root else None for r in range(P)]


def ring_gather(
    xs: Sequence[torch.Tensor],
    root: int = 0,
    num_segments: int = 1,
    *,
    out: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> List[Optional[torch.Tensor]]:
    """Gather every rank's block to ``root`` through K3.  With ``out``
    None, or an ``out`` table that names the root alone (the facade's
    form), the root-only kernel writes the root's result (None for the
    other ranks); a table that names other ranks too writes each of them
    through the all-rank allgather, and must name the root."""
    P = len(xs)
    _check(P, root, num_segments, "ring_gather")
    if out is not None:
        out = list(out)
        if len(out) != P:
            raise ValueError(f"ring_gather: out must be {P} entries")
        if out[root] is None:
            raise ValueError("ring_gather: out[root] is None, the root "
                             "takes the result")
        if any(o is not None for r, o in enumerate(out) if r != root):
            return ring_allgather(xs, out=out)
    flat = _flat(xs, "ring_gather")
    x0, n = flat[0], flat[0].numel()
    shape = (P * xs[0].shape[0],) + tuple(xs[0].shape[1:])
    if out is None:
        res = torch.empty(shape, dtype=x0.dtype, device=x0.device)
    else:
        res = out[root]
        if (res.numel() != P * n or res.dtype != x0.dtype
                or not res.is_contiguous()):
            raise ValueError(f"ring_gather: out[root] must be a contiguous "
                             f"tensor of {P * n} {x0.dtype} elements")
    if not on_cuda(flat + [res]):
        res.reshape(-1).copy_(torch.cat(flat))  # ring_gather_plain's value
    elif n:
        lib = ring_lib()
        rc = lib.accl_ring_gather_root(
            pointer_table(pointers(flat)), res.data_ptr(), P, n,
            x0.element_size(), stream_of(x0.device),
        )
        check_launch(lib, rc, "ring_gather")
        ring_gather.launches.bump()
    outs: List[Optional[torch.Tensor]] = [None] * P
    outs[root] = res.reshape(shape)
    return outs


ring_gather.launches = LaunchCounter()
