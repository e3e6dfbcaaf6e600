"""K1-K3: the segmented ring collectives over ranks that share one device.

The counterpart of ``accl_tpu/ops/pallas/ring.py``.  Where the JAX entry
points run inside ``shard_map`` on one rank's shard, these take every
rank's operand at once — a sequence of per-rank tensors, each its own
allocation — and return one result tensor per rank.  The kernels
(``csrc/ring.cu``) reach the ranks through a table of per-rank pointers;
nothing is stacked or copied on the way in.

Each ``*_plain`` function is the kernel's plain PyTorch version: it walks
the same hop schedule block by block with the same fold order and wire
rounding points, so its float results equal the kernel's, and the JAX
kernel's, exactly.  ``int8_allreduce`` composes K3 with the quantize and
dequantize kernels (rows 7-8).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ...arithconfig import reduce_op
from ...constants import ReduceFunction, as_datatype, torch_to_dtype
from ...wire import astype, is_wire_dtype, widen
from . import _build
from . import compression as kcomp
from ._build import INT, LL, PTR
from ._common import (
    LANES,
    LaunchCounter,
    PreparedLaunch,
    aligned16,
    check_launch,
    check_ranks,
    on_cuda,
    pointer_table,
    pointers,
    ring_len,
    stream_of,
)

#: ``csrc/ring.cu``'s C prototypes (declared once, at load)
PROTOTYPES = {"ring": {
    "accl_ring_allreduce": (PTR, PTR, INT, LL, LL, LL, INT, INT, INT, INT,
                            PTR),
    "accl_ring_reduce_scatter": (PTR, PTR, INT, LL, LL, INT, INT, INT, PTR),
    "accl_ring_allgather": (PTR, PTR, INT, LL, INT, PTR),
    "accl_ring_gather_root": (PTR, PTR, INT, LL, INT, PTR),
}}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)


def _wire_round(v: torch.Tensor, wire) -> torch.Tensor:
    """``v`` through the wire dtype and back, as the JAX kernel's
    ``astype`` pair rounds it; the int8 lane is XLA's raw conversion
    (toward zero, saturating, NaN to 0) with no scale."""
    if wire is None:
        return v
    if wire == torch.int8:
        q = widen(v).trunc().clamp(-128, 127)
        return torch.where(torch.isnan(q), 0.0, q).to(v.dtype)
    return astype(astype(v, wire), v.dtype)


def _resolve_wire(dtype: torch.dtype, wire_dtype) -> Optional[torch.dtype]:
    """The hop payload's dtype: any registered wire lane on float
    operands, as the JAX kernel casts each hop's partial with ``astype``
    (int8 included: a raw cast, not the scaled lane)."""
    if wire_dtype is None or wire_dtype == dtype:
        return None  # no-op compression
    if not is_wire_dtype(as_datatype(wire_dtype)) or dtype not in (
            torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(
            f"wire dtype {wire_dtype} on {dtype} operands: the ring's wire "
            "lanes are the registered wire dtypes on float operands"
        )
    return wire_dtype


def _flat(xs: Sequence[torch.Tensor], what: str) -> List[torch.Tensor]:
    flat = [x.reshape(-1) for x in xs]
    check_ranks(flat, what)
    return flat


def _outputs(flat, out, length: int, what: str,
             optional: bool = False) -> List[Optional[torch.Tensor]]:
    """The per-rank output tensors, flattened (allocated when ``out`` is
    None).  With ``optional`` an ``out`` entry may be None: that rank
    takes no result."""
    x0 = flat[0]
    if out is None:
        return [torch.empty(length, dtype=x0.dtype, device=x0.device)
                for _ in flat]
    out = list(out)
    if len(out) != len(flat) or any(
        (o is None and not optional) or (o is not None and (
            o.numel() != length or o.dtype != x0.dtype
            or not o.is_contiguous()))
        for o in out
    ):
        raise ValueError(f"{what}: out must be {len(flat)} contiguous "
                         f"tensors of {length} {x0.dtype} elements")
    return [None if o is None else o.reshape(-1) for o in out]


def _vec(ptrs, n: int, dtype: torch.dtype) -> int:
    """16-byte accesses: every pointer (:func:`pointers`) aligned, n whole
    vectors."""
    return int(aligned16(ptrs) and n % (16 // dtype.itemsize) == 0)


def _lib():
    return _build.library("ring", PROTOTYPES["ring"])


def _kernel_dtype(dtype: torch.dtype, what: str) -> None:
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} kernel takes {_KERNEL_DTYPES}, got {dtype}")


# ---------------------------------------------------------------------------
# K1: allreduce
# ---------------------------------------------------------------------------


def _allreduce_layout(n, P, dtype, num_segments, bidirectional, wire):
    ndirs = 2 if bidirectional else 1
    half = ring_len(n, ndirs * P, num_segments, dtype, wire) // ndirs
    return ndirs, half, half // P


def ring_allreduce_plain(
    xs: Sequence[torch.Tensor],
    function: ReduceFunction = ReduceFunction.SUM,
    num_segments: int = 1,
    *,
    bidirectional: bool = False,
    wire_dtype=None,
) -> List[torch.Tensor]:
    """The hop schedule of K1, block by block, in plain PyTorch."""
    flat = _flat(xs, "ring_allreduce")
    P, n, dtype = len(flat), flat[0].numel(), flat[0].dtype
    if P == 1:
        return [flat[0].clone().reshape(xs[0].shape)]
    op = reduce_op(function)
    wire = _resolve_wire(dtype, wire_dtype)
    ndirs, half, blk = _allreduce_layout(
        n, P, dtype, num_segments, bidirectional, wire
    )
    outs = [torch.empty_like(flat[0]) for _ in flat]
    for d in range(ndirs):
        sg = 1 if d == 0 else -1
        for b in range(P):
            lo = d * half + b * blk
            hi = min(lo + blk, n)
            if lo >= hi:
                continue
            r = (b + sg) % P
            acc = flat[r][lo:hi]
            for _ in range(1, P):
                r = (r + sg) % P
                acc = op(_wire_round(acc, wire), flat[r][lo:hi])
            sent = _wire_round(acc, wire)
            for q in range(P):
                outs[q][lo:hi] = acc if q == b else sent
    return [o.reshape(x.shape) for o, x in zip(outs, xs)]


def ring_allreduce(
    xs: Sequence[torch.Tensor],
    function: ReduceFunction = ReduceFunction.SUM,
    num_segments: int = 1,
    *,
    bidirectional: bool = False,
    wire_dtype=None,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Segmented-ring allreduce (reduce-scatter + allgather) over the
    per-rank operands ``xs``; returns every rank's result (``out``, when
    given, receives them — it may be ``xs`` itself: in place).

    ``bidirectional`` sends the operand's two halves around the ring in
    opposite directions; ``wire_dtype`` (any registered wire lane: f16,
    bf16, fp8 e4m3 / e5m2, or int8 as a raw cast) rounds every hop's
    payload through the narrow dtype while accumulating in the operand
    dtype.  Both change the fold order and rounding exactly as the JAX
    kernel's do."""
    flat = _flat(xs, "ring_allreduce")
    P, n, dtype = len(flat), flat[0].numel(), flat[0].dtype
    wire = _resolve_wire(dtype, wire_dtype)
    reduce_op(function)
    if num_segments < 1:
        raise ValueError("num_segments must be >= 1")
    outs = _outputs(flat, out, n, "ring_allreduce")
    if not on_cuda(flat + outs):
        res = ring_allreduce_plain(
            flat, function, num_segments,
            bidirectional=bidirectional, wire_dtype=wire,
        )
        for o, r in zip(outs, res):
            o.copy_(r)
    elif P == 1:
        if outs[0].data_ptr() != flat[0].data_ptr():
            outs[0].copy_(flat[0])
    elif n:
        _kernel_dtype(dtype, "ring_allreduce")
        _, half, blk = _allreduce_layout(
            n, P, dtype, num_segments, bidirectional, wire
        )
        lib = _lib()
        pin, pout = pointers(flat), pointers(outs)
        rc = lib.accl_ring_allreduce(
            pointer_table(pin), pointer_table(pout), P, n, half, blk,
            int(torch_to_dtype(dtype)), int(function),
            int(torch_to_dtype(wire)) if wire is not None else 0,
            _vec(pin + pout, n, dtype), stream_of(flat[0].device),
        )
        check_launch(lib, rc, "ring_allreduce")
        ring_allreduce.launches.bump()
    return [o.reshape(x.shape) for o, x in zip(outs, xs)]


ring_allreduce.launches = LaunchCounter()


class PreparedAllreduce(PreparedLaunch):
    """K1 with its reduce function, segments, direction and wire resolved
    (:class:`PreparedLaunch`: its pointer tables and layout kept by
    pointers).  CPU tensors, P = 1 and empty operands take
    :func:`ring_allreduce` every time."""

    def __init__(self, function=ReduceFunction.SUM, num_segments: int = 1,
                 bidirectional: bool = False, wire_dtype=None):
        super().__init__()
        self.function = function
        self.num_segments = int(num_segments)
        self.bidirectional = bool(bidirectional)
        self.wire_dtype = wire_dtype

    def _full(self, xs, out) -> None:
        ring_allreduce(xs, self.function, self.num_segments,
                       bidirectional=self.bidirectional,
                       wire_dtype=self.wire_dtype, out=out)

    def _entry(self, xs, out):
        P, n, dtype = len(xs), xs[0].numel(), xs[0].dtype
        if P == 1 or not n:
            return None
        wire = _resolve_wire(dtype, self.wire_dtype)
        _, half, blk = _allreduce_layout(
            n, P, dtype, self.num_segments, self.bidirectional, wire)
        pin, pout = pointers(xs), pointers(out)
        lib = _lib()
        return (lib, lib.accl_ring_allreduce, (
            pointer_table(pin), pointer_table(pout), P, n, half, blk,
            int(torch_to_dtype(dtype)), int(self.function),
            int(torch_to_dtype(wire)) if wire is not None else 0,
            _vec(pin + pout, n, dtype)), ring_allreduce.launches,
            "ring_allreduce")


# ---------------------------------------------------------------------------
# K2: reduce-scatter
# ---------------------------------------------------------------------------


def ring_reduce_scatter_plain(
    xs: Sequence[torch.Tensor],
    function: ReduceFunction = ReduceFunction.SUM,
    num_segments: int = 1,
) -> List[torch.Tensor]:
    """The hop schedule of K2 in plain PyTorch: rank b's padded block b."""
    flat = _flat(xs, "ring_reduce_scatter")
    P, n = len(flat), flat[0].numel()
    op = reduce_op(function)
    L = ring_len(n, P, num_segments, flat[0].dtype)
    blk = L // P
    padded = []
    for x in flat:
        p = torch.zeros(L, dtype=x.dtype, device=x.device)
        p[:n] = x
        padded.append(p)
    outs = []
    for b in range(P):
        r = (b + 1) % P
        acc = padded[r][b * blk:(b + 1) * blk]
        for _ in range(1, P):
            r = (r + 1) % P
            acc = op(acc, padded[r][b * blk:(b + 1) * blk])
        outs.append(acc.clone())
    return outs


def ring_reduce_scatter(
    xs: Sequence[torch.Tensor],
    function: ReduceFunction = ReduceFunction.SUM,
    num_segments: int = 1,
    *,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Ring reduce-scatter: P-1 fused recv-reduce-send hops.  Returns
    rank ``i``'s reduced block ``i`` of the PADDED operand (the JAX
    kernel's packing), flattened."""
    flat = _flat(xs, "ring_reduce_scatter")
    P, n, dtype = len(flat), flat[0].numel(), flat[0].dtype
    reduce_op(function)
    if num_segments < 1:
        raise ValueError("num_segments must be >= 1")
    blk = ring_len(n, P, num_segments, dtype) // P
    outs = _outputs(flat, out, blk, "ring_reduce_scatter")
    if not on_cuda(flat + outs):
        for o, r in zip(outs, ring_reduce_scatter_plain(
                flat, function, num_segments)):
            o.copy_(r)
        return outs
    _kernel_dtype(dtype, "ring_reduce_scatter")
    lib = _lib()
    pin, pout = pointers(flat), pointers(outs)
    rc = lib.accl_ring_reduce_scatter(
        pointer_table(pin), pointer_table(pout), P, n, blk,
        int(torch_to_dtype(dtype)), int(function),
        _vec(pin + pout, n, dtype), stream_of(flat[0].device),
    )
    check_launch(lib, rc, "ring_reduce_scatter")
    ring_reduce_scatter.launches.bump()
    return outs


ring_reduce_scatter.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# K3: allgather
# ---------------------------------------------------------------------------


def ring_allgather_plain(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank ends with all blocks concatenated in rank order."""
    flat = _flat(xs, "ring_allgather")
    full = torch.cat(flat)
    shape = (len(flat) * xs[0].shape[0],) + tuple(xs[0].shape[1:])
    return [full.clone().reshape(shape) for _ in flat]


def ring_allgather(
    xs: Sequence[torch.Tensor],
    *,
    out: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> List[Optional[torch.Tensor]]:
    """Ring allgather (store-and-relay): ``xs[i]`` is rank i's block;
    every rank receives all blocks concatenated along the leading axis.
    A None entry of ``out`` is a rank that takes no result: the kernel
    skips its stores (``rooted.ring_gather`` with a root-only table has
    a kernel of its own)."""
    flat = _flat(xs, "ring_allgather")
    P, n = len(flat), flat[0].numel()
    shape = (P * xs[0].shape[0],) + tuple(xs[0].shape[1:])
    outs = _outputs(flat, out, P * n, "ring_allgather", optional=True)
    if not on_cuda(flat + outs):
        for o, r in zip(outs, ring_allgather_plain(flat)):
            if o is not None:
                o.copy_(r.reshape(-1))
    elif n:
        lib = _lib()
        rc = lib.accl_ring_allgather(
            pointer_table(pointers(flat)), pointer_table(pointers(outs)), P,
            n, flat[0].element_size(), stream_of(flat[0].device),
        )
        check_launch(lib, rc, "ring_allgather")
        ring_allgather.launches.bump()
    return [None if o is None else o.reshape(shape) for o in outs]


ring_allgather.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# int8_allreduce: rows 7-8 around K3
# ---------------------------------------------------------------------------


def int8_allreduce(
    xs: Sequence[torch.Tensor],
    *,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Allreduce over a blockwise-int8 wire (ref ``ring.int8_allreduce``):
    every rank quantizes its operand once (row 7, one absmax / 127 scale
    per ``block_rows x 128`` tile, round half to even), K3 allgathers the
    int8 values and the float32 scales, one batched dequantize (row 8)
    turns the P blocks back into float32, and a rank-order sum gives the
    result, cast to the operand dtype.  Each contribution is rounded
    exactly once, so the error is bounded by the sum of the ranks' own
    tile scales.

    With every rank on one card, each rank's gathered copy holds the same
    bytes (K3 relays them unchanged), so one dequantize of the P blocks
    and one sum serve every rank."""
    flat = _flat(xs, "int8_allreduce")
    P, n = len(flat), flat[0].numel()
    outs = _outputs(flat, out, n, "int8_allreduce")
    if P == 1:
        if outs[0].data_ptr() != flat[0].data_ptr():
            outs[0].copy_(flat[0])
        return [o.reshape(x.shape) for o, x in zip(outs, xs)]
    rows, br, nblk = kcomp.tiles(n)
    seg = br * LANES
    values, scales = kcomp.quantize_rows(flat, [0] * P, seg,
                                         out_len=rows * LANES)
    all_v = ring_allgather(list(values.unbind(0)))
    all_s = ring_allgather(list(scales.unbind(0)))
    blocks = kcomp.dequantize_rows(all_v[0].view(P, rows * LANES),
                                   all_s[0].view(P, nblk), n, seg)
    acc = blocks[0] + blocks[1]
    for b in blocks[2:]:
        acc = acc + b
    acc = astype(acc, flat[0].dtype)
    for o in outs:
        o.copy_(acc)
    return [o.reshape(x.shape) for o, x in zip(outs, xs)]
