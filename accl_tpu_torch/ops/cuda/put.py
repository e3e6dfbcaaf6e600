"""Row 13: the fused compute-and-put — ``vadd_put`` in one kernel.

The counterpart of ``accl_tpu/ops/pallas/put.py::fused_shift``: every
rank computes ``compute(x)`` and puts the result into the output of the
rank ``distance`` away on the ring, so rank r's output holds what rank
``(r - distance) mod P`` computed.  JAX runs it inside ``shard_map``, one
kernel per rank that issues its own remote DMA; here every rank's row
lies on one device and ONE launch of ``csrc/put.cu`` computes and stores
all of them through a pointer table.

The kernel fuses the compute forms the repository uses: identity (the
default), :class:`Add` (``v + c``, ``vadd_put``) and :class:`Mul`
(``v * c``).  Any other callable runs as its own PyTorch pass over each
row before an identity put; such a pass is counted in
``fused_shift.compute_passes``, not in ``fused_shift.launches``.
:func:`fused_shift_plain` is the plain version (a roll of ``compute``
over the stacked rows); CPU tensors take it.

The constant ``c`` follows JAX's weak-typed Python scalar (one rule,
:func:`_constant`, for the plain version and the kernel alike): on a
float16 or bfloat16 operand it is first rounded to the operand's dtype
through float32 (``1 + 2**-8 + 2**-30`` becomes ``1 + 2**-8``, then 1.0
in bfloat16), and the operation then computes in float32 and rounds
once; on a float32 operand it rounds to float32, on float64 it stays; on
an integer operand it is the integer and the arithmetic wraps.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch

from ...constants import torch_to_dtype
from . import _build
from ._build import DOUBLE, INT, LL, PTR
from ._common import (
    LaunchCounter,
    check_launch,
    check_ranks,
    on_cuda,
    overlaps,
    pointer_table,
    pointers,
    stream_of,
)

#: ``csrc/put.cu``'s C prototypes (declared once, at load)
PROTOTYPES = {"put": {"accl_fused_put": (
    PTR, PTR, INT, INT, LL, INT, INT, INT, DOUBLE, LL, PTR)}}

#: dtypes the kernel computes ``v + c`` and ``v * c`` in (identity takes
#: any dtype)
COMPUTE_DTYPES = (torch.float32, torch.float16, torch.bfloat16,
                  torch.float64, torch.int32, torch.int64)

_IDENTITY, _ADD, _MUL = 0, 1, 2


def _constant(dtype: torch.dtype, c: float):
    """The constant as JAX's weak-typed Python scalar meets an operand of
    ``dtype``: rounded to a 16-bit float dtype through float32 (exact as
    a Python float); unchanged for float32 (the float cast rounds it) and
    float64; an integer for integer operands, whose arithmetic stays in
    their dtype and wraps (a fractional constant is refused)."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.tensor(c, dtype=torch.float32).to(dtype).item()
    if dtype.is_floating_point:
        return c
    if not float(c).is_integer():
        raise ValueError(f"constant {c} on an integer operand")
    return int(c)


class Add:
    """``compute(v) = v + c``, fused into the put."""

    op = _ADD

    def __init__(self, c: float):
        self.c = float(c)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v + _constant(v.dtype, self.c)

    def __repr__(self) -> str:
        return f"Add({self.c})"


class Mul:
    """``compute(v) = v * c``, fused into the put."""

    op = _MUL

    def __init__(self, c: float):
        self.c = float(c)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v * _constant(v.dtype, self.c)

    def __repr__(self) -> str:
        return f"Mul({self.c})"


Operand = Union[torch.Tensor, Sequence[torch.Tensor]]


def _rows(xs: Operand) -> List[torch.Tensor]:
    return list(xs.unbind(0)) if isinstance(xs, torch.Tensor) else list(xs)


def _result(xs: Operand, outs: List[torch.Tensor]):
    return torch.stack(outs) if isinstance(xs, torch.Tensor) else outs


def fused_shift_plain(xs: Operand, distance: int = 1,
                      compute: Optional[Callable] = None):
    """Rank ``(r + distance) mod P`` gets ``compute(xs[r])``: a roll of
    ``compute`` over the stacked rows (Python's modulus, as ``jnp.mod``).
    A 2-D operand gives a 2-D result, a sequence a list."""
    rows = _rows(xs)
    done = torch.stack([x.clone() if compute is None else compute(x)
                        for x in rows])
    return _result(xs, list(torch.roll(done, int(distance), 0).unbind(0)))


def fused_shift(xs: Operand, distance: int = 1,
                compute: Optional[Callable] = None,
                out: Optional[Sequence[torch.Tensor]] = None):
    """``out[(r + distance) mod P] = compute(xs[r])`` for every rank r in
    one launch (row 13); with P = 1, ``compute(xs[0])``.  ``xs`` is a
    ``(P, n)`` tensor or P contiguous 1-D tensors of one shape and dtype;
    ``out`` names P tensors to write (they may not overlap the
    operands).  ``compute`` is None, :class:`Add`, :class:`Mul` or any
    callable that keeps the shape and dtype (run as its own pass)."""
    rows = _rows(xs)
    check_ranks(rows, "fused_shift")
    P, x0 = len(rows), rows[0]
    if out is None:
        outs = [torch.empty_like(x) for x in rows]
    else:
        outs = list(out)
        if len(outs) != P or any(
                o.shape != x0.shape or o.dtype != x0.dtype
                or not o.is_contiguous() for o in outs):
            raise ValueError(
                "fused_shift out must be P contiguous tensors shaped and "
                "typed as the operands")
        if any(overlaps(o, x) for o in outs for x in rows):
            raise ValueError("fused_shift out may not overlap its operands")
    if not on_cuda(rows + outs):
        for o, r in zip(outs, fused_shift_plain(rows, distance, compute)):
            o.copy_(r)
        return _result(xs, outs)
    op, c = _IDENTITY, 0.0
    if isinstance(compute, (Add, Mul)):
        if x0.dtype not in COMPUTE_DTYPES:
            raise ValueError(f"fused_shift computes no {compute!r} on "
                             f"{x0.dtype}")
        op, c = compute.op, _constant(x0.dtype, compute.c)
    elif compute is not None:
        rows = [compute(x) for x in rows]
        fused_shift.compute_passes.bump()
        if any(r.shape != x0.shape or r.dtype != x0.dtype for r in rows):
            raise ValueError("fused_shift compute must keep shape and dtype")
        rows = [r.contiguous() for r in rows]
    n = x0.numel()
    if n:
        lib = _build.library("put", PROTOTYPES["put"])
        rc = lib.accl_fused_put(
            pointer_table(pointers(rows)), pointer_table(pointers(outs)), P,
            int(distance) % P, n,
            int(torch_to_dtype(x0.dtype)) if op else 0, x0.element_size(),
            op, c, 0 if x0.is_floating_point() else int(c),
            stream_of(x0.device),
        )
        check_launch(lib, rc, "fused_shift")
        fused_shift.launches.bump()
    return _result(xs, outs)


fused_shift.launches = LaunchCounter()
fused_shift.compute_passes = LaunchCounter()
