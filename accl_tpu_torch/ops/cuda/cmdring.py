"""Row 14: the command-ring sequencer over ranks that share one device.

The counterpart of ``accl_tpu/ops/pallas/cmdring.py::_sequencer_kernel``.
:func:`sequencer` runs one refill window: on CUDA tensors as ONE launch of
``csrc/cmdring.cu`` (two or more only when the window holds more than 512
rank-slots, the descriptor's capacity; a depth-64 window fits at P <= 8),
on CPU tensors through :func:`sequencer_plain`, which walks the same
slots in the same order with :func:`accl_tpu_torch.ops.cmdring.
slot_epilogue` and is the kernel's reference on the card.

Before either runs, the wrapper reads the window's aliasing on the host:

* a slot whose operand an earlier slot writes is refused (the engine
  counts it as ``data_dependency`` before it gets here);
* a slot whose result overlaps memory an earlier slot reads or writes is
  preceded by a grid-wide barrier in the kernel (write after read, write
  after write);
* inside a slot, a result that overlaps an operand other than in the
  kernel's column-preserving forms (a rank's result at its own operand;
  the MPI in-place allgather) takes a copy of that operand first, on the
  same stream;
* two results of one slot that overlap other than exactly are refused.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...cmdring import WindowShape
from ...constants import (
    CMDRING_FIELDS,
    CMDRING_SLOT_WORDS,
    CmdOpcode,
    torch_to_dtype,
)
from . import _build
from ._build import INT, PTR
from ._common import LaunchCounter, check_launch, on_cuda, stream_of

_F = CMDRING_FIELDS

#: the descriptor's capacity (csrc/cmdring.cu)
MAX_SLOTS = 64
MAX_RANK_SLOTS = 512
#: alltoall slots stage P*P values per thread up to this many ranks
A2A_STAGE_RANKS = 8

# width classes, as csrc/cmdring.cu numbers them
CLS_SAME, CLS_AG, CLS_APPLY, CLS_RS, CLS_ATTN, CLS_SOLO = range(6)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                  torch.float64, torch.int64)


def slot_class(in_w: int, out_w: int, P: int) -> int:
    """The width class of a slot, by the relations ``slot_epilogue``
    branches on, in its order."""
    if P == 1:
        return CLS_SOLO
    if out_w == in_w * P:
        return CLS_AG
    if in_w == out_w * (P + 1):
        return CLS_APPLY
    if in_w == out_w * P:
        return CLS_RS
    if in_w == out_w * 2:
        return CLS_ATTN
    return CLS_SAME


def result_width(in_w: int, out_w: int, P: int) -> int:
    """Elements of one rank's result of a slot."""
    cls = slot_class(in_w, out_w, P)
    if cls == CLS_SOLO:
        return min(in_w, out_w)
    if cls == CLS_AG:
        return in_w * P
    if cls == CLS_SAME:
        return in_w
    return out_w


def _chunk(in_w: int, P: int) -> int:
    return in_w // P if in_w % P == 0 and in_w >= P else 0


def launches_for(P: int, n_slots: int) -> int:
    """Kernel launches one window of ``n_slots`` slots of ``P`` ranks
    takes."""
    per = max(1, min(MAX_SLOTS, MAX_RANK_SLOTS // max(P, 1)))
    return -(-n_slots // per)


#: ``csrc/cmdring.cu``'s C prototypes (declared once, at load)
PROTOTYPES = {"cmdring": {
    "accl_sequencer": (PTR,) * 9 + (INT, INT, INT, PTR, PTR, PTR)}}


def _words(slots) -> np.ndarray:
    w = np.ascontiguousarray(np.asarray(slots, np.int32))
    return w.reshape(-1, CMDRING_SLOT_WORDS)


def _span(t: torch.Tensor):
    lo = t.data_ptr()
    return lo, lo + t.numel() * t.element_size()


def _check_window(words, xs, outs, shape: WindowShape):
    """Validate the window; returns ``(P, xs, outs)`` with every operand
    cut to its slot's width."""
    n = words.shape[0]
    if not 1 <= n or len(xs) != n or len(outs) != n or shape.depth != n:
        raise ValueError(
            f"sequencer: {n} slot rows, {len(xs)} operand rows, "
            f"{len(outs)} result rows, window depth {shape.depth}")
    P = len(xs[0])
    cut_x, cut_o = [], []
    for i in range(n):
        in_w, out_w = shape.in_ws[i], shape.out_ws[i]
        width = result_width(in_w, out_w, P)
        if len(xs[i]) != P or len(outs[i]) != P:
            raise ValueError(f"sequencer: slot {i} does not have {P} ranks")
        row_x, row_o = [], []
        for x in xs[i]:
            if x is not None and (x.dim() != 1 or not x.is_contiguous()
                                  or x.dtype != shape.dtype
                                  or x.numel() < in_w):
                raise ValueError(
                    f"sequencer: slot {i} operands must be contiguous 1-D "
                    f"{shape.dtype} of at least {in_w} elements")
            row_x.append(None if x is None else x[:in_w])
        for o in outs[i]:
            if o is not None and (o.dim() != 1 or not o.is_contiguous()
                                  or o.dtype != shape.dtype
                                  or o.numel() != width):
                raise ValueError(
                    f"sequencer: slot {i} results must be contiguous 1-D "
                    f"{shape.dtype} of {width} elements")
            row_o.append(o)
        cut_x.append(row_x)
        cut_o.append(row_o)
    return P, cut_x, cut_o


def _in_place(words_i, shape, i, P, q, o, p, x) -> bool:
    """Whether result ``o`` of rank q overlapping operand ``x`` of rank p
    is one of the kernel's column-preserving forms."""
    if p != q:
        return False
    in_w, out_w = shape.in_ws[i], shape.out_ws[i]
    cls = slot_class(in_w, out_w, P)
    offset = x.data_ptr() - o.data_ptr()
    if cls == CLS_AG:
        return offset == q * in_w * x.element_size()
    if (cls == CLS_SAME and int(words_i[_F["opcode"]]) == CmdOpcode.ALLTOALL
            and _chunk(in_w, P) and P > A2A_STAGE_RANKS):
        return False  # the unstaged alltoall reads every rank's chunks
    return offset == 0


def _hazards(words, xs, outs, shape, P):
    """Barrier flags per slot, and the (slot, rank) operands to stage as
    copies; raises on a read after write across slots and on two results
    of one slot that overlap other than exactly."""
    spans = []  # (lo, hi, slot, rank, is_result, tensor)
    for i in range(len(xs)):
        for r in range(P):
            for is_res, t in ((False, xs[i][r]), (True, outs[i][r])):
                if t is not None and t.numel():
                    lo, hi = _span(t)
                    spans.append((lo, hi, i, r, is_res, t))
    spans.sort(key=lambda s: s[0])
    sync = [False] * len(xs)
    stage = set()
    active: List[tuple] = []
    for cur in spans:
        active = [a for a in active if a[1] > cur[0]]
        for prev in active:
            a, b = (prev, cur) if prev[2] <= cur[2] else (cur, prev)
            if not (a[4] or b[4]):
                continue  # two reads
            if a[2] != b[2]:  # different slots, a earlier
                if not b[4]:
                    raise ValueError(
                        f"sequencer: slot {b[2]} reads what slot {a[2]} "
                        f"writes (run it in a later window)")
                sync[b[2]] = True
                continue
            i = a[2]
            if a[4] and b[4]:
                if a[0] != b[0] or a[1] != b[1]:
                    raise ValueError(
                        f"sequencer: slot {i} results of ranks {a[3]} and "
                        f"{b[3]} overlap")
                continue
            res, opnd = (a, b) if a[4] else (b, a)
            if not _in_place(words[i], shape, i, P, res[3], res[5],
                             opnd[3], opnd[5]):
                stage.add((i, opnd[3]))
        active.append(cur)
    return sync, stage


def sequencer_plain(slots, xs, outs, shape: WindowShape) -> torch.Tensor:
    """The sequencer in plain PyTorch: slot by slot, every rank's result
    from :func:`slot_epilogue` over the wire-rounded operand rows (None
    rows read as zeros), all of a slot's results computed before any is
    written.  Returns the status words."""
    from ..cmdring import slot_epilogue, status_words

    words = _words(slots)
    P, xs, outs = _check_window(words, xs, outs, shape)
    _hazards(words, xs, outs, shape, P)
    device = _device(*xs, *outs)
    for i, w in enumerate(words):
        in_w = shape.in_ws[i]
        wire = shape.wires[i]
        own = [x if x is not None
               else torch.zeros(in_w, dtype=shape.dtype, device=device)
               for x in xs[i]]
        blocks = [x.to(wire).to(x.dtype) if wire is not None else x
                  for x in own]
        chunk = in_w // P if in_w % P == 0 else None
        results = [
            None if outs[i][me] is None else slot_epilogue(
                blocks, own[me], me, w[_F["opcode"]], w[_F["function"]],
                w[_F["root"]], w[_F["peer"]], shape.out_ws[i], chunk=chunk,
                fparam=w[_F["fparam"]],
            ).clone()
            for me in range(P)
        ]
        for o, res in zip(outs[i], results):
            if o is not None:
                o.copy_(res)
    return torch.from_numpy(status_words(words)).to(device)


def _device(*rows):
    for row in rows:
        for t in row:
            if t is not None:
                return t.device
    return torch.device("cpu")


def sequencer(slots, xs: Sequence[Sequence[Optional[torch.Tensor]]],
              outs: Sequence[Sequence[Optional[torch.Tensor]]],
              shape: WindowShape, device=None) -> torch.Tensor:
    """Run one refill window (``ops.cmdring.run_window`` describes the
    arguments); returns the ``(n, 2)`` int32 status words on the
    operands' device, or on ``device`` for a window that holds no tensor
    (barriers only).  CPU tensors run :func:`sequencer_plain`; CUDA
    tensors launch the kernel or raise."""
    words = _words(slots)
    P, cut_x, cut_o = _check_window(words, xs, outs, shape)
    tensors = [t for row in cut_x + cut_o for t in row if t is not None]
    if not tensors:
        tensors = [torch.empty(0, device=device or "cpu")]
    if not on_cuda(tensors):
        return sequencer_plain(words, xs, outs, shape)
    dtype = shape.dtype
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"sequencer kernel takes {_KERNEL_DTYPES}, "
                         f"got {dtype}")
    sync, stage = _hazards(words, cut_x, cut_o, shape, P)
    for i, r in stage:  # a copy on the same stream, before the launch
        cut_x[i][r] = cut_x[i][r].clone()
    device = tensors[0].device
    n = words.shape[0]
    scratch = torch.empty(2 * n + 1, dtype=torch.int32, device=device)
    status = scratch[:2 * n].view(n, 2)
    lib = _build.library("cmdring", PROTOTYPES["cmdring"])
    per = max(1, min(MAX_SLOTS, MAX_RANK_SLOTS // P))
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        idx = range(lo, hi)
        k = hi - lo
        ll = ctypes.c_longlong * k
        ii = ctypes.c_int * k
        in_w = [shape.in_ws[i] for i in idx]
        out_w = [shape.out_ws[i] for i in idx]
        ptrs = ctypes.c_void_p * (k * P)
        slot_words = np.ascontiguousarray(words[lo:hi])
        rc = lib.accl_sequencer(
            slot_words.ctypes.data_as(ctypes.c_void_p),
            ll(*in_w), ll(*out_w), ll(*[_chunk(w, P) for w in in_w]),
            ii(*[slot_class(a, b, P) for a, b in zip(in_w, out_w)]),
            ii(*[0 if shape.wires[i] is None
                 else int(torch_to_dtype(shape.wires[i])) for i in idx]),
            ii(*[int(sync[i] and i > lo) for i in idx]),
            ptrs(*[None if t is None else t.data_ptr()
                   for i in idx for t in cut_x[i]]),
            ptrs(*[None if t is None else t.data_ptr()
                   for i in idx for t in cut_o[i]]),
            k, P, int(torch_to_dtype(dtype)), status[lo:].data_ptr(),
            scratch[2 * n:].data_ptr(), stream_of(device),
        )
        check_launch(lib, rc, "sequencer")
        sequencer.launches.bump()
    return status


sequencer.launches = LaunchCounter()
