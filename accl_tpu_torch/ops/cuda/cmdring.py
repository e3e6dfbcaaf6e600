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
  kernel's column-preserving forms (a rank's result at its own operand,
  but for the attention hop above ``HOLD_RANKS`` ranks; the MPI in-place
  allgather) takes a copy of that operand first, on the same stream;
* two results of one slot that overlap other than exactly are refused.

On the card that reading is cached (:func:`_cached`): the verdict
and the launch's descriptors (``WINDOW``, one host buffer a launch) are
kept by the window's shape, opcode column and every tensor's (pointer,
bytes) in its place, so a warm window reads each tensor's pointer and
size, copies its slot words into the cached descriptor and launches.
"""

from __future__ import annotations

import functools
import threading
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
from ._build import PTR
from ._common import LaunchCounter, check_launch, on_cuda, stream_of

_F = CMDRING_FIELDS

#: the descriptor's capacity (csrc/cmdring.cu)
MAX_SLOTS = 64
MAX_RANK_SLOTS = 512
#: the attention hop holds every rank's visiting word up to this many
#: ranks (in place); above, the wrapper stages an overlapping operand
HOLD_RANKS = 4
#: the kernel's column offsets are 32-bit
MAX_WIDTH = 2 ** 31 - 1

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
PROTOTYPES = {"cmdring": {"accl_sequencer": (PTR, PTR, PTR, PTR)}}

#: ``csrc/cmdring.cu``'s ``Window``, field for field: the descriptor one
#: launch takes, packed into one host buffer (``first``, the per-slot
#: prefix of work items, is filled by the launch, which knows the tile)
WINDOW = np.dtype([
    ("words", np.int32, (MAX_SLOTS, CMDRING_SLOT_WORDS)),
    ("in_w", np.int64, (MAX_SLOTS,)),
    ("out_w", np.int64, (MAX_SLOTS,)),
    ("chunk", np.int64, (MAX_SLOTS,)),
    ("cols", np.int64, (MAX_SLOTS,)),
    ("first", np.int64, (MAX_SLOTS + 1,)),
    ("cls", np.int32, (MAX_SLOTS,)),
    ("wire", np.int32, (MAX_SLOTS,)),
    ("sync", np.int32, (MAX_SLOTS,)),
    ("parts", np.int32, (MAX_SLOTS,)),
    ("n_slots", np.int32),
    ("P", np.int32),
    ("dtype", np.int32),
    ("pad", np.int32),
    ("in", np.uint64, (MAX_RANK_SLOTS,)),
    ("out", np.uint64, (MAX_RANK_SLOTS,)),
])
_WORDS = MAX_SLOTS * CMDRING_SLOT_WORDS  # int32 words ahead of in_w
_IN = WINDOW.fields["in"][1] // 8  # the pointers, in uint64 words


def _words(slots) -> np.ndarray:
    w = np.ascontiguousarray(np.asarray(slots, np.int32))
    return w.reshape(-1, CMDRING_SLOT_WORDS)


def geometry(in_w: int, out_w: int, P: int, opcode: int,
             writes: bool = True, apart: bool = False):
    """``(cls, chunk, cols, parts)`` of a slot in the kernel's work list:
    its width class, per-rank chunk, the columns of one part and the parts
    (an alltoall's rank pairs, P (P + 1) / 2; a reduce-scatter's or fused
    apply's ranks, P, when its results lie ``apart`` from its operands;
    else 1; 0 for a slot that writes nothing)."""
    cls = slot_class(in_w, out_w, P)
    chunk = _chunk(in_w, P)
    op = int(opcode)
    if cls == CLS_SOLO:
        cols = min(in_w, out_w)
    elif cls == CLS_AG:
        cols = in_w
    elif cls == CLS_SAME:
        cols = in_w
        if op == CmdOpcode.ALLTOALL and chunk:
            return cls, chunk, chunk, (P * (P + 1) // 2 if writes else 0)
    else:
        cols = out_w
        if apart and writes and (
                (cls == CLS_RS and op in (CmdOpcode.REDUCE_SCATTER,
                                          CmdOpcode.FUSED_MATMUL_RS))
                or (cls == CLS_APPLY and op == CmdOpcode.FUSED_APPLY)):
            return cls, chunk, cols, P
    return cls, chunk, cols, int(writes)


def _apart(in_ptrs, out_ptrs, in_bytes: int, out_bytes: int) -> bool:
    """Whether no result of a slot overlaps any of its operands."""
    for o in out_ptrs:
        if not o:
            continue
        for x in in_ptrs:
            if x and x < o + out_bytes and o < x + in_bytes:
                return False
    return True


def pack_window(words, shape: WindowShape, P: int, sync, in_ptrs, out_ptrs,
                lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
    """The descriptor of slots ``lo:hi`` of a window: ``words`` its slot
    words, ``sync`` the barrier flags, ``in_ptrs`` / ``out_ptrs`` the
    ranks' pointers slot-major (``words.shape[0] * P`` each, 0 or None
    for none).  Returns one ``WINDOW`` record (a 0-d array)."""
    hi = words.shape[0] if hi is None else hi
    k = hi - lo
    d = np.zeros((), WINDOW)
    d["words"][:k] = words[lo:hi]
    isz = shape.dtype.itemsize
    for s, i in enumerate(range(lo, hi)):
        in_w, out_w = shape.in_ws[i], shape.out_ws[i]
        if max(in_w, result_width(in_w, out_w, P)) > MAX_WIDTH:
            raise ValueError(f"sequencer: slot {i} is wider than "
                             f"{MAX_WIDTH} elements")
        ins, outs = in_ptrs[i * P:(i + 1) * P], out_ptrs[i * P:(i + 1) * P]
        cls, chunk, cols, parts = geometry(
            in_w, out_w, P, words[i, _F["opcode"]], any(outs),
            _apart(ins, outs, in_w * isz,
                   result_width(in_w, out_w, P) * isz))
        d["in_w"][s], d["out_w"][s], d["chunk"][s] = in_w, out_w, chunk
        d["cols"][s], d["parts"][s], d["cls"][s] = cols, parts, cls
        wire = shape.wires[i]
        d["wire"][s] = 0 if wire is None else int(torch_to_dtype(wire))
        d["sync"][s] = int(bool(sync[i]) and i > lo)
    d["n_slots"], d["P"] = k, P
    d["dtype"] = int(torch_to_dtype(shape.dtype))
    d["in"][:k * P] = [p or 0 for p in in_ptrs[lo * P:hi * P]]
    d["out"][:k * P] = [p or 0 for p in out_ptrs[lo * P:hi * P]]
    return d


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
                raise _operand_error(i, shape)
            row_x.append(None if x is None else x[:in_w])
        for o in outs[i]:
            if o is not None and (o.dim() != 1 or not o.is_contiguous()
                                  or o.dtype != shape.dtype
                                  or o.numel() != width):
                raise _result_error(i, shape, width)
            row_o.append(o)
        cut_x.append(row_x)
        cut_o.append(row_o)
    return P, cut_x, cut_o


def _operand_error(i, shape) -> ValueError:
    return ValueError(
        f"sequencer: slot {i} operands must be contiguous 1-D "
        f"{shape.dtype} of at least {shape.in_ws[i]} elements")


def _result_error(i, shape, width) -> ValueError:
    return ValueError(
        f"sequencer: slot {i} results must be contiguous 1-D "
        f"{shape.dtype} of {width} elements")


def _in_place(words_i, shape, i, P, q, p, offset) -> bool:
    """Whether rank q's result overlapping rank p's operand of slot i, the
    operand ``offset`` bytes past the result, is one of the kernel's
    column-preserving forms."""
    if p != q:
        return False
    in_w, out_w = shape.in_ws[i], shape.out_ws[i]
    cls = slot_class(in_w, out_w, P)
    if cls == CLS_AG:
        return offset == q * in_w * shape.dtype.itemsize
    op = int(words_i[_F["opcode"]])
    if P > HOLD_RANKS and op == CmdOpcode.FUSED_ATTN_HOP and cls == CLS_ATTN:
        return False  # the hop holds every rank's visiting word
    return offset == 0


def spans_of(xs, outs, shape: WindowShape, P: int) -> tuple:
    """The window's memory as ``(pointer, bytes)`` per (slot, rank,
    operand / result), slot-major, operands before results: an operand
    spans its slot's width, a result all of it, None is ``(0, 0)``."""
    isz = shape.dtype.itemsize
    spans = []
    for i in range(len(xs)):
        nb = shape.in_ws[i] * isz
        for x in xs[i]:
            spans += (0, 0) if x is None else (x.data_ptr(), nb)
        for o in outs[i]:
            spans += (0, 0) if o is None else (o.data_ptr(), o.nbytes)
    return tuple(spans)


def _hazards(words, spans, shape, P):
    """Barrier flags per slot, and the (slot, rank) operands to stage as
    copies, from :func:`spans_of`'s spans; raises on a read after write
    across slots and on two results of one slot that overlap other than
    exactly."""
    live = []  # (lo, hi, slot, rank, is_result)
    k = 0
    for i in range(len(shape.in_ws)):
        for is_res in (False, True):
            for r in range(P):
                lo, nb = spans[k], spans[k + 1]
                k += 2
                if nb:
                    live.append((lo, lo + nb, i, r, is_res))
    live.sort(key=lambda s: s[0])
    sync = [False] * len(shape.in_ws)
    stage = set()
    active: List[tuple] = []
    for cur in live:
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
            if not _in_place(words[i], shape, i, P, res[3], opnd[3],
                             opnd[0] - res[0]):
                stage.add((i, opnd[3]))
        active.append(cur)
    return sync, stage


class _Verdicts:
    """:func:`_hazards`'s verdicts by what they depend on: the window's
    shape, its opcode column and every span (pointer, bytes, and by its
    place the slot, rank and side).  A verdict is ``(sync, stage)`` or the
    refusal's message; each is kept with the launch's descriptors, so a
    warm window (the gang ring reuses its buffers) packs nothing anew."""

    LIMIT = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._cache = {}
        self.hits = self.misses = 0

    def key(self, words, shape, spans):
        return (shape.in_ws, shape.out_ws, shape.wires, shape.dtype,
                words[:, _F["opcode"]].tobytes(), spans)

    def get(self, key):
        entry = self._cache.get(key)
        if entry is not None:
            self.hits += 1
        return entry

    def put(self, key, entry):
        with self._lock:
            self.misses += 1
            if len(self._cache) >= self.LIMIT:
                self._cache.clear()
            self._cache[key] = entry

    def clear(self):
        with self._lock:
            self._cache.clear()
            self.hits = self.misses = 0


_verdicts = _Verdicts()


def _cached(words, spans, shape, P, xs=None, outs=None):
    """:func:`_hazards` through the verdict cache: the window's entry
    ``(sync, stage, descriptors)``, the last filled by its first launch;
    raises the cached refusal.  A new key first checks that ``xs`` and
    ``outs`` lie on one device."""
    key = _verdicts.key(words, shape, spans)
    entry = _verdicts.get(key)
    if entry is None:
        if xs is not None:
            _one_device(xs, outs)
        try:
            sync, stage = _hazards(words, spans, shape, P)
            entry = (sync, frozenset(stage), {})
        except ValueError as e:
            entry = str(e)
        _verdicts.put(key, entry)
    if isinstance(entry, str):
        raise ValueError(entry)
    return entry


def sequencer_plain(slots, xs, outs, shape: WindowShape) -> torch.Tensor:
    """The sequencer in plain PyTorch: slot by slot, every rank's result
    from :func:`slot_epilogue` over the wire-rounded operand rows (None
    rows read as zeros), all of a slot's results computed before any is
    written.  Returns the status words."""
    from ..cmdring import slot_epilogue, status_words

    words = _words(slots)
    P, xs, outs = _check_window(words, xs, outs, shape)
    _hazards(words, spans_of(xs, outs, shape, P), shape, P)
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


def _checked_spans(words, xs, outs, shape: WindowShape):
    """Validate the window as :func:`_check_window` does, reading each
    tensor's pointer and size without a view of it; returns ``(P,
    spans, first)``, ``first`` the first tensor (None for none).  The
    devices are checked apart (:func:`_one_device`), on a cache miss."""
    n = words.shape[0]
    if not 1 <= n or len(xs) != n or len(outs) != n or shape.depth != n:
        _check_window(words, xs, outs, shape)  # raises its message
    P = len(xs[0])
    dtype = shape.dtype
    isz = dtype.itemsize
    widths = _widths(shape.in_ws, shape.out_ws, P)
    spans = []
    add = spans.append
    first = None
    one = _ONE
    for i in range(n):
        row_x, row_o = xs[i], outs[i]
        if len(row_x) != P or len(row_o) != P:
            raise ValueError(f"sequencer: slot {i} does not have {P} ranks")
        nb = shape.in_ws[i] * isz
        for x in row_x:
            if x is None:
                add(0)
                add(0)
                continue
            if (x.dtype is not dtype or x.nbytes < nb
                    or (x.stride() != one
                        and not (x.dim() == 1 and x.is_contiguous()))):
                raise _operand_error(i, shape)
            add(x.data_ptr())
            add(nb)
            if first is None:
                first = x
        wb = widths[i] * isz
        for o in row_o:
            if o is None:
                add(0)
                add(0)
                continue
            if (o.dtype is not dtype or o.nbytes != wb
                    or (o.stride() != one
                        and not (o.dim() == 1 and o.is_contiguous()))):
                raise _result_error(i, shape, widths[i])
            add(o.data_ptr())
            add(wb)
            if first is None:
                first = o
    return P, tuple(spans), first


def _one_device(xs, outs) -> None:
    """Raise unless every tensor lies on one device.  Checked when a
    window's key is new: a pointer names its device (one address space
    over the host and every card), so a cached key has been checked."""
    tensors = [t for row in list(xs) + list(outs) for t in row]
    if any(t is not None for t in tensors):  # not a window of barriers
        on_cuda(tensors)


_ONE = (1,)


@functools.lru_cache(maxsize=256)
def _widths(in_ws, out_ws, P):
    return tuple(result_width(a, b, P) for a, b in zip(in_ws, out_ws))


def _barrier(device: torch.device, stream: int) -> int:
    """Two device words of grid barrier for a window with a barrier flag,
    one pair per (device, stream), zeroed once: the kernel leaves them
    zero."""
    key = (device.index, stream)
    t = _barriers.get(key)
    if t is None:
        with _barrier_lock:
            t = _barriers.get(key)
            if t is None:
                t = _barriers[key] = torch.zeros(2, dtype=torch.int32,
                                                 device=device)
    return t.data_ptr()


_barriers = {}
_barrier_lock = threading.Lock()


def sequencer(slots, xs: Sequence[Sequence[Optional[torch.Tensor]]],
              outs: Sequence[Sequence[Optional[torch.Tensor]]],
              shape: WindowShape, device=None) -> torch.Tensor:
    """Run one refill window (``ops.cmdring.run_window`` describes the
    arguments); returns the ``(n, 2)`` int32 status words on the
    operands' device, or on ``device`` for a window that holds no tensor
    (barriers only).  CPU tensors run :func:`sequencer_plain`; CUDA
    tensors launch the kernel or raise.

    The launch path reads each tensor's pointer and size (no view of it),
    looks the window's hazard verdict and descriptors up by them
    (:func:`_cached`), copies the slot words into a copy of the
    cached descriptor and passes it as one pointer."""
    words = _words(slots)
    P, spans, first = _checked_spans(words, xs, outs, shape)
    if first is None:
        first = torch.empty(0, device=device or "cpu")
    if not first.is_cuda:
        return sequencer_plain(words, xs, outs, shape)
    dev = first.device
    dtype = shape.dtype
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"sequencer kernel takes {_KERNEL_DTYPES}, "
                         f"got {dtype}")
    sync, stage, packed = _cached(words, spans, shape, P, xs, outs)
    n = words.shape[0]
    per = max(1, min(MAX_SLOTS, MAX_RANK_SLOTS // P))
    if not packed:  # the descriptors of this key, built once
        in_ptrs = [spans[2 * (i * 2 * P + r)] for i in range(n)
                   for r in range(P)]
        out_ptrs = [spans[2 * (i * 2 * P + P + r)] for i in range(n)
                    for r in range(P)]
        built = {}
        for lo in range(0, n, per):
            hi = min(n, lo + per)
            d = pack_window(words, shape, P, sync, in_ptrs, out_ptrs, lo, hi)
            built[lo] = (d.reshape(1).view(np.int32), any(sync[lo + 1:hi]))
        packed.update(built)  # at once: another thread may read it
    status = torch.empty((n, 2), dtype=torch.int32, device=dev)
    stream = stream_of(dev)
    lib = _build.library("cmdring", PROTOTYPES["cmdring"])
    staged = {}
    for i, r in stage:  # a copy on the same stream, before the launch
        x = xs[i][r]
        staged[(i, r)] = x.reshape(-1)[:shape.in_ws[i]].clone()
    base = status.data_ptr()
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        tmpl, has_sync = packed[lo]
        d = tmpl.copy()
        d[:(hi - lo) * CMDRING_SLOT_WORDS] = words[lo:hi].reshape(-1)
        if staged:
            ptrs = d.view(np.uint64)
            for (i, r), t in staged.items():
                if lo <= i < hi:
                    ptrs[_IN + (i - lo) * P + r] = t.data_ptr()
        rc = lib.accl_sequencer(
            d.ctypes.data, base + 8 * lo,
            _barrier(dev, stream) if has_sync else None, stream)
        check_launch(lib, rc, "sequencer")
        sequencer.launches.bump()
    return status


sequencer.launches = LaunchCounter()
