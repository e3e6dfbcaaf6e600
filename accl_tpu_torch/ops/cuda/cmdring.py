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

A window with an fp8 or int8 wire (or a 16-bit wire under a nonzero
seed) takes the kernel's LANES instantiation, counted apart in
:func:`sequencer_lanes`; an int8 window's launch also takes a scratch
buffer for its segment scales.  :class:`PersistentRun` is the persistent
form: one cooperative launch that drains up to ``run_windows`` windows
posted into host-mapped memory, each window's completion a
:class:`RunTicket` in place of a CUDA event.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import threading
import time
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...cmdring import WindowShape
from ...constants import (
    CMDRING_FIELDS,
    CMDRING_MAX_RUN_WINDOWS,
    CMDRING_SLOT_WORDS,
    WIRE_SEGMENT_ELEMS,
    CmdOpcode,
    torch_to_dtype,
)
from ...wire import astype, dropped_mantissa_bits, is_scaled, lane_tiny, rank_seed
from . import _build
from ._build import INT, LL, PTR
from ._common import LaunchCounter, check_launch, on_cuda, stream_of
from .compression import dequantize_plain, quantize_plain, stochastic_cast_plain

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
#: the wires of the LANES instantiation, and the operand dtypes it takes
LANE_WIRES = (torch.float8_e4m3fn, torch.float8_e5m2, torch.int8)
LANE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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
    "accl_sequencer": (PTR, PTR, PTR, PTR, LL, PTR),
    "accl_sequencer_plan": (PTR,),
    "accl_sequencer_segment": (),
    "accl_sequencer_run": (PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, LL,
                           INT, INT, PTR),
    "accl_sequencer_ring": (PTR, INT, INT),
    "accl_mapped_alloc": (PTR, LL),
    # scripts/run_profile.py's: the one-shot kernel at a run's grid, and
    # the run's stamps (a build with ACCL_RUN_STAMPS)
    "accl_sequencer_grid": (PTR, PTR, PTR, PTR, LL, INT, PTR),
    "accl_run_stamps": (PTR, INT),
}}

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
    ("maxseg", np.int32),
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


def takes_lanes(words, wires) -> bool:
    """Whether a window's slots take the kernel's LANES instantiation: an
    fp8 or int8 wire, or a 16-bit wire under a nonzero seed word."""
    for i, wire in enumerate(wires):
        if wire in LANE_WIRES:
            return True
        if wire is not None and int(words[i, _F["flags"]]):
            return True
    return False


def scale_segments(shape: WindowShape, lo: int = 0,
                   hi: Optional[int] = None) -> int:
    """The most int8 segments of one operand row among slots ``lo:hi``
    (0: no int8 slot), as the kernel counts them."""
    return max((max(1, -(-shape.in_ws[i] // WIRE_SEGMENT_ELEMS))
                for i in range(lo, len(shape.in_ws) if hi is None else hi)
                if shape.wires[i] == torch.int8), default=0)


def lane_roundtrip(x: torch.Tensor, wire: Optional[torch.dtype],
                   seed: int) -> torch.Tensor:
    """One rank's contribution through a slot's wire lane, as JAX's
    ``_decode_slot_xla`` rounds it: the int8 lane quantizes with one
    absmax / 127 scale per 256 elements of the whole row and dequantizes;
    the float lanes round stochastically with the element's index as the
    counter under a nonzero ``seed`` (the rank's mixed seed), else to
    nearest even.  A 16-bit lane under seed 0 is the plain cast."""
    if wire is None:
        return x
    dt = torch_to_dtype(wire)
    if is_scaled(dt):
        q, scales = quantize_plain(x, seed, WIRE_SEGMENT_ELEMS)
        return dequantize_plain(q, scales, x.numel(), WIRE_SEGMENT_ELEMS,
                                x.dtype)
    if not seed and wire in (torch.float16, torch.bfloat16):
        return x.to(wire).to(x.dtype)
    return astype(stochastic_cast_plain(x, wire, seed,
                                        dropped_mantissa_bits(dt),
                                        lane_tiny(dt)), x.dtype)


def sequencer_plain(slots, xs, outs, shape: WindowShape) -> torch.Tensor:
    """The sequencer in plain PyTorch: slot by slot, every rank's result
    from :func:`slot_epilogue` over the operand rows rounded through the
    slot's wire lane (:func:`lane_roundtrip`, rank r's seed
    ``rank_seed(flags, r)``; None rows read as zeros), all of a slot's
    results computed before any is written.  Returns the status words."""
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
        flags = int(w[_F["flags"]]) & 0xFFFFFFFF
        blocks = [lane_roundtrip(x, wire, rank_seed(flags, r))
                  for r, x in enumerate(own)]
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


def _packed(words, xs, outs, shape: WindowShape, device=None):
    """The window's checked spans, verdict and descriptors (built once a
    key): ``(P, dev, stage, packed, per)``, ``dev`` the window's device
    (``device`` for a window of barriers alone) and ``packed[lo]`` the
    descriptor template of slots ``lo:lo + per`` and whether any of them
    waits at a barrier; ``packed`` is None off the card."""
    P, spans, first = _checked_spans(words, xs, outs, shape)
    n = words.shape[0]
    per = max(1, min(MAX_SLOTS, MAX_RANK_SLOTS // P))
    dev = (first.device if first is not None
           else torch.device(device if device is not None else "cpu"))
    if dev.type != "cuda":
        return P, dev, None, None, per
    if shape.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"sequencer kernel takes {_KERNEL_DTYPES}, "
                         f"got {shape.dtype}")
    sync, stage, packed = _cached(words, spans, shape, P, xs, outs)
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
    return P, dev, stage, packed, per


def _descriptor(packed, words, lo: int, hi: int, P: int, staged):
    """A launch's descriptor: the cached template of slots ``lo:hi`` with
    their slot words, and the staged copies' pointers in place of the
    operands they copy."""
    tmpl, has_sync = packed[lo]
    d = tmpl.copy()
    d[:(hi - lo) * CMDRING_SLOT_WORDS] = words[lo:hi].reshape(-1)
    if staged:
        ptrs = d.view(np.uint64)
        for (i, r), t in staged.items():
            if lo <= i < hi:
                ptrs[_IN + (i - lo) * P + r] = t.data_ptr()
    return d, has_sync


def _check_lanes(shape: WindowShape) -> None:
    if shape.dtype not in LANE_DTYPES:
        raise ValueError(f"sequencer: the fp8 / int8 lanes take "
                         f"{LANE_DTYPES} operands, got {shape.dtype}")


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
    cached descriptor and passes it as one pointer.  A launch whose slots
    take the LANES instantiation counts in ``sequencer_lanes.launches``,
    the others in ``sequencer.launches``; a LANES launch in the segment
    form (no int8 scale phase) also in ``sequencer_lanes.segment_launches``."""
    words = _words(slots)
    P, dev, stage, packed, per = _packed(words, xs, outs, shape, device)
    if packed is None:
        return sequencer_plain(words, xs, outs, shape)
    n = words.shape[0]
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
        d, has_sync = _descriptor(packed, words, lo, hi, P, staged)
        lanes = takes_lanes(words[lo:hi], shape.wires[lo:hi])
        maxseg = scale_segments(shape, lo, hi) if lanes else 0
        scales = None
        if lanes:
            _check_lanes(shape)
            if maxseg:
                scales = torch.empty((hi - lo) * P * maxseg,
                                     dtype=torch.float32, device=dev)
        rc = lib.accl_sequencer(
            d.ctypes.data, base + 8 * lo,
            _barrier(dev, stream) if has_sync or maxseg else None,
            None if scales is None else scales.data_ptr(),
            0 if scales is None else scales.numel(), stream)
        check_launch(lib, rc, "sequencer")
        (sequencer_lanes if lanes else sequencer).launches.bump()
        if lanes and lib.accl_sequencer_segment():
            sequencer_lanes.segment_launches.bump()
    return status


sequencer.launches = LaunchCounter()


def sequencer_lanes(slots, xs, outs, shape: WindowShape,
                    device=None) -> torch.Tensor:
    """Row 14's fp8 / int8 instantiation: :func:`sequencer` on a window
    whose wires take it (raises for any other window)."""
    if not takes_lanes(_words(slots), shape.wires):
        raise ValueError("sequencer_lanes: the window has no fp8 or int8 "
                         "wire and no seeded 16-bit wire")
    return sequencer(slots, xs, outs, shape, device=device)


sequencer_lanes.launches = LaunchCounter()
sequencer_lanes.segment_launches = LaunchCounter()


# ---------------------------------------------------------------------------
# the persistent form
# ---------------------------------------------------------------------------

#: a window's posted form (``csrc/cmdring.cu``'s ``kRunSeg``): the extents
#: of ``WINDOW``'s fields that n slots of P ranks use, in this order, each
#: ``(field, bytes a slot, bytes a rank-slot, fixed bytes)``; the first row
#: is the four header words from ``n_slots`` on
RUN_SEGMENTS = (("n_slots", 0, 0, 16), ("words", 44, 0, 0),
                ("in_w", 8, 0, 0), ("out_w", 8, 0, 0), ("chunk", 8, 0, 0),
                ("cols", 8, 0, 0), ("first", 8, 0, 8), ("cls", 4, 0, 0),
                ("wire", 4, 0, 0), ("sync", 4, 0, 0), ("parts", 4, 0, 0),
                ("in", 0, 8, 0), ("out", 0, 8, 0))


@functools.lru_cache(maxsize=64)
def run_layout(n: int, P: int) -> tuple:
    """The posted form of ``n`` slots of ``P`` ranks: ``((offset in
    WINDOW, offset in the posted form, bytes copied), ...)`` a field, and
    the form's size.  Each field starts at a 16-byte boundary and is
    copied in 8-byte words, so a 4-byte field of odd ``n`` takes its next
    (unused, zero) entry with it."""
    rows, c = [], 0
    for name, per_slot, per_rank, fixed in RUN_SEGMENTS:
        b = per_slot * n + per_rank * n * P + fixed
        rows.append((WINDOW.fields[name][1], c, -(-b // 8) * 8))
        c += -(-b // 16) * 16
    return tuple(rows), c


def run_bytes(n: int, P: int) -> int:
    """Bytes of the posted form of ``n`` slots of ``P`` ranks."""
    return run_layout(n, P)[1]


def posted_form(d: np.ndarray, n: int, P: int) -> np.ndarray:
    """The posted form (uint8) of the planned descriptor ``d`` (a
    ``WINDOW`` record, or its int32 view) of ``n`` slots of ``P``
    ranks."""
    full = np.ascontiguousarray(d).reshape(-1).view(np.uint8)
    rows, size = run_layout(n, P)
    out = np.zeros(size, np.uint8)
    for off, c, b in rows:
        out[c:c + b] = full[off:off + b]
    return out


def expand_posted(form: np.ndarray, n: int, P: int) -> np.ndarray:
    """The ``WINDOW`` record the run writes the posted form into (each
    field at its place, here in a zeroed record), as
    ``csrc/cmdring.cu::fetch_posted`` does."""
    d = np.zeros((), WINDOW)
    full = d.reshape(1).view(np.uint8)
    for off, c, b in run_layout(n, P)[0]:
        full[off:off + b] = form[c:c + b]
    return d


def _run_descriptor(packed, words, n: int, P: int, lanes: bool,
                    staged) -> np.ndarray:
    """A window's posted form for a run: planned once a descriptor
    template and instantiation (``accl_sequencer_plan`` fills its item
    prefix and int8 segments, which its slot words do not change), then
    its slot words copied in; a window with staged operand copies is
    planned on its own."""
    if staged:
        d, _ = _descriptor(packed, words, 0, n, P, staged)
        _plan(d)
        return posted_form(d, n, P)
    key = ("run", lanes)
    form = packed.get(key)
    if form is None:
        d, _ = _descriptor(packed, words, 0, n, P, {})
        _plan(d)
        form = packed[key] = posted_form(d, n, P)
    out = form.copy()
    _, c, _ = run_layout(n, P)[0][1]
    out[c:c + 44 * n] = words.reshape(-1).view(np.uint8)
    return out


def _plan(d: np.ndarray) -> None:
    lib = _build.library("cmdring", PROTOTYPES["cmdring"])
    check_launch(lib, lib.accl_sequencer_plan(d.ctypes.data), "sequencer plan")


#: the run's host-mapped block: its control words (``RunCtl``, 256 bytes:
#: ``posted`` and ``halt`` at words 0-1, ``done``, ``exited``, ``closing``
#: and ``ahead`` at words 32-35), then the status words and the posted
#: forms of up to CMDRING_MAX_RUN_WINDOWS windows (the largest, 64 slots of
#: 8 ranks, bounds a block's size)
_CTL_BYTES = 256
_STATUS_BYTES = MAX_SLOTS * 2 * 4
_DESCS = _CTL_BYTES + CMDRING_MAX_RUN_WINDOWS * _STATUS_BYTES
_MAPPED_BYTES = _DESCS + CMDRING_MAX_RUN_WINDOWS * run_bytes(
    MAX_SLOTS, MAX_RANK_SLOTS // MAX_SLOTS)
_DONE, _EXITED, _CLOSING, _AHEAD = 32, 33, 34, 35
#: why a run returned (``exited``)
EXIT_HALT, EXIT_BUDGET, EXIT_LINGER = 1, 2, 3

_mapped_free: List[int] = []
_mapped_lock = threading.Lock()


def _mapped_block() -> int:
    """A zeroed host-mapped block for one run (kept in a pool: each block
    is pinned memory the card reads over the bus)."""
    with _mapped_lock:
        if _mapped_free:
            return _mapped_free.pop()
    lib = _build.library("cmdring", PROTOTYPES["cmdring"])
    out = ctypes.c_void_p()
    rc = lib.accl_mapped_alloc(ctypes.byref(out), _MAPPED_BYTES)
    check_launch(lib, rc, "mapped memory for a sequencer run")
    return out.value


class RunTicket:
    """The completion of window ``k`` of a :class:`PersistentRun`, in
    place of the CUDA event a one-shot launch records: ``query()``,
    ``synchronize()`` and ``wait(stream)`` (the host waits: a stream
    cannot wait on a window inside a running kernel)."""

    __slots__ = ("run", "k")

    def __init__(self, run: "PersistentRun", k: int):
        self.run = run
        self.k = k

    def query(self) -> bool:
        return self.run.done() > self.k or self.run.failed is not None

    def synchronize(self) -> None:
        self.run.wait_window(self.k)

    def wait(self, stream=None) -> None:
        self.synchronize()


class PersistentRun:
    """Row 14's persistent form on the card: ONE cooperative launch of
    ``csrc/cmdring.cu``'s ``persistent_kernel`` that drains up to
    ``run_windows`` windows of one shape posted into host-mapped memory.

    :meth:`post` writes a window's posted form (:func:`run_layout`: the
    used extents of its descriptor, 1,344 bytes at 8 slots of 4 ranks
    against the descriptor's 14,616) into the window's slot of the mapped
    block and rings the doorbell; the form is planned once a descriptor
    template (:func:`_run_descriptor`), so a warm post copies its slot words
    into it and makes no call to ``accl_sequencer_plan``.  :meth:`launch`
    starts the run (after its first post, whose staged operand copies, if
    any, go on the stream before it).  On the card a window crosses the bus
    once; when it is posted before the window ahead of it ends, the run
    fetches it during that window and one grid barrier both ends the one
    and publishes the other (:meth:`ahead` counts those windows).  The run
    returns on the HALT doorbell (:meth:`halt`), once its budget is spent,
    or when its mailbox stays idle for ``linger_s`` by the card's clock.
    Closing at the linger is a handshake with the post
    (``csrc/cmdring.cu``, ``persistent_body``): a post the run closed on
    without reading returns None, and the caller runs the window
    elsewhere; it never reaches the run.  ``launches`` counts the runs,
    ``closed_posts`` the posts a closing run refused.

    On an H100 at 700 W (``scripts/run_profile.py``, windows of 8 x
    allreduce 1 Mi float32 at P = 4, every one posted ahead) a window takes
    0.1016 ms of device time in a run against 0.0947 a one-shot launch
    (0.1242 before this design, which moved the whole descriptor over the
    bus and met at two grid barriers a window); the host's post takes
    0.06-0.09 ms, most of it ``_packed``'s reading of the window's
    tensors."""

    launches = LaunchCounter()
    closed_posts = LaunchCounter()

    def __init__(self, shape: WindowShape, P: int, device: torch.device,
                 run_windows: int, linger_s: float, lanes: bool):
        if not 1 <= run_windows <= CMDRING_MAX_RUN_WINDOWS:
            raise ValueError(f"run_windows {run_windows} not in 1.."
                             f"{CMDRING_MAX_RUN_WINDOWS}")
        if lanes:
            _check_lanes(shape)
        self.shape, self.P, self.device = shape, int(P), device
        self.run_windows, self.linger_s = int(run_windows), float(linger_s)
        self.lanes = bool(lanes)
        self.ptr = _mapped_block()
        self.ctl = np.ctypeslib.as_array(
            (ctypes.c_int32 * (_CTL_BYTES // 4)).from_address(self.ptr))
        self.form_bytes = run_bytes(shape.depth, self.P)
        self.stage = torch.empty(2 * WINDOW.itemsize, dtype=torch.uint8,
                                 device=device)
        self.bar = torch.zeros(8, dtype=torch.int32, device=device)
        maxseg = scale_segments(shape)
        self.scales = (torch.empty(shape.depth * self.P * maxseg,
                                   dtype=torch.float32, device=device)
                       if maxseg else None)
        self.posted = 0
        self.keep: list = []  # staged copies the descriptors point at
        self.launched = False
        self.halted = False
        self.failed: Optional[str] = None
        self.fault: Optional[str] = None  # a CUDA error seen by ended()
        self.on_fail = None  # callback(reason), once, on a failure
        self.end_event = None
        self._final = (0, 0, 0)  # (done, exited, ahead) once returned
        self._lock = threading.Lock()
        _live_runs.add(self)

    # -- the host side -------------------------------------------------------
    def done(self) -> int:
        """Windows the run has completed (its release store)."""
        ctl = self.ctl
        return self._final[0] if ctl is None else int(ctl[_DONE])

    def exited(self) -> int:
        """0 while the run lives, else why it returned (EXIT_*)."""
        ctl = self.ctl
        return self._final[1] if ctl is None else int(ctl[_EXITED])

    def ahead(self) -> int:
        """Windows the run fetched during the window ahead of them (as of
        its last ``done``)."""
        ctl = self.ctl
        return self._final[2] if ctl is None else int(ctl[_AHEAD])

    @property
    def accepting(self) -> bool:
        return (not self.halted and self.failed is None
                and self.posted < self.run_windows and not self.exited())

    def post(self, words, xs, outs) -> Optional[int]:
        """Post one window (slot words, operand and result rows, as for
        :func:`sequencer`); returns its index in the run, or None when the
        run cannot take it (halted, spent, lingered out, another
        instantiation, more than one descriptor, or, once launched, an
        operand to stage, or the run closed at the linger before it read
        the window).  Raises what a one-shot launch would."""
        words = _words(words)
        n = words.shape[0]
        with self._lock:
            if not self.accepting or launches_for(self.P, n) != 1:
                return None
            if takes_lanes(words, self.shape.wires) != self.lanes:
                return None
            P, _, stage, packed, _ = _packed(words, xs, outs, self.shape,
                                             self.device)
            if packed is None or P != self.P:
                return None
            if stage and self.launched:
                return None
            staged = {(i, r): xs[i][r].reshape(-1)[:self.shape.in_ws[i]]
                      .clone() for i, r in stage}
            form = _run_descriptor(packed, words, n, P, self.lanes, staged)
            k = self.posted
            ctypes.memmove(self.ptr + _DESCS + k * self.form_bytes,
                           form.ctypes.data, self.form_bytes)
            lib = _build.library("cmdring", PROTOTYPES["cmdring"])
            closing = lib.accl_sequencer_ring(self.ptr, k + 1, 0)
            if self.launched and closing == k + 1 and not self._took(k):
                PersistentRun.closed_posts.bump()
                return None
            if staged:
                self.keep.append(staged)
            self.posted = k + 1
            return k

    def _took(self, k: int) -> bool:
        """The host's side of the closing handshake: the run was closing
        at window k when the doorbell rang, so wait for its decision: it
        clears ``closing`` once it took the window, or returns without
        it."""
        ctl = self.ctl
        while int(ctl[_CLOSING]) == k + 1 and not int(ctl[_EXITED]):
            if self.ended():
                break
            time.sleep(0)
        return self.done() > k or not self.exited()

    def launch(self) -> None:
        """Start the run on the device's current stream."""
        lib = _build.library("cmdring", PROTOTYPES["cmdring"])
        stream = stream_of(self.device)
        rc = lib.accl_sequencer_run(
            self.ptr, self.ptr + _DESCS, self.ptr + _CTL_BYTES,
            self.stage.data_ptr(), self.bar.data_ptr(),
            None if self.scales is None else self.scales.data_ptr(),
            int(torch_to_dtype(self.shape.dtype)), int(self.lanes),
            self.run_windows, int(self.linger_s * 1e9), self.shape.depth,
            self.P, stream)
        check_launch(lib, rc, "persistent sequencer")
        PersistentRun.launches.bump()
        self.end_event = torch.cuda.Event()
        self.end_event.record(torch.cuda.current_stream(self.device))
        self.launched = True

    def ticket(self, k: int) -> RunTicket:
        return RunTicket(self, k)

    def status(self, k: int, n: int) -> np.ndarray:
        """Window k's status words, as the run wrote them."""
        words = np.ctypeslib.as_array(
            (ctypes.c_int32 * (2 * n)).from_address(
                self.ptr + _CTL_BYTES + k * _STATUS_BYTES))
        return words.reshape(n, 2).copy()

    def halt(self) -> None:
        """The HALT doorbell: the run finishes what was posted and
        returns."""
        with self._lock:
            if self.halted or self.ptr is None:
                return
            self.halted = True
            lib = _build.library("cmdring", PROTOTYPES["cmdring"])
            lib.accl_sequencer_ring(self.ptr, 0, 1)

    def ended(self) -> bool:
        """Whether the run's kernel has returned (or never launched, or
        faulted: the fault is kept for :meth:`wait_window` to latch, as
        callers may hold the ring's lock here)."""
        if not self.launched:
            return True
        try:
            return bool(self.end_event.query())
        except RuntimeError as e:  # a fault in the run
            self.fault = f"{type(e).__name__}: {e}"
            return True

    def fail(self, reason: str) -> None:
        """Latch a failure once: the callback fails every window the run
        has not completed."""
        with self._lock:
            if self.failed is not None:
                return
            self.failed = reason[:300]
            cb = self.on_fail
        self.halt()
        if cb is not None:
            cb(self.failed)

    def wait_window(self, k: int, timeout: float = 60.0) -> bool:
        """Block the host until window k is done (True), or latch the
        run's failure (False): it returned without the window, its kernel
        faulted, or the deadline passed."""
        deadline = time.monotonic() + timeout
        while self.done() <= k:
            if self.failed is not None:
                return False
            if self.exited() or (self.launched and self.ended()):
                if self.done() > k:
                    break
                self.fail(self.fault or f"the run returned before window {k}")
                return False
            if time.monotonic() > deadline:
                self.fail(f"window {k} not done within {timeout} s")
                return False
            time.sleep(2e-5)
        return True

    def join(self, timeout: float = 10.0) -> bool:
        """Halt the run and wait until its kernel returned; its mapped
        block then goes back to the pool.  False when it did not within
        ``timeout``."""
        self.halt()
        deadline = time.monotonic() + timeout
        while not self.ended():
            if time.monotonic() > deadline:
                return False
            time.sleep(1e-4)
        with self._lock:
            ptr, self.ptr = self.ptr, None
            if ptr is not None:
                self._final = (self.done(), self.exited(), self.ahead())
                self.ctl = None
        if ptr is not None:
            ctypes.memset(ptr, 0, _CTL_BYTES)
            with _mapped_lock:
                _mapped_free.append(ptr)
        self.keep = []
        _live_runs.discard(self)
        return True


_live_runs: "weakref.WeakSet[PersistentRun]" = weakref.WeakSet()


@atexit.register
def _halt_live_runs() -> None:
    """At interpreter exit no run may keep a kernel spinning."""
    for run in list(_live_runs):
        try:
            run.join(timeout=5.0)
        except Exception:
            pass
