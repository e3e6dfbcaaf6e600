"""Command-ring host half: the slot codec, the window shape and the
persistent sequencer's mailbox.

The port's own copy of the jax-free ``accl_tpu/cmdring.py``:

* the slot codec: ``encode_slot`` / ``decode_slot`` / ``encode_window``
  pack a collective into ``CMDRING_SLOT_WORDS`` int32 words through the
  one layout table (:data:`accl_tpu_torch.constants.CMDRING_FIELDS`),
  ``ring_widths`` gives a slot's operand and result widths,
  ``fused_slot_eligible`` says why a fused call cannot ride a slot,
  ``complementary_pair`` is the one definition of a matched SEND/RECV
  pair, and :class:`WindowShape` is what selects the sequencer's code
  path;
* the mailbox: :class:`SequencerMailbox` is what one persistent
  sequencer *run* drains.  While a run is live, a refill window is a
  ``post`` (a memory write), not a launch; a run pulls up to
  ``run_windows`` windows and halts once its mailbox stays empty for
  ``linger_s``, so an idle run never holds the device.  The first rank
  to pull step ``s`` decides it (window or HALT) and every rank reads
  the same decision.

The device half is ``ops/cmdring.py``, the gang engine's window
management ``backends/cuda/cmdring.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .constants import (
    CMDRING_FIELDS,
    CMDRING_FPARAM_ONE,
    CMDRING_LINGER_ENV,
    CMDRING_LINGER_MS_DEFAULT,
    CMDRING_MAX_RUN_WINDOWS,
    CMDRING_RUN_WINDOWS_DEFAULT,
    CMDRING_RUN_WINDOWS_ENV,
    CMDRING_SLOT_WORDS,
    CmdOpcode,
    CompressionFlags,
    FusedCompute,
    Operation,
    ReduceFunction,
)

_F = CMDRING_FIELDS


def encode_slot(
    seqn: int,
    opcode: CmdOpcode,
    count: int,
    dtype: int = 0,
    function: ReduceFunction = ReduceFunction.SUM,
    root: int = 0,
    flags: int = 0,
    nseg: int = 1,
    peer: int = 0,
    wire: int = 0,
    fparam: int = 0,
) -> np.ndarray:
    """One command slot as ``(CMDRING_SLOT_WORDS,)`` int32, every field
    written through :data:`CMDRING_FIELDS`."""
    words = np.zeros(CMDRING_SLOT_WORDS, np.int32)
    words[_F["seqn"]] = int(seqn) & 0x7FFFFFFF
    words[_F["opcode"]] = int(opcode)
    words[_F["count"]] = int(count)
    words[_F["dtype"]] = int(dtype)
    words[_F["function"]] = int(function)
    words[_F["root"]] = int(root)
    words[_F["flags"]] = int(flags)
    words[_F["nseg"]] = max(1, int(nseg))
    words[_F["peer"]] = int(peer)
    words[_F["wire"]] = int(wire)
    words[_F["fparam"]] = int(fparam)
    return words


def encode_fparam(x: float) -> int:
    """A fused epilogue's scalar as the Q16.16 fparam word (exact for the
    power-of-two scales training uses), clamped to int32."""
    q = int(round(float(x) * CMDRING_FPARAM_ONE))
    return max(-(2 ** 31), min(2 ** 31 - 1, q))


def decode_fparam(word: int) -> float:
    """The host-side inverse of :func:`encode_fparam`."""
    return float(int(word)) / CMDRING_FPARAM_ONE


def decode_slot(words) -> dict:
    """The encoder's inverse."""
    w = np.asarray(words).reshape(-1)
    if w.size != CMDRING_SLOT_WORDS:
        raise ValueError(
            f"slot has {w.size} words, layout says {CMDRING_SLOT_WORDS}"
        )
    out = {name: int(w[idx]) for name, idx in _F.items()}
    out["opcode"] = CmdOpcode(out["opcode"])
    return out


def encode_window(slots: Sequence[np.ndarray], depth: int) -> np.ndarray:
    """Stack encoded slots into a ``(depth, CMDRING_SLOT_WORDS)`` window,
    NOP-padding the tail (padding slots report OK and move nothing)."""
    if len(slots) > depth:
        raise ValueError(f"{len(slots)} slots into a depth-{depth} window")
    rows = [np.asarray(s, np.int32).reshape(-1) for s in slots]
    while len(rows) < depth:
        rows.append(encode_slot(0, CmdOpcode.NOP, 0))
    return np.stack(rows).astype(np.int32)


def complementary_pair(calls) -> Optional[Tuple[int, int]]:
    """(src, dst) when a world-2 batch position holds a matched SEND/RECV
    pair: the one pair definition of the ring planner and the engine's
    direct delivery.  A matched pair agrees on roles, count, tag and
    operand dtype and carries no wire compression.  None otherwise."""
    if len(calls) != 2:
        return None
    ops = [c.op for c in calls]
    if sorted(ops) != sorted((Operation.SEND, Operation.RECV)):
        return None
    src = ops.index(Operation.SEND)
    dst = ops.index(Operation.RECV)
    snd, rcv = calls[src], calls[dst]
    if (
        snd.root_dst != dst or rcv.root_src != src
        or snd.count != rcv.count or snd.tag != rcv.tag
        or snd.arithcfg.uncompressed != rcv.arithcfg.uncompressed
        or (snd.compression | rcv.compression)
        & CompressionFlags.ETH_COMPRESSED
    ):
        return None
    return src, dst


def ring_widths(
    op: Operation, count: int, size: int, fuse: int = 0
) -> Tuple[int, int]:
    """(operand width, result width) in elements of one ring slot.
    BARRIER rides a one-element token.  Fused slots pack their compute
    operands into the same operand row: MATMUL_RS the reduce-scatter
    geometry ``(n*size, n)``, APPLY gradients plus this rank's param chunk
    ``(n*(size+1), n)``, ATTN_HOP kv then q ``(2n, n)``."""
    n = int(count)
    fuse = FusedCompute(int(fuse))
    if fuse == FusedCompute.APPLY:
        return n * (size + 1), n
    if fuse == FusedCompute.ATTN_HOP:
        return 2 * n, n
    if op in (Operation.REDUCE_SCATTER, Operation.ALLTOALL):
        in_w = n * size
    elif op == Operation.BARRIER:
        in_w = 1
    else:
        in_w = n
    if op in (Operation.ALLGATHER, Operation.ALLTOALL):
        out_w = n * size
    elif op == Operation.BARRIER:
        out_w = 1
    else:
        out_w = n
    return in_w, out_w


#: FusedCompute -> the base Operation its call rides
FUSED_BASE_OPS = {
    FusedCompute.MATMUL_RS: Operation.REDUCE_SCATTER,
    FusedCompute.APPLY: Operation.ALLREDUCE,
    FusedCompute.ATTN_HOP: Operation.ALLREDUCE,
}


def _dtype_of(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    from .constants import as_datatype, dtype_to_torch

    return dtype_to_torch(as_datatype(dtype))


#: the dtypes numpy counts as floats (kind "f"): the JAX predicate's test,
#: under which bfloat16 (an ml_dtypes kind "V") is refused as fused_dtype
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def fused_slot_eligible(
    fuse: int,
    op: Operation,
    size: int,
    count: int,
    operand_count: int,
    dtype,
    compressed: bool = False,
) -> Optional[str]:
    """Why a fused call CANNOT ride a ring slot (None = eligible): it
    needs its base operation, a world of at least 2, a float16, float32 or
    float64 operand (bfloat16 is refused, as by the JAX predicate), an
    operand row of exactly the fused width and no wire compression.
    ``dtype`` is a torch dtype, a DataType or a dtype name."""
    try:
        fuse = FusedCompute(int(fuse))
    except ValueError:
        return "unknown_fuse"
    if fuse == FusedCompute.NONE:
        return None
    base = FUSED_BASE_OPS.get(fuse)
    if base is None or op != base:
        return "fused_base_op"
    if int(size) < 2:
        return "fused_world_too_small"
    if _dtype_of(dtype) not in _NUMPY_FLOATS:
        return "fused_dtype"
    in_w, _ = ring_widths(base, count, size, fuse=fuse)
    if int(operand_count) != in_w:
        return "fused_operand_width"
    if compressed:
        return "fused_compressed"
    return None


def dtype_name(dtype: Optional[torch.dtype]) -> Optional[str]:
    """A torch dtype's name as numpy spells it (``torch.bfloat16`` ->
    ``"bfloat16"``); None stays None."""
    return None if dtype is None else str(dtype).rsplit(".", 1)[-1]


class WindowShape:
    """Static shape of a refill window: the depth, every slot's operand
    and result width, its wire dtype (None for none) and the payload
    dtype.  Slot CONTENT (opcode, function, root, peer, fparam, seqn)
    stays data, read by the sequencer from the slot words; the shape may
    select its code path, as it keys the JAX program cache.  ``key()``
    equals the JAX package's for the same window."""

    __slots__ = ("depth", "in_ws", "out_ws", "wires", "dtype")

    def __init__(self, depth: int, in_ws, out_ws, wires, dtype):
        self.depth = int(depth)
        self.in_ws = tuple(int(w) for w in in_ws)
        self.out_ws = tuple(int(w) for w in out_ws)
        self.wires = tuple(None if w is None else _dtype_of(w)
                           for w in wires)
        self.dtype = _dtype_of(dtype)

    def key(self) -> tuple:
        return (self.depth, self.in_ws, self.out_ws,
                tuple(dtype_name(w) for w in self.wires),
                dtype_name(self.dtype))

    def __eq__(self, other) -> bool:
        return isinstance(other, WindowShape) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())


# ---------------------------------------------------------------------------
# the persistent sequencer's knobs and mailbox
# ---------------------------------------------------------------------------


def default_run_windows() -> int:
    """Refill windows one sequencer run drains before it returns."""
    try:
        n = int(os.environ.get(CMDRING_RUN_WINDOWS_ENV,
                               CMDRING_RUN_WINDOWS_DEFAULT))
    except ValueError:
        n = CMDRING_RUN_WINDOWS_DEFAULT
    return max(1, min(n, CMDRING_MAX_RUN_WINDOWS))


def default_linger_s() -> float:
    """How long a live run waits on an empty mailbox before it halts:
    small, since a lingering run holds the device, so anything else
    launched there waits at most this long."""
    try:
        ms = float(os.environ.get(CMDRING_LINGER_ENV,
                                  CMDRING_LINGER_MS_DEFAULT))
    except ValueError:
        ms = CMDRING_LINGER_MS_DEFAULT
    return max(0.0, ms) / 1e3


class _PostedWindow:
    __slots__ = ("window_id", "slots", "payload", "status", "results",
                 "pushed")

    def __init__(self, window_id: int, slots: np.ndarray, payload):
        self.window_id = window_id
        self.slots = np.asarray(slots, np.int32)
        # payload[i][r]: rank r's operand row of slot i (None pulls as
        # zeros), or payload[i] None for a slot without operands
        self.payload = payload
        self.status: Optional[np.ndarray] = None
        self.results: Dict[int, list] = {}  # rank -> per-slot results
        self.pushed = 0


class SequencerMailbox:
    """One sequencer run's mailbox (commands in, status out).
    ``pull(rank)`` is the run's per-step window fetch, ``post`` the
    host's refill, ``push(rank, ...)`` the run's per-step status and
    result writeback.  ``on_window_done(window_id, status, results)``
    fires, outside every mailbox lock, once every rank pushed a
    window's step."""

    def __init__(self, size: int, shape: WindowShape,
                 run_windows: Optional[int] = None,
                 linger_s: Optional[float] = None,
                 on_window_done: Optional[Callable] = None):
        self.size = int(size)
        self.shape = shape
        self.run_windows = (run_windows if run_windows is not None
                            else default_run_windows())
        self.linger_s = (linger_s if linger_s is not None
                         else default_linger_s())
        self.on_window_done = on_window_done
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[_PostedWindow] = []
        self._decisions: List[Optional[_PostedWindow]] = []  # None = HALT
        self._pull_cursor = [0] * self.size
        self._push_cursor = [0] * self.size
        self._halt_seen = [False] * self.size
        self._accepted = 0
        self._halted = False
        self.drained = threading.Event()  # every rank pulled a HALT
        # per-window host timing: posted_ns, pulled_ns (the first rank's
        # fetch) and pushed_ns (the last rank's writeback), pruned once
        # read
        self._timings: Dict[int, Dict[str, int]] = {}

    # -- introspection -------------------------------------------------------
    def depth(self) -> int:
        """Posted windows not yet pulled (how far the host runs ahead)."""
        with self._lock:
            return len(self._queue)

    def take_timing(self, window_id: int) -> Optional[Dict[str, int]]:
        """The window's host timing record, removed."""
        with self._lock:
            return self._timings.pop(int(window_id), None)

    # -- host side -----------------------------------------------------------
    def post(self, window_id: int, slots: np.ndarray, payload) -> bool:
        """Queue one refill window.  False when this run can no longer
        take it (halted, or its window budget is spent): the caller
        arms a fresh run instead."""
        with self._cv:
            if self._halted or self._accepted >= self.run_windows:
                return False
            self._accepted += 1
            self._queue.append(_PostedWindow(window_id, slots, payload))
            self._timings[int(window_id)] = {
                "posted_ns": time.perf_counter_ns()}
            if len(self._timings) > 4 * self.run_windows:
                for k in sorted(self._timings)[:-2 * self.run_windows]:
                    del self._timings[k]
            self._cv.notify_all()
            return True

    def halt(self) -> None:
        """The teardown doorbell: accept no more posts; the run drains
        what is queued (those windows' requests wait on it), then
        returns."""
        with self._cv:
            self._halted = True
            self._cv.notify_all()

    @property
    def accepting(self) -> bool:
        with self._lock:
            return not self._halted and self._accepted < self.run_windows

    # -- run side ------------------------------------------------------------
    def pull(self, rank: int):
        """One rank's step: ``(live, slots, rows)``, ``live`` 0 with zero
        slots and rows on a HALT step.  The first rank to reach a step
        decides it, waiting at most ``linger_s`` on an empty queue;
        every other rank reads the same decision."""
        r = int(rank)
        with self._cv:
            step = self._pull_cursor[r]
            self._pull_cursor[r] += 1
            while len(self._decisions) <= step:
                if self._queue:
                    nxt = self._queue.pop(0)
                    t = self._timings.get(nxt.window_id)
                    if t is not None and "pulled_ns" not in t:
                        t["pulled_ns"] = time.perf_counter_ns()
                    self._decisions.append(nxt)
                    break
                if self._halted:
                    self._decisions.append(None)
                    break
                # the linger, measured afresh each step
                deadline = time.monotonic() + self.linger_s
                decided = len(self._decisions)
                while (not self._queue and not self._halted
                       and len(self._decisions) == decided):
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    self._cv.wait(min(rem, 0.05))
                if (not self._queue and not self._halted
                        and len(self._decisions) == decided):
                    self._halted = True  # the linger expired: park
                self._cv.notify_all()
            win = self._decisions[step]
            if win is None:
                self._halt_seen[r] = True
                if all(self._halt_seen):
                    self.drained.set()
                self._cv.notify_all()
        if win is None:
            return self._halt_payload()
        sh = self.shape
        rows = []
        for i, p in enumerate(win.payload):
            row = p[r] if p is not None else None
            if row is None:
                row = torch.zeros(sh.in_ws[i], dtype=sh.dtype)
            rows.append(row)
        return (np.int32(1), win.slots, rows)

    def _halt_payload(self):
        sh = self.shape
        return (np.int32(0),
                np.zeros((sh.depth, CMDRING_SLOT_WORDS), np.int32),
                [torch.zeros(w, dtype=sh.dtype) for w in sh.in_ws])

    def push(self, rank: int, live: int, status: np.ndarray,
             outs: list) -> None:
        """One rank's status and result writeback for its current step;
        the window's callback fires once every rank pushed."""
        r = int(rank)
        done = None
        with self._cv:
            step = self._push_cursor[r]
            self._push_cursor[r] += 1
            win = (self._decisions[step] if step < len(self._decisions)
                   else None)
            if win is not None and int(live):
                win.results[r] = list(outs)
                if win.status is None:
                    win.status = np.asarray(status, np.int32).copy()
                win.pushed += 1
                if win.pushed == self.size:
                    done = win
                    t = self._timings.get(win.window_id)
                    if t is not None:
                        t["pushed_ns"] = time.perf_counter_ns()
            self._cv.notify_all()
        if done is not None and self.on_window_done is not None:
            self.on_window_done(done.window_id, done.status, done.results)


# ---------------------------------------------------------------------------
# the mailbox registry: a run addresses its mailbox by id
# ---------------------------------------------------------------------------

_REGISTRY: Dict[int, SequencerMailbox] = {}
_REGISTRY_LOCK = threading.Lock()
_NEXT_ID = [1]


def register_mailbox(mbox: SequencerMailbox) -> int:
    with _REGISTRY_LOCK:
        mid = _NEXT_ID[0]
        _NEXT_ID[0] += 1
        _REGISTRY[mid] = mbox
        return mid


def mailbox_for(mid: int) -> Optional[SequencerMailbox]:
    with _REGISTRY_LOCK:
        return _REGISTRY.get(int(mid))


def unregister_mailbox(mid: int) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.pop(int(mid), None)
