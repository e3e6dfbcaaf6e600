"""The gang engine's command ring: batched windows as sequencer launches.

The counterpart of ``accl_tpu/backends/xla/cmdring.py`` in its inline
form.  A flushed batch of eligible collectives is encoded into the slots
of the communicator's ring (``seqn`` and ``head`` advance per slot, the
head wraps past the ring depth) and each window of at most ``depth``
slots runs as ONE launch of the sequencer kernel (``ops/cmdring.py``),
which decodes the slot words on the device.  A batch the ring refuses
runs position by position through the per-call path, with the reason
counted in :meth:`GangCommandRing.stats` under the JAX package's names:
``tuning_override``, ``unsupported_op``, ``oversized``,
``host_operands``, ``mixed_dtype``, ``data_dependency`` and the
``fused_*`` reasons (``fused_decomposed`` is counted by the engine).

What the JAX ring has and this one does not (yet): the persistent
mailbox run (on the card, a persistent kernel polling host-mapped
memory), SEND/RECV pair slots, circuit breakers, chaos hooks, QoS slot
budgets and the window log.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ...cmdring import (
    WindowShape,
    encode_fparam,
    encode_slot,
    fused_slot_eligible,
    ring_widths,
)
from ...constants import (
    CMDRING_DEPTH_DEFAULT,
    CMDRING_DEPTH_ENV,
    CMDRING_ENV,
    CMDRING_FUSED_OPCODES,
    CMDRING_MAX_BYTES_ENV,
    CMDRING_MAX_DEPTH,
    CMDRING_MAX_PAYLOAD_BYTES,
    CMDRING_OPCODES,
    CMDRING_SLOT_WORDS,
    CMDRING_ST_OK,
    ErrorCode,
    FusedCompute,
    Operation,
)
from ...ops.cmdring import run_window, status_words
from ...ops.cuda.cmdring import launches_for

#: ops whose operand/result widths scale with world size
_P_WIDE = (Operation.REDUCE_SCATTER, Operation.ALLTOALL)

#: wire lanes the sequencer decodes (None: an uncompressed slot)
SEQUENCER_WIRES = (None, torch.float16, torch.bfloat16)

#: the algorithm registers whose non-default value keeps its meaning
#: (the ring is its own lowering and must not shadow a requested one)
BATCH_TUNING_KEYS = (
    "allreduce_algorithm", "reduce_algorithm", "bcast_algorithm",
    "scatter_algorithm", "gather_algorithm",
)


def _env_mode() -> str:
    return os.environ.get(CMDRING_ENV, "1").strip().lower()


def buffer_root(buf) -> int:
    """Identity of the storage a buffer views (slices of one buffer share
    it), the key of the ``data_dependency`` screen."""
    return buf.tensor.untyped_storage().data_ptr()


class _RingSession:
    """Per-communicator ring state: the host mirror of the ring (slot i of
    refill k+1 reuses the words of slot i of refill k-depth), the monotone
    seqn, and the last window's status words."""

    __slots__ = ("ring", "head", "seqn", "last_status", "status_event")

    def __init__(self, depth: int):
        self.ring = np.zeros((depth, CMDRING_SLOT_WORDS), np.int32)
        self.head = 0
        self.seqn = 0
        self.last_status: Optional[torch.Tensor] = None
        self.status_event = None


class GangCommandRing:
    """One gang context's command ring (all communicators' sessions)."""

    def __init__(self, gang):
        self.gang = gang
        mode = _env_mode()
        self.enabled = mode not in ("0", "off", "false", "")
        self.eager = mode == "eager"
        try:
            depth = int(os.environ.get(CMDRING_DEPTH_ENV,
                                       CMDRING_DEPTH_DEFAULT))
        except ValueError:
            depth = CMDRING_DEPTH_DEFAULT
        self.depth = max(1, min(depth, CMDRING_MAX_DEPTH))
        try:
            self.max_bytes = int(os.environ.get(CMDRING_MAX_BYTES_ENV,
                                                CMDRING_MAX_PAYLOAD_BYTES))
        except ValueError:
            self.max_bytes = CMDRING_MAX_PAYLOAD_BYTES
        self._lock = threading.Lock()
        self._sessions: Dict[int, _RingSession] = {}
        self.refills = 0          # refill windows (= doorbells)
        self.dispatches = 0       # sequencer kernel launches
        self.slots_enqueued = 0   # collectives executed ring-resident
        self.wraps = 0            # head wrapped past the ring depth
        self.max_window = 0
        self.last_window = 0
        self.op_slots: Dict[str, int] = {}
        self.fallbacks: Dict[str, int] = {}

    # -- introspection -------------------------------------------------------
    def supports(self, op) -> bool:
        """Whether ``op`` has a sequencer opcode on this ring (the JAX
        table minus the SEND/RECV pair slots)."""
        return (op in CMDRING_OPCODES
                and op not in (Operation.SEND, Operation.RECV))

    def last_status(self, comm_id: int) -> Optional[np.ndarray]:
        """The most recent window's status words of a communicator, read
        from host memory once that window's event has passed (it waits on
        the event alone, never on the device)."""
        with self._lock:
            s = self._sessions.get(comm_id)
            if s is None or s.last_status is None:
                return None
            status, event = s.last_status, s.status_event
        if event is not None:
            event.synchronize()
        return status.numpy().copy()

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "mode": "eager" if self.eager else
                        ("batch" if self.enabled else "off"),
                "depth": self.depth,
                "refills": self.refills,
                "doorbells": self.refills,  # every refill rings once
                "dispatches": self.dispatches,
                "slots": self.slots_enqueued,
                "wraps": self.wraps,
                "max_window": self.max_window,
                "occupancy": round(self.last_window / self.depth, 3)
                if self.last_window else 0.0,
                "ops": dict(self.op_slots),
                "fallbacks": dict(self.fallbacks),
            }

    def _fallback(self, reason: str) -> bool:
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        return False

    def note_fallback(self, reason: str) -> None:
        """Count a ring miss decided outside run_batch (the engine's fused
        host decomposition)."""
        self._fallback(reason)

    def reset(self) -> None:
        """Realign every session's seqn and head at 0."""
        with self._lock:
            self._sessions.clear()

    # -- position planning ---------------------------------------------------
    def _plan_barrier(self, comm, dtype) -> dict:
        return {"op": Operation.BARRIER, "n": 1, "dtype": dtype,
                "compressed": False, "wire": None, "writers": set()}

    def _plan_fused(self, comm, calls, lead, plan, fuse: int):
        """Re-validate a planned position against the fused geometry;
        returns the plan with its fuse fields, or the fallback reason."""
        in_w, _ = ring_widths(lead.op, lead.count, comm.size, fuse=fuse)
        opn = in_w
        for c in calls:
            buf = c.op0
            if buf is None or buf.is_dummy:
                opn = 0
                break
            if buf.count < in_w:
                opn = min(opn, int(buf.count))
        reason = fused_slot_eligible(
            fuse, lead.op, comm.size, lead.count, opn, plan["dtype"],
            compressed=bool(plan["compressed"]),
        )
        if reason is not None:
            return reason
        patched = dict(plan)
        patched["fuse"] = int(fuse)
        patched["fparam"] = float(lead.fuse_param)
        if FusedCompute(fuse) == FusedCompute.ATTN_HOP:
            patched["hop"] = int(lead.root_src) % comm.size
        return patched

    def _slot_opcode(self, plan):
        fuse = plan.get("fuse", 0)
        if fuse:
            return CMDRING_FUSED_OPCODES[FusedCompute(fuse)]
        return CMDRING_OPCODES[plan["op"]]

    # -- the refill path -----------------------------------------------------
    def run_batch(self, comm, entries, npos: int,
                  t0: Optional[int] = None) -> bool:
        """Execute a fully matched batch ring-resident.  Returns False,
        having launched NOTHING, when any position disqualifies (the
        sequential path then owns the batch); True once the ring owns the
        requests' completion."""
        if not self.enabled or npos == 0:
            return False
        gang = self.gang
        if any(gang.tuning.get(k, "xla") != "xla"
               for k in BATCH_TUNING_KEYS):
            return self._fallback("tuning_override")
        if t0 is None:
            t0 = time.perf_counter_ns()
        plans = []
        written: set = set()  # result roots of earlier positions
        window_dtype = None
        barrier_positions = []
        for i in range(npos):
            calls = [e[0][i] for e in entries]
            lead = calls[0]
            if not self.supports(lead.op):
                return self._fallback("unsupported_op")
            if any(gang._sig(c) != gang._sig(lead) for c in calls[1:]):
                return False  # torn gang: surface through the per-call path
            if lead.op == Operation.BARRIER:
                barrier_positions.append(i)
                plans.append((calls, lead, None))
                continue
            fuse = int(lead.fuse)
            if fuse:
                n_eff, _ = ring_widths(lead.op, lead.count, comm.size,
                                       fuse=fuse)
            else:
                n_eff = lead.count * (comm.size if lead.op in _P_WIDE else 1)
            if n_eff * lead.arithcfg.uncompressed_elem_bytes > self.max_bytes:
                return self._fallback("oversized")
            plan = gang._plan_device_call(comm, calls, lead)
            if plan is None:
                return self._fallback("host_operands")
            if plan["wire"] not in SEQUENCER_WIRES:
                # the sequencer's fp8 / int8 slots are not ported yet
                return self._fallback("wire_lane")
            if fuse:
                plan = self._plan_fused(comm, calls, lead, plan, fuse)
                if isinstance(plan, str):
                    return self._fallback(plan)
            if window_dtype is None:
                window_dtype = plan["dtype"]
            elif plan["dtype"] != window_dtype:
                return self._fallback("mixed_dtype")
            # every slot reads its operands as they were before the
            # window: a position reading an earlier position's result
            # must run in order on the per-call path
            for call in calls:
                buf = call.op0
                if (buf is not None and not buf.is_dummy
                        and buffer_root(buf) in written):
                    return self._fallback("data_dependency")
            for r in plan["writers"]:
                res = calls[r].res
                if res is not None and not res.is_dummy:
                    written.add(buffer_root(res))
            plans.append((calls, lead, plan))
        if window_dtype is None:
            window_dtype = torch.float32  # an all-barrier window
        for i in barrier_positions:
            calls, lead, _ = plans[i]
            plans[i] = (calls, lead, self._plan_barrier(comm, window_dtype))

        for lo in range(0, npos, self.depth):
            window = plans[lo:lo + self.depth]
            reqs_per_slot = [[e[1][i] for e in entries]
                             for i in range(lo, lo + len(window))]
            try:
                self._dispatch_window(comm, window, reqs_per_slot, t0)
            except Exception as e:
                # fail this window's slots and the rest; earlier windows
                # were launched and stay completed.  Never re-execute.
                ctx = {"comm": comm.id,
                       "error": f"{type(e).__name__}: {e}"[:300]}
                dt = time.perf_counter_ns() - t0
                for i in range(lo, npos):
                    for e_ in entries:
                        req = e_[1][i]
                        if not req.done():
                            req.ring_resident = True
                            req.complete(ErrorCode.INVALID_OPERATION, dt,
                                         context=dict(ctx, op=req.op_name))
                break
        return True

    # -- slot encoding -------------------------------------------------------
    def _encode(self, session: _RingSession, lead, plan) -> np.ndarray:
        op = plan["op"]
        wire = int(lead.arithcfg.compressed) if plan["wire"] is not None else 0
        words = encode_slot(
            session.seqn, self._slot_opcode(plan), plan["n"],
            dtype=int(lead.arithcfg.uncompressed),
            function=lead.reduce_function,
            root=lead.root_src if op == Operation.BCAST else 0,
            nseg=1, peer=plan.get("hop", 0), wire=wire,
            fparam=encode_fparam(plan["fparam"]) if plan.get("fuse") else 0,
        )
        session.ring[session.head % session.ring.shape[0]] = words
        session.head += 1
        session.seqn += 1
        return words

    def _window_shape(self, comm, window) -> WindowShape:
        in_ws, out_ws, wires = [], [], []
        dtype = None
        for _, _, plan in window:
            in_w, out_w = ring_widths(plan["op"], plan["n"], comm.size,
                                      fuse=plan.get("fuse", 0))
            in_ws.append(in_w)
            out_ws.append(out_w)
            wires.append(plan["wire"])
            dtype = plan["dtype"]
        return WindowShape(len(window), in_ws, out_ws, wires, dtype)

    # -- dispatch ------------------------------------------------------------
    def _dispatch_window(self, comm, window, reqs_per_slot, t0) -> None:
        """Encode the window, launch the sequencer once, and complete every
        slot's requests with the window's one CUDA event."""
        from .engine import _record_event, _wait_operands

        gang = self.gang
        n = len(window)
        shape = self._window_shape(comm, window)
        with self._lock:
            session = self._sessions.get(comm.id)
            if session is None:
                session = self._sessions[comm.id] = _RingSession(self.depth)
            start = session.head
            slot_rows = [self._encode(session, lead, plan)
                         for _, lead, plan in window]
            if (start % self.depth) + n > self.depth:
                self.wraps += 1
            self.refills += 1
            self.slots_enqueued += n
            self.last_window = n
            self.max_window = max(self.max_window, n)
            for _, _, plan in window:
                name = self._slot_opcode(plan).name
                self.op_slots[name] = self.op_slots.get(name, 0) + 1
        slots_np = np.stack(slot_rows)
        xs, outs, bufs = [], [], []
        for k, (calls, lead, plan) in enumerate(window):
            in_w, out_w = shape.in_ws[k], shape.out_ws[k]
            row_x, row_o = [], []
            for r, call in enumerate(calls):
                if plan["op"] == Operation.BARRIER:
                    row_x.append(None)
                    row_o.append(None)
                    continue
                buf = call.op0
                dummy = buf is None or buf.is_dummy
                row_x.append(None if dummy else buf.tensor[:in_w])
                res = call.res
                take = (r in plan["writers"] and res is not None
                        and not res.is_dummy)
                row_o.append(res.tensor[:out_w] if take else None)
                bufs += [b for b in (buf, res) if b is not None
                         and not b.is_dummy]
            xs.append(row_x)
            outs.append(row_o)
        device = gang.device
        _wait_operands(device, bufs)
        status = run_window(slots_np, xs, outs, shape, device=device)
        if device.type == "cuda":
            host = torch.empty(status.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(status, non_blocking=True)
        else:
            host = status
        event = _record_event(device)
        for k, (calls, _, plan) in enumerate(window):
            for r in plan["writers"]:
                res = calls[r].res
                if res is not None and not res.is_dummy:
                    res.ready = event
        with self._lock:
            self.dispatches += launches_for(comm.size, n)
            session.last_status = host
            session.status_event = event
        # the retcodes the device writes, known on the host from the same
        # words: the requests complete now, at launch, with the event
        codes = status_words(slots_np)[:, 1]
        dt = time.perf_counter_ns() - t0
        for k, slot_reqs in enumerate(reqs_per_slot):
            code = (ErrorCode.OK if int(codes[k]) == CMDRING_ST_OK
                    else ErrorCode.INVALID_OPERATION)
            for req in slot_reqs:
                req.ring_resident = True
                req.complete(code, dt, event=event)

