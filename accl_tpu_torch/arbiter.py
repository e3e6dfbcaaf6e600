"""The QoS arbiter plane: weighted-fair scheduling of concurrent tenants.

The port's copy of ``accl_tpu/arbiter.py``.  Many communicators share one
gang: a latency-bound serving communicator and a bulk best-effort one
meet at the same gang rendezvous, the same in-flight window and the same
command-ring windows, and every one of those queues is first come, first
served.  This module gives each communicator a **tenant** with a priority
class, a **deficit-weighted round-robin** admission queue in front of
engine dispatch, and quota levers where the contention lives: a
per-tenant share of the in-flight window's depth and a per-tenant slot
budget in the command ring's windows, plus optional token-bucket bytes/s
caps.

Three coupled pieces:

* **Tenant registry** (:class:`Tenant` + :meth:`QosArbiter.register`) —
  one tenant per communicator id, carrying a :class:`TenantClass`
  (GUARANTEED / BURST / BEST_EFFORT), a DRR weight (class default,
  overridable), a per-OWNER (= per rank handle) outstanding-admission
  bound at the tenant's in-flight window share — bounding ranks
  independently keeps one rank's intake thread from hoarding the
  tenant allowance and starving its peers' halves of the same
  collectives — and the optional token bucket.

* **DRR admission** (:meth:`QosArbiter.admit`) — every gated collective
  enqueues a ticket; tickets are granted in deficit-weighted round-robin
  order across tenants: each round refills every tenant's deficit by
  ``weight x quantum`` bytes and grants affordable queue heads
  round-robin, and a tenant at its outstanding limit simply waits for a
  completion (:meth:`QosArbiter.release`) to free a slot — the
  backpressure a flooder absorbs while a guaranteed tenant's small calls
  keep flowing.  Rounds advance the moment no queued tenant can afford
  its head (classic DRR: no time dimension, work-conserving when a
  tenant is alone).  Every wait is bounded (``ACCL_ARBITER_MAX_WAIT_S``):
  a starved ticket over-admits with a counted reason rather than wedging
  the submitting thread — the overlap plane's ``park`` discipline.

* **Decision latch** (the ``admit`` ledger) — scheduling must be
  SPMD-uniform: every rank of a communicator must admit the same call
  with the same throttle, or the ranks' call timings diverge and the
  contract verifier starts arguing.  The per-(comm, call index) decision
  record — tenant class and token-bucket throttle — is therefore
  computed ONCE by the first rank to reach a call index and latched on
  the shared arbiter (the membership plane's ``DemotionLedger``
  discipline: one shared state machine per process anchor, every
  in-process rank reads the same decision; one-process-per-rank tiers
  replay identical per-comm call streams through identical per-process
  state, which derives the same records).  The DRR grant itself never alters call
  CONTENT or intra-comm order — admission can only delay a whole call
  uniformly — so the latch covers everything that must agree.

Opt-in: registration and quota writes are always accepted (sensing),
but the acting half — DRR queueing, throttles — arms via
``ACCL_ARBITER=1`` or ``ACCL.set_arbiter(True)``.  Disabled, the intake
gate is one attribute check.  Standard library only: no torch, no JAX
and nothing of the JAX package.  On the port the anchor is the gang
context (``CudaEngine.contract_anchor``), so every rank handle of a group
shares one arbiter; ``ledger_exchange`` needs a KV plane, which only a
multi-process tier has (ROADMAP A6), so the ledger is exercised with a
dict KV.
"""

from __future__ import annotations

import enum
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .constants import (
    CMDRING_MAX_DEPTH,
    ConfigFunction,
    DEFAULT_INFLIGHT_WINDOW,
    MAX_INFLIGHT_WINDOW,
)
from .contract import anchored

__all__ = [
    "ARBITER_ENV",
    "CLASS_WEIGHTS",
    "LEDGER_ENV",
    "QosArbiter",
    "Tenant",
    "TenantClass",
    "TenantLedger",
    "TokenBucket",
    "arbiter_for",
    "env_arbiter",
    "env_ledger",
    "hist_p99_us",
    "tenant_config_field",
    "tenant_config_valid",
]

ARBITER_ENV = "ACCL_ARBITER"
MAX_WAIT_ENV = "ACCL_ARBITER_MAX_WAIT_S"
QUANTUM_ENV = "ACCL_ARBITER_QUANTUM"
#: opt-in for the CROSS-PROCESS tenant registry (dist tier): per-process
#: arbiters publish their tenant weight tables through the KV plane and
#: derive fabric-share token-bucket caps from the fleet-wide totals
LEDGER_ENV = "ACCL_ARBITER_LEDGER"
#: modeled fabric capacity the ledger divides into per-tenant shares
#: (bytes/s); the honest default is deliberately generous — the ledger
#: exists for *relative* fairness, and an operator who knows the link
#: sets the real number
LEDGER_FABRIC_ENV = "ACCL_ARBITER_FABRIC_BYTES_S"
DEFAULT_LEDGER_FABRIC_BYTES_S = 1e9

#: DRR credit granted per weight unit per round, in bytes.  Small
#: enough that a BEST_EFFORT flooder's large payloads span several
#: rounds (real interleaving), large enough that a GUARANTEED tenant's
#: small serving messages never wait a round for credit.
DEFAULT_QUANTUM = 64 * 1024
#: bounded admission wait before a ticket over-admits (counted): the
#: park_timeout_s discipline — the arbiter must never wedge intake.
DEFAULT_MAX_WAIT_S = 30.0
#: latched per-(comm, seq) admission decisions retained (the
#: DemotionLedger cap discipline)
_DECISION_CAP = 512
#: deficit accrual cap, in rounds-worth of quantum: an idle-ish tenant
#: must not bank unbounded credit and then monopolize a burst
_DEFICIT_CAP_ROUNDS = 2


class TenantClass(enum.IntEnum):
    """Priority class of one tenant communicator (the reference
    client_arbiter has no classes — every client is equal; production
    multi-tenancy needs the serving/training/scavenger split)."""

    GUARANTEED = 0   # latency-bound serving traffic: highest weight
    BURST = 1        # interactive/batch traffic with headroom to spare
    BEST_EFFORT = 2  # bulk scavenger traffic: absorbs all backpressure


#: default DRR weight per class (overridable per tenant)
CLASS_WEIGHTS = {
    TenantClass.GUARANTEED: 8,
    TenantClass.BURST: 4,
    TenantClass.BEST_EFFORT: 1,
}

MAX_TENANT_WEIGHT = 64


def env_arbiter(environ=None) -> bool:
    """The ``ACCL_ARBITER`` opt-in (read at ACCL-handle construction):
    arms the acting half — DRR admission queueing and throttles."""
    return (environ or os.environ).get(ARBITER_ENV, "0") not in ("0", "")


def env_ledger(environ=None) -> bool:
    """The ``ACCL_ARBITER_LEDGER`` opt-in (read at ACCL-handle
    construction on KV-capable tiers): arms the cross-process tenant
    registry exchange."""
    return (environ or os.environ).get(LEDGER_ENV, "0") not in ("0", "")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def arbiter_for(anchor) -> Optional["QosArbiter"]:
    """The :class:`QosArbiter` shared by every rank handle anchored on
    ``anchor`` (the engine's ``contract_anchor()`` — the same anchor
    discipline as the contract board and the demotion ledger); None on
    one-process-per-rank tiers, where each rank process runs its own
    arbiter over an identical per-comm call stream."""
    return anchored(anchor, "_accl_qos_arbiter", QosArbiter)


def tenant_config_field(fn) -> str:
    """``"class"`` / ``"weight"`` / ``"window_share"`` /
    ``"ring_slots"`` / ``"rate"`` from a ``SET_TENANT_*``
    :class:`~accl_tpu_torch.constants.ConfigFunction` — the engine-mirror
    field name, derived in ONE place."""
    return ConfigFunction(fn).name[len("SET_TENANT_"):].lower()


def tenant_config_valid(fn, value) -> bool:
    """THE validator every engine tier applies to a ``SET_TENANT_*``
    write — one shared range table, so a tenant config accepted on one
    tier can never be CONFIG_ERROR on another (the portability the
    config surface promises).  Ranges derive from the authoritative
    constants, not hardcoded maxima."""
    fn = ConfigFunction(fn)
    if fn == ConfigFunction.SET_TENANT_CLASS:
        return 0 <= value <= max(TenantClass)
    if fn == ConfigFunction.SET_TENANT_WEIGHT:
        return 1 <= value <= MAX_TENANT_WEIGHT
    if fn == ConfigFunction.SET_TENANT_WINDOW_SHARE:
        return 1 <= value <= MAX_INFLIGHT_WINDOW
    if fn == ConfigFunction.SET_TENANT_RING_SLOTS:
        return 1 <= value <= CMDRING_MAX_DEPTH
    if fn == ConfigFunction.SET_TENANT_RATE:
        return value >= 0
    return False


def coerce_class(value) -> TenantClass:
    """A :class:`TenantClass` from an enum / int / name string."""
    if isinstance(value, TenantClass):
        return value
    if isinstance(value, str):
        try:
            return TenantClass[value.upper()]
        except KeyError:
            raise ValueError(
                f"unknown tenant class {value!r}; valid: "
                f"{[c.name.lower() for c in TenantClass]}"
            ) from None
    return TenantClass(int(value))


def hist_p99_us(hist: dict) -> Optional[float]:
    """p99 upper bound in us from a log2-us bucket histogram
    (``{"count": n, "log2_us": {bucket: n}}`` — the telemetry plane's
    shape): the upper edge of the first bucket whose cumulative count
    reaches the 99th percentile.  None on an empty histogram.  The
    monitor plane's ``/tenants`` route and the bench's adversarial-load
    gate both read tail latency through this ONE estimator."""
    count = int(hist.get("count") or 0)
    if count <= 0:
        return None
    need = count - count // 100  # ceil(0.99 * count) for count < 100
    cum = 0
    for b, n in sorted(
        ((int(k), int(v)) for k, v in (hist.get("log2_us") or {}).items())
    ):
        cum += n
        if cum >= need:
            return float(2 ** (b + 1))
    return None


def _log2_bucket(us: int) -> int:
    return max(0, int(us).bit_length() - 1)


class TokenBucket:
    """Bytes/s cap with burst headroom, monotonic-clock timed.

    ``throttle_ns(cost)`` consumes ``cost`` tokens and returns how long
    the caller must wait for the bucket to have covered them — tokens go
    negative (the debt model), so the delay is exact for back-to-back
    callers without a reservation queue.  The clock is injectable for
    deterministic tests.
    """

    def __init__(self, rate_bytes_s: float, burst_bytes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate_bytes_s)
        self.burst = float(
            burst_bytes if burst_bytes is not None else max(self.rate, 1.0)
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()

    def throttle_ns(self, cost: int) -> int:
        """Consume ``cost`` bytes; ns the caller owes the cap (0 when
        the burst allowance covers it)."""
        if self.rate <= 0:
            return 0
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            self._tokens -= float(cost)
            if self._tokens >= 0:
                return 0
            return int(-self._tokens / self.rate * 1e9)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rate_bytes_s": self.rate,
                "burst_bytes": self.burst,
                "tokens": round(self._tokens, 1),
            }


class _Ticket:
    __slots__ = ("cost", "granted")

    def __init__(self, cost: int):
        self.cost = cost
        self.granted = False


class Tenant:
    """One registered tenant communicator's arbiter-side state.

    Admission bookkeeping is per OWNER (one owner = one rank handle):
    the in-flight bound is the tenant's *per-rank* window share, and a
    collective occupies one admission on every rank — bounding ranks
    independently is what keeps one rank's intake thread from grabbing
    the whole tenant allowance and starving its peers' halves of the
    same collectives (which can only complete when every rank admits).
    DRR credit stays tenant-wide: the tenant is the unit of fairness.

    All mutation happens under the owning arbiter's lock; ``snapshot``
    is served through the arbiter too.
    """

    __slots__ = (
        "comm_id", "name", "cls", "weight", "world", "window_share",
        "ring_slots", "bucket", "deficit", "queues", "owner_rr",
        "outstanding", "_inflight", "outstanding_peak", "admitted",
        "completed", "cost_granted", "grant_wait_ns",
        "throttle_ns_total", "over_admissions", "queued_peak", "hist",
        "template", "auto_rate",
    )

    def __init__(self, comm_id: int, name: str, cls: TenantClass,
                 weight: int, world: int):
        self.comm_id = int(comm_id)
        self.name = name
        self.cls = cls
        self.weight = int(weight)
        self.world = max(1, int(world))
        self.window_share = DEFAULT_INFLIGHT_WINDOW
        self.ring_slots: Optional[int] = None
        self.bucket: Optional[TokenBucket] = None
        # True when the bucket was derived by the cross-process ledger
        # (a fabric share, re-derived on every exchange); an explicit
        # set_quota rate clears it and is never overwritten by shares
        self.auto_rate = False
        self.deficit = 0
        # per-owner (rank handle) waiting tickets + in-flight counts;
        # _inflight mirrors sum(outstanding.values()) so the hot path
        # never sums the dict
        self.queues: Dict[int, deque] = {}
        self.owner_rr: List[int] = []  # owner scan order (first-seen)
        self.outstanding: Dict[int, int] = {}
        self._inflight = 0
        self.outstanding_peak = 0
        self.admitted = 0
        self.completed = 0
        self.cost_granted = 0
        self.grant_wait_ns = 0
        self.throttle_ns_total = 0
        self.over_admissions = 0
        self.queued_peak = 0
        # per-tenant completion-latency histogram, telemetry-shaped:
        # [count, sum_ns, {log2_us: n}] — the monitor plane serves it
        # live and hist_p99_us reads the tail off it
        self.hist: list = [0, 0, {}]
        # pre-built decision-record template (enum .name lookups and
        # key construction off the admission hot path)
        self.template: dict = {}
        self.retemplate()

    def retemplate(self) -> None:
        self.template = {
            "seq": 0,
            "tenant": self.name,
            "class": self.cls.name,
            "throttle_ns": 0,
            "latched": False,
        }

    def queue_for(self, owner: int) -> deque:
        q = self.queues.get(owner)
        if q is None:
            q = self.queues[owner] = deque()
            self.owner_rr.append(owner)
        return q

    def queued(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def in_flight(self) -> int:
        return self._inflight

    def grantable_owner(self) -> Optional[int]:
        """The first owner (scan order) with a waiting head under its
        per-rank limit; None when every queued owner is pinned."""
        for owner in self.owner_rr:
            q = self.queues.get(owner)
            if q and self.outstanding.get(owner, 0) < self.window_share:
                return owner
        return None

    def snapshot(self) -> dict:
        count, sum_ns, buckets = self.hist
        hist = {
            "count": count,
            "sum_ns": sum_ns,
            "mean_us": round(sum_ns / count / 1e3, 3) if count else 0,
            "log2_us": {str(k): v for k, v in sorted(buckets.items())},
        }
        return {
            "comm": self.comm_id,
            "name": self.name,
            "class": self.cls.name,
            "weight": self.weight,
            "world": self.world,
            "window_share": self.window_share,
            "ring_slots": self.ring_slots,
            "rate": self.bucket.snapshot() if self.bucket else None,
            "auto_rate": self.auto_rate,
            "outstanding": self.in_flight(),
            "outstanding_peak": self.outstanding_peak,
            "outstanding_limit": self.window_share,
            "queued": self.queued(),
            "queued_peak": self.queued_peak,
            "admitted": self.admitted,
            "completed": self.completed,
            "cost_granted_bytes": self.cost_granted,
            "grant_wait_ns_total": self.grant_wait_ns,
            "throttle_ns_total": self.throttle_ns_total,
            "over_admissions": self.over_admissions,
            "latency": dict(hist, p99_us=hist_p99_us(hist)),
        }


class TenantLedger:
    """Cross-process tenant-weight registry state for one arbiter.

    Each process posts its local ``{tenant name: weight}`` map into the
    dist tier's KV plane (the same plane the contract-digest ledger
    rides) and sweeps every peer's posting back.  The arbiter then
    re-derives per-tenant token-bucket rates as *fabric shares*:

        rate = fabric_bytes_s * weight / (local_total + foreign_total)

    so a GUARANTEED tenant in one process squeezes a BEST_EFFORT tenant
    in another even though the two arbiters share no lock — only the KV
    plane.  Derived rates are marked ``auto_rate`` and are re-derived on
    every exchange; explicit ``set_quota`` rates are never overwritten.
    """

    __slots__ = ("process_key", "fabric_bytes_s", "state", "foreign",
                 "exchanges", "posted", "errors")

    def __init__(self, process_key: str,
                 fabric_bytes_s: Optional[float] = None):
        self.process_key = str(process_key)
        self.fabric_bytes_s = float(
            fabric_bytes_s if fabric_bytes_s is not None
            else _env_float(LEDGER_FABRIC_ENV, DEFAULT_LEDGER_FABRIC_BYTES_S)
        )
        # exchange-protocol scratch (slot claim + last posted doc) owned
        # by contract.kv_tenant_exchange
        self.state: dict = {}
        # last swept view: {process_key: {"weights": {...}, "total": n}}
        self.foreign: dict = {}
        self.exchanges = 0
        self.posted = 0
        self.errors = 0

    def foreign_weight(self) -> int:
        """Sum of every foreign process's tenant weights (the
        denominator share the local tenants compete against)."""
        return sum(int(doc.get("total", 0))
                   for doc in self.foreign.values())

    def snapshot(self) -> dict:
        return {
            "process": self.process_key,
            "fabric_bytes_s": self.fabric_bytes_s,
            "peers": len(self.foreign),
            "foreign_weight": self.foreign_weight(),
            "exchanges": self.exchanges,
            "posted": self.posted,
            "errors": self.errors,
        }


class QosArbiter:
    """Deficit-weighted round-robin admission in front of engine
    dispatch, shared by every rank handle on one process anchor.

    One lock + condition covers the whole machine (registry, queues,
    deficits, the decision latch) — admission is a handful of integer
    ops per call, and the single lock keeps the grant order globally
    consistent (the fairness the tests counter-assert).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.armed = False
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._tenants: Dict[int, Tenant] = {}
        self._order: List[int] = []  # registration order (RR scan)
        self._rr = 0
        self.quantum = max(
            1024, int(_env_float(QUANTUM_ENV, DEFAULT_QUANTUM))
        )
        self.max_wait_s = max(
            0.1, _env_float(MAX_WAIT_ENV, DEFAULT_MAX_WAIT_S)
        )
        # per-(comm, seq) latched decisions (DemotionLedger discipline;
        # engaged only for token-bucket tenants — see _admitted)
        self._decisions: Dict[tuple, dict] = {}
        self._decision_order: deque = deque()
        # queued tickets across every tenant: the hot path's contention
        # probe — zero means admit/release may skip the DRR pump
        self._waiting = 0
        self.rounds = 0
        self.grant_timeouts = 0
        self.passthrough = 0
        # cross-process tenant registry (attached when ACCL_ARBITER_LEDGER
        # is set and the engine exposes a KV plane); None = local-only
        self.ledger: Optional[TenantLedger] = None

    # -- registry ------------------------------------------------------------
    def register(self, comm_id: int, name: Optional[str] = None,
                 cls=TenantClass.BEST_EFFORT, weight: Optional[int] = None,
                 world: int = 1) -> Tenant:
        """Register (or re-class) the tenant behind ``comm_id``.
        Collective by contract: every rank of the communicator registers
        it with the same class/weight at the same call-sequence point —
        the same discipline every other config write carries."""
        cls = coerce_class(cls)
        w = int(weight) if weight is not None else CLASS_WEIGHTS[cls]
        w = max(1, min(w, MAX_TENANT_WEIGHT))
        with self._cv:
            t = self._tenants.get(int(comm_id))
            if t is None:
                t = Tenant(comm_id, name or f"comm-{comm_id}", cls, w,
                           world)
                self._tenants[t.comm_id] = t
                self._order.append(t.comm_id)
            else:
                t.cls = cls
                t.weight = w
                if name:
                    t.name = name
                if world > 1:
                    t.world = int(world)
                t.retemplate()
            self._cv.notify_all()
            return t

    def set_quota(self, comm_id: int, window_share: Optional[int] = None,
                  ring_slots: Optional[int] = None,
                  bytes_per_s: Optional[float] = None) -> Optional[Tenant]:
        """Quota writes for a registered tenant; None for unknown ids
        (quotas without a registered tenant have nothing to govern)."""
        with self._cv:
            t = self._tenants.get(int(comm_id))
            if t is None:
                return None
            if window_share is not None:
                t.window_share = max(
                    1, min(int(window_share), MAX_INFLIGHT_WINDOW)
                )
            if ring_slots is not None:
                t.ring_slots = max(1, int(ring_slots))
            if bytes_per_s is not None:
                t.bucket = (
                    TokenBucket(float(bytes_per_s), clock=self._clock)
                    if bytes_per_s > 0 else None
                )
                # an explicit operator rate is authoritative: the
                # cross-process ledger must never overwrite it with a
                # derived fabric share
                t.auto_rate = False
            self._cv.notify_all()
            return t

    def tenant(self, comm_id: int) -> Optional[Tenant]:
        with self._lock:
            return self._tenants.get(int(comm_id))

    # -- admission (the DRR queue) -------------------------------------------
    def admit(self, comm_id: int, seq: int, cost: int,
              timeout_s: Optional[float] = None,
              pace: bool = True, owner: int = 0) -> Optional[dict]:
        """Admit call index ``seq`` of communicator ``comm_id`` costing
        ``cost`` bytes.  Blocks (bounded) while the tenant is out of DRR
        credit or at its outstanding limit; returns the latched decision
        record — identical on every rank of the comm by construction —
        or None when the arbiter is disarmed / the comm unregistered
        (pass-through, counted).

        ``pace=False`` charges without queueing (DRR credit, token
        bucket, counters — no outstanding slot, no grant wait): the
        facade uses it for calls queued into an open batch, whose
        dispatch unit is the flushed window — a queued call cannot
        complete before its batch flushes, so holding an admission slot
        for it would wedge any batch deeper than the tenant's limit.
        Batched traffic is quota'd where its contention lives instead:
        the command ring's per-tenant slot budget."""
        with self._cv:
            t = self._tenants.get(int(comm_id))
            if not self.armed or t is None:
                self.passthrough += 1
                return None
            cost = max(1, int(cost))
            o = int(owner)
            if not pace:
                t.deficit = max(0, t.deficit - cost)  # charged, unqueued
                decision, waited = self._admitted(t, comm_id, seq, cost, 0)
            elif (
                self._waiting == 0
                and t.outstanding.get(o, 0) < t.window_share
            ):
                # uncontended fast path: nothing queued anywhere and
                # this owner has window headroom — grant inline, no
                # ticket, no DRR pump, no wait timers (the whole
                # machine only engages under contention; the warm-path
                # budget depends on it)
                t.outstanding[o] = t.outstanding.get(o, 0) + 1
                t._inflight += 1
                t.outstanding_peak = max(
                    t.outstanding_peak, t._inflight
                )
                decision, waited = self._admitted(t, comm_id, seq, cost, 0)
            else:
                t0 = time.perf_counter_ns()
                ticket = _Ticket(cost)
                t.queue_for(o).append(ticket)
                self._waiting += 1
                t.queued_peak = max(t.queued_peak, t.queued())
                self._pump()
                if not ticket.granted:
                    bound = min(
                        self.max_wait_s,
                        timeout_s if timeout_s is not None
                        else self.max_wait_s,
                    )
                    deadline = self._clock() + max(0.05, bound)
                    while not ticket.granted:
                        rem = deadline - self._clock()
                        if rem <= 0:
                            break
                        self._cv.wait(min(rem, 0.5))
                    if not ticket.granted:
                        # bounded wait expired: over-admit (counted) —
                        # the arbiter must never wedge intake; the
                        # facade's deadlock deadlines stay the last word
                        try:
                            t.queue_for(o).remove(ticket)
                        except ValueError:  # granted in the race window
                            pass
                        else:
                            self._waiting -= 1
                            t.outstanding[o] = (
                                t.outstanding.get(o, 0) + 1
                            )
                            t._inflight += 1
                            t.outstanding_peak = max(
                                t.outstanding_peak, t._inflight
                            )
                            t.over_admissions += 1
                            self.grant_timeouts += 1
                            ticket.granted = True
                decision, waited = self._admitted(t, comm_id, seq, cost, t0)
        throttle_ns = decision["throttle_ns"]
        if throttle_ns > 0:
            # bytes/s cap: the latched debt, paid outside the lock so a
            # throttled tenant never blocks its peers' admissions;
            # bounded by the same admission ceiling
            time.sleep(min(throttle_ns / 1e9, self.max_wait_s))
        # `paced` is the CALLER's accounting truth (did this admission
        # take an outstanding slot, i.e. must its completion release
        # one) — per handle, deliberately not the latched value.  A
        # ledger-shared record is copied; the unlatched fast-path dict
        # is fresh and stamped in place.
        if decision.get("latched", True):
            return dict(decision, wait_ns=int(waited), paced=bool(pace))
        decision["wait_ns"] = int(waited)
        decision["paced"] = bool(pace)
        return decision

    def _admitted(self, t: Tenant, comm_id: int, seq: int, cost: int,
                  t0: int) -> tuple:
        """Account one admission + fetch-or-latch its decision record
        (arbiter lock held).  The token bucket is consumed ONCE per
        logical call — the first rank to a call index computes the
        throttle, every later rank replays it.  Unthrottled tenants
        carry nothing stateful in the record (class and name are
        registration constants, identical on every rank), so the
        ledger only engages when a bucket makes the decision
        path-dependent — the warm path skips the dict churn.  ``t0``
        of 0 means the grant was inline (no wait, no timer taken).
        ``seq < 0`` means NO LATCH: plain p2p is rank-asymmetric by
        design (the contract plane exempts it for the same reason), so
        its admissions never consume the shared per-(comm, call index)
        space — a p2p decision charges this handle's side of the
        bucket directly, and collective call indices stay aligned
        across ranks however asymmetric the p2p pattern is."""
        waited = time.perf_counter_ns() - t0 if t0 else 0
        t.admitted += 1
        t.cost_granted += cost
        t.grant_wait_ns += waited
        if t.bucket is None:
            # fresh (unshared) dict off the template: admit() may stamp
            # wait_ns/paced into it directly instead of paying a copy
            decision = dict(t.template)
            decision["seq"] = int(seq)
            return decision, waited
        if seq < 0:  # p2p: local charge, no shared-ledger entry
            decision = dict(t.template)
            decision["seq"] = -1
            decision["throttle_ns"] = int(t.bucket.throttle_ns(cost))
            t.throttle_ns_total += decision["throttle_ns"]
            return decision, waited
        key = (int(comm_id), int(seq))
        decision = self._decisions.get(key)
        if decision is None:
            decision = {
                "seq": int(seq),
                "tenant": t.name,
                "class": t.cls.name,
                "throttle_ns": int(t.bucket.throttle_ns(cost)),
            }
            self._decisions[key] = decision
            self._decision_order.append(key)
            while len(self._decision_order) > _DECISION_CAP:
                self._decisions.pop(
                    self._decision_order.popleft(), None
                )
        t.throttle_ns_total += decision["throttle_ns"]
        return decision, waited

    def release(self, comm_id: int, owner: int = 0) -> None:
        """One admitted call completed on ``owner``'s handle: free its
        outstanding slot and grant whatever the freed capacity now
        affords."""
        with self._cv:
            t = self._tenants.get(int(comm_id))
            if t is None:
                return
            t.completed += 1
            o = int(owner)
            if t.outstanding.get(o, 0) > 0:
                t.outstanding[o] -= 1
                t._inflight -= 1
            if self._waiting:
                self._pump()

    def complete(self, comm_id: int, duration_ns: int,
                 owner: int = 0, release: bool = True) -> None:
        """The completion fast lane (the facade's Request
        done-callback): release + latency observation under ONE lock
        acquisition — the separate calls each pay a lock and measured
        ~2x this on the warm path."""
        with self._cv:
            t = self._tenants.get(int(comm_id))
            if t is None:
                return
            # completion counts unconditionally — a batched
            # (charge-only) call really did complete; only the SLOT
            # release is conditional on having taken one
            t.completed += 1
            if release:
                o = int(owner)
                if t.outstanding.get(o, 0) > 0:
                    t.outstanding[o] -= 1
                    t._inflight -= 1
                if self._waiting:
                    self._pump()
            h = t.hist
            h[0] += 1
            h[1] += int(duration_ns)
            b = _log2_bucket(int(duration_ns) // 1000)
            h[2][b] = h[2].get(b, 0) + 1

    def _pump(self) -> None:
        """Grant waiting tickets in deficit-weighted round-robin order
        (lock held).  Within a tenant, owners (rank handles) are
        scanned in first-seen order, each bounded at the tenant's
        per-rank window share — one rank's backlog never pins a slot a
        peer rank needs to complete the same collective.  Terminates:
        every grant consumes a ticket, and a round only advances while
        some queued owner is under its limit — pinned owners wait for
        :meth:`release`, which pumps again."""
        while True:
            n = len(self._order)
            granted = False
            for i in range(n):
                cid = self._order[(self._rr + i) % n]
                t = self._tenants[cid]
                owner = t.grantable_owner()
                if owner is None:
                    continue
                head = t.queues[owner][0]
                if t.deficit < head.cost:
                    continue
                t.deficit -= head.cost
                t.queues[owner].popleft()
                self._waiting -= 1
                if not t.queued():
                    # classic DRR: an emptied queue banks nothing
                    t.deficit = 0
                head.granted = True
                t.outstanding[owner] = t.outstanding.get(owner, 0) + 1
                t._inflight += 1
                t.outstanding_peak = max(
                    t.outstanding_peak, t._inflight
                )
                self._rr = (self._rr + i + 1) % n
                granted = True
                break
            if granted:
                self._cv.notify_all()
                continue
            # nothing affordable: advance rounds for the tenants still
            # eligible (a queued owner under its limit) — by exactly
            # enough rounds that the cheapest head becomes affordable,
            # so a lone big payload costs O(1) bookkeeping, not
            # O(cost/quantum)
            eligible = []
            for t in self._tenants.values():
                owner = t.grantable_owner()
                if owner is not None:
                    eligible.append((t, t.queues[owner][0].cost))
            if not eligible:
                return
            need = min(
                max(
                    1,
                    -(-(cost - t.deficit) // (t.weight * self.quantum)),
                )
                for t, cost in eligible
            )
            self.rounds += need
            for t, cost in eligible:
                t.deficit = min(
                    t.deficit + need * t.weight * self.quantum,
                    _DEFICIT_CAP_ROUNDS * t.weight * self.quantum + cost,
                )

    # -- cross-process tenant registry ---------------------------------------
    def attach_ledger(self, ledger: TenantLedger) -> TenantLedger:
        """Arm the cross-process registry: subsequent
        ``ledger_exchange`` calls post local weights and re-derive
        fabric-share rates against the swept foreign total."""
        with self._cv:
            self.ledger = ledger
            return ledger

    def local_weights(self) -> Dict[str, int]:
        """``{tenant name: weight}`` for every registered tenant — the
        doc this process posts to the KV plane."""
        with self._lock:
            return {
                self._tenants[cid].name: int(self._tenants[cid].weight)
                for cid in self._order
            }

    def ledger_exchange(self, kv, is_notfound=None) -> Optional[dict]:
        """Post local tenant weights through ``kv`` and re-derive
        fabric-share token-bucket rates from the swept peer view.
        Returns the exchange counters, or None when no ledger is
        attached (local-only arbiter)."""
        led = self.ledger
        if led is None:
            return None
        from . import contract as _contract
        weights = self.local_weights()
        foreign, out = _contract.kv_tenant_exchange(
            kv, led.process_key, weights, led.state,
            is_notfound=is_notfound,
        )
        led.foreign = foreign
        led.exchanges += 1
        led.posted += int(out.get("posted", 0))
        led.errors += int(out.get("errors", 0))
        self._apply_ledger_shares()
        return out

    def _apply_ledger_shares(self) -> None:
        """Re-derive auto token-bucket rates as fabric shares.  Only
        buckets the ledger itself installed (``auto_rate``) or tenants
        with no bucket at all are touched — explicit ``set_quota``
        rates stay authoritative.  With no foreign peers the auto caps
        are lifted entirely (nothing to share the fabric with)."""
        led = self.ledger
        if led is None:
            return
        with self._cv:
            foreign_total = led.foreign_weight()
            local_total = sum(
                int(t.weight) for t in self._tenants.values()
            )
            for t in self._tenants.values():
                if t.bucket is not None and not t.auto_rate:
                    continue  # explicit operator rate
                if foreign_total <= 0:
                    # sole process on the fabric: an auto cap would
                    # only throttle against nobody
                    t.bucket = None
                    t.auto_rate = False
                    continue
                total = local_total + foreign_total
                if total <= 0:
                    continue
                rate = led.fabric_bytes_s * (int(t.weight) / total)
                if rate > 0:
                    t.bucket = TokenBucket(rate, clock=self._clock)
                    t.auto_rate = True
            self._cv.notify_all()

    # -- recovery / telemetry ------------------------------------------------
    def reset_ledger(self) -> None:
        """soft_reset recovery: drop latched decisions and DRR credit —
        the facade's per-comm call-index counters restart at 0, and a
        stale latched decision for those indices would replay pre-reset
        throttles.  Registrations and counters survive (quotas are
        config state, like the tuning registers)."""
        with self._cv:
            self._decisions.clear()
            self._decision_order.clear()
            for t in self._tenants.values():
                t.deficit = 0
            self._cv.notify_all()

    def window_share_of(self, comm_id: int) -> Optional[int]:
        """The tenant's per-rank in-flight window share (None when
        unregistered) — the overlap plane reads its per-key depth
        override through this accessor."""
        with self._lock:
            t = self._tenants.get(int(comm_id))
            return t.window_share if t is not None else None

    def ring_slots_of(self, comm_id: int) -> Optional[int]:
        """The tenant's per-refill-window ring slot budget (None when
        unregistered or unbudgeted)."""
        with self._lock:
            t = self._tenants.get(int(comm_id))
            return t.ring_slots if t is not None else None

    def snapshot(self) -> dict:
        """The merged-telemetry view (``telemetry_snapshot()["tenants"]``
        and the monitor plane's ``/tenants`` route serve this live)."""
        with self._lock:
            return {
                "enabled": self.armed,
                "quantum": self.quantum,
                "rounds": self.rounds,
                "grant_timeouts": self.grant_timeouts,
                "passthrough": self.passthrough,
                "ledger": (
                    self.ledger.snapshot()
                    if self.ledger is not None else None
                ),
                "tenants": {
                    str(cid): self._tenants[cid].snapshot()
                    for cid in self._order
                },
            }
