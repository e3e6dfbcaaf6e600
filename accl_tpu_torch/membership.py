"""The membership plane: self-healing communicators.

The port's copy of ``accl_tpu/membership.py``: the same protocol,
records and environment variables.

The sensing machinery lives elsewhere — the per-peer health state
machine (the gang), the contract plane's cross-rank exchange paths, the
straggler judge (``monitor``).  All of it *reports*:
a ``dead`` verdict makes every later collective fail fast at intake —
correct, loud, and terminal.  This module is the acting half: a
long-lived fabric that **shrinks the communicator and keeps serving**
when a rank dies, and **routes around** ranks the straggler judge
convicts instead of only reporting them.

Three coupled pieces:

* **Shrink protocol** (:class:`MembershipView` + :class:`MembershipBoard`)
  — on a ``dead`` health verdict (or an explicit ``ACCL.evict_rank()``)
  the surviving ranks run a bounded three-phase agreement over the
  contract plane's exchange paths (shared board on InProc/gang anchors,
  ``MEMBER`` wire frames on the socket tier):

  1. **propose** — the observing rank votes an eviction set (world
     sessions);
  2. **confirm** — peers *second* the proposal (a rank with no
     conflicting evidence adds its vote; votes from ranks inside the
     eviction set never count); a strict majority of the would-be
     survivors confirms the plan;
  3. **cutover** — each survivor atomically applies the confirmed plan
     at its next call boundary: drain the in-flight window, shrink
     every affected communicator to the survivors (fresh epoch — plans
     and tuning overlays re-key instead of silently mis-bucketing),
     fold a ``__shrink__`` marker into the contract digest stream (the
     ``__begin__`` discipline: a rank that missed the cutover
     diverges within one window instead of hanging), and tear down /
     re-arm engine sessions over the survivors.

  Collectives in flight against the evicted rank complete with
  structured ``ErrorCode.RANK_EVICTED`` carrying the agreement
  evidence; collectives issued after cutover just run at the new world
  size.  ``soft_reset`` (collective, after the operator heals the
  fabric) restores full membership.

* **Join protocol** (elastic expansion — the shrink discipline run in
  the GROW direction): a candidate rank *petitions* over the same
  agreement paths (board event on InProc/gang anchors,
  ``join_petition`` MEMBER frames on the socket tier).  The candidate
  never votes on its own admission — elastic members *second* the
  petition at their current epoch and a strict majority of the current
  members confirms a ``kind="join"`` plan.  Every member applies the
  cutover at its next call boundary (``Communicator.grow()`` in place,
  fresh epoch, ``__join__`` contract marker); the candidate applies it
  inside ``ACCL.join_rank()``, aligning its membership epoch and
  cumulative eviction record to the group's (it missed every bump
  since its previous life, if it had one).  The confirming member's
  **warm-handoff** artifacts (contract generation + per-comm digest
  baseline, tuning plan, plan-cache verdicts) ride the confirmed plan
  so the candidate's first verification window is contract-conformant.

* **Straggler demotion** (:class:`DemotionLedger`) — a convicted
  ``slow_rank`` (two-window arrival-skew dominance, exchanged
  cross-rank) is *demoted*: kept in the communicator, excluded from
  root/relay roles where topology allows (today: the barrier's
  internal gather root, plus the advisory ``ACCL.suggest_root()``),
  behind a circuit breaker (strike → open/demoted → half-open probe →
  restore) timed on the monotonic clock.  Demotion decisions are
  SPMD-uniform by construction: they derive from the *exchanged*
  verdict (the shared judge on board-anchored tiers), never from local
  observation, and every per-call decision is latched per (comm, call
  index) on the shared ledger — the first rank to a call index decides,
  every other rank reads the same decision (the sequencer-mailbox
  discipline).  On wire tiers, whose straggler verdicts are pairwise
  (correct only on the conforming side), demotion never alters routing
  — verdicts stay operator signals there.

* **Circuit breaker** (:class:`CircuitBreaker`) — the shared
  strike/open/half-open/closed machine, also used by the command
  ring to degrade ring → inline → host dispatch per communicator when
  sequencer windows fail against a dying peer, re-probing after a
  cool-down (``backends/cuda/cmdring.py``).

Opt-in: the *acting* behaviors (shrink, demotion routing) arm via
``ACCL_ELASTIC=1`` or ``ACCL.set_elastic(True)``; the sensing surface
(health transition events, the membership snapshot) is always on.
Everything here is monotonic-clock timed and every wait is bounded.

Zero dependencies (stdlib only), like ``faults``, ``contract`` and
``monitor``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, FrozenSet, List, Optional, Set

from .contract import anchored

__all__ = [
    "CircuitBreaker",
    "DemotionLedger",
    "ELASTIC_ENV",
    "JOIN_CONFIRM_ENV",
    "MembershipBoard",
    "MembershipView",
    "board_for",
    "env_elastic",
    "env_join_s",
    "ledger_for",
]

ELASTIC_ENV = "ACCL_ELASTIC"
DEMOTE_COOLDOWN_ENV = "ACCL_DEMOTE_COOLDOWN_S"
EVICT_CONFIRM_ENV = "ACCL_EVICT_CONFIRM_S"
JOIN_CONFIRM_ENV = "ACCL_JOIN_CONFIRM_S"

DEFAULT_DEMOTE_COOLDOWN_S = 30.0
DEFAULT_EVICT_CONFIRM_S = 5.0
DEFAULT_JOIN_CONFIRM_S = 5.0

#: cutover records retained per view (the eviction history the
#: determinism test replays)
_HISTORY_CAP = 32
#: latched per-(comm, seq) demotion decisions retained on the ledger
_DECISION_CAP = 256


def env_elastic(environ=None) -> bool:
    """The ``ACCL_ELASTIC`` opt-in (read at ACCL-handle construction):
    arms the acting half — communicator shrink on dead verdicts and
    straggler demotion routing."""
    return (environ or os.environ).get(ELASTIC_ENV, "0") not in ("0", "")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def env_confirm_s() -> float:
    """How long a failed collective waits for eviction confirmation
    before surfacing its raw timeout (bounded — the shrink deadline)."""
    return max(0.1, _env_float(EVICT_CONFIRM_ENV, DEFAULT_EVICT_CONFIRM_S))


def env_join_s() -> float:
    """How long a candidate's ``join_rank`` waits for admission before
    returning None (bounded — the grow deadline; the petition stands
    and a retry re-petitions)."""
    return max(0.1, _env_float(JOIN_CONFIRM_ENV, DEFAULT_JOIN_CONFIRM_S))


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Strike / open / half-open / closed, monotonic-clock timed.

    * CLOSED — healthy; ``record_failure`` counts strikes and opens the
      breaker at ``threshold``.
    * OPEN — degraded; ``allow()`` answers ``"open"`` until
      ``cooldown_s`` elapses, then flips to HALF_OPEN.
    * HALF_OPEN — probing; ``allow()`` answers ``"probe"``.
      ``success()`` restores (CLOSED, strikes reset); ``record_failure``
      re-opens with a fresh cool-down.

    Thread-safe; the clock is injectable for deterministic tests.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int = 2, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.strikes = 0
        self.opened_at: Optional[float] = None
        self.opens_total = 0
        self.restores_total = 0
        self.reasons: Dict[str, int] = {}

    def allow(self) -> str:
        """``"closed"`` / ``"probe"`` / ``"open"`` — the routing verdict
        for the next unit of work (a window, a root role)."""
        with self._lock:
            if self.state == self.OPEN:
                if (
                    self.opened_at is not None
                    and self._clock() - self.opened_at >= self.cooldown_s
                ):
                    self.state = self.HALF_OPEN
            if self.state == self.CLOSED:
                return self.CLOSED
            return "probe" if self.state == self.HALF_OPEN else self.OPEN

    def record_failure(self, reason: str = "failure") -> bool:
        """One strike; True when this strike opened (or re-opened) the
        breaker."""
        with self._lock:
            self.reasons[reason] = self.reasons.get(reason, 0) + 1
            self.strikes += 1
            if self.state == self.HALF_OPEN or (
                self.state == self.CLOSED and self.strikes >= self.threshold
            ):
                self.state = self.OPEN
                self.opened_at = self._clock()
                self.opens_total += 1
                return True
            if self.state == self.OPEN:
                self.opened_at = self._clock()  # extend the cool-down
            return False

    def success(self) -> bool:
        """A probe (or closed-path unit) succeeded; True when this
        restored a half-open breaker to CLOSED."""
        with self._lock:
            restored = self.state == self.HALF_OPEN
            if restored:
                self.restores_total += 1
            if self.state != self.CLOSED:
                self.state = self.CLOSED
            self.strikes = 0
            self.opened_at = None
            return restored

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "strikes": self.strikes,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "opens_total": self.opens_total,
                "restores_total": self.restores_total,
                "reasons": dict(self.reasons),
            }


# ---------------------------------------------------------------------------
# the shared agreement board (InProc fabric / gang anchors)
# ---------------------------------------------------------------------------


def board_for(anchor) -> Optional["MembershipBoard"]:
    """The :class:`MembershipBoard` shared by every rank handle anchored
    on ``anchor`` (the engine's ``contract_anchor()`` — the same anchor
    discipline as the contract board); None on one-process-per-rank
    tiers, where ``MEMBER`` wire frames do the exchanging."""
    return anchored(anchor, "_accl_membership_board", MembershipBoard)


def ledger_for(anchor) -> Optional["DemotionLedger"]:
    """The shared :class:`DemotionLedger` for board-anchored tiers —
    demotion routing decisions must come from ONE shared state machine
    so every in-process rank reads the same verdict; None on wire
    tiers, where demotion never alters routing."""
    return anchored(anchor, "_accl_demotion_ledger", DemotionLedger)


class MembershipBoard:
    """Shared membership-agreement state for rank handles in one process.

    Votes are keyed ``(epoch, kind, member set)`` — ``kind`` is
    ``"evict"`` (the shrink direction) or ``"join"`` (the grow
    direction); a post that completes a strict majority confirms the
    plan.  Listeners observe proposals and join petitions (so elastic
    peers can second) and confirmations (so every handle cuts over).
    Votes from ranks inside the eviction/admission set never count
    toward the majority — the condemned don't vote, and neither does
    the candidate petitioning its own admission.
    """

    #: confirmed plans retained (one per applied cutover; a bound only
    #: guards pathological epoch churn)
    _PLAN_CAP = 64

    def __init__(self):
        self._lock = threading.Lock()
        # (epoch, kind, frozenset(members)) -> set(voting world ranks)
        self._votes: Dict[tuple, Set[int]] = {}
        self._plans: Dict[tuple, dict] = {}  # (epoch, kind) -> plan
        self._plan_order: List[tuple] = []
        self._listeners: List[Callable[[dict], None]] = []

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def standing(self, epoch: int, kind: str = "evict") -> Optional[dict]:
        with self._lock:
            plan = self._plans.get((epoch, kind))
            return dict(plan) if plan is not None else None

    def clear(self) -> None:
        """Recovery (soft_reset restore): drop votes and plans."""
        with self._lock:
            self._votes.clear()
            self._plans.clear()
            self._plan_order.clear()

    def _store_plan(self, key: tuple, plan: dict) -> None:
        # caller holds self._lock
        self._plans[key] = plan
        self._plan_order.append(key)
        while len(self._plan_order) > self._PLAN_CAP:
            self._plans.pop(self._plan_order.pop(0), None)

    def post(self, epoch: int, evict: FrozenSet[int], rank: int,
             world: int,
             excluded: FrozenSet[int] = frozenset()) -> Optional[dict]:
        """One rank's vote for evicting ``evict`` (world sessions) at
        membership ``epoch``.  ``excluded`` carries the sessions
        evicted in EARLIER epochs: their votes never count and they
        leave the survivor base — a second eviction's majority is over
        the ranks actually still serving, matching the wire-mode tally
        (views share one cumulative evicted set after cutover, so every
        poster passes the same base).  Returns the confirmed plan once
        a strict majority of survivors voted; notifies listeners of
        both the proposal and (once) the confirmation — listeners are
        called OUTSIDE the board lock."""
        evict = frozenset(int(r) for r in evict)
        excluded = frozenset(int(r) for r in excluded)
        notify: List[tuple] = []
        plan = None
        with self._lock:
            stand = self._plans.get((epoch, "evict"))
            if stand is not None:
                return dict(stand)
            if rank in evict or rank in excluded:
                return None  # the condemned/evicted don't vote
            votes = self._votes.setdefault((epoch, "evict", evict), set())
            fresh = rank not in votes
            votes.add(rank)
            survivors = world - len(excluded | evict)
            listeners = list(self._listeners)
            if len(votes) * 2 > survivors:
                plan = {
                    "kind": "evict",
                    "epoch": epoch,
                    "evict": sorted(evict),
                    "votes": sorted(votes),
                    "world": world,
                    "survivors": survivors,
                    "basis": "board",
                }
                self._store_plan((epoch, "evict"), plan)
                notify.append(("confirmed", dict(plan)))
            elif fresh:
                notify.append(("propose", {
                    "epoch": epoch, "evict": sorted(evict),
                    "votes": sorted(votes), "world": world,
                }))
        for kind, payload in notify:
            for fn in listeners:
                try:
                    fn(dict(payload, type=kind))
                except Exception:  # a listener must never fail the vote
                    pass
        return dict(plan) if plan is not None else None

    def petition(self, admit: FrozenSet[int], world: int) -> None:
        """The candidate's JOIN petition: NOT a vote — a listener event
        (type ``join_petition``) the elastic members answer by
        seconding (:meth:`post_join`).  A petition is idempotent and
        retryable; the candidate learns the outcome from the confirmed
        plan's listener event."""
        admit = frozenset(int(r) for r in admit)
        with self._lock:
            listeners = list(self._listeners)
        payload = {"admit": sorted(admit), "world": world}
        for fn in listeners:
            try:
                fn(dict(payload, type="join_petition"))
            except Exception:  # a listener must never fail the petition
                pass

    def post_join(self, epoch: int, admit: FrozenSet[int], rank: int,
                  world: int, excluded: FrozenSet[int] = frozenset(),
                  handoff: Optional[dict] = None) -> Optional[dict]:
        """One member's vote for ADMITTING ``admit`` (world sessions)
        at membership ``epoch`` — the grow mirror of :meth:`post`.  The
        candidate itself never votes (it petitions; the group decides);
        ``excluded`` is the voter's cumulative evicted set and the
        strict majority is over the CURRENT members (world minus
        excluded — the admitted are joining, not leaving, so they don't
        shrink the base).  The confirming voter's ``handoff`` (the
        warm-start artifacts its facade exported) rides the plan to the
        candidate, and ``excluded_after`` carries the post-join
        cumulative eviction record the candidate aligns to.  Returns
        the confirmed plan once the majority voted; notifies listeners
        OUTSIDE the board lock, like :meth:`post`."""
        admit = frozenset(int(r) for r in admit)
        excluded = frozenset(int(r) for r in excluded)
        notify: List[tuple] = []
        plan = None
        with self._lock:
            stand = self._plans.get((epoch, "join"))
            if stand is not None:
                return dict(stand)
            if rank in admit or rank in excluded:
                return None  # the candidate (and the evicted) don't vote
            votes = self._votes.setdefault((epoch, "join", admit), set())
            fresh = rank not in votes
            votes.add(rank)
            members = world - len(excluded)
            listeners = list(self._listeners)
            if len(votes) * 2 > members:
                plan = {
                    "kind": "join",
                    "epoch": epoch,
                    "admit": sorted(admit),
                    "votes": sorted(votes),
                    "world": world,
                    "survivors": members,
                    "excluded_after": sorted(excluded - admit),
                    "basis": "board",
                }
                if handoff:
                    plan["handoff"] = handoff
                self._store_plan((epoch, "join"), plan)
                notify.append(("confirmed", dict(plan)))
            elif fresh:
                notify.append(("join_propose", {
                    "epoch": epoch, "admit": sorted(admit),
                    "votes": sorted(votes), "world": world,
                }))
        for kind, payload in notify:
            for fn in listeners:
                try:
                    fn(dict(payload, type=kind))
                except Exception:  # a listener must never fail the vote
                    pass
        return dict(plan) if plan is not None else None


# ---------------------------------------------------------------------------
# straggler demotion (board tiers)
# ---------------------------------------------------------------------------


class DemotionLedger:
    """Shared per-(comm, rank) demotion breakers plus the per-call
    decision latch.  One instance serves every in-process rank handle
    (board anchor), so the routing decision for call index ``seq`` is
    computed exactly once and read identically by every rank — the
    SPMD-uniformity the barrier-root re-route depends on."""

    def __init__(self, cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else _env_float(DEMOTE_COOLDOWN_ENV, DEFAULT_DEMOTE_COOLDOWN_S)
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[tuple, CircuitBreaker] = {}
        self._decisions: Dict[tuple, dict] = {}
        self._order: List[tuple] = []  # decision-insertion FIFO (gc)
        self.demotions_total = 0
        self.restores_total = 0
        self.last_decision: Dict[int, dict] = {}  # comm -> latest

    def candidates(self, comm_id: int) -> Set[int]:
        """Ranks with demotion state on ``comm_id`` (for pre-computing
        recovery evidence OUTSIDE the ledger lock)."""
        with self._lock:
            return {r for (c, r) in self._breakers if c == comm_id}

    def decide(self, comm_id: int, world: int, seq: int,
               slow: List[int], recovered: Dict[int, bool]) -> dict:
        """The latched routing decision for call index ``seq`` on
        ``comm_id``: first caller computes (possibly transitioning
        breakers), every later caller reads the cached decision —
        identical on every rank by construction.  ``slow`` is the
        exchanged standing slow_rank verdict (shared judge);
        ``recovered`` maps candidate rank -> "its skew recovered"
        (pre-computed outside this lock)."""
        key = (comm_id, seq)
        with self._lock:
            cached = self._decisions.get(key)
            if cached is not None:
                return dict(cached)
            for r in slow:
                brk = self._breakers.get((comm_id, r))
                if brk is None:
                    brk = self._breakers[(comm_id, r)] = CircuitBreaker(
                        threshold=1, cooldown_s=self.cooldown_s,
                        clock=self._clock,
                    )
                if brk.state == CircuitBreaker.CLOSED:
                    brk.record_failure("slow_rank")
                    self.demotions_total += 1
            demoted: List[int] = []
            restored: List[int] = []
            for (c, r), brk in list(self._breakers.items()):
                if c != comm_id:
                    continue
                verdict = brk.allow()
                if verdict == CircuitBreaker.OPEN:
                    demoted.append(r)
                elif verdict == "probe":
                    # re-admission gates on the RECOVERY evidence (the
                    # judge's current EWMA back under the conviction
                    # bar) — the standing verdict itself is cleared by
                    # the caller on restore, so it cannot self-renew
                    if recovered.get(r, False):
                        brk.success()
                        restored.append(r)
                        self.restores_total += 1
                        del self._breakers[(c, r)]
                    else:
                        brk.record_failure("still_slow")
                        demoted.append(r)
            demoted = sorted(set(demoted))
            healthy = [r for r in range(world) if r not in demoted]
            decision = {
                "seq": seq,
                "demoted": demoted,
                "restored": sorted(restored),
                # the re-routed relay/root role: lowest healthy rank
                # (0 when nothing is demoted — the stock choice)
                "root": healthy[0] if healthy else 0,
            }
            self._decisions[key] = decision
            self._order.append(key)
            while len(self._order) > _DECISION_CAP:
                self._decisions.pop(self._order.pop(0), None)
            self.last_decision[comm_id] = decision
            return dict(decision)

    def demoted(self, comm_id: int) -> List[int]:
        """Currently-demoted ranks (OPEN breakers) on ``comm_id`` —
        the advisory view (``suggest_root``); no transitions."""
        with self._lock:
            return sorted(
                r for (c, r), brk in self._breakers.items()
                if c == comm_id and brk.state != CircuitBreaker.CLOSED
            )

    def reset(self) -> None:
        """soft_reset recovery: drop breakers and latched decisions."""
        with self._lock:
            self._breakers.clear()
            self._decisions.clear()
            self._order.clear()
            self.last_decision.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "cooldown_s": self.cooldown_s,
                "demotions_total": self.demotions_total,
                "restores_total": self.restores_total,
                "breakers": {
                    f"{c}/{r}": brk.snapshot()
                    for (c, r), brk in sorted(self._breakers.items())
                },
                "last_decision": {
                    str(c): dict(d)
                    for c, d in sorted(self.last_decision.items())
                },
            }


# ---------------------------------------------------------------------------
# the per-handle view
# ---------------------------------------------------------------------------


class MembershipView:
    """One rank handle's end of the membership plane.

    Created by the ACCL facade unconditionally (sensing is always on);
    the *acting* half — shrink, demotion routing — arms via
    ``elastic`` (``ACCL_ELASTIC=1`` / ``ACCL.set_elastic``).  Exchange
    rides the board when one exists (InProc / gang anchors) and
    ``MEMBER`` wire frames otherwise (``send_fn``, wired by the
    facade over the fabric).
    """

    def __init__(self, rank: int, world: int,
                 board: Optional[MembershipBoard] = None,
                 ledger: Optional[DemotionLedger] = None,
                 send_fn: Optional[Callable[[dict, Set[int]], None]] = None):
        self.rank = int(rank)       # world session of this handle
        self.world = int(world)
        self.board = board
        self.ledger = ledger
        self._send = send_fn
        self.elastic = False
        self._lock = threading.Lock()
        self.epoch = 0
        # wire-mode agreement state for the CURRENT epoch
        self._votes: Dict[FrozenSet[int], Set[int]] = {}
        self._own_vote: Optional[FrozenSet[int]] = None
        self._announced = False
        self._plan: Optional[dict] = None   # confirmed, not yet applied
        self._confirmed = threading.Event()
        self.evicted: Set[int] = set()      # cumulative evicted sessions
        self.self_evicted = False
        self.history: List[dict] = []       # bounded cutover records
        self.proposals = 0
        self.evictions_total = 0
        self.restores_total = 0
        # join (grow) agreement state for the CURRENT epoch
        self._join_votes: Dict[FrozenSet[int], Set[int]] = {}
        self._own_join: Optional[FrozenSet[int]] = None
        self._last_join: Optional[dict] = None  # latest APPLIED join
        self.joins_total = 0
        self.petitions = 0
        # warm handoff: the facade's artifact exporter (contract
        # generation + digest baselines, tuning plan, plan verdicts) —
        # called by the vote that confirms an admission, so the
        # artifacts ride the plan to the candidate
        self.handoff_fn: Optional[Callable[[], dict]] = None
        self._listeners: List[Callable[[dict], None]] = []
        if board is not None:
            board.add_listener(self._on_board_event)

    # -- wiring ---------------------------------------------------------------
    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """Plan-event listener (the engine wires its scheduler wake
        here so in-flight calls against a freshly-confirmed eviction
        fail fast instead of burning their deadline)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def close(self) -> None:
        if self.board is not None:
            self.board.remove_listener(self._on_board_event)

    def _notify(self, event: dict) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(event)
            except Exception:  # a listener must never fail the plane
                pass

    # -- agreement ------------------------------------------------------------
    def propose(self, evict, reason: str = "",
                evidence: Optional[dict] = None) -> Optional[dict]:
        """Phase 1: vote an eviction set (world sessions) at the
        current epoch.  Returns the confirmed plan when this vote (or
        earlier ones) completed the majority."""
        evict = frozenset(int(r) for r in evict)
        if not evict or self.rank in evict:
            # evicting self is a mark, not a vote: the group decides
            with self._lock:
                if self.rank in evict:
                    self.self_evicted = True
            return None
        with self._lock:
            if self._plan is not None:
                return dict(self._plan)
            epoch = self.epoch
            if self._own_vote is None:
                self._own_vote = evict
                self.proposals += 1
            elif self._own_vote != evict:
                # first-proposal-wins: hard PeerDead evidence lands
                # before cascade timeouts, so the genuine dead set wins
                # the race deterministically; conflicting later sets
                # are dropped (they re-propose at the next epoch)
                evict = self._own_vote
        plan = self._vote(epoch, evict, self.rank, reason, evidence)
        if plan is not None:
            return plan
        self._broadcast("propose", epoch, evict)
        return None

    def petition_join(self) -> None:
        """The candidate's end of the GROW agreement (phase 1): ask the
        group to admit this session.  Clears any stale pending state
        from the previous life first (the eviction plan the condemned
        rank adopted but never applied would otherwise block the
        admission confirm from landing); the admission confirms via the
        normal plan surface (``wait_confirmed`` → ``take_cutover``).
        Idempotent and retryable — a petition that races an in-flight
        eviction agreement is simply ignored by busy members."""
        with self._lock:
            self._plan = None
            self._votes.clear()
            self._join_votes.clear()
            self._own_vote = None
            self._own_join = None
            self._announced = False
            self._confirmed.clear()
            self.petitions += 1
        admit = frozenset({self.rank})
        if self.board is not None:
            self.board.petition(admit, self.world)
            return
        self._send_frames({
            "phase": "join_petition",
            "admit": sorted(admit),
            "src_session": self.rank,
        }, exclude=set())

    def _vote(self, epoch: int, evict: FrozenSet[int], rank: int,
              reason: str = "", evidence: Optional[dict] = None
              ) -> Optional[dict]:
        """Register one vote (board post or local tally) and adopt the
        plan if it confirms."""
        if self.board is not None:
            with self._lock:
                excluded = frozenset(self.evicted)
            plan = self.board.post(
                epoch, evict, rank, self.world, excluded=excluded
            )
            if plan is not None:
                self._adopt_plan(plan, reason, evidence)
            return plan
        with self._lock:
            if self._plan is not None:
                return dict(self._plan)
            if (
                epoch != self.epoch or rank in evict
                or rank in self.evicted  # the evicted don't vote
            ):
                return None
            votes = self._votes.setdefault(evict, set())
            votes.add(rank)
            survivors = self.world - len(self.evicted | evict)
            if len(votes) * 2 <= survivors:
                return None
            plan = {
                "kind": "evict",
                "epoch": epoch,
                "evict": sorted(evict),
                "votes": sorted(votes),
                "world": self.world,
                "survivors": survivors,
                "basis": "wire",
            }
        self._adopt_plan(plan, reason, evidence)
        return plan

    def _vote_join(self, epoch: int, admit: FrozenSet[int],
                   rank: int) -> Optional[dict]:
        """Register one ADMISSION vote (board post or local wire tally)
        and adopt the join plan if it confirms.  The voter's handoff
        artifacts ride the board post (the confirming vote's land in
        the plan); on wire tiers the handoff attaches to the confirm
        broadcast instead."""
        if self.board is not None:
            with self._lock:
                excluded = frozenset(self.evicted)
            handoff = None
            if rank == self.rank and self.handoff_fn is not None:
                try:
                    handoff = self.handoff_fn()
                except Exception:  # an exporter must never fail the vote
                    handoff = None
            plan = self.board.post_join(
                epoch, admit, rank, self.world,
                excluded=excluded, handoff=handoff,
            )
            if plan is not None:
                self._adopt_plan(plan)
            return plan
        with self._lock:
            if self._plan is not None:
                if self._plan.get("kind") == "join":
                    return dict(self._plan)
                return None
            if (
                epoch != self.epoch or rank in admit
                or rank in self.evicted  # the evicted don't vote
            ):
                return None
            votes = self._join_votes.setdefault(admit, set())
            votes.add(rank)
            members = self.world - len(self.evicted)
            if len(votes) * 2 <= members:
                return None
            plan = {
                "kind": "join",
                "epoch": epoch,
                "admit": sorted(admit),
                "votes": sorted(votes),
                "world": self.world,
                "survivors": members,
                "excluded_after": sorted(self.evicted - admit),
                "basis": "wire",
            }
        self._adopt_plan(plan)
        return plan

    def _adopt_plan(self, plan: dict, reason: str = "",
                    evidence: Optional[dict] = None) -> None:
        if plan.get("kind") == "join":
            self._adopt_join(plan)
            return
        announce = False
        with self._lock:
            if self._plan is not None or plan.get("epoch") != self.epoch:
                return
            plan = dict(plan)
            if reason:
                plan.setdefault("reason", reason)
            if evidence:
                plan.setdefault("evidence", evidence)
            self._plan = plan
            if self.rank in plan["evict"]:
                self.self_evicted = True
            self._confirmed.set()
            announce = not self._announced
            self._announced = True
        if announce:
            self._broadcast(
                "confirm", plan["epoch"], frozenset(plan["evict"]),
                votes=plan.get("votes"),
            )
        self._notify(dict(plan, type="confirmed"))

    def _broadcast(self, phase: str, epoch: int, evict: FrozenSet[int],
                   votes=None) -> None:
        """Wire-tier exchange: one MEMBER frame per surviving peer.
        Board tiers skip — the shared board already told everyone."""
        if self._send is None or self.board is not None:
            return
        payload = {
            "phase": phase,
            "epoch": epoch,
            "evict": sorted(evict),
            "src_session": self.rank,
        }
        if votes is not None:
            payload["votes"] = sorted(votes)
        try:
            self._send(payload, set(evict) | set(self.evicted))
        except Exception:  # a dead peer mid-broadcast: nothing to tell
            pass

    def _send_frames(self, payload: dict, exclude: Set[int]) -> None:
        """Raw MEMBER frames to the world peers minus ``exclude`` —
        the join phases' exchange (which, unlike evictions, must REACH
        sessions currently outside the shrunk group: the candidate).
        Board tiers skip, like :meth:`_broadcast`."""
        if self._send is None or self.board is not None:
            return
        try:
            self._send(payload, set(exclude))
        except Exception:  # a dead peer mid-broadcast: nothing to tell
            pass

    def _adopt_join(self, plan: dict) -> None:
        """Adopt a confirmed JOIN plan.  Members require the plan at
        their current epoch (the evict discipline); the candidate — by
        definition desynced, it missed every epoch bump since its
        previous life — accepts any join covering it that is not older
        than its own record."""
        candidate = self.rank in set(plan.get("admit") or ())
        announce = False
        with self._lock:
            if self._plan is not None:
                return
            epoch = plan.get("epoch", -1)
            if candidate:
                if not isinstance(epoch, int) or epoch < self.epoch:
                    return  # a previous life's admission: stale
            elif epoch != self.epoch:
                return
            self._plan = dict(plan)
            self._confirmed.set()
            announce = not self._announced and not candidate
            self._announced = True
        if announce:
            self._broadcast_join_confirm(plan)
        self._notify(dict(plan, type="confirmed"))

    def _broadcast_join_confirm(self, plan: dict) -> None:
        """Wire-tier confirm for a JOIN: the announcing member attaches
        its warm-handoff artifacts so the candidate can align its
        contract stream before its first collective."""
        if self._send is None or self.board is not None:
            return
        payload = dict(plan)
        if "handoff" not in payload and self.handoff_fn is not None:
            try:
                payload["handoff"] = self.handoff_fn()
            except Exception:  # an exporter must never fail the confirm
                pass
        payload["phase"] = "join_confirm"
        payload["src_session"] = self.rank
        admit = set(plan.get("admit") or ())
        self._send_frames(payload, exclude=set(self.evicted) - admit)

    def observe_wire(self, payload: dict, src: int = -1) -> None:
        """A peer's MEMBER frame (fabric delivery thread).  Elastic
        handles *second* proposals they cannot refute (phase 2 of the
        agreement); confirmed frames carry the full vote set and are
        adopted directly once the majority checks out locally."""
        phase = payload.get("phase")
        if phase in ("join_petition", "join_propose", "join_confirm"):
            self._observe_join_wire(phase, payload, src)
            return
        try:
            epoch = int(payload.get("epoch", -1))
            evict = frozenset(int(r) for r in payload.get("evict") or ())
            voter = int(payload.get("src_session", src))
        except (TypeError, ValueError):
            return
        if not evict or epoch != self.epoch:
            return
        if self.rank in evict:
            with self._lock:
                self.self_evicted = True
            return
        # tally the sender's vote (and, for confirm frames, the votes
        # it aggregated)
        voters = {voter}
        if phase == "confirm":
            try:
                voters |= {int(v) for v in payload.get("votes") or ()}
            except (TypeError, ValueError):
                pass
        plan = None
        for v in sorted(voters - evict):
            plan = self._vote(epoch, evict, v) or plan
        if plan is not None:
            return
        # phase 2: second a proposal we cannot refute (no conflicting
        # own vote).  Only elastic handles act; passive handles just
        # tally so their snapshot shows the attempt.
        if not self.elastic:
            return
        second = False
        with self._lock:
            if (
                self._own_vote is None and self._plan is None
                and not self.self_evicted
            ):
                self._own_vote = evict
                second = True
        if second:
            self._vote(epoch, evict, self.rank)
            self._broadcast("confirm" if self.confirmed() else "propose",
                            epoch, evict)

    def _observe_join_wire(self, phase: str, payload: dict,
                           src: int) -> None:
        """The GROW agreement's wire phases.  ``join_petition`` (from
        the candidate): elastic members not mid-agreement second it at
        their current epoch and re-broadcast; a member that ALREADY
        applied an admission covering the candidate re-sends the
        confirm (a lost-confirm retry must converge, not re-vote).
        ``join_propose`` (member→member): tally the voter, second if
        fresh.  ``join_confirm``: adopt — the candidate from any epoch
        not older than its own record, members at their current one."""
        try:
            admit = frozenset(int(r) for r in payload.get("admit") or ())
            voter = int(payload.get("src_session", src))
        except (TypeError, ValueError):
            return
        if not admit:
            return
        if self.rank in admit:
            # frames about OUR OWN admission: only the confirm matters
            if phase == "join_confirm":
                plan = {
                    k: v for k, v in payload.items()
                    if k not in ("phase", "src_session")
                }
                plan.setdefault("kind", "join")
                plan.setdefault("basis", "wire")
                self._adopt_plan(plan)
            return
        if not self.elastic:
            return
        with self._lock:
            if self.self_evicted or self.rank in self.evicted:
                return
            busy = self._plan is not None or self._own_vote is not None
            applied = (
                dict(self._last_join)
                if self._last_join is not None else None
            )
        if phase == "join_petition":
            if (
                applied is not None
                and admit <= set(applied.get("admit") or ())
                and applied.get("applied_epoch", 0) >= self.epoch
            ):
                # already admitted; the candidate missed the confirm
                resend = dict(applied)
                resend.pop("applied_epoch", None)
                resend["phase"] = "join_confirm"
                resend["src_session"] = self.rank
                self._send_frames(resend, exclude=set(self.evicted) - admit)
                return
            if busy:
                return  # an agreement is in flight; the candidate retries
            with self._lock:
                if self._own_join is None:
                    self._own_join = admit
                vote_self = self._own_join == admit
                epoch = self.epoch
            if not vote_self:
                return  # already seconding a different admission
            self._send_frames({
                "phase": "join_propose", "epoch": epoch,
                "admit": sorted(admit), "src_session": self.rank,
            }, exclude=set(self.evicted) - admit)
            self._vote_join(epoch, admit, self.rank)
            return
        try:
            epoch = int(payload.get("epoch", -1))
        except (TypeError, ValueError):
            return
        if phase == "join_propose":
            if epoch != self.epoch:
                return
            self._vote_join(epoch, admit, voter)
            second = False
            vote_self = False
            with self._lock:
                if self._plan is None and self._own_vote is None:
                    if self._own_join is None:
                        self._own_join = admit
                        second = True
                    vote_self = self._own_join == admit
            if second:
                self._send_frames({
                    "phase": "join_propose", "epoch": epoch,
                    "admit": sorted(admit), "src_session": self.rank,
                }, exclude=set(self.evicted) - admit)
            if vote_self:
                self._vote_join(epoch, admit, self.rank)
            return
        if phase == "join_confirm":
            plan = {
                k: v for k, v in payload.items()
                if k not in ("phase", "src_session")
            }
            plan.setdefault("kind", "join")
            plan.setdefault("basis", "wire")
            # tally the aggregated votes so local state agrees, then
            # adopt (epoch-checked inside)
            try:
                voters = {int(v) for v in payload.get("votes") or ()}
            except (TypeError, ValueError):
                voters = set()
            for v in sorted((voters | {voter}) - admit):
                self._vote_join(epoch, admit, v)
            self._adopt_plan(plan)

    def _on_board_event(self, event: dict) -> None:
        """Board listener: adopt confirmations; second proposals and
        join petitions (the elastic handles' phase-2 vote)."""
        if event.get("type") == "confirmed":
            self._adopt_plan({k: v for k, v in event.items() if k != "type"})
            return
        if not self.elastic:
            return
        if event.get("type") == "join_petition":
            try:
                admit = frozenset(
                    int(r) for r in event.get("admit") or ()
                )
            except (TypeError, ValueError):
                return
            if not admit or self.rank in admit:
                return
            with self._lock:
                if (
                    self.self_evicted or self.rank in self.evicted
                    or self._plan is not None
                    or self._own_vote is not None
                ):
                    return
            self._vote_join(self.epoch, admit, self.rank)
            return
        if event.get("type") != "propose":
            return
        try:
            epoch = int(event.get("epoch", -1))
            evict = frozenset(int(r) for r in event.get("evict") or ())
        except (TypeError, ValueError):
            return
        if epoch != self.epoch or not evict or self.rank in evict:
            return
        second = False
        with self._lock:
            if (
                self._own_vote is None and self._plan is None
                and not self.self_evicted
            ):
                self._own_vote = evict
                second = True
        if second:
            self._vote(epoch, evict, self.rank)

    # -- verdict surface ------------------------------------------------------
    def confirmed(self) -> Optional[dict]:
        with self._lock:
            return dict(self._plan) if self._plan is not None else None

    def cutover_ready(self) -> bool:
        return self._plan is not None  # racy read; take_cutover decides

    def proposing(self) -> bool:
        """Any votes (own or observed) pending at the current epoch —
        the failed-call path only waits for confirmation when an
        eviction is actually in flight."""
        with self._lock:
            return (
                self._plan is not None or self._own_vote is not None
                or bool(self._votes)
            )

    def wait_confirmed(self, timeout: float) -> Optional[dict]:
        """Bounded wait for a confirmed plan (the shrink deadline);
        None on timeout — the caller surfaces its raw failure."""
        self._confirmed.wait(timeout=max(0.0, float(timeout)))
        return self.confirmed()

    def plan_covers(self, session: int) -> bool:
        """Is ``session`` under a confirmed (or already applied)
        eviction?  The engine's intake/failure paths use this to
        complete with RANK_EVICTED instead of a bare timeout."""
        with self._lock:
            if session in self.evicted:
                return True
            return (
                self._plan is not None
                and self._plan.get("kind", "evict") == "evict"
                and session in self._plan["evict"]
            )

    def evidence(self) -> dict:
        """The agreement evidence attached to RANK_EVICTED errors."""
        with self._lock:
            return {
                "epoch": self.epoch,
                "evicted": sorted(self.evicted),
                "plan": dict(self._plan) if self._plan is not None else None,
                "self_evicted": self.self_evicted,
            }

    # -- cutover / restore ----------------------------------------------------
    def take_cutover(self) -> Optional[dict]:
        """Atomically consume the confirmed plan: bump the membership
        epoch, fold the eviction/admission set into the cumulative
        record, reset the agreement state for the new epoch.  Exactly
        one non-None return per confirmed plan per view — the facade
        applies the communicator surgery on it.  For a JOIN plan the
        admitted side ALIGNS instead of bumping: its epoch becomes the
        group's post-join epoch and its cumulative eviction record
        becomes the plan's ``excluded_after`` (it missed every bump
        since its previous life)."""
        with self._lock:
            plan = self._plan
            if plan is None:
                return None
            self._plan = None
            self._votes.clear()
            self._join_votes.clear()
            self._own_vote = None
            self._own_join = None
            self._announced = False
            self._confirmed.clear()
            if plan.get("kind") == "join":
                admit = set(int(r) for r in plan.get("admit") or ())
                if self.rank in admit:
                    self.epoch = int(plan.get("epoch", self.epoch)) + 1
                    self.evicted = set(
                        int(r) for r in plan.get("excluded_after") or ()
                    )
                    self.self_evicted = False
                else:
                    self.epoch += 1
                    self.evicted -= admit
                self.joins_total += 1
                record = dict(plan, applied_epoch=self.epoch)
                self._last_join = dict(record)
                self.history.append(record)
                if len(self.history) > _HISTORY_CAP:
                    self.history.pop(0)
                return dict(record)
            self.epoch += 1
            self.evicted |= set(plan["evict"])
            if self.rank in self.evicted:
                self.self_evicted = True
            else:
                self.evictions_total += 1
            record = dict(plan, applied_epoch=self.epoch)
            self.history.append(record)
            if len(self.history) > _HISTORY_CAP:
                self.history.pop(0)
            return dict(record)

    def restore(self) -> Optional[dict]:
        """soft_reset recovery (collective, after the operator healed
        the fabric): re-admit every evicted session, drop any pending
        agreement state, and return to membership epoch 0 — the GENESIS
        epoch, so a previously-evicted rank (which never advanced past
        0) realigns with the survivors without needing to have observed
        the shrink at all.  Returns the restore record, or None when
        there was nothing to restore."""
        with self._lock:
            pending = (
                self._plan is not None or self._own_vote is not None
                or bool(self._votes)
            )
            if not self.evicted and not self.self_evicted and not pending:
                return None
            record = {
                "kind": "restore",
                "readmitted": sorted(self.evicted),
                "epoch": 0,
            }
            had_evictions = bool(self.evicted)
            self.evicted.clear()
            self.self_evicted = False
            self._plan = None
            self._votes.clear()
            self._join_votes.clear()
            self._own_vote = None
            self._own_join = None
            self._last_join = None
            self._announced = False
            self._confirmed.clear()
            self.epoch = 0
            if had_evictions:
                self.restores_total += 1
                self.history.append(record)
                if len(self.history) > _HISTORY_CAP:
                    self.history.pop(0)
        if self.board is not None:
            self.board.clear()
        if self.ledger is not None:
            self.ledger.reset()
        return dict(record)

    # -- demotion -------------------------------------------------------------
    def demote_decision(self, comm_id: int, world: int, seq: int,
                        slow: List[int],
                        recovered: Dict[int, bool]) -> dict:
        """The SPMD-uniform routing decision for call index ``seq``:
        derived from the EXCHANGED slow_rank verdict (shared judge) and
        latched per (comm, seq) on the shared ledger — never from local
        observation.  ``{"demoted": [...], "restored": [...],
        "root": n}``; the stock decision when no ledger is shared
        (wire tiers: verdicts are pairwise, routing stays put)."""
        if self.ledger is None or not self.elastic:
            return {"seq": seq, "demoted": [], "restored": [], "root": 0}
        return self.ledger.decide(comm_id, world, seq, slow, recovered)

    def demoted(self, comm_id: int) -> List[int]:
        """Currently-demoted ranks on ``comm_id`` (advisory view)."""
        if self.ledger is None:
            return []
        return self.ledger.demoted(comm_id)

    # -- admission ------------------------------------------------------------
    def join_decision(self) -> dict:
        """The latched admission-decision surface: the latest APPLIED
        join record — majority-confirmed and cutover-applied, so every
        member reads the same record (the ``demote_decision``
        discipline applied to admission; never derived from local
        observation).  The stock record when the group never grew."""
        with self._lock:
            if self._last_join is None:
                return {
                    "epoch": self.epoch, "admitted": [],
                    "world": self.world, "joins_total": 0,
                }
            return {
                "epoch": self._last_join.get("applied_epoch", self.epoch),
                "admitted": list(self._last_join.get("admit") or ()),
                "world": self._last_join.get("world", self.world),
                "joins_total": self.joins_total,
            }

    # -- telemetry ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            doc = {
                "elastic": self.elastic,
                "epoch": self.epoch,
                "world": self.world,
                "evicted": sorted(self.evicted),
                "self_evicted": self.self_evicted,
                "pending_plan": (
                    dict(self._plan) if self._plan is not None else None
                ),
                "proposals": self.proposals,
                "petitions": self.petitions,
                "evictions_total": self.evictions_total,
                "joins_total": self.joins_total,
                "restores_total": self.restores_total,
                "last_join": (
                    dict(self._last_join)
                    if self._last_join is not None else None
                ),
                "history": [dict(h) for h in self.history],
                "exchange": "board" if self.board is not None else "wire",
            }
        if self.ledger is not None:
            doc["demotion"] = self.ledger.snapshot()
        return doc


def member_payload(data: bytes) -> Optional[dict]:
    """Decode one MEMBER wire frame's JSON payload; None on garbage (a
    corrupt-fault frame must never poison the agreement)."""
    try:
        doc = json.loads(data.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    return doc if isinstance(doc, dict) else None
