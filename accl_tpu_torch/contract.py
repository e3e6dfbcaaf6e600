"""The collective contract plane: cross-rank runtime sequence verification.

The reference's CCLO — and our gang tier's SPMD seqn ordering — assume
*matched calls on every rank*: one rank issuing a different op, count,
root, tag or dtype wedges the whole fabric, and the in-flight window
makes the wedge surface N calls after the actual divergence.
This module turns that silent hang into a one-line verdict.

The port's copy of ``accl_tpu/contract.py``, whole: fingerprints and
digests equal the JAX package's bit for bit, so the two packages' ranks
convict the same divergence at the same window.

Opt-in (``ACCL_VERIFY=1`` / ``ACCL.set_contract_verify()``).  When armed:

* every collective call gets a canonical **fingerprint** (op, comm id,
  reset generation, dtype, count, root, tag, per-comm call seqn) hashed
  with crc32 — deliberately NOT Python ``hash()``, which is per-process
  salted;
* fingerprints roll into a per-communicator **digest**; every
  ``ACCL_VERIFY_INTERVAL`` calls the completed window's digest is
  exchanged with the other ranks two ways:

  - **in-process board** — rank handles sharing an engine anchor (the
    InProc fabric, the gang context) post to a shared
    :class:`ContractBoard`; a strict majority that excludes some rank
    convicts it (the multi-slice gang will ride a device-side digest
    reduce instead);
  - **wire piggyback** — emulated fabrics stamp the latest completed
    (window, digest) onto every outgoing message (three ints; zero
    extra traffic) and the receiving endpoint compares claims against
    its own history — so one-process-per-rank socket groups verify with
    no extra round trips;

* on divergence every rank **fails fast** with
  ``ErrorCode.CONTRACT_VIOLATION`` and structured ``ACCLError.details``
  naming the diverging rank, the first mismatched call, and the local
  (plus, in-process, the diverging rank's) flight-recorder tail —
  instead of timing out one hang at a time.

A rank that is *dead* is not *diverging*: verdict construction consults
the gang's health map, so ``kill_rank`` faults keep failing through the
dead-peer fast path rather than being misreported as contract breaks.

Zero dependencies (stdlib only), like ``faults`` and ``telemetry``.
"""

from __future__ import annotations

import os
import threading
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "ContractBoard",
    "ContractVerifier",
    "DEFAULT_VERIFY_INTERVAL",
    "VERIFY_ENV",
    "VERIFY_INTERVAL_ENV",
    "anchored",
    "board_for",
    "call_fingerprint",
    "env_enabled",
    "env_interval",
    "install_fault_plan",
    "kv_digest_exchange",
    "kv_tenant_exchange",
    "roll_digest",
]

VERIFY_ENV = "ACCL_VERIFY"
VERIFY_INTERVAL_ENV = "ACCL_VERIFY_INTERVAL"
DEFAULT_VERIFY_INTERVAL = 8

#: recent per-call summaries retained per communicator (the "first
#: mismatched call" evidence ring; also surfaced in telemetry)
_RING_CAP = 64
#: completed window digests retained per communicator (wire claims from
#: a peer running ahead/behind must still find their comparison point)
_WINDOW_CAP = 128


def env_enabled(environ=None) -> bool:
    """The ``ACCL_VERIFY`` opt-in (read at ACCL-handle construction)."""
    return (environ or os.environ).get(VERIFY_ENV, "0") not in ("0", "")


def env_interval(environ=None) -> int:
    try:
        n = int((environ or os.environ).get(
            VERIFY_INTERVAL_ENV, DEFAULT_VERIFY_INTERVAL
        ))
    except ValueError:
        return DEFAULT_VERIFY_INTERVAL
    return max(1, n)


def call_fingerprint(
    op: str, comm_id: int, generation: int, dtype: Optional[str],
    count: int, root, tag: int, seqn: int,
) -> int:
    """Canonical 32-bit fingerprint of one collective call.  Identical
    inputs fingerprint identically on every rank and process (crc32 of
    a canonical byte string; Python ``hash`` is per-process salted and
    must never leak in here)."""
    data = (
        f"{op}|{comm_id}|{generation}|{dtype or '-'}|{count}|{root}|"
        f"{tag}|{seqn}"
    ).encode()
    return zlib.crc32(data)


def roll_digest(digest: int, fingerprint: int) -> int:
    """Fold one fingerprint into a rolling per-communicator digest
    (order-sensitive: a transposed call sequence yields a different
    digest, which is the point)."""
    return zlib.crc32(fingerprint.to_bytes(4, "little"), digest)


# ---------------------------------------------------------------------------
# seeded fingerprint perturbation (the `diverge` fault action)
# ---------------------------------------------------------------------------

# Device tiers have no fabric to install a FaultPlan on; tests arm the
# `diverge` action there through this process-global injector instead
# (the emulated tiers keep using fabric.install_fault_plan).
_global_lock = threading.Lock()
_global_injector = None


def install_fault_plan(plan) -> None:
    """Arm (or with ``None`` disarm) a process-global FaultPlan for the
    contract plane — the `diverge` action's hook on fabric-less tiers
    (the gang / dist / native tiers)."""
    global _global_injector
    from .faults import FaultInjector

    with _global_lock:
        _global_injector = FaultInjector(plan) if plan is not None else None


def _injector_for(fabric) -> Optional[object]:
    inj = getattr(fabric, "fault_injector", None) if fabric is not None else None
    if inj is not None:
        return inj
    return _global_injector


# ---------------------------------------------------------------------------
# the in-process exchange board
# ---------------------------------------------------------------------------

_board_lock = threading.Lock()


def anchored(anchor, attr: str, factory):
    """One shared exchange object per process-wide ``anchor``: the
    get-or-create-an-attribute discipline both in-process exchange
    planes use — the contract board here, and the monitor plane's skew
    judge (``accl_tpu_torch.monitor.judge_for``) — so rank handles sharing an
    engine anchor (InProc fabric, gang context) meet on one
    instance.  None when the anchor is None (one-process-per-rank
    tiers: the wire piggyback does the exchanging) or cannot hold
    attributes (slotted/foreign anchor)."""
    if anchor is None:
        return None
    with _board_lock:
        obj = getattr(anchor, attr, None)
        if obj is None:
            obj = factory()
            try:
                setattr(anchor, attr, obj)
            except (AttributeError, TypeError):  # slotted/foreign anchor
                return None
        return obj


def board_for(anchor) -> Optional["ContractBoard"]:
    """The :class:`ContractBoard` shared by every rank handle anchored
    on ``anchor`` (the engine's ``contract_anchor()``: the InProc
    fabric, the gang context, or the engine itself on
    one-process-per-rank tiers, where the board degenerates to a single
    poster and the wire piggyback does the comparing)."""
    return anchored(anchor, "_accl_contract_board", ContractBoard)


class ContractBoard:
    """Shared digest exchange for rank handles in one process.

    Each verifier posts ``(comm, generation, window) -> digest`` at its
    window boundaries; a post that completes a *strict majority* whose
    digest excludes some rank convicts that rank (majority needs
    world >= 3 — two-rank groups rely on the wire piggyback's pairwise
    comparison instead).  Verdicts are standing: every later intake on
    the communicator fails fast until a soft_reset clears the board.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (comm, generation, window) -> {rank: digest}
        self._posts: Dict[tuple, Dict[int, int]] = {}
        # (comm, generation, window, rank) -> (ring-tail, tail_fn)
        self._info: Dict[tuple, tuple] = {}
        self._verdicts: Dict[int, dict] = {}  # comm -> standing verdict
        self._listeners: List[Callable[[dict], None]] = []

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def standing(self, comm_id: int) -> Optional[dict]:
        with self._lock:
            return self._verdicts.get(comm_id)

    def retract(self, comm_id: int, rank: int) -> None:
        """Remove one rank's posts/evidence for a communicator — the
        disarm path: a verifier that re-arms later restarts its digest
        stream at generation 1, and its own STALE posts at the same
        (comm, generation, window) keys would otherwise vote against
        its fresh digests (a false conviction).  Standing verdicts are
        deliberately kept — those were real when recorded; recovery
        from a verdict is the collective soft_reset."""
        with self._lock:
            for key in [k for k in self._posts if k[0] == comm_id]:
                self._posts[key].pop(rank, None)
                if not self._posts[key]:
                    del self._posts[key]
            for key in [
                k for k in self._info
                if k[0] == comm_id and k[3] == rank
            ]:
                del self._info[key]

    def clear(self, comm_id: Optional[int] = None) -> None:
        """Drop standing verdicts (and posts) — the soft_reset recovery
        path; ``None`` clears every communicator."""
        with self._lock:
            if comm_id is None:
                self._posts.clear()
                self._info.clear()
                self._verdicts.clear()
            else:
                self._verdicts.pop(comm_id, None)
                for key in [k for k in self._posts if k[0] == comm_id]:
                    del self._posts[key]
                for key in [k for k in self._info if k[0] == comm_id]:
                    del self._info[key]

    def post(
        self, comm_id: int, generation: int, window: int, rank: int,
        world: int, digest: int, ring: List[dict],
        tail_fn: Optional[Callable[[], list]] = None,
        sessions: Optional[tuple] = None,
    ) -> Optional[dict]:
        """Post one completed window digest.  ``rank`` and ``world``
        are COMM-relative (the posting rank within the communicator and
        the communicator's member count — a subcomm's majority is over
        ITS size); ``sessions`` maps comm-relative rank -> global
        session for the verdict report.  Returns the (new or standing)
        verdict for this communicator, if any."""
        notify = None
        with self._lock:
            stand = self._verdicts.get(comm_id)
            if stand is not None:
                return stand
            key = (comm_id, generation, window)
            posts = self._posts.setdefault(key, {})
            posts[rank] = digest
            self._info[key + (rank,)] = (list(ring), tail_fn)
            self._gc(comm_id, generation, window)
            verdict = self._judge(key, posts, world, sessions)
            if verdict is not None:
                self._verdicts[comm_id] = verdict
                notify = list(self._listeners)
                div_tail_fn = verdict.pop("_tail_fn", None)
        if notify is None:
            return None
        # the convicted rank's flight-recorder tail is fetched OUTSIDE
        # the board lock (tail_fn takes the recorder's own lock; no
        # cross-family hold)
        if div_tail_fn is not None:
            try:
                verdict["diverging_flight_recorder"] = div_tail_fn()
            except Exception:
                pass
        for fn in notify:
            try:
                fn(verdict)
            except Exception:  # a listener must never fail the call
                pass
        return verdict

    def _gc(self, comm_id: int, generation: int, window: int) -> None:
        floor = window - _WINDOW_CAP
        stale = [
            k for k in self._posts
            if k[0] == comm_id and (k[1] < generation - 1 or k[2] < floor)
        ]
        for k in stale:
            del self._posts[k]
        stale_i = [
            k for k in self._info
            if k[0] == comm_id and (k[1] < generation - 1 or k[2] < floor)
        ]
        for k in stale_i:
            del self._info[k]

    def _judge(self, key: tuple, posts: Dict[int, int], world: int,
               sessions: Optional[tuple] = None) -> Optional[dict]:
        """Majority vote over the digests posted for one window.  Only a
        STRICT majority (> world/2 agreeing posts) convicts — a 1-1
        split cannot name a culprit, and convicting early on partial
        posts would misname a merely-slow rank."""
        if len(posts) < 2 or len(set(posts.values())) < 2:
            return None
        counts: Dict[int, int] = {}
        for d in posts.values():
            counts[d] = counts.get(d, 0) + 1
        majority_digest, nmaj = max(counts.items(), key=lambda kv: kv[1])
        if nmaj * 2 <= world:
            return None  # no strict majority (yet): wait for more posts
        diverging = sorted(r for r, d in posts.items() if d != majority_digest)
        comm_id, generation, window = key
        verdict = {
            "kind": "divergence",
            "basis": "majority",
            "comm": comm_id,
            "generation": generation,
            "window": window,
            "digests": dict(posts),
            "majority_digest": majority_digest,
            "diverging_rank": diverging[0],
            "diverging_ranks": diverging,
            "diverging_session": (
                sessions[diverging[0]]
                if sessions is not None and diverging[0] < len(sessions)
                else diverging[0]
            ),
        }
        # first mismatched call: walk a majority rank's ring against the
        # convicted rank's, fingerprint by fingerprint
        maj_rank = next(
            (r for r, d in sorted(posts.items()) if d == majority_digest),
            None,
        )
        div_rank = diverging[0]
        maj_info = self._info.get(key + (maj_rank,))
        div_info = self._info.get(key + (div_rank,))
        if maj_info and div_info:
            mismatch = _first_mismatch(maj_info[0], div_info[0])
            if mismatch is not None:
                verdict["first_mismatch"] = mismatch
            if div_info[1] is not None:
                # fetched by post() AFTER the board lock is released
                verdict["_tail_fn"] = div_info[1]
        return verdict


def _first_mismatch(ring_a: List[dict], ring_b: List[dict]) -> Optional[dict]:
    """First (seqn-aligned) call where two ranks' fingerprints differ:
    the expected call (majority side) and the got call (diverging
    side), for the error report."""
    by_seq_b = {r["seqn"]: r for r in ring_b}
    for r in ring_a:
        other = by_seq_b.get(r["seqn"])
        if other is not None and other["fingerprint"] != r["fingerprint"]:
            return {"expected": dict(r), "got": dict(other)}
    # seqn sets may not overlap (epoch skew restarted one side's count)
    if ring_a and ring_b and (
        {r["seqn"] for r in ring_a} & {r["seqn"] for r in ring_b} == set()
    ):
        return {"expected": dict(ring_a[0]), "got": dict(ring_b[0])}
    return None


# ---------------------------------------------------------------------------
# the per-handle verifier
# ---------------------------------------------------------------------------


class _CommContract:
    """Per-communicator rolling state."""

    __slots__ = ("calls", "digest", "windows", "ring", "claims",
                 "pending_relays", "local_rank", "size", "sessions")

    def __init__(self, local_rank: Optional[int] = None,
                 size: Optional[int] = None,
                 sessions: Optional[tuple] = None):
        self.calls = 0          # collective calls recorded (the seqn)
        self.digest = 0         # rolling digest over ALL recorded calls
        self.windows: Dict[int, int] = {}  # completed window -> digest
        self.ring: deque = deque(maxlen=_RING_CAP)
        # wire claims from peers ahead of us: window -> (src_rank, digest)
        self.claims: Dict[int, Tuple[int, int]] = {}
        # relayed pairwise verdicts blaming a third party that we could
        # not yet tiebreak (our window lagged): resolved at the next
        # boundary (bounded; adopt_verdict explains the policy)
        self.pending_relays: List[dict] = []
        # membership (registered by begin_comm): every rank field of
        # this communicator's verdicts — wire msg.src, board posts,
        # blame — is COMM-RELATIVE; mixing in the verifier's world rank
        # misblames on subcommunicators.  sessions maps comm-relative
        # rank -> global session for health lookups + reporting.
        self.local_rank = local_rank
        self.size = size
        self.sessions = sessions


class ContractVerifier:
    """One rank handle's end of the collective contract.

    Created by the ACCL facade when verification is armed; `record` is
    called at call intake (before dispatch, so a verdict fails the call
    *pre-launch*), `observe_message` from fabric delivery threads, and
    `stamp` from the fabric send path.  Thread-safe; every public entry
    takes the verifier lock briefly and never calls out while holding it.
    """

    def __init__(
        self,
        rank: int,
        world: int,
        interval: Optional[int] = None,
        board: Optional[ContractBoard] = None,
        fabric=None,
        tail_fn: Optional[Callable[[], list]] = None,
        health_fn: Optional[Callable[[], dict]] = None,
    ):
        self.rank = rank
        self.world = world
        self.interval = max(1, int(interval or env_interval()))
        self.board = board
        self._fabric = fabric  # injector discovery (fault plan host)
        self._tail_fn = tail_fn
        self._health_fn = health_fn
        self._lock = threading.Lock()
        self._comms: Dict[int, _CommContract] = {}
        self._verdicts: Dict[int, dict] = {}
        self.has_verdict = False  # lock-free fast-path probe
        self._listeners: List[Callable[[dict], None]] = []
        self.generation = 1  # bumped by soft_reset (collective by contract)
        self.calls_verified = 0
        self.windows_exchanged = 0
        self.perturbed = 0  # `diverge` fault applications (seeded tests)
        if board is not None:
            board.add_listener(self._on_board_verdict)

    # -- wiring --------------------------------------------------------------
    def add_verdict_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def close(self) -> None:
        """Disarm: detach from the board and retract this rank's posts
        so a later (collective) re-arm cannot collide its fresh digest
        stream with this life's stale ones."""
        if self.board is None:
            return
        self.board.remove_listener(self._on_board_verdict)
        with self._lock:
            ranks = {
                cid: (
                    st.local_rank
                    if st.local_rank is not None else self.rank
                )
                for cid, st in self._comms.items()
            }
        for cid, r in ranks.items():
            self.board.retract(cid, r)

    def _on_board_verdict(self, verdict: dict) -> None:
        with self._lock:
            self._verdicts.setdefault(verdict["comm"], verdict)
            self.has_verdict = True
            notify = list(self._listeners)
        for fn in notify:
            try:
                fn(verdict)
            except Exception:
                pass

    # -- verdicts ------------------------------------------------------------
    def check(self, comm_id: int) -> Optional[dict]:
        """The standing verdict for ``comm_id`` (own or board), or None."""
        if self.has_verdict:
            with self._lock:
                v = self._verdicts.get(comm_id)
            if v is not None:
                return v
        if self.board is not None:
            v = self.board.standing(comm_id)
            if v is not None:
                with self._lock:
                    self._verdicts.setdefault(comm_id, v)
                    self.has_verdict = True
            return v
        return None

    def _set_verdict(self, comm_id: int, verdict: dict) -> None:
        with self._lock:
            if comm_id in self._verdicts:
                return
            self._verdicts[comm_id] = verdict
            self.has_verdict = True
            notify = list(self._listeners)
        for fn in notify:
            try:
                fn(verdict)
            except Exception:
                pass

    # -- recording (call intake) ---------------------------------------------
    def record(
        self, op: str, comm_id: int, dtype: Optional[str], count: int,
        root, tag: int,
    ) -> Optional[dict]:
        """Fingerprint one collective call and roll it into the
        communicator's digest; at a window boundary, exchange.  Returns
        the standing verdict if one exists (callers fail the call
        pre-dispatch)."""
        post = None
        # injector consult OUTSIDE the verifier lock (it takes its own;
        # no cross-family hold for the lock-order registry to flag) —
        # the rule's rank matches COMM-relative like every FaultRule
        # rank field, so peek the registered membership first.  The
        # no-injector production path skips the peek entirely (a
        # lock-free getattr + global read, not an extra lock round-trip
        # on the <=5%-budgeted warm path).
        mask = 0
        if _injector_for(self._fabric) is not None:
            with self._lock:
                st0 = self._comms.get(comm_id)
                rank0 = (
                    st0.local_rank
                    if st0 is not None and st0.local_rank is not None
                    else self.rank
                )
            mask = self._perturb_mask(comm_id, rank0)
        with self._lock:
            v = self._verdicts.get(comm_id)
            if v is not None:
                return v
            st = self._comm_state(comm_id)
            comm_rank = (
                st.local_rank if st.local_rank is not None else self.rank
            )
            comm_size = st.size or self.world
            sessions = st.sessions
            seqn = st.calls
            fp = call_fingerprint(
                op, comm_id, self.generation, dtype, count, root, tag, seqn
            )
            if mask:
                self.perturbed += 1
                fp ^= mask
            st.digest = roll_digest(st.digest, fp)
            st.calls = seqn + 1
            self.calls_verified += 1
            st.ring.append({
                "seqn": seqn, "op": op, "dtype": dtype, "count": count,
                "root": root, "tag": tag, "fingerprint": fp,
            })
            if st.calls % self.interval == 0:
                window = st.calls // self.interval - 1
                st.windows[window] = st.digest
                if len(st.windows) > _WINDOW_CAP:
                    for w in sorted(st.windows)[:-_WINDOW_CAP]:
                        del st.windows[w]
                self.windows_exchanged += 1
                pairwise = self._check_claims(st, comm_id, window)
                if pairwise is None and st.pending_relays:
                    # parked third-party relays: our freshly completed
                    # window is the tiebreaker they were waiting for.
                    # Adopt the first one that resolves; re-park those
                    # for windows we haven't reached; a relay for a
                    # window we PASSED but cannot tiebreak (generation
                    # skew / pruned history) is adopted as-is — its
                    # blame may be the sender's guess, but staying
                    # silent would trade wrong blame for a hang.
                    relays, st.pending_relays = st.pending_relays, []
                    keep: List[dict] = []
                    for vd in relays:
                        if pairwise is not None:
                            keep.append(vd)
                        elif self._tiebreak_pairwise(vd, st):
                            pairwise = vd
                        elif (vd.get("window") or 0) > window:
                            keep.append(vd)  # not our tiebreak point yet
                        else:
                            pairwise = vd  # passed window: best effort
                    st.pending_relays = keep
                post = (window, st.digest, list(st.ring))
        if post is None:
            return self.check(comm_id) if self.has_verdict else None
        # ALWAYS post the completed window to the board, even when a
        # pairwise claim already convicted: the other ranks' majority
        # needs this digest to form their own (better-attributed)
        # verdict — skipping the post on self-detection left peers
        # blocked in flight until their engine deadline
        if self.board is not None:
            window, digest, ring = post
            # rank and majority threshold are COMM-relative: a subcomm's
            # majority is over ITS member count, not the world's (a
            # world-sized threshold would make subcomm conviction
            # impossible on the board-only gang tier)
            verdict = self.board.post(
                comm_id, self.generation, window, comm_rank, comm_size,
                digest, ring, tail_fn=self._tail_fn, sessions=sessions,
            )
            if verdict is not None:
                # prefer the board's majority attribution over the
                # pairwise guess when both land on the same boundary
                with self._lock:
                    self._verdicts.setdefault(comm_id, verdict)
                    self.has_verdict = True
                return verdict
        if pairwise is not None:
            self._annotate_health(pairwise)
            self._set_verdict(comm_id, pairwise)
            return pairwise
        return None

    def _perturb_mask(self, comm_id: int, comm_rank: int) -> int:
        """The `diverge` fault action: a nonzero XOR mask when a seeded
        FaultRule says this rank's next fingerprint diverges (the proof
        the verifier catches real divergence); 0 otherwise.  The rule's
        ``rank`` field matches COMM-relative, like every other
        FaultRule rank field."""
        inj = _injector_for(self._fabric)
        if inj is None:
            return 0
        return inj.on_fingerprint(comm_id, comm_rank)

    # -- wire piggyback -------------------------------------------------------
    def stamp(self, comm_id: int) -> Tuple[int, int, int]:
        """(generation, window, digest) of the latest completed window
        for ``comm_id`` — stamped onto outgoing wire messages.  window
        -1 = nothing completed yet (receivers skip)."""
        with self._lock:
            st = self._comms.get(comm_id)
            if st is None or not st.windows:
                return self.generation, -1, 0
            w = max(st.windows)
            return self.generation, w, st.windows[w]

    def observe_claim(
        self, comm_id: int, src_rank: int, generation: int, window: int,
        digest: int,
    ) -> Optional[dict]:
        """A peer's piggybacked digest claim (fabric delivery thread).
        ``src_rank`` is COMM-relative (the wire message's src field).
        Claims from other generations are skipped (a soft_reset is in
        flight); a claim for a window we have completed is compared
        immediately, one ahead of us is parked until we complete it."""
        if window < 0:
            return None
        verdict = None
        with self._lock:
            if generation != self.generation:
                return None
            v = self._verdicts.get(comm_id)
            if v is not None:
                return v
            st = self._comm_state(comm_id)
            if src_rank == (
                st.local_rank if st.local_rank is not None else self.rank
            ):
                return None
            ours = st.windows.get(window)
            if ours is None:
                st.claims[window] = (src_rank, digest)
                if len(st.claims) > _WINDOW_CAP:
                    for w in sorted(st.claims)[:-_WINDOW_CAP]:
                        del st.claims[w]
                return None
            if ours != digest:
                verdict = self._pairwise_verdict(
                    st, comm_id, src_rank, window, ours, digest
                )
        if verdict is not None:
            self._annotate_health(verdict)
            self._set_verdict(comm_id, verdict)
        return verdict

    def adopt_verdict(self, comm_id: int, verdict: dict,
                      src_rank: Optional[int] = None) -> None:
        """A verdict relayed from a peer (wire VERIFY message): adopt it
        so in-flight and future calls on this rank fail fast too.

        Pairwise blame is re-resolved locally before adoption: the
        relay carries both parties' digests, and comparing them against
        OUR digest for the same window makes this rank the tiebreaker —
        the party whose digest differs from ours is the diverger (a
        two-plus-one majority).  When we cannot tiebreak (window not
        completed here, generation skew) a relay that blames US is
        re-oriented to blame the sender — from this rank's perspective
        the other side of the pair is the relaying peer."""
        verdict = dict(verdict)
        verdict["relayed"] = True
        if verdict.get("basis") == "pairwise":
            resolved = False
            digests = verdict.get("digests") or {}
            try:
                parties = {int(r): d for r, d in digests.items()}
            except (TypeError, ValueError):
                parties = {}
            window = verdict.get("window")
            ours = None
            sessions = None
            with self._lock:
                st = self._comms.get(comm_id)
                comm_rank = (
                    st.local_rank
                    if st is not None and st.local_rank is not None
                    else self.rank
                )
                if st is not None:
                    sessions = st.sessions
                if (
                    st is not None and window is not None
                    and verdict.get("generation") == self.generation
                ):
                    ours = st.windows.get(window)
            if ours is not None and parties:
                resolved = self._tiebreak_pairwise_against(
                    verdict, parties, ours, comm_rank, sessions
                )
            if not resolved and src_rank is not None:
                blamed = verdict.get("diverging_rank")
                if blamed == comm_rank:
                    self._reblame(verdict, src_rank, sessions)
                elif blamed != src_rank:
                    # blames a THIRD party and we cannot tiebreak yet
                    # (our window lags the verdict's): the sender may
                    # itself be the diverger misblaming a conforming
                    # rank.  Park until our next boundary — at most one
                    # call away on a live rank — where the local digest
                    # settles the blame before anything is reported.
                    with self._lock:
                        if comm_id in self._verdicts:
                            return
                        st = self._comm_state(comm_id)
                        if len(st.pending_relays) < 8:
                            st.pending_relays.append(verdict)
                    return
        self._set_verdict(comm_id, verdict)

    @staticmethod
    def _reblame(verdict: dict, rank: int,
                 sessions: Optional[tuple]) -> None:
        """Re-point a verdict's blame at ``rank`` — ALL three fields
        together (diverging_rank/_ranks/_session); leaving the session
        stale would send an operator to the wrong host."""
        verdict["diverging_rank"] = rank
        verdict["diverging_ranks"] = [rank]
        verdict["diverging_session"] = (
            sessions[rank]
            if sessions is not None and rank < len(sessions) else rank
        )

    def _tiebreak_pairwise_against(
        self, verdict: dict, parties: Dict[int, int], ours: int,
        comm_rank: int, sessions: Optional[tuple] = None,
    ) -> bool:
        """Resolve a relayed pairwise verdict's blame using OUR digest
        as the third vote: the party whose digest differs from ours is
        the diverger.  ``comm_rank`` is our COMM-relative rank (the
        space every party key lives in).  Mutates the verdict's blame
        fields; False when the evidence cannot decide (both parties
        differ, or none)."""
        odd = sorted(
            r for r, d in parties.items() if r != comm_rank and d != ours
        )
        if len(odd) != 1:
            return False
        self._reblame(verdict, odd[0], sessions)
        return True

    def _tiebreak_pairwise(self, verdict: dict,
                           st: _CommContract) -> bool:
        """The parked-relay form: look our digest up by the verdict's
        window (verifier lock held by the caller)."""
        digests = verdict.get("digests") or {}
        try:
            parties = {int(r): d for r, d in digests.items()}
        except (TypeError, ValueError):
            return False
        ours = st.windows.get(verdict.get("window"))
        if ours is None:
            return False
        return self._tiebreak_pairwise_against(
            verdict, parties, ours,
            st.local_rank if st.local_rank is not None else self.rank,
            st.sessions,
        )

    def _check_claims(self, st: _CommContract, comm_id: int,
                      window: int) -> Optional[dict]:
        """Compare parked peer claims against a freshly completed
        window (verifier lock held)."""
        claim = st.claims.pop(window, None)
        if claim is None:
            return None
        src_rank, digest = claim
        if digest == st.windows[window]:
            return None
        return self._pairwise_verdict(
            st, comm_id, src_rank, window, st.windows[window], digest
        )

    def _pairwise_verdict(
        self, st: _CommContract, comm_id: int, src_rank: int, window: int,
        ours: int, theirs: int,
    ) -> dict:
        """Two digests disagree and there is no majority to consult: by
        convention each side names the *peer* — correct on the
        conforming side, which is where production reads the report.
        All rank fields are COMM-relative; ``diverging_session`` maps
        the blame to the global rank identity when the membership was
        registered.  Verifier lock held by the caller — the health
        annotation (which calls out to the engine) is applied AFTER
        release by :meth:`_annotate_health`."""
        comm_rank = st.local_rank if st.local_rank is not None else self.rank
        session = (
            st.sessions[src_rank]
            if st.sessions is not None and src_rank < len(st.sessions)
            else src_rank
        )
        return {
            "kind": "divergence",
            "basis": "pairwise",
            "comm": comm_id,
            "generation": self.generation,
            "window": window,
            "digests": {comm_rank: ours, src_rank: theirs},
            "diverging_rank": src_rank,
            "diverging_ranks": [src_rank],
            "diverging_session": session,
            "local_recent_calls": list(st.ring),
        }

    def _annotate_health(self, verdict: dict) -> None:
        """Fill the kill_rank-vs-diverge distinction in OUTSIDE the
        verifier lock (health_report may call into the engine): a peer
        the health map already calls dead is reported as dead, not
        diverging."""
        if self._health_fn is None or verdict.get("relayed"):
            return
        try:
            # the health map is keyed by WORLD rank == Rank.session
            health = (self._health_fn() or {}).get(
                verdict.get("diverging_session")
            )
        except Exception:
            health = None
        verdict["peer_health"] = health
        if health is not None and health.get("state") == "dead":
            verdict["kind"] = "rank_dead"

    # -- lifecycle -----------------------------------------------------------
    def _comm_state(self, comm_id: int) -> _CommContract:
        """Per-comm state, creating a membership-less entry on first
        touch (world-comm fallbacks apply until begin_comm registers
        the real membership).  Verifier lock held by the caller."""
        st = self._comms.get(comm_id)
        if st is None:
            st = self._comms[comm_id] = _CommContract()
        return st

    def begin_comm(
        self, comm_id: int, local_rank: Optional[int] = None,
        sessions: Optional[tuple] = None, fresh: bool = True,
    ) -> None:
        """Register a communicator's membership (COMM-relative local
        rank + comm-relative-rank -> global session map — the spaces
        every wire src / board post / blame field live in) and, for a
        (re-)created instance (``fresh=True``), fold a begin marker
        into the continuous digest stream instead of resetting it — a
        rank that re-creates a subcomm when its peers don't diverges at
        the next window boundary (the subcomm-epoch-skew failure)."""
        with self._lock:
            st = self._comm_state(comm_id)
            if local_rank is not None:
                st.local_rank = local_rank
            if sessions is not None:
                st.sessions = tuple(sessions)
                st.size = len(st.sessions)
            if not fresh or comm_id in self._verdicts:
                return
            fp = call_fingerprint(
                "__begin__", comm_id, self.generation, None, 0, 0, 0,
                st.calls,
            )
            st.digest = roll_digest(st.digest, fp)

    def shrink_comm(self, comm_id: int, local_rank: int,
                    sessions: tuple, membership_epoch: int) -> None:
        """Membership-plane cutover (``accl_tpu_torch.membership``): fold a
        ``__shrink__`` marker into the CONTINUOUS digest stream — the
        ``__begin__`` discipline applied to eviction — and re-register
        the shrunk membership (new comm-relative local rank + rank ->
        session map).  A rank that missed the cutover keeps digesting
        the old membership and diverges at the next window boundary:
        one window of delay instead of a silent hang.  Pre-shrink wire
        claims are dropped — their src ranks live in the old rank
        space."""
        with self._lock:
            st = self._comm_state(comm_id)
            st.local_rank = int(local_rank)
            st.sessions = tuple(sessions)
            st.size = len(st.sessions)
            fp = call_fingerprint(
                "__shrink__", comm_id, self.generation, None,
                len(sessions), membership_epoch, 0, st.calls,
            )
            st.digest = roll_digest(st.digest, fp)
            st.claims.clear()
            st.pending_relays.clear()

    def join_comm(self, comm_id: int, local_rank: int, sessions: tuple,
                  membership_epoch: int,
                  base: Optional[tuple] = None) -> None:
        """Membership-plane GROW cutover: re-register the grown
        membership and fold a ``__join__`` marker into the digest
        stream — the ``__shrink__`` discipline run in the other
        direction.  ``base`` is the agreed ``(calls, digest)`` restart
        point carried by the confirmed join plan's warm handoff: every
        member (survivor and candidate alike) rebases its stream on it
        before folding the marker, so the candidate — whose local
        stream is empty or belongs to a previous life — converges on
        the group's digest at the cutover boundary instead of
        diverging forever.  A rank that MISSED the cutover keeps
        rolling its old stream and diverges within one verification
        window, exactly like a missed shrink.  Without a base
        (defensive: a plan with no handoff) the marker folds into the
        continuous stream, shrink-style."""
        with self._lock:
            st = self._comm_state(comm_id)
            st.local_rank = int(local_rank)
            st.sessions = tuple(sessions)
            st.size = len(st.sessions)
            if base is not None:
                try:
                    st.calls = int(base[0])
                    st.digest = int(base[1])
                except (TypeError, ValueError, IndexError):
                    pass
            fp = call_fingerprint(
                "__join__", comm_id, self.generation, None,
                len(sessions), membership_epoch, 0, st.calls,
            )
            st.digest = roll_digest(st.digest, fp)
            st.claims.clear()
            st.pending_relays.clear()

    def export_handoff(self) -> dict:
        """The contract half of the warm-handoff artifacts an admitting
        member exports for the candidate (JSON-serializable): the
        generation (so stale wire stamps from the candidate's previous
        life are ignored by ``observe_claim``) and each registered
        communicator's ``(calls, digest)`` baseline — the agreed
        restart point :meth:`join_comm` rebases every member on."""
        with self._lock:
            return {
                "generation": self.generation,
                "interval": self.interval,
                "comms": {
                    str(cid): {"calls": st.calls, "digest": st.digest}
                    for cid, st in self._comms.items()
                },
            }

    def adopt_generation(self, generation: int) -> None:
        """Candidate-side handoff adoption: align the verification
        generation with the group's (the candidate's own generation
        belongs to its previous life — its posts would be ignored and
        peers' claims skipped without this)."""
        with self._lock:
            self.generation = int(generation)

    def reset(self) -> None:
        """soft_reset recovery: drop every verdict, digest and claim and
        start a new generation (collective by contract, so generations
        stay aligned across ranks; stale wire stamps from the old
        generation are ignored by ``observe_claim``).  Registered
        memberships survive — only the rolling state restarts."""
        with self._lock:
            self._comms = {
                cid: _CommContract(st.local_rank, st.size, st.sessions)
                for cid, st in self._comms.items()
            }
            self._verdicts.clear()
            self.has_verdict = False
            self.generation += 1
        if self.board is not None:
            self.board.clear()

    # -- telemetry ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "interval": self.interval,
                "generation": self.generation,
                "calls_verified": self.calls_verified,
                "windows_exchanged": self.windows_exchanged,
                "perturbed": self.perturbed,
                "verdicts": {
                    str(c): {
                        k: v for k, v in vd.items()
                        if k not in ("local_recent_calls",
                                     "diverging_flight_recorder")
                    }
                    for c, vd in self._verdicts.items()
                },
                "comms": {
                    str(c): {"calls": st.calls, "digest": st.digest,
                             "windows": len(st.windows)}
                    for c, st in self._comms.items()
                },
            }


def kv_digest_exchange(kv, verifier: "ContractVerifier", comm_id: int,
                       local_rank: int, size: int,
                       state: Optional[dict] = None,
                       is_notfound=None) -> dict:
    """Piggyback the verifier's rolling digest onto a distributed KV
    plane — the dist tier's exchange path: post
    this rank's latest completed window digest under
    ``accl/vfy/<comm>/<gen>/<window>/<rank>`` and compare every peer's
    posted digest via :meth:`ContractVerifier.observe_claim`, so
    cross-host divergence fails fast exactly like in-process.

    ``kv`` needs ``key_value_set_bytes(key, bytes)`` and
    ``key_value_try_get_bytes(key) -> bytes|None`` (a distributed
    KV client's surface); ``state`` carries the per-comm cursor
    (``{"posted": window, "checked": {peer: window}}``) between calls
    so warm calls cost one stamp read.  Missing peer keys (a rank
    behind us) are skipped — ``is_notfound(exc)`` classifies raisy KV
    clients.  Returns counter deltas for telemetry.  Stdlib-only so
    the exchange is unit-testable with a dict-backed fake KV.
    """
    out = {"posted": 0, "claims": 0, "errors": 0}
    gen, window, digest = verifier.stamp(comm_id)
    if window < 0:
        return out
    st = state if state is not None else {}
    base = f"accl/vfy/{comm_id}/{gen}"
    if st.get("posted") != (gen, window):
        try:
            kv.key_value_set_bytes(
                f"{base}/{window}/{local_rank}", str(digest).encode()
            )
            st["posted"] = (gen, window)
            out["posted"] = 1
        except Exception:
            out["errors"] += 1
            return out  # the KV is unreachable: nothing to compare
    checked = st.setdefault("checked", {})
    for peer in range(size):
        if peer == local_rank or checked.get(peer) == (gen, window):
            continue
        try:
            raw = kv.key_value_try_get_bytes(f"{base}/{window}/{peer}")
        except Exception as e:
            if is_notfound is not None and is_notfound(e):
                continue  # peer hasn't completed this window yet
            out["errors"] += 1
            continue
        if raw is None:
            continue
        try:
            theirs = int(raw)
        except ValueError:
            out["errors"] += 1
            continue
        checked[peer] = (gen, window)
        out["claims"] += 1
        verifier.observe_claim(comm_id, peer, gen, window, theirs)
    return out


def kv_tenant_exchange(kv, process_key: str, weights: dict,
                       state: Optional[dict] = None,
                       is_notfound=None, slot_cap: int = 64):
    """Share one process's QoS tenant weight table through the dist
    tier's KV plane — the cross-process tenant registry (the arbiter's
    per-process DRR is fair only among tenants it can SEE; two
    one-process-per-rank jobs sharing a fabric each run a blind
    arbiter, and the bulk job starves the serving job exactly as if
    no arbiter existed).

    Rendezvous rides the contract-digest ledger discipline: the
    first call claims a dense slot index via
    ``key_value_increment("accl/arb/slots")`` (the KV plane's atomic
    counter — no registry key to race), then posts this process's
    table as JSON under ``accl/arb/slot/<i>`` (re-posted only when the
    table changes, so warm exchanges cost one sweep).  The sweep scans
    slots upward and stops at the first gap past our own slot (slots
    are claimed densely; a gap *below* us is a peer that claimed but
    has not posted yet, and is skipped, not a stop), bounded by
    ``slot_cap``.

    ``kv`` needs ``key_value_set_bytes`` / ``key_value_try_get_bytes``
    / ``key_value_increment`` (a distributed KV client's
    surface); ``state`` carries the slot claim and last-posted doc
    between calls.  Returns ``(foreign, counters)``: foreign maps each
    peer process key to ``{"weights": {...}, "total": int}``.
    Stdlib-only so the exchange is unit-testable with a
    dict-backed fake KV."""
    import json as _json

    out = {"posted": 0, "peers": 0, "errors": 0}
    st = state if state is not None else {}
    slot = st.get("slot")
    if slot is None:
        try:
            slot = int(kv.key_value_increment("accl/arb/slots", 1)) - 1
        except Exception:
            out["errors"] += 1
            return {}, out  # the KV is unreachable: nothing to share
        st["slot"] = slot
    doc = _json.dumps(
        {
            "process": str(process_key),
            "weights": {str(k): int(v) for k, v in sorted(weights.items())},
        },
        sort_keys=True,
    )
    if st.get("posted_doc") != doc:
        try:
            kv.key_value_set_bytes(f"accl/arb/slot/{slot}", doc.encode())
            st["posted_doc"] = doc
            out["posted"] = 1
        except Exception:
            out["errors"] += 1
            return {}, out
    foreign: dict = {}
    for i in range(max(slot + 1, int(slot_cap))):
        if i == slot:
            continue
        try:
            raw = kv.key_value_try_get_bytes(f"accl/arb/slot/{i}")
        except Exception as e:
            if is_notfound is not None and is_notfound(e):
                raw = None
            else:
                out["errors"] += 1
                continue
        if raw is None:
            if i > slot:
                break  # past the dense frontier: no more claimed slots
            continue  # a lower slot claimed but not yet posted
        try:
            peer_doc = _json.loads(
                raw.decode() if isinstance(raw, (bytes, bytearray))
                else str(raw)
            )
            pk = str(peer_doc["process"])
            w = {
                str(k): int(v)
                for k, v in (peer_doc.get("weights") or {}).items()
            }
        except (KeyError, TypeError, ValueError):
            out["errors"] += 1
            continue
        if pk == str(process_key):
            continue  # a stale slot from a restarted self
        foreign[pk] = {"weights": w, "total": sum(w.values())}
        out["peers"] += 1
    return foreign, out


def verdict_context(verdict: dict, op: Optional[str] = None) -> dict:
    """Structured ``ACCLError.details`` for a contract verdict: the
    diverging rank rides at top level (the one-line answer), the full
    verdict underneath."""
    ctx = {
        "diverging_rank": verdict.get("diverging_rank"),
        "contract": verdict,
        "comm": verdict.get("comm"),
    }
    if op is not None:
        ctx["op"] = op
    return ctx
