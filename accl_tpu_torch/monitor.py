"""The live observability service: continuous monitoring over the
telemetry plane.

The port's copy of ``accl_tpu/monitor.py``, whole.  The port's facade
wires the always-on skew tracker and anomaly watchdog and the two opt-in
services (the scrape server and the trace stream); :class:`BlackBox`'s
postmortem wiring, :class:`ScaleAdvisor`'s ``/membership`` advice and
the shared :func:`~accl_tpu_torch.contract.anchored` registry come with
the port's fault, membership and contract planes; the facade's
``/tenants`` route serves its arbiter's snapshot, and the advisor reads
the arbiter's per-tenant latency histograms.

Role model: the reference's observability is *always on and live* — a
free-running hardware perf counter copied into exchange memory on every
call, ``ACCL::get_duration``, the 27-bit per-call error bitmask.  The
telemetry plane alone (flight recorder, metrics registry, trace export)
is pull-on-demand and single-rank: it cannot watch a running job, and
nothing in it correlates windows *across* ranks, so a persistently slow
rank stays invisible until it becomes a timeout.  This module makes the
plane continuous:

* **Scrape service** (:class:`MonitorServer`) — an opt-in stdlib
  ``http.server`` on an ``accl-monitor`` thread serving ``/metrics``
  (Prometheus text rendered from the existing registry), ``/snapshot``
  (the ``telemetry_snapshot()`` JSON) and ``/trace`` (the rolling
  Chrome-trace window).  Armed by ``ACCL.start_monitor()`` or the
  ``ACCL_MONITOR_PORT`` env var.
* **Streaming trace export** (:class:`TraceStreamWriter`) — a bounded
  rolling-file writer (``ACCL_TRACE_STREAM=<dir>``) that continuously
  flushes completed flight-recorder records as Perfetto-loadable trace
  files (each file is a complete JSON document, written atomically), so
  a crash leaves a loadable timeline instead of nothing.
* **Cross-rank straggler analysis** (:class:`SkewTracker` /
  :class:`SkewJudge`) — two coupled signals, exchanged on the contract
  plane's window cadence (in-process tiers meet on a judge anchored
  exactly like the contract board via ``contract_anchor()``;
  one-process-per-rank fabrics piggyback on outgoing messages like the
  contract digest stamp):

  - **wait baselines** (all four tiers): per-collective wait durations
    recorded at completion fold into per-rank EWMA *relative-wait*
    baselines — the dashboard's who-waits-how-much view.  Deliberately
    NOT a conviction signal: a synchronizing collective equalizes
    completion times (a ring diffuses a slow link into every rank's
    wait within one cycle), and fire-and-forget eager sends give
    roots/senders structurally shorter waits than leaves — duration
    lag alone both misses real stragglers and convicts innocent roots.
  - **arrival skew** (fabric tiers): every delivered message carries
    its send timestamp, so each receiver measures per-SOURCE wire
    latency — the direct observable of "rank p's messages arrive
    late", which is what a slow sender/NIC/link actually looks like
    and is immune to the wash-out above.  Window means fold into
    per-rank EWMA latency baselines; a rank persistently beyond BOTH
    the absolute floor and the dominance factor over the runner-up
    yields a structured ``slow_rank`` verdict — majority-grade on
    board tiers (all receivers' observations aggregated by median),
    pairwise on wire tiers (each side blames from its own
    observations — correct on the conforming side, the contract
    plane's pairwise discipline).

  Verdicts surface in ``telemetry_snapshot()["stragglers"]``, as
  Prometheus gauges, and as a ``suspect_slow`` annotation on the
  health map (annotation only — never fail-fast: slowness is an
  operator signal, not a failure).
* **Anomaly watchdog** (:class:`AnomalyWatchdog`) — rolling EWMA
  latency baselines per (op × size bucket) emitting bounded alert
  records into the snapshot when a call regresses past a configurable
  factor of its baseline.

Clock caveat (documented honestly): send timestamps are wall-clock
(``time.time_ns`` — the only clock two processes share), so cross-HOST
latency skew inherits whatever NTP leaves; same-host fabrics (the whole
test matrix) are exact.  The absolute floor and the dominance factor
together keep µs-scale noise from ever convicting anyone — uniform
load produces zero verdicts.

Zero dependencies (stdlib only), like ``telemetry``.

Env knobs:

* ``ACCL_MONITOR_PORT=N``         — start the scrape service at handle
  construction (0 = ephemeral; the bound port is in ``capabilities()``)
* ``ACCL_TRACE_STREAM=dir``       — stream completed trace segments
* ``ACCL_TRACE_STREAM_EVENTS=N``  — events per rolling file (def 4096)
* ``ACCL_TRACE_STREAM_FILES=N``   — rolling files kept (default 8)
* ``ACCL_TRACE_STREAM_INTERVAL_S``— flush cadence (default 0.5)
* ``ACCL_SKEW_INTERVAL=N``        — collectives per skew window (def 8)
* ``ACCL_STRAGGLER_FACTOR``       — lag dominance factor (default 4.0)
* ``ACCL_STRAGGLER_MIN_US``       — absolute lag floor (default 200.0)
* ``ACCL_STRAGGLER_WINDOWS``      — consecutive windows to convict (2)
* ``ACCL_ANOMALY_FACTOR``         — latency regression factor (4.0)
* ``ACCL_SCALE_GROW_P99_US``      — tenant p99 high-water for a *grow*
  recommendation (default 50000.0)
* ``ACCL_SCALE_SHRINK_P99_US``    — tenant p99 low-water for a *shrink*
  recommendation (default 1000.0)

Traffic-aware scale advice (:class:`ScaleAdvisor`) closes the loop from
the QoS arbiter's per-tenant latency histograms to the elastic
membership plane — advisory only, the ``suspect_slow`` annotation
discipline: a sustained p99 tail or queue backlog on guaranteed-class
tenants yields a ``grow`` recommendation, a uniformly idle tail yields
``shrink``, and the verdict surfaces in
``telemetry_snapshot()["membership"]["scale_advice"]`` and the
``/membership`` route.  Nothing ever acts on it automatically —
``join_rank``/``evict_rank`` are the operator's calls.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .contract import anchored

__all__ = [
    "AnomalyWatchdog",
    "BlackBox",
    "Monitor",
    "MonitorServer",
    "ScaleAdvisor",
    "SkewJudge",
    "SkewTracker",
    "TraceStreamWriter",
    "env_port",
    "env_postmortem_dir",
    "judge_for",
    "load_bundle",
]

MONITOR_PORT_ENV = "ACCL_MONITOR_PORT"
TRACE_STREAM_ENV = "ACCL_TRACE_STREAM"
POSTMORTEM_DIR_ENV = "ACCL_POSTMORTEM_DIR"
POSTMORTEM_WAIT_ENV = "ACCL_POSTMORTEM_WAIT_S"
DEFAULT_POSTMORTEM_WAIT_S = 2.0
#: bundle.json layout version (bumped when the artifact shape changes)
BUNDLE_SCHEMA = 1

DEFAULT_SKEW_INTERVAL = 8
DEFAULT_STRAGGLER_FACTOR = 4.0
DEFAULT_STRAGGLER_MIN_US = 200.0
DEFAULT_STRAGGLER_WINDOWS = 2
DEFAULT_ANOMALY_FACTOR = 4.0
ANOMALY_WARMUP = 16
ANOMALY_ALPHA = 0.1
EWMA_ALPHA = 0.5

SCALE_GROW_ENV = "ACCL_SCALE_GROW_P99_US"
SCALE_SHRINK_ENV = "ACCL_SCALE_SHRINK_P99_US"
DEFAULT_SCALE_GROW_P99_US = 50_000.0
DEFAULT_SCALE_SHRINK_P99_US = 1_000.0
#: completed calls a tenant needs before its tail counts (a two-sample
#: histogram's p99 is noise, not pressure)
SCALE_MIN_SAMPLES = 32

#: skew windows / judged markers retained per communicator (a peer far
#: ahead/behind must still find its comparison point — the contract
#: plane's _WINDOW_CAP discipline)
_WINDOW_CAP = 128
_ALERT_CAP = 64
_VERDICT_CAP = 32

#: collectives whose wait durations feed the skew tracker: the contract
#: ops — every rank participates, so cross-rank wait comparison is
#: meaningful (p2p/local ops are rank-asymmetric by design)
SKEW_OPS = frozenset((
    "bcast", "scatter", "gather", "allgather", "reduce", "allreduce",
    "reduce_scatter", "alltoall", "barrier",
))


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(floor, int(os.environ.get(name, default)))
    except ValueError:
        return default


def env_port(environ=None) -> Optional[int]:
    """The ``ACCL_MONITOR_PORT`` opt-in (read at handle construction);
    None = not set.  0 means "bind an ephemeral port"."""
    raw = (environ or os.environ).get(MONITOR_PORT_ENV)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def env_postmortem_dir(environ=None) -> Optional[str]:
    """The ``ACCL_POSTMORTEM_DIR`` opt-in (read at handle
    construction); None/empty = postmortem bundles disabled (the
    always-on cost of the plane is then exactly one None check per
    structured failure)."""
    raw = (environ or os.environ).get(POSTMORTEM_DIR_ENV)
    return raw or None


def _env_wait_s() -> float:
    return max(0.0, _env_float(
        POSTMORTEM_WAIT_ENV, DEFAULT_POSTMORTEM_WAIT_S
    ))


# ---------------------------------------------------------------------------
# postmortem bundles (the flight-data-recorder plane)
# ---------------------------------------------------------------------------


class BlackBox:
    """Automatic postmortem bundles for structured failures.

    On any covered failure path (facade ``ACCLError`` with
    CONTRACT_VIOLATION / RANK_EVICTED / DEADLOCK_SUSPECTED, the
    command-ring failure latch, a membership cutover) the facade calls
    :meth:`capture`: the local evidence (flight-recorder tail +
    telemetry snapshot — which carries ring/mailbox state, the
    membership event ring, skew baselines and contract window digests)
    is snapshotted, reachable peers are solicited for THEIR evidence —
    in process over the anchored registry (the contract-board
    discipline), across processes via a POSTMORTEM wire frame — and
    everything merges into one crash-safe, atomically-written
    ``bundle.json`` whose path rides ``ACCLError.details["postmortem"]``.

    Bounded + best-effort by construction: peer solicitation waits at
    most ``ACCL_POSTMORTEM_WAIT_S`` (default 2 s); dead/partitioned
    peers are documented as ``absent`` in the bundle, never waited out.
    One bundle per failure: captures are latched per failure key
    (counter-asserted), and the latch clears with ``soft_reset`` like
    every other recovery surface.  Disabled (one None check per
    failure) unless ``ACCL_POSTMORTEM_DIR`` is set."""

    def __init__(self, rank: int, world: int,
                 evidence_fn: Callable[[], dict],
                 directory: Optional[str] = None,
                 wait_s: Optional[float] = None,
                 peers_fn: Optional[Callable[[], Dict[int, Any]]] = None,
                 solicit_fn: Optional[Callable[[int], int]] = None,
                 metrics=None):
        self.rank = int(rank)
        self.world = int(world)
        self.directory = (
            directory if directory is not None else env_postmortem_dir()
        )
        self.enabled = bool(self.directory)
        self.wait_s = wait_s if wait_s is not None else _env_wait_s()
        self._evidence_fn = evidence_fn
        # in-process solicitation: {session: evidence_fn} (the anchored
        # registry every rank handle of the process registers into)
        self._peers_fn = peers_fn
        # wire solicitation: sends POSTMORTEM request frames, returns
        # how many peers were asked (replies land via deliver_reply)
        self._solicit_fn = solicit_fn
        self._metrics = metrics
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._latched: Dict[tuple, Optional[str]] = {}
        self._replies: Dict[int, Dict[int, dict]] = {}
        self._token = 0
        self._seq = 0  # bundle-name allocator (monotone, never reused)
        self.bundles_written = 0
        self.solicit_timeouts = 0
        self.last_bundle: Optional[str] = None

    # -- wire reply intake (fabric delivery thread) --------------------------
    def deliver_reply(self, token: int, rank: int, evidence: dict) -> None:
        with self._cv:
            bucket = self._replies.get(int(token))
            if bucket is None:
                return  # late reply after the bounded deadline: dropped
            bucket[int(rank)] = evidence
            self._cv.notify_all()

    def _solicit(self) -> tuple:
        """(peer evidence {session: dict}, absent sessions).  Board
        peers answer synchronously; wire peers get the bounded wait."""
        collected: Dict[int, dict] = {}
        asked: set = set()
        if self._peers_fn is not None:
            try:
                registry = dict(self._peers_fn() or {})
            except Exception:
                registry = {}
            for session, fn in sorted(registry.items()):
                if session == self.rank:
                    continue
                asked.add(session)
                try:
                    collected[session] = fn()
                except Exception as e:  # a wedged peer must not wedge us
                    collected[session] = {
                        "error": f"{type(e).__name__}: {e}"[:200]
                    }
        if self._solicit_fn is not None:
            with self._cv:
                self._token += 1
                token = self._token
                self._replies[token] = {}
            try:
                n_asked = int(self._solicit_fn(token) or 0)
            except Exception:
                n_asked = 0
            if n_asked:
                deadline = time.monotonic() + self.wait_s
                with self._cv:
                    while len(self._replies[token]) < n_asked:
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            self.solicit_timeouts += 1
                            break
                        self._cv.wait(rem)
                    for r, ev in self._replies[token].items():
                        collected[r] = ev
                        asked.add(r)
            with self._cv:
                self._replies.pop(token, None)
        absent = sorted(
            s for s in range(self.world)
            if s != self.rank and s not in collected
        )
        return collected, absent

    # -- the capture path ----------------------------------------------------
    def capture(self, code: str, context: str = "",
                details: Optional[dict] = None,
                key: Optional[tuple] = None) -> Optional[str]:
        """Write one bundle for this failure (or return the already-
        written one when the failure key is latched).  Never raises —
        a postmortem failure must not mask the failure it documents."""
        if not self.enabled:
            return None
        key = key if key is not None else (str(code),)
        with self._lock:
            if key in self._latched:
                return self._latched[key]
            self._latched[key] = None  # claim: concurrent paths collapse
            # the bundle name is allocated HERE, atomically with the
            # claim: two concurrent captures (distinct keys, same code)
            # must never derive the same directory and clobber each
            # other's bundle.json
            seq = self._seq
            self._seq += 1
        path = None
        try:
            path = self._write_bundle(code, context, details, seq)
        except Exception:  # pragma: no cover - defensive
            import traceback

            traceback.print_exc()
        with self._lock:
            self._latched[key] = path
            if path is not None:
                self.bundles_written += 1
                self.last_bundle = path
        if path is not None and self._metrics is not None:
            try:
                self._metrics.inc("accl_postmortem_bundles_total")
            except Exception:  # pragma: no cover - defensive
                pass
        return path

    def _write_bundle(self, code: str, context: str,
                      details: Optional[dict], seq: int) -> str:
        try:
            local = self._evidence_fn()
        except Exception as e:  # evidence half-missing beats no bundle
            local = {"error": f"{type(e).__name__}: {e}"[:200]}
        peers, absent = self._solicit()
        ranks = {str(self.rank): local}
        for r, ev in sorted(peers.items()):
            ranks[str(r)] = ev
        bundle = {
            "bundle_schema": BUNDLE_SCHEMA,
            "code": str(code),
            "context": str(context),
            "rank": self.rank,
            "world": self.world,
            # wall timestamp on purpose (cross-process artifact naming/
            # correlation needs the shared clock, same as Message.
            # sent_ns) — never used as a duration
            "created_ns": time.time_ns(),
            "ranks": ranks,
            "reachable": sorted(int(r) for r in ranks),
            "absent": absent,
        }
        if details:
            bundle["details"] = _jsonable(details)
        os.makedirs(self.directory, exist_ok=True)
        name = (
            f"accl_postmortem_{str(code).lower()}_rank{self.rank}_{seq:03d}"
        )
        bdir = os.path.join(self.directory, name)
        os.makedirs(bdir, exist_ok=True)
        path = os.path.join(bdir, "bundle.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=str)
        os.replace(tmp, path)  # crash-safe: the artifact is atomic
        return path

    def reset(self) -> None:
        """soft_reset recovery: clear the per-failure latches (a fresh
        regime's failures deserve fresh bundles); written-bundle
        accounting is lifetime and survives."""
        with self._lock:
            self._latched.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "dir": self.directory,
                "wait_s": self.wait_s,
                "bundles_written": self.bundles_written,
                "solicit_timeouts": self.solicit_timeouts,
                "last_bundle": self.last_bundle,
                "latched": len(self._latched),
            }


def _jsonable(obj):
    """Best-effort JSON-safe copy (ACCLError.details may carry enums /
    numpy scalars; the bundle must always serialize)."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return json.loads(json.dumps(obj, default=str))


def load_bundle(path: str) -> dict:
    """Load + structurally validate one ``bundle.json`` (the test/CI
    surface): raises ValueError on a malformed bundle."""
    with open(path) as f:
        doc = json.load(f)
    for k in ("bundle_schema", "code", "rank", "world", "ranks",
              "reachable", "absent"):
        if k not in doc:
            raise ValueError(f"postmortem bundle missing {k!r}: {path}")
    if not isinstance(doc["ranks"], dict) or not doc["ranks"]:
        raise ValueError(f"postmortem bundle has no rank evidence: {path}")
    return doc


# ---------------------------------------------------------------------------
# cross-rank straggler analysis
# ---------------------------------------------------------------------------


def judge_for(anchor, world: int) -> Optional["SkewJudge"]:
    """The :class:`SkewJudge` shared by every rank handle anchored on
    ``anchor`` — the same anchor discipline as the contract plane's
    ``board_for`` (InProc fabric / XLA gang context); None on
    one-process-per-rank tiers, where each tracker judges locally from
    wire-piggybacked claims instead."""
    return anchored(anchor, "_accl_skew_judge", lambda: SkewJudge(world))


class SkewJudge:
    """Folds per-(comm, window) posts from the ranks into per-rank EWMA
    baselines and standing ``slow_rank`` verdicts.

    One instance is SHARED by every in-process rank handle (board mode,
    via :func:`judge_for`) or PRIVATE per tracker (wire mode) — the
    math is identical either way, which is what makes the seeded-fault
    conviction deterministic: same posts, same verdict.

    Two post streams per window:

    * **wait means** (:meth:`post_wait`) — each rank's mean collective
      wait; folded into relative-wait EWMA baselines (``max - own``,
      how much *less* a rank waited than the slowest-waiting rank).
      Reported, never convicting: synchronizing collectives equalize
      waits and eager fire-and-forget biases roots short.
    * **arrival latency** (:meth:`post_latency`) — each rank's window
      vector of per-SOURCE wire latencies.  When every member's vector
      arrived, source ``p``'s aggregate is the MEDIAN of its receivers'
      observations (one weird receiver cannot frame a peer); a source
      whose aggregate clears the absolute floor AND the dominance
      factor over the runner-up for ``persist`` consecutive windows is
      convicted ``slow_rank``.
    """

    def __init__(self, world: int, factor: Optional[float] = None,
                 min_us: Optional[float] = None,
                 persist: Optional[int] = None):
        self.world = int(world)
        self.factor = (
            factor if factor is not None
            else _env_float("ACCL_STRAGGLER_FACTOR", DEFAULT_STRAGGLER_FACTOR)
        )
        self.min_us = (
            min_us if min_us is not None
            else _env_float("ACCL_STRAGGLER_MIN_US", DEFAULT_STRAGGLER_MIN_US)
        )
        self.persist = (
            persist if persist is not None
            else _env_int("ACCL_STRAGGLER_WINDOWS", DEFAULT_STRAGGLER_WINDOWS)
        )
        self._lock = threading.Lock()
        # (comm, window) -> {rank: mean_wait_us}
        self._wait_posts: Dict[Tuple[int, int], Dict[int, float]] = {}
        # (comm, window) -> {observer: {src: mean_latency_us}}
        self._lat_posts: Dict[Tuple[int, int], Dict[int, dict]] = {}
        self._wait_judged: Dict[int, int] = {}  # comm -> highest window
        self._lat_judged: Dict[int, int] = {}
        self._wait_ewma: Dict[int, Dict[int, float]] = {}
        self._lat_ewma: Dict[int, Dict[int, float]] = {}
        self._streak: Dict[Tuple[int, int], int] = {}
        self._slow: Dict[int, dict] = {}  # comm -> standing verdict
        self.verdicts: List[dict] = []
        self.windows_judged = 0

    @staticmethod
    def _gc(posts: Dict[Tuple[int, int], dict], comm_id: int,
            window: int) -> None:
        floor = window - _WINDOW_CAP
        for k in [k for k in posts if k[0] == comm_id and k[1] < floor]:
            del posts[k]

    def post_wait(self, comm_id: int, window: int, rank: int,
                  mean_us: float, world: Optional[int] = None) -> None:
        """One rank's completed-window mean wait; folds the window into
        the relative-wait EWMA baselines once every member (``world`` =
        the communicator's member count) posted."""
        need = int(world) if world else self.world
        with self._lock:
            if window <= self._wait_judged.get(comm_id, -1):
                return
            key = (comm_id, window)
            posts = self._wait_posts.setdefault(key, {})
            posts[rank] = float(mean_us)
            self._gc(self._wait_posts, comm_id, window)
            if len(posts) < need:
                return
            del self._wait_posts[key]
            self._wait_judged[comm_id] = max(
                self._wait_judged.get(comm_id, -1), window
            )
            mmax = max(posts.values())
            ew = self._wait_ewma.setdefault(comm_id, {})
            for r, m in sorted(posts.items()):
                lag = mmax - m
                prev = ew.get(r)
                ew[r] = round(
                    lag if prev is None
                    else EWMA_ALPHA * lag + (1.0 - EWMA_ALPHA) * prev,
                    3,
                )

    def post_latency(self, comm_id: int, window: int, observer: int,
                     latencies_us: Dict[int, float],
                     world: Optional[int] = None) -> Optional[dict]:
        """One rank's completed-window per-source latency vector; judges
        the window once every member's vector arrived.  Returns the
        (new or standing) verdict for the communicator."""
        need = int(world) if world else self.world
        with self._lock:
            if window <= self._lat_judged.get(comm_id, -1):
                return self._slow.get(comm_id)
            key = (comm_id, window)
            posts = self._lat_posts.setdefault(key, {})
            posts[int(observer)] = {
                int(p): float(v) for p, v in latencies_us.items()
            }
            self._gc(self._lat_posts, comm_id, window)
            if len(posts) < need:
                return self._slow.get(comm_id)
            del self._lat_posts[key]
            self._lat_judged[comm_id] = max(
                self._lat_judged.get(comm_id, -1), window
            )
            self.windows_judged += 1
            return self._judge(comm_id, window, posts)

    def _judge(self, comm_id: int, window: int,
               posts: Dict[int, dict]) -> Optional[dict]:
        """Judge one complete latency window (judge lock held).  Pure
        math over the posts — same posts, same verdict, on every rank."""
        sources: Dict[int, List[float]] = {}
        for observer, vec in posts.items():
            for src, lat in vec.items():
                if src != observer:
                    sources.setdefault(src, []).append(lat)
        if not sources:
            return self._slow.get(comm_id)
        agg = {p: statistics.median(obs) for p, obs in sources.items()}
        ew = self._lat_ewma.setdefault(comm_id, {})
        for p, lat in sorted(agg.items()):
            prev = ew.get(p)
            ew[p] = round(
                lat if prev is None
                else EWMA_ALPHA * lat + (1.0 - EWMA_ALPHA) * prev,
                3,
            )
        if len(agg) < 2:
            # conviction needs a genuine runner-up to dominate: with a
            # single observed source (a 2-rank wire-mode group) the
            # dominance test is vacuous and any fabric whose baseline
            # latency clears the floor — localhost TCP sits at
            # 300-900 us — would convict an innocent peer.  Mirrors
            # the contract plane's "majority needs world >= 3": 2-rank
            # wire groups get EWMA baselines, not verdicts (board
            # tiers aggregate BOTH observers, so world 2 still
            # convicts there).
            return self._slow.get(comm_id)
        ranked = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
        cand, lead = ranked[0]
        runner_up = ranked[1][1]
        beyond = (
            lead >= self.min_us
            and lead >= self.factor * (runner_up + 1.0)
        )
        # "persist CONSECUTIVE windows": every tracked streak on this
        # comm resets except the dominant candidate's — including ranks
        # ABSENT from this window's observations (a source that goes
        # quiet for a window has broken its streak, or two
        # non-consecutive dominant windows would sum to a conviction)
        prev = self._streak.get((comm_id, cand), 0)
        for k in [k for k in self._streak if k[0] == comm_id]:
            self._streak[k] = 0
        if not beyond:
            return self._slow.get(comm_id)
        streak = prev + 1
        self._streak[(comm_id, cand)] = streak
        if streak < self.persist:
            return self._slow.get(comm_id)
        verdict = {
            "kind": "slow_rank",
            "comm": comm_id,
            "rank": cand,
            "window": window,
            "latency_us": round(lead, 1),
            "ewma_latency_us": ew[cand],
            "streak": streak,
            "observed_us": {
                str(p): round(v, 1) for p, v in sorted(agg.items())
            },
            "basis": "majority" if len(posts) > 1 else "pairwise",
        }
        if self._slow.get(comm_id) is None or (
            self._slow[comm_id].get("rank") != cand
        ):
            if len(self.verdicts) < _VERDICT_CAP:
                self.verdicts.append(verdict)
        self._slow[comm_id] = verdict
        return verdict

    def slow_ranks(self, comm_id: int) -> List[int]:
        """Comm-relative ranks under a standing slow_rank verdict — the
        health-map ``suspect_slow`` annotation source."""
        with self._lock:
            v = self._slow.get(comm_id)
            return [v["rank"]] if v is not None else []

    def recovered(self, comm_id: int, rank: int) -> bool:
        """Has ``rank``'s arrival skew recovered?  True when its
        current EWMA latency no longer clears the conviction bar
        (below the absolute floor, or below ``factor`` × the slowest
        other rank) — the membership plane's half-open circuit-breaker
        probe: a demoted rank is re-admitted when this turns true and
        no standing verdict renews."""
        with self._lock:
            ew = self._lat_ewma.get(comm_id) or {}
            lat = ew.get(rank)
            if lat is None:
                return True  # no recent observations: nothing to hold
            if lat < self.min_us:
                return True
            others = [v for r, v in ew.items() if r != rank]
            if not others:
                return True
            return lat < self.factor * (max(others) + 1.0)

    def clear_slow(self, comm_id: int, rank: Optional[int] = None) -> bool:
        """Drop the standing slow_rank verdict (optionally only when it
        names ``rank``) and its streaks — the demotion-restore path:
        re-admission must also lift the health map's ``suspect_slow``
        annotation, or the operator keeps paging on a healed rank."""
        with self._lock:
            v = self._slow.get(comm_id)
            if v is None or (rank is not None and v.get("rank") != rank):
                return False
            del self._slow[comm_id]
            for k in [k for k in self._streak if k[0] == comm_id]:
                self._streak[k] = 0
            return True

    def reset(self) -> None:
        """soft_reset recovery: drop posts, baselines, streaks and
        standing verdicts (the collective recovery point, like the
        contract board's clear)."""
        with self._lock:
            self._wait_posts.clear()
            self._lat_posts.clear()
            self._wait_judged.clear()
            self._lat_judged.clear()
            self._wait_ewma.clear()
            self._lat_ewma.clear()
            self._streak.clear()
            self._slow.clear()
            # the verdict history is about the PRE-reset regime too: a
            # recovered group starts with a clean bill (windows_judged
            # keeps counting — it is lifetime accounting, not state)
            self.verdicts.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "world": self.world,
                "factor": self.factor,
                "min_us": self.min_us,
                "persist_windows": self.persist,
                "windows_judged": self.windows_judged,
                "ewma_wait_lag_us": {
                    str(c): {str(r): v for r, v in sorted(ranks.items())}
                    for c, ranks in sorted(self._wait_ewma.items())
                },
                "ewma_latency_us": {
                    str(c): {str(r): v for r, v in sorted(ranks.items())}
                    for c, ranks in sorted(self._lat_ewma.items())
                },
                "verdicts": [dict(v) for v in self.verdicts],
                "standing": {
                    str(c): dict(v) for c, v in sorted(self._slow.items())
                },
            }


class SkewTracker:
    """One rank handle's end of the straggler exchange.

    Fed from the telemetry plane's completion observer (every tier's
    ``Request.complete`` runs through it); accumulates per-communicator
    wait durations, and at every ``interval``-call window boundary posts
    the window mean to the judge — shared in-process, or local with
    peers' posts arriving as wire-piggybacked claims
    (:meth:`observe_claim`, the contract plane's stamp cadence reused).
    """

    def __init__(self, rank: int, world: int,
                 interval: Optional[int] = None,
                 judge: Optional[SkewJudge] = None):
        self.rank = int(rank)
        self.world = int(world)
        self.interval = (
            interval if interval is not None
            else _env_int("ACCL_SKEW_INTERVAL", DEFAULT_SKEW_INTERVAL)
        )
        self.shared_judge = judge is not None
        self.judge = judge if judge is not None else SkewJudge(world)
        self._lock = threading.Lock()
        # comm -> [count, sum_ns, comm_world, comm_rank]
        self._acc: Dict[int, list] = {}
        # (comm, src) -> [count, sum_latency_ns]: per-source arrival
        # latency observed at delivery, drained at window boundaries
        self._lat: Dict[Tuple[int, int], list] = {}
        # comm -> (window, mean_us): the latest completed window — the
        # wire piggyback stamp (two header fields, zero extra traffic)
        self._stamp: Dict[int, Tuple[int, float]] = {}
        self.samples = 0
        self.latency_samples = 0
        self.windows_posted = 0

    def observe(self, comm_id: int, duration_ns: int,
                comm_rank: Optional[int] = None,
                comm_world: Optional[int] = None) -> None:
        """One completed collective's wait duration (telemetry observer
        fast lane: a dict update under one short lock; the window posts
        happen outside it)."""
        wait_post = None
        lat_post = None
        with self._lock:
            acc = self._acc.get(comm_id)
            if acc is None:
                acc = self._acc[comm_id] = [
                    0, 0,
                    int(comm_world) if comm_world else self.world,
                    int(comm_rank) if comm_rank is not None else self.rank,
                ]
            acc[0] += 1
            acc[1] += int(duration_ns)
            self.samples += 1
            if acc[0] % self.interval == 0:
                window = acc[0] // self.interval - 1
                mean_us = acc[1] / self.interval / 1e3
                acc[1] = 0
                self._stamp[comm_id] = (window, mean_us)
                self.windows_posted += 1
                wait_post = (comm_id, window, acc[3], mean_us, acc[2])
                # drain this comm's per-source latency window alongside
                vec = {}
                for (cid, src), cell in list(self._lat.items()):
                    if cid != comm_id or not cell[0]:
                        continue
                    vec[src] = cell[1] / cell[0] / 1e3
                    cell[0] = cell[1] = 0
                lat_post = (comm_id, window, acc[3], vec, acc[2])
        # judge OUTSIDE the tracker lock (the judge takes its own; no
        # cross-family hold for the lock-order registry to flag)
        if wait_post is not None:
            cid, window, r, mean_us, w = wait_post
            self.judge.post_wait(cid, window, r, mean_us, world=w)
        if lat_post is not None:
            cid, window, r, vec, w = lat_post
            # wire mode judges from this rank's OWN observations only
            # (pairwise basis — the board aggregates all receivers)
            self.judge.post_latency(
                cid, window, r, vec,
                world=w if self.shared_judge else 1,
            )

    def on_message(self, comm_id: int, src: int,
                   latency_ns: Optional[int]) -> None:
        """One delivered message's arrival latency (fabric delivery
        thread; ``latency_ns`` None when the sender did not stamp —
        monitor off on that rank)."""
        if latency_ns is None:
            return
        with self._lock:
            cell = self._lat.get((comm_id, src))
            if cell is None:
                cell = self._lat[(comm_id, src)] = [0, 0]
            cell[0] += 1
            cell[1] += max(0, int(latency_ns))
            self.latency_samples += 1

    def begin_comm(self, comm_id: int, comm_rank: int,
                   comm_world: int) -> None:
        """Register a communicator's membership up front (the facade
        calls this at handle construction and on create_communicator),
        so piggybacked claims arriving BEFORE this rank's first
        completion on the comm resolve against the real comm-relative
        identity and member count instead of the world fallbacks."""
        with self._lock:
            acc = self._acc.get(comm_id)
            if acc is None:
                self._acc[comm_id] = [0, 0, int(comm_world), int(comm_rank)]
            else:
                acc[2], acc[3] = int(comm_world), int(comm_rank)

    # -- wire piggyback (the contract stamp cadence, reused) -----------------
    def stamp(self, comm_id: int) -> Tuple[int, float]:
        """(window, mean_wait_us) of the latest completed skew window —
        stamped onto outgoing wire messages.  window -1 = nothing
        completed yet (receivers skip).  Lock-free read on the per-send
        hot path: ``_stamp`` values are immutable tuples replaced under
        the tracker lock, so a racing reader sees the old or the new
        stamp — both valid — without paying a lock per wire message."""
        s = self._stamp.get(comm_id)
        return s if s is not None else (-1, 0.0)

    def observe_claim(self, comm_id: int, src_rank: int, window: int,
                      mean_us: float) -> None:
        """A peer's piggybacked wait-window claim (fabric delivery
        thread).  ``src_rank`` is COMM-relative (the wire message's src
        field).  Feeds the relative-wait baselines; the latency signal
        needs no claim — each receiver observes it directly."""
        if window < 0:
            return
        with self._lock:
            acc = self._acc.get(comm_id)
            world = acc[2] if acc is not None else self.world
            me = acc[3] if acc is not None else self.rank
        if src_rank == me:
            return
        self.judge.post_wait(comm_id, window, src_rank, mean_us, world=world)

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()
            self._lat.clear()
            self._stamp.clear()
        if not self.shared_judge:
            self.judge.reset()

    def snapshot(self) -> dict:
        with self._lock:
            samples = self.samples
            lat_samples = self.latency_samples
            windows = self.windows_posted
        doc = self.judge.snapshot()
        doc.update({
            "enabled": True,
            "interval": self.interval,
            "samples": samples,
            "latency_samples": lat_samples,
            "windows_posted": windows,
            "exchange": "board" if self.shared_judge else "wire",
        })
        return doc


# ---------------------------------------------------------------------------
# anomaly watchdog
# ---------------------------------------------------------------------------


class AnomalyWatchdog:
    """Rolling EWMA latency baselines per (op × size bucket); a call
    past ``factor`` × its baseline emits one bounded alert record into
    the snapshot.  The baseline keeps absorbing every sample (alpha
    ``ANOMALY_ALPHA``), so a persistent regime shift becomes the new
    normal instead of alerting forever."""

    def __init__(self, factor: Optional[float] = None,
                 warmup: int = ANOMALY_WARMUP):
        self.factor = (
            factor if factor is not None
            else _env_float("ACCL_ANOMALY_FACTOR", DEFAULT_ANOMALY_FACTOR)
        )
        self.warmup = int(warmup)
        self._lock = threading.Lock()
        self._base: Dict[Tuple[str, int], list] = {}  # key -> [n, ewma_us]
        self.alerts: List[dict] = []
        self.alerts_total = 0

    def observe(self, op: str, bucket: int, duration_ns: int) -> Optional[dict]:
        d_us = duration_ns / 1e3
        with self._lock:
            key = (op, bucket)
            b = self._base.get(key)
            if b is None:
                self._base[key] = [1, d_us]
                return None
            n, ewma = b
            alert = None
            if n >= self.warmup and d_us > self.factor * max(ewma, 1e-9):
                self.alerts_total += 1
                alert = {
                    "op": op,
                    "size_bucket": bucket,
                    "duration_us": round(d_us, 1),
                    "baseline_us": round(ewma, 1),
                    "factor": round(d_us / max(ewma, 1e-9), 1),
                    "sample": n,
                }
                if len(self.alerts) >= _ALERT_CAP:
                    self.alerts.pop(0)
                self.alerts.append(alert)
            b[0] = n + 1
            b[1] = ewma + ANOMALY_ALPHA * (d_us - ewma)
            return alert

    def reset(self) -> None:
        with self._lock:
            self._base.clear()
            self.alerts.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "factor": self.factor,
                "warmup": self.warmup,
                "alerts_total": self.alerts_total,
                "alerts": [dict(a) for a in self.alerts],
                "baselines": {
                    f"{op}/b{b}": {"samples": n, "ewma_us": round(e, 1)}
                    for (op, b), (n, e) in sorted(self._base.items())
                },
            }


# ---------------------------------------------------------------------------
# traffic-aware scale advice
# ---------------------------------------------------------------------------


class ScaleAdvisor:
    """Advisory grow/shrink recommendations from the QoS arbiter's
    per-tenant latency histograms.

    A pure, deterministic function of the arbiter snapshot — no clocks,
    no randomness, no internal traffic state — so the same tenant
    pressure always yields the same advice (the chaos soaks assert
    this).  The verdict NEVER acts (the ``suspect_slow`` annotation
    discipline): it is surfaced through ``telemetry_snapshot()
    ["membership"]["scale_advice"]`` and the ``/membership`` route, and
    the operator decides whether to call ``join_rank``/``evict_rank``.

    Rules, in precedence order:

    * **grow** — any tenant with ≥ :data:`SCALE_MIN_SAMPLES` completed
      calls whose p99 exceeds the high-water mark, or whose queue
      backlog exceeds its own outstanding-window limit (grant starvation
      is tail pressure even before the histogram shows it).
    * **shrink** — every sampled tenant rides below the low-water p99
      with empty queues, and at least one tenant has samples (an idle
      fabric is not evidence).
    * **hold** — anything else, including no data at all.
    """

    def __init__(
        self,
        grow_p99_us: Optional[float] = None,
        shrink_p99_us: Optional[float] = None,
    ):
        self.grow_p99_us = float(
            grow_p99_us
            if grow_p99_us is not None
            else os.environ.get(SCALE_GROW_ENV, DEFAULT_SCALE_GROW_P99_US)
        )
        self.shrink_p99_us = float(
            shrink_p99_us
            if shrink_p99_us is not None
            else os.environ.get(
                SCALE_SHRINK_ENV, DEFAULT_SCALE_SHRINK_P99_US
            )
        )
        self.advisories = 0
        self._last: Optional[dict] = None
        self._lock = threading.Lock()

    def advise(self, arbiter_snapshot: Optional[dict], world: int) -> dict:
        """One advisory pass over ``QosArbiter.snapshot()`` output.
        Tolerates a disarmed/absent arbiter (→ hold, reason given)."""
        tenants = (arbiter_snapshot or {}).get("tenants") or {}
        hot: List[dict] = []
        sampled = 0
        idle = True
        for cid in sorted(tenants, key=str):
            t = tenants[cid] or {}
            lat = t.get("latency") or {}
            p99 = lat.get("p99_us")
            samples = int(lat.get("count") or 0)
            queued = int(t.get("queued") or 0)
            limit = int(t.get("outstanding_limit") or 0)
            backlogged = limit > 0 and queued > limit
            if samples >= SCALE_MIN_SAMPLES:
                sampled += 1
                if p99 is not None and p99 > self.grow_p99_us:
                    hot.append({
                        "tenant": str(cid),
                        "class": t.get("class"),
                        "p99_us": p99,
                        "reason": "p99_over_high_water",
                    })
                    idle = False
                elif p99 is not None and p99 > self.shrink_p99_us:
                    idle = False
            if backlogged:
                hot.append({
                    "tenant": str(cid),
                    "class": t.get("class"),
                    "queued": queued,
                    "outstanding_limit": limit,
                    "reason": "queue_backlog",
                })
                idle = False
        if hot:
            rec, why = "grow", "tail_pressure"
        elif sampled and idle:
            rec, why = "shrink", "idle_tail"
        else:
            rec, why = "hold", (
                "insufficient_data" if not sampled else "within_band"
            )
        advice = {
            "recommendation": rec,
            "reason": why,
            "world": int(world),
            "hot_tenants": hot,
            "tenants_sampled": sampled,
            "grow_p99_us": self.grow_p99_us,
            "shrink_p99_us": self.shrink_p99_us,
            "advisory_only": True,
        }
        with self._lock:
            self.advisories += 1
            self._last = advice
        return advice

    def last(self) -> Optional[dict]:
        with self._lock:
            return dict(self._last) if self._last is not None else None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "advisories": self.advisories,
                "last": dict(self._last) if self._last else None,
            }


# ---------------------------------------------------------------------------
# the scrape service
# ---------------------------------------------------------------------------


class MonitorServer:
    """The live scrape endpoint: a stdlib HTTP server on an
    ``accl-monitor`` thread serving the routes the facade registers
    (``/metrics`` Prometheus, ``/snapshot`` JSON, ``/trace`` Chrome
    trace; ``/`` lists them).  Render functions run on the request
    thread — they must be the cheap, side-effect-free snapshot surface
    the telemetry plane already guarantees.  A route given as ``(fn,
    content_type, True)`` is called with the request's query, parsed by
    ``urllib.parse.parse_qs`` (``utils.profiling.start_server``'s
    ``/capture?ms=N``)."""

    def __init__(self, routes: Dict[str, tuple],
                 port: int = 0, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs

        self.routes = dict(routes)
        self.scrapes: Dict[str, int] = {p: 0 for p in self.routes}
        self.errors = 0
        self._count_lock = threading.Lock()
        self._requests: List[threading.Thread] = []
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib handler contract
                path, _, query = self.path.partition("?")
                if path == "/" and "/" not in outer.routes:
                    body = "\n".join(sorted(outer.routes)) + "\n"
                    self._reply(200, body, "text/plain; charset=utf-8")
                    return
                route = outer.routes.get(path)
                if route is None:
                    self._reply(404, f"no such route {path}\n", "text/plain")
                    return
                fn, ctype = route[:2]
                try:
                    body = (fn(parse_qs(query)) if route[2:] == (True,)
                            else fn())
                except Exception as e:  # a render failure must not kill
                    with outer._count_lock:  # the server
                        outer.errors += 1
                    self._reply(500, f"{type(e).__name__}: {e}\n",
                                "text/plain")
                    return
                with outer._count_lock:
                    outer.scrapes[path] = outer.scrapes.get(path, 0) + 1
                self._reply(200, body, ctype)

            def _reply(self, code: int, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # quiet: scrapes poll
                pass

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

            def process_request(self, request, client_address):
                # named so the conftest excepthook guard (accl-* prefix)
                # covers request threads like every other project thread
                t = threading.Thread(
                    target=self.process_request_thread,
                    args=(request, client_address),
                    name="accl-monitor-req", daemon=True,
                )
                with outer._count_lock:  # kept for stop()'s join
                    outer._requests = [r for r in outer._requests
                                       if r.is_alive()] + [t]
                t.start()

        self._server = _Server((host, int(port)), _Handler)
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"accl-monitor-{self.port}", daemon=True,
        )

    def start(self) -> "MonitorServer":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> bool:
        """Shut the service down; True when the serve thread and every
        request thread (one may still be closing its connection after
        its reply) joined within ``timeout`` (bounded — a wedged handler
        must not wedge deinit)."""
        deadline = time.monotonic() + timeout
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=timeout)
        with self._count_lock:
            requests = list(self._requests)
        for t in requests:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return not (self._thread.is_alive()
                    or any(t.is_alive() for t in requests))

    @property
    def serving(self) -> bool:
        return self._thread.is_alive()

    def snapshot(self) -> dict:
        with self._count_lock:
            return {
                "host": self.host,
                "port": self.port,
                "serving": self.serving,
                "scrapes": dict(self.scrapes),
                "errors": self.errors,
            }


# ---------------------------------------------------------------------------
# streaming trace export
# ---------------------------------------------------------------------------


class TraceStreamWriter:
    """Bounded rolling-file Chrome-trace streamer.

    ``pull_fn()`` returns the chrome events completed since the last
    pull (the flight recorder's since-cursor); a flusher thread drains
    it every ``interval_s`` and rewrites the CURRENT segment file as a
    complete JSON document via an atomic replace — so at every instant,
    every file on disk is independently Perfetto-loadable, and a crash
    loses at most one flush interval.  Files roll at ``max_events``
    events and the oldest beyond ``max_files`` are pruned.
    """

    def __init__(self, directory: str, rank: int,
                 pull_fn: Callable[[], List[dict]],
                 interval_s: Optional[float] = None,
                 max_events: Optional[int] = None,
                 max_files: Optional[int] = None):
        self.directory = os.fspath(directory)
        self.rank = int(rank)
        self._pull = pull_fn
        self.interval_s = (
            interval_s if interval_s is not None
            else _env_float("ACCL_TRACE_STREAM_INTERVAL_S", 0.5)
        )
        self.max_events = (
            max_events if max_events is not None
            else _env_int("ACCL_TRACE_STREAM_EVENTS", 4096)
        )
        self.max_files = (
            max_files if max_files is not None
            else _env_int("ACCL_TRACE_STREAM_FILES", 8)
        )
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._seq = 0
        self._files: List[str] = []
        self.events_streamed = 0
        self.flushes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"accl-trace-stream-{rank}", daemon=True,
        )
        self._thread.start()

    def _path(self, seq: int) -> str:
        return os.path.join(
            self.directory, f"accl_trace_rank{self.rank}_{seq:04d}.json"
        )

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            try:
                self.flush()
            except Exception:  # a disk hiccup must not kill the stream
                pass
        try:
            self.flush()  # final drain on stop
        except Exception:
            pass

    def flush(self) -> None:
        """Drain new records and rewrite the current segment file (and
        roll it when full).  Callable from any thread — the pull runs
        UNDER the writer lock so concurrent flushes (interval thread +
        an explicit caller) cannot both advance the recorder cursor and
        double-append the same records."""
        with self._lock:
            fresh = self._pull() or []
            self._events.extend(fresh)
            self.events_streamed += len(fresh)
            self.flushes += 1
            while len(self._events) >= self.max_events:
                head = self._events[: self.max_events]
                self._events = self._events[self.max_events:]
                self._write(self._seq, head)
                self._seq += 1
            # the in-progress segment is ALWAYS on disk as a valid doc:
            # the crash-leaves-a-loadable-timeline contract
            self._write(self._seq, self._events)
            while len(self._files) > self.max_files:
                stale = self._files.pop(0)
                try:
                    os.remove(stale)
                except OSError:
                    pass

    def _write(self, seq: int, events: List[dict]) -> None:
        """One segment file, atomically (writer lock held)."""
        path = self._path(seq)
        tmp = path + ".tmp"
        doc = {"traceEvents": list(events), "displayTimeUnit": "ms"}
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        if path not in self._files:
            self._files.append(path)

    def stop(self, timeout: float = 5.0) -> bool:
        self._stop.set()
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": self.directory,
                "files": len(self._files),
                "current_seq": self._seq,
                "events_streamed": self.events_streamed,
                "flushes": self.flushes,
                "interval_s": self.interval_s,
                "max_events": self.max_events,
                "max_files": self.max_files,
            }


# ---------------------------------------------------------------------------
# the per-handle plane
# ---------------------------------------------------------------------------


class Monitor:
    """One rank handle's continuous-observability plane: the straggler
    tracker and anomaly watchdog are always armed (they ride the
    telemetry completion observer — a couple of dict updates per call);
    the scrape server and trace streamer are opt-in services.

    Created by the ACCL facade next to its :class:`~accl_tpu_torch.telemetry.
    Telemetry` (None under the ``ACCL_TELEMETRY=0`` kill switch — no
    records, nothing to monitor)."""

    def __init__(self, rank: int, world: int, telemetry,
                 anchor: Any = None, tier: str = ""):
        self.rank = int(rank)
        self.world = int(world)
        self.tier = tier
        self.telemetry = telemetry
        self.tracker = SkewTracker(
            rank, world, judge=judge_for(anchor, world)
        )
        self.watchdog = AnomalyWatchdog()
        self.scale = ScaleAdvisor()
        self.server: Optional[MonitorServer] = None
        self.stream: Optional[TraceStreamWriter] = None
        telemetry.add_observer(self._observe)

    # -- the telemetry completion observer -----------------------------------
    def _observe(self, meta: dict, duration_ns: int, code: int) -> None:
        op = meta.get("op") or "?"
        if code != 0:
            # failed calls carry deadline-shaped durations (the engine
            # timeout, not a wait measurement): baselines and skew must
            # not absorb them — errors are already counted as errors
            return
        comm = meta.get("comm")
        if comm is not None and op in SKEW_OPS:
            self.tracker.observe(
                comm, duration_ns,
                comm_rank=meta.get("comm_rank"),
                comm_world=meta.get("comm_world"),
            )
        self.watchdog.observe(op, meta.get("bucket") or 0, duration_ns)

    # -- services ------------------------------------------------------------
    def start_trace_stream(self, directory: str) -> TraceStreamWriter:
        """Arm the rolling-file streamer over this handle's flight
        recorder (idempotent)."""
        if self.stream is not None:
            return self.stream
        from .telemetry import record_event

        recorder = self.telemetry.recorder
        cursor = {"total": recorder.total}
        rank = self.rank

        def pull() -> List[dict]:
            recs, cursor["total"] = recorder.since(cursor["total"])
            return [record_event(r, rank) for r in recs]

        self.stream = TraceStreamWriter(directory, rank, pull)
        return self.stream

    def slow_ranks(self, comm_id: int) -> List[int]:
        return self.tracker.judge.slow_ranks(comm_id)

    def scale_advice(
        self, arbiter_snapshot: Optional[dict], world: int
    ) -> dict:
        """One :class:`ScaleAdvisor` pass (advisory only — see the
        class docstring); the result is also retained for the snapshot
        surface."""
        return self.scale.advise(arbiter_snapshot, world)

    def reset(self) -> None:
        """soft_reset recovery: clear skew accumulators, baselines and
        standing straggler verdicts (collective by contract, like the
        reset itself)."""
        self.tracker.reset()
        if self.tracker.shared_judge:
            self.tracker.judge.reset()
        self.watchdog.reset()

    def close(self) -> None:
        """Handle deinit: stop the services (bounded); the tracker and
        watchdog are passive and need no teardown."""
        if self.server is not None:
            srv, self.server = self.server, None
            srv.stop()
        if self.stream is not None:
            stream, self.stream = self.stream, None
            stream.stop()

    # -- snapshot sections ----------------------------------------------------
    def straggler_snapshot(self) -> dict:
        return self.tracker.snapshot()

    def anomaly_snapshot(self) -> dict:
        return self.watchdog.snapshot()

    def service_snapshot(self) -> dict:
        return {
            "serving": self.server is not None and self.server.serving,
            "server": self.server.snapshot() if self.server else None,
            "trace_stream": self.stream.snapshot() if self.stream else None,
        }
