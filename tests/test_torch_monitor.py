"""The port's monitor plane (``accl_tpu_torch.monitor``) against the JAX
package's (``accl_tpu.monitor``).

The classes are copies, so one seeded observation stream through both
must give equal verdicts, snapshots, alerts, files and advice, exactly.
Each scenario below is a function of the module under test; the tests
run it on both and hold the port's result equal to JAX's, then check
what the scenario is there to show (a JAX monitor test's assertion,
where it has one).  The facade's services (the scrape server, the trace
stream) run on ``cuda_group(..., device="cpu")``; every threaded wait is
bounded.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from accl_tpu import monitor as JM
from helpers import run_parallel

import accl_tpu_torch as at
from accl_tpu_torch import monitor as TM
from accl_tpu_torch.constants import ACCLError, ErrorCode

def _both(scenario, *args):
    """``scenario(module, *args)`` on the JAX module and the port's;
    asserts the two results equal and returns the port's."""
    want = scenario(JM, *args)
    got = scenario(TM, *args)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# the skew judge and tracker over one seeded stream
# ---------------------------------------------------------------------------


def _latency_stream(seed: int, world: int, windows: int, slow: int,
                    slow_us: float):
    """Per window, every observer's per-source latency vector: noise
    around 10 us, source ``slow`` at ``slow_us`` (slow = -1: none)."""
    rng = np.random.default_rng(seed)
    out = []
    for _w in range(windows):
        vecs = {}
        for obs in range(world):
            vecs[obs] = {
                src: float(slow_us if src == slow
                           else 10.0 + rng.uniform(0, 5))
                for src in range(world) if src != obs
            }
        out.append(vecs)
    return out


def _board(M, seed, world, windows, slow, slow_us, persist):
    j = M.SkewJudge(world=world, min_us=200.0, factor=4.0, persist=persist)
    verdicts = []
    for w, vecs in enumerate(_latency_stream(seed, world, windows, slow,
                                             slow_us)):
        for obs in range(world):
            verdicts.append(j.post_latency(0, w, obs, vecs[obs]))
    return verdicts, j.snapshot(), j.slow_ranks(0), j.recovered(0, 1)


@pytest.mark.parametrize("seed,world,slow,slow_us,persist,convicts", [
    (1, 4, 2, 9000.0, 2, True),    # dominant past the floor, persisting
    (2, 4, 2, 150.0, 1, False),    # dominant but under the 200 us floor
    (3, 4, -1, 0.0, 1, False),     # uniform load: no verdict
    (4, 2, 1, 5000.0, 2, True),    # board mode convicts at world 2
])
def test_skew_judge_board_verdicts_equal_jax(seed, world, slow, slow_us,
                                             persist, convicts):
    verdicts, snap, slow_ranks, _ = _both(_board, seed, world, 4, slow,
                                          slow_us, persist)
    assert bool(snap["verdicts"]) == convicts
    assert slow_ranks == ([slow] if convicts else [])
    if convicts:
        assert snap["standing"]["0"]["basis"] == "majority"
        assert snap["standing"]["0"]["streak"] >= persist


def _median(M):
    j = M.SkewJudge(world=4, min_us=200.0, factor=4.0, persist=1)
    j.post_latency(0, 0, 1, {0: 10.0, 2: 12.0, 3: 9.0})
    j.post_latency(0, 0, 2, {0: 11.0, 1: 10.0, 3: 8.0})
    j.post_latency(0, 0, 3, {0: 90000.0, 1: 12.0, 2: 11.0})
    return j.post_latency(0, 0, 0, {1: 9.0, 2: 10.0, 3: 11.0}), j.snapshot()


def test_skew_judge_median_discounts_one_receiver_as_jax():
    verdict, snap = _both(_median)
    assert verdict is None and snap["standing"] == {}


def _dominance(M):
    j = M.SkewJudge(world=2, min_us=200.0, factor=4.0, persist=1)
    j.post_latency(0, 0, 0, {1: 5000.0})
    return j.post_latency(0, 0, 1, {0: 4000.0}), j.snapshot()


def test_skew_judge_needs_dominance_as_jax():
    verdict, _ = _both(_dominance)
    assert verdict is None  # past the floor, not dominant


def _quiet_window(M):
    j = M.SkewJudge(world=3, min_us=200.0, factor=4.0, persist=2)
    out = []
    for w, lat1 in enumerate((9000.0, None, 9000.0, 9000.0)):
        v0 = {2: 10.0} if lat1 is None else {1: lat1, 2: 10.0}
        v2 = {0: 11.0} if lat1 is None else {1: lat1, 0: 11.0}
        j.post_latency(0, w, 0, v0)
        j.post_latency(0, w, 2, v2)
        out.append(j.post_latency(0, w, 1, {0: 9.0, 2: 12.0}))
    return out, j.snapshot()


def test_skew_streak_broken_by_quiet_window_as_jax():
    verdicts, _ = _both(_quiet_window)
    assert verdicts[:3] == [None, None, None]
    assert verdicts[3]["rank"] == 1 and verdicts[3]["streak"] == 2


def _wire(M, world, slow_ns):
    t = M.SkewTracker(rank=0, world=world, interval=2)
    for _w in range(4):
        for _ in range(2):
            t.on_message(0, 1, slow_ns)
            if world > 2:
                t.on_message(0, 2, 400_000)
            t.observe(0, duration_ns=1_000_000)
    return t.snapshot()


def test_skew_tracker_wire_mode_pairwise_as_jax():
    snap = _both(_wire, 3, 30_000_000)
    assert snap["exchange"] == "wire"
    assert snap["standing"]["0"]["rank"] == 1
    assert snap["standing"]["0"]["basis"] == "pairwise"


def test_skew_single_source_never_convicts_as_jax():
    snap = _both(_wire, 2, 50_000_000)
    assert snap["ewma_latency_us"]["0"]["1"] > 0
    assert snap["verdicts"] == [] and snap["standing"] == {}


def _wait_lag(M, seed):
    rng = np.random.default_rng(seed)
    t = M.SkewTracker(rank=0, world=2, interval=2)
    for w in range(6):
        t.judge.post_wait(0, w, 0, float(rng.uniform(50, 150)), world=2)
        t.judge.post_wait(0, w, 1, float(rng.uniform(900, 1100)), world=2)
    return t.judge.snapshot()


def test_skew_wait_baselines_never_convict_as_jax():
    snap = _both(_wait_lag, 7)
    assert snap["ewma_wait_lag_us"]["0"]["0"] > 0
    assert snap["verdicts"] == []


def _board_trackers(M, seed):
    """Four trackers on one anchored judge (the gang's board), fed the
    same seeded wait durations and per-source latencies."""
    anchor = type("Anchor", (), {})()
    rng = np.random.default_rng(seed)
    trackers = [M.SkewTracker(r, 4, interval=4,
                              judge=M.judge_for(anchor, 4))
                for r in range(4)]
    assert all(t.judge is trackers[0].judge for t in trackers)
    for t in trackers:
        t.begin_comm(9, t.rank, 4)
    for _call in range(12):
        for t in trackers:
            for src in range(4):
                if src != t.rank:
                    lat = 8_000_000 if src == 3 else int(
                        rng.integers(5_000, 15_000))
                    t.on_message(9, src, lat)
            t.observe(9, int(rng.integers(100_000, 200_000)),
                      comm_rank=t.rank, comm_world=4)
    return [t.snapshot() for t in trackers], [t.stamp(9) for t in trackers]


def test_skew_trackers_on_one_board_equal_jax():
    snaps, stamps = _both(_board_trackers, 11)
    assert snaps[0]["exchange"] == "board"
    assert snaps[0]["standing"]["9"]["rank"] == 3
    assert all(s[0] == 2 for s in stamps)  # 12 calls, windows of 4


def _early_claims(M):
    t = M.SkewTracker(rank=2, world=4, interval=2)
    t.begin_comm(77, comm_rank=1, comm_world=3)
    t.observe_claim(77, src_rank=2, window=0, mean_us=100.0)
    t.observe_claim(77, src_rank=1, window=0, mean_us=50.0)
    return dict(t.judge._wait_posts)


def test_skew_tracker_begin_comm_resolves_early_claims_as_jax():
    assert _both(_early_claims) == {(77, 0): {2: 100.0}}


def _judge_reset(M):
    out = _board(M, 1, 4, 4, 2, 9000.0, 2)[1]
    j = M.SkewJudge(world=4, min_us=200.0, factor=4.0, persist=1)
    for w, vecs in enumerate(_latency_stream(1, 4, 2, 2, 9000.0)):
        for obs in range(4):
            j.post_latency(0, w, obs, vecs[obs])
    cleared = j.clear_slow(0, rank=2)
    j.reset()
    return out, cleared, j.snapshot()


def test_skew_judge_clear_and_reset_as_jax():
    _, cleared, snap = _both(_judge_reset)
    assert cleared is True
    assert snap["standing"] == {} and snap["ewma_latency_us"] == {}


# ---------------------------------------------------------------------------
# the anomaly watchdog
# ---------------------------------------------------------------------------


def _watchdog(M, seed):
    rng = np.random.default_rng(seed)
    w = M.AnomalyWatchdog(factor=4.0, warmup=8)
    alerts = []
    for i in range(300):
        bucket = int(rng.integers(0, 3))
        d = int(rng.integers(80_000, 120_000))
        if i % 37 == 36:
            d *= 60  # a spike
        if i > 200:
            d = 50_000_000  # a persistent regime shift
        alerts.append(w.observe("allreduce", bucket, d))
    return alerts, w.snapshot()


def test_anomaly_watchdog_alerts_equal_jax():
    alerts, snap = _both(_watchdog, 3)
    assert snap["alerts_total"] >= 5
    assert len(snap["alerts"]) <= TM._ALERT_CAP
    assert alerts[-1] is None  # the new regime became the baseline


# ---------------------------------------------------------------------------
# the trace stream's rollover and pruning
# ---------------------------------------------------------------------------


def _stream(M, root):
    d = root / M.__name__.split(".")[0]
    batches = [[{"name": f"ev{i}", "ph": "X", "ts": i} for i in range(3)]]
    for k in range(4):
        batches.append([{"name": f"b{k}", "ph": "X", "ts": 100 + k},
                        {"name": f"c{k}", "ph": "X", "ts": 200 + k}])
    pending = list(batches)

    def pull():
        return pending.pop(0) if pending else []

    w = M.TraceStreamWriter(str(d), rank=0, pull_fn=pull, interval_s=3600.0,
                            max_events=2, max_files=2)
    try:
        sizes = []
        for _ in batches:
            w.flush()
            sizes.append(len(list(d.glob("accl_trace_rank0_*.json"))))
    finally:
        assert w.stop(timeout=10.0) is True
    snap = w.snapshot()
    snap.pop("dir")
    files = {f.name: json.loads(f.read_text())
             for f in sorted(d.glob("accl_trace_rank0_*.json"))}
    return sizes, snap, files


def test_trace_stream_rollover_and_prune_equal_jax(tmp_path):
    sizes, snap, files = _both(_stream, tmp_path)
    assert sizes[0] == 2 and max(sizes) <= 3
    assert snap["events_streamed"] == 11
    assert all("traceEvents" in doc for doc in files.values())


# ---------------------------------------------------------------------------
# the classes the facade does not wire yet
# ---------------------------------------------------------------------------


def _tenant(p99, count, queued=0, limit=8, cls="batch"):
    return {"class": cls, "latency": {"p99_us": p99, "count": count},
            "queued": queued, "outstanding_limit": limit}


def _advice(M):
    n = M.SCALE_MIN_SAMPLES
    adv = M.ScaleAdvisor(grow_p99_us=1000.0, shrink_p99_us=100.0)
    cases = [None,
             {"tenants": {"0": _tenant(5000.0, n)}},
             {"tenants": {"1": _tenant(None, 0, queued=20, limit=8)}},
             {"tenants": {"0": _tenant(50.0, n)}},
             {"tenants": {"0": _tenant(500.0, n)}},
             {"tenants": {"0": _tenant(50.0, n - 1)}}]
    return [adv.advise(c, world=4) for c in cases], adv.snapshot()


def test_scale_advisor_equal_jax():
    out, snap = _both(_advice)
    assert [(o["recommendation"], o["reason"]) for o in out] == [
        ("hold", "insufficient_data"), ("grow", "tail_pressure"),
        ("grow", "tail_pressure"), ("shrink", "idle_tail"),
        ("hold", "within_band"), ("hold", "insufficient_data")]
    assert snap["advisories"] == 6


def _blackbox(M, root):
    d = root / M.__name__.split(".")[0]
    peers = {0: lambda: {"rank": 0, "records": [1, 2]},
             2: lambda: {"rank": 2, "records": [3]}}
    bb = M.BlackBox(rank=1, world=4, evidence_fn=lambda: {"rank": 1},
                    directory=str(d), peers_fn=lambda: peers)
    path = bb.capture("DEADLOCK_SUSPECTED", context="ctx",
                      details={"op": "allreduce"}, key=("k",))
    again = bb.capture("DEADLOCK_SUSPECTED", key=("k",))
    doc = M.load_bundle(path)
    doc.pop("created_ns")
    snap = bb.snapshot()
    for key in ("dir", "last_bundle"):
        snap.pop(key)
    return os.path.relpath(path, d), again == path, doc, snap


def test_blackbox_bundle_equal_jax(tmp_path):
    rel, latched, doc, snap = _both(_blackbox, tmp_path)
    assert latched and snap["bundles_written"] == 1
    assert doc["absent"] == [3] and doc["reachable"] == [0, 1, 2]


def test_anchored_shares_one_instance_per_anchor():
    class Anchor:
        pass

    a, b = Anchor(), Anchor()
    assert TM.anchored(a, "_x", list) is TM.anchored(a, "_x", list)
    assert TM.anchored(a, "_x", list) is not TM.anchored(b, "_x", list)
    assert TM.anchored(None, "_x", list) is None
    assert TM.judge_for(a, 4) is TM.judge_for(a, 4)


# ---------------------------------------------------------------------------
# the facade's services
# ---------------------------------------------------------------------------


def _get(port: int, route: str, timeout: float = 5.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=timeout) as r:
        return r.status, r.read().decode()


def _accl_threads():
    return [t.name for t in threading.enumerate()
            if t.is_alive() and (t.name.startswith("accl-monitor")
                                 or t.name.startswith("accl-trace-stream"))]


def _drive(group, rounds: int, n: int = 64):
    send = [a.create_buffer_from(np.full(n, r + 1.0, np.float32))
            for r, a in enumerate(group)]
    recv = [a.create_buffer(n, np.float32) for a in group]
    for _ in range(rounds):
        run_parallel(group, lambda a, r: a.allreduce(send[r], recv[r], n))


def test_facade_monitor_shares_one_judge_per_gang():
    g = at.cuda_group(4, device="cpu")
    try:
        trackers = [a._monitor.tracker for a in g]
        assert all(t.shared_judge for t in trackers)
        assert all(t.judge is trackers[0].judge for t in trackers)
        assert g[0].engine.telemetry_report()["skew_exchange"] == "board"
        _drive(g, 8)  # one skew window (8 calls) judged on the board
        snap = g[0].telemetry_snapshot()["stragglers"]
        assert snap["exchange"] == "board" and snap["windows_posted"] == 1
        assert "0" in snap["ewma_wait_lag_us"]
        assert g[0].telemetry_snapshot()["anomalies"]["enabled"] is True
    finally:
        for a in g:
            a.deinit()


def test_start_monitor_scrapes_every_route():
    g = at.cuda_group(2, device="cpu")
    try:
        _drive(g, 3)
        a = g[0]
        port = a.start_monitor(port=0)
        assert port > 0 and a.start_monitor(0) == port
        status, body = _get(port, "/metrics")
        assert status == 200 and "accl_calls_total" in body
        status, body = _get(port, "/snapshot")
        snap = json.loads(body)
        assert status == 200 and snap["schema_version"] == 6
        assert snap["monitor"]["serving"] is True
        status, body = _get(port, "/trace")
        assert status == 200 and any(
            e.get("name") == "accl::allreduce"
            for e in json.loads(body)["traceEvents"])
        status, body = _get(port, "/cmdring")
        assert status == 200 and "windows_logged" in json.loads(body)
        status, body = _get(port, "/")
        assert status == 200 and "/cmdring" in body
        status, body = _get(port, "/tenants")  # the arbiter's snapshot
        assert status == 200 and json.loads(body) == \
            a.telemetry_snapshot()["tenants"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/no-such-route")
        assert e.value.code == 404
        srv = a.capabilities()["monitor"]["server"]
        assert srv["scrapes"]["/metrics"] == 1
        assert a.stop_monitor() is True
        assert a.stop_monitor() is True  # no-op once stopped
        with pytest.raises(OSError):
            _get(port, "/metrics", timeout=1.0)
    finally:
        for a in g:
            a.deinit()
    assert _accl_threads() == []


def test_start_monitor_raises_with_telemetry_off(monkeypatch):
    monkeypatch.setenv("ACCL_TELEMETRY", "0")
    g = at.cuda_group(1, device="cpu")
    try:
        with pytest.raises(ACCLError) as e:
            g[0].start_monitor(0)
        assert e.value.code == ErrorCode.INVALID_OPERATION
        assert g[0].capabilities()["monitor"] is None
        assert g[0].telemetry_snapshot()["stragglers"] == {"enabled": False}
    finally:
        for a in g:
            a.deinit()


def test_env_port_autostart_and_busy_port(monkeypatch, capsys):
    """``ACCL_MONITOR_PORT`` serves at construction; in-process ranks
    after the first find the port taken and say so (JAX's message)."""
    with socket.socket() as probe:  # a port free a moment ago
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    monkeypatch.setenv("ACCL_MONITOR_PORT", str(port))
    g = at.cuda_group(2, device="cpu")
    try:
        assert g[0].capabilities()["monitor"]["server"]["port"] == port
        assert g[1].capabilities()["monitor"]["serving"] is False
        assert "monitor port busy, not serving rank 1" in (
            capsys.readouterr().err)
        assert _get(port, "/metrics")[0] == 200
    finally:
        for a in g:
            a.deinit()
    assert _accl_threads() == []


def test_stop_joins_a_request_thread_still_closing(monkeypatch):
    """A request thread descheduled after its reply (a loaded host) is
    joined by ``stop()``: no ``accl-monitor`` thread outlives deinit."""
    from http.server import BaseHTTPRequestHandler

    finish = BaseHTTPRequestHandler.finish

    def slow_finish(self):
        finish(self)
        time.sleep(0.8)  # longer than shutdown()'s 0.5 s poll

    monkeypatch.setattr(BaseHTTPRequestHandler, "finish", slow_finish)
    g = at.cuda_group(1, device="cpu")
    try:
        port = g[0].start_monitor(0)
        assert _get(port, "/metrics")[0] == 200
    finally:
        for a in g:
            a.deinit()
    assert _accl_threads() == []


def test_trace_stream_env_writes_loadable_files(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCL_TRACE_STREAM", str(tmp_path))
    monkeypatch.setenv("ACCL_TRACE_STREAM_INTERVAL_S", "0.05")
    g = at.cuda_group(2, device="cpu")
    try:
        _drive(g, 3)
        deadline = time.monotonic() + 10.0
        events = []
        while time.monotonic() < deadline:
            events = [e for f in tmp_path.glob("accl_trace_rank*.json")
                      for e in json.loads(f.read_text())["traceEvents"]]
            if sum(e.get("name") == "accl::allreduce" for e in events) >= 6:
                break
            time.sleep(0.05)
        # read mid-run, without a stop: every file is a whole document
        assert sum(e.get("name") == "accl::allreduce" for e in events) == 6
    finally:
        for a in g:
            a.deinit()
    assert _accl_threads() == []
    for f in tmp_path.glob("accl_trace_rank*.json"):
        json.loads(f.read_text())
