"""The port's telemetry plane (``accl_tpu_torch.telemetry``, the facade's
records, the command ring's window log) against the JAX package's.

The module is a copy of ``accl_tpu/telemetry.py``, so its pure functions
and classes must give JAX's output on the same inputs, exactly: the
exporters' text, the Chrome traces and their merge, the flow checks, the
trace ids and the histograms (both modules' clock anchors pinned to one
value where a time is rendered).  On the facade, ``xla_group(4)`` and
``cuda_group(4, device="cpu")`` run one call sequence (an allreduce, a
bcast, a batched window of 2, a pipelined allreduce, a send / recv) and
their flight records, metrics counters, snapshot keys, window logs and
capability keys must be equal rank by rank, times excluded.  The
differences that remain are ROADMAP §C's divergences, each pinned by a
test named for it below.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from accl_tpu import telemetry as JT
from accl_tpu.core import xla_group
from helpers import run_parallel
import test_telemetry as jax_tests

import accl_tpu_torch as at
from accl_tpu_torch import telemetry as TT
from accl_tpu_torch.constants import ACCLError, ErrorCode
from accl_tpu_torch.request import Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4
N = 64

#: the flight-record fields held equal (everything but the times; a
#: communicator's epoch comes from a process-wide counter, so each
#: record's is held equal to its own handle's communicator's); beside
#: them, whether ``overlap_ns`` is set
RECORD_KEYS = ("op", "comm", "epoch", "dtype", "count", "nbytes", "bucket",
               "algorithm", "plan_hit", "eager", "retcode", "ring_resident",
               "trace_id", "parent_id", "inflight_depth", "tenant")


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both modules' epoch / perf-counter anchors at one value, so the
    times they render from equal perf_counter stamps are equal."""
    for mod in (JT, TT):
        monkeypatch.setattr(mod, "_ANCHOR_EPOCH_NS", 1_700_000_000 * 10**9)
        monkeypatch.setattr(mod, "_ANCHOR_PERF_NS", 5 * 10**9)


def _deinit(group):
    for a in group:
        a.deinit()


# ---------------------------------------------------------------------------
# pure functions and classes, equal outputs
# ---------------------------------------------------------------------------


def test_trace_ids_equal_jax_over_a_grid():
    ops = ("allreduce", "bcast", "reduce_scatter", "__batch__", "barrier")
    for op in ops:
        for comm in (0, 1, 12345, 2**31 - 1):
            for gen in (1, 2, 7):
                for seqn in (0, 1, 63, 10**6):
                    assert TT.collective_trace_id(op, comm, gen, seqn) == \
                        JT.collective_trace_id(op, comm, gen, seqn)
    rng = np.random.default_rng(3)
    for _ in range(200):
        comm, src, dst, tag, seqn = (int(v) for v in rng.integers(0, 1000, 5))
        stream = int(rng.integers(0, 4))
        assert TT.p2p_trace_id(comm, src, dst, tag, seqn, stream=stream) == \
            JT.p2p_trace_id(comm, src, dst, tag, seqn, stream=stream)
    assert TT.collective_trace_id("allreduce", 0, 1, 0) != 0


def _seeded_calls(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    ops = ("allreduce", "bcast", "send", "reduce_scatter")
    for i in range(n):
        yield dict(
            op=ops[int(rng.integers(0, 4))],
            size_bucket=int(rng.integers(0, 25)),
            duration_ns=int(rng.integers(1, 10**9)),
            code=int(rng.choice([0, 0, 0, 1 << 3])),
            plan_hit=(True, False, None)[int(rng.integers(0, 3))],
            attempts=int(rng.integers(0, 3)) or None,
            overlap_ns=int(rng.integers(0, 10**6)) if i % 5 == 0 else None,
            ring_resident=bool(i % 3 == 0) or None,
        )


def test_histogram_buckets_and_counters_equal_jax():
    for v in (0, 1, 2, 3, 1023, 1024, 10**6, 2**40):
        assert TT._log2_bucket(v) == JT._log2_bucket(v)
    want, got = JT.MetricsRegistry(), TT.MetricsRegistry()
    for c in _seeded_calls(5):
        name = "TIMEOUT" if c["code"] else "OK"
        for reg in (want, got):
            reg.record_call(c["op"], c["size_bucket"], c["duration_ns"],
                            c["code"], name, c["plan_hit"], c["attempts"],
                            c["overlap_ns"], c["ring_resident"])
            reg.inc("accl_compression_casts_total", ("int8",))
            reg.observe(c["op"], c["size_bucket"], c["duration_ns"] // 3)
    assert got.snapshot() == want.snapshot()


def _record(mod, i: int, **extra):
    return mod.CallRecord(
        "allreduce" if i % 3 else "send", i % 2, 1, "FLOAT32", 8 * i,
        32 * i, 3, "xla", bool(i % 2), True, 1000 * (i + 1), 0, "OK",
        6 * 10**9 + 10_000 * i, **extra)


def test_flight_recorder_equal_jax(pinned_clock):
    want, got = JT.FlightRecorder(capacity=8), TT.FlightRecorder(capacity=8)
    for i in range(21):
        want.append(_record(JT, i))
        got.append(_record(TT, i))
    assert len(got) == len(want) == 8 and got.total == want.total == 21
    assert got.tail_dicts(5) == want.tail_dicts(5)
    (rw, cw), (rg, cg) = want.since(15), got.since(15)
    assert cw == cg == 21
    assert [r.as_dict() for r in rg] == [r.as_dict() for r in rw]


def _flow_records(mod):
    """A 3-rank collective, a send -> recv and a child with a parent."""
    recs = []
    for rank, phase in enumerate(("s", "t", "f")):
        recs.append((rank, _record(mod, rank, trace_id=0x1234,
                                   trace_phase=phase)))
    recs.append((0, _record(mod, 7, trace_id=0xBEEF, trace_phase="s")))
    recs.append((1, _record(mod, 8, trace_id=0xBEEF, trace_phase="f",
                            parent_id=0x77)))
    return recs


def test_chrome_trace_and_flows_equal_jax(pinned_clock):
    def render(mod):
        tel = [mod.Telemetry(r, "CudaEngine") for r in range(3)]
        events = {}
        for rank, rec in _flow_records(mod):
            tel[rank].recorder.append(rec)
            events.setdefault(rank, []).append(mod.record_event(rec, rank))
            events[rank] += mod.flow_events_for(rec, rank)
        docs = [mod.chrome_trace(t.chrome_events(wire=False)) for t in tel]
        merged = mod.merge_traces(docs)
        return events, docs, merged, mod.validate_flows(
            merged["traceEvents"]), mod.validate_flow_docs(docs)

    want, got = render(JT), render(TT)
    assert got == want
    assert got[3] == [] and got[4] == []
    # a rank missing from the merge leaves unmatched ends, alike
    partial = TT.merge_traces(got[1][1:])["traceEvents"]
    assert TT.validate_flows(partial) == JT.validate_flows(partial)
    assert TT.validate_flows(partial)
    assert TT.validate_flow_docs(got[1][1:]) == JT.validate_flow_docs(
        got[1][1:]) != []


def test_merge_dedups_the_shared_rows_as_jax():
    wire = {"name": "x", "cat": "wire", "ph": "i", "ts": 1.0, "pid": 9,
            "tid": 1}
    ring = {"name": "cmdring::window[2]", "cat": "cmdring", "ph": "X",
            "ts": 2.0, "dur": 1.0, "pid": 9, "tid": 2}
    docs = [{"traceEvents": [wire, ring, {"name": "a", "ph": "X", "ts": r,
                                          "pid": r}]} for r in range(3)]
    assert TT.merge_traces(docs) == JT.merge_traces(docs)
    assert len(TT.merge_traces(docs)["traceEvents"]) == 5


def test_wire_ring_equal_jax(monkeypatch, pinned_clock):
    monkeypatch.setenv("ACCL_TELEMETRY_SAMPLE", "2")
    for mod in (JT, TT):
        mod.wire_reset()
    try:
        for i in range(9):
            for mod in (JT, TT):
                mod.wire_event("wire", f"send EAGER seq={i}")
                mod.wire_flow(0x10 + i, 0, 1, 0)
        ws, wt = JT.wire_snapshot(), TT.wire_snapshot()
        for snap in (ws, wt):
            for ev in snap["events"]:
                ev.pop("ts_us")
        assert wt == ws and wt["recorded"] == 5
        assert [dict(e, ts_us=0) for e in TT.wire_flow_events()] == \
            [dict(e, ts_us=0) for e in JT.wire_flow_events()]
    finally:
        for mod in (JT, TT):
            mod.wire_reset()


def _full_snapshot(base: dict) -> dict:
    """``base`` with every section the Prometheus exporter folds filled:
    the engine's ring counters and window histogram, tenants, membership,
    health events, stragglers, anomalies, services, compression."""
    snap = json.loads(json.dumps(base, default=str))
    snap["engine"]["cmdring"].update({
        "ops": {"ALLREDUCE": 4, "BCAST": 1},
        "fallbacks": {"oversized": 2},
        "window_latency_log2_us": {"3": 2, "7": 1},
        "window_latency_sum_us": 171.25, "windows_logged": 3,
        "state": "resident", "mailbox_depth": 1})
    snap["tenants"] = {"enabled": True, "rounds": 3, "tenants": {"5": {
        "name": 'ten"ant\\1', "class": "burst", "weight": 2,
        "admitted": 9, "completed": 9, "outstanding": 0, "queued": 0,
        "latency": {"log2_us": {"4": 3, "9": 1}, "count": 4,
                    "sum_ns": 812000}}}}
    snap["membership"] = {"epoch": 2, "elastic": True, "evicted": [3],
                          "demotion": {"demotions_total": 1, "breakers": {
                              "0/3": {"state": "open"}}}}
    snap["health_events"] = {"transitions_total": 2,
                             "counters": {"3|ok|suspect": 1, "bad": 1}}
    snap["stragglers"] = {"ewma_wait_lag_us": {"0": {"1": 12.5}},
                          "ewma_latency_us": {"0": {"2": 900.0}},
                          "standing": {"0": {"rank": 2}},
                          "windows_judged": 4, "verdicts": [{}]}
    snap["anomalies"] = {"alerts_total": 2}
    snap["monitor"] = {"server": {"scrapes": {"/metrics": 3}, "errors": 1},
                       "trace_stream": {"events_streamed": 40}}
    snap["compression"] = {"sr_calls": 4, "error_feedback": {
        "enabled": True, "entries": 2, "max_residual_norm": 0.5}}
    snap["postmortem"] = {"enabled": True, "bundles_written": 1,
                          "solicit_timeouts": 0}
    return snap


@pytest.fixture(scope="module")
def recorded():
    """One call sequence on both gangs: an allreduce, a bcast (root 1), a
    batched window of 2 allreduces, an allreduce pipelined into 4
    segments and a send / recv; then every rank's snapshot, capabilities
    and trace export, and the gang tables' rooted registers.  Both gangs
    run with an in-flight window of depth 1, where whether a call
    overlapped a later launch does not hang on the threads' timing (a
    launch parks only once the call before it completed)."""
    rows = np.random.default_rng(19).standard_normal((P, N)).astype(
        np.float32)

    def sequence(group):
        for a in group:
            a.set_inflight_window(1)
        send = [a.create_buffer_from(rows[r].copy())
                for r, a in enumerate(group)]
        recv = [a.create_buffer(N, np.float32) for a in group]
        got = [a.create_buffer(N, np.float32) for a in group]

        def work(a, r):
            a.allreduce(send[r], recv[r], N)
            a.bcast(recv[r], N, root=1)
            with a.batch():
                reqs = [a.allreduce(send[r], recv[r], N, run_async=True),
                        a.allreduce(send[r], got[r], N, run_async=True)]
            for q in reqs:
                assert q.wait(60)
                q.check()

        run_parallel(group, work)
        for a in group:
            a.set_tuning("ring_segments", 4)
            a.set_tuning("pipeline_threshold", 128)
        run_parallel(group, lambda a, r: a.allreduce(send[r], recv[r], N))

        def p2p(a, r):
            if r == 0:
                a.send(send[r], N, dst=1, tag=3)
            elif r == 1:
                a.recv(recv[r], N, src=0, tag=3)

        run_parallel(group, p2p)
        return {
            "snaps": [_epochs_checked(a) for a in group],
            "caps": [a.capabilities() for a in group],
            "traces": [a.export_chrome_trace() for a in group],
            "tuning": dict(group[0].engine.gang.tuning),
            "out": [np.asarray(b.host_view()).copy() for b in recv],
        }

    jg = xla_group(P)
    try:
        want = sequence(jg)
    finally:
        _deinit(jg)
    tg = at.cuda_group(P, device="cpu")
    try:
        got = sequence(tg)
    finally:
        _deinit(tg)
    return want, got


def _epochs_checked(a) -> dict:
    """The handle's snapshot, each record's epoch checked against its
    communicator's on this handle and replaced by ``"own"``."""
    snap = a.telemetry_snapshot()
    epochs = {c.id: c.epoch for c in a._communicators}
    for rec in snap["flight_recorder"]:
        assert rec["epoch"] == epochs[rec["comm"]]
        rec["epoch"] = "own"
    return snap


def _record_rows(snap, jax_tuning=None, port_tuning=None):
    rows = []
    for rec in snap["flight_recorder"]:
        row = dict((k, rec.get(k)) for k in RECORD_KEYS)
        row["overlapped"] = rec.get("overlap_ns") is not None
        if jax_tuning is not None and row["algorithm"] is None:
            # §C: JAX's gang table holds no rooted register until one is
            # written (None); the port's holds every register's default
            reg = f"{row['op']}_algorithm"
            if reg not in jax_tuning and reg in port_tuning:
                row["algorithm"] = port_tuning[reg]
        rows.append(row)
    return rows


def test_prometheus_and_json_equal_jax(recorded):
    want, got = recorded
    for snap in (want["snaps"][0], got["snaps"][0]):
        full = _full_snapshot(snap)
        assert TT.to_prometheus(full) == JT.to_prometheus(full)
        assert TT.to_json(full) == JT.to_json(full)
        assert TT.to_prometheus(snap) == JT.to_prometheus(snap)
    text = TT.to_prometheus(_full_snapshot(got["snaps"][0]))
    assert "accl_cmdring_window_latency_us_bucket" in text
    assert 'tenant="ten\\"ant\\\\1"' in text


def test_flight_records_equal_jax(recorded):
    want, got = recorded
    for r in range(P):
        assert _record_rows(got["snaps"][r]) == _record_rows(
            want["snaps"][r], want["tuning"], got["tuning"]), f"rank {r}"
    np.testing.assert_allclose(got["out"][2], want["out"][2], rtol=1e-6)
    ops = [rec["op"] for rec in got["snaps"][0]["flight_recorder"]]
    assert ops == ["allreduce", "bcast", "allreduce", "allreduce",
                   "allreduce"] + ["allreduce"] * 4 + ["send"]
    # the batch's calls name the batch, the segments their aggregate
    recs = got["snaps"][0]["flight_recorder"]
    assert recs[2]["parent_id"] == recs[3]["parent_id"] is not None
    agg = recs[-2]
    assert agg["count"] == N and all(
        r["parent_id"] == agg["trace_id"] for r in recs[4:8])
    assert recs[-1].get("ring_resident") is None  # no ring on a send


def test_metrics_counters_equal_jax(recorded):
    want, got = recorded
    for r in range(P):
        assert got["snaps"][r]["metrics"]["counters"] == \
            want["snaps"][r]["metrics"]["counters"]
        assert {k: h["count"] for k, h in
                got["snaps"][r]["metrics"]["histograms"].items()} == \
            {k: h["count"] for k, h in
             want["snaps"][r]["metrics"]["histograms"].items()}


def test_snapshot_keys_equal_jax(recorded):
    want, got = recorded
    ws, ts = want["snaps"][0], got["snaps"][0]
    assert set(ts) == set(ws)
    assert set(ts["engine"]) == set(ws["engine"])
    assert ts["schema_version"] == ws["schema_version"] == 6
    assert set(ts["compression"]) == set(ws["compression"])
    assert set(ts["stragglers"]) == set(ws["stragglers"])
    assert set(ts["anomalies"]) == set(ws["anomalies"])
    assert ts["monitor"] == ws["monitor"]
    # the ring's stats (the QoS plane's budgets included), the in-flight
    # window's and the arbiter's: JAX's keys
    assert set(ts["engine"]["cmdring"]) == set(ws["engine"]["cmdring"])
    assert set(ts["engine"]["inflight"]) == set(ws["engine"]["inflight"])
    assert set(ts["tenants"]) == set(ws["tenants"])


def test_window_log_equal_jax(recorded):
    want, got = recorded

    def slots(snap):
        return [[(s["seqn"], s["opcode"], s["retcode"], s["trace_id"])
                 for s in w["slots"]]
                for w in snap["engine"]["cmdring"]["windows"]]

    for r in range(P):
        assert slots(got["snaps"][r]) == slots(want["snaps"][r])
    ring = got["snaps"][0]["engine"]["cmdring"]
    assert ring["windows_logged"] == 1
    window = ring["windows"][0]
    assert window["basis"] == "host" and window["form"] == "inline"
    batch = got["snaps"][0]["flight_recorder"][2:4]
    assert [s["trace_id"] for s in window["slots"]] == [
        rec["trace_id"] for rec in batch]


def test_capabilities_telemetry_and_monitor_equal_jax(recorded):
    want, got = recorded
    for key in ("telemetry", "monitor"):
        assert got["caps"][0][key] == want["caps"][0][key]
    assert got["caps"][0]["telemetry"] is True


def test_traces_merge_with_either_cli(recorded, tmp_path):
    """Each package's per-rank exports merge under both CLIs with every
    flow matched; the port's CLI also runs as ``python -m``."""
    want, got = recorded
    for name, traces in (("jax", want["traces"]), ("port", got["traces"])):
        paths = []
        for r, doc in enumerate(traces):
            path = tmp_path / f"{name}_rank{r}.json"
            path.write_text(json.dumps(doc))
            paths.append(str(path))
        assert TT.validate_flow_docs(traces) == []
        for mod in (JT, TT):
            out = tmp_path / f"{name}_by_{mod.__name__.split('.')[0]}.json"
            assert mod.main(["merge", "--out", str(out)] + paths) == 0
            merged = json.loads(out.read_text())["traceEvents"]
            assert mod.validate_flows(merged) == []
            assert sum(e.get("name") == "accl::allreduce"
                       for e in merged) == P * 8
            assert sum(e.get("cat") == "cmdring" and e.get("ph") == "X"
                       for e in merged) == 3  # one window of 2, deduped
    out = tmp_path / "cli.json"
    proc = subprocess.run(
        [sys.executable, "-m", "accl_tpu_torch.telemetry", "merge", "--out",
         str(out)] + [str(tmp_path / f"port_rank{r}.json") for r in range(P)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(out.read_text())["traceEvents"]
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(SystemExit):
        TT.main(["merge", str(bad)])


# ---------------------------------------------------------------------------
# the warm path, the kill switch, failures
# ---------------------------------------------------------------------------


@pytest.fixture
def port4():
    g = at.cuda_group(P, device="cpu")
    yield g
    _deinit(g)


def test_warm_path_recording_adds_zero_device_interactions(port4):
    """JAX's own test, unedited, on the port's gang: a warm collective
    with the plane on is 1 device interaction and 1 record."""
    jax_tests.test_warm_path_recording_adds_zero_device_interactions(port4)


def test_deadlock_error_carries_flight_recorder(port4):
    jax_tests.test_deadlock_error_carries_flight_recorder(port4)
    err = port4[0]._deadlock_error("ctx", {"op": "ALLREDUCE"})
    assert err.details["op"] == "ALLREDUCE"
    counters = port4[0]._telemetry.metrics.snapshot()["counters"]
    assert counters["accl_deadlock_suspected_total"] == 2


def test_kill_switch_disables_recording(monkeypatch):
    monkeypatch.setenv("ACCL_TELEMETRY", "0")
    g = at.cuda_group(2, device="cpu")
    try:
        jax_tests._exercise(g)
        ic0 = g[0].capabilities()["device_interactions"]
        jax_tests._exercise(g)
        assert g[0].capabilities()["device_interactions"] - ic0 == 1
        snap = g[0].telemetry_snapshot()
        assert snap["telemetry_enabled"] is False
        assert snap["flight_recorder"] == [] and snap["metrics"] == {}
        assert g[0].telemetry_trace_events() == []
        assert g[0].capabilities()["telemetry"] is False
    finally:
        _deinit(g)


def test_failed_call_ships_the_flight_recorder(port4):
    """A recv that times out raises with the recorder's tail, its own
    failed record last."""
    jax_tests._exercise(port4, n=8)
    a = port4[1]
    a.set_timeout(0.2)
    d = a.create_buffer(8, np.float32)
    with pytest.raises(ACCLError) as e:
        a.recv(d, 8, src=0, tag=9)
    assert e.value.code == ErrorCode.RECEIVE_TIMEOUT
    recs = e.value.details["flight_recorder"]
    assert recs[0]["op"] == "allreduce" and recs[-1]["op"] == "recv"
    assert recs[-1]["retcode_name"] == "RECEIVE_TIMEOUT"
    counters = a._telemetry.metrics.snapshot()["counters"]
    assert counters["accl_call_errors_total|recv|RECEIVE_TIMEOUT"] == 1


def _meta():
    return {"op": "allreduce", "comm": 0, "epoch": 1, "dtype": "FLOAT32",
            "count": 8, "nbytes": 32, "bucket": 3, "algorithm": None,
            "plan_hit": True, "eager": True}


def test_deferred_failure_amends_the_record():
    """JAX's deferred-adoption test on the port's Request: the placement
    that fails after an OK completion appends an amended record (the
    error counted once, the call not twice)."""
    tel = TT.Telemetry(0, "CudaEngine")
    req = Request("ALLREDUCE")
    tel.attach(req, _meta())

    def bad_resolver():
        raise RuntimeError("placement failed")

    req.defer_result(bad_resolver)
    req.complete(ErrorCode.OK, 1000)
    assert req.wait(1)
    with pytest.raises(ACCLError) as e:
        req.check()
    assert e.value.details["flight_recorder"][-1]["retcode_name"] == \
        "INVALID_OPERATION"
    recs = tel.recorder.tail()
    assert [r.retcode_name for r in recs] == ["OK", "INVALID_OPERATION"]
    counters = tel.metrics.snapshot()["counters"]
    assert counters["accl_calls_total|allreduce"] == 1
    assert counters["accl_call_errors_total|allreduce|INVALID_OPERATION"] \
        == 1


def test_complete_records_exactly_once():
    """A request completed twice (a card run's failure latch after its
    windows completed at post) keeps one record, amended on a failure;
    a request completed before ``attach`` is recorded by ``attach``."""
    tel = TT.Telemetry(0, "CudaEngine")
    req = Request("ALLREDUCE")
    tel.attach(req, _meta())
    req.complete(ErrorCode.OK, 10)
    req.complete(ErrorCode.OK, 10)
    assert tel.recorder.total == 1
    req.complete(ErrorCode.INVALID_OPERATION, 10)
    assert [r.retcode for r in tel.recorder.tail()] == [
        0, int(ErrorCode.INVALID_OPERATION)]
    assert tel.metrics.snapshot()["counters"][
        "accl_calls_total|allreduce"] == 1
    early = Request("ALLREDUCE")
    early.complete(ErrorCode.OK, 5)
    tel.attach(early, _meta())
    assert tel.recorder.total == 3 and early._telemetry is tel


def test_observers_see_each_call_once(port4):
    seen = []
    port4[0]._telemetry.add_observer(lambda m, d, c: seen.append(m["op"]))
    jax_tests._exercise(port4)
    assert seen == ["allreduce"]


# ---------------------------------------------------------------------------
# the aggregates' records against JAX
# ---------------------------------------------------------------------------


def test_hierarchical_records_equal_jax():
    from accl_tpu import topology as jtopo
    from accl_tpu_torch.topology import Topology

    rows = np.random.default_rng(23).standard_normal((P, N)).astype(
        np.float32)

    def run(group):
        for a in group:
            a.set_tuning("hierarchical", 1)
        send = [a.create_buffer_from(rows[r].copy())
                for r, a in enumerate(group)]
        recv = [a.create_buffer(N, np.float32) for a in group]
        run_parallel(group, lambda a, r: a.allreduce(send[r], recv[r], N))
        return ([_record_rows(_epochs_checked(a)) for a in group],
                [a.export_chrome_trace() for a in group])

    jg = xla_group(P, topology=jtopo.Topology.from_slice_size(P, 2))
    try:
        want, _ = run(jg)
    finally:
        _deinit(jg)
    tg = at.cuda_group(P, device="cpu", topology=Topology.from_slice_size(
        P, 2))
    try:
        got, traces = run(tg)
    finally:
        _deinit(tg)
    for r in range(P):
        key = lambda row: (row["trace_id"], row["op"])  # noqa: E731
        assert sorted(got[r], key=key) == sorted(want[r], key=key)
    agg = [row for row in got[0] if row["parent_id"] is None]
    assert [row["op"] for row in agg] == ["allreduce"]
    stages = [row for row in got[0] if row["parent_id"] is not None]
    assert {row["parent_id"] for row in stages} == {agg[0]["trace_id"]}
    assert [row["op"] for row in stages] == [
        "reduce_scatter", "allreduce", "allgather"]
    assert TT.validate_flow_docs(traces) == []


# ---------------------------------------------------------------------------
# ROADMAP §C: the recorded divergences
# ---------------------------------------------------------------------------


def _gate(group, comm_id):
    """Hold the gang's in-flight window on ``comm_id`` behind a parked
    entry until the returned event is set: every call of the comm
    launched meanwhile stays in flight behind it, on either package's
    gang (the same window), whatever the threads' timing."""
    import threading

    gate = threading.Event()
    group[0].engine.gang.window.park(
        comm_id, lambda: gate.wait(30), lambda *_a: None, lambda _e: None)
    return gate


def test_duration_ns_is_the_launch_time(port4):
    """(Was §C: a port request completed at launch.)  A gang call now
    completes when the in-flight window has seen its device work end:
    held behind the window, a launched call is not done, and its record,
    appended at completion, carries the duration from the gang's start
    to that end, the request's own ``get_duration_ns``, and the window
    depth it was parked at."""
    send = [a.create_buffer_from(np.ones(N, np.float32)) for a in port4]
    recv = [a.create_buffer(N, np.float32) for a in port4]
    gate = _gate(port4, port4[0].comm.id)
    held = 0.05
    t0 = time.perf_counter_ns()
    reqs = run_parallel(port4, lambda a, r: a.allreduce(
        send[r], recv[r], N, run_async=True))
    time.sleep(held)
    assert not any(q.done() for q in reqs)  # launched, still in flight
    assert port4[0].engine.gang.window.in_flight() == 2
    gate.set()
    for q in reqs:
        assert q.wait(30)
        q.check()
    for a, q in zip(port4, reqs):
        rec = a._telemetry.recorder.tail(1)[0]
        assert rec.duration_ns == q.get_duration_ns()
        assert held * 1e9 <= rec.duration_ns <= time.perf_counter_ns() - t0
        assert rec.inflight_depth == q.inflight_depth == 2
    port4[0].flush()
    assert port4[0].engine.gang.window.stats()["in_flight"] == 0


def test_overlap_ns_is_none(port4):
    """(Was §C: no window, so every ``overlap_ns`` was None.)  The
    records' ``overlap_ns`` presence, ``inflight_depth`` and ``tenant``
    equal ``xla_group``'s on the same calls: a registered tenant's burst
    of 4 async allreduces a rank, launched while the window is held, so
    each but the last is overlapped by a later launch (depths 2-5 behind
    the gate); and the ``accl_overlapped_calls_total`` counter and the
    window's launch counts equal JAX's.  A lone synchronous call after
    it overlaps nothing: ``overlap_ns`` None, as JAX records it."""
    send_rows = np.random.default_rng(5).standard_normal((P, 4096)).astype(
        np.float32)

    def run(group):
        for a in group:
            a.set_inflight_window(8)
            a.set_arbiter(True)
        run_parallel(group, lambda a, r: a.set_tenant_class(
            "guaranteed", name="serve"))
        send = [a.create_buffer_from(send_rows[r].copy())
                for r, a in enumerate(group)]
        recv = [[a.create_buffer(4096, np.float32) for _ in range(4)]
                for a in group]
        gate = _gate(group, group[0].comm.id)

        def burst(a, r):
            return [a.allreduce(send[r], d, run_async=True)
                    for d in recv[r]]

        reqs = run_parallel(group, burst)
        gate.set()
        for qs in reqs:
            for q in qs:
                assert q.wait(30)
                q.check()
        run_parallel(group, lambda a, r: a.allreduce(send[r], recv[r][0]))
        out = []
        for a in group:
            snap = a.telemetry_snapshot()
            out.append({
                "records": [(rec.get("overlap_ns") is not None,
                             rec.get("inflight_depth"), rec.get("tenant"))
                            for rec in snap["flight_recorder"]],
                "counters": {k: v for k, v in
                             snap["metrics"]["counters"].items()
                             if k.startswith("accl_overlapped")},
                "window": {k: snap["engine"]["inflight"][k] for k in (
                    "depth", "key_depths", "in_flight", "launched",
                    "completed", "failed", "max_depth_seen")},
            })
        return out

    jg = xla_group(P)
    try:
        want = run(jg)
    finally:
        _deinit(jg)
    got = run(port4)
    assert got == want
    assert got[0]["records"] == [(True, 2, "serve"), (True, 3, "serve"),
                                 (True, 4, "serve"), (False, 5, "serve"),
                                 (False, 1, "serve")]
    assert got[0]["counters"] == {"accl_overlapped_calls_total|allreduce": 3}


def test_unported_plane_sections_hold_off_values(port4):
    """(Was §C: the arbiter's sections held the values of a plane that is
    off.)  After the same calls, the snapshot's ``tenants`` (the arbiter,
    armed, one guaranteed tenant with a window share of 2 and a ring
    budget of 3) equals ``xla_group``'s but for the wait and latency
    times, and so do the engine report's ``tenants`` mirror and its
    ``inflight`` counters; the fault, contract, membership and
    postmortem sections hold the JAX gang's live values (``faults`` None
    on both)."""
    timed = ("grant_wait_ns_total", "latency", "throttle_ns_total")

    def run(group):
        for a in group:
            a.set_arbiter(True)
        run_parallel(group, lambda a, r: a.set_tenant_class(
            "guaranteed", name="serve"))
        run_parallel(group, lambda a, r: a.set_tenant_quota(
            window_share=2, ring_slots=3))
        jax_tests._exercise(group)
        snap = group[0].telemetry_snapshot()
        tenants = snap["tenants"]
        for t in tenants["tenants"].values():
            for k in timed:
                t.pop(k)
        inflight = {k: v for k, v in snap["engine"]["inflight"].items()
                    if k not in ("max_depth_seen", "overlap_ns_total")}
        return snap, tenants, inflight

    jg = xla_group(P)
    try:
        want, want_tenants, want_inflight = run(jg)
    finally:
        _deinit(jg)
    snap, tenants, inflight = run(port4)
    assert tenants == want_tenants
    assert tenants["tenants"]["0"]["admitted"] == P
    assert tenants["tenants"]["0"]["outstanding"] == 0
    assert snap["engine"]["tenants"] == want["engine"]["tenants"] == {
        "0": {"class": 0.0, "window_share": 2.0, "ring_slots": 3.0}}
    assert inflight == want_inflight
    assert inflight["key_depths"] == {0: 2}
    assert snap["engine"]["cmdring"]["slot_budgets"] == \
        want["engine"]["cmdring"]["slot_budgets"] == {"0": 3}
    assert snap["contract"] == want["contract"] == {"enabled": False}
    assert snap["postmortem"] == want["postmortem"]
    assert snap["faults"] is None and snap["engine"]["faults"] is None
    assert snap["health"] == want["health"]
    assert snap["health_events"] == want["health_events"]
    assert snap["membership"] == want["membership"]
    assert snap["wire_trace"]["events"] == [] or all(
        ev["src"] for ev in snap["wire_trace"]["events"])


def test_rooted_record_algorithm_names_the_table_register(port4):
    """§C: a rooted call's record names its algorithm register as the
    gang's table holds it: the port's table holds every register's
    default (``xla``), where JAX's gang holds no rooted register until
    one is written and records None."""
    buf = [a.create_buffer_from(np.ones(N, np.float32)) for a in port4]
    run_parallel(port4, lambda a, r: a.bcast(buf[r], N, root=0))
    rec = port4[0].telemetry_snapshot()["flight_recorder"][-1]
    assert rec["op"] == "bcast" and rec["algorithm"] == "xla"


def test_window_log_covers_every_completion_path(port4):
    """Each window is logged once, whichever way it completed: inline,
    through a run (the CPU's run thread, with its mailbox timestamps),
    or failed."""
    ring = port4[0].engine.gang.cmdring
    ring.linger_s = 0.5
    send = [a.create_buffer_from(np.full(N, r + 1.0, np.float32))
            for r, a in enumerate(port4)]
    outs = [[a.create_buffer(N, np.float32) for _ in range(2)]
            for a in port4]

    def stream(a, r):
        reqs = []
        a.begin_batch()
        try:
            for _ in range(3):
                reqs += [a.allreduce(send[r], d, run_async=True)
                         for d in outs[r]]
                a._dispatch_pending()
        finally:
            a.end_batch()
        for q in reqs:
            assert q.wait(30)
            q.check()

    run_parallel(port4, stream)
    log = ring.window_log()
    assert len(log) == ring.stats()["windows_logged"] == 3
    assert [w["form"] for w in log] == ["inline", "mailbox", "mailbox"]
    for w in log[1:]:
        assert set(w["mailbox_us"]) == {"posted_us", "pulled_us",
                                        "pushed_us"}
    assert all(s["retcode"] == 1 for w in log for s in w["slots"])
    hist = ring.stats()["window_latency_log2_us"]
    assert sum(hist.values()) == 3
    # a failed window is logged once, with its error
    from accl_tpu_torch.backends.cuda.cmdring import _Window

    dead = _Window(99, [], [], [], [], time.perf_counter_ns(), [0])
    ring._fail(dead, "boom")
    ring._fail(dead, "boom")
    assert ring.window_log()[-1]["error"] == "boom"
    assert ring.stats()["windows_logged"] == 4
    events = ring.trace_events()
    assert sum(e.get("ph") == "t" for e in events) == 6  # a slot each


def test_card_run_window_times_its_post_alone():
    """§C: a card run pulls and pushes on the device, where the host
    reads no clock, so its mailbox records a window's post time alone."""
    from accl_tpu_torch.backends.cuda.cmdring import _DeviceMailbox

    class Run:  # the host side of a PersistentRun
        run_windows, linger_s = 16, 0.002

        def post(self, slots, xs, outs):
            return 0

    mbox = _DeviceMailbox(Run())
    assert mbox.post(7, None, ([], []))
    timing = mbox.take_timing(7)
    assert set(timing) == {"posted_ns"} and timing["posted_ns"] > 0
    assert mbox.take_timing(7) is None  # taken once
