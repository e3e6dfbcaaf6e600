"""The PyTorch port's QoS arbiter plane (``accl_tpu_torch.arbiter``, the
facade's admission gate, the gang's window shares and the command ring's
slot budgets) against the JAX package's.

* ``tests/test_arbiter.py``'s unit tests, unedited, with the port's
  classes and functions in place of JAX's (``:41-200``, ``:241``, and
  the KV ledger ``:942-993``);
* its facade tests (``:204``, ``:315-437``) on ``cuda_group(2,
  device="cpu")`` in place of ``emulated_group``: none of them reaches
  the emulated fabric;
* its gang tests (``:460``, ``:506``, ``:695``) on the port's gang in
  place of ``xla_group``;
* differential scenarios: the same calls on ``xla_group(2)`` and the
  port's gang give equal admission decisions, tenant snapshots (times
  excluded), engine mirrors, ring budgets and window counters.

The cases tied to the emulated fabric or its fault plans (``:568``,
``:814``, ``:1062``) wait for the port's host tiers (ROADMAP A12).
"""

import json
import urllib.request

import numpy as np
import pytest

import accl_tpu.arbiter as jarb
import accl_tpu.contract as jcontract
import accl_tpu.overlap as joverlap
import test_arbiter as jtests
from accl_tpu.core import xla_group
from helpers import run_parallel

import accl_tpu_torch as at
import accl_tpu_torch.arbiter as tarb
import accl_tpu_torch.contract as tcontract
import accl_tpu_torch.overlap as toverlap


def _deinit(group):
    for a in group:
        a.deinit()


def _port_group(n):
    return at.cuda_group(n, device="cpu")


# ---------------------------------------------------------------------------
# the reference's own tests, unedited, on the port
# ---------------------------------------------------------------------------

UNIT_TESTS = [
    "test_tenant_class_coercion_and_weights",
    "test_token_bucket_deterministic_clock",
    "test_hist_p99_estimator",
    "test_admission_decision_latched_per_seq",
    "test_outstanding_backpressure_flooder_queues",
    "test_bounded_wait_over_admits_instead_of_wedging",
    "test_drr_shares_track_weights_under_saturation",
    "test_disarmed_is_passthrough",
    "test_inflight_window_per_key_depth",
    "test_kv_tenant_exchange_rendezvous_and_sweep",
    "test_kv_tenant_exchange_skips_stale_self_and_gaps",
    "test_ledger_fabric_shares_adversarial_pair_soak",
]


@pytest.mark.parametrize("name", UNIT_TESTS)
def test_jax_arbiter_units_on_the_port(monkeypatch, name):
    """``tests/test_arbiter.py``'s unit tests with the port's arbiter,
    window and KV exchange in place of JAX's (the module's names, and
    the ones its tests import inside)."""
    for attr in ("CLASS_WEIGHTS", "QosArbiter", "TenantClass", "TokenBucket",
                 "coerce_class", "hist_p99_us"):
        monkeypatch.setattr(jtests, attr, getattr(tarb, attr))
    monkeypatch.setattr(jarb, "TenantLedger", tarb.TenantLedger)
    monkeypatch.setattr(joverlap, "InflightWindow", toverlap.InflightWindow)
    monkeypatch.setattr(jcontract, "kv_tenant_exchange",
                        tcontract.kv_tenant_exchange)
    getattr(jtests, name)()


FACADE_TESTS = [
    "test_admission_slot_released_when_dispatch_raises",
    "test_facade_registration_and_engine_mirror",
    "test_facade_admission_counters_and_latency",
    "test_tenants_route_and_index_summary",
    "test_soft_reset_clears_ledger_keeps_registration",
    "test_disarmed_facade_is_unobservable",
]

GANG_TESTS = [
    "test_gang_quotas_window_share_and_ring_budget",
    "test_gang_two_tenant_ring_shares_match_quotas",
    "test_gang_flooder_absorbs_backpressure_serve_tail_bounded",
]


@pytest.mark.parametrize("name", FACADE_TESTS + GANG_TESTS)
def test_jax_arbiter_facade_and_gang_tests_on_the_port(monkeypatch, name):
    """``tests/test_arbiter.py``'s facade and gang tests on the port's
    gang in place of ``emulated_group`` / ``xla_group`` (the registry and
    its engine mirror, admission counters and latency, the ``/tenants``
    route, ``soft_reset``, the window share and ring budget, two tenants'
    ring shares, and the flooder that absorbs the backpressure).  The
    last asserts the guaranteed tenant's p99 at 65,536 us (a log2 bucket
    edge) beside the admission counters."""
    monkeypatch.setattr(jtests, "emulated_group", _port_group)
    monkeypatch.setattr(jtests, "xla_group", _port_group)
    monkeypatch.setattr(jtests, "ACCLError", at.ACCLError)
    for attr in ("QosArbiter", "TenantClass"):
        monkeypatch.setattr(jtests, attr, getattr(tarb, attr))
    getattr(jtests, name)()


def test_arbiter_and_overlap_import_nothing_of_jax():
    """The two modules import the standard library and the port's own
    constants and contract only."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import accl_tpu_torch.arbiter, accl_tpu_torch.overlap\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'accl_tpu' or "
            "m.startswith('accl_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout


# ---------------------------------------------------------------------------
# differential scenarios: the port's gang against xla_group(2)
# ---------------------------------------------------------------------------

#: a tenant snapshot's fields that hold wall-clock times, or peaks that
#: hang on how the ranks' threads interleave (on either package's gang)
TIMED = ("grant_wait_ns_total", "throttle_ns_total", "latency", "rate",
         "outstanding_peak", "queued_peak")


def _scrub(snap: dict) -> dict:
    out = dict(snap, tenants={})
    for cid, t in snap["tenants"].items():
        out["tenants"][cid] = {k: v for k, v in t.items() if k not in TIMED}
        out["tenants"][cid]["latency_count"] = t["latency"]["count"]
        out["tenants"][cid]["rate_bytes_s"] = (
            None if t["rate"] is None else t["rate"]["rate_bytes_s"])
    return out


def _scenario(group, batched: bool):
    """Two tenants: the world GUARANTEED with a bytes/s cap, a
    sub-communicator BEST_EFFORT with a window share of 1 and a ring
    budget of 2; synchronous calls on both, async bursts, and (when
    ``batched``) a batch of 5 on each.  Returns what must agree."""
    for a in group:
        a.set_arbiter(True)
    subs = run_parallel(group, lambda a, r: a.create_communicator([0, 1]))
    n = 256
    rows = np.random.default_rng(11).standard_normal((2, n)).astype(
        np.float32)
    send = [a.create_buffer_from(rows[r].copy()) for r, a in enumerate(group)]
    out = [a.create_buffer(n, np.float32) for a in group]
    bulk = [a.create_buffer(n, np.float32) for a in group]

    def register(a, r):
        a.set_tenant_class("guaranteed", name="serve")
        a.set_tenant_quota(bytes_per_s=512 * 1024)
        a.set_tenant_class("best_effort", comm=subs[r], name="bulk",
                           weight=2)
        a.set_tenant_quota(comm=subs[r], window_share=1, ring_slots=2)

    run_parallel(group, register)

    def work(a, r):
        for _ in range(3):
            a.allreduce(send[r], out[r], n)
            a.allreduce(send[r], bulk[r], n, comm=subs[r])
        reqs = [a.allreduce(send[r], bulk[r], n, comm=subs[r],
                            run_async=True) for _ in range(3)]
        reqs += [a.allgather(send[r], out[r], n // 2, run_async=True)]
        for q in reqs:
            assert q.wait(60)
            q.check()
        if batched:
            with a.batch():
                qs = [a.allreduce(send[r], out[r], n, run_async=True)
                      for _ in range(5)]
            with a.batch():
                qs += [a.allreduce(send[r], bulk[r], n, comm=subs[r],
                                   run_async=True) for _ in range(5)]
            for q in qs:
                assert q.wait(60)
                q.check()
        a.barrier()

    run_parallel(group, work, timeout=120)
    for a in group:
        a.flush()
    arb = group[0]._arbiter
    ring = group[0].engine.gang.cmdring.stats()
    window = group[0].engine.gang.window.stats()
    return {
        "tenants": _scrub(group[0].telemetry_snapshot()["tenants"]),
        "decisions": sorted(
            (k, v["class"], v["tenant"], v["throttle_ns"] > 0)
            for k, v in arb._decisions.items()),
        "mirror": [a.engine.telemetry_report()["tenants"] for a in group],
        "ring": {k: ring[k] for k in ("slot_budgets", "comm_slots",
                                      "budgeted_windows", "max_window",
                                      "refills")},
        "window": {k: window[k] for k in (
            "depth", "key_depths", "in_flight", "launched", "completed",
            "failed", "ring_launched", "ring_completed")},
        # per communicator, in completion order (two communicators'
        # windows complete independently of each other)
        "records": [_by_comm(a.telemetry_snapshot()["flight_recorder"])
                    for a in group],
        "out": [np.asarray(b.device_view()[:n]).copy() for b in out + bulk],
    }


def _by_comm(records) -> dict:
    out: dict = {}
    for rec in records:
        out.setdefault(rec["comm"], []).append((rec["op"], rec.get("tenant")))
    return out


@pytest.mark.parametrize("batched", [False, True])
def test_admissions_snapshots_and_budgets_equal_jax(batched):
    """Decisions (class, tenant, throttle per (comm, call index)), the
    tenants snapshot (admitted, completed, outstanding 0, queued, weights,
    shares, budgets, caps), the engines' mirrors, the ring's
    ``slot_budgets`` / ``comm_slots`` / ``budgeted_windows`` and the
    window's counters equal ``xla_group(2)``'s on the same calls."""
    jg = xla_group(2)
    try:
        want = _scenario(jg, batched)
    finally:
        _deinit(jg)
    tg = _port_group(2)
    try:
        got = _scenario(tg, batched)
    finally:
        _deinit(tg)
    for key in ("tenants", "decisions", "mirror", "ring", "window",
                "records"):
        assert got[key] == want[key], key
    for g_, w_ in zip(got["out"], want["out"]):
        np.testing.assert_allclose(g_, w_, rtol=1e-6, atol=1e-6)
    serve, bulk = (got["tenants"]["tenants"][k] for k in sorted(
        got["tenants"]["tenants"], key=int))
    assert serve["outstanding"] == bulk["outstanding"] == 0
    assert serve["admitted"] == serve["completed"]
    assert bulk["window_share"] == 1 and bulk["ring_slots"] == 2
    assert got["window"]["in_flight"] == 0
    if batched:
        assert got["ring"]["budgeted_windows"] == 3  # 5 slots as 2 + 2 + 1
        assert got["ring"]["slot_budgets"] == {str(bulk["comm"]): 2}


def test_flooder_admission_order_is_deterministic():
    """The fairness mechanism with no clock in it: a BEST_EFFORT tenant
    held to one outstanding admission a rank queues its surplus at the
    arbiter while the GUARANTEED tenant's calls pass at once.  Asserted
    on counters and admission order (which tenant was granted when),
    never on a latency, so it holds under any load."""
    g = _port_group(2)
    try:
        subs = run_parallel(g, lambda a, r: a.create_communicator([0, 1]))
        for a in g:
            a.set_arbiter(True)

        def register(a, r):
            a.set_tenant_class("guaranteed", name="serve")
            a.set_tenant_class("best_effort", comm=subs[r], name="bulk")
            a.set_tenant_quota(comm=subs[r], window_share=1)

        run_parallel(g, register)
        arb = g[0]._arbiter
        window = g[0].engine.gang.window
        import threading

        hold = threading.Event()
        # the bulk comm's calls held in flight behind a parked entry (the
        # window's depth for the comm widened past it, the arbiter's share
        # left at 1): a rank's first bulk call stays outstanding, so its
        # next admission must queue at the arbiter
        window.set_key_depth(subs[0].id, 8)
        window.park(subs[0].id, lambda: hold.wait(30), lambda *_: None,
                    lambda _e: None)
        n = 1 << 12
        fs = [a.create_buffer_from(np.ones(n, np.float32)) for a in g]
        fr = [a.create_buffer(n, np.float32) for a in g]
        gs = [a.create_buffer_from(np.ones(64, np.float32)) for a in g]
        gr = [a.create_buffer(64, np.float32) for a in g]
        flood_reqs = [[], []]

        def flood(a, r):
            for _ in range(3):
                flood_reqs[r].append(a.allreduce(
                    fs[r], fr[r], n, comm=subs[r], run_async=True))

        threads = [threading.Thread(target=flood, args=(a, r))
                   for r, a in enumerate(g)]
        for t in threads:
            t.start()
        bulk = arb.tenant(subs[0].id)
        for _ in range(500):  # each rank's second call reaches the queue
            if bulk.queued() == 2:
                break
            hold.wait(0.01)
        assert bulk.in_flight() == 2 and bulk.queued() == 2
        # the guaranteed tenant is granted while the flooder queues
        run_parallel(g, lambda a, r: a.allreduce(gs[r], gr[r], 64))
        snap = arb.snapshot()["tenants"]
        assert snap["0"]["admitted"] == 2 and snap["0"]["outstanding"] == 0
        assert snap[str(subs[0].id)]["admitted"] == 2
        hold.set()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        for qs in flood_reqs:
            for q in qs:
                assert q.wait(60)
                q.check()
        for a in g:
            a.flush()
        snap = arb.snapshot()
        bulk_t = snap["tenants"][str(subs[0].id)]
        assert bulk_t["admitted"] == 6 and bulk_t["outstanding"] == 0
        assert bulk_t["queued_peak"] == 2 and bulk_t["over_admissions"] == 0
        assert snap["grant_timeouts"] == 0
        np.testing.assert_array_equal(np.asarray(fr[0].device_view()[:n]),
                                      np.full(n, 2.0))
    finally:
        _deinit(g)


def test_tenants_route_serves_the_snapshot():
    """The monitor's ``/tenants`` is the arbiter's snapshot, and the
    index carries one line a tenant."""
    g = _port_group(2)
    try:
        for a in g:
            a.set_arbiter(True)
        run_parallel(g, lambda a, r: a.set_tenant_class("burst", name="jobs"))
        s = [a.create_buffer_from(np.ones(32, np.float32)) for a in g]
        d = [a.create_buffer(32, np.float32) for a in g]
        run_parallel(g, lambda a, r: a.allreduce(s[r], d[r], 32))
        port = g[0].start_monitor(0)
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/tenants", timeout=10).read().decode())
        assert doc == json.loads(json.dumps(g[0]._arbiter.snapshot()))
        assert doc["tenants"]["0"]["admitted"] == 2
        assert doc["tenants"]["0"]["outstanding"] == 0
        advice = g[0].telemetry_snapshot()["membership"]["scale_advice"]
        assert advice is not None and "hot_tenants" in advice
    finally:
        g[0].stop_monitor()
        _deinit(g)


def test_arbiter_is_shared_by_the_gang_and_ledger_is_local():
    """Every rank handle of a group shares one arbiter (the gang is the
    anchor); a second group gets its own.  The gang has no KV plane, so
    ``ACCL_ARBITER_LEDGER`` attaches no ledger and the facade's exchange
    is None (the multi-process tier, ROADMAP A6)."""
    import os

    g, h = _port_group(2), _port_group(2)
    old = os.environ.get("ACCL_ARBITER_LEDGER")
    try:
        assert g[0]._arbiter is g[1]._arbiter
        assert g[0]._arbiter is not h[0]._arbiter
        os.environ["ACCL_ARBITER_LEDGER"] = "1"
        k = _port_group(2)
        try:
            assert k[0]._arbiter.ledger is None
            assert k[0].arbiter_ledger_exchange() is None
        finally:
            _deinit(k)
    finally:
        if old is None:
            os.environ.pop("ACCL_ARBITER_LEDGER", None)
        else:
            os.environ["ACCL_ARBITER_LEDGER"] = old
        _deinit(g)
        _deinit(h)


def test_tenant_config_validator_equals_jax():
    """The one validator every tier applies: the port's accepts and
    refuses exactly what JAX's does, and a refused write is CONFIG_ERROR
    on the port's gang as on JAX's."""
    from accl_tpu.constants import ConfigFunction as JCF

    from accl_tpu_torch.constants import ConfigFunction as TCF

    for fn in (9, 10, 11, 12, 13):
        for val in (-1, 0, 1, 2, 3, 8, 64, 65, 1e9):
            assert tarb.tenant_config_valid(TCF(fn), val) == \
                jarb.tenant_config_valid(JCF(fn), val), (fn, val)
            assert tarb.tenant_config_field(TCF(fn)) == \
                jarb.tenant_config_field(JCF(fn))
    g = _port_group(2)
    try:
        with pytest.raises(at.ACCLError) as e:
            g[0]._config(TCF.SET_TENANT_WINDOW_SHARE, 65, key=0)
        assert e.value.code & at.ErrorCode.CONFIG_ERROR
        with pytest.raises(at.ACCLError) as e:
            g[0].set_inflight_window(0)
        assert e.value.code & at.ErrorCode.CONFIG_ERROR
    finally:
        _deinit(g)
