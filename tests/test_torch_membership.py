"""The PyTorch port's membership plane (``accl_tpu_torch.membership``, the
communicator cutovers, the ring's circuit breaker and the facade's
elastic surface) against the JAX package's.

* the pure module: ``CircuitBreaker``'s state machine, ``DemotionLedger``'s
  decisions, ``MembershipBoard``'s majority and join petition and the
  environment readers on the same seeded inputs, and
  ``tests/test_membership.py``'s own unit tests, unedited, with the port's
  classes in place of JAX's;
* ``Communicator.shrink`` / ``grow`` / ``restore`` round trips (with a
  topology) and the residual store's epoch migration;
* the gang, as differential twins of ``tests/test_membership.py:592`` (the
  ring breaker) and ``:657`` (kill -> shrink -> serve -> restore), plus the
  operator's ``evict_rank``, ``suggest_root`` and the join half on the
  port (``evict_rank`` -> serve -> ``join_rank`` -> serve: JAX's gang
  keeps the old sequence numbering at a cutover, so its joined call times
  out, ROADMAP §C);
* the snapshot's sections and the monitor's ``/membership`` route.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import accl_tpu.communicator as jcomm
import accl_tpu.membership as jm
import test_membership as jtests
from accl_tpu import ACCLError as JACCLError
from accl_tpu.core import xla_group
from accl_tpu.topology import Topology as JTopology
from helpers import run_parallel

import accl_tpu_torch as at
import accl_tpu_torch.communicator as tcomm
import accl_tpu_torch.membership as tm
from accl_tpu_torch.errorfeedback import MAX_MIGRATIONS, ResidualStore
from accl_tpu_torch.topology import Topology as TTopology

ERRORS = (JACCLError, at.ACCLError)


def _deinit(group):
    for a in group:
        a.deinit()


# ---------------------------------------------------------------------------
# the pure module
# ---------------------------------------------------------------------------

def _breaker_trace(mod, seed):
    rng = np.random.default_rng(seed)
    now = [0.0]
    brk = mod.CircuitBreaker(threshold=2, cooldown_s=1.5,
                             clock=lambda: now[0])
    out = []
    for _ in range(60):
        now[0] += float(rng.uniform(0.0, 0.8))
        step = int(rng.integers(0, 3))
        if step == 0:
            out.append(("allow", brk.allow()))
        elif step == 1:
            out.append(("fail", brk.record_failure(
                ["TimeoutError", "dispatch_error"][int(rng.integers(0, 2))])))
        else:
            out.append(("ok", brk.success()))
    return out, brk.snapshot()


@pytest.mark.parametrize("seed", [0, 7])
def test_circuit_breaker_equals_jax(seed):
    assert _breaker_trace(tm, seed) == _breaker_trace(jm, seed)
    assert (tm.CircuitBreaker.OPEN, tm.CircuitBreaker.HALF_OPEN) == (
        jm.CircuitBreaker.OPEN, jm.CircuitBreaker.HALF_OPEN)


def _ledger_trace(mod, seed):
    rng = np.random.default_rng(seed)
    now = [0.0]
    led = mod.DemotionLedger(cooldown_s=2.0, clock=lambda: now[0])
    out = []
    for seq in range(40):
        now[0] += float(rng.uniform(0.0, 1.0))
        slow = sorted({int(r) for r in rng.integers(0, 4, size=int(
            rng.integers(0, 2)))})
        recovered = {r: bool(rng.integers(0, 2)) for r in range(4)}
        out.append(led.decide(3, 4, seq, slow, recovered))
        out.append(sorted(led.candidates(3)))
        out.append(led.demoted(3))
    return out, led.snapshot()


@pytest.mark.parametrize("seed", [1, 2])
def test_demotion_ledger_equals_jax(seed):
    assert _ledger_trace(tm, seed) == _ledger_trace(jm, seed)


def test_membership_board_and_petition_equal_jax():
    def trace(mod):
        board = mod.MembershipBoard()
        events = []
        board.add_listener(events.append)
        out = [board.post(0, frozenset({3}), rank=r, world=5)
               for r in (3, 1, 4, 0, 2)]
        board.petition(frozenset({3}), world=5)
        out += [board.post_join(1, frozenset({3}), rank=r, world=5,
                                excluded=frozenset({3}),
                                handoff={"trace_gen": r})
                for r in (3, 0, 1, 2)]
        out.append(board.standing(1))
        return out, [{k: v for k, v in e.items() if k != "plan"}
                     for e in events]

    assert trace(tm) == trace(jm)


def test_env_readers_and_payload_equal_jax(monkeypatch):
    for env in ({}, {"ACCL_ELASTIC": "1"}, {"ACCL_ELASTIC": "0"}):
        assert tm.env_elastic(env) == jm.env_elastic(env)
    for name, val in (("ACCL_EVICT_CONFIRM_S", "2.5"),
                      ("ACCL_JOIN_CONFIRM_S", "junk")):
        monkeypatch.setenv(name, val)
    assert (tm.env_confirm_s(), tm.env_join_s()) == (
        jm.env_confirm_s(), jm.env_join_s())
    for raw in (b'{"epoch": 1}', b"\xff", b"[1, 2]"):
        assert tm.member_payload(raw) == jm.member_payload(raw)


@pytest.mark.parametrize("name", [
    "test_circuit_breaker_state_machine",
    "test_membership_board_majority_and_evicted_votes",
    "test_wire_agreement_seconding_and_confirm",
    "test_board_majority_over_remaining_survivors",
    "test_demotion_decision_latched_per_seq",
    "test_membership_board_join_petition_and_majority",
    "test_wire_join_agreement_three_phase",
    "test_wire_join_lost_confirm_resends",
])
def test_jax_membership_units_on_the_port(monkeypatch, name):
    """``tests/test_membership.py``'s unit tests, unedited, with the
    port's classes in place of JAX's."""
    for attr in ("CircuitBreaker", "DemotionLedger", "MembershipBoard",
                 "MembershipView"):
        monkeypatch.setattr(jtests, attr, getattr(tm, attr))
    getattr(jtests, name)()


# ---------------------------------------------------------------------------
# communicator cutovers and the residual store
# ---------------------------------------------------------------------------

def _cutovers(mod, topo_cls):
    ranks = [mod.Rank(address=f"x:{i}", session=i) for i in range(6)]
    c = mod.Communicator(ranks, 2, comm_id=9)
    c.topology = topo_cls([[0, 1, 2], [3, 4, 5]])

    def view():
        return (c.size, c.local_rank, [r.session for r in c.ranks],
                c.shrunk, None if c.topology is None
                else c.topology.signature())

    out = [view()]
    out.append(c.shrink([0, 2, 3, 5]))
    out.append(view())
    out.append(c.shrink([0, 1, 3]))
    out.append(view())
    out.append(c.grow({4}))
    out.append(view())
    out.append(c.restore())
    out.append(view())
    out.append(c.restore())
    out.append(c.grow({2}))  # identity: the candidate's own re-key
    out.append(c.grow({8}, rank_info={8: mod.Rank(address="x:8",
                                                  session=8)}))
    out.append(view())
    other = mod.Communicator(ranks, 1, comm_id=10)
    out.append(other.shrink([0, 2]))
    with pytest.raises(ValueError):
        c.grow({11})
    return out


def test_communicator_cutovers_equal_jax():
    """shrink / grow / restore translations, sizes, local ranks,
    sessions and the topology carried through them, step by step."""
    assert _cutovers(tcomm, TTopology) == _cutovers(jcomm, JTopology)


def test_cutovers_start_fresh_epochs():
    ranks = [tcomm.Rank(address=f"x:{i}", session=i) for i in range(3)]
    c = tcomm.Communicator(ranks, 0)
    seen = {c.epoch}
    c.next_outbound_seq(1)
    for step in (lambda: c.shrink([0, 1]), lambda: c.grow({2}),
                 lambda: c.shrink([0, 2]), c.restore):
        step()
        assert c.epoch not in seen
        seen.add(c.epoch)
        assert c.as_dict()["ranks"][-1]["seq_out"] == 0


def test_residual_store_lazy_epoch_migration():
    """The port's store keeps JAX's migration rules: a join's mapping
    re-keys a residual at its first use, chains compose, a
    ``membership_join`` invalidation keeps pending migrations and any
    other reason (or overflow) clears."""
    store = ResidualStore()
    x = torch.linspace(-1.0, 1.0, 64)
    key_old = (9, 100, "allreduce", 64)
    store.apply(key_old, x, at.DataType.INT8)
    r_old = store.residual(key_old)
    assert float(r_old.abs().max()) > 0.0
    store.migrate_epoch(9, 100, 200)
    store.invalidate("membership_join")
    assert store.stats()["pending_migrations"] == 1
    key_new = (9, 200, "allreduce", 64)
    corrected = store.apply(key_new, x, at.DataType.INT8)
    assert torch.allclose(corrected, x + r_old)
    assert store.residual(key_old) is None
    assert store.stats()["migrations"] == 1
    key2 = (9, 200, "reduce_scatter", 32)
    store.apply(key2, x[:32], at.DataType.INT8)
    r2 = store.residual(key2)
    store.migrate_epoch(9, 200, 300)
    store.invalidate("membership_join")
    store.migrate_epoch(9, 300, 400)
    out = store.apply((9, 400, "reduce_scatter", 32), x[:32],
                      at.DataType.INT8)
    assert torch.allclose(out, x[:32] + r2)
    store.invalidate("set_tuning")
    assert store.stats()["entries"] == 0
    assert store.stats()["pending_migrations"] == 0
    for e in range(MAX_MIGRATIONS + 1):
        store.migrate_epoch(1, e, e + 1)
    assert store.stats()["pending_migrations"] == 0


# ---------------------------------------------------------------------------
# the gang: the ring's breaker (tests/test_membership.py:592)
# ---------------------------------------------------------------------------

def _breaker_steps(g):
    ring = g[0].engine.gang.cmdring
    send = [a.create_buffer_from(np.full(32, float(r + 1), np.float32))
            for r, a in enumerate(g)]
    recv = [a.create_buffer(32, np.float32) for a in g]

    def batch_round(a, r):
        with a.batch():
            a.allreduce(send[r], recv[r], 32, run_async=True)
            a.allreduce(send[r], recv[r], 32, run_async=True)

    cid = str(g[0].comm.id)
    run_parallel(g, batch_round, timeout=120.0)
    out = {"engaged": ring.stats()["slots"] > 0}
    base = ring.stats()["slots"]
    brk = ring.breaker_for(g[0].comm.id)
    brk.record_failure("TimeoutError")
    brk.record_failure("TimeoutError")
    out["wedged"] = brk.allow()
    run_parallel(g, batch_round, timeout=120.0)
    st = ring.stats()
    out["open"] = (st["fallbacks"].get("circuit_open", 0), st["slots"] - base,
                   st["breakers"][cid]["state"])
    exact = []
    for r in range(len(g)):
        recv[r].sync_from_device()
        exact.append(recv[r].data.tolist())
    out["exact"] = exact
    time.sleep(0.25)  # cool-down -> half-open
    run_parallel(g, batch_round, timeout=120.0)  # the probe
    st = ring.stats()
    out["probe"] = (st["slots"] > base, st["breakers"][cid]["state"],
                    st["breakers"][cid]["restores_total"])
    opens = st["fallbacks"].get("circuit_open", 0)
    run_parallel(g, batch_round, timeout=120.0)
    out["after"] = ring.stats()["fallbacks"].get("circuit_open", 0) - opens
    return out


def test_ring_breaker_equals_jax(monkeypatch):
    """Open: the batch takes JAX's host path on the CPU (``circuit_open``,
    no slot), exact; after the cool-down the probe rides the ring and
    closes the breaker; no circuit fallback after it."""
    monkeypatch.setenv("ACCL_CMDRING_COOLDOWN_S", "0.2")
    jg, tg = xla_group(2), at.cuda_group(2, device="cpu")
    try:
        want, got = _breaker_steps(jg), _breaker_steps(tg)
        assert tg[0].engine.gang.cmdring.breaker_cooldown_s == 0.2
    finally:
        _deinit(jg + tg)
    assert got == want
    assert got["open"] == (1, 0, "open")
    assert got["probe"] == (True, "closed", 1) and got["after"] == 0
    assert got["exact"] == [[3.0] * 32, [3.0] * 32]


def test_open_breaker_on_the_card_never_takes_the_plain_lowering():
    """On the card the plain fused lowering is no stand-in for a ring
    whose breaker is open: under the ``xla`` registers the batch fails
    at once, INVALID_OPERATION naming ``circuit_open``, and the process
    total counts the refusal; a kernel register sends the batch on to
    that kernel.  The gang's device reads as the card's: the refusal
    comes before any device work."""
    from types import SimpleNamespace

    from accl_tpu_torch.backends.cuda.cmdring import circuit_open_total

    g = at.cuda_group(2, device="cpu")
    gang = g[0].engine.gang
    try:
        brk = gang.cmdring.breaker_for(g[0].comm.id)
        brk.record_failure("TimeoutError")
        brk.record_failure("TimeoutError")
        s = [a.create_buffer_from(np.ones(8, np.float32)) for a in g]
        d = [a.create_buffer(8, np.float32) for a in g]

        def batch_round(a, r):
            with a.batch():
                qs = [a.allreduce(s[r], d[r], 8, run_async=True)
                      for _ in range(2)]
            out = []
            for q in qs:
                assert q.wait(5)
                with pytest.raises(at.ACCLError) as exc:
                    q.check()
                out.append((int(exc.value.code),
                            exc.value.details.get("error")))
            return out

        total = circuit_open_total()
        gang.device = torch.device("cuda")
        assert run_parallel(g, batch_round) == [
            [(int(at.ErrorCode.INVALID_OPERATION), "circuit_open")] * 2] * 2
        assert circuit_open_total() == total + 1
        assert gang.cmdring.stats()["fallbacks"] == {"circuit_open": 1}
        ring_call = SimpleNamespace(effective_tuning=lambda t: {
            "allreduce_algorithm": "pallas_ring"})
        assert not gang._circuit_refused(g[0].comm, [([ring_call], [])])
        gang.device = torch.device("cpu")
        assert not gang._circuit_refused(g[0].comm, [([SimpleNamespace(
            effective_tuning=lambda t: {})], [])])
    finally:
        gang.device = torch.device("cpu")
        _deinit(g)


def test_a_dropped_handle_is_freed_without_a_collection():
    """The planes a handle owns (membership view, black box) and the
    gang it shares (health listener, postmortem registry, ring hook)
    hold it weakly: a deinit'ed, dropped handle is freed by its
    reference count, with no full collection (whose pause stalls the
    host path)."""
    import gc
    import weakref

    g = at.cuda_group(2, device="cpu")
    bufs = [(a.create_buffer_from(np.ones(8, np.float32)),
             a.create_buffer(8, np.float32)) for a in g]
    run_parallel(g, lambda a, r: a.allreduce(*bufs[r]))
    assert g[0]._blackbox is not None
    _deinit(g)
    refs = [weakref.ref(a) for a in g]
    gc.disable()
    try:
        del g, bufs
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_ring_failure_strikes_the_breaker_and_reaches_the_hook():
    """A failed window dispatch is a strike and the facade's postmortem
    hook hears it; soft_reset closes every breaker."""
    g = at.cuda_group(2, device="cpu")
    try:
        ring = g[0].engine.gang.cmdring
        heard = []
        ring.on_failure = lambda c, e: heard.append((c, e))
        orig = ring._dispatch_inline

        def boom(*args, **kwargs):
            raise RuntimeError("launch refused")

        ring._dispatch_inline = boom
        s = [a.create_buffer_from(np.ones(8, np.float32)) for a in g]
        d = [a.create_buffer(8, np.float32) for a in g]

        def batch_round(a, r):
            with a.batch():
                q = a.allreduce(s[r], d[r], 8, run_async=True)
            assert q.wait(30)
            return int(q.get_retcode())

        assert run_parallel(g, batch_round) == [
            int(at.ErrorCode.INVALID_OPERATION)] * 2
        ring._dispatch_inline = orig
        snap = ring.stats()["breakers"][str(g[0].comm.id)]
        assert snap["reasons"] == {"dispatch_error": 1}
        assert heard and heard[0][0] == g[0].comm.id
        run_parallel(g, lambda a, r: a.soft_reset())
        assert ring.stats()["breakers"] == {}
    finally:
        _deinit(g)


# ---------------------------------------------------------------------------
# the gang: kill -> shrink -> serve -> restore (tests/test_membership.py:657)
# ---------------------------------------------------------------------------

def _kill_cycle(g):
    for a in g:
        a.set_elastic(True)
        a.set_timeout(1.0)
    survivors = g[:3]

    def doomed(a, r):
        codes = []
        for _ in range(4):
            s = a.create_buffer_from(np.full(64, r + 1.0, np.float32))
            d = a.create_buffer(64, np.float32)
            try:
                a.allreduce(s, d, 64)
                return codes
            except ERRORS as e:
                codes.append(int(e.code))
                if int(e.code) & int(at.ErrorCode.RANK_EVICTED):
                    return codes
        return codes

    t0 = time.monotonic()
    out = {"codes": run_parallel(survivors, doomed, timeout=40.0)}
    out["shrink_s"] = time.monotonic() - t0
    out["sizes"] = [a.size for a in survivors]
    out["epochs"] = [a._membership.epoch for a in survivors]
    out["exchange"] = survivors[0]._membership.snapshot()["exchange"]
    out["health"] = survivors[0].capabilities()["health"]

    def serve(a, r):
        vals = []
        for _ in range(4):
            s = a.create_buffer_from(np.full(64, r + 1.0, np.float32))
            d = a.create_buffer(64, np.float32)
            a.allreduce(s, d, 64)
            d.sync_from_device()
            vals.append(float(d.data[0]))
        return vals

    out["served"] = run_parallel(survivors, serve, timeout=60.0)
    for a in g:
        a.set_timeout(10.0)
    run_parallel(g, lambda a, r: a.soft_reset(), timeout=60.0)
    out["restored"] = [a.size for a in g]

    def full(a, r):
        s = a.create_buffer_from(np.full(64, r + 1.0, np.float32))
        d = a.create_buffer(64, np.float32)
        a.allreduce(s, d, 64)
        d.sync_from_device()
        return float(d.data[0])

    out["full"] = run_parallel(g, full, timeout=60.0)
    snap = g[0].telemetry_snapshot()
    out["totals"] = (snap["membership"]["evictions_total"],
                     snap["membership"]["restores_total"])
    out["events"] = snap["health_events"]["counters"]
    out["membership_keys"] = sorted(snap["membership"])
    out["caps"] = g[0].capabilities()["membership"]
    return out


def test_gang_kill_shrink_serve_restore_equals_jax():
    jg, tg = xla_group(4), at.cuda_group(4, device="cpu")
    try:
        want, got = _kill_cycle(jg), _kill_cycle(tg)
    finally:
        _deinit(jg + tg)
    for key in ("codes", "sizes", "epochs", "exchange", "health", "served",
                "restored", "full", "totals", "events", "membership_keys",
                "caps"):
        assert got[key] == want[key], key
    for codes in got["codes"]:
        assert codes and codes[-1] & int(at.ErrorCode.RANK_EVICTED)
    assert got["sizes"] == [3, 3, 3] and got["epochs"] == [1, 1, 1]
    assert got["served"] == [[6.0] * 4] * 3
    assert got["restored"] == [4] * 4 and got["full"] == [10.0] * 4
    assert got["totals"] == (1, 1)
    assert got["shrink_s"] < 20.0


def test_evict_join_cycle_on_the_port():
    """The operator evicts a middle rank (the survivors' local ranks
    shift), the group serves at 3, the evicted rank joins back and the
    group serves at 4, with one latched join decision on every rank;
    ``suggest_root`` stays 0 with nothing demoted.  JAX's gang evicts
    alike, but its joined call times out (ROADMAP §C)."""
    g = at.cuda_group(4, device="cpu")
    try:
        for a in g:
            a.set_elastic(True)
            a.set_timeout(5.0)
        survivors = [a for i, a in enumerate(g) if i != 1]

        def serve(a, r):
            me = a.comm.ranks[a.comm.local_rank].session
            s = a.create_buffer_from(np.full(8, me + 1.0, np.float32))
            d = a.create_buffer(8, np.float32)
            a.allreduce(s, d, 8)
            d.sync_from_device()
            return float(d.data[0])

        plans = run_parallel(survivors, lambda a, r: a.evict_rank(1),
                             timeout=30.0)
        assert [p["evict"] for p in plans] == [[1]] * 3
        assert [a.size for a in survivors] == [3, 3, 3]
        assert [a.comm.local_rank for a in survivors] == [0, 1, 2]
        assert run_parallel(survivors, serve) == [8.0] * 3
        with pytest.raises(at.ACCLError) as exc:
            g[1].evict_rank(1)
        assert exc.value.code == at.ErrorCode.RANK_EVICTED

        def rejoin(a, r):
            if r == 1:
                plan = a.join_rank(timeout=20.0)
                assert plan is not None and plan["kind"] == "join"
            else:
                deadline = time.monotonic() + 20.0
                while not (a._membership.cutover_ready()
                           or a._membership.joins_total):
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
            return serve(a, r)

        assert run_parallel(g, rejoin, timeout=60.0) == [10.0] * 4
        assert [a.size for a in g] == [4] * 4
        decisions = [a.join_decision() for a in g]
        assert all(d == decisions[0] for d in decisions)
        assert decisions[0]["admitted"] == [1] and decisions[0]["world"] == 4
        assert [a.suggest_root() for a in g] == [0] * 4
        g[0].set_elastic(False)
        with pytest.raises(at.ACCLError) as exc:
            g[0].join_rank(timeout=0.1)  # a join needs elastic membership
        assert exc.value.code == at.ErrorCode.INVALID_OPERATION
    finally:
        _deinit(g)


def test_membership_route_and_snapshot_sections():
    """The monitor serves ``/membership`` (the machine and the scale
    advice), the index names it, and the snapshot's contract,
    membership, health, health-event and postmortem sections carry the
    JAX facade's keys."""
    jg, tg = xla_group(2), at.cuda_group(2, device="cpu")
    try:
        port = tg[0].start_monitor(port=0)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/membership", timeout=10) as r:
            doc = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as r:
            index = r.read().decode()
        assert doc["epoch"] == 0 and doc["exchange"] == "board"
        assert doc["scale_advice"] == jg[0]._membership_report()[
            "scale_advice"]
        assert "/membership" in index and "membership: epoch=0" in index
        tg[0].stop_monitor()
        js, ts = jg[0].telemetry_snapshot(), tg[0].telemetry_snapshot()
        for key in ("membership", "health_events", "postmortem",
                    "contract"):
            assert set(ts[key]) == set(js[key]), key
        assert ts["health"] == js["health"]
        assert ts["membership"]["scale_advice"] == js["membership"][
            "scale_advice"]
    finally:
        _deinit(jg + tg)
