"""The PyTorch port's fault plane (``accl_tpu_torch.faults`` and the gang's
slot watchdog, health map and ``soft_reset``) against the JAX package's.

* the pure module: ``FaultPlan``'s JSON and environment round trips across
  the two packages, the injector's verdicts, log and corruption bytes for
  one seed, ``HealthTransitions`` and ``SeqnLedger``;
* the gang, as differential twins of ``tests/test_failure_paths.py``'s gang
  tests (``:208`` the watchdog, ``:228`` soft_reset, ``:267`` health and
  fail-fast): the same steps on ``xla_group`` and ``cuda_group(...,
  device="cpu")``, with equal codes, ``details``, health maps and results;
* the gang's order of execution across a reaped slot (a port mechanism:
  JAX's gang does not order);
* the command ring's chaos hook on fused windows (``tests/test_cmdring.py``
  ``:1572`` corrupt, ``:1609`` delay), each plan installed on both
  packages' ``contract.install_fault_plan``, and that file's own
  ``soft_reset`` tests (``:230``, ``:1112``) unedited on the port's group.
"""

import threading
import time

import numpy as np
import pytest

import accl_tpu.contract as jcontract
import accl_tpu.faults as jf
from accl_tpu import ACCLError as JACCLError
from accl_tpu.core import xla_group
from helpers import run_parallel

import accl_tpu_torch as at
import accl_tpu_torch.contract as tcontract
import accl_tpu_torch.faults as tf

ERRORS = (JACCLError, at.ACCLError)


def _deinit(group):
    for a in group:
        a.deinit()


def _groups(n):
    return xla_group(n), at.cuda_group(n, device="cpu")


def _drive(group, work, timeout=60.0):
    """One thread per rank handle; returns ({rank: error}, seconds)."""
    errs = {}

    def runner(a, rank):
        try:
            work(a, rank)
        except ERRORS as e:
            errs[rank] = e

    threads = [threading.Thread(target=runner, args=(a, i), daemon=True)
               for i, a in enumerate(group)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert all(not t.is_alive() for t in threads), "rank thread hung"
    return errs, time.monotonic() - t0


# ---------------------------------------------------------------------------
# the pure module
# ---------------------------------------------------------------------------

RULES = [
    dict(action="drop", msg_type="EAGER", src=1, dst=0, nth=2, count=3),
    dict(action="delay", delay_s=0.25, tag=7),
    dict(action="kill_rank", rank=2, nth=0),
    dict(action="partition", groups=[[0, 1], [2, 3]], comm=0,
         heal_after=2),
    dict(action="diverge", rank=1, nth=2, count=1),
    dict(action="corrupt", msg_type="RING", count=2),
]


def test_fault_plan_json_round_trips_across_packages():
    tplan = tf.FaultPlan([tf.FaultRule(**r) for r in RULES], seed=99)
    jplan = jf.FaultPlan([jf.FaultRule(**r) for r in RULES], seed=99)
    assert tplan.to_json() == jplan.to_json()
    assert jf.FaultPlan.from_json(tplan.to_json()).to_json() == (
        jplan.to_json())
    assert tf.FaultPlan.from_json(jplan.to_json()).to_json() == (
        tplan.to_json())


def test_fault_plan_env_round_trip_across_packages():
    assert tf.FAULT_PLAN_ENV == jf.FAULT_PLAN_ENV
    tplan = tf.FaultPlan([tf.FaultRule(**r) for r in RULES], seed=5)
    env = {tf.FAULT_PLAN_ENV: tplan.to_json()}
    assert jf.FaultPlan.from_env(env).to_json() == tplan.to_json()
    assert tf.FaultPlan.from_env({}) is None
    assert [a.value for a in tf.FaultAction] == [
        a.value for a in jf.FaultAction]


def test_rule_validation_equals_jax():
    for bad in (dict(action="kill_rank"), dict(action="diverge"),
                dict(action="partition"),
                dict(action="delay", heal_after=1),
                dict(action="drop", heal_after=0)):
        with pytest.raises(ValueError):
            jf.FaultRule(**bad)
        with pytest.raises(ValueError):
            tf.FaultRule(**bad)


class _Msg:
    """A wire message as the injector reads it."""

    class _T:
        def __init__(self, name):
            self.name = name

        def __int__(self):
            return {"EAGER": 1, "RING": -1}.get(self.name, 2)

    def __init__(self, comm_id, src, dst, tag, msg_type, seqn):
        self.comm_id, self.src, self.dst, self.tag = comm_id, src, dst, tag
        self.msg_type = self._T(msg_type)
        self.seqn = seqn


def _replay(mod, seed):
    rng = np.random.default_rng(seed)
    plan = mod.FaultPlan([mod.FaultRule(**r) for r in RULES], seed=seed)
    inj = mod.FaultInjector(plan)
    verdicts, masks, corrupt = [], [], []
    for seqn in range(64):
        msg = _Msg(int(rng.integers(0, 2)), int(rng.integers(0, 4)),
                   int(rng.integers(0, 4)), int(rng.integers(0, 9)),
                   ["EAGER", "RING", "OTHER"][int(rng.integers(0, 3))],
                   seqn)
        v = inj.on_send(msg)
        verdicts.append((v.drop, v.dead_dst, v.duplicate, v.corrupt,
                         v.delay_s))
        masks.append(inj.on_fingerprint(0, int(rng.integers(0, 3))))
        if v.corrupt:
            corrupt.append(inj.corrupt_payload(bytes(range(32))))
    return verdicts, masks, corrupt, inj.log, inj.stats(), inj.dead_ranks()


@pytest.mark.parametrize("seed", [3, 17])
def test_injector_verdicts_equal_jax(seed):
    """The same plan against the same seeded message stream: the same
    verdicts, diverge masks, corrupted bytes, log and counters."""
    assert _replay(tf, seed) == _replay(jf, seed)


def test_health_transitions_and_seqn_ledger_equal_jax():
    rng = np.random.default_rng(1)
    th, jh = tf.HealthTransitions(), jf.HealthTransitions()
    tl, jl = tf.SeqnLedger(), jf.SeqnLedger()
    states = tf.HEALTH_STATES
    assert states == jf.HEALTH_STATES
    for _ in range(40):
        edge = (int(rng.integers(0, 4)), states[int(rng.integers(0, 6))],
                states[int(rng.integers(0, 6))])
        th.note(*edge)
        jh.note(*edge)
        key, seqn = (0, int(rng.integers(0, 3))), int(rng.integers(0, 12))
        assert tl.seen(key, seqn) == jl.seen(key, seqn)

    def strip(snap):  # monotonic stamps differ between the two notes
        return dict(snap, events=[{k: v for k, v in e.items()
                                   if k != "mono_ns"}
                                  for e in snap["events"]])

    assert strip(th.snapshot()) == strip(jh.snapshot())


# ---------------------------------------------------------------------------
# the gang: watchdog, health, soft_reset (tests/test_failure_paths.py)
# ---------------------------------------------------------------------------

def _absent_peer_steps(g):
    """test_failure_paths.py:267's steps on one group; returns what the
    twins compare."""
    a = g[0]
    a.set_timeout(0.3)
    send = a.create_buffer_from(np.ones(16, np.float32))
    recv = a.create_buffer(16, np.float32)
    out = {}
    t0 = time.monotonic()
    with pytest.raises(ERRORS) as exc:
        a.allreduce(send, recv, 16)  # strike 1: the watchdog
    out["first_s"] = time.monotonic() - t0
    d = exc.value.details
    out["first"] = (int(exc.value.code), d["peer"], d["elapsed_s"],
                    d["comm"], d["op"])
    out["suspect"] = a.capabilities()["health"]
    with pytest.raises(ERRORS):
        a.allreduce(send, recv, 16)  # strike 2: dead
    out["dead"] = a.capabilities()["health"]
    out["dump"] = [ln for ln in a.dump_communicator().splitlines()
                   if "health" in ln]
    a.set_timeout(10)  # a deadline the next call must not wait out
    t0 = time.monotonic()
    with pytest.raises(ERRORS) as exc:
        a.allreduce(send, recv, 16)
    out["intake_s"] = time.monotonic() - t0
    d = exc.value.details
    out["intake"] = (int(exc.value.code), d["peer"], d["elapsed_s"],
                     d["attempts"])
    run_parallel(g, lambda x, r: x.soft_reset())
    out["after_reset"] = a.capabilities()["health"]

    def work(accl, rank):
        s = accl.create_buffer_from(np.full(16, float(rank + 1), np.float32))
        d = accl.create_buffer(16, np.float32)
        accl.allreduce(s, d, 16)
        d.sync_from_device()
        return float(d.data[0])

    out["served"] = run_parallel(g, work)
    return out


def test_gang_watchdog_health_and_soft_reset_equal_jax():
    """A peer that never posts: RECEIVE_TIMEOUT at the timeout naming it,
    suspect then dead, the third call failing at intake, and after every
    rank's soft_reset the health map is clear and the allreduce exact --
    on the port as on JAX's gang."""
    jg, tg = _groups(2)
    try:
        want, got = _absent_peer_steps(jg), _absent_peer_steps(tg)
    finally:
        _deinit(jg + tg)
    for key in ("first", "suspect", "dead", "dump", "intake",
                "after_reset", "served"):
        assert got[key] == want[key], key
    assert got["first"][:3] == (int(at.ErrorCode.RECEIVE_TIMEOUT), 1, 0.3)
    assert got["dead"][1] == {"state": "dead", "timeouts": 2, "failures": 0,
                              "last_event": "gang_timeout"}
    assert got["served"] == [3.0, 3.0]
    # at the timeout, not after the facade's outer bound
    assert 0.25 < got["first_s"] < 1.0
    assert got["intake_s"] < 0.1


def test_gang_timeout_is_receive_timeout_not_deadlock():
    """The watchdog fires first: never DEADLOCK_SUSPECTED, and the
    flight recorder's tail rides the error as in JAX."""
    g = at.cuda_group(2, device="cpu")
    try:
        a = g[0]
        a.set_timeout(0.2)
        buf = a.create_buffer_from(np.ones(8, np.float32))
        t0 = time.monotonic()
        with pytest.raises(at.ACCLError) as exc:
            a.bcast(buf, 8, root=0)
        assert time.monotonic() - t0 < 1.0
        assert exc.value.code == at.ErrorCode.RECEIVE_TIMEOUT
        assert exc.value.details["op"] == "BCAST"
        assert "flight_recorder" in exc.value.details
        assert g[0].engine.gang.dump_state() == []
    finally:
        _deinit(g)


def test_reaped_slot_advances_the_order():
    """The port's gang runs a communicator's events in sequence order.
    A slot the watchdog reaps (here twice: rank 0's, then rank 1's late
    one of the same number) must advance that order, or the next event
    would wait forever; JAX's gang, which does not order, gives the same
    codes and result."""
    def steps(g):
        for a in g:
            a.set_timeout(0.2)
        s = [a.create_buffer_from(np.full(8, r + 1.0, np.float32))
             for r, a in enumerate(g)]
        d = [a.create_buffer(8, np.float32) for a in g]
        codes = []
        for r in (0, 1):  # each alone at sequence number 0
            with pytest.raises(ERRORS) as exc:
                g[r].allreduce(s[r], d[r], 8)
            codes.append((int(exc.value.code), exc.value.details["peer"]))

        def both(a, r):
            a.allreduce(s[r], d[r], 8)
            d[r].sync_from_device()
            return d[r].data.tolist()

        return codes, run_parallel(g, both, timeout=10.0), [
            a.capabilities()["health"] for a in g]

    jg, tg = _groups(2)
    try:
        want, got = steps(jg), steps(tg)
    finally:
        _deinit(jg + tg)
    assert got == want
    assert got[1] == [[3.0] * 8, [3.0] * 8]


def test_soft_reset_strands_no_waiter_and_dumps_clean():
    """A rank parked in a half-assembled slot when every rank resets
    completes with RECEIVE_TIMEOUT; the gang's dump then shows no
    pending slot, and the next call runs."""
    g = at.cuda_group(3, device="cpu")
    try:
        s = [a.create_buffer_from(np.full(4, r + 1.0, np.float32))
             for r, a in enumerate(g)]
        d = [a.create_buffer(4, np.float32) for a in g]
        req = g[0].allreduce(s[0], d[0], 4, run_async=True)
        assert "rxbuf gang-slot comm=0 seq=0 PENDING posted_ranks=[0] " \
               "world=3" in g[0].dump_rx_buffers()
        run_parallel(g, lambda a, r: a.soft_reset())
        assert req.wait(5)
        assert req.get_retcode() == at.ErrorCode.RECEIVE_TIMEOUT
        assert "rxbuf" not in g[0].dump_rx_buffers()
        assert g[0].dump_rx_buffers(as_dict=True)["report"][
            "gang_pending_slots"] == 0
        run_parallel(g, lambda a, r: a.allreduce(s[r], d[r], 4))
        d[2].sync_from_device()
        assert d[2].data.tolist() == [6.0] * 4
    finally:
        _deinit(g)


@pytest.mark.parametrize("limit,backoff_s,ok", [
    (3, 0.2, True), (0, 0.05, True), (-1, 0.05, False), (3, 0.0, False),
    (3, -0.5, False)])
def test_retry_policy_accepted_and_refused_as_jax(limit, backoff_s, ok):
    jg, tg = _groups(2)
    try:
        codes = []
        for grp in (jg, tg):
            try:
                grp[0].set_retry_policy(limit, backoff_s)
                codes.append(0)
            except ERRORS as e:
                codes.append(int(e.code))
        assert codes[0] == codes[1]
        assert codes[1] == (0 if ok else int(at.ErrorCode.CONFIG_ERROR))
    finally:
        _deinit(jg + tg)


def test_watchdog_thread_ends_with_the_gang():
    g = at.cuda_group(2, device="cpu")
    g[0].set_timeout(0.1)
    buf = g[0].create_buffer_from(np.ones(4, np.float32))
    with pytest.raises(at.ACCLError):
        g[0].bcast(buf, 4, root=0)
    watchdog = g[0].engine.gang.watchdog
    thread = watchdog._thread
    assert thread is not None and thread.name == "accl-gang-watchdog"
    _deinit(g)
    assert not thread.is_alive() and watchdog._thread is None


# ---------------------------------------------------------------------------
# the command ring's chaos hook (tests/test_cmdring.py:1572, :1609)
# ---------------------------------------------------------------------------

def _fused_buffers(g, n=8):
    world = len(g)
    grads = [np.arange(world * n, dtype=np.float32) + r
             for r in range(world)]
    params = [np.full(n, 50.0 + r, np.float32) for r in range(world)]
    send = [a.create_buffer_from(np.concatenate([grads[r], params[r]]))
            for r, a in enumerate(g)]
    out = [a.create_buffer(n, np.float32) for a in g]
    ref = [params[r] - 0.5 * np.sum(grads, axis=0).reshape(world, n)[r]
           for r in range(world)]
    return send, out, ref


def _fused_window(g, send, out, n=8):
    def work(a, r):
        with a.batch():
            req = a.fused_apply(send[r], out[r], n, lr=0.5, run_async=True)
        assert req.wait(60)
        req.check()

    return _drive(g, work)


def _install(plan_kwargs, seed):
    for mod, fmod in ((tcontract, tf), (jcontract, jf)):
        mod.install_fault_plan(fmod.FaultPlan(
            [fmod.FaultRule(**plan_kwargs)], seed=seed))


def _uninstall():
    tcontract.install_fault_plan(None)
    jcontract.install_fault_plan(None)


def _chaos_corrupt(g):
    ring = g[0].engine.gang.cmdring
    send, out, ref = _fused_buffers(g)
    _fused_window(g, send, out)  # cold first
    _install(dict(action="corrupt", msg_type="RING", nth=1, count=1), 11)
    try:
        errs, elapsed = _fused_window(g, send, out)
    finally:
        _uninstall()
    res = {"codes": sorted((r, int(e.code)) for r, e in errs.items()),
           "recorder": all("flight_recorder" in e.details
                           for e in errs.values()),
           "chaos": ring.stats()["chaos_faults"],
           "status": ring.last_status(g[0].comm.id)[:, 1].tolist(),
           "elapsed": elapsed}
    run_parallel(g, lambda a, r: a.soft_reset())
    errs, _ = _fused_window(g, send, out)
    res["after"] = sorted(errs)
    res["exact"] = []
    for r in range(len(g)):
        out[r].sync_from_device()
        res["exact"].append(bool(np.allclose(out[r].data, ref[r],
                                             rtol=1e-6)))
    return res


def test_chaos_corrupt_fused_window_equals_jax():
    """A corrupt verdict poisons the window's first opcode: the status
    word reads BAD_OP (2), every rank's request fails INVALID_OPERATION
    fast with the recorder's tail, and soft_reset recovers an exact
    fused window."""
    jg, tg = _groups(4)
    try:
        want, got = _chaos_corrupt(jg), _chaos_corrupt(tg)
    finally:
        _deinit(jg + tg)
    for key in ("codes", "recorder", "chaos", "status", "after", "exact"):
        assert got[key] == want[key], key
    assert got["codes"] == [(r, int(at.ErrorCode.INVALID_OPERATION))
                            for r in range(4)]
    assert got["status"] == [2] and got["chaos"] == {"corrupt": 1}
    assert got["exact"] == [True] * 4
    assert got["elapsed"] < 15


def _chaos_delay(g):
    ring = g[0].engine.gang.cmdring
    send, out, ref = _fused_buffers(g)
    _fused_window(g, send, out)
    delays0 = ring.stats()["chaos_faults"].get("delay", 0)
    _install(dict(action="delay", msg_type="RING", nth=1, count=1,
                  delay_s=0.3), 12)
    try:
        errs, elapsed = _fused_window(g, send, out)
    finally:
        _uninstall()
    exact = []
    for r in range(len(g)):
        out[r].sync_from_device()
        exact.append(bool(np.allclose(out[r].data, ref[r], rtol=1e-6)))
    return {"errs": sorted(errs), "elapsed": elapsed, "exact": exact,
            "delays": ring.stats()["chaos_faults"].get("delay", 0)
            - delays0}


def test_chaos_delay_fused_window_equals_jax():
    """A delay verdict is bounded and perturbs timing only: the window
    completes exact, one delay counted."""
    jg, tg = _groups(4)
    try:
        want, got = _chaos_delay(jg), _chaos_delay(tg)
    finally:
        _deinit(jg + tg)
    for key in ("errs", "exact", "delays"):
        assert got[key] == want[key], key
    assert got["errs"] == [] and got["delays"] == 1
    assert 0.25 < got["elapsed"] < 15


def test_init_reset_abandons_nothing():
    """§C: a handle's init-time RESET (value 0) leaves the port's gang
    as it is, where JAX's gang soft-resets at every RESET, so its
    construction counts a reset and a register epoch a handle; each
    ``soft_reset`` (RESET 1) counts one on both."""
    def counters(g):
        gang = g[0].engine.gang
        return gang.tuning_epoch, gang.cmdring.stats()["resets"]

    jg, tg = _groups(2)
    try:
        assert counters(jg) == (2, 2) and counters(tg) == (0, 0)
        for grp in (jg, tg):
            run_parallel(grp, lambda a, r: a.soft_reset())
        assert counters(jg) == (4, 4) and counters(tg) == (2, 2)
        assert tg[0]._plans.stats() == jg[0]._plans.stats()
    finally:
        _deinit(jg + tg)


@pytest.mark.parametrize("name", [
    "test_soft_reset_parks_and_realigns_seqn",
    "test_wraparound_and_soft_reset_under_mixed_windows",
])
def test_jax_soft_reset_ring_tests_on_the_port(name):
    """``tests/test_cmdring.py``'s soft_reset tests, unedited, on a fresh
    port group: the ring parks, abandons its sessions, realigns seqn at 0
    and re-arms exactly."""
    import test_cmdring

    g = at.cuda_group(4, device="cpu")
    try:
        getattr(test_cmdring, name)(g)
    finally:
        _deinit(g)
