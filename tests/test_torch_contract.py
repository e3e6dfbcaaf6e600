"""The PyTorch port's contract plane (``accl_tpu_torch.contract``) against
the JAX package's.

* fingerprints and digests bit for bit on seeded call streams, and the
  board's majority and two-rank-split rules on the same posts;
* ``tests/test_contract.py``'s own unit tests, unedited, with the port's
  classes in place of JAX's, and its facade tests on the port's group in
  place of ``emulated_group``;
* the gang, as differential twins of ``tests/test_contract.py:412``
  (seeded divergence), ``:439`` (a real op mismatch), ``:587`` (blame on a
  sub-communicator) and ``tests/test_fault_injection.py:868`` (fused
  against plain skew), ``:910`` (a uniform fused stream);
* the hierarchical fingerprint (``"<op>.hier"``) and ``soft_reset``'s
  fresh generation.
"""

import threading
import time

import numpy as np
import pytest

import accl_tpu.contract as jc
import accl_tpu.faults as jf
import test_contract as jtests
from accl_tpu import ACCLError as JACCLError
from accl_tpu.core import xla_group

import accl_tpu_torch as at
import accl_tpu_torch.contract as tc
import accl_tpu_torch.faults as tf

ERRORS = (JACCLError, at.ACCLError)


def _deinit(group):
    for a in group:
        a.deinit()


def _drive(group, work):
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
        t.join(60)
    assert all(not t.is_alive() for t in threads), "rank thread hung"
    return errs, time.monotonic() - t0


# ---------------------------------------------------------------------------
# the pure module
# ---------------------------------------------------------------------------

def _calls(seed, n=200):
    rng = np.random.default_rng(seed)
    ops = ["allreduce", "bcast", "allgather", "allreduce.fused3",
           "reduce_scatter.hier", "__begin__"]
    for _ in range(n):
        yield (ops[int(rng.integers(0, len(ops)))],
               int(rng.integers(0, 1 << 31)), int(rng.integers(0, 9)),
               ["FLOAT32", "BFLOAT16", None][int(rng.integers(0, 3))],
               int(rng.integers(0, 1 << 40)),
               f"{int(rng.integers(0, 8))}/{int(rng.integers(0, 8))}",
               int(rng.integers(0, 1 << 31)), int(rng.integers(0, 1 << 20)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprint_and_digest_bit_for_bit(seed):
    td = jd = 0
    for call in _calls(seed):
        tfp, jfp = tc.call_fingerprint(*call), jc.call_fingerprint(*call)
        assert tfp == jfp
        td, jd = tc.roll_digest(td, tfp), jc.roll_digest(jd, jfp)
        assert td == jd


def test_env_readers_equal_jax():
    for env in ({}, {"ACCL_VERIFY": "1"}, {"ACCL_VERIFY": "0"},
                {"ACCL_VERIFY_INTERVAL": "3"},
                {"ACCL_VERIFY_INTERVAL": "junk"},
                {"ACCL_VERIFY_INTERVAL": "0"}):
        assert tc.env_enabled(env) == jc.env_enabled(env)
        assert tc.env_interval(env) == jc.env_interval(env)
    assert (tc.VERIFY_ENV, tc.VERIFY_INTERVAL_ENV,
            tc.DEFAULT_VERIFY_INTERVAL) == (
        jc.VERIFY_ENV, jc.VERIFY_INTERVAL_ENV, jc.DEFAULT_VERIFY_INTERVAL)


@pytest.mark.parametrize("world,bad", [(4, {3}), (2, {1}), (5, {0, 4}),
                                       (3, set())])
def test_board_rules_equal_jax(world, bad):
    """Majority convictions and the two-rank split on the same posts."""
    ring = [{"seqn": 0, "op": "allreduce", "fingerprint": 1}]
    bad_ring = [{"seqn": 0, "op": "bcast", "fingerprint": 2}]
    tb, jb = tc.ContractBoard(), jc.ContractBoard()
    for window in range(2):
        for r in range(world):
            digest, rg = (222, bad_ring) if r in bad else (111, ring)
            args = (5, 1, window, r, world, digest, rg)
            assert tb.post(*args) == jb.post(*args)
    assert tb.standing(5) == jb.standing(5)


def test_verdict_context_equals_jax():
    v = {"kind": "divergence", "basis": "majority", "comm": 7,
         "diverging_rank": 2, "diverging_session": 3, "window": 4,
         "first_mismatch": {"expected": {"op": "allreduce"},
                            "got": {"op": "bcast"}}}
    assert tc.verdict_context(v, "ctx") == jc.verdict_context(v, "ctx")


@pytest.mark.parametrize("name", [
    "test_fingerprint_deterministic_and_sensitive",
    "test_digest_is_order_sensitive",
    "test_board_majority_convicts_minority",
    "test_board_two_rank_split_stays_silent",
    "test_verifier_pairwise_claim_matching",
    "test_verifier_parks_claims_from_ranks_ahead",
    "test_verifier_reset_clears_verdicts_and_bumps_generation",
])
def test_jax_contract_units_on_the_port(monkeypatch, name):
    """``tests/test_contract.py``'s unit tests, unedited, with the port's
    classes and functions in place of JAX's."""
    for attr in ("ContractBoard", "ContractVerifier", "call_fingerprint",
                 "roll_digest"):
        monkeypatch.setattr(jtests, attr, getattr(tc, attr))
    getattr(jtests, name)()


@pytest.mark.parametrize("name", [
    "test_verifier_quiet_on_matched_sequences",
    "test_verifier_off_by_default_and_disarmable",
    "test_verify_env_arms_per_handle",
    "test_board_retract_on_disarm_prevents_stale_conviction",
])
def test_jax_contract_facade_tests_on_the_port(monkeypatch, name):
    """``tests/test_contract.py``'s facade tests, unedited, on the port's
    gang in place of ``emulated_group`` (the board exchange, the
    snapshot and capability surfaces, the env arming)."""
    monkeypatch.setattr(jtests, "emulated_group",
                        lambda n: at.cuda_group(n, device="cpu"))
    monkeypatch.setattr(jtests, "ACCLError", at.ACCLError)
    fn = getattr(jtests, name)
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(monkeypatch)
    else:
        fn()


# ---------------------------------------------------------------------------
# the gang (tests/test_contract.py, tests/test_fault_injection.py)
# ---------------------------------------------------------------------------

def _install(rule, seed):
    tc.install_fault_plan(tf.FaultPlan([tf.FaultRule(**rule)], seed=seed))
    jc.install_fault_plan(jf.FaultPlan([jf.FaultRule(**rule)], seed=seed))


def _uninstall():
    tc.install_fault_plan(None)
    jc.install_fault_plan(None)


def _verdicts(errs):
    return {r: (int(e.code), e.details.get("diverging_rank"),
                e.details.get("contract", {}).get("basis"),
                e.details.get("contract", {}).get("diverging_session"),
                e.details.get("contract", {}).get("comm"))
            for r, e in errs.items()}


def _twin(n, steps):
    jg, tg = xla_group(n), at.cuda_group(n, device="cpu")
    try:
        return steps(jg), steps(tg)
    finally:
        _uninstall()
        _deinit(jg + tg)


def _seeded(g):
    _install(dict(action="diverge", rank=2, nth=3), 9)
    for a in g:
        a.set_contract_verify(True, interval=2)

    def loop(a, rank):
        s = a.create_buffer_from(np.full(16, rank + 1.0, np.float32))
        d = a.create_buffer(16, np.float32)
        for _ in range(10):
            a.allreduce(s, d, 16)

    errs, elapsed = _drive(g, loop)
    _uninstall()
    v = errs[0].details["contract"]
    return {"verdicts": _verdicts(errs), "elapsed": elapsed,
            "keys": sorted(v), "details": sorted(errs[0].details),
            "mismatch": v["first_mismatch"]["got"]["seqn"],
            "snapshot": sorted(g[0].telemetry_snapshot()["contract"])}


def test_gang_seeded_divergence_equals_jax():
    want, got = _twin(4, _seeded)
    for key in ("verdicts", "keys", "details", "mismatch", "snapshot"):
        assert got[key] == want[key], key
    assert set(got["verdicts"]) == {0, 1, 2, 3}
    assert all(v[:3] == (int(at.ErrorCode.CONTRACT_VIOLATION), 2,
                         "majority") for v in got["verdicts"].values())
    assert {"first_mismatch", "diverging_flight_recorder"} <= set(
        got["keys"])
    assert got["elapsed"] < 15


def _op_mismatch(g):
    for a in g:
        a.set_contract_verify(True, interval=1)

    def work(a, rank):
        s = a.create_buffer_from(np.full(8, rank + 1.0, np.float32))
        d = a.create_buffer(8, np.float32)
        r = a.create_buffer(32, np.float32)
        a.allreduce(s, d, 8)
        if rank == 3:
            a.allgather(s, r, 8)  # the torn sequence
        else:
            a.allreduce(s, d, 8)
        a.allreduce(s, d, 8)

    errs, elapsed = _drive(g, work)
    return {"verdicts": _verdicts(errs), "elapsed": elapsed}


def test_gang_real_op_mismatch_equals_jax():
    """Rank 3 issues an allgather where its peers allreduce: convicted
    at the window boundary, every rank (the parked peers too) failing
    CONTRACT_VIOLATION instead of the watchdog's timeout."""
    want, got = _twin(4, _op_mismatch)
    assert got["verdicts"] == want["verdicts"]
    assert got["verdicts"] and all(
        v[:2] == (int(at.ErrorCode.CONTRACT_VIOLATION), 3)
        for v in got["verdicts"].values())
    assert got["elapsed"] < 15


def _subcomm(g):
    subs = {}
    for r, a in enumerate(g):
        sub = a.create_communicator([1, 2, 3])
        if sub is not None:
            subs[r] = sub
    _install(dict(action="diverge", rank=2, comm=subs[1].id), 31)
    for a in g:
        a.set_contract_verify(True, interval=2)

    def work(a, rank):
        if rank not in subs:
            return
        s = a.create_buffer_from(np.full(8, rank + 1.0, np.float32))
        d = a.create_buffer(8, np.float32)
        for _ in range(8):
            a.allreduce(s, d, 8, comm=subs[rank])

    errs, elapsed = _drive(g, work)
    return {"verdicts": _verdicts(errs), "elapsed": elapsed,
            "sub": subs[1].id}


def test_subcomm_blame_is_comm_relative_equals_jax():
    """World rank 3 is rank 2 of the subcomm [1, 2, 3]: the verdict
    blames rank 2 with session 3, on the subcomm's own majority."""
    want, got = _twin(4, _subcomm)
    assert got["sub"] == want["sub"]
    assert got["verdicts"] == want["verdicts"]
    assert sorted(got["verdicts"]) == [1, 2, 3]
    assert all(v == (int(at.ErrorCode.CONTRACT_VIOLATION), 2, "majority",
                     3, got["sub"]) for v in got["verdicts"].values())
    assert got["elapsed"] < 15


def _fuse_skew(g):
    for a in g:
        a.set_contract_verify(True, interval=1)
    n, world = 8, len(g)

    def work(a, rank):
        s = a.create_buffer_from(np.full(n, rank + 1.0, np.float32))
        d = a.create_buffer(n, np.float32)
        a.allreduce(s, d, n)
        if rank == 2:
            packed = a.create_buffer_from(np.concatenate([
                np.ones(world * n, np.float32),
                np.full(n, 5.0, np.float32)]))
            a.fused_apply(packed, d, n, lr=0.5)  # the skewed call
        else:
            a.allreduce(s, d, n)
        a.allreduce(s, d, n)

    errs, elapsed = _drive(g, work)
    return {"verdicts": _verdicts(errs), "elapsed": elapsed}


def test_fuse_vs_plain_skew_equals_jax():
    want, got = _twin(4, _fuse_skew)
    assert got["verdicts"] == want["verdicts"]
    assert got["verdicts"] and all(
        v[:2] == (int(at.ErrorCode.CONTRACT_VIOLATION), 2)
        for v in got["verdicts"].values())
    assert got["elapsed"] < 15


def _uniform_fused(g):
    for a in g:
        a.set_contract_verify(True, interval=1)
    n, world = 8, len(g)
    grads = [np.arange(world * n, dtype=np.float32) + r
             for r in range(world)]
    params = [np.full(n, 9.0 + r, np.float32) for r in range(world)]
    send = [a.create_buffer_from(np.concatenate([grads[r], params[r]]))
            for r, a in enumerate(g)]
    out = [a.create_buffer(n, np.float32) for a in g]

    def work(a, rank):
        for _ in range(3):
            a.fused_apply(send[rank], out[rank], n, lr=0.5)

    errs, _ = _drive(g, work)
    res = []
    for r in range(world):
        out[r].sync_from_device()
        res.append(out[r].data.tolist())
    snap = g[0].telemetry_snapshot()["contract"]
    return {"errs": sorted(errs), "out": res,
            "calls": snap["calls_verified"], "verdicts": snap["verdicts"]}


def test_uniform_fused_stream_passes_equals_jax():
    want, got = _twin(4, _uniform_fused)
    assert got == want
    assert got["errs"] == [] and got["verdicts"] == {}
    assert got["calls"] == 3


def test_hier_fingerprint_and_soft_reset_generation():
    """A hierarchical allreduce records ``allreduce.hier`` on the parent
    comm beside its stages' records on the subcomms; soft_reset starts a
    fresh generation with the verdicts cleared, on both packages."""
    from accl_tpu.topology import Topology as JTopology

    def steps(g, topo):
        for a in g:
            a.set_topology(topo)
            a.set_tuning("hierarchical", 1)
            a.set_contract_verify(True, interval=1)
        s = [a.create_buffer_from(np.full(8, r + 1.0, np.float32))
             for r, a in enumerate(g)]
        d = [a.create_buffer(8, np.float32) for a in g]
        errs, _ = _drive(g, lambda a, r: a.allreduce(s[r], d[r], 8))
        v = g[0]._contract
        ops = [e["op"] for e in v._comms[0].ring]
        for a in g:
            a.soft_reset()
        return errs, ops, v.generation, g[0].capabilities()[
            "contract_verify"]

    jg, tg = xla_group(4), at.cuda_group(4, device="cpu")
    try:
        want = steps(jg, JTopology([[0, 1], [2, 3]]))
        got = steps(tg, at.topology.Topology([[0, 1], [2, 3]]))
    finally:
        _deinit(jg + tg)
    assert got == want
    assert got[0] == {} and got[1] == ["allreduce.hier"] and got[2] == 2
