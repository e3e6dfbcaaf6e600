"""The port's tuning plane against the JAX package's: tuning plans
(``accl_tpu_torch.tuning``), the autotuner's candidates, plans loaded
into the facade, segmented pipelining, the eager register and
``Request.add_done_callback``.

A plan written by either package loads in the other (same JSON keys,
same register names); ``validate_registers`` refuses what JAX's refuses
with the same exception types; the port's gang is raced as JAX's device
tier (``_candidates("cuda", ...)`` equals ``_candidates("xla", ...)``).
The facade cases run on ``cuda_group(4, device="cpu")`` beside JAX's
``xla_group(4)`` (the conftest's 8 virtual devices), one thread per rank.
"""

import json
import threading

import numpy as np
import pytest

import accl_tpu as jaccl
import accl_tpu.tuning as jtuning
from accl_tpu.constants import DataType as JDataType
from accl_tpu.constants import Operation as JOperation
from accl_tpu.core import xla_group
from helpers import run_parallel

import accl_tpu_torch as at
import accl_tpu_torch.tuning as ttuning
from accl_tpu_torch.backends.base import CallOptions
from accl_tpu_torch.backends.cuda.engine import resolve_lowering
from accl_tpu_torch.constants import (
    DataType,
    EAGER_THRESHOLD_DEFAULT,
    Operation,
    TUNING_DEFAULTS,
)
from accl_tpu_torch.plans import size_bucket
from accl_tpu_torch.request import Request
from accl_tpu_torch.topology import Topology

P = 4


def _deinit(*groups):
    for g in groups:
        for a in g:
            a.deinit()


def _plan_doc(**kw):
    doc = {
        "version": 1, "world": P, "tier": "cuda",
        "defaults": dict(ttuning.REGISTER_DEFAULTS, ring_segments=2),
        "entries": {
            "allreduce": {
                "9": {"registers": {"allreduce_algorithm": "pallas_ring",
                                    "ring_segments": 4},
                      "measured_ns": 1.0, "size": 512,
                      "candidates": {"defaults": 2.0}},
                "12": {"registers": {}, "measured_ns": 3.0, "size": 4096},
            },
            "bcast": {"9": {"registers": {"bcast_algorithm": "pallas_ring",
                                          "max_eager_size": 4096},
                            "measured_ns": 1.0, "size": 512}},
        },
        "provenance": {"generated_by": "a test"},
        "topology": None,
    }
    doc.update(kw)
    return doc


# ---------------------------------------------------------------------------
# the plan artifact and the register checks
# ---------------------------------------------------------------------------


def test_register_tables_equal_jax():
    assert ttuning.REGISTER_DEFAULTS == jtuning.REGISTER_DEFAULTS
    assert ttuning.VALID_REGISTERS == jtuning.VALID_REGISTERS
    assert ttuning.COLLECTIVES == jtuning.COLLECTIVES
    assert EAGER_THRESHOLD_DEFAULT == jtuning.EAGER_THRESHOLD_DEFAULT


@pytest.mark.parametrize("topology", [None, "2x2", "s3-5/d163e132"])
def test_plan_json_loads_in_both_packages(topology, tmp_path):
    doc = _plan_doc(topology=topology)
    tp = ttuning.TuningPlan.from_json(json.dumps(doc))
    jp = jtuning.TuningPlan.from_json(json.dumps(doc))
    # the same document, written by either package
    assert tp.to_json() == jp.to_json()
    # each package's output loads in the other, unchanged
    assert jtuning.TuningPlan.from_json(tp.to_json()).to_json() == tp.to_json()
    assert ttuning.TuningPlan.from_json(jp.to_json()).to_json() == jp.to_json()
    path = tmp_path / "plan.json"
    tp.save(str(path))
    assert jtuning.TuningPlan.load(str(path)) == jp
    for bucket in range(6, 16):
        for op in ("allreduce", "bcast", "gather"):
            assert (tp.registers_for(op, bucket)
                    == jp.registers_for(op, bucket))


VALID = [
    {"allreduce_algorithm": "PALLAS_RING_BIDIR"},
    {"allreduce_algorithm": 2, "bcast_algorithm": 0},
    {"wire_dtype": "float8_e4m3", "wire_dtype_dcn": "INT8",
     "wire_dtype_ici": "off"},
    {"wire_dtype": int(DataType.BFLOAT16)},
    {"hierarchical": 1, "pipeline_threshold": 65536, "ring_segments": 4},
    {"max_eager_size": 16 * 1024 * 1024, "gather_flat_tree_max_fanin": 1},
    {"cmdring_run_windows": 128, "cmdring_linger_us": 1_000_000},
]

INVALID = [
    {"no_such_register": 1},
    {"allreduce_algorithm": "tree"},
    {"allreduce_algorithm": 9},
    {"bcast_algorithm": "pallas_ring_bidir"},
    {"gather_algorithm": "ring"},
    {"wire_dtype": "float64"},
    {"wire_dtype_dcn": int(DataType.FLOAT32)},
    {"hierarchical": 2},
    {"pipeline_threshold": -1},
    {"max_eager_size": 0},
    {"max_eager_size": 16 * 1024 * 1024 + 1},
    {"ring_segments": 0},
    {"gather_flat_tree_max_fanin": 0},
    {"cmdring_run_windows": 129},
    {"cmdring_linger_us": 1_000_001},
]


@pytest.mark.parametrize("regs", VALID, ids=range(len(VALID)))
def test_validate_registers_normalizes_as_jax(regs):
    assert ttuning.validate_registers(regs) == jtuning.validate_registers(
        regs)


@pytest.mark.parametrize("regs", INVALID, ids=range(len(INVALID)))
def test_validate_registers_refuses_as_jax(regs):
    with pytest.raises(Exception) as jx:
        jtuning.validate_registers(regs)
    with pytest.raises(Exception) as tx:
        ttuning.validate_registers(regs)
    assert type(tx.value) is type(jx.value)


def test_wire_dtype_value_equals_jax():
    for v in ("off", "", "0", "none", "INT8", "int8", "float8_e4m3",
              "float8_e4m3fn", "FLOAT8_E5M2", "bfloat16", "float16", 0, 1,
              6, 7, 8, 9):
        assert ttuning.wire_dtype_value(v) == jtuning.wire_dtype_value(v)
    for v in ("float32", "tree", 2, 3):
        with pytest.raises(ValueError):
            jtuning.wire_dtype_value(v)
        with pytest.raises(ValueError):
            ttuning.wire_dtype_value(v)


AXES = [
    dict(include_pallas=False, eager_candidates=(), segments=(1, 2, 4)),
    dict(include_pallas=True, eager_candidates=(4096,), segments=(1, 4),
         pipeline_thresholds=(1 << 20,), race_hierarchical=True),
    dict(include_pallas=True, eager_candidates=(), segments=(2,),
         wire_dtypes=("int8", "off", "bfloat16"),
         cmdring_run_windows=(0, 32, 200), cmdring_linger_us=(500, 2_000_000),
         race_hierarchical=True, wire_dtypes_ici=("float16",),
         wire_dtypes_dcn=("float8_e4m3", "off")),
]


@pytest.mark.parametrize("axes", AXES, ids=range(len(AXES)))
@pytest.mark.parametrize("op", jtuning.COLLECTIVES)
def test_candidates_equal_jax_device_tier(op, axes):
    """The port's tier is raced as JAX's device tier."""
    kw = dict(axes)
    args = (op, P, kw.pop("include_pallas"), kw.pop("eager_candidates"),
            kw.pop("segments"))
    assert ttuning._candidates("cuda", *args, **kw) == jtuning._candidates(
        "xla", *args, **kw)


def test_detect_tier_names_the_port_gang():
    g = at.cuda_group(2, device="cpu")
    try:
        assert ttuning.detect_tier(g) == "cuda"
    finally:
        _deinit(g)


# ---------------------------------------------------------------------------
# plans in the facade
# ---------------------------------------------------------------------------


def test_load_tuning_plan_refusals():
    """World and topology provenance, as JAX's
    ``test_tuning_plan_topology_provenance_refusal``."""
    g = at.cuda_group(2, device="cpu")
    try:
        a = g[0]
        wrong_world = ttuning.TuningPlan.from_json(json.dumps(
            _plan_doc(world=3)))
        with pytest.raises(ValueError, match="world=3"):
            a.load_tuning_plan(wrong_world)
        assert a.load_tuning_plan(wrong_world, strict=False) is None
        raced = ttuning.TuningPlan.from_json(json.dumps(
            _plan_doc(world=2, topology="2x1")))
        with pytest.raises(ValueError, match="2x1"):
            a.load_tuning_plan(raced, strict=True)
        assert a.load_tuning_plan(raced, strict=False) is None
        assert a.capabilities()["tuning_plan"] is None
        for x in g:
            x.set_topology(Topology.from_slice_size(2, 1))
        assert a.load_tuning_plan(raced, strict=True) is raced
        flat = dict(_plan_doc(world=2))
        del flat["topology"]
        assert a.load_tuning_plan(ttuning.TuningPlan.from_json(
            json.dumps(flat))) is not None
        assert a.capabilities()["tuning_plan"] == {
            "tier": "cuda", "world": 2, "collectives": ["allreduce", "bcast"]}
    finally:
        _deinit(g)


def test_overlay_dispatches_its_lowering_and_equals_jax():
    """A loaded plan's per-bucket overlay reaches the plan, the prepared
    handle's lowering (``resolve_lowering``) and the result; the same plan
    in JAX's gang gives the same bits."""
    doc = _plan_doc()
    n = 512  # bucket 9: pallas_ring, 4 segments
    rng = np.random.default_rng(3)
    data = [rng.integers(-64, 64, n).astype(np.float32) for _ in range(P)]
    tg, jg = at.cuda_group(P, device="cpu"), xla_group(P)
    try:
        for grp, mod in ((tg, ttuning), (jg, jtuning)):
            plan = mod.TuningPlan.from_json(json.dumps(doc))
            for a in grp:
                a.load_tuning_plan(plan)
        assert tg[0].engine.gang.tuning["ring_segments"] == 2  # defaults
        p = tg[0]._plan_for(Operation.ALLREDUCE, tg[0].comm,
                            DataType.FLOAT32, n, None, 0, (0,))
        jp = jg[0]._plan_for(JOperation.ALLREDUCE, jg[0].comm,
                             JDataType.FLOAT32, n, None, 0, (0,))
        assert p.tuning == jp.tuning == {
            "allreduce_algorithm": "pallas_ring", "ring_segments": 4}
        assert p.pipeline_segments == jp.pipeline_segments == 4
        lead = CallOptions(op=Operation.ALLREDUCE, count=n, tuning=p.tuning)
        assert resolve_lowering(
            Operation.ALLREDUCE, lead,
            lead.effective_tuning(tg[0].engine.gang.tuning), None) == (
                "pallas_allreduce", (4, None, False))
        # a bucket without an overlay keeps the table's lowering
        big = CallOptions(op=Operation.ALLREDUCE, count=4096,
                          tuning=tg[0]._plan_for(
                              Operation.ALLREDUCE, tg[0].comm,
                              DataType.FLOAT32, 4096, None, 0,
                              (0,)).tuning)
        assert resolve_lowering(
            Operation.ALLREDUCE, big,
            big.effective_tuning(tg[0].engine.gang.tuning), None) == (
                "allreduce", None)

        def work(a, r):
            s = a.create_buffer_from(data[r])
            d = a.create_buffer(n, np.float32)
            for _ in range(2):  # the second call takes the prepared handle
                a.allreduce(s, d, n)
            return np.asarray(d.device_view()[:n]).copy()

        tout, jout = run_parallel(tg, work), run_parallel(jg, work)
        for r in range(P):
            assert np.array_equal(tout[r], jout[r])
        (state,) = p.engine["gang"].values()
        assert [h.op for h in state["handles"].values()] == [
            "pallas_allreduce"]
        # the bcast bucket's eager overlay reaches the plan's verdict
        pb = tg[0]._plan_for(Operation.BCAST, tg[0].comm, DataType.FLOAT32,
                             n, None, 0, (0,))
        jpb = jg[0]._plan_for(JOperation.BCAST, jg[0].comm,
                              JDataType.FLOAT32, n, None, 0, (0,))
        # bucket 9 holds 512-1023 float32 elements: 2048-4092 bytes
        assert pb.tuning["max_eager_size"] == 4096
        assert pb.eager is jpb.eager is True
    finally:
        _deinit(tg, jg)


def test_unload_restores_register_defaults_as_jax():
    doc = _plan_doc(defaults=dict(
        ttuning.REGISTER_DEFAULTS, allreduce_algorithm="ring",
        pipeline_threshold=8192, hierarchical=1, wire_dtype=6,
        max_eager_size=4096))
    tg, jg = at.cuda_group(P, device="cpu"), xla_group(P)
    try:
        for grp, mod in ((tg, ttuning), (jg, jtuning)):
            for a in grp:
                a.load_tuning_plan(mod.TuningPlan.from_json(json.dumps(doc)))
        assert tg[0].engine.gang.tuning["allreduce_algorithm"] == "ring"
        assert tg[0]._max_eager_size == 4096
        for grp in (tg, jg):
            for a in grp:
                a.unload_tuning_plan()
        assert tg[0].engine.gang.tuning == TUNING_DEFAULTS
        restored = {k: jg[0].engine.gang.tuning[k] for k in TUNING_DEFAULTS}
        assert restored == {k: jtuning.REGISTER_DEFAULTS[k]
                            for k in TUNING_DEFAULTS}
        assert tg[0]._max_eager_size == EAGER_THRESHOLD_DEFAULT
        assert tg[0]._tuning_plan is None
        assert tg[0].capabilities()["plan_cache"]["last_invalidation"] == (
            "unload_tuning_plan")
        tg[0].unload_tuning_plan()  # nothing loaded: a no-op
    finally:
        _deinit(tg, jg)


def test_tiny_autotune_returns_defaults_as_candidate_zero():
    g = at.cuda_group(P, device="cpu",
                      topology=Topology.from_slice_size(P, 2))
    try:
        plan = ttuning.autotune(g, collectives=["allreduce", "bcast"],
                                sizes=[256], runs=1, segments=(1,))
        assert plan.tier == "cuda" and plan.world == P
        assert plan.topology == "2x2"
        assert plan.provenance["hierarchical_raced"] is True
        assert plan.provenance["generated_by"] == (
            "accl_tpu_torch.tuning.autotune")
        assert plan.provenance["platform"] == "cpu"
        for op in ("allreduce", "bcast"):
            entry = plan.entries[op][size_bucket(256)]
            assert list(entry["candidates"])[0] == "defaults"
            assert "hierarchical=1" in entry["candidates"]
        # the registers came back to the defaults
        assert g[0].engine.gang.tuning == TUNING_DEFAULTS
        # and the plan loads (its topology provenance matches)
        for a in g:
            assert a.load_tuning_plan(plan) is plan
        doc = json.loads(plan.to_json())
        assert jtuning.TuningPlan.from_json(json.dumps(doc)).tier == "cuda"
    finally:
        _deinit(g)


def test_autotune_raises_when_a_candidate_fails_to_run(monkeypatch):
    """A refused register write is a SKIP; a candidate whose call fails
    (a kernel that does not build or launch) fails the race instead of
    leaving the plain lowering the winner."""
    g = at.cuda_group(P, device="cpu")
    run = ttuning.run_group_op

    def failing(group, op, n):
        if group[0].engine.gang.tuning["allreduce_algorithm"] != "xla":
            raise RuntimeError("kernel launch failed")
        return run(group, op, n)

    try:
        log = []
        plan = ttuning.autotune(g, collectives=["allreduce"], sizes=[256],
                                runs=1, segments=(1,), eager_candidates=(0,),
                                log=log.append)
        assert any("max_eager_size=0: SKIP" in m for m in log)
        assert "max_eager_size=0" not in (
            plan.entries["allreduce"][size_bucket(256)]["candidates"])
        monkeypatch.setattr(ttuning, "run_group_op", failing)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            ttuning.autotune(g, collectives=["allreduce"], sizes=[256],
                             runs=1, segments=(1,), include_pallas=True)
        assert g[0].engine.gang.tuning == TUNING_DEFAULTS  # restored
    finally:
        _deinit(g)


def test_tuning_cli_refuses_wire_rates_with_jax_wording():
    for flags, text in ((["--wire-gbps", "1"], "--wire-gbps models"),
                        (["--dcn-gbps", "1"], "--ici-gbps/--dcn-gbps model")):
        with pytest.raises(SystemExit, match=text):
            ttuning.main(["--backend", "cpu"] + flags)


def test_tuning_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "plan.json"
    assert ttuning.main(["--backend", "cpu", "--world", "2", "--min-exp",
                         "6", "--max-exp", "6", "--runs", "1",
                         "--collectives", "allreduce", "--segments", "1",
                         "--out", str(out)]) == 0
    plan = jtuning.TuningPlan.load(str(out))  # JAX loads it
    assert plan.tier == "cuda" and plan.provenance["backend"] == "cpu"


def test_tuning_plan_env_at_construction(tmp_path, monkeypatch, capsys):
    path = tmp_path / "plan.json"
    jtuning.TuningPlan.from_json(json.dumps(_plan_doc())).save(str(path))
    monkeypatch.setenv("ACCL_TUNING_PLAN", str(path))
    g = at.cuda_group(P, device="cpu")
    try:
        assert g[0].capabilities()["tuning_plan"]["world"] == P
        assert g[0].engine.gang.tuning["ring_segments"] == 2
    finally:
        _deinit(g)
    g = at.cuda_group(2, device="cpu")  # another world: skipped quietly
    try:
        assert g[0]._tuning_plan is None
    finally:
        _deinit(g)
    monkeypatch.setenv("ACCL_TUNING_PLAN", str(tmp_path / "missing.json"))
    g = at.cuda_group(2, device="cpu")  # a bad path must not brick startup
    try:
        assert g[0]._tuning_plan is None
        assert "ignoring ACCL_TUNING_PLAN" in capsys.readouterr().err
    finally:
        _deinit(g)


# ---------------------------------------------------------------------------
# segmented pipelining
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["allreduce", "bcast"])
def test_segmented_pipelining_equals_the_unsplit_call(op):
    """The port's form of ``test_segmented_pipelining_gang``: above
    ``pipeline_threshold`` the call runs as ``ring_segments`` sub-calls,
    equal to the unsplit call and to JAX's, ``nseg`` device interactions
    (one dispatch a segment), and an async aggregate drains at
    ``flush()``."""
    n, nseg = 1 << 14, 4
    rng = np.random.default_rng(8)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(P)]
    tg, jg = at.cuda_group(P, device="cpu"), xla_group(P)

    def work(a, r):
        if op == "allreduce":
            s = a.create_buffer_from(data[r])
            d = a.create_buffer(n, np.float32)
            a.allreduce(s, d, n)
            return np.asarray(d.device_view()[:n]).copy()
        s = a.create_buffer_from(data[r])
        a.bcast(s, n, root=2)
        return np.asarray(s.device_view()[:n]).copy()

    try:
        unsplit = run_parallel(tg, work)
        for grp in (tg, jg):
            for a in grp:
                a.set_tuning("ring_segments", nseg)
                a.set_tuning("pipeline_threshold", 8192)
        jout = run_parallel(jg, work)
        ic0 = tg[0].capabilities()["device_interactions"]
        tout = run_parallel(tg, work)
        assert tg[0].capabilities()["device_interactions"] - ic0 == nseg
        for r in range(P):
            assert np.array_equal(tout[r], unsplit[r])
            assert np.array_equal(tout[r], jout[r])
        p = tg[0]._plan_for(Operation[op.upper()], tg[0].comm,
                            DataType.FLOAT32, n, None, 0,
                            (0,) if op == "allreduce" else (2,))
        assert p.pipeline_for(4 * n) == nseg
        # an async aggregate drains at flush()
        sends = [a.create_buffer_from(d) for a, d in zip(tg, data)]
        recvs = [a.create_buffer(n, np.float32) for a in tg]
        if op == "allreduce":
            reqs = run_parallel(tg, lambda a, r: a.allreduce(
                sends[r], recvs[r], n, run_async=True))
        else:
            reqs = run_parallel(tg, lambda a, r: a.bcast(
                sends[r], n, root=2, run_async=True))
        tg[0].flush()
        for q in reqs:
            assert q.done()
            q.check()
        assert tg[0].engine.gang.window.in_flight() == 0
        # a pipelined call inside a batch: its segments queue, and
        # waiting on the aggregate flushes them
        def batched(a, r):
            with a.batch():
                q = a.allreduce(sends[r], recvs[r], n, run_async=True)
                assert q.wait(30)
                q.check()
            return np.asarray(recvs[r].device_view()[:n]).copy()

        if op == "allreduce":
            out = run_parallel(tg, batched)
            for r in range(P):
                assert np.array_equal(out[r], unsplit[r])
    finally:
        _deinit(tg, jg)


def test_pipelining_stays_whole_below_threshold_and_for_reduce():
    g = at.cuda_group(P, device="cpu")
    try:
        for a in g:
            a.set_tuning("ring_segments", 4)
            a.set_tuning("pipeline_threshold", 1 << 20)
        p = g[0]._plan_for(Operation.ALLREDUCE, g[0].comm, DataType.FLOAT32,
                           1024, None, 0, (0,))
        assert p.pipeline_for(4096) == 1
        assert g[0]._pipeline_segments_for(p, 3, DataType.FLOAT32) == 1
        pr = g[0]._plan_for(Operation.REDUCE, g[0].comm, DataType.FLOAT32,
                            1 << 20, None, 0, (0, 0, 0))
        assert pr.pipeline_segments == 1 and pr.pipeline_threshold == 0
    finally:
        _deinit(g)


# ---------------------------------------------------------------------------
# requests, the eager register, invalidation
# ---------------------------------------------------------------------------


def test_add_done_callback_on_pending_and_done_requests():
    req = Request("ALLREDUCE")
    calls = []
    req.add_done_callback(lambda: calls.append("a"))
    req.add_done_callback(lambda: calls.append("b"))
    assert calls == []
    t = threading.Thread(target=req.complete, args=(at.ErrorCode.OK,))
    t.start()
    t.join()
    assert calls == ["a", "b"]
    req.add_done_callback(lambda: calls.append("c"))  # done: runs at once
    assert calls == ["a", "b", "c"]
    req.complete(at.ErrorCode.OK)  # a second completion runs none again
    assert calls == ["a", "b", "c"]


def test_stage_completing_after_deinit_fails_its_aggregate():
    """A hierarchical stage that completes after ``deinit`` fails the
    aggregate and starts no stage thread; the next stage never runs."""
    def stage_threads():
        return sum(t.name == f"accl-hier-{a.rank}"
                   for t in threading.enumerate())

    g = at.cuda_group(2, device="cpu")
    a = g[0]
    threads = stage_threads()
    pending, ran = Request("REDUCE_SCATTER"), []
    outer = a._launch_hier_stages(
        "allreduce", [lambda: pending, lambda: ran.append(1)],
        run_async=True, context="allreduce")
    _deinit(g)
    pending.complete(at.ErrorCode.OK)
    assert outer.done() and ran == []
    assert outer.get_retcode() == at.ErrorCode.INVALID_OPERATION
    assert outer.error_context["hier_stage"] == 1
    assert stage_threads() == threads
    assert a._hop(lambda: ran.append(2)) is False and ran == []


@pytest.mark.parametrize("limit", [4096, 4095, 6000, 8191, 8192, 1])
def test_eager_verdict_at_bucket_edges_equals_jax(limit):
    """The plan's eager verdict: the whole bucket under the limit (True),
    over it (False) or mixed (None), as JAX's; a write re-plans once."""
    tg, jg = at.cuda_group(P, device="cpu"), xla_group(P)
    try:
        for grp in (tg, jg):
            for a in grp:
                a.set_max_eager_size(limit)
        before = tg[0].capabilities()["plan_cache"]
        for n in (1, 2, 511, 512, 1023, 1024, 1025, 2047, 2048, 4096):
            for dt, jdt in ((DataType.FLOAT32, JDataType.FLOAT32),
                            (DataType.FLOAT16, JDataType.FLOAT16)):
                p = tg[0]._plan_for(Operation.ALLREDUCE, tg[0].comm, dt, n,
                                    None, 0, (0,))
                jp = jg[0]._plan_for(JOperation.ALLREDUCE, jg[0].comm, jdt,
                                     n, None, 0, (0,))
                assert p.eager == jp.eager, (n, dt)
        a = tg[0]
        n = 1024
        a._plan_for(Operation.ALLREDUCE, a.comm, DataType.FLOAT32, n, None,
                    0, (0,))
        stats = a.capabilities()["plan_cache"]
        assert stats["invalidations"] == before["invalidations"]
        a.set_max_eager_size(4 * n)  # the bucket [1024, 2048) flips
        assert a.capabilities()["plan_cache"]["invalidations"] == (
            stats["invalidations"] + 1)
        p = a._plan_for(Operation.ALLREDUCE, a.comm, DataType.FLOAT32, n,
                        None, 0, (0,))
        assert a.capabilities()["plan_cache"]["misses"] == stats["misses"] + 1
        assert p.eager is None
        a.set_max_eager_size(8 * n)
        assert a._plan_for(Operation.ALLREDUCE, a.comm, DataType.FLOAT32, n,
                           None, 0, (0,)).eager is True
        with pytest.raises(at.ACCLError) as ei:
            a.set_max_eager_size(0)
        assert ei.value.code == at.ErrorCode.CONFIG_ERROR
        # refused and accepted as on JAX's gang
        for h, err in ((a, at.ACCLError), (jg[0], jaccl.ACCLError)):
            with pytest.raises(err) as ei:
                h.set_max_rendezvous_size(0)
            assert int(ei.value.code) == int(at.ErrorCode.CONFIG_ERROR)
            h.set_max_rendezvous_size(1 << 20)
    finally:
        _deinit(tg, jg)


def test_every_register_is_served_as_jax():
    """Every register of JAX's table is written, read back and refused
    out of range as on JAX's gang."""
    tg, jg = at.cuda_group(2, device="cpu"), xla_group(2)
    try:
        writes = {"gather_flat_tree_max_fanin": 3,
                  "gather_flat_tree_max_count": 7,
                  "bcast_flat_tree_max_ranks": 5,
                  "reduce_flat_tree_max_ranks": 6,
                  "reduce_flat_tree_max_count": 9,
                  "pipeline_threshold": 1 << 16, "hierarchical": 1,
                  "wire_dtype_ici": "bfloat16", "wire_dtype_dcn": "int8",
                  "cmdring_run_windows": 64, "cmdring_linger_us": 500}
        for name, value in writes.items():
            for a in tg + jg:
                a.set_tuning(name, value)
            assert (tg[0].engine.gang.tuning[name]
                    == jg[0].engine.gang.tuning[name])
        for name, value in (("hierarchical", 2),
                            ("gather_flat_tree_max_fanin", 0),
                            ("wire_dtype_dcn", int(DataType.FLOAT64))):
            for a in (tg[0], jg[0]):
                with pytest.raises(Exception) as ei:
                    a.set_tuning(name, value)
                assert int(ei.value.code) == int(at.ErrorCode.CONFIG_ERROR)
    finally:
        _deinit(tg, jg)
