"""The port's topology plane against the JAX package's: the descriptor
(``accl_tpu_torch.topology``), the decomposition rules
(``accl_tpu_torch.hierarchical``), and the hierarchical facade calls.

The descriptor and the rules are pure math: every fact is held equal to
``accl_tpu.topology`` / ``accl_tpu.hierarchical`` over a grid of layouts
and counts.  The four hierarchical collectives run on
``cuda_group(P, device="cpu", topology=...)`` and on JAX's
``xla_group(P, topology=...)`` (the conftest's 8 virtual devices), flat
and with the ``hierarchical`` register set, on integer-valued float32
from a numpy seed: all four results agree bit for bit (the JAX test this
mirrors is ``tests/test_topology.py::test_hierarchical_bit_identical_gang_tier``).
"""

import json

import numpy as np
import pytest

import accl_tpu.hierarchical as jhier
import accl_tpu.topology as jtopo
from accl_tpu.constants import DataType as JDataType
from accl_tpu.constants import Operation as JOperation
from accl_tpu.constants import ReduceFunction as JReduceFunction
from accl_tpu.core import xla_group
from helpers import run_parallel

import accl_tpu_torch as at
import accl_tpu_torch.hierarchical as thier
import accl_tpu_torch.topology as ttopo
from accl_tpu_torch.constants import DataType, Operation
from accl_tpu_torch.topology import LinkClass, Topology

#: layouts of up to 8 ranks: symmetric contiguous, symmetric
#: non-contiguous, ragged, all-singleton, one slice
LAYOUTS = [
    ((0, 1), (2, 3)),
    ((0, 1, 2, 3), (4, 5, 6, 7)),
    ((0, 1), (2, 3), (4, 5), (6, 7)),
    ((0, 2), (1, 3)),
    ((0, 1, 2), (3, 4, 5, 6, 7)),
    ((0, 1, 2), (3, 4)),
    ((0,), (1,)),
    ((0,), (1,), (2,)),
    ((0, 1, 2, 3),),
    ((3, 1), (0, 2, 4)),
]


def _pair(slices):
    return Topology(slices), jtopo.Topology(slices)


def _facts(t):
    """Every derived fact of a descriptor, in plain Python values."""
    w = t.world
    out = {
        "slices": t.slices, "world": w, "num_slices": t.num_slices,
        "symmetric": t.symmetric, "contiguous": t.contiguous,
        "signature": t.signature(), "fingerprint": t.fingerprint(),
        "json": t.to_json(), "dict": t.to_dict(),
        "leaders": t.leaders(), "repr": repr(t),
        "comm_link_class": (None if t.comm_link_class() is None
                            else int(t.comm_link_class())),
        "link_class": [[int(t.link_class(a, b)) for b in range(w)]
                       for a in range(w)],
        "slice_of": [t.slice_of(r) for r in range(w)],
        "local_index": [t.local_index(r) for r in range(w)],
        "slice_leader": [t.slice_leader(r) for r in range(w)],
        "is_leader": [t.is_leader(r) for r in range(w)],
        "appended": t.with_appended_rank().slices,
    }
    if t.symmetric:
        out["rails"] = [t.rail(i) for i in range(len(t.slices[0]))]
    # subtopologies: each slice, a reversed prefix, every other rank
    subs = [list(s) for s in t.slices]
    subs += [list(range(w))[::-1][: max(1, w - 1)], list(range(0, w, 2))]
    out["subtopology"] = [t.subtopology(m).slices for m in subs]
    return out


@pytest.mark.parametrize("slices", LAYOUTS, ids=str)
def test_descriptor_equals_jax(slices):
    t, j = _pair(slices)
    assert _facts(t) == _facts(j)
    # JSON written by either package loads in the other
    assert Topology.from_json(j.to_json()) == t
    assert jtopo.Topology.from_json(t.to_json()) == j
    assert Topology.from_dict(j.to_dict()).signature() == j.signature()


@pytest.mark.parametrize("world,size", [(4, 2), (8, 4), (8, 2), (6, 3),
                                        (4, 1), (4, 4)])
def test_from_slice_size_and_flat_equal_jax(world, size):
    assert (Topology.from_slice_size(world, size).slices
            == jtopo.Topology.from_slice_size(world, size).slices)
    assert Topology.flat(world).signature() == jtopo.Topology.flat(
        world).signature()


def test_descriptor_refusals_equal_jax():
    for bad in ([(0, 1), (1, 2)], [(0, 2)], [], [()]):
        with pytest.raises(ValueError):
            jtopo.Topology(bad)
        with pytest.raises(ValueError):
            Topology(bad)
    for world, size in ((6, 4), (4, 0)):
        with pytest.raises(ValueError):
            jtopo.Topology.from_slice_size(world, size)
        with pytest.raises(ValueError):
            Topology.from_slice_size(world, size)
    with pytest.raises(ValueError, match="world"):
        Topology.from_dict({"slices": [[0, 1]], "world": 3})
    with pytest.raises(ValueError, match="symmetric"):
        Topology(((0, 1, 2), (3,))).rail(0)


@pytest.mark.parametrize("environ", [
    {"ACCL_TOPOLOGY": json.dumps({"slices": [[0, 1], [2, 3]]})},
    {"ACCL_TOPOLOGY": json.dumps({"slices": [[0, 3], [1, 2]], "world": 4})},
    {"ACCL_SLICE_SIZE": "2"},
    {"ACCL_SLICE_SIZE": "1"},
    {"ACCL_TOPOLOGY": "", "ACCL_SLICE_SIZE": "4"},
    {},
], ids=["inline", "inline-world", "slice-2", "slice-1", "empty-topo",
        "none"])
def test_from_env_equals_jax(environ):
    t = Topology.from_env(4, environ=environ)
    j = jtopo.Topology.from_env(4, environ=environ)
    assert (None if t is None else t.slices) == (
        None if j is None else j.slices)


def test_from_env_path_and_world_refusal(tmp_path):
    doc = tmp_path / "topo.json"
    doc.write_text(Topology.from_slice_size(8, 4).to_json())
    env = {"ACCL_TOPOLOGY": f"@{doc}"}
    assert (Topology.from_env(8, environ=env).slices
            == jtopo.Topology.from_env(8, environ=env).slices)
    for mod in (ttopo, jtopo):
        with pytest.raises(ValueError, match="world"):
            mod.Topology.from_env(4, environ=env)
    # torch.distributed is not initialized here: no topology from it
    assert Topology._from_torch(8) is None


COUNTS = [0, 1, 2, 3, 4, 6, 8, 12, 255, 256, 300, 512, 1000]


@pytest.mark.parametrize("slices", LAYOUTS, ids=str)
def test_hierarchical_rules_equal_jax(slices):
    t, j = _pair(slices)
    assert thier.HIER_OPS == jhier.HIER_OPS
    assert thier.multi_slice(t) == jhier.multi_slice(j)
    assert thier.gatherlike_eligible(t) == jhier.gatherlike_eligible(j)
    assert thier.bcast_eligible(t) == jhier.bcast_eligible(j)
    for n in COUNTS:
        assert thier.allreduce_mode(t, n) == jhier.allreduce_mode(j, n)
        for op in thier.HIER_OPS + ("alltoall", "reduce"):
            assert thier.eligible(op, t, n) == jhier.eligible(op, j, n)
    for root in range(t.world):
        assert (thier.bcast_representatives(t, root)
                == jhier.bcast_representatives(j, root))
    if t.symmetric and t.contiguous:
        assert (thier.reduce_scatter_permutation(t)
                == jhier.reduce_scatter_permutation(j))
    else:
        with pytest.raises(ValueError):
            jhier.reduce_scatter_permutation(j)
        with pytest.raises(ValueError):
            thier.reduce_scatter_permutation(t)
    assert thier.multi_slice(None) is jhier.multi_slice(None) is False


# ---------------------------------------------------------------------------
# the hierarchical collectives, bit for bit against JAX's gang
# ---------------------------------------------------------------------------

#: (name, slices): bench.py's 2 x 4, a 2 x 2 and the ragged leader layout
HIER_LAYOUTS = [
    ("2x2", ((0, 1), (2, 3))),
    ("2x4", ((0, 1, 2, 3), (4, 5, 6, 7))),
    ("ragged", ((0, 1, 2), (3, 4, 5, 6, 7))),
]

#: (op, reduce function, bcast root): SUM and MAX, bcast at two roots
HIER_CASES = [
    ("allreduce", "SUM", 0), ("allreduce", "MAX", 0),
    ("allgather", "SUM", 0),
    ("reduce_scatter", "SUM", 0), ("reduce_scatter", "MAX", 0),
    ("bcast", "SUM", 0), ("bcast", "SUM", -1),
]


@pytest.fixture(scope="module", params=HIER_LAYOUTS, ids=lambda p: p[0])
def hier_groups(request):
    """JAX's gang and the port's CPU gang over one layout, both holding
    its topology."""
    _, slices = request.param
    world = sum(len(s) for s in slices)
    jg = xla_group(world, topology=jtopo.Topology(slices))
    tg = at.cuda_group(world, device="cpu", topology=Topology(slices))
    yield slices, jg, tg
    for a in jg + tg:
        a.deinit()


def _integer_data(world, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-64, 64, size=n).astype(np.float32)
            for _ in range(world)]


def _hier_run(group, op, fn_name, root, data, n):
    world = len(data)
    seg = n // world

    def work(a, r):
        port = type(a).__module__.startswith("accl_tpu_torch")
        rf = (at.ReduceFunction if port else JReduceFunction)[fn_name]
        if op == "allreduce":
            s = a.create_buffer_from(data[r])
            d = a.create_buffer(n, np.float32)
            a.allreduce(s, d, n, function=rf)
            return np.asarray(d.device_view()[:n]).copy()
        if op == "allgather":
            s = a.create_buffer_from(data[r][:seg])
            d = a.create_buffer(seg * world, np.float32)
            a.allgather(s, d, seg)
            return np.asarray(d.device_view()[:seg * world]).copy()
        if op == "reduce_scatter":
            s = a.create_buffer_from(data[r][:seg * world])
            d = a.create_buffer(seg, np.float32)
            a.reduce_scatter(s, d, seg, function=rf)
            return np.asarray(d.device_view()[:seg]).copy()
        s = a.create_buffer_from(data[r])
        a.bcast(s, n, root=root)
        return np.asarray(s.device_view()[:n]).copy()

    return run_parallel(group, work)


def _numpy_want(op, fn_name, root, data, n):
    world = len(data)
    seg = n // world
    red = np.sum if fn_name == "SUM" else np.max
    if op == "allreduce":
        return [red(np.stack(data), 0)] * world
    if op == "allgather":
        return [np.concatenate([d[:seg] for d in data])] * world
    if op == "reduce_scatter":
        full = red(np.stack([d[:seg * world] for d in data]), 0)
        return [full[r * seg:(r + 1) * seg] for r in range(world)]
    return [data[root]] * world


@pytest.mark.parametrize("op,fn_name,root", HIER_CASES,
                         ids=[f"{o}-{f}-{r}" for o, f, r in HIER_CASES])
def test_hierarchical_ops_equal_jax_bit_for_bit(hier_groups, op, fn_name,
                                                root):
    slices, jg, tg = hier_groups
    world = len(tg)
    root = root % world
    # 2^9 + 8: divisible by every slice size here but 3 and 5, so the
    # ragged layout's allreduce takes leader mode and 2 x 2 rail mode
    n = 520 if world == 8 else 512
    data = _integer_data(world, n, seed=43 + world)
    results = {}
    for name, group in (("jax", jg), ("port", tg)):
        for hier in (0, 1):
            for a in group:
                a.set_tuning("hierarchical", hier)
                a._hier_comms.clear()  # re-derived, under the same ids
            results[name, hier] = _hier_run(group, op, fn_name, root, data,
                                            n)
    want = _numpy_want(op, fn_name, root, data, n)
    for r in range(world):
        for key, got in results.items():
            assert np.array_equal(got[r], want[r]), f"{key} rank {r}"
    # the port decomposed where JAX would: subcomms were derived
    topo = tg[0].topology
    count = n // world if op in ("allgather", "reduce_scatter") else n
    assert bool(tg[0]._hier_comms) == thier.eligible(op, topo, count)
    for a in tg:
        a.set_tuning("hierarchical", 0)


def test_leader_mode_on_a_count_the_slice_does_not_divide():
    """2 x 2 at an odd count: the symmetric layout falls back to leader
    mode (reduce -> leaders' allreduce -> bcast), equal to flat."""
    topo = Topology.from_slice_size(4, 2)
    n = 257
    assert thier.allreduce_mode(topo, n) == "leader"
    data = _integer_data(4, n, seed=5)
    g = at.cuda_group(4, device="cpu", topology=topo)
    try:
        flat = _hier_run(g, "allreduce", "SUM", 0, data, n)
        for a in g:
            a.set_tuning("hierarchical", 1)
        hier = _hier_run(g, "allreduce", "SUM", 0, data, n)
        st = g[0]._hier_state(g[0].comm)
        assert "leaders" in st and ("intra", 0) in st
        for r in range(4):
            assert np.array_equal(flat[r], hier[r])
    finally:
        for a in g:
            a.deinit()


def test_async_hierarchical_calls_from_one_thread():
    """Every rank posts its hierarchical call from ONE thread with
    ``run_async=True`` (the autotuner's harness): the stages chain on
    done-callbacks, never blocking the poster, and a non-leader's wait
    at the bcast's rendezvous is a post.  ``flush()`` drains the
    aggregates."""
    topo = Topology(((0, 1, 2), (3, 4)))
    n = 300
    data = _integer_data(5, n, seed=23)
    g = at.cuda_group(5, device="cpu", topology=topo)
    try:
        for a in g:
            a.set_tuning("hierarchical", 1)
        sends = [a.create_buffer_from(d) for a, d in zip(g, data)]
        recvs = [a.create_buffer(n, np.float32) for a in g]
        reqs = [a.allreduce(s, d, n, run_async=True)
                for a, s, d in zip(g, sends, recvs)]
        for a in g:
            a.flush()
        for q in reqs:
            assert q.wait(30)
            q.check()
        want = np.sum(np.stack(data), 0)
        for d in recvs:
            assert np.array_equal(d.device_view()[:n], want)
        for a in g:  # every stage has run: the drain point empties
            a.flush()
        assert g[0].engine.gang.window.in_flight() == 0
    finally:
        for a in g:
            a.deinit()


def test_failing_stage_fails_the_aggregate():
    """A stage that raises fails the aggregate with INVALID_OPERATION;
    nothing falls back to a flat call."""
    topo = Topology.from_slice_size(4, 2)
    g = at.cuda_group(4, device="cpu", topology=topo)
    try:
        a = g[0]
        a.set_tuning("hierarchical", 1)

        def boom():
            raise RuntimeError("stage down")

        q = a._launch_hier_stages("allreduce", [boom], True, "allreduce")
        assert q.wait(5)
        assert q.get_retcode() == at.ErrorCode.INVALID_OPERATION
        with pytest.raises(at.ACCLError, match="stage down"):
            q.check("allreduce")
    finally:
        for x in g:
            x.deinit()


def test_explicit_compression_stays_flat():
    """An explicit ``compress_dtype`` is honoured exactly: the call
    stays flat, no subcomm is derived (JAX's
    ``test_hierarchical_explicit_compression_stays_flat``)."""
    topo = Topology.from_slice_size(4, 2)
    n = 512
    data = _integer_data(4, n, seed=5)
    g = at.cuda_group(4, device="cpu", topology=topo)
    try:
        for a in g:
            a.set_tuning("hierarchical", 1)

        def work(a, r):
            s = a.create_buffer_from(data[r])
            d = a.create_buffer(n, np.float32)
            a.allreduce(s, d, n, compress_dtype=np.float16)
            return np.asarray(d.device_view()[:n]).copy()

        out = run_parallel(g, work)
        assert g[0]._hier_comms == {}
        assert np.array_equal(out[0], np.sum(np.stack(data), 0))
    finally:
        for a in g:
            a.deinit()


def test_plan_key_topology_axis_and_invalidation():
    """The signature is a plan-key axis before ``extra`` (JAX's
    ``test_plan_key_topology_axis_and_invalidation``); ``set_topology``
    clears the pool once and drops the derived subcomms, so the next
    call re-plans once."""
    topo = Topology.from_slice_size(4, 2)
    g = at.cuda_group(4, device="cpu", topology=topo)
    jg = xla_group(4, topology=jtopo.Topology.from_slice_size(4, 2))
    try:
        a, j = g[0], jg[0]
        p = a._plan_for(Operation.ALLREDUCE, a.comm, DataType.FLOAT32, 256,
                        None, 0, (0,))
        jp = j._plan_for(JOperation.ALLREDUCE, j.comm, JDataType.FLOAT32,
                         256, None, 0, (0,))
        assert p.key[-2:] == jp.key[-2:] == ("2x2", (0,))
        assert p.link_class is None and jp.link_class is None
        n = 512
        data = _integer_data(4, n, seed=9)
        for x in g:
            x.set_tuning("hierarchical", 1)
        _hier_run(g, "allreduce", "SUM", 0, data, n)
        assert g[0]._hier_comms
        before = a.capabilities()["plan_cache"]
        for x in g:
            x.set_topology(Topology.from_slice_size(4, 2))
        after = a.capabilities()["plan_cache"]
        assert after["invalidations"] == before["invalidations"] + 1
        assert after["last_invalidation"] == "set_topology"
        assert all(not x._hier_comms for x in g)
        # the next call re-plans once on the world (then the stages'
        # subcomms, derived afresh, plan their own)
        p2 = a._plan_for(Operation.ALLREDUCE, a.comm, DataType.FLOAT32, n,
                         None, 0, (0,))
        assert a.capabilities()["plan_cache"]["misses"] == after["misses"] + 1
        assert p2 is a._plan_for(Operation.ALLREDUCE, a.comm,
                                 DataType.FLOAT32, n, None, 0, (0,))
        # detaching re-keys: a None signature axis
        for x in g:
            x.set_topology(None)
        p3 = a._plan_for(Operation.ALLREDUCE, a.comm, DataType.FLOAT32, n,
                         None, 0, (0,))
        assert p3.key[-2] is None and p3.key != p2.key
        assert not p3.hierarchical
        with pytest.raises(ValueError, match="world"):
            a.set_topology(Topology.from_slice_size(2, 1))
    finally:
        for x in g + jg:
            x.deinit()


#: register writes and the verdict after each, per topology
LADDER = [
    ("dcn", [("wire_dtype_dcn", "int8")]),
    ("dcn", [("wire_dtype_dcn", "off"), ("wire_dtype", "int8")]),
    ("dcn", [("wire_dtype", "int8"), ("wire_dtype_dcn", "float8_e4m3")]),
    ("dcn", [("wire_dtype_ici", "float16")]),
    ("ici", [("wire_dtype_dcn", "int8")]),
    ("ici", [("wire_dtype_ici", "int8")]),
    ("ici", [("wire_dtype_ici", "bfloat16"), ("wire_dtype", "float16")]),
    ("mixed", [("wire_dtype_ici", "int8"), ("wire_dtype_dcn", "int8")]),
    ("mixed", [("wire_dtype_dcn", "int8"), ("wire_dtype", "bfloat16")]),
]


@pytest.mark.parametrize("layout,writes", LADDER,
                         ids=[f"{l}-{i}" for i, (l, _) in enumerate(LADDER)])
def test_per_class_wire_ladder_equals_jax(layout, writes):
    """The per-link-class ladder resolves as JAX's ``_plan_for``: a
    class-uniform comm reads its class register first, 0 defers to
    ``wire_dtype``, a mixed comm reads ``wire_dtype`` alone."""
    slices = {"dcn": ((0,), (1,)), "ici": ((0, 1),),
              "mixed": ((0, 1), (2, 3))}[layout]
    world = sum(len(s) for s in slices)
    g = at.cuda_group(world, device="cpu", topology=Topology(slices))
    jg = xla_group(world, topology=jtopo.Topology(slices))
    try:
        for name, value in writes:
            for a in g:
                a.set_tuning(name, value)
            for a in jg:
                a.set_tuning(name, value)
        for fn in (0, 1):  # SUM, and MAX (no int8 lane under MAX)
            p = g[0]._plan_for(Operation.ALLREDUCE, g[0].comm,
                               DataType.FLOAT32, 512, None, 0, (fn,))
            jp = jg[0]._plan_for(JOperation.ALLREDUCE, jg[0].comm,
                                 JDataType.FLOAT32, 512, None, 0, (fn,))
            assert (None if p.wire_dtype is None else p.wire_dtype.name) == (
                None if jp.wire_dtype is None else jp.wire_dtype.name)
            assert (p.link_class is None) == (jp.link_class is None)
            if p.link_class is not None:
                assert int(p.link_class) == int(jp.link_class)
    finally:
        for a in g + jg:
            a.deinit()


def test_error_feedback_residuals_key_per_link_class():
    """EF residual streams carry the comm's link class (JAX's
    ``test_error_feedback_residuals_key_per_link_class``)."""
    rng = np.random.default_rng(11)
    n = 512
    g = at.cuda_group(2, device="cpu", topology=Topology(((0,), (1,))))
    try:
        for a in g:
            a.set_tuning("wire_dtype_dcn", "int8")
            a.set_error_feedback(True)
        data = [rng.standard_normal(n).astype(np.float32) for _ in g]
        sends = [a.create_buffer_from(d.copy()) for a, d in zip(g, data)]
        recvs = [a.create_buffer(n, np.float32) for a in g]
        run_parallel(g, lambda a, r: a.allreduce(sends[r], recvs[r], n))
        a = g[0]
        key = (a.comm.id, a.comm.epoch, Operation.ALLREDUCE, n, 0,
               int(LinkClass.DCN))
        assert a._residuals.residual(key) is not None
        for other in (-1, int(LinkClass.ICI)):
            assert a._residuals.residual(key[:-1] + (other,)) is None
        err = float(np.abs(recvs[0].device_view() - (data[0] + data[1])).max())
        assert 0 < err < 0.2  # the lossy DCN lane engaged, bounded
    finally:
        for a in g:
            a.deinit()


def test_split_derived_subcomm_link_classes_truthful():
    """JAX's ``test_split_derived_subcomm_link_classes_truthful`` on the
    port: an intra-slice subcomm is ICI-uniform, a cross-slice one
    DCN-uniform; the dumps report the signature."""
    g = at.cuda_group(4, device="cpu",
                      topology=Topology.from_slice_size(4, 2))
    try:
        def work(a, r):
            c = a.create_communicator([0, 1] if r < 2 else [2, 3])
            return c.topology.comm_link_class()

        out = run_parallel(g, work)
        assert out == [LinkClass.ICI] * 4

        def cross(a, r):
            if r in (0, 2):
                c = a.create_communicator([0, 2])
                return c.topology.comm_link_class(), c.as_dict()["topology"]
            return None

        out = run_parallel(g, cross)
        assert out[0] == (LinkClass.DCN, Topology(((0,), (1,))).signature())
        assert g[0].comm.as_dict()["topology"] == "2x2"
        assert "topology=2x2" in g[0].comm.dump()
        assert g[0].topology == Topology.from_slice_size(4, 2)
    finally:
        for a in g:
            a.deinit()


def test_construction_topology_from_env_and_world_check(monkeypatch):
    monkeypatch.setenv("ACCL_SLICE_SIZE", "2")
    g = at.cuda_group(4, device="cpu")
    try:
        assert g[0].topology.slices == ((0, 1), (2, 3))
    finally:
        for a in g:
            a.deinit()
    monkeypatch.delenv("ACCL_SLICE_SIZE")
    with pytest.raises(ValueError, match="world"):
        at.cuda_group(4, device="cpu", topology=Topology.flat(3))
