"""The port's dispatch plane against the JAX gang: sub-communicators,
collective plans, the prepared warm path, fused batches, the host-staged
path, the device-interaction counter and the rest of the buffer API.

``cuda_group(4, device="cpu")`` and ``xla_group(4)`` (the conftest's 8
virtual CPU devices) run the same programs, one thread per rank.  The
counters mirror ``tests/test_dispatch_overhead.py``; the buffer cases
mirror ``tests/test_device_buffer.py``.  The host-staged cases hold the
port's host path against JAX's ``_run_op_host`` where its ranks have no
device mesh: a four-member communicator of ``xla_group(9)`` whose members
lie past the eighth device (``submesh`` gives None), bit for bit.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from accl_tpu.core import xla_group
from helpers import run_parallel

import accl_tpu_torch as at
from accl_tpu_torch.backends.cuda.engine import CudaGangContext
from accl_tpu_torch.buffer import DeviceBuffer, HostBuffer
from accl_tpu_torch.communicator import Communicator, Rank
from accl_tpu_torch.constants import DataType
from accl_tpu_torch.ops import collectives
from accl_tpu_torch.plans import PlanCache, size_bucket

P = 4


@pytest.fixture(scope="module")
def groups():
    """The JAX gang and the port's CPU gang, four ranks each."""
    jg = xla_group(P)
    tg = at.cuda_group(P, device="cpu")
    yield jg, tg
    for a in jg + tg:
        a.deinit()


@pytest.fixture
def port():
    g = at.cuda_group(P, device="cpu")
    yield g
    for a in g:
        a.deinit()


def _ic(a) -> int:
    caps = a.capabilities()
    assert isinstance(caps["device_interactions"], int)
    return caps["device_interactions"]


def _pc(a) -> dict:
    return a.capabilities()["plan_cache"]


def _full(group, n, value=lambda r: r + 1.0, host_only=False):
    return [a.create_buffer_from(np.full(n, value(r), np.float32),
                                 host_only=host_only)
            for r, a in enumerate(group)]


def _read(buf) -> np.ndarray:
    buf.sync_from_device()
    return np.asarray(buf.host_view()).copy()


# ---------------------------------------------------------------------------
# the gang's device
# ---------------------------------------------------------------------------


def test_gang_context_takes_the_card_or_raises(monkeypatch):
    """``CudaGangContext()`` resolves the card, as every entry point does:
    without one it raises, and it runs on the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaGangContext()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaGangContext(device="cuda")
    assert CudaGangContext(device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# communicators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("members", [[0, 1], [2, 3], [1, 3], [3, 1, 0],
                                     [0, 1, 2, 3], [2]])
def test_create_communicator_equals_jax(groups, members):
    """The derived id, the membership (None off it), the local rank and
    each rank's session equal the JAX facade's."""
    jg, tg = groups
    for r in range(P):
        jc = jg[r].create_communicator(members)
        tc = tg[r].create_communicator(members)
        assert (jc is None) == (tc is None) == (r not in members)
        if jc is None:
            continue
        assert tc.id == jc.id
        assert tc.local_rank == jc.local_rank == members.index(r)
        assert [x.session for x in tc.ranks] == [x.session for x in jc.ranks]
        # a nested split derives from the sub-communicator's id
        inner = list(range(tc.size))[::-1]
        assert (tg[r].create_communicator(inner, base=tc).id
                == jg[r].create_communicator(inner, base=jc).id)


@pytest.mark.parametrize("members", [[0, 0], [0, 4], [-1, 1]])
def test_create_communicator_refusals_equal_jax(groups, members):
    jg, tg = groups
    for g in (jg, tg):
        with pytest.raises(ValueError) as ei:
            g[0].create_communicator(members)
        assert ("duplicate" in str(ei.value)) == (members == [0, 0])


def test_communicator_sequences_and_dump():
    ranks = [Rank(address=f"cpu:{i}", session=i) for i in range(3)]
    c = Communicator(ranks, 1, comm_id=7)
    assert [c.next_outbound_seq(2) for _ in range(3)] == [0, 1, 2]
    c.advance_inbound_seq(0)
    assert c.peek_inbound_seq(0) == 1
    d = c.as_dict()
    assert d["ranks"][2]["seq_out"] == 3 and d["ranks"][0]["seq_in"] == 1
    assert d["id"] == 7 and d["topology"] is None
    assert "seq_out=3" in c.dump()
    epoch = c.epoch
    c.reset_sequences()
    assert c.epoch != epoch and c.peek_inbound_seq(0) == 0
    sub = c.split([2, 1])
    assert sub.local_rank == 1 and sub.ranks[0].session == 2
    assert c.split([0, 2]) is None


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def test_plan_cache_unit():
    pc = PlanCache(maxsize=2)
    seen = []
    pc.add_invalidation_hook(seen.append)
    assert size_bucket(1) == 0 and size_bucket(1024) == 10
    assert size_bucket(2047) == 10
    plan, hit = pc.get_with_flag(("k",))
    assert plan is None and not hit
    from accl_tpu_torch.plans import CollectivePlan

    p = pc.store(CollectivePlan(("k", ("fuse", 2)), None, 0, None, 3, None,
                                "xla"))
    assert pc.get(("k", ("fuse", 2))) is p and p.fuse == 2
    assert p.pipeline_for(1 << 30) == 1
    pc.invalidate("why")
    assert seen == ["why"] and len(pc) == 0
    st = pc.stats()
    assert (st["hits"], st["misses"], st["invalidations"]) == (1, 1, 1)
    assert pc.adopt_verdicts([{"a": 1}, 3]) == 1


def _run_sequence(group):
    """One call sequence, the same on either facade; returns rank 0's
    plan-cache counters after every step."""
    n = 48
    send = _full(group, 5 * n)
    recv = _full(group, 4 * n, lambda r: 0.0)
    steps = []

    def call(fn):
        run_parallel(group, fn)
        pc = _pc(group[0])
        steps.append((pc["hits"], pc["misses"], pc["size"]))

    def ar(a, r, comm=None, count=n):
        a.allreduce(send[r], recv[r], count, comm=comm)

    call(ar)
    call(ar)
    call(lambda a, r: ar(a, r, count=n + 3))   # same bucket: a hit
    call(lambda a, r: ar(a, r, count=2 * n))   # another bucket: a miss
    call(lambda a, r: a.allreduce(send[r], recv[r], n,
                                  compress_dtype=np.float16))
    call(lambda a, r: a.reduce_scatter(send[r], recv[r], n))
    call(lambda a, r: a.allgather(send[r], recv[r], n))
    call(lambda a, r: a.bcast(recv[r], n, root=2))
    call(lambda a, r: a.reduce(send[r], recv[r], n, root=1))
    call(lambda a, r: a.gather(send[r], recv[r], n, root=3))
    call(lambda a, r: a.scatter(send[r], recv[r], n, root=0))
    call(lambda a, r: a.alltoall(send[r], recv[r], n))
    call(lambda a, r: a.fused_apply(send[r], recv[r], n, lr=0.5))
    call(lambda a, r: a.barrier())
    for a in group:
        a.set_tuning("ring_segments", 1)
    call(ar)
    call(ar)
    return steps


def test_plan_cache_counters_equal_jax():
    """After the same call sequence -- warm and cold calls, a second
    bucket, every collective, a fused slot, a register write -- the
    plan pool's hits, misses, size and invalidations equal JAX's at
    every step (both constructions write RESET and the eager threshold,
    two invalidations, before the first call)."""
    jg, tg = xla_group(P), at.cuda_group(P, device="cpu")
    try:
        j0, t0 = _pc(jg[0]), _pc(tg[0])
        assert (j0["hits"], j0["misses"], j0["invalidations"]) == (
            t0["hits"], t0["misses"], t0["invalidations"])
        assert _run_sequence(tg) == _run_sequence(jg)
        assert _pc(tg[0])["invalidations"] == _pc(jg[0])["invalidations"]
    finally:
        for a in jg + tg:
            a.deinit()


def test_plan_carries_the_wire_verdict(port):
    """The ``wire_dtype`` register's verdict is baked into the allreduce's
    plan; a register write clears the pool, so the next call re-plans."""
    n = 32
    send, recv = _full(port, n), _full(port, n, lambda r: 0.0)
    for a in port:
        a.set_tuning("wire_dtype", "bfloat16")
    run_parallel(port, lambda a, r: a.allreduce(send[r], recv[r], n))
    (plan,) = port[0]._plans._plans.values()
    assert plan.wire_dtype == DataType.BFLOAT16
    assert plan.describe()["wire_dtype"] == "BFLOAT16"
    # int8 under MAX keeps the uncompressed wire
    for a in port:
        a.set_tuning("wire_dtype", "int8")
    run_parallel(port, lambda a, r: a.allreduce(
        send[r], recv[r], n, function=at.ReduceFunction.MAX))
    (plan,) = port[0]._plans._plans.values()
    assert plan.wire_dtype is None
    np.testing.assert_array_equal(_read(recv[0]), 4.0)


# ---------------------------------------------------------------------------
# one collective == one device interaction (test_dispatch_overhead.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [None, np.float16])
def test_warm_allreduce_is_one_interaction_and_a_plan_hit(groups, compress):
    for g in groups:
        n = 64
        send, recv = _full(g, n), _full(g, n, lambda r: 0.0)

        def work(a, r):
            a.allreduce(send[r], recv[r], n, compress_dtype=compress)

        run_parallel(g, work)  # cold: plans, parks the template
        run_parallel(g, work)  # first hit: prepares the handle
        ic0, pc0 = _ic(g[0]), _pc(g[0])
        run_parallel(g, work)
        assert _ic(g[0]) - ic0 == 1
        pc1 = _pc(g[0])
        assert pc1["hits"] - pc0["hits"] >= 1
        assert pc1["misses"] == pc0["misses"]
        for r in range(P):
            np.testing.assert_allclose(_read(recv[r]), 10.0, rtol=1e-3)


def test_warm_call_takes_the_prepared_handle(port):
    """The plan parks the template and the handle: the warm call runs it;
    a view operand is refused by the template and takes the full path,
    still one interaction, with the same result."""
    n = 40
    send, recv = _full(port, 2 * n), _full(port, n, lambda r: 0.0)
    for a in port:
        a.set_tuning("allreduce_algorithm", "pallas_ring")
    run_parallel(port, lambda a, r: a.allreduce(send[r], recv[r], n))
    run_parallel(port, lambda a, r: a.allreduce(send[r], recv[r], n))
    plan = next(iter(port[0]._plans._plans.values()))
    (state,) = plan.engine["gang"].values()
    assert set(state["handles"]) == {2 * n}  # keyed by operand width
    assert state["handles"][2 * n].op == "pallas_allreduce"
    ic0 = _ic(port[0])
    views = [s.slice(0, n) for s in send]
    run_parallel(port, lambda a, r: a.allreduce(views[r], recv[r], n))
    assert _ic(port[0]) - ic0 == 1
    np.testing.assert_array_equal(_read(recv[3]), 10.0)


def test_width_slack_operand_is_one_interaction(groups):
    for g in groups:
        n, width = 48, 64
        send, recv = _full(g, width), _full(g, n, lambda r: 0.0)

        def work(a, r):
            a.allreduce(send[r], recv[r], n)

        run_parallel(g, work)
        ic0 = _ic(g[0])
        run_parallel(g, work)
        assert _ic(g[0]) - ic0 == 1
        np.testing.assert_allclose(_read(recv[2]), 10.0)


def test_width_slack_result_needs_no_writeback(groups):
    """A result wider than the output: JAX parks a writeback program per
    rank and runs it at wait() (1 interaction at dispatch, 1 + 4 after);
    the port's kernels write the result's first elements in place, so
    there is nothing to defer (1 after wait too).  ROADMAP C records it."""
    counts = []
    for g in groups:
        n, res_width = 32, 64
        send, recv = _full(g, n), _full(g, res_width, lambda r: 0.0)
        run_parallel(g, lambda a, r: a.allreduce(send[r], recv[r], n))
        reqs = [None] * P

        def work(a, r):
            reqs[r] = a.allreduce(send[r], recv[r], n, run_async=True)

        ic0 = _ic(g[0])
        run_parallel(g, work)
        for q in reqs:
            assert q._done.wait(30)
        at_dispatch = _ic(g[0]) - ic0
        for q in reqs:
            assert q.wait(30)
            q.check()
        counts.append((at_dispatch, _ic(g[0]) - ic0))
        out = _read(recv[1])
        np.testing.assert_allclose(out[:n], 10.0)
        np.testing.assert_array_equal(out[n:], 0.0)
    assert counts == [(1, 1 + P), (1, 1)]


def test_batch_of_n_is_one_interaction(groups):
    for g in groups:
        n, world = 16, len(g)
        send = _full(g, n)
        rs_send = _full(g, world * n)
        ar, rs = _full(g, n, lambda r: 0.0), _full(g, n, lambda r: 0.0)
        ag = _full(g, world * n, lambda r: 0.0)

        def work(a, r):
            with a.batch():
                q = [a.allreduce(send[r], ar[r], n, run_async=True),
                     a.allgather(send[r], ag[r], n, run_async=True),
                     a.reduce_scatter(rs_send[r], rs[r], n, run_async=True)]
            for req in q:
                assert req.wait(60)
                req.check()

        run_parallel(g, work)
        ic0 = _ic(g[0])
        run_parallel(g, work)
        assert _ic(g[0]) - ic0 == 1
        for r in range(P):
            np.testing.assert_allclose(_read(ar[r]), 10.0)
            np.testing.assert_allclose(_read(rs[r]), 10.0)
            np.testing.assert_allclose(
                _read(ag[r]).reshape(world, n),
                np.broadcast_to(np.arange(1.0, 5.0)[:, None], (world, n)))


def test_set_tuning_forces_exactly_one_replan(groups):
    for g in groups:
        n = 32
        send, recv = _full(g, n), _full(g, n, lambda r: 0.0)

        def work(a, r):
            a.allreduce(send[r], recv[r], n)

        run_parallel(g, work)
        run_parallel(g, work)
        for a in g:  # a write of the default value still invalidates
            a.set_tuning("ring_segments", 1)
        pc0 = _pc(g[0])
        assert pc0["size"] == 0 and pc0["last_invalidation"] == "set_tuning"
        run_parallel(g, work)
        pc1 = _pc(g[0])
        assert pc1["misses"] - pc0["misses"] == 1
        run_parallel(g, work)
        pc2 = _pc(g[0])
        assert pc2["misses"] == pc1["misses"]
        assert pc2["hits"] - pc1["hits"] >= 1


def test_subcomm_epoch_churn_is_exactly_one_miss(groups):
    """A re-created same-membership sub-communicator keeps its id, gets a
    fresh epoch, and its first call re-plans exactly once."""
    for g in groups:
        n = 16
        send = _full(g[:2], n)
        recv = _full(g[:2], n, lambda r: 0.0)
        sub = [a.create_communicator([0, 1]) for a in g]
        assert sub[2] is None and sub[3] is None
        assert sub[0].id == sub[1].id

        def work(comms):
            run_parallel(g[:2], lambda a, r: a.allreduce(
                send[r], recv[r], n, comm=comms[r]))
            for r in range(2):
                np.testing.assert_allclose(_read(recv[r]), 3.0)

        work(sub)
        pc0 = _pc(g[0])
        work(sub)
        pc1 = _pc(g[0])
        assert pc1["hits"] - pc0["hits"] >= 1
        assert pc1["misses"] == pc0["misses"]
        sub2 = [a.create_communicator([0, 1]) for a in g]
        assert sub2[0].id == sub[0].id and sub2[0].epoch != sub[0].epoch
        pc2 = _pc(g[0])
        work(sub2)
        assert _pc(g[0])["misses"] - pc2["misses"] == 1


@pytest.mark.parametrize("algo", ["xla", "pallas_ring", "pallas_ring_bidir"])
def test_one_member_communicator(port, algo):
    """A one-member communicator's allreduce is its operand (K1's P = 1
    branch under the ring registers), one interaction, warm or not."""
    n = 24
    data = np.arange(n, dtype=np.float32)
    a = port[2]
    a.set_tuning("allreduce_algorithm", algo)
    solo = a.create_communicator([2])
    assert solo.size == 1 and solo.local_rank == 0
    s, d = a.create_buffer_from(data), a.create_buffer(n, np.float32)
    for _ in range(3):
        ic0 = _ic(a)
        a.allreduce(s, d, comm=solo)
        assert _ic(a) - ic0 == 1
        np.testing.assert_array_equal(_read(d), data)


def test_capabilities_keys_equal_jax(groups):
    jg, tg = groups
    jc, tc = jg[0].capabilities(), tg[0].capabilities()
    assert set(tc) == set(jc)  # every key of JAX's report
    assert set(tc["plan_cache"]) == set(jc["plan_cache"])
    for key in ("device_tier", "wire_compression", "arithmetic",
                "world_size", "inflight_window", "tuning_plan", "telemetry",
                "monitor", "health", "membership", "contract_verify",
                "streams", "rendezvous", "platform"):
        assert tc[key] == jc[key]
    assert tc["engine"] == "CudaEngine"
    assert tc["native_dataplane"] is False  # until the host tiers (A12)


# ---------------------------------------------------------------------------
# fused batches (the batches the command ring refuses)
# ---------------------------------------------------------------------------


def _batch_then_single(port, make_calls, npos):
    """Run ``npos`` calls as one batch, then the same calls one by one
    into fresh results; returns (batched results, single results, the
    batch's interactions, the ring's fallbacks)."""
    outs = {}

    def work(a, r, batched):
        with a.batch() if batched else _nullcontext():
            reqs = make_calls(a, r, batched)
        for q in reqs:
            assert q.wait(60)
            q.check()

    for batched in (True, False):
        ic0 = _ic(port[0])
        run_parallel(port, lambda a, r: work(a, r, batched))
        outs[batched] = _ic(port[0]) - ic0
    return outs, port[0].engine.gang.cmdring.stats()["fallbacks"]


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("reason", ["oversized", "unsupported_op"])
def test_fused_batch_equals_calls_one_by_one(port, reason):
    """A batch the ring refuses runs as ONE fused dispatch of the plain
    lowerings and equals the same calls one by one (a reduce has no
    sequencer opcode; the fp8 lane that the ring refused before rides it
    now)."""
    n, npos = 64, 8
    rng = np.random.default_rng(5)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(P)]
    if reason == "oversized":
        port[0].engine.gang.cmdring.max_bytes = 4 * n - 4
    res = {b: [[a.create_buffer(n, np.float32) for _ in range(npos)]
               for a in port] for b in (True, False)}
    send = [a.create_buffer_from(data[r] * (r + 1)) for r, a in
            enumerate(port)]

    def calls(a, r, batched):
        if reason == "unsupported_op":
            return [a.reduce(send[r], res[batched][r][0], n, root=0,
                             run_async=True)] + [
                a.allreduce(send[r], res[batched][r][i], n, run_async=True)
                for i in range(1, npos)]
        return [a.allreduce(send[r], res[batched][r][i], n, run_async=True)
                for i in range(npos)]

    counts, fallbacks = _batch_then_single(port, calls, npos)
    assert counts == {True: 1, False: npos}
    assert fallbacks == {reason: 1}
    for r in range(P):
        for i in range(npos):
            np.testing.assert_array_equal(_read(res[True][r][i]),
                                          _read(res[False][r][i]))


def test_fused_batch_refuses_a_data_dependency(port):
    """A position reading an earlier position's result: the ring and the
    fused batch both refuse it, the positions run in order (one
    interaction each), and the chain sees the earlier result."""
    n = 32
    a0 = _full(port, n)
    mid = _full(port, n, lambda r: 0.0)
    out = _full(port, n, lambda r: 0.0)

    def calls(a, r, batched):
        return [a.allreduce(a0[r], mid[r], n, run_async=True),
                a.allreduce(mid[r], out[r], n, run_async=True)]

    counts, fallbacks = _batch_then_single(port, calls, 2)
    assert counts == {True: 2, False: 2}
    assert fallbacks == {"data_dependency": 1}
    np.testing.assert_array_equal(_read(out[0]), 40.0)


def test_fused_batch_keeps_the_registers(port):
    """A non-``xla`` register keeps its meaning: neither the ring nor the
    fused batch takes the window."""
    n = 32
    send, recv = _full(port, n), _full(port, n, lambda r: 0.0)
    for a in port:
        a.set_tuning("allreduce_algorithm", "pallas_ring")

    def calls(a, r, batched):
        return [a.allreduce(send[r], recv[r], n, run_async=True)
                for _ in range(3)]

    counts, fallbacks = _batch_then_single(port, calls, 3)
    assert counts == {True: 3, False: 3}
    assert fallbacks == {"tuning_override": 1}


# ---------------------------------------------------------------------------
# buffers (test_device_buffer.py)
# ---------------------------------------------------------------------------


def test_host_only_buffer_factory(port):
    h = port[0].create_buffer(4, np.float32, host_only=True)
    assert isinstance(h, HostBuffer) and h.is_host_only
    d = port[0].create_buffer(4, np.float32)
    assert isinstance(d, DeviceBuffer) and not d.is_host_only
    data = np.arange(6, dtype=np.float32)
    h2 = port[1].create_buffer_from(data, host_only=True)
    data[0] = 9.0  # the host side aliases the array
    assert h2.data[0] == 9.0 and h2.device_view()[0] == 9.0
    assert h2.slice(2, 4).data.tolist() == [2.0, 3.0]


def test_device_buffer_slice_writeback():
    buf = DeviceBuffer(10, DataType.FLOAT32, "cpu")
    buf.data[:] = np.arange(10, dtype=np.float32)
    buf.sync_to_device()
    sl = buf.slice(2, 6)
    assert sl.count == 4 and sl._root() is buf and sl._root_offset() == 2
    np.testing.assert_array_equal(sl.device_array().numpy(),
                                  [2.0, 3.0, 4.0, 5.0])
    assert sl.store(torch.full((4,), 9.0))
    buf.sync_from_device()
    np.testing.assert_array_equal(buf.data, [0, 1, 9, 9, 9, 9, 6, 7, 8, 9])
    assert sl.host_view().base is not None


def test_device_buffer_partial_store_preserves_tail():
    buf = DeviceBuffer(8, DataType.FLOAT32, "cpu")
    buf.data[:] = np.arange(8, dtype=np.float32)
    buf.sync_to_device()
    buf.store(torch.full((3,), -1.0), 3)
    buf.sync_from_device()
    np.testing.assert_array_equal(buf.data, [-1, -1, -1, 3, 4, 5, 6, 7])


def test_store_validates_shape_and_dtype():
    buf = DeviceBuffer(8, DataType.FLOAT32, "cpu")
    with pytest.raises(ValueError):
        buf.store(torch.zeros(4), 8)  # too short
    with pytest.raises(TypeError):
        buf.store(torch.zeros(8, dtype=torch.int32), 8)  # wrong dtype


def test_deferred_stores_resolve_in_issue_order():
    """Deferred placements chain on the root, run once, in issue order,
    before any device read; freeing a slice keeps them, freeing the root
    drops them."""
    buf = DeviceBuffer(6, DataType.FLOAT32, "cpu")
    sl = buf.slice(1, 4)
    ran = []
    sl.defer_store(lambda: (ran.append(1), sl.store(torch.full((3,), 5.0))))
    buf.defer_store(lambda: (ran.append(2), buf.store(torch.full((2,), 7.0),
                                                      2)))
    sl.free_buffer()
    assert buf._pending is not None and ran == []
    np.testing.assert_array_equal(buf.device_view(), [7, 7, 5, 5, 0, 0])
    assert ran == [1, 2]
    buf.resolve_pending()
    assert ran == [1, 2]
    buf.defer_store(lambda: ran.append(3))
    buf.free_buffer()
    buf.resolve_pending()
    assert ran == [1, 2]


def test_copy_then_free_source(port):
    a = port[0]
    src = a.create_buffer_from(np.arange(8, dtype=np.float32))
    dst = a.create_buffer(8, np.float32)
    a.copy(src, dst, 8)
    src.free_buffer()
    np.testing.assert_array_equal(_read(dst), np.arange(8, dtype=np.float32))


def test_subcommunicator_device_path(groups):
    """A sub-communicator's collective on its members' own buffers, one
    interaction, equal to JAX's."""
    got = []
    for g in groups:
        n = 8
        send = {r: g[r].create_buffer_from(np.full(n, float(r), np.float32))
                for r in (1, 3)}
        recv = {r: g[r].create_buffer(n, np.float32) for r in (1, 3)}
        comms = [a.create_communicator([1, 3]) for a in g]
        ic0 = _ic(g[0])

        def work(a, r):
            if comms[r] is not None:
                a.allreduce(send[r], recv[r], n, comm=comms[r])

        run_parallel(g, work)
        assert _ic(g[0]) - ic0 == 1
        got.append([_read(recv[r]) for r in (1, 3)])
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[1][0], 4.0)


def test_mixed_host_operand_takes_the_host_path(groups):
    """Rank 0's host-only operand stages the call through the host; the
    result equals JAX's."""
    got = []
    for g in groups:
        n = 8
        send = [g[r].create_buffer(n, np.float32, host_only=(r == 0))
                for r in range(P)]
        recv = [a.create_buffer(n, np.float32) for a in g]
        for r in range(P):
            send[r].data[:] = float(r + 1)
            send[r].sync_to_device()
        run_parallel(g, lambda a, r: a.allreduce(send[r], recv[r], n))
        got.append([_read(recv[r]) for r in range(P)])
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[1][3], 10.0)


def test_host_path_counts_its_transfers(port):
    """The host-staged path counts one interaction a device operand read
    and one a device result written; host-only sides count none."""
    n = 8
    send = [port[r].create_buffer_from(np.full(n, 1.0, np.float32),
                                       host_only=(r < 2))
            for r in range(P)]
    recv = [port[r].create_buffer(n, np.float32, host_only=(r == 3))
            for r in range(P)]
    ic0 = _ic(port[0])
    run_parallel(port, lambda a, r: a.allreduce(send[r], recv[r], n))
    assert _ic(port[0]) - ic0 == 2 + 3
    assert recv[3].data.tolist() == [4.0] * n
    np.testing.assert_array_equal(_read(recv[0]), 4.0)


# ---------------------------------------------------------------------------
# the host-staged path, bit for bit with JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_groups():
    """Members 5..8 of nine ranks: JAX's gang has no mesh for them (eight
    devices), so its calls stage through the host; the port's members are
    host-only buffers on its nine-rank gang."""
    jg = xla_group(9)
    tg = at.cuda_group(9, device="cpu")
    yield jg, tg
    for a in jg + tg:
        a.deinit()


def _host_run(host_groups, work):
    jg, tg = host_groups
    members = [5, 6, 7, 8]
    jc = [jg[m].create_communicator(members) for m in members]
    tc = [tg[m].create_communicator(members) for m in members]
    for t, j in zip(tc, jc):
        # the per-call wire seeds derive from (id, epoch, counter)
        assert t.id == j.id
        t.epoch = j.epoch
    assert jg[0].engine.gang.submesh(jc[0]) is None
    out = []
    for g, comms in ((jg, jc), (tg, tc)):
        out.append(run_parallel(
            [g[m] for m in members],
            lambda a, r: work(a, r, comms[r], g is tg)))
    return out


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("function", ["SUM", "MAX"])
def test_host_only_bfloat16_allreduce_equals_jax_bit_for_bit(host_groups,
                                                             function):
    """The bfloat16 fold in rank order, each step rounded, as JAX's
    ``_host_reduce``; its MAX keeps NaNs."""
    n = 1332
    rng = np.random.default_rng(18)
    rows = [(rng.standard_normal(n) * 8).astype(ml_dtypes.bfloat16)
            for _ in range(4)]
    rows[2][::97] = np.nan
    fn = getattr(at.ReduceFunction, function)

    def work(a, r, comm, port):
        s = a.create_buffer_from(rows[r].copy(), host_only=True)
        d = a.create_buffer(n, ml_dtypes.bfloat16, host_only=True)
        a.allreduce(s, d, n, function=int(fn), comm=comm)
        return np.asarray(d.host_view()).copy()

    jax_out, port_out = _host_run(host_groups, work)
    for j, t in zip(jax_out, port_out):
        np.testing.assert_array_equal(_bits(t), _bits(j))
    if function == "SUM":
        fold = rows[0]
        for x in rows[1:]:
            fold = (fold + x).astype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(_bits(port_out[0]), _bits(fold))


@pytest.mark.parametrize("lane", ["float16", "bfloat16", "float8_e4m3fn",
                                  "float8_e5m2", "int8"])
def test_host_compressed_allreduce_equals_jax_bit_for_bit(host_groups, lane):
    """The host-staged allreduce casts every operand through the wire and
    back (no seed; int8 the plain cast, not the scaled lane), then folds
    in rank order, as JAX's host ``_allreduce`` does."""
    n = 515
    rng = np.random.default_rng(44)
    rows = [(rng.standard_normal(n) * 8).astype(np.float32)
            for _ in range(4)]

    def work(a, r, comm, port):
        s = a.create_buffer_from(rows[r].copy(), host_only=True)
        d = a.create_buffer(n, np.float32, host_only=True)
        a.allreduce(s, d, n, comm=comm, compress_dtype=lane)
        return np.asarray(d.host_view()).copy()

    jax_out, port_out = _host_run(host_groups, work)
    for j, t in zip(jax_out, port_out):
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("lane", ["float8_e4m3fn", "float8_e5m2", "int8"])
def test_host_compressed_reduce_scatter_equals_jax_bit_for_bit(host_groups,
                                                               lane):
    """Every contribution rounded by the host codec with its rank's mixed
    seed, then folded in rank order: equal to JAX's bit for bit."""
    n = 333
    rng = np.random.default_rng(32)
    rows = [rng.standard_normal(4 * n).astype(np.float32) for _ in range(4)]

    def work(a, r, comm, port):
        s = a.create_buffer_from(rows[r].copy(), host_only=True)
        d = a.create_buffer(n, np.float32, host_only=True)
        for _ in range(2):  # the second call draws the next seed
            a.reduce_scatter(s, d, n, comm=comm, compress_dtype=lane)
        return np.asarray(d.host_view()).copy()

    jax_out, port_out = _host_run(host_groups, work)
    for j, t in zip(jax_out, port_out):
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("op", ["reduce", "bcast", "gather", "allgather",
                                "scatter", "alltoall", "reduce_scatter"])
def test_host_staged_collectives_equal_jax(host_groups, op):
    """Every collective of the host-staged path, rooted at rank 2 where it
    has a root, with an e5m2 wire on the ops that take one: equal to
    JAX's bit for bit (the members' results and the untouched ones)."""
    n = 96
    rng = np.random.default_rng(3)
    wide = op in ("scatter", "alltoall", "reduce_scatter")
    rows = [rng.standard_normal(4 * n if wide else n).astype(np.float32)
            for _ in range(4)]
    out_w = 4 * n if op in ("gather", "allgather", "alltoall") else n
    lane = "float8_e5m2" if op in ("reduce", "gather", "scatter") else None

    def work(a, r, comm, port):
        s = a.create_buffer_from(rows[r].copy(), host_only=True)
        d = a.create_buffer_from(np.full(out_w, -1.0, np.float32),
                                 host_only=True)
        if op == "reduce":
            a.reduce(s, d, n, root=2, comm=comm, compress_dtype=lane)
        elif op == "bcast":
            a.bcast(s, n, root=2, comm=comm)
            return np.asarray(s.host_view()).copy()
        elif op == "gather":
            a.gather(s, d, n, root=2, comm=comm, compress_dtype=lane)
        elif op == "scatter":
            a.scatter(s, d, n, root=2, comm=comm, compress_dtype=lane)
        else:
            getattr(a, op)(s, d, n, comm=comm)
        return np.asarray(d.host_view()).copy()

    jax_out, port_out = _host_run(host_groups, work)
    for j, t in zip(jax_out, port_out):
        np.testing.assert_array_equal(_bits(t), _bits(j))


# ---------------------------------------------------------------------------
# point-to-point: the copy runs at the receiver's wait()
# ---------------------------------------------------------------------------


def test_p2p_delivery_runs_at_the_receivers_wait(port):
    n = 16
    src = port[0].create_buffer_from(np.arange(n, dtype=np.float32))
    dst = port[1].create_buffer(n, np.float32)
    rreq = port[1].recv(dst, n, src=0, tag=3, run_async=True)
    port[0].send(src, n, dst=1, tag=3)
    assert rreq.done()
    ic0 = _ic(port[0])
    assert dst._pending is not None  # matched, not yet delivered
    assert rreq.wait(10)
    rreq.check()
    assert _ic(port[0]) - ic0 == 1 and dst._pending is None
    np.testing.assert_array_equal(_read(dst), np.arange(n))
    # a host-only receiver takes the payload at the match
    hdst = port[2].create_buffer(n, np.float32, host_only=True)
    hreq = port[2].recv(hdst, n, src=0, tag=4, run_async=True)
    port[0].send(src, n, dst=2, tag=4)
    assert hreq.wait(10)
    np.testing.assert_array_equal(hdst.data, np.arange(n))


@pytest.mark.parametrize("use", ["operand", "result"])
def test_parked_delivery_lands_before_a_later_call(port, use):
    """A received payload not yet waited on lands before a later
    collective reads the buffer as its operand, or writes it as its
    result (issue order), on the prepared path too."""
    n = 16
    send = _full(port, n)
    recv = _full(port, n, lambda r: 0.0)
    run_parallel(port, lambda a, r: a.allreduce(send[r], recv[r], n))
    run_parallel(port, lambda a, r: a.allreduce(send[r], recv[r], n))
    src = port[0].create_buffer_from(np.full(n, 100.0, np.float32))
    port[1].recv(send[1] if use == "operand" else recv[1], n, src=0, tag=7,
                 run_async=True)  # never waited on
    port[0].send(src, n, dst=1, tag=7)
    run_parallel(port, lambda a, r: a.allreduce(send[r], recv[r], n))
    want = 1 + 100 + 3 + 4 if use == "operand" else 10
    for r in range(P):
        np.testing.assert_array_equal(_read(recv[r]), float(want))


def test_failed_deferred_placement_fails_the_request():
    req = at.Request("RECV")

    def boom():
        raise RuntimeError("no")

    req.defer_result(boom, handle=object())
    req.complete(at.ErrorCode.OK)
    assert req.wait(1)
    assert req.get_retcode() == at.ErrorCode.INVALID_OPERATION
    assert req.device_handle is None
    with pytest.raises(at.ACCLError):
        req.check()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def test_allgather_invariant_is_the_allgather():
    xs = [torch.full((3,), float(r)) for r in range(4)]
    for a, b in zip(collectives.allgather_invariant(xs),
                    collectives.allgather(xs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algo", ["xla", "pallas_ring"])
def test_rooted_calls_on_a_subcomm_with_a_far_root_equal_jax(groups, algo):
    """A bcast and a reduce rooted at rank 1 of a sub-communicator whose
    sessions are 2 and 3, and an allgather on [1, 3], under both rooted
    registers: equal to JAX's."""
    got = []
    n = 96
    rng = np.random.default_rng(7)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(P)]
    for g in groups:
        for a in g:
            for key in ("bcast_algorithm", "reduce_algorithm",
                        "gather_algorithm"):
                a.set_tuning(key, algo)
        pair = [a.create_communicator([2, 3]) for a in g]
        odd = [a.create_communicator([1, 3]) for a in g]

        def work(a, r):
            out = {}
            if pair[r] is not None:
                b = a.create_buffer_from(data[r].copy())
                a.bcast(b, n, root=1, comm=pair[r])
                out["bcast"] = _read(b)
                s = a.create_buffer_from(data[r].copy())
                d = a.create_buffer(n, np.float32)
                a.reduce(s, d, n, root=1, comm=pair[r])
                out["reduce"] = _read(d) if r == 3 else None
            if odd[r] is not None:
                s = a.create_buffer_from(data[r].copy())
                d = a.create_buffer(2 * n, np.float32)
                a.allgather(s, d, n, comm=odd[r])
                out["allgather"] = _read(d)
            return out

        got.append(run_parallel(g, work))
        for a in g:
            for key in ("bcast_algorithm", "reduce_algorithm",
                        "gather_algorithm"):
                a.set_tuning(key, "xla")
    for j, t in zip(*got):
        assert j.keys() == t.keys()
        for k in j:
            if j[k] is None:
                continue
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1][2]["bcast"], data[3])
    np.testing.assert_array_equal(got[1][1]["allgather"],
                                  np.concatenate([data[1], data[3]]))
