"""The PyTorch port's facade (``accl_tpu_torch``) against the JAX gang.

``cuda_group(4, device="cpu")`` and ``xla_group(4)`` run the same MPI-like
programs, one thread per rank, on the same numpy-seeded operands; the
tuning registers of the JAX gang carry across through
``interop.tuning_from_jax``.  The ring kernels' lowerings (``pallas_ring``,
``pallas_ring_bidir``) and the explicit ``ring`` pipeline keep the JAX
fold order, so they agree exactly; the ``xla`` lowering sums in XLA's
order, so it agrees to float32 rounding (rtol 1e-6), and the bfloat16
wire of the ``xla`` lowering to bfloat16 rounding (rtol 1e-2).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accl_tpu.compat import has_pallas_interpret
from accl_tpu.core import xla_group
from helpers import run_parallel

import accl_tpu_torch as at
from accl_tpu_torch import interop
from accl_tpu_torch.ops import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4


@pytest.fixture
def groups():
    """The JAX gang and the port's CPU gang, four ranks each."""
    jg = xla_group(P)
    tg = at.cuda_group(P, device="cpu")
    yield jg, tg
    for a in jg + tg:
        a.deinit()


def _set_tuning(group, **registers):
    for a in group:
        for key, value in registers.items():
            a.set_tuning(key, value)


def _tune_both(groups, **registers):
    """Write ``registers`` into the JAX gang, then carry its whole
    register dict across to the port's gang through
    ``interop.tuning_from_jax``."""
    jg, tg = groups
    _set_tuning(jg, **registers)
    port = interop.tuning_from_jax(dict(jg[0].engine.gang.tuning))
    _set_tuning(tg, **port)
    assert tg[0].engine.gang.tuning == port


def _run_both(groups, work):
    """``work(accl, rank)`` on every rank of both gangs; returns the JAX
    and the port results."""
    jg, tg = groups
    return run_parallel(jg, work), run_parallel(tg, work)


def _allreduce_work(rows, count, function=at.ReduceFunction.SUM,
                    compress_dtype=None):
    def work(a, r):
        send = a.create_buffer_from(rows[r].copy())
        recv = a.create_buffer(count, np.float32)
        a.allreduce(send, recv, count, function=int(function),
                    compress_dtype=compress_dtype)
        recv.sync_from_device()
        return np.asarray(recv.host_view()).copy()

    return work


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_cuda_group_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at.cuda_group(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            at.cuda_group(2, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2, device=device)
    assert make_mesh(2, device="cpu").device == torch.device("cpu")


def test_import_is_free_of_jax_and_the_jax_package():
    code = (
        "import sys, accl_tpu_torch, accl_tpu_torch.ops, "
        "accl_tpu_torch.interop, accl_tpu_torch.models, "
        "accl_tpu_torch.ops.attention, accl_tpu_torch.examples.vadd_put, "
        "accl_tpu_torch.compat, accl_tpu_torch.ops.cuda.put, "
        "accl_tpu_torch.models.ring_attention, "
        "accl_tpu_torch.models.ulysses_attention, "
        "accl_tpu_torch.ops.cuda.alltoall, accl_tpu_torch.ops.cuda.attention, "
        "accl_tpu_torch.plans, accl_tpu_torch.topology, "
        "accl_tpu_torch.hierarchical, accl_tpu_torch.tuning, "
        "accl_tpu_torch.telemetry, accl_tpu_torch.monitor, "
        "accl_tpu_torch.faults, accl_tpu_torch.contract, "
        "accl_tpu_torch.membership, accl_tpu_torch.arbiter, "
        "accl_tpu_torch.overlap, accl_tpu_torch.models.moe, "
        "accl_tpu_torch.models.encoder, accl_tpu_torch.parallel, "
        "accl_tpu_torch.parallel.zero, accl_tpu_torch.models.pipeline, "
        "accl_tpu_torch.models.composed, accl_tpu_torch.data, "
        "accl_tpu_torch.examples.train, accl_tpu_torch.utils, "
        "accl_tpu_torch.parallel.topology, accl_tpu_torch.parallel.multihost, "
        "accl_tpu_torch.utils.profiling\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'accl_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == ""


# ---------------------------------------------------------------------------
# allreduce under every algorithm register
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "algo,segments,function",
    [
        ("xla", 1, at.ReduceFunction.SUM),
        ("ring", 2, at.ReduceFunction.SUM),
        ("ring", 1, at.ReduceFunction.MAX),
        ("pallas_ring", 2, at.ReduceFunction.SUM),
        ("pallas_ring", 1, at.ReduceFunction.MAX),
        ("pallas_ring_bidir", 2, at.ReduceFunction.SUM),
    ],
)
def test_allreduce_equals_jax(groups, algo, segments, function):
    if algo.startswith("pallas") and not has_pallas_interpret():
        pytest.skip("the JAX pallas lowering off-chip needs the interpreter")
    _tune_both(groups, allreduce_algorithm=algo, ring_segments=segments)
    count = 1000
    rows = np.random.default_rng(11).standard_normal((P, count)).astype(
        np.float32)
    want, got = _run_both(groups, _allreduce_work(rows, count, function))
    for r in range(P):
        if algo == "xla" and function == at.ReduceFunction.SUM:
            np.testing.assert_allclose(got[r], want[r], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("algo", ["xla", "pallas_ring"])
def test_allreduce_bfloat16_wire_equals_jax(groups, algo):
    if algo.startswith("pallas") and not has_pallas_interpret():
        pytest.skip("the JAX pallas lowering off-chip needs the interpreter")
    _tune_both(groups, allreduce_algorithm=algo)
    count = 1000
    rows = np.random.default_rng(12).standard_normal((P, count)).astype(
        np.float32)
    want, got = _run_both(
        groups, _allreduce_work(rows, count, compress_dtype="bfloat16"))
    for r in range(P):
        if algo == "xla":
            np.testing.assert_allclose(got[r], want[r], rtol=1e-2, atol=1e-2)
        else:  # the ring's wire lane rounds at the same points
            np.testing.assert_array_equal(got[r], want[r])
    exact = rows.astype(np.float64).sum(0)
    np.testing.assert_allclose(got[0], exact, rtol=3e-2, atol=3e-2)
    assert not np.array_equal(got[0], rows.sum(0))  # the wire was narrowed


def test_wire_dtype_register_rides_allreduce(groups):
    """``wire_dtype`` set through the register narrows a plain allreduce
    like an explicit ``compress_dtype``."""
    _, tg = groups
    count = 512
    rows = np.random.default_rng(13).standard_normal((P, count)).astype(
        np.float32)
    explicit = run_parallel(
        tg, _allreduce_work(rows, count, compress_dtype="bfloat16"))
    _set_tuning(tg, wire_dtype="bfloat16")
    assert tg[0].engine.gang.tuning["wire_dtype"] == int(at.DataType.BFLOAT16)
    implicit = run_parallel(tg, _allreduce_work(rows, count))
    for e, i in zip(explicit, implicit):
        np.testing.assert_array_equal(e, i)


@pytest.mark.parametrize("algo", ["xla", "pallas_ring", "pallas_ring_bidir"])
def test_bfloat16_host_view_equals_jax(groups, algo):
    """``host_view()`` is the host side as a numpy array, as the JAX
    package's is: on a bfloat16 buffer ``np.asarray`` of it is the
    ml_dtypes bfloat16 array, equal bit for bit to the JAX gang's after
    a 4-rank allreduce (count 17) under each register.  The operands are
    halves in [-8, 8], whose every partial sum bfloat16 holds exactly, so
    the bits do not hang on the fold order (the rounding of other sums is
    held by ``test_bfloat16_sums_within_the_fold_of_jax``)."""
    if algo.startswith("pallas") and not has_pallas_interpret():
        pytest.skip("the JAX pallas lowering off-chip needs the interpreter")
    _tune_both(groups, allreduce_algorithm=algo)
    count = 17
    rows = (np.random.default_rng(17).integers(-16, 17, (P, count)) / 2
            ).astype(ml_dtypes.bfloat16)

    def work(a, r):
        send = a.create_buffer_from(rows[r].copy())
        recv = a.create_buffer(count, ml_dtypes.bfloat16)
        a.allreduce(send, recv, count)
        recv.sync_from_device()
        return np.asarray(recv.host_view()).copy()

    want, got = _run_both(groups, work)
    for r in range(P):
        assert got[r].dtype == want[r].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(got[r].view(np.uint16),
                                      want[r].view(np.uint16))


@pytest.mark.parametrize("algo",
                         ["xla", "ring", "pallas_ring", "pallas_ring_bidir"])
def test_bfloat16_sums_within_the_fold_of_jax(groups, algo):
    """A recorded divergence, pinned: the port's bfloat16 sums add rank by
    rank in bfloat16 (``ops/collectives.py::_fold``, the ring kernels hop
    by hop), where XLA's CPU psum may accumulate in float32 and round
    once.  So the reduce_scatter at count 333 over 4 ranks, and the
    allreduce of the same rows, agree with JAX's under each register
    within the fold's rounding: each of the port's P - 1 additions and
    JAX's one rounding errs by at most bfloat16's unit roundoff 2^-8 of a
    partial sum, and every partial sum is at most sum_r |x_r|, so
    |port - jax| <= P * 2^-8 * sum_r |x_r| element by element."""
    if algo.startswith("pallas") and not has_pallas_interpret():
        pytest.skip("the JAX pallas lowering off-chip needs the interpreter")
    _tune_both(groups, allreduce_algorithm=algo)
    count = 333
    big = (np.random.default_rng(18).standard_normal((P, P * count)) * 8
           ).astype(ml_dtypes.bfloat16)

    def work(a, r):
        send = a.create_buffer_from(big[r].copy())
        rs = a.create_buffer(count, ml_dtypes.bfloat16)
        a.reduce_scatter(send, rs, count)
        ar = a.create_buffer(P * count, ml_dtypes.bfloat16)
        a.allreduce(send, ar, P * count)
        out = []
        for buf in (rs, ar):
            buf.sync_from_device()
            out.append(np.asarray(buf.host_view()).astype(np.float64))
        return out

    want, got = _run_both(groups, work)
    mag = np.abs(big.astype(np.float64)).sum(0)
    tol = P * 2.0 ** -8 * mag + 1e-30
    for r in range(P):
        block = slice(r * count, (r + 1) * count)
        np.testing.assert_array_less(np.abs(got[r][0] - want[r][0]),
                                     tol[block])
        np.testing.assert_array_less(np.abs(got[r][1] - want[r][1]), tol)


def _jax_paths(monkeypatch, jg):
    """Count the JAX gang's calls by path: ``device`` lists the calls its
    device program ran (``_run_op_device`` returned a code), ``host`` the
    calls staged through host numpy (``_run_op_host``: the rank-order
    fold and the per-rank seeded ``wire_cast``, taken when the gang has
    no mesh of its ranks' devices).  The instance's methods are wrapped;
    the gang's code is not changed."""
    gang = jg[0].engine.gang
    paths = {"device": [], "host": []}
    run_device, run_host = gang._run_op_device, gang._run_op_host

    def on_device(comm, calls, lead, *args, **kw):
        code = run_device(comm, calls, lead, *args, **kw)
        if code is not None:
            paths["device"].append(lead.op)
        return code

    def on_host(comm, calls, lead, *args, **kw):
        paths["host"].append(lead.op)
        return run_host(comm, calls, lead, *args, **kw)

    monkeypatch.setattr(gang, "_run_op_device", on_device)
    monkeypatch.setattr(gang, "_run_op_host", on_host)
    return paths


@pytest.mark.parametrize("algo", ["ring", "pallas_ring", "pallas_ring_bidir"])
def test_bfloat16_ring_allreduce_equals_jax_bit_for_bit(groups, algo,
                                                        monkeypatch):
    """The bfloat16 allreduce under the ring registers, on the JAX gang's
    device path (the conftest's 8 virtual devices give it a mesh of its 4
    ranks): the port's ring fold equals JAX's bit for bit, count 1,332
    (8 x standard normals, seed 18).  With one device the JAX gang stages
    through the host and folds in rank order instead, which differs; so
    the test asserts that no call took that path."""
    if algo.startswith("pallas") and not has_pallas_interpret():
        pytest.skip("the JAX pallas lowering off-chip needs the interpreter")
    _tune_both(groups, allreduce_algorithm=algo)
    paths = _jax_paths(monkeypatch, groups[0])
    count = P * 333
    rows = (np.random.default_rng(18).standard_normal((P, count)) * 8
            ).astype(ml_dtypes.bfloat16)

    def work(a, r):
        send = a.create_buffer_from(rows[r].copy())
        recv = a.create_buffer(count, ml_dtypes.bfloat16)
        a.allreduce(send, recv, count)
        recv.sync_from_device()
        return np.asarray(recv.host_view()).copy()

    want, got = _run_both(groups, work)
    assert paths["host"] == [] and len(paths["device"]) == 1, paths
    for r in range(P):
        assert got[r].dtype == want[r].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(got[r].view(np.uint16),
                                      want[r].view(np.uint16))


@pytest.mark.parametrize("dtype,lane", [
    (np.float32, "float8_e4m3fn"), (np.float32, "float8_e5m2"),
    (np.float32, "float16"), (np.float32, "bfloat16"),
    (np.float32, "int8"),
    (ml_dtypes.bfloat16, "float8_e4m3fn"), (ml_dtypes.bfloat16, "float8_e5m2"),
    (ml_dtypes.bfloat16, "int8"),
], ids=lambda v: getattr(v, "__name__", v))
def test_compressed_reduce_scatter_equals_jax(groups, dtype, lane,
                                              monkeypatch):
    """The compressed reduce_scatter at count 333 over 4 ranks (seed 32,
    default registers) on every lane and operand dtype the arithmetic
    table takes, against the JAX gang's device program (asserted: no
    call staged through the host, whose per-rank seeded ``wire_cast``
    rounds otherwise).  float32 operands on the float lanes agree bit for
    bit; on int8 within 1e-6, the recorded ``absmax / 127`` scale
    divergence (``test_torch_wire.py::test_int8_scale_divergence``);
    bfloat16 operands within the fold bound P * 2^-8 * sum_r |x_r| of
    ``test_bfloat16_sums_within_the_fold_of_jax`` (XLA's CPU psum adds
    bfloat16 in float32 and rounds once)."""
    paths = _jax_paths(monkeypatch, groups[0])
    count = 333
    rows = np.random.default_rng(32).standard_normal((P, P * count)).astype(
        dtype)

    def work(a, r):
        send = a.create_buffer_from(rows[r].copy())
        recv = a.create_buffer(count, dtype)
        a.reduce_scatter(send, recv, count, compress_dtype=lane)
        recv.sync_from_device()
        return np.asarray(recv.host_view()).astype(np.float64)

    want, got = _run_both(groups, work)
    assert paths["host"] == [] and len(paths["device"]) == 1, paths
    mag = np.abs(rows.astype(np.float64)).sum(0)
    for r in range(P):
        if dtype == ml_dtypes.bfloat16:
            tol = P * 2.0 ** -8 * mag[r * count:(r + 1) * count] + 1e-30
            np.testing.assert_array_less(np.abs(got[r] - want[r]), tol)
        elif lane == "int8":
            np.testing.assert_allclose(got[r], want[r], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[r], want[r])


# ---------------------------------------------------------------------------
# the other collectives and the local ops
# ---------------------------------------------------------------------------


def test_reduce_scatter_allgather_bcast_equal_jax(groups):
    count = 250
    rng = np.random.default_rng(14)
    big = rng.standard_normal((P, P * count)).astype(np.float32)
    rows = rng.standard_normal((P, count)).astype(np.float32)

    def work(a, r):
        rs_send = a.create_buffer_from(big[r].copy())
        rs_recv = a.create_buffer(count, np.float32)
        a.reduce_scatter(rs_send, rs_recv, count)
        ag_send = a.create_buffer_from(rows[r].copy())
        ag_recv = a.create_buffer(P * count, np.float32)
        a.allgather(ag_send, ag_recv, count)
        bc = a.create_buffer_from(rows[r].copy())
        a.bcast(bc, count, root=2)
        a.barrier()
        out = []
        for buf in (rs_recv, ag_recv, bc):
            buf.sync_from_device()
            out.append(np.asarray(buf.host_view()).copy())
        return out

    want, got = _run_both(groups, work)
    for r in range(P):
        np.testing.assert_allclose(got[r][0], want[r][0], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[r][1], want[r][1])
        np.testing.assert_array_equal(got[r][2], want[r][2])
    np.testing.assert_array_equal(got[1][2], rows[2])


def test_compressed_bcast_and_allgather_equal_jax(groups):
    count = 300
    rows = np.random.default_rng(15).standard_normal((P, count)).astype(
        np.float32)

    def work(a, r):
        ag_send = a.create_buffer_from(rows[r].copy())
        ag_recv = a.create_buffer(P * count, np.float32)
        a.allgather(ag_send, ag_recv, count, compress_dtype="bfloat16")
        bc = a.create_buffer_from(rows[r].copy())
        a.bcast(bc, count, root=1, compress_dtype="float16")
        ag_recv.sync_from_device()
        bc.sync_from_device()
        return (np.asarray(ag_recv.host_view()).copy(),
                np.asarray(bc.host_view()).copy())

    want, got = _run_both(groups, work)
    for r in range(P):
        np.testing.assert_array_equal(got[r][0], want[r][0])
        np.testing.assert_array_equal(got[r][1], want[r][1])


@pytest.mark.parametrize("function", [at.ReduceFunction.SUM,
                                      at.ReduceFunction.MAX])
def test_combine_and_copy_equal_jax(groups, function):
    count = 777
    rng = np.random.default_rng(16)
    a_rows = rng.standard_normal((P, count)).astype(np.float32)
    b_rows = rng.standard_normal((P, count)).astype(np.float32)

    def work(a, r):
        x = a.create_buffer_from(a_rows[r].copy())
        y = a.create_buffer_from(b_rows[r].copy())
        res = a.create_buffer(count, np.float32)
        a.combine(int(function), x, y, res)
        a.combine(int(function), x, y, x)  # in place
        cp = a.create_buffer(count, np.float32)
        a.copy(res, cp)
        out = []
        for buf in (res, x, cp):
            buf.sync_from_device()
            out.append(np.asarray(buf.host_view()).copy())
        return out

    want, got = _run_both(groups, work)
    for r in range(P):
        for g, w in zip(got[r], want[r]):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# requests, buffers, registers
# ---------------------------------------------------------------------------


def test_run_async_and_buffer_views():
    g = at.cuda_group(2, device="cpu")
    try:
        rows = [np.arange(8, dtype=np.float32) * (r + 1) for r in range(2)]

        def work(a, r):
            send = a.create_buffer_from(rows[r])
            recv = a.create_buffer(8, np.float32)
            req = a.allreduce(send, recv, run_async=True)
            assert req.wait(timeout=30) and req.test()
            req.check()
            recv.sync_from_device()
            half = recv.slice(4, 8)
            half.host_view()[:] = 0
            half.sync_to_device()
            assert float(recv.tensor[4:].abs().sum()) == 0.0
            return recv.host_view().copy()

        for got in run_parallel(g, work):
            np.testing.assert_array_equal(got[:4], rows[0][:4] * 3)
    finally:
        for a in g:
            a.deinit()


def test_bad_registers_and_calls_raise():
    g = at.cuda_group(2, device="cpu")
    try:
        with pytest.raises(ValueError, match="unknown tuning key"):
            g[0].set_tuning("no_such_register", 1)
        with pytest.raises(ValueError, match="unknown algorithm"):
            g[0].set_tuning("allreduce_algorithm", "tree")
        with pytest.raises(at.ACCLError) as ei:
            g[0].set_tuning("ring_segments", 0)
        assert ei.value.code == at.ErrorCode.CONFIG_ERROR
        with pytest.raises(at.ACCLError) as ei:
            g[0].set_tuning("wire_dtype", "float64")
        assert ei.value.code == at.ErrorCode.CONFIG_ERROR
        with pytest.raises(at.ACCLError) as ei:
            g[0].set_timeout(0)
        assert ei.value.code == at.ErrorCode.CONFIG_ERROR
        buf = g[0].create_buffer(4, np.float32)
        with pytest.raises(at.ACCLError) as ei:  # no float32 -> f64 pair
            g[0].allreduce(buf, buf, compress_dtype="float64")
        assert ei.value.code == at.ErrorCode.INVALID_DTYPE

        def mismatched(a, r):
            src = a.create_buffer(8 + r, np.float32)
            with pytest.raises(at.ACCLError) as ei:
                a.allreduce(src, src)
            return ei.value.code

        assert run_parallel(g, mismatched) == [at.ErrorCode.INVALID_OPERATION] * 2
    finally:
        for a in g:
            a.deinit()


def test_capabilities_report():
    """test_aux.py:262 on the port, beside ``xla_group(2)``'s report."""
    jg, tg = xla_group(2), at.cuda_group(2, device="cpu")
    try:
        for caps in (jg[0].capabilities(), tg[0].capabilities()):
            assert caps["world_size"] == 2
            assert "SUM" in caps["arithmetic"] and "MAX" in caps["arithmetic"]
            assert any("FLOAT16" in w for w in caps["wire_compression"])
            assert any("FLOAT8" in w for w in caps["wire_compression"])
            assert caps["streams"] and caps["rendezvous"]
            assert isinstance(caps["device_tier"], bool)
            assert caps["platform"] == "cpu"
        jc, tc = jg[0].capabilities(), tg[0].capabilities()
        for key in ("world_size", "arithmetic", "wire_compression",
                    "streams", "rendezvous", "device_tier", "platform"):
            assert tc[key] == jc[key], key
        assert tc["native_dataplane"] is False  # until ROADMAP A12
    finally:
        for a in jg + tg:
            a.deinit()


def test_nop_and_get_duration_equal_jax(groups):
    """``nop`` completes on every rank without a device call, as JAX's;
    ``get_duration`` is the request's engine-measured ns, on a nop and on
    an allreduce."""
    jg, tg = groups
    count = 256
    rows = np.random.default_rng(14).standard_normal((P, count)).astype(
        np.float32)

    def work(a, r):
        ic0 = a.capabilities()["device_interactions"]
        q = a.nop()
        nq = a.nop(run_async=True)
        assert nq.wait(60)
        s = a.create_buffer_from(rows[r].copy())
        d = a.create_buffer(count, np.float32)
        ar = a.allreduce(s, d, count, run_async=True)
        assert ar.wait(60)
        return (int(q.get_retcode()), int(nq.get_retcode()),
                a.get_duration(q), a.get_duration(nq),
                a.get_duration(ar) == ar.get_duration_ns(),
                a.get_duration(ar) > 0, ic0)

    want, got = _run_both(groups, work)
    for w, g in zip(want, got):
        assert g[:6] == w[:6]
        assert g[:2] == (int(at.ErrorCode.OK),) * 2
        assert g[4] and g[5]


@pytest.mark.parametrize(
    "enum_name",
    ["Operation", "ConfigFunction", "TuningKey", "AllreduceAlgorithm",
     "ReduceFunction", "DataType", "CompressionFlags", "ErrorCode"],
)
def test_vocabulary_values_equal_jax(enum_name):
    """The port's own copy of the vocabulary keeps the JAX package's
    values, so codes and register numbers carry across unchanged."""
    import accl_tpu.constants as jax_constants
    import accl_tpu_torch.constants as port_constants

    jax_enum = getattr(jax_constants, enum_name)
    for member in getattr(port_constants, enum_name):
        assert int(jax_enum[member.name]) == int(member)


def test_tuning_from_jax():
    assert interop.tuning_from_jax(
        {"allreduce_algorithm": "pallas_ring_bidir", "ring_segments": 4,
         "wire_dtype": int(at.DataType.FLOAT16)}
    ) == dict(at.constants.TUNING_DEFAULTS,
              allreduce_algorithm="pallas_ring_bidir", ring_segments=4,
              wire_dtype=int(at.DataType.FLOAT16))
    # registers the port does not serve may only hold their defaults
    assert interop.tuning_from_jax(
        {"allreduce_algorithm": "xla", "ring_segments": 1,
         "bcast_algorithm": "xla", "pipeline_threshold": 0}
    )["allreduce_algorithm"] == "xla"
    # the rooted registers carry across; they have no ring form
    assert interop.tuning_from_jax(
        {"bcast_algorithm": "pallas_ring"})["bcast_algorithm"] == "pallas_ring"
    with pytest.raises(ValueError, match="rooted"):
        interop.tuning_from_jax({"bcast_algorithm": "pallas_ring_bidir"})
    assert interop.tuning_from_jax(
        {"wire_dtype": int(at.DataType.INT8)})["wire_dtype"] == int(
            at.DataType.INT8)
    with pytest.raises(ValueError, match="not a wire lane"):
        interop.tuning_from_jax({"wire_dtype": int(at.DataType.FLOAT64)})
    with pytest.raises(KeyError):
        interop.tuning_from_jax({"allreduce_algorithm": "tree"})


def test_stacked_from_numpy_keeps_bits():
    rows = np.random.default_rng(17).standard_normal((3, 10)).astype(
        jnp.bfloat16)
    xs = interop.stacked_from_numpy(rows, "cpu")
    assert len(xs) == 3 and xs[0].dtype == torch.bfloat16
    assert len({x.data_ptr() for x in xs}) == 3  # one allocation per rank
    np.testing.assert_array_equal(interop.to_numpy(xs[2]),
                                  rows[2].astype(np.float32))
