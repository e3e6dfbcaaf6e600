"""The port's wire codecs, error feedback and compressed facade against the
JAX package.

* The host codec (``accl_tpu_torch.wire``) and the device codec
  (``accl_tpu_torch.ops.wire``; on the CPU the compression kernels' plain
  versions) give the same bytes as ``accl_tpu.wire`` and
  ``accl_tpu.ops.wire`` for every lane and seed.
* ``ResidualStore`` gives JAX's residual stream.
* The facade's compressed allreduce on ``cuda_group(4, device="cpu")``
  equals JAX's gang facade (``xla_group(4)`` on the CPU mesh) per lane and
  register: bit for bit for the fp8 and int8 lanes under every register
  and for every lane under the ring registers (the fold order and rounding
  points are the reference's); the f16 / bf16 lanes under ``xla`` reduce
  in XLA's reduce-scatter order, so they agree to their lane's rounding.
* The convergence leg of ``bench.py`` on both CPU gangs.
"""

import numpy as np
import pytest
import torch

import accl_tpu.ops.wire as jdw
import jax
import accl_tpu.wire as jhw
import jax.numpy as jnp
import ml_dtypes
from accl_tpu.compat import has_pallas_interpret
from accl_tpu.constants import DataType as JDataType
from accl_tpu.core import xla_group
from accl_tpu.errorfeedback import ResidualStore as JResidualStore
from helpers import run_parallel

import accl_tpu_torch as at
import accl_tpu_torch.ops.wire as tdw
import accl_tpu_torch.wire as thw
from accl_tpu_torch.errorfeedback import ResidualStore

P = 4
LANES = ["float16", "bfloat16", "float8_e4m3fn", "float8_e5m2", "int8"]
_DT = {"float16": "FLOAT16", "bfloat16": "BFLOAT16",
       "float8_e4m3fn": "FLOAT8_E4M3", "float8_e5m2": "FLOAT8_E5M2",
       "int8": "INT8"}


def _operand(n=1000, seed=7) -> np.ndarray:
    """Normals at several scales with NaN, infinities, signed zeros,
    subnormals of every lane and an all-zero segment."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.choice([1e-6, 1e-3, 1.0, 40.0], n)
         ).astype(np.float32)
    x[:12] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, 2.0 ** -17,
              2.0 ** -10, 500.0, 70000.0, -3e38]
    x[256:512] = 0.0
    return x


# ---------------------------------------------------------------------------
# the host and device codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("seed", [0, 4242, 2 ** 31 + 5])
def test_host_codec_bytes_equal_jax(lane, seed):
    x = _operand()
    dt = _DT[lane]
    want = jhw.encode_bytes(x, JDataType[dt], seed)
    got = thw.encode_bytes(x, at.DataType[dt], seed)
    assert got == want
    n = x.size
    assert thw.wire_nbytes(n, at.DataType[dt]) == jhw.wire_nbytes(
        n, JDataType[dt]) == len(got)
    dec = thw.decode_bytes(got, at.DataType[dt], n, torch.float32)
    np.testing.assert_array_equal(
        dec.numpy().view(np.uint32),
        jhw.decode_bytes(want, JDataType[dt], n, np.float32).view(np.uint32))
    rt = thw.roundtrip(x, at.DataType[dt], seed)
    np.testing.assert_array_equal(
        rt.numpy().view(np.uint32),
        jhw.roundtrip(x, JDataType[dt], seed).view(np.uint32))


@pytest.mark.parametrize("lane", ["bfloat16", "float8_e5m2", "int8"])
def test_host_codec_bfloat16_operand_equals_jax(lane):
    x = _operand(seed=8).astype(ml_dtypes.bfloat16)
    dt = _DT[lane]
    for seed in (0, 99):
        assert thw.encode_bytes(x, at.DataType[dt], seed) == \
            jhw.encode_bytes(x, JDataType[dt], seed)
        got = thw.roundtrip(x, at.DataType[dt], seed)
        want = jhw.roundtrip(x, JDataType[dt], seed)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_codec_helpers_equal_jax():
    for dt in at.DataType:
        if dt == at.DataType.NONE:
            continue
        j = JDataType[dt.name]
        assert thw.is_wire_dtype(dt) == jhw.is_wire_dtype(j)
        if thw.is_wire_dtype(dt):
            assert thw.is_scaled(dt) == jhw.is_scaled(j)
            assert thw.is_stochastic(dt) == jhw.is_stochastic(j)
            assert thw.dropped_mantissa_bits(dt) == \
                jhw.dropped_mantissa_bits(j)
            assert thw.lane_tiny(dt) == jhw.lane_tiny(j)
    assert [int(d) for d in thw.wire_lane_dtypes()] == \
        [int(d) for d in jhw.wire_lane_dtypes()]
    for n in (0, 1, 255, 256, 257, 100_000):
        assert thw.seg_count(n) == jhw.seg_count(n)
    for args in ((0, 0, 0, 8), (3, 1, 17, 7), (12, 5, 2 ** 20, 9)):
        assert thw.call_seed(*args) == jhw.call_seed(*args)
    for seed in (0, 1, 31337, 2 ** 32 - 1):
        for r in range(5):
            want = jhw.rank_seed(seed, r)
            assert thw.rank_seed(seed, r) == want
            assert tdw.rank_seed(seed, r) == want == int(np.asarray(
                jdw.rank_seed(jnp.uint32(seed), jnp.uint32(r))))
    from types import SimpleNamespace

    for seed, comm in ((0, SimpleNamespace(local_rank=2)), (77, None),
                       (77, SimpleNamespace(local_rank=3))):
        opts = SimpleNamespace(wire_seed=seed, comm=comm)
        assert thw.options_rank_seed(opts) == jhw.options_rank_seed(opts)
    for seed in (0, 5, 2 ** 32 - 3):
        want = jhw.sr_bits(777, seed)
        np.testing.assert_array_equal(thw.sr_bits(777, seed), want)
        np.testing.assert_array_equal(tdw.sr_bits(777, seed).numpy(), want)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("seed", [0, 99, 123456])
def test_device_codec_equals_jax_and_host(lane, seed):
    x = _operand(seed=9)
    want = np.asarray(jdw.wire_lane_roundtrip(
        jnp.asarray(x), jnp.dtype(lane), jnp.uint32(seed)))
    got = tdw.wire_lane_roundtrip(torch.from_numpy(x), lane, seed)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    host = thw.roundtrip(x, at.DataType[_DT[lane]], seed)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  host.numpy().view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_device_int8_lane_equals_jax(seed):
    x = _operand(n=1300, seed=10)
    qj, sj = jdw.quantize_int8(jnp.asarray(x), jnp.uint32(seed))
    q, s = tdw.quantize_int8(torch.from_numpy(x), seed)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    back = tdw.dequantize_int8(q, s, x.size)
    np.testing.assert_array_equal(
        back.numpy().view(np.uint32),
        np.asarray(jdw.dequantize_int8(qj, sj, x.size)).view(np.uint32))


def test_roundtrip_rows_seed_each_row():
    """One call rounds every rank's row with its own seed, as P calls
    would."""
    rows = [torch.from_numpy(_operand(seed=20 + r)) for r in range(3)]
    seeds = [thw.rank_seed(555, r) for r in range(3)]
    for lane in LANES:
        got = tdw.wire_lane_roundtrip_rows(rows, lane, seeds)
        for r in range(3):
            want = tdw.wire_lane_roundtrip(rows[r], lane, seeds[r])
            assert torch.equal(got[r].view(torch.int32),
                               want.view(torch.int32))


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lane", ["float8_e4m3fn", "int8"])
def test_residual_store_stream_equals_jax(lane):
    """Five successive calls carry the same residual stream; a change of
    count restarts it; residuals are keyed per count."""
    rng = np.random.default_rng(21)
    dt = _DT[lane]
    js, ts = JResidualStore(), ResidualStore()
    key = (0, 0, 10, 700, 0, -1)
    for step in range(5):
        g = rng.standard_normal(700).astype(np.float32)
        seed = jhw.rank_seed(jhw.call_seed(0, 0, step, int(JDataType[dt])), 2)
        want = js.apply(key, g, JDataType[dt], seed)
        got = ts.apply(key, torch.from_numpy(g), at.DataType[dt], seed)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ts.residual(key).numpy(),
                                      js.residual(key))
    assert ts.residual(key).abs().max() > 0
    # a new count under the same key restarts at zeros
    g = rng.standard_normal(300).astype(np.float32)
    np.testing.assert_array_equal(
        ts.apply(key, torch.from_numpy(g), at.DataType[dt], 3).numpy(), g)
    # keyed per count: another key starts from zeros too
    other = (0, 0, 10, 300, 0, -1)
    np.testing.assert_array_equal(
        ts.apply(other, torch.from_numpy(g), at.DataType[dt], 3).numpy(), g)
    stats = ts.stats()
    assert stats["updates"] == 7 and stats["entries"] == 2
    assert stats["max_residual_norm"] > 0
    ts.invalidate("test")
    assert ts.residual(key) is None and ts.stats()["invalidations"] == 1


# ---------------------------------------------------------------------------
# the compressed facade against the JAX gang
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_group():
    g = xla_group(P)
    yield g
    for a in g:
        a.deinit()


@pytest.fixture
def port_group():
    g = at.cuda_group(P, device="cpu")
    yield g
    for a in g:
        a.deinit()


def _allreduce(group, rows, lane, function=0, dtype=np.float32):
    count = rows.shape[1]

    def work(a, r):
        s = a.create_buffer_from(rows[r].astype(dtype))
        d = a.create_buffer(count, dtype)
        a.allreduce(s, d, count, function=function, compress_dtype=lane)
        d.sync_from_device()
        return np.asarray(d.data).astype(np.float32)

    return run_parallel(group, work)


def _codec_fold(rows, lane, function=0, dtype=np.float32):
    """The port's ``xla`` result for the single-rounding lanes: every
    contribution through the numpy codec (seed 0), folded in rank order
    in the operand dtype."""
    rounded = [jhw.roundtrip(rows[r].astype(dtype), JDataType[_DT[lane]], 0)
               .astype(dtype) for r in range(len(rows))]
    acc = rounded[0]
    for x in rounded[1:]:
        acc = (np.maximum(acc.astype(np.float32), x.astype(np.float32))
               if function else acc.astype(np.float32) + x.astype(np.float32)
               ).astype(dtype)
    return acc.astype(np.float32)


def _tune(group, algo):
    for a in group:
        a.set_tuning("allreduce_algorithm", algo)


@pytest.mark.parametrize("algo", ["xla", "pallas_ring", "pallas_ring_bidir"])
@pytest.mark.parametrize("lane", LANES)
def test_compressed_allreduce_equals_jax(jax_group, port_group, algo, lane):
    if algo != "xla" and not has_pallas_interpret():
        pytest.skip("the JAX pallas lowering off-chip needs the interpreter")
    rows = np.random.default_rng(31).standard_normal((P, 1000)).astype(
        np.float32)
    _tune(jax_group, algo)
    _tune(port_group, algo)
    try:
        want = _allreduce(jax_group, rows, lane)
    finally:
        _tune(jax_group, "xla")
    got = _allreduce(port_group, rows, lane)
    for r in range(P):
        if algo == "xla" and lane in ("float16", "bfloat16"):
            tol = 1e-2 if lane == "bfloat16" else 2e-3
            np.testing.assert_allclose(got[r], want[r], rtol=tol, atol=tol)
        elif algo == "xla" and lane == "int8":
            # the numpy codec's scales exactly; JAX's jitted program
            # divides by 127 as a multiply (test_int8_scale_divergence)
            np.testing.assert_array_equal(got[r], _codec_fold(rows, lane))
            np.testing.assert_allclose(got[r], want[r], rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("lane", ["float8_e5m2", "int8"])
def test_compressed_allreduce_bfloat16_and_max_equal_jax(
        jax_group, port_group, lane):
    """bfloat16 operands, and MAX (JAX's gang runs int8 under MAX too:
    the single rounding, then the max).  The contributions' rounding is
    bit for bit (the codec tests); the bfloat16 SUM then differs by the
    fold: XLA's CPU psum accumulates bfloat16 in float32 and rounds once,
    the port's ``xla`` lowering adds in bfloat16 rank by rank, so the two
    agree to a bfloat16 ulp of the partial sums (ROADMAP's
    divergences)."""
    rows = np.random.default_rng(32).standard_normal((P, 700)).astype(
        np.float32)
    for function, dtype in ((0, ml_dtypes.bfloat16), (1, np.float32),
                            (1, ml_dtypes.bfloat16)):
        want = _allreduce(jax_group, rows, lane, function, dtype)
        got = _allreduce(port_group, rows, lane, function, dtype)
        fold = _codec_fold(rows, lane, function, dtype)
        exact = lane != "int8" and (function or dtype == np.float32)
        for r in range(P):
            np.testing.assert_array_equal(got[r], fold)
            if exact:
                np.testing.assert_array_equal(got[r], want[r])
            else:  # the bfloat16 fold, or the int8 scale (see above)
                np.testing.assert_allclose(got[r], want[r], rtol=2 ** -6,
                                           atol=2 ** -6)


def test_int8_scale_divergence():
    """A recorded divergence: under ``jit`` XLA's CPU compiler turns the
    int8 lane's ``absmax / 127`` into ``absmax * (1 / 127)``, so the JAX
    gang's in-program scales can differ from the numpy codec's (and the
    eager twin's) by an ulp.  The port keeps the codec's division."""
    x = np.random.default_rng(33).standard_normal(2048).astype(np.float32)
    _, eager = jdw.quantize_int8(jnp.asarray(x), jnp.uint32(0))
    _, jitted = jax.jit(lambda v: jdw.quantize_int8(v, jnp.uint32(0)))(
        jnp.asarray(x))
    absmax = np.abs(x.reshape(-1, 256)).max(1)
    np.testing.assert_array_equal(np.asarray(eager), absmax / np.float32(127))
    np.testing.assert_array_equal(np.asarray(jitted),
                                  absmax * (np.float32(1) / np.float32(127)))
    assert not np.array_equal(np.asarray(eager), np.asarray(jitted))
    _, port = tdw.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(port.numpy(), np.asarray(eager))


def test_compressed_refusals_equal_jax(jax_group, port_group):
    """The same refusals: no f16 lane for bfloat16 operands, no scaled
    lane on a point-to-point call, no float64 wire register; a cast lane
    (fp8) on a point-to-point call is no refusal, and delivers."""
    for group, err in ((jax_group, None), (port_group, at.ACCLError)):
        a = group[0]
        buf = a.create_buffer(8, ml_dtypes.bfloat16)
        with pytest.raises(Exception) as ei:
            a.allreduce(buf, buf, 8, compress_dtype="float16")
        assert int(ei.value.code) & int(at.ErrorCode.INVALID_DTYPE)
        src = a.create_buffer_from(np.ones(8, np.float32))
        with pytest.raises(Exception) as ei:
            a.send(src, 8, dst=1, compress_dtype="int8")
        assert int(ei.value.code) & int(at.ErrorCode.COMPRESSION_ERROR)
        with pytest.raises(Exception) as ei:
            a.set_tuning("wire_dtype", int(at.DataType.FLOAT64))
        assert int(ei.value.code) & int(at.ErrorCode.CONFIG_ERROR)
        if err is not None:
            assert isinstance(ei.value, err)
    sreq = port_group[0].send(src, 8, dst=1, compress_dtype="float8_e4m3fn",
                              run_async=True)
    got = port_group[1].create_buffer(8, np.float32)
    port_group[1].recv(got, 8, src=0, compress_dtype="float8_e4m3fn")
    assert sreq.wait(30)
    sreq.check()
    got.sync_from_device()
    np.testing.assert_array_equal(got.data, np.ones(8, np.float32))


def test_wire_verdict_register_dispatch_equals_jax(jax_group, port_group):
    """``wire_dtype=int8`` rides a plain SUM allreduce; a MAX allreduce
    keeps the uncompressed wire (int8 allows SUM only); ``off`` restores
    the exact wire (tests/test_wire.py's register cases)."""
    rows = np.random.default_rng(33).standard_normal((P, 2048)).astype(
        np.float32)
    results = []
    for group in (jax_group, port_group):
        for a in group:
            a.set_tuning("wire_dtype", "int8")
        try:
            out = [_allreduce(group, rows, None)[0],
                   _allreduce(group, rows, None, function=1)[0]]
        finally:
            for a in group:
                a.set_tuning("wire_dtype", "off")
        out.append(_allreduce(group, rows, None)[0])
        results.append(out)
    (j_sum, j_max, j_off), (t_sum, t_max, t_off) = results
    np.testing.assert_array_equal(t_sum, _codec_fold(rows, "int8"))
    np.testing.assert_allclose(t_sum, j_sum, rtol=1e-6, atol=1e-6)
    assert 0 < np.abs(t_sum - rows.sum(0)).max() < 0.2
    np.testing.assert_array_equal(t_max, rows.max(0))
    np.testing.assert_array_equal(j_max, rows.max(0))
    np.testing.assert_allclose(t_off, j_off, rtol=1e-6, atol=1e-6)


def test_error_feedback_facade(port_group, monkeypatch):
    """Armed error feedback dispatches ``grad + residual``: the first
    call equals the plain compressed call, the residual it leaves is
    ``x - roundtrip(x, rank seed)``, and the per-comm seed counter
    advances on every compressed allreduce; ``ACCL_ERROR_FEEDBACK=1``
    arms a new handle."""
    rows = np.random.default_rng(34).standard_normal((P, 512)).astype(
        np.float32)
    plain = _allreduce(port_group, rows, "float8_e4m3fn")
    for a in port_group:
        a.set_error_feedback(True)
    armed = _allreduce(port_group, rows, "float8_e4m3fn")
    for r in range(P):
        np.testing.assert_array_equal(armed[r], plain[r])
    a = port_group[2]
    assert a.sr_calls == 2
    seed = thw.rank_seed(thw.call_seed(
        0, a.comm.epoch, 1, int(at.DataType.FLOAT8_E4M3)), 2)
    want = rows[2] - thw.roundtrip(rows[2], at.DataType.FLOAT8_E4M3,
                                   seed).numpy()
    key = (0, a.comm.epoch, at.constants.Operation.ALLREDUCE, 512, 0, -1)
    np.testing.assert_array_equal(a.residuals.residual(key).numpy(), want)
    a.set_error_feedback(False)
    assert a.residuals.residual(key) is None
    monkeypatch.setenv("ACCL_ERROR_FEEDBACK", "1")
    g = at.cuda_group(2, device="cpu")
    try:
        assert all(h._error_feedback for h in g)
    finally:
        for h in g:
            h.deinit()


def _convergence(g, wire, ef, steps=40, dim=512, batch=64):
    """bench.py's convergence leg (``_compression_convergence``) on a
    2-rank gang: DP-SGD linear regression with facade-allreduced
    gradients; returns the final loss."""
    rng = np.random.default_rng(42)
    w_true = rng.standard_normal(dim).astype(np.float32)
    X = [rng.standard_normal((batch, dim)).astype(np.float32)
         for _ in range(2)]
    y = [x @ w_true for x in X]
    try:
        if ef:
            for a in g:
                a.set_error_feedback(True)

        def work(a, r):
            w = np.zeros(dim, np.float32)
            gbuf = a.create_buffer(dim, np.float32)
            obuf = a.create_buffer(dim, np.float32)
            for _ in range(steps):
                err = X[r] @ w - y[r]
                gbuf.data[:] = (X[r].T @ err / batch).astype(np.float32)
                gbuf.sync_to_device()
                a.allreduce(gbuf, obuf, dim, compress_dtype=wire)
                obuf.sync_from_device()
                w -= 0.05 * obuf.data / 2.0
            return float(np.mean((X[r] @ w - y[r]) ** 2))

        return max(run_parallel(g, work, timeout=120.0))
    finally:
        for a in g:
            a.deinit()


@pytest.mark.parametrize("wire,ef", [(None, False),
                                     ("float8_e4m3fn", False),
                                     ("float8_e4m3fn", True)])
def test_convergence_leg_equals_jax(wire, ef):
    jg, tg = xla_group(2), at.cuda_group(2, device="cpu")
    # the per-call seeds are keyed by each communicator's epoch, which
    # both packages draw from a process-wide counter: align them
    for j, t in zip(jg, tg):
        t.comm.epoch = j.comm.epoch
    want = _convergence(jg, wire, ef)
    got = _convergence(tg, wire, ef)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fp8_and_int8_batches_run_call_by_call():
    """Once refused with ``wire_lane`` and run call by call, a batched
    fp8 / int8 window now rides the command ring as in JAX (ROADMAP A5):
    with the communicators' epochs aligned, the same calls on both gangs
    take one refill each, count no fallback, seed their slots alike and
    give JAX's ring result (fp8 bit for bit; int8 within an ulp of its
    scale, ``test_int8_scale_divergence``), which differs from the same
    call unbatched in both packages; the unbatched calls equal JAX's as
    the batched ones do (int8 also the codec's fold, as before the ring
    took the lanes)."""
    rows = np.random.default_rng(35).standard_normal((P, 512)).astype(
        np.float32)
    # fresh gangs: the seeds key on each communicator's epoch (aligned
    # here) and its count of seeded calls so far
    jax_group, port_group = xla_group(P), at.cuda_group(P, device="cpu")
    for j, t in zip(jax_group, port_group):
        t.comm.epoch = j.comm.epoch

    def work(a, r):
        s = a.create_buffer_from(rows[r].copy())
        out = []
        for lane in ("int8", "float8_e4m3fn", "float8_e5m2"):
            d = a.create_buffer(512, np.float32)
            with a.batch():
                req = a.allreduce(s, d, 512, compress_dtype=lane,
                                  run_async=True)
            req.wait()
            req.check()
            assert req.ring_resident is True
            d.sync_from_device()
            single = a.create_buffer(512, np.float32)
            a.allreduce(s, single, 512, compress_dtype=lane)
            single.sync_from_device()
            out += [np.asarray(d.data).copy(), np.asarray(single.data).copy()]
        return out

    try:
        stats = [g[0].engine.gang.cmdring.stats() for g in (jax_group,
                                                             port_group)]
        want = run_parallel(jax_group, work)
        got = run_parallel(port_group, work)
        after = [g[0].engine.gang.cmdring.stats() for g in (jax_group,
                                                            port_group)]
    finally:
        for a in jax_group + port_group:
            a.deinit()
    for s0, s1 in zip(stats, after):
        assert s1["refills"] - s0["refills"] == 3
        assert s1["fallbacks"] == s0["fallbacks"]
    for r in range(P):
        np.testing.assert_allclose(got[r][0], want[r][0], rtol=0,
                                   atol=2.0 ** -20)
        for k in (2, 4):
            np.testing.assert_array_equal(got[r][k], want[r][k])
        # the unbatched calls: int8 the codec's fold, and JAX's within an
        # ulp of its scale as above; fp8 JAX's bit for bit
        np.testing.assert_array_equal(got[r][1], _codec_fold(rows, "int8"))
        np.testing.assert_allclose(got[r][1], want[r][1], rtol=0,
                                   atol=2.0 ** -20)
        for k in (3, 5):
            np.testing.assert_array_equal(got[r][k], want[r][k])
        for k in (0, 2, 4):
            assert not np.array_equal(got[r][k], got[r][k + 1])
            assert not np.array_equal(want[r][k], want[r][k + 1])
