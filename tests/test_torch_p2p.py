"""The PyTorch port's point-to-point and stream calls against the JAX package.

Every test of ``tests/test_sendrecv.py`` and ``tests/test_streams.py``
runs unedited on the port's groups (``cuda_group(n, device="cpu")`` in
place of the ``group2`` / ``group4`` / ``gang4`` fixtures).  Row 13's
plain version (``ops.cuda.put.fused_shift_plain``) is held bit for bit
against JAX's ``fused_shift``, run by the Pallas TPU interpreter on the
4-device CPU mesh as ``tests/test_pallas.py`` runs it (16-bit operands
with constants they cannot hold, rounded as JAX rounds a weak-typed
scalar, and lengths around one tile of the card's kernel too); the three
``vadd_put`` forms, the compressed sends (every cast lane) and the
timeout contexts against the JAX gang (``xla_group``) on the same
seeded numpy data, exactly; so are a facade ``copy`` into a buffer of
each wire dtype and a stream result under RES_COMPRESSED (row 5's casts
on a card).  Then the port's own contracts: the int8
refusal, a batched pair, a send buffer overwritten after the call, the
cancelled posts of a shut-down engine, the stream deadline, and (on a
card only) row 13 and row 19 against their plain versions.
"""

import inspect
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

import test_sendrecv
import test_streams
from accl_tpu.compat import has_interpret_params, interpret_params_reason
from accl_tpu.core import xla_group
from accl_tpu.examples import vadd_put as jvadd
from accl_tpu.ops import make_mesh as jax_make_mesh
from accl_tpu.ops import pallas as pk
from helpers import run_parallel

import accl_tpu_torch as at
from accl_tpu_torch import compat, interop
from accl_tpu_torch.backends.cuda.engine import Payload, p2p_device_deliver
from accl_tpu_torch.examples import vadd_put as tvadd
from accl_tpu_torch.ops import cuda as kc

interpreted = pytest.mark.skipif(
    jax.default_backend() != "tpu" and not has_interpret_params(),
    reason=f"Pallas interpret tier unavailable: {interpret_params_reason()}",
)

#: the cast lanes a point-to-point call takes (int8 is refused)
CAST_LANES = ["float16", "bfloat16", "float8_e4m3fn", "float8_e5m2"]


@pytest.fixture(scope="module")
def port2():
    g = at.cuda_group(2, device="cpu")
    yield g
    for a in g:
        a.deinit()


@pytest.fixture(scope="module")
def port4():
    g = at.cuda_group(4, device="cpu")
    yield g
    for a in g:
        a.deinit()


@pytest.fixture(scope="module")
def jax2():
    g = xla_group(2)
    yield g
    for a in g:
        a.deinit()


# ---------------------------------------------------------------------------
# the JAX package's send/recv and stream tests, unedited, on the port
# ---------------------------------------------------------------------------


def _cases(module):
    """``(name, kwargs)`` for every test of ``module``, one per
    parametrised case (read off the functions' own marks)."""
    out = []
    for name, fn in inspect.getmembers(module, inspect.isfunction):
        if not name.startswith("test_"):
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        cases = [{}]
        for m in marks:
            argname, values = m.args
            cases = [dict(c, **{argname: v}) for c in cases for v in values]
        out += [(f"{module.__name__}::{name}", kw) for kw in cases]
    return out


REFERENCE_CASES = _cases(test_sendrecv) + _cases(test_streams)


def test_every_reference_test_is_run():
    """Each test function of the two files is among the cases (21 test
    functions, 29 cases with their parameters)."""
    names = {n.split("::")[1] for n, _ in REFERENCE_CASES}
    for module in (test_sendrecv, test_streams):
        assert {n for n, _ in inspect.getmembers(module, inspect.isfunction)
                if n.startswith("test_")} <= names
    assert len(REFERENCE_CASES) == 29


@pytest.mark.parametrize(
    "name,kwargs", REFERENCE_CASES,
    ids=[f"{n.split('::')[1]}-{'-'.join(map(str, kw.values())) or 'plain'}"
         for n, kw in REFERENCE_CASES],
)
def test_reference_test_on_port(name, kwargs, port2, port4):
    module, func = name.split("::")
    fn = getattr({"test_sendrecv": test_sendrecv,
                  "test_streams": test_streams}[module], func)
    groups = {"group2": port2, "group4": port4, "gang4": port4}
    args = {}
    for p in inspect.signature(fn).parameters:
        if p in groups:
            args[p] = groups[p]
        elif p == "rng":
            args[p] = np.random.default_rng(42)
        else:
            args[p] = kwargs[p]
    fn(**args)


# ---------------------------------------------------------------------------
# row 13: the plain version against the interpreted Pallas kernel
# ---------------------------------------------------------------------------


def _jax_fused_shift(data, distance, compute):
    devs = jax.devices()[: len(data)]
    if len(devs) < len(data):
        pytest.skip(f"needs {len(data)} devices")
    mesh = Mesh(np.array(devs), ("x",))
    fn = jax.jit(shard_map(
        lambda x: pk.fused_shift(x[0], "x", distance, compute)[None],
        mesh=mesh, in_specs=PS("x"), out_specs=PS("x"), check_vma=False,
    ))
    return np.asarray(fn(jnp.asarray(data)))


@interpreted
@pytest.mark.parametrize("distance", [1, 3])
@pytest.mark.parametrize("form", ["mul", "add"])
def test_fused_shift_plain_equals_pallas(form, distance):
    """``* 2.0`` and ``+ 1.0`` over n = 700 on 4 ranks, bit for bit."""
    data = np.random.default_rng(7).normal(size=(4, 700)).astype(np.float32)
    jfn = (lambda v: v * 2.0) if form == "mul" else (lambda v: v + 1.0)
    port = kc.Mul(2.0) if form == "mul" else kc.Add(1.0)
    want = _jax_fused_shift(data, distance, jfn)
    got = kc.fused_shift_plain(torch.from_numpy(data), distance, port)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    got = kc.fused_shift(list(torch.from_numpy(data)), distance, port)
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


#: constants a 16-bit operand cannot hold: JAX converts the weak-typed
#: Python float to the operand's dtype through float32 before it computes
#: (1 + 2**-8 + 2**-30 is 1 + 2**-8 in float32, then 1.0 in bfloat16)
CONSTANTS_16 = [("mul", 1.3), ("add", 0.1), ("mul", 1 + 2**-8 + 2**-30)]


@interpreted
@pytest.mark.parametrize("form,c", CONSTANTS_16)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fused_shift_16bit_constant_equals_pallas(dtype, form, c):
    """``v * c`` and ``v + c`` on 16-bit operands over n = 700 on 4 ranks,
    bit for bit: the constant rounds to the operand's dtype as JAX's
    weak-typed scalar does."""
    data = np.random.default_rng(7).normal(size=(4, 700)).astype(
        jnp.dtype(dtype))
    jfn = (lambda v: v * c) if form == "mul" else (lambda v: v + c)
    port = kc.Mul(c) if form == "mul" else kc.Add(c)
    want = _jax_fused_shift(data, 1, jfn).view(np.uint16)
    xs = interop.stacked_from_numpy(data, "cpu")
    np.testing.assert_array_equal(
        _bits16(torch.stack(kc.fused_shift(xs, 1, port))), want)
    np.testing.assert_array_equal(
        _bits16(kc.fused_shift_plain(torch.stack(xs), 1, port)), want)


@interpreted
@pytest.mark.parametrize("n", [1, 255, 257])
@pytest.mark.parametrize("dtype", ["int32", "bfloat16"])
def test_fused_shift_odd_lengths_equal_pallas(n, dtype):
    """Lengths shorter than one tile of the card's kernel and past it by
    one element (its scalar path): int32 ``v * 3`` wrapping, bfloat16
    ``v * 1.3``, distance -1."""
    rng = np.random.default_rng(n)
    if dtype == "int32":
        data = rng.integers(-2**31, 2**31, size=(4, n)).astype(np.int32)
        jfn, port = (lambda v: v * 3), kc.Mul(3)
    else:
        data = rng.standard_normal((4, n)).astype(jnp.bfloat16)
        jfn, port = (lambda v: v * 1.3), kc.Mul(1.3)
    want = _jax_fused_shift(data, -1, jfn)
    got = kc.fused_shift(interop.stacked_from_numpy(data, "cpu"), -1, port)
    np.testing.assert_array_equal(interop.to_numpy(torch.stack(got)),
                                  want.astype(np.float32)
                                  if dtype == "bfloat16" else want)


def test_fused_shift_forms_and_refusals():
    """Python's modulus for any distance, P = 1, integer wrap, any
    callable, both operand layouts; and the refusals."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal(9).astype(np.float32))
          for _ in range(4)]
    for d in (-1, 5, 4, 0):
        got = kc.fused_shift(xs, d, kc.Add(0.5))
        for r in range(4):
            assert torch.equal(got[(r + d) % 4], xs[r] + 0.5)
    assert torch.equal(kc.fused_shift(xs[:1], 3, kc.Mul(2.0))[0], xs[0] * 2)
    big = torch.tensor([2**31 - 1, -2**31, 7], dtype=torch.int32)
    got = kc.fused_shift([big, big.clone()], 1, kc.Mul(2.0))
    assert got[1].tolist() == [-2, 0, 14]
    stacked = torch.stack(xs)
    assert torch.equal(kc.fused_shift(stacked, 2, lambda v: v - 1),
                       torch.roll(stacked - 1, 2, 0))
    with pytest.raises(ValueError, match="integer operand"):
        kc.fused_shift([big], 1, kc.Add(0.5))
    with pytest.raises(ValueError, match="overlap"):
        kc.fused_shift(xs, 1, out=[xs[1], xs[2], xs[3], xs[0]])
    with pytest.raises(ValueError, match="match in shape"):
        kc.fused_shift([xs[0], xs[1][:3]])
    before = kc.fused_shift.launches.count
    kc.fused_shift(xs, 1)
    assert kc.fused_shift.launches.count == before  # CPU: the plain version


# ---------------------------------------------------------------------------
# vadd_put: the three forms against JAX's
# ---------------------------------------------------------------------------


def _vadd_pair(group, module, data):
    """Rank 0 runs ``vadd_put`` (tag-matched) then ``vadd_put_streamed``
    (into rank 1's port 4); rank 1 receives both."""
    def work(a, r):
        if r == 0:
            module.vadd_put(a, data, 1, stream_id=3, increment=1.0)
            module.vadd_put_streamed(a, data, 1, stream_id=4, increment=1.0)
            return None
        buf = a.create_buffer(data.size, np.float32)
        a.recv(buf, data.size, src=0, tag=3)
        buf.sync_from_device()
        return (np.asarray(buf.data).copy(),
                a.stream_pop(data.size, np.float32, stream_id=4))

    return run_parallel(group, work)[1]


def test_vadd_put_forms_equal_jax(jax2, port2):
    data = np.random.default_rng(11).standard_normal(513).astype(np.float32)
    want = _vadd_pair(jax2, jvadd, data)
    got = _vadd_pair(port2, tvadd, data)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, data + np.float32(1.0))


@interpreted
def test_vadd_put_kernel_equals_vadd_put_pallas():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    data = np.random.default_rng(12).standard_normal((4, 300)).astype(
        np.float32)
    want = np.asarray(jvadd.vadd_put_pallas(data, jax_make_mesh(4),
                                            increment=1.0))
    got = tvadd.vadd_put_kernel(torch.from_numpy(data), 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.roll(data + 1.0, 1, axis=0))


# ---------------------------------------------------------------------------
# compressed sends: the cast lanes against the JAX gang
# ---------------------------------------------------------------------------


def _compressed_send(group, data, lane):
    n = data.size

    def work(a, r):
        if r == 0:
            a.send(a.create_buffer_from(data), n, dst=1, tag=4,
                   compress_dtype=lane)
            return None
        buf = a.create_buffer(n, np.float32)
        a.recv(buf, n, src=0, tag=4, compress_dtype=lane)
        buf.sync_from_device()
        return np.asarray(buf.data).copy()

    return run_parallel(group, work)[1]


@pytest.mark.parametrize("lane", CAST_LANES)
def test_compressed_send_equals_jax(lane, jax2, port2):
    """Narrowed on the sender, widened on the receiver (row 5 twice on
    the card), bit for bit with JAX's gang: normals at three scales,
    signed zeros, subnormals of every lane."""
    rng = np.random.default_rng(21)
    data = np.concatenate([
        rng.standard_normal(600) * s for s in (1.0, 1e-3, 30.0)
    ] + [np.array([0.0, -0.0, 1e-6, -3e-8, 5e-40, 448.0, -57344.0])]
    ).astype(np.float32)
    want = _compressed_send(jax2, data, lane)
    got = _compressed_send(port2, data, lane)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    wire = getattr(ml_dtypes, lane) if lane != "float16" else np.float16
    np.testing.assert_array_equal(
        got, data.astype(wire).astype(np.float32))


def _lane_operand():
    data = np.random.default_rng(5).standard_normal(257).astype(np.float32)
    data[:6] = [np.nan, -np.nan, 1e6, -0.0, np.inf, 3e-9]
    return data


@pytest.mark.parametrize("lane", CAST_LANES)
def test_cross_dtype_copy_equals_jax(lane, jax2, port2):
    """A facade ``copy`` from float32 into a buffer of a wire dtype casts
    as JAX's does (on a card: row 5), bit for bit."""
    data = _lane_operand()
    n = data.size
    j = jax2[0]
    s, d = j.create_buffer_from(data), j.create_buffer(
        n, np.dtype(getattr(ml_dtypes, lane, lane)))
    j.copy(s, d, n)
    d.sync_from_device()
    want = np.asarray(d.data).view(np.uint8 if d.data.itemsize == 1
                                   else np.uint16)
    p = port2[0]
    s, d = p.create_buffer_from(data), p.create_buffer(n, getattr(torch, lane))
    p.copy(s, d, n)
    got = d.tensor[:n].view(torch.uint8 if d.tensor.element_size() == 1
                            else torch.int16).numpy()
    np.testing.assert_array_equal(got.view(want.dtype), want)


def _compressed_stream_result(accl, c, options, dummy, data):
    """COPY of ``data`` to this rank's stream port with RES_COMPRESSED
    (``c``: the package's constants; ``options`` / ``dummy``: its
    ``CallOptions`` / ``DummyBuffer``): the port receives bfloat16."""
    s = accl.create_buffer_from(data)
    cfg, _ = accl._resolve_arithcfg(c.DataType.FLOAT32, "bfloat16")
    accl._launch(options(
        op=c.Operation.COPY, comm=accl.comm, count=data.size, arithcfg=cfg,
        compression=c.CompressionFlags.RES_COMPRESSED,
        stream=c.StreamFlags.RES_STREAM, stream_id=13, op0=s,
        res=dummy(data.size, c.DataType.FLOAT32)), False, "copy_to_stream")
    return np.asarray(accl.stream_pop(data.size, ml_dtypes.bfloat16,
                                      stream_id=13)).view(np.uint16)


def test_compressed_stream_result_equals_jax(jax2, port2):
    """A stream result under RES_COMPRESSED reaches the port in the
    compressed dtype as JAX writes it (on a card: row 5), bit for bit."""
    from accl_tpu import constants as jc
    from accl_tpu.backends.base import CallOptions as JOptions
    from accl_tpu.buffer import DummyBuffer as JDummy
    from accl_tpu_torch import constants as tc
    from accl_tpu_torch.backends.base import CallOptions as TOptions
    from accl_tpu_torch.buffer import DummyBuffer as TDummy

    data = _lane_operand()
    want = _compressed_stream_result(jax2[0], jc, JOptions, JDummy, data)
    got = _compressed_stream_result(port2[0], tc, TOptions, TDummy, data)
    np.testing.assert_array_equal(got, want)


def test_scaled_lane_refused_on_p2p(port2):
    src = port2[0].create_buffer_from(np.ones(8, np.float32))
    for call in (lambda: port2[0].send(src, 8, dst=1, compress_dtype="int8"),
                 lambda: port2[1].recv(src, 8, src=0, compress_dtype="int8")):
        with pytest.raises(at.ACCLError) as ei:
            call()
        assert ei.value.code == at.ErrorCode.COMPRESSION_ERROR
        assert "collective-only" in str(ei.value)


# ---------------------------------------------------------------------------
# deadlines: the watchdog's codes and context against JAX's
# ---------------------------------------------------------------------------


def _starved(group, kind):
    a = group[1]
    a.set_timeout(0.2)
    try:
        buf = a.create_buffer(4, np.float32)
        t0 = time.monotonic()
        with pytest.raises(Exception) as ei:
            if kind == "recv":
                a.recv(buf, 4, src=0, tag=77)
            else:
                a.send(buf, 4, dst=0, tag=77)
        return ei.value, time.monotonic() - t0
    finally:
        a.set_timeout(30.0)


@pytest.mark.parametrize("kind", ["recv", "send"])
def test_unmatched_post_times_out_as_jax(kind, jax2, port2):
    """An unmatched recv (send) under ``set_timeout(0.2)`` fails with
    RECEIVE_TIMEOUT (SEND_TIMEOUT) and JAX's context: the op, the comm,
    the absent peer and the elapsed seconds."""
    want, _ = _starved(jax2, kind)
    got, waited = _starved(port2, kind)
    code = (at.ErrorCode.RECEIVE_TIMEOUT if kind == "recv"
            else at.ErrorCode.SEND_TIMEOUT)
    assert int(want.code) == int(code) and got.code == code
    keys = ("op", "comm", "peer")
    assert set(got.details) == {"op", "comm", "peer", "elapsed_s"}
    assert {k: got.details[k] for k in keys} == {
        k: want.details[k] for k in keys}
    assert 0.2 <= got.details["elapsed_s"] and waited < 5.0
    assert port2[0].engine.gang.p2p.parked() == {"send": 0, "recv": 0}


def test_stream_deadlines(port2):
    """A stream operand that never arrives fails the call with
    DMA_TIMEOUT after the engine timeout; ``stream_pop`` honours its own
    ``timeout``."""
    a = port2[0]
    a.set_timeout(0.2)
    try:
        buf = a.create_buffer(4, np.float32)
        with pytest.raises(at.ACCLError) as ei:
            a.copy_from_stream(buf, 4, stream_id=41)
        assert ei.value.code == at.ErrorCode.DMA_TIMEOUT
        with pytest.raises(at.ACCLError) as ei:
            a.send(None, 4, dst=1, from_stream=True, stream_id=41)
        assert ei.value.code == at.ErrorCode.DMA_TIMEOUT
    finally:
        a.set_timeout(30.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        a.stream_pop(4, np.float32, stream_id=41, timeout=0.1)
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------


def test_batched_pair_delivers(port2):
    """A send and a recv queued in batches (around an allreduce) dispatch
    on their own in issue order and deliver."""
    data = np.arange(64, dtype=np.float32)

    def work(a, r):
        s = a.create_buffer_from(data * (r + 1))
        d = a.create_buffer(64, np.float32)
        p = a.create_buffer(64, np.float32)
        with a.batch():
            if r == 0:
                req = a.send(s, 64, dst=1, tag=3, run_async=True)
            else:
                req = a.recv(p, 64, src=0, tag=3, run_async=True)
            areq = a.allreduce(s, d, 64, run_async=True)
        for q in (req, areq):
            assert q.wait(30)
            q.check()
        d.sync_from_device()
        p.sync_from_device()
        return np.asarray(d.data).copy(), np.asarray(p.data).copy()

    res = run_parallel(port2, work)
    np.testing.assert_array_equal(res[0][0], data * 3)
    np.testing.assert_array_equal(res[1][1], data)


def test_channel_under_contention():
    """Every ordered pair of 8 ranks exchanges 4 tagged messages at once
    (224 sends, 224 recvs, more threads than this test's share of cores)
    under a 1 us switch interval: each arrives whole at its receiver and
    nothing stays parked."""
    import sys

    g = at.cuda_group(8, device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(a, r):
            reqs, outs = [], {}
            for peer in range(8):
                if peer == r:
                    continue
                for t in range(4):
                    src = a.create_buffer_from(
                        np.full(33, 100 * r + t, np.float32))
                    reqs.append(a.send(src, 33, dst=peer, tag=t,
                                       run_async=True))
                    outs[(peer, t)] = a.create_buffer(33, np.float32)
                    reqs.append(a.recv(outs[(peer, t)], 33, src=peer, tag=t,
                                       run_async=True))
            for q in reqs:
                assert q.wait(30)
                q.check()
            return {k: np.unique(b.tensor.numpy()).tolist()
                    for k, b in outs.items()}

        res = run_parallel(g, work, timeout=60)
        for r in range(8):
            assert res[r] == {(p, t): [100.0 * p + t] for p in range(8)
                              if p != r for t in range(4)}
        assert g[0].engine.gang.p2p.parked() == {"send": 0, "recv": 0}
    finally:
        sys.setswitchinterval(interval)
        for a in g:
            a.deinit()


def test_send_buffer_may_be_overwritten_after_send_returns(port2):
    """An asynchronous send snapshots its operand: writing the buffer
    right after the call returns does not change what arrives."""
    data = np.random.default_rng(9).standard_normal(1000).astype(np.float32)
    a, b = port2
    src = a.create_buffer_from(data.copy())
    req = a.send(src, 1000, dst=1, tag=8, run_async=True)
    src.tensor.fill_(-1.0)
    src.host_view()[:] = -1.0
    dst = b.create_buffer(1000, np.float32)
    b.recv(dst, 1000, src=0, tag=8)
    assert req.wait(30)
    req.check()
    dst.sync_from_device()
    np.testing.assert_array_equal(dst.data, data)


def test_shutdown_cancels_parked_posts():
    """``deinit`` stops a rank's parked posts: their watchdogs are
    cancelled and their requests fail at once."""
    g = at.cuda_group(2, device="cpu")
    buf = g[1].create_buffer(4, np.float32)
    req = g[1].recv(buf, 4, src=0, tag=1, run_async=True)
    sreq = g[0].send(buf, 4, dst=1, tag=2, run_async=True)
    assert g[0].engine.gang.p2p.parked() == {"send": 1, "recv": 1}
    g[1].deinit()
    assert req.wait(5)
    assert req.get_retcode() == at.ErrorCode.INVALID_OPERATION
    assert req.error_context["error"] == "engine shut down"
    assert not sreq.done()
    g[0].deinit()
    assert sreq.wait(5)
    assert g[0].engine.gang.p2p.parked() == {"send": 0, "recv": 0}


def test_mismatched_pair_fails_both_sides(port2):
    """A payload shorter than the receive fails the pair with
    INVALID_OPERATION; a hop between two devices is refused, not
    guessed."""
    def work(a, r):
        buf = a.create_buffer(8, np.float32)
        with pytest.raises(at.ACCLError) as ei:
            if r == 0:
                a.send(buf, 4, dst=1, tag=6)
            else:
                a.recv(buf, 8, src=0, tag=6)
        return ei.value.code

    assert run_parallel(port2, work) == [at.ErrorCode.INVALID_OPERATION] * 2
    res = port2[0].create_buffer(4, np.float32)
    with pytest.raises(NotImplementedError, match="B14"):
        p2p_device_deliver(Payload(torch.empty(4, device="meta")), res, 4)


def test_p2p_on_cpu_launches_no_kernel(port2):
    for k in kc.KERNELS.values():
        k.launches.reset()
    data = np.ones(16, np.float32)

    def work(a, r):
        buf = a.create_buffer_from(data)
        if r == 0:
            a.send(buf, 16, dst=1, compress_dtype="bfloat16")
            a.stream_put(buf, 16, dst=1, stream_id=9)
        else:
            a.recv(buf, 16, src=0, compress_dtype="bfloat16")
            a.stream_pop(16, np.float32, stream_id=9)

    run_parallel(port2, work)
    assert {k: f.launches.count for k, f in kc.KERNELS.items()} == {
        k: 0 for k in kc.KERNELS}


def test_kernel_probe_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compat._probe_kernels() == (False, "no CUDA device is available")


@pytest.mark.gpu
def test_put_and_probe_kernels_on_the_card():
    """On the card row 19's probe holds, and row 13 equals its plain
    version over every compute form and a misaligned view."""
    if not compat.has_kernels():
        pytest.skip(compat.kernels_reason())
    dev = torch.device("cuda", 0)
    x = torch.randn(3, 1001, device=dev)
    x[0, ::7] = float("nan")
    for d in (1, -1, 3):
        for comp in (None, kc.Add(1.0), kc.Mul(2.0)):
            got = kc.fused_shift(x, d, comp)
            want = kc.fused_shift_plain(x, d, comp)
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)
    rows = [x[0, 1:], x[1, 1:]]
    torch.testing.assert_close(torch.stack(kc.fused_shift(rows, 1)),
                               torch.stack(kc.fused_shift_plain(rows, 1)),
                               rtol=0, atol=0, equal_nan=True)
    block = torch.randn(8, 128, device=dev)
    assert torch.equal(kc.probe_copy(block), kc.probe_copy_plain(block))
