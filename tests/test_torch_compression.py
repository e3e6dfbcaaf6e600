"""Rows 5-8 of the port (``accl_tpu_torch/ops/cuda/compression.py``) against
the JAX package's Pallas compression kernels, run under the Pallas
interpreter as ``tests/test_pallas.py`` runs them.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
card's checks (``chip_smoke.py`` phase 2) hold the kernels to these plain
versions bit for bit.  Casts, quantize, dequantize and ``int8_allreduce``
are held to JAX bit for bit (values, scales and NaN bits).  The
stochastic cast cannot be: the TPU's hardware random bits cannot be
matched and the interpreter stubs them to zero, so the port's plain
version fed zero bits equals the interpreter's truncation bit for bit,
and the seeded cast is held by its bounds, its determinism per seed and
its unbiasedness.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import accl_tpu.ops.pallas as pk
from jax.experimental.pallas import tpu as pltpu
from accl_tpu.compat import has_pallas_interpret

import accl_tpu_torch as at
from accl_tpu_torch.ops.cuda import compression as kcomp
from accl_tpu_torch.ops.cuda import ring as kring
from accl_tpu_torch.ops.cuda._common import block_rows, pack_lanes

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

pytestmark = pytest.mark.skipif(
    not has_pallas_interpret(),
    reason="the JAX Pallas kernels off-chip need the interpreter")

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}
_NUMPY = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
          "float16": np.float16, "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
          "float8_e5m2": ml_dtypes.float8_e5m2}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_TBITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _bits(a) -> np.ndarray:
    """The bit patterns of a numpy array or a CPU tensor."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().view(_TBITS[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_UINT[a.dtype.itemsize])


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    signed = {1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(a.view(signed)).view(_TORCH[a.dtype.name])


def _specials() -> np.ndarray:
    """NaN (both signs), infinities, signed zeros, float32 and target
    subnormals, the fp8 overflow edges, ties, and normals at every
    scale the lanes cover."""
    rng = np.random.default_rng(5)
    edges = np.array([
        np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
        2.0 ** -9, 2.0 ** -10, 2.0 ** -16, 2.0 ** -17, 3 * 2.0 ** -10,
        448.0, 464.0, 464.0001, 480.0, 500.0, -1e6, 57344.0, 61439.0,
        61440.0, 65504.0, 65520.0, 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -4,
        3e38, -3e38,
    ], np.float32)
    normals = np.concatenate([
        rng.standard_normal(256).astype(np.float32) * s
        for s in (1e-5, 1e-2, 1.0, 30.0, 300.0, 3e4)])
    return np.concatenate([edges, normals])


def _source(name: str) -> np.ndarray:
    if name in ("float8_e4m3fn", "float8_e5m2"):
        return np.arange(256, dtype=np.uint8).view(_NUMPY[name])
    return _specials().astype(_NUMPY[name])


_LANES = ["float32", "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2"]


@pytest.mark.parametrize(
    "src,dst", [(s, d) for s in _LANES for d in _LANES if s != d])
def test_cast_equals_pallas(src, dst):
    """Row 5, every lane pair, bit for bit with the special values."""
    x = _source(src)
    want = pk.cast(jnp.asarray(x), _NUMPY[dst], interpret=True)
    got = kcomp.cast(_to_torch(x), _TORCH[dst])
    assert got.dtype == _TORCH[dst] and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_cast_rows_takes_every_rank_in_one_call():
    rows = [_specials() * (r + 1) for r in range(3)]
    got = kcomp.cast_rows([torch.from_numpy(r) for r in rows],
                          torch.float8_e4m3fn)
    for r, g in zip(rows, got):
        np.testing.assert_array_equal(
            _bits(g), _bits(r.astype(ml_dtypes.float8_e4m3fn)))


def test_e5m2_nan_from_narrow_sources_is_unsigned():
    """A recorded divergence: JAX's astype writes float8_e5m2's NaN as
    0x7F (sign dropped) from bfloat16, float16 and e4m3 sources, where
    ml_dtypes keeps the sign (0xFE for -NaN); the port copies JAX."""
    neg = np.array([-np.nan], np.float32)
    for src in ("bfloat16", "float16"):
        x = neg.astype(_NUMPY[src])
        assert _bits(x.astype(ml_dtypes.float8_e5m2))[0] == 0xFE
        jax_bits = _bits(jnp.asarray(x).astype(jnp.float8_e5m2))[0]
        assert jax_bits == 0x7F
        assert _bits(kcomp.cast(_to_torch(x), torch.float8_e5m2))[0] == 0x7F
    # from float32 both keep the sign
    assert _bits(kcomp.cast(torch.from_numpy(neg),
                            torch.float8_e5m2))[0] == 0xFE


def test_e4m3_overflow_is_nan_not_saturation():
    """torch's own float32 -> float8_e4m3fn saturates above 464; JAX's
    astype, which the port follows, gives NaN."""
    x = torch.tensor([464.0, 464.5, 1e6, float("inf")])
    assert x.to(torch.float8_e4m3fn).float()[1].item() == 448.0
    got = kcomp.cast(x, torch.float8_e4m3fn).float()
    assert got[0].item() == 448.0 and torch.isnan(got[1:]).all()


def test_stochastic_cast_zero_bits_equals_interpreter():
    """Row 6: the interpreter stubs the PRNG to zero bits (truncation);
    the plain version fed zero bits gives the same bits."""
    x = _specials()
    want = pk.cast(jnp.asarray(x), jnp.bfloat16, stochastic=True, seed=11,
                   interpret=pltpu.InterpretParams())
    t = torch.from_numpy(x)
    got = kcomp.stochastic_cast_plain(
        t, torch.bfloat16, 11, 16, 0.0, always=True,
        bits=torch.zeros(x.shape, dtype=torch.int64))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_stochastic_cast_bounds_and_determinism():
    x = np.random.default_rng(6).standard_normal(4096).astype(np.float32)
    t = torch.from_numpy(x)
    a = kcomp.cast(t, torch.bfloat16, stochastic=True, seed=3)
    b = kcomp.cast(t, torch.bfloat16, stochastic=True, seed=3)
    c = kcomp.cast(t, torch.bfloat16, stochastic=True, seed=4)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert not np.array_equal(_bits(a), _bits(c))
    # each output is one of x's two bfloat16 neighbours
    down = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    up = ((x.view(np.uint32) & np.uint32(0xFFFF0000)) + np.uint32(0x10000)
          ).view(np.float32)
    got = a.float().numpy()
    assert np.all((got == down) | (got == up))
    with pytest.raises(ValueError, match="float32 -> bfloat16"):
        kcomp.cast(t.to(torch.float16), torch.bfloat16, stochastic=True)


def test_stochastic_round_unbiased():
    """JAX's own case (tests/test_pallas.py): x = 1 + 2^-9 lies a quarter
    of the way from 1 to the next bfloat16; 2048 draws must take both
    neighbours, their mean within 3 sigma of x."""
    x = torch.full((2048,), 1.0 + 2.0 ** -9)
    out = kcomp.cast(x, torch.bfloat16, stochastic=True, seed=11).float()
    vals = np.unique(out.numpy())
    assert len(vals) == 2, vals
    ulp, p = 2.0 ** -7, 0.25
    sigma = ulp * np.sqrt(p * (1 - p) / x.numel())
    assert abs(float(out.mean()) - (1.0 + 2.0 ** -9)) < 3 * sigma


@pytest.mark.parametrize("n", [1, 500, 4097, 65_536, 2 * 65_536 + 1000])
def test_quantize_dequantize_equal_pallas(n):
    """Rows 7-8 in the Pallas tier's layouts: values (rows, 128), scales
    (nblk, 1); bit for bit, values, scales and the dequantized floats."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    if n > 600:
        x[256:512] = 0.0  # an all-zero stretch
    wv, ws, wn = pk.quantize_int8(jnp.asarray(x), interpret=True)
    gv, gs, gn = kcomp.quantize_int8(torch.from_numpy(x))
    assert gn == wn == n
    assert tuple(gv.shape) == wv.shape and tuple(gs.shape) == ws.shape
    rows = gv.shape[0]
    assert gs.shape[0] == rows // block_rows(rows)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    for dtype in ("float32", "bfloat16"):
        want = pk.dequantize_int8(wv, ws, wn, (n,), _NUMPY[dtype],
                                  interpret=True)
        got = kcomp.dequantize_int8(gv, gs, gn, (n,), _TORCH[dtype])
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_quantize_bfloat16_operand_equals_pallas():
    x = (np.random.default_rng(8).standard_normal(3000) * 7).astype(
        ml_dtypes.bfloat16)
    wv, ws, _ = pk.quantize_int8(jnp.asarray(x), interpret=True)
    gv, gs, _ = kcomp.quantize_int8(_to_torch(x))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("n", [1, 255, 257])
def test_quantize_whole_operand_segment_equals_pallas(n, dtype):
    """Where ``block_rows`` falls back to ``total_rows`` (an operand of at
    most 512 packed rows is one block), the segment is the whole padded
    operand, 32 x 128 elements here: the wrapper's plain version equals
    the interpreted kernel bit for bit, values and scales, from float32
    and from float16 (widened exactly), and the card takes a cluster of
    one CTA for it."""
    rng = np.random.default_rng(1000 + n)
    x = (rng.standard_normal(n) * 5.0).astype(_NUMPY[dtype])
    x[n // 2] = 0.0
    rows = pack_lanes(torch.zeros(n))[0].shape[0]
    assert block_rows(rows) == rows == 32
    wv, ws, wn = pk.quantize_int8(jnp.asarray(x), interpret=True)
    gv, gs, gn = kcomp.quantize_int8(_to_torch(x))
    assert gn == wn == n and tuple(gs.shape) == ws.shape == (1, 1)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    assert kcomp.quantize_geometry(rows * 128, _TORCH[dtype]) == (
        kcomp.QP_CLUSTER, 1, 256)


def test_quantize_geometry_table():
    """Row 7's choice of path is a pure function of (L, dtype) and this is
    its table: LANES up to 512 (a half-warp a segment up to 256),
    CLUSTER up to 8 CTAs x 8192 elements (the fewest CTAs of 256
    threads), TWO_PASS above, whatever the source dtype.  The Pallas tier's
    segments (block_rows x 128) always fit one cluster."""
    L_, C, T = kcomp.QP_LANES, kcomp.QP_CLUSTER, kcomp.QP_TWO_PASS
    table = {
        1: (L_, 1, 16), 100: (L_, 1, 16), 256: (L_, 1, 16),
        257: (L_, 1, 32), 512: (L_, 1, 32), 513: (C, 1, 256),
        4096: (C, 1, 256), 8192: (C, 1, 256), 8193: (C, 2, 256),
        32768: (C, 4, 256), 49152: (C, 8, 256), 65536: (C, 8, 256),
        65537: (T, 1, 256), 1 << 22: (T, 1, 256),
    }
    assert kcomp.QUANT_CLUSTER_CAP == 65536
    for dtype in kcomp.QUANT_SOURCES:
        assert {L: kcomp.quantize_geometry(L, dtype) for L in table} == table
    for path, cluster, threads in table.values():
        assert threads % 16 == 0 and cluster in (1, 2, 4, 8)
    for rows in (32, 64, 512, 544, 32 * 17 * 31, 1 << 17, 131072 + 32):
        seg = block_rows(rows) * 128
        assert kcomp.quantize_geometry(seg)[0] == C, rows
    for bad in ((0, torch.float32), (256, torch.int32)):
        with pytest.raises(ValueError):
            kcomp.quantize_geometry(*bad)


def test_pack_lanes_equals_jax():
    from accl_tpu.ops.pallas._common import pack_lanes as jpack

    for n in (1, 127, 1025, 5000):
        x = np.arange(n, dtype=np.float32)
        jp, jn = jpack(jnp.asarray(x))
        tp, tn = pack_lanes(torch.from_numpy(x))
        assert jn == tn and tuple(tp.shape) == jp.shape
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for rows in (8, 512, 520, 1024, 4104, 8 * 997):
        from accl_tpu.ops.pallas._common import block_rows as jbr

        assert block_rows(rows) == jbr(rows)


def test_int8_allreduce_equals_jax():
    """``int8_allreduce`` on the port's gang buffers against JAX's under
    shard_map on the CPU mesh, bit for bit, with JAX's analytic error
    bound (tests/test_pallas.py)."""
    from accl_tpu.ops import make_mesh
    from accl_tpu.ops.driver import AXIS

    P = 4
    n = 4 * 8 * 128
    rng = np.random.default_rng(33)
    data = (rng.normal(size=(P, n)) * 3.0).astype(np.float32)
    fn = jax.jit(shard_map(
        lambda x: pk.int8_allreduce(x[0], AXIS)[None],
        mesh=make_mesh(P), in_specs=PS(AXIS), out_specs=PS(AXIS),
        check_vma=False))
    want = np.asarray(fn(jnp.asarray(data)))
    g = at.cuda_group(P, device="cpu")
    try:
        bufs = [a.create_buffer_from(data[r].copy()) for r, a in enumerate(g)]
        got = kring.int8_allreduce([b.tensor for b in bufs])
    finally:
        for a in g:
            a.deinit()
    expect = data.sum(0)
    bound = (np.abs(data).max(axis=1) / 127.0).sum() / 2.0 + 1e-4
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])
        assert np.abs(got[r].numpy() - expect).max() <= bound


def test_compression_wrappers_refuse_bad_inputs():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="rows must match"):
        kcomp.cast_rows([x, torch.zeros(9)], torch.bfloat16)
    with pytest.raises(ValueError, match="seeds"):
        kcomp.stochastic_cast_rows([x, x], torch.bfloat16, [1], 16, 0.0)
    with pytest.raises(ValueError, match="drop"):
        kcomp.stochastic_cast_rows([x], torch.bfloat16, [1], 30, 0.0)
    with pytest.raises(ValueError, match="int8 values"):
        kcomp.dequantize_rows(torch.zeros((1, 8)), torch.ones((1, 1)), 8, 8)


def test_cpu_tensors_launch_nothing():
    """On the CPU every compression wrapper runs its plain version and
    counts no launch; the four kernels sit in the tier's table."""
    from accl_tpu_torch.ops import cuda as kc

    names = ("cast", "stochastic_cast", "quantize_int8", "dequantize_int8")
    assert all(n in kc.KERNELS for n in names)
    for n in names:
        kc.KERNELS[n].launches.reset()
    x = torch.randn(600)
    kcomp.cast_rows([x], torch.float8_e5m2)
    kcomp.stochastic_cast_rows([x, x], torch.bfloat16, [1, 2], 16, 0.0)
    v, s = kcomp.quantize_rows([x], [0], 256)
    kcomp.dequantize_rows(v, s, 600, 256)
    assert {n: kc.KERNELS[n].launches.count for n in names} == dict.fromkeys(
        names, 0)
