"""The PyTorch port's kernel tier against the JAX package's Pallas kernels.

``accl_tpu_torch.ops.cuda`` holds hand-written CUDA kernels; on a CPU
tensor each wrapper runs its plain PyTorch version, which walks the same
hop schedule with the same fold order and wire rounding points.  Here the
same inputs, made from a numpy seed and carried into both packages
through ``accl_tpu_torch.interop``, go through the Pallas kernel (run by
the Pallas TPU interpreter on the virtual CPU mesh, as
``tests/test_pallas.py`` runs it) and through the port's wrapper: float
results must agree EXACTLY.  Sizes stay at P <= 4 and <= 4096 elements,
since the interpreter's ring busy-spins on its semaphores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from accl_tpu.compat import has_interpret_params, interpret_params_reason
from accl_tpu.constants import ReduceFunction as JaxReduceFunction
from accl_tpu.ops import pallas as pk
from accl_tpu.ops.pallas._common import pack_lanes, sublanes_for
from accl_tpu_torch import interop
from accl_tpu_torch.constants import ReduceFunction
from accl_tpu_torch.ops import cuda as kc
from accl_tpu_torch.ops.cuda._common import ring_len

SUM, MAX = ReduceFunction.SUM, ReduceFunction.MAX

interpreted = pytest.mark.skipif(
    jax.default_backend() != "tpu" and not has_interpret_params(),
    reason=f"Pallas interpret tier unavailable: {interpret_params_reason()}",
)


def _jax_ring(body, data):
    """Run ``body(x)`` (one rank's shard) under shard_map over
    ``len(data)`` devices; returns the stacked per-rank results."""
    devs = jax.devices()[: len(data)]
    if len(devs) < len(data):
        pytest.skip(f"needs {len(data)} devices")
    mesh = Mesh(np.array(devs), ("x",))
    fn = jax.jit(shard_map(
        lambda x: body(x[0])[None], mesh=mesh, in_specs=PS("x"),
        out_specs=PS("x"), check_vma=False,
    ))
    return np.asarray(fn(jnp.asarray(data)))


def _torch_dtype(name):
    return None if name is None else getattr(torch, name)


# ---------------------------------------------------------------------------
# the padding rule that fixes the ring's blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 127, 128, 1000, 4096, 100_003])
@pytest.mark.parametrize("parts,segments", [(1, 1), (2, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize(
    "dtype,wire",
    [("float32", None), ("float32", "bfloat16"), ("bfloat16", None),
     ("int32", None)],
)
def test_ring_len_matches_pack_ring(n, parts, segments, dtype, wire):
    """The port's padded ring length equals the row count the JAX
    ``_pack_ring`` packs to, so every block boundary falls on the same
    element in both packages."""
    sub = sublanes_for(jnp.dtype(dtype))
    if wire is not None:
        sub = max(sub, sublanes_for(jnp.dtype(wire)))
    packed, _ = pack_lanes(jnp.zeros(n, dtype), min_rows=parts * segments * sub)
    assert ring_len(n, parts, segments, _torch_dtype(dtype),
                    _torch_dtype(wire)) == packed.size


# ---------------------------------------------------------------------------
# K1: ring allreduce
# ---------------------------------------------------------------------------


@interpreted
@pytest.mark.parametrize(
    "P,S,bidir,wire,function,n",
    [
        (2, 1, False, None, SUM, 1000),
        (2, 2, True, None, MAX, 4096),
        (4, 1, False, None, SUM, 3000),
        (4, 2, False, None, MAX, 3000),
        (4, 1, True, None, SUM, 2500),
        (4, 2, False, "bfloat16", SUM, 3000),
        (2, 2, True, "bfloat16", MAX, 4096),
    ],
)
def test_ring_allreduce_equals_pallas(P, S, bidir, wire, function, n):
    data = np.random.default_rng(P * 100 + n).standard_normal(
        (P, n)).astype(np.float32)
    want = _jax_ring(
        lambda x: pk.ring_allreduce(
            x, "x", JaxReduceFunction(int(function)), S,
            bidirectional=bidir, wire_dtype=wire,
        ),
        data,
    )
    got = kc.ring_allreduce(
        interop.stacked_from_numpy(data, "cpu"), function, S,
        bidirectional=bidir, wire_dtype=_torch_dtype(wire),
    )
    for r in range(P):
        np.testing.assert_array_equal(interop.to_numpy(got[r]), want[r])
    if wire is not None:
        # the owner keeps its block at full precision, every other rank
        # receives it wire-rounded: compressed results differ per rank
        assert not np.array_equal(want[0], want[1])


def test_ring_allreduce_in_place_and_shape():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((3, 6, 50)).astype(np.float32)
    xs = [torch.from_numpy(d.copy()) for d in data]
    want = kc.ring_allreduce_plain(xs, SUM, 2)
    got = kc.ring_allreduce(xs, SUM, 2, out=xs)
    for r in range(3):
        assert got[r].shape == (6, 50)
        assert got[r].data_ptr() == xs[r].data_ptr()
        assert torch.equal(xs[r], want[r])
    # two float32 additions of unit normals: a few ulp of the partial sums
    np.testing.assert_allclose(want[0].numpy(), data.sum(0), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32])
def test_ring_allreduce_plain_dtypes(dtype):
    """bfloat16 folds round after every hop; int32 SUM wraps."""
    rng = np.random.default_rng(6)
    data = rng.integers(0 if dtype == torch.bfloat16 else -2**30, 2**30,
                        size=(4, 700))
    xs = [torch.from_numpy(d).to(dtype) for d in data]
    got = kc.ring_allreduce(xs, SUM, 1)
    if dtype == torch.int32:
        want = data.sum(0).astype(np.int32)  # wraps like the kernel
        for g in got:
            np.testing.assert_array_equal(g.numpy(), want)
    else:
        # positive terms: each of the 4 roundings costs at most 2**-8
        for g in got:
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(
                g.float().numpy(), data.astype(np.float64).sum(0), rtol=2e-2
            )


def test_ring_allreduce_rejects():
    xs = [torch.zeros(10), torch.zeros(10)]
    with pytest.raises(ValueError, match="wire"):
        kc.ring_allreduce([torch.zeros(8, dtype=torch.int32)] * 2,
                          wire_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wire"):
        kc.ring_allreduce(xs, wire_dtype=torch.float64)
    with pytest.raises(ValueError, match="match"):
        kc.ring_allreduce([torch.zeros(10), torch.zeros(11)])
    with pytest.raises(ValueError, match="num_segments"):
        kc.ring_allreduce(xs, num_segments=0)
    with pytest.raises(ValueError, match="reduce function"):
        kc.ring_allreduce(xs, function=7)


# ---------------------------------------------------------------------------
# K2 / K3: ring reduce-scatter and allgather
# ---------------------------------------------------------------------------


@interpreted
@pytest.mark.parametrize("P,S,function,n", [(4, 1, SUM, 3000),
                                            (2, 2, MAX, 1000)])
def test_ring_reduce_scatter_equals_pallas(P, S, function, n):
    data = np.random.default_rng(n).standard_normal((P, n)).astype(np.float32)
    want = _jax_ring(
        lambda x: pk.ring_reduce_scatter(
            x, "x", JaxReduceFunction(int(function)), S
        ).reshape(-1),
        data,
    )
    got = kc.ring_reduce_scatter(interop.stacked_from_numpy(data, "cpu"),
                                 function, S)
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


@interpreted
def test_ring_allgather_equals_pallas():
    data = np.random.default_rng(9).standard_normal((4, 1000)).astype(
        np.float32)
    want = _jax_ring(lambda x: pk.ring_allgather(x, "x", num_segments=2), data)
    got = kc.ring_allgather(interop.stacked_from_numpy(data, "cpu"))
    for r in range(4):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


def test_ring_allgather_keeps_trailing_dims():
    xs = [torch.full((2, 3), float(r)) for r in range(3)]
    got = kc.ring_allgather(xs)
    assert got[1].shape == (6, 3)
    assert torch.equal(got[2], torch.cat(xs))


# ---------------------------------------------------------------------------
# K4: combine
# ---------------------------------------------------------------------------


def _combine_inputs(dtype, n=777, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        a, b = (rng.integers(-2**31, 2**31, size=n) for _ in range(2))
    else:
        a, b = (rng.standard_normal(n) * 100 for _ in range(2))
        a[::97] = np.nan
        b[3::89] = np.nan
    return a.astype(dtype), b.astype(dtype)


@interpreted
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("function", [SUM, MAX])
@pytest.mark.parametrize("accumulate", [False, True])
def test_combine_equals_pallas(dtype, function, accumulate):
    np_dtype = jnp.dtype(dtype)
    a, b = _combine_inputs(np_dtype)
    want = np.asarray(pk.combine(
        jnp.asarray(a), jnp.asarray(b), JaxReduceFunction(int(function)),
        accumulate=accumulate,
    ))
    ta, tb = interop.stacked_from_numpy([a, b], "cpu")
    got = kc.combine(ta, tb, function, accumulate=accumulate)
    if accumulate:
        assert got is ta
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  want.astype(np.float32)
                                  if dtype == "bfloat16" else want)


@interpreted
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float16"])
def test_combine_out_dtype_equals_pallas(out_dtype):
    a, b = _combine_inputs(np.float32, seed=1)
    want = np.asarray(pk.combine(jnp.asarray(a), jnp.asarray(b),
                                 out_dtype=jnp.dtype(out_dtype)))
    ta, tb = interop.stacked_from_numpy([a, b], "cpu")
    got = kc.combine(ta, tb, SUM, getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  want.astype(np.float32))


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
@pytest.mark.parametrize("function", [SUM, MAX])
def test_combine_wide_dtypes_against_numpy(dtype, function):
    """JAX runs with 64-bit types off, so f64 / i64 hold to numpy."""
    a, b = _combine_inputs(dtype, seed=2)
    want = np.add(a, b) if function == SUM else np.maximum(a, b)
    ta, tb = interop.stacked_from_numpy([a, b], "cpu")
    np.testing.assert_array_equal(kc.combine(ta, tb, function).numpy(), want)


def test_combine_out_and_rejects():
    a, b = torch.arange(6.0), torch.ones(6)
    out = torch.empty(6, dtype=torch.float64)
    assert kc.combine(a, b, SUM, torch.float64, out=out) is out
    assert torch.equal(out, (a + 1).double())
    with pytest.raises(ValueError, match="match"):
        kc.combine(a, torch.ones(5))
    with pytest.raises(ValueError, match="accumulate"):
        kc.combine(a, b, SUM, torch.bfloat16, accumulate=True)
    with pytest.raises(ValueError, match="out"):
        kc.combine(a, b, SUM, out=torch.empty(6, dtype=torch.float64))


def test_kernel_table_counts_only_launches():
    """On the CPU the wrappers run their plain versions: no launch is
    counted."""
    for k in kc.KERNELS.values():
        k.launches.reset()
    kc.combine(torch.ones(4), torch.ones(4))
    kc.ring_allreduce([torch.ones(300)] * 2)
    assert {k: f.launches.count for k, f in kc.KERNELS.items()} == {
        k: 0 for k in kc.KERNELS
    }
