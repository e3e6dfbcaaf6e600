"""Row 12, the all-to-all block transpose, against the JAX package's.

``accl_tpu_torch.ops.cuda.alltoall`` takes P per-rank operands and
returns P results, rank r's block p being rank p's block r.  On CPU
tensors it runs its plain version.  Here the same numpy operands go
through the JAX package's Pallas ``alltoall`` (interpreted under
``shard_map`` on the virtual CPU mesh, as ``tests/test_pallas.py`` runs
it) and through the port, and must agree bit for bit: the kernel is a
copy.  The kernel itself runs only on the card (``chip_smoke.py`` phase
2 holds it against the plain version bit for bit; the ``gpu``-marked
test below does too).
"""

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

from accl_tpu.compat import has_interpret_params, interpret_params_reason
from accl_tpu.ops import pallas as pk

from accl_tpu_torch import interop
from accl_tpu_torch.ops import cuda as kc
from accl_tpu_torch.ops.cuda.alltoall import alltoall, alltoall_plain

interpreted = pytest.mark.skipif(
    jax.default_backend() != "tpu" and not has_interpret_params(),
    reason=f"Pallas interpret tier unavailable: {interpret_params_reason()}",
)

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
          "int32": np.int32}


def _jax_alltoall(data):
    """JAX's Pallas ``alltoall`` over ``data``'s leading dim as the mesh
    axis: rank r's operand is ``data[r]``."""
    P = data.shape[0]
    mesh = Mesh(np.array(jax.devices()[:P]), ("x",))
    fn = jax.jit(shard_map(
        lambda x: pk.alltoall_kernel(x[0], "x")[None],
        mesh=mesh, in_specs=PS("x"), out_specs=PS("x"), check_vma=False,
    ))
    return np.asarray(fn(jnp.asarray(data)))


def _port_operands(data):
    """rank r's operand ``data[r]``, carried across by ``interop``."""
    P = data.shape[0]
    return interop.shards_from_numpy(
        data.reshape((P * data.shape[1],) + data.shape[2:]), P, axis=0,
        device="cpu")


def _operands(P, rest, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (P, P * 5) + rest
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    return rng.standard_normal(shape).astype(DTYPES[dtype])


@interpreted
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rest", [(3,), (8, 16)],
                         ids=["block15", "block640"])
def test_alltoall_plain_equals_jax_pallas(P, dtype, rest):
    """Blocks of 5 x 3 = 15 elements (no lane multiple: the TPU wrapper
    pads them to (rows, 128) tiles) and of 5 x 128."""
    data = _operands(P, rest, dtype, seed=P * 7 + len(rest))
    want = _jax_alltoall(data)
    xs = _port_operands(data)
    got = alltoall(xs)
    assert len(got) == P
    for r in range(P):
        assert got[r].dtype == xs[r].dtype and got[r].shape == xs[r].shape
        np.testing.assert_array_equal(interop.to_numpy(got[r]),
                                      want[r].astype(np.float32)
                                      if dtype == "bfloat16" else want[r])


def test_alltoall_moves_blocks():
    """Rank r's block p is rank p's block r (the docstring's rule), on
    int8 and the fp8 pair as on the wider dtypes."""
    P = 3
    for dtype in (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2,
                  torch.float16, torch.int64):
        xs = [(torch.arange(P * 4) + 16 * r).reshape(P * 2, 2).to(dtype)
              for r in range(P)]
        got = alltoall(xs)
        for r in range(P):
            for p in range(P):
                assert torch.equal(got[r][2 * p:2 * p + 2].view(torch.uint8),
                                   xs[p][2 * r:2 * r + 2].view(torch.uint8))


def test_alltoall_validates():
    with pytest.raises(ValueError, match="divisible"):
        alltoall([torch.zeros(7, 3), torch.zeros(7, 3)])
    with pytest.raises(ValueError, match="divisible"):
        alltoall_plain([torch.zeros(7, 3), torch.zeros(7, 3)])
    with pytest.raises(ValueError, match="shape and dtype"):
        alltoall([torch.zeros(4, 3), torch.zeros(4, 2)])
    with pytest.raises(ValueError, match="shape and dtype"):
        alltoall([torch.zeros(4), torch.zeros(4, dtype=torch.int32)])


@interpreted
def test_alltoall_divisible_error_matches_jax():
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    fn = jax.jit(shard_map(lambda x: pk.alltoall_kernel(x, "x"), mesh=mesh,
                           in_specs=PS(), out_specs=PS(), check_vma=False))
    with pytest.raises(ValueError, match="divisible") as jerr:
        fn(jnp.zeros((7, 3)))
    with pytest.raises(ValueError, match="divisible") as terr:
        alltoall([torch.zeros(7, 3)] * 2)
    assert str(terr.value) == str(jerr.value)


def test_alltoall_single_rank_returns_its_input():
    x = torch.arange(12.0).reshape(4, 3)
    before = alltoall.launches.count
    (out,) = alltoall([x])
    assert out is x
    (out,) = alltoall_plain([x])
    assert out is x
    assert alltoall.launches.count == before


def test_alltoall_cpu_tensors_take_the_plain_version():
    xs = [torch.randn(8, 5) for _ in range(4)]
    before = kc.KERNELS["alltoall"].launches.count
    got = alltoall(xs)
    assert kc.KERNELS["alltoall"].launches.count == before
    for g, w in zip(got, alltoall_plain(xs)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_alltoall_kernel_on_the_card():
    """On CUDA tensors one launch, bit for bit the plain version, aligned
    (16-byte path) and not (element path), every width of element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for P, shape, dtype in ((4, (4 * 1024, 64), torch.bfloat16),
                            (3, (3 * 7, 5), torch.float32),
                            (8, (8 * 3, 33), torch.int8),
                            (2, (2 * 100,), torch.float8_e4m3fn),
                            (4, (4 * 9, 3), torch.int64)):
        xs = [torch.randint(-100, 100, shape, device=dev).to(dtype)
              for _ in range(P)]
        before = alltoall.launches.count
        got = alltoall(xs)
        torch.cuda.synchronize()
        assert alltoall.launches.count - before == 1
        for g, w in zip(got, alltoall_plain(xs)):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
