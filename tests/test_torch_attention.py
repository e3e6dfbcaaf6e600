"""The port's attention lowerings against the JAX package's.

``accl_tpu_torch.ops.cuda.attention.flash_attention`` holds the
hand-written flash-attention forward (row 16); on a CPU tensor it runs
``flash_attention_plain``, the TPU kernel's fold in plain PyTorch.  Here
the same numpy-seeded operands go through the JAX package's Pallas
``flash_attention`` (interpreted on the CPU, as ``tests/test_pallas.py``
runs it) and through the port: float32 results agree within 2e-5, the
JAX tests' own tolerance; the logsumexp residual within 2e-5 of
``_flash_fwd_impl(..., with_lse=True)``.  ``blockwise_attention`` is
held against the JAX XLA fold the same way.  The kernel itself runs only
on the card (``chip_smoke.py`` phase 2 holds it against the plain
version there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.ops import pallas as pk
from accl_tpu.ops.attention import blockwise_attention as jax_blockwise
from accl_tpu.ops.pallas.attention import _flash_fwd_impl
from accl_tpu_torch import interop
from accl_tpu_torch.ops.attention import blockwise_attention
from accl_tpu_torch.ops.cuda import KERNELS
from accl_tpu_torch.ops.cuda.attention import (
    flash_attention,
    flash_attention_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def interpreted():
    """The Pallas flash kernel off the TPU needs the TPU interpret mode."""
    import jax.experimental.pallas.tpu as pltpu

    if jax.default_backend() != "tpu" and not hasattr(
        pltpu, "InterpretParams"
    ):
        pytest.skip("flash kernel needs Mosaic or pallas TPU interpret mode")


def _operands(seed, B, H, Hkv, T, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(dtype)
    k = rng.standard_normal((B, Hkv, T, D)).astype(dtype)
    v = rng.standard_normal((B, Hkv, T, D)).astype(dtype)
    return q, k, v


def _both(arrays, dtype=None):
    """(jax arrays, torch CPU tensors) of the same numpy operands."""
    jx = tuple(jnp.asarray(a, dtype) for a in arrays)
    tx = tuple(torch.from_numpy(np.array(a)) for a in arrays)
    if dtype is not None:
        tx = tuple(t.to(getattr(torch, jnp.dtype(dtype).name)) for t in tx)
    return jx, tx


FLASH_CASES = [
    # (B, H, Hkv, T, D, causal)
    (2, 2, 2, 96, 32, True),
    (2, 2, 2, 96, 32, False),
    (1, 3, 3, 50, 24, True),   # ragged T, D below the lane width
    (1, 2, 2, 50, 16, False),
    (2, 4, 2, 64, 32, True),   # GQA
    (1, 4, 1, 40, 8, False),   # MQA
]


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", FLASH_CASES)
def test_flash_attention_equals_jax(interpreted, B, H, Hkv, T, D, causal):
    (jq, jk, jv), (q, k, v) = _both(_operands(1, B, H, Hkv, T, D))
    want = np.asarray(pk.flash_attention(jq, jk, jv, causal=causal))
    before = KERNELS["flash_attention"].launches.count
    got = flash_attention(q, k, v, causal)
    assert KERNELS["flash_attention"].launches.count == before  # CPU: plain
    assert got.shape == (B, H, T, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, causal),
                               rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv,T,D", [(2, 2, 2, 50, 24), (2, 4, 2, 64, 32)])
def test_flash_lse_equals_jax(interpreted, B, H, Hkv, T, D, causal):
    (jq, jk, jv), (q, k, v) = _both(_operands(2, B, H, Hkv, T, D))
    jo, jlse = _flash_fwd_impl(jq, jk, jv, causal, 512, None, with_lse=True)
    out, lse = flash_attention(q, k, v, causal, with_lse=True)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


def test_flash_bfloat16_equals_jax(interpreted):
    """bfloat16 operands: the scores and the fold in float32 on both
    sides, the probabilities rounded to bfloat16 before P @ V, the output
    rounded to bfloat16 (a few bf16 ulps apart at most)."""
    (jq, jk, jv), (q, k, v) = _both(_operands(3, 2, 4, 2, 48, 32),
                                    jnp.bfloat16)
    want = np.asarray(pk.flash_attention(jq, jk, jv)).astype(np.float32)
    got = flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(interop.to_numpy(got), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,H,Hkv,T,D,blocks",
    [(2, 2, 2, 96, 32, (256, 256)), (1, 3, 3, 50, 24, (16, 16)),
     (2, 4, 2, 40, 16, (16, 8))],
)
def test_blockwise_equals_jax(B, H, Hkv, T, D, blocks, causal):
    (jq, jk, jv), (q, k, v) = _both(_operands(4, B, H, Hkv, T, D))
    bq, bk = blocks
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_blockwise(jq, jk, jv, causal=causal,
                                        block_q=bq, block_k=bk))
    got = blockwise_attention(q, k, v, causal=causal, block_q=bq,
                              block_k=bk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_validates():
    z = torch.zeros
    with pytest.raises(ValueError, match="k/v shapes must match"):
        flash_attention(z(1, 1, 8, 8), z(1, 1, 8, 8), z(1, 1, 16, 8))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(z(1, 4, 16, 8), z(1, 3, 16, 8), z(1, 3, 16, 8))
    with pytest.raises(ValueError, match="must match outside the head dim"):
        flash_attention(z(1, 2, 16, 8), z(1, 2, 8, 8), z(1, 2, 8, 8))
    with pytest.raises(ValueError, match="dtypes must match"):
        flash_attention(z(1, 2, 8, 8), z(1, 2, 8, 8, dtype=torch.bfloat16),
                        z(1, 2, 8, 8))
    with pytest.raises(ValueError, match=r"\(B, H, T, D\)"):
        flash_attention(z(2, 8, 8), z(2, 8, 8), z(2, 8, 8))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        blockwise_attention(z(1, 4, 8, 8), z(1, 3, 8, 8), z(1, 3, 8, 8))


def test_flash_plain_is_differentiable_on_the_cpu():
    """The CPU form is plain autograd-able PyTorch; only the card's call
    refuses a gradient until the backward kernels land."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _operands(5, 1, 2, 2, 20, 8))
    flash_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


@pytest.mark.gpu
def test_flash_on_the_card_refuses_a_gradient():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
               for a in _operands(6, 1, 2, 2, 32, 16))
    before = KERNELS["flash_attention"].launches.count
    with pytest.raises(RuntimeError, match="no backward kernels"):
        flash_attention(q, k, v)
    assert KERNELS["flash_attention"].launches.count == before
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert KERNELS["flash_attention"].launches.count == before + 1
    torch.testing.assert_close(out, flash_attention_plain(q, k, v).detach(),
                               rtol=2e-5, atol=2e-5)
