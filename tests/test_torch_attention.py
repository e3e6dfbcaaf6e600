"""The port's attention lowerings against the JAX package's.

``accl_tpu_torch.ops.cuda.attention.flash_attention`` holds the
hand-written flash-attention forward (row 16) and, behind its
``torch.autograd.Function``, the delta pass and the dQ and dK/dV
backward kernels (rows 17-18); on CPU tensors it runs their plain
versions, the TPU kernels' folds in plain PyTorch.  Here the same
numpy-seeded operands go through the JAX package's Pallas
``flash_attention`` (interpreted on the CPU, as
``tests/test_pallas.py`` runs it, default ``block=512``) and through the
port: float32 results agree within 2e-5, the JAX tests' own tolerance;
the logsumexp residual within 2e-5 of ``_flash_fwd_impl(...,
with_lse=True)``; float32 gradients within rtol 2e-4, atol 2e-5, the
JAX gradient tests' own.  ``blockwise_attention`` is held against the
JAX XLA fold the same way.  The kernels themselves run only on the card
(``chip_smoke.py`` phase 2 holds them against the plain versions there;
the ``gpu``-marked tests below do too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.ops import pallas as pk
from accl_tpu.ops.attention import blockwise_attention as jax_blockwise
from accl_tpu.ops.pallas.attention import _flash_bwd_impl, _flash_fwd_impl
from accl_tpu_torch import interop
from accl_tpu_torch.ops.attention import blockwise_attention
from accl_tpu_torch.ops.cuda import KERNELS
from accl_tpu_torch.ops.cuda import attention as ka
from accl_tpu_torch.ops.cuda.attention import (
    flash_attention,
    flash_attention_bwd_delta,
    flash_attention_bwd_delta_plain,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BWD_KERNELS = ("flash_attention", "flash_attention_bwd_delta",
               "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
#: rows 17-18, whose 16-bit launches take the wgmma kernels
WGMMA_BWD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


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
    """On CPU tensors the autograd Function runs the plain forward and the
    plain dQ and dK/dV backward, launching no kernel."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _operands(5, 1, 2, 2, 20, 8))
    before = {n: KERNELS[n].launches.count for n in BWD_KERNELS}
    flash_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))
    assert before == {n: KERNELS[n].launches.count for n in BWD_KERNELS}


def _jax_grads(jq, jk, jv, jw, causal):
    """jax.grad of sum(flash(q, k, v) * w) through the interpreted Pallas
    kernels (forward with LSE, then the dQ and dK/dV kernels)."""
    return jax.grad(
        lambda q, k, v: (pk.flash_attention(q, k, v, causal=causal)
                         * jw).sum(),
        argnums=(0, 1, 2),
    )(jq, jk, jv)


def _torch_grads(q, k, v, w, causal):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    (flash_attention(q, k, v, causal) * w).sum().backward()
    return q.grad, k.grad, v.grad


FLASH_GRAD_CASES = [
    # (B, H, Hkv, T, D, causal): tests/test_pallas.py's gradient cases
    # (:742, :776, :941) and an MQA one
    (2, 2, 2, 96, 32, True),
    (2, 2, 2, 96, 32, False),
    (1, 2, 2, 50, 24, True),   # ragged T, D below the lane width
    (2, 4, 2, 64, 32, True),   # GQA
    (1, 4, 1, 40, 8, False),   # MQA
]


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", FLASH_GRAD_CASES)
def test_flash_grads_equal_jax(interpreted, B, H, Hkv, T, D, causal):
    ops = _operands(6, B, H, Hkv, T, D)
    w = np.random.default_rng(7).standard_normal((B, H, T, D)).astype(
        np.float32)
    (jq, jk, jv, jw), (q, k, v, tw) = _both(ops + (w,))
    want = _jax_grads(jq, jk, jv, jw, causal)
    got = _torch_grads(q, k, v, tw, causal)
    for g, x, name in zip(got, want, "qkv"):
        assert g.shape == (q, k, v)["qkv".index(name)].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_flash_grads_bfloat16_near_jax(interpreted):
    """bfloat16 operands: both sides round p to bfloat16 before p^T dO,
    ds before ds K and ds^T Q, and each gradient at the end, but their
    float32 sums run in other orders, so a rounding may land one bf16 ulp
    (2^-8 relative) apart.  Held within rtol 1e-2 (two ulps) and atol
    1e-3; on this case dK and dV come out equal bit for bit and dQ within
    2e-7 of JAX's."""
    ops = _operands(8, 2, 4, 2, 48, 32)
    w = np.random.default_rng(9).standard_normal((2, 4, 48, 32)).astype(
        np.float32)
    (jq, jk, jv, jw), (q, k, v, tw) = _both(ops + (w,), jnp.bfloat16)
    want = _jax_grads(jq, jk, jv, jw, True)
    got = _torch_grads(q, k, v, tw, True)
    for g, x, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(interop.to_numpy(g),
                                   np.asarray(x).astype(np.float32),
                                   rtol=1e-2, atol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("B,H,Hkv,T,D,causal", [(1, 4, 2, 50, 24, True),
                                                (2, 2, 2, 40, 16, False)])
def test_flash_bwd_plain_equals_jax(interpreted, B, H, Hkv, T, D, causal):
    """The plain dQ and dK/dV functions against ``_flash_bwd_impl`` given
    the same o, lse and output gradient."""
    q, k, v = _operands(10, B, H, Hkv, T, D)
    g = np.random.default_rng(11).standard_normal((B, H, T, D)).astype(
        np.float32)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((q, k, v, g))
    jo, jlse = _flash_fwd_impl(jq, jk, jv, causal, 512, None, with_lse=True)
    want = _flash_bwd_impl(jq, jk, jv, jo, jlse, jg, causal, 512, None)
    o = torch.from_numpy(np.array(jo))
    lse = torch.from_numpy(np.array(jlse))
    delta = (tg * o).sum(-1)
    dq = flash_attention_bwd_dq_plain(tq, tk, tv, tg, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv_plain(tq, tk, tv, tg, lse, delta,
                                           causal)
    for got, x, name in zip((dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(x), **GRAD_TOL,
                                   err_msg=f"d{name}")
    # the wrappers take the plain versions on CPU tensors
    torch.testing.assert_close(
        flash_attention_bwd_dq(tq, tk, tv, tg, lse, delta, causal), dq,
        rtol=0, atol=0)
    for a, b in zip(flash_attention_bwd_dkv(tq, tk, tv, tg, lse, delta,
                                            causal), (dk, dv)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_bwd_validates():
    z = torch.zeros
    q = z(1, 2, 8, 4)
    stats = z(1, 2, 8)
    with pytest.raises(ValueError, match="dO must match q"):
        flash_attention_bwd_dq(q, q, q, z(1, 2, 8, 5), stats, stats)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd_dkv(q, q, q, q, stats.double(), stats)
    with pytest.raises(ValueError, match="delta must be float32"):
        flash_attention_bwd_dq(q, q, q, q, stats, z(1, 2, 7))
    with pytest.raises(ValueError, match="dO and O must match"):
        flash_attention_bwd_delta(q, z(1, 2, 8, 5))
    with pytest.raises(ValueError, match="dO and O must match"):
        flash_attention_bwd_delta(q, q.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,H,T,D", [(2, 4, 50, 24), (1, 2, 64, 128)])
def test_flash_bwd_delta_plain_equals_jax(dtype, B, H, T, D):
    """The delta pass, rowsum(dO * O) in float32, against JAX's form in
    ``_flash_bwd_impl`` (:572), ``(g.astype(f32) * o.astype(f32)).sum(-1)``,
    on the same numpy-seeded operands.  The two sum in other orders, so
    each row within 1e-6 of its sum of magnitudes (a float32 reordering
    moves a sum by a few ulps of its largest partial, not of a result
    that cancels).  The wrapper takes the plain version on CPU tensors
    and launches nothing."""
    rng = np.random.default_rng(13)
    g, o = (rng.standard_normal((B, H, T, D)).astype(np.float32)
            for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    (jg, jo), (tg, to) = _both((g, o), jdt)
    want = np.asarray((jg.astype(jnp.float32) * jo.astype(jnp.float32))
                      .sum(-1))
    got = flash_attention_bwd_delta_plain(tg, to)
    assert got.shape == (B, H, T) and got.dtype == torch.float32
    mag = np.asarray((jnp.abs(jg.astype(jnp.float32)
                              * jo.astype(jnp.float32))).sum(-1))
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * mag)
    before = KERNELS["flash_attention_bwd_delta"].launches.count
    torch.testing.assert_close(flash_attention_bwd_delta(tg, to), got,
                               rtol=0, atol=0)
    assert KERNELS["flash_attention_bwd_delta"].launches.count == before


@pytest.mark.gpu
def test_flash_gradient_on_the_card_runs_the_kernels():
    """On CUDA tensors that need a gradient the forward kernel runs with
    its LSE and the backward launches the delta, dQ and dK/dV kernels
    once each; the gradients equal the plain backward's on the same
    residuals (float32: FFMA kernels, no TF32; rows 16-18 fold in other
    orders than the plain versions, so within 2e-4 relative).  A bfloat16
    gradient takes rows 17-18's wgmma kernels.  bfloat16 forwards at the
    main paths' shapes and on the transformer's head views take the wgmma
    kernel, with no copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for causal, (B, H, Hkv, T, D) in ((True, (1, 4, 2, 72, 32)),
                                      (False, (2, 2, 2, 64, 16))):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in _operands(12, B, H, Hkv, T, D))
        w = torch.randn(B, H, T, D, device=dev)
        before = {n: KERNELS[n].launches.count for n in BWD_KERNELS}
        out = flash_attention(q, k, v, causal)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        assert {n: KERNELS[n].launches.count - before[n]
                for n in BWD_KERNELS} == dict.fromkeys(BWD_KERNELS, 1)
        with torch.no_grad():
            o, lse = flash_attention_plain(q, k, v, causal, with_lse=True)
            delta = (w * o).sum(-1)
            want = (flash_attention_bwd_dq_plain(q, k, v, w, lse, delta,
                                                 causal),
                    *flash_attention_bwd_dkv_plain(q, k, v, w, lse, delta,
                                                   causal))
        for t, x in zip((q, k, v), want):
            torch.testing.assert_close(t.grad, x, rtol=2e-4, atol=2e-5)
    q, k, v = (torch.randn(2, 4, 256, 128, device=dev).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    before = {n: KERNELS[n].launches.count for n in BWD_KERNELS}
    wgmma = {n: KERNELS[n].wgmma_launches.count for n in WGMMA_BWD}
    flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert {n: KERNELS[n].launches.count - before[n]
            for n in BWD_KERNELS} == dict.fromkeys(BWD_KERNELS, 1)
    assert {n: KERNELS[n].wgmma_launches.count - wgmma[n]
            for n in WGMMA_BWD} == dict.fromkeys(WGMMA_BWD, 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    # bfloat16 forwards go through the wgmma kernel (rows 16's 16-bit
    # route), at the main paths' shapes and on the transformer's head
    # views, which it reads in place: within 1e-2 (the output) and 1e-4
    # (the LSE) of the plain version
    kern = KERNELS["flash_attention"]
    x = torch.randn(2, 1024, 3 * 16 * 128, device=dev).to(torch.bfloat16)
    heads = [t.reshape(2, 1024, 16, 128).transpose(1, 2)
             for t in x.split(16 * 128, dim=2)]
    shapes = [(8, 16, 128), (8, 16, 1024), (8, 32, 1024)]
    cases = [heads] + [[torch.randn(B, H, T, 128, device=dev).to(
        torch.bfloat16) for _ in range(3)] for B, H, T in shapes]
    for q, k, v in cases:
        before = (kern.launches.count, kern.wgmma_launches.count,
                  ka.tma_copies.count)
        out, lse = flash_attention(q, k, v, True, with_lse=True)
        torch.cuda.synchronize()
        assert (kern.launches.count, kern.wgmma_launches.count,
                ka.tma_copies.count) == (before[0] + 1, before[1] + 1,
                                         before[2])
        want, want_lse = flash_attention_plain(q, k, v, True, with_lse=True)
        torch.testing.assert_close(out.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the 16-bit kernels' tensor maps (rows 15 and 16 read their operands
# through TMA): geometry, the copy rule and the grid caps, all host-side
# ---------------------------------------------------------------------------


def _heads(B, T, n, hd, dtype=torch.bfloat16):
    """The transformer's head tensors: a (B, T, n * hd) projection viewed
    as (B, n, T, hd) (``models/transformer.py`` ``heads``), no copy."""
    return torch.zeros(B, T, n * hd, dtype=dtype).reshape(
        B, T, n, hd).transpose(1, 2)


TMA_GEOMETRY = [
    # (name, tensor, dims (D, T, H, B), byte strides of T, H, B)
    ("contiguous", torch.zeros(2, 4, 1024, 128, dtype=torch.bfloat16),
     (128, 1024, 4, 2), (256, 1024 * 256, 4 * 1024 * 256)),
    ("transposed view", _heads(2, 1024, 16, 128),
     (128, 1024, 16, 2), (16 * 256, 256, 1024 * 16 * 256)),
    ("gqa k", _heads(2, 1024, 4, 128),  # Hkv = 4 under H = 16
     (128, 1024, 4, 2), (4 * 256, 256, 1024 * 4 * 256)),
    ("T 200", torch.zeros(1, 2, 200, 64, dtype=torch.float16),
     (64, 200, 2, 1), (128, 200 * 128, 2 * 200 * 128)),
    ("T 50", torch.zeros(1, 2, 50, 24, dtype=torch.float16),
     (24, 50, 2, 1), (48, 50 * 48, 2 * 50 * 48)),
    ("one row, one head", torch.zeros(3, 1, 1, 24, dtype=torch.bfloat16),
     (24, 1, 1, 3), (48, 48, 48)),
]


@pytest.mark.parametrize("name,t,dims,strides", TMA_GEOMETRY,
                         ids=[c[0] for c in TMA_GEOMETRY])
def test_tma_geometry(name, t, dims, strides):
    """Each map is 4-D (D, T, H, B) with the operand's own byte strides
    (a transposed view needs no copy), T a real boundary, and the box 64
    columns (one 128-byte swizzle row) by 128 rows: a tile of T 200 is
    one whole box and a ragged one, T 50 one box of 78 zero-filled rows,
    D 24 one box of 40 zero-filled columns, D 128 two boxes a row."""
    got_dims, got_strides, box = ka._tma_geometry(t, ka.TILE_ROWS,
                                                  ka.BOX_COLS)
    assert got_dims == dims and got_strides == strides
    assert box == (64, 128, 1, 1)
    assert ka._tma_ready(t)
    assert list(ka._tma_table([t])) == [*dims, *strides, 64, 128]
    D, T = dims[0], dims[1]
    assert -(-D // box[0]) == (2 if D == 128 else 1)  # boxes a tile row
    assert -(-T // box[1]) * box[1] - T == {1024: 0, 200: 56, 50: 78,
                                            1: 127}[T]  # zero-filled rows


def test_tma_operand_copies_only_what_tma_cannot_read():
    """An operand TMA can read is passed as it is; a misaligned base or a
    row stride that is no multiple of 16 bytes is copied, contiguous, its
    head dim padded with zeros to a multiple of 8, and counted."""
    ok = _heads(1, 64, 2, 128)
    before = ka.tma_copies.count
    assert ka._tma_operand(ok) is ok and ka.tma_copies.count == before
    misaligned = torch.randn(1, 2, 64, 129).to(torch.bfloat16)[..., 1:]
    assert not ka._tma_ready(misaligned)
    ragged = torch.randn(1, 2, 50, 20).to(torch.float16)  # 40-byte rows
    assert not ka._tma_ready(ragged)
    for t, width in ((misaligned, 128), (ragged, 24)):
        c = ka._tma_operand(t)
        assert c.shape == t.shape[:3] + (width,) and c.is_contiguous()
        assert ka._tma_ready(c)
        torch.testing.assert_close(c[..., :t.shape[-1]], t, rtol=0, atol=0)
        assert not c[..., t.shape[-1]:].any()
    assert ka.tma_copies.count == before + 2


@pytest.mark.parametrize("causal", [True, False])
def test_tma_copy_keeps_the_result(interpreted, causal):
    """bfloat16 operands of head dim 20 (40-byte rows) and a misaligned
    q: all three are copied, D padded to 24 with zeros.  The copies' fold
    (the scale of the logical D 20, the output cut back to 20 columns)
    equals the plain version on the operands as given within the card
    checks' 16-bit tolerance, 1e-2, and JAX's kernel within the bfloat16
    tolerance of ``test_flash_bfloat16_equals_jax``."""
    (jq, jk, jv), (q, k, v) = _both(_operands(21, 1, 2, 2, 50, 20),
                                    jnp.bfloat16)
    q = torch.cat([torch.zeros(1, 2, 50, 1, dtype=q.dtype), q], -1)[..., 1:]
    before = ka.tma_copies.count
    qc, kc, vc = (ka._tma_operand(t) for t in (q, k, v))
    assert ka.tma_copies.count == before + 3
    assert qc.shape[-1] == kc.shape[-1] == vc.shape[-1] == 24
    out, lse = ka.online_softmax_fold(
        qc, kc, vc, causal, ka._flash_block(50, q.dtype, 512),
        scale=1.0 / 20 ** 0.5)
    want, want_lse = flash_attention_plain(q, k, v, causal, with_lse=True)
    torch.testing.assert_close(out[..., :20], want, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        interop.to_numpy(out[..., :20]),
        np.asarray(pk.flash_attention(jq, jk, jv, causal=causal)).astype(
            np.float32), rtol=2e-2, atol=2e-2)


def _bwd_close(got, want):
    """The card checks' 16-bit tolerance for a gradient: max abs
    difference within 1e-2 of the plain gradient's largest entry and
    relative Frobenius difference within 1e-3 (a rounding of p or ds to
    the 16-bit dtype may land one ulp apart and carry into the
    product)."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape and torch.isfinite(g).all()
    assert float((g - w).abs().max()) <= 1e-2 * float(w.abs().max())
    assert float((g - w).norm() / w.norm()) <= 1e-3


def _card_bwd_case(dev, B, H, Hkv, T, D, dtype, causal, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, h, T, D, generator=gen, device=dev).to(dtype)
               for h in (H, Hkv, Hkv))
    do = torch.randn(B, H, T, D, generator=gen, device=dev).to(dtype)
    o, lse = flash_attention(q, k, v, causal, with_lse=True)
    return q, k, v, do, lse, flash_attention_bwd_delta(do, o)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,T,D,dtype,causal", [
    (1, 2, 2, 50, 24, torch.bfloat16, True),    # ragged T and D
    (2, 3, 3, 77, 40, torch.float16, False),    # ragged T and D, full
    (2, 4, 1, 200, 64, torch.bfloat16, True),   # MQA
])
def test_flash_bwd_wgmma_kernels_on_the_card(B, H, Hkv, T, D, dtype, causal):
    """Rows 17-18's wgmma kernels against their plain versions on ragged
    T and D (TMA zero-fills the rows at or past T and the columns at or
    past D; a head dim that TMA cannot read in place is copied) and under
    MQA (dK and dV per q head, summed over the group), one wgmma launch
    each; the delta kernel against its plain version within 1e-5 of each
    row's sum of magnitudes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    q, k, v, do, lse, delta = _card_bwd_case(dev, B, H, Hkv, T, D, dtype,
                                             causal, 31)
    o = flash_attention(q, k, v, causal)
    plain = flash_attention_bwd_delta_plain(do, o)
    mag = (do.float() * o.float()).abs().sum(-1)
    assert bool(((delta - plain).abs() <= 1e-5 * mag).all())
    wgmma = {n: KERNELS[n].wgmma_launches.count for n in WGMMA_BWD}
    got = (flash_attention_bwd_dq(q, k, v, do, lse, plain, causal),
           *flash_attention_bwd_dkv(q, k, v, do, lse, plain, causal))
    torch.cuda.synchronize()
    assert {n: KERNELS[n].wgmma_launches.count - wgmma[n]
            for n in WGMMA_BWD} == dict.fromkeys(WGMMA_BWD, 1)
    want = (flash_attention_bwd_dq_plain(q, k, v, do, lse, plain, causal),
            *flash_attention_bwd_dkv_plain(q, k, v, do, lse, plain, causal))
    for g, w in zip(got, want):
        _bwd_close(g, w)


@pytest.mark.gpu
def test_flash_bwd_is_deterministic_on_the_card():
    """Every output of rows 17-18 is written by one block, without
    atomics: two backward calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    args = _card_bwd_case(dev, 2, 8, 2, 512, 128, torch.bfloat16, True, 32)
    first = (flash_attention_bwd_dq(*args),
             *flash_attention_bwd_dkv(*args))
    again = (flash_attention_bwd_dq(*args),
             *flash_attention_bwd_dkv(*args))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_bwd_tma_operands_copy_only_what_tma_cannot_read():
    """The backward reads q, k, v and dO through TMA as the forward reads
    q, k and v: the transformer's head views in place, a misaligned base,
    a 40-byte row and an expanded gradient (stride 0) copied, one counted
    copy each; the C array holds each operand's geometry as it is read.
    float32 operands take no maps and no copies."""
    q, k, v = _heads(2, 64, 4, 128), _heads(2, 64, 2, 128), \
        _heads(2, 64, 2, 128)
    do = torch.randn(2, 4, 64, 129).to(torch.bfloat16)[..., 1:]
    assert not ka._tma_ready(do)
    before = ka.tma_copies.count
    (q2, k2, v2, do2), table = ka._bwd_tma(q, k, v, do)
    assert (q2, k2, v2) == (q, k, v) and do2 is not do
    assert ka.tma_copies.count == before + 1
    torch.testing.assert_close(do2, do, rtol=0, atol=0)
    assert list(table) == list(ka._tma_table([q, k, v, do2]))
    assert len(table) == 4 * 9
    grad = torch.ones(1, 1, 1, 1, dtype=torch.bfloat16).expand(2, 4, 64, 128)
    assert not ka._tma_ready(grad)  # stride 0: copied
    ragged = torch.zeros(2, 4, 64, 20, dtype=torch.float16)  # 40-byte rows
    before = ka.tma_copies.count
    ops, table = ka._bwd_tma(ragged, ragged[:, :2], ragged[:, :2], ragged)
    assert ka.tma_copies.count == before + 4
    assert all(t.shape[-1] == 24 and ka._tma_ready(t) for t in ops)
    assert [table[9 * i] for i in range(4)] == [24] * 4  # D padded to 24
    f32 = torch.zeros(1, 2, 16, 8)
    before = ka.tma_copies.count
    assert ka._bwd_tma(f32, f32, f32, f32) == ((f32,) * 4, None)
    assert ka.tma_copies.count == before


def test_grid_caps():
    """The forward's grid: 16-bit kernels take 128 query rows a block,
    float32 ones 64; at most 65535 blocks (times the ranks for row 15)
    along the grid's y, and the wrappers refuse more."""
    assert ka._fwd_rows(torch.bfloat16) == ka._fwd_rows(torch.float16) == 128
    assert ka._fwd_rows(torch.float32) == 64
    assert ka._grid_fits(128 * 65535, 128)
    assert not ka._grid_fits(128 * 65535 + 1, 128)
    assert ka._grid_fits(64 * 65535, 64)
    assert not ka._grid_fits(64 * 65535 + 1, 64)
    assert ka._grid_fits(128 * 16383, 128, ranks=4)
    assert not ka._grid_fits(128 * 16384 - 127, 128, ranks=4)
    long = torch.zeros(1, 1, 64 * 65535 + 1, 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds the kernel's grid"):
        ka._kernel_operands("flash_attention", long.float(),
                            rows=ka._fwd_rows(torch.float32))
    (got,), _ = ka._kernel_operands("flash_attention", long,
                                    rows=ka._fwd_rows(long.dtype))
    assert got is long  # 32768 blocks of 128 rows
