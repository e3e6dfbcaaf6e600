"""The port's sequence-parallel attention against the JAX package's.

``accl_tpu_torch.models`` runs ring, striped and Ulysses attention over P
virtual ranks: each function takes the ranks' ``(B, H, T_local, D)``
shards as lists and returns one result per rank.  JAX runs the same
functions inside ``shard_map`` over the virtual CPU mesh.  Here the same
numpy-seeded global operands go through both: ``interop.shards_from_numpy``
cuts the port's shards as ``P(None, None, "sp", None)`` cuts JAX's, and
``interop.shards_to_numpy`` reassembles them.  Row 15's plain version
(``ring_attention_plain``, what ``ring_attention_pallas`` runs on CPU
tensors) is held against the JAX package's Pallas ``ring_attention``,
interpreted as ``tests/test_pallas.py`` runs it; Ulysses with
``use_pallas_alltoall=True`` reaches JAX's interpreted row 12.

Tolerances: float32 rtol = atol = 2e-5, the JAX flash tests' own (the
JAX model tests hold these forms at 2e-4 / 2e-5 against the reference);
bfloat16 1e-2, row 16's.  The kernels run only on the card
(``chip_smoke.py`` phases 2 and 3 hold them against the plain versions;
the ``gpu``-marked tests below do too).
"""

import threading
from functools import partial

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

from accl_tpu import models as jm
from accl_tpu.compat import has_interpret_params, interpret_params_reason
from accl_tpu.core import xla_group
from accl_tpu.models.ring_attention import fused_hop_partial as j_hop
from accl_tpu.ops import pallas as pk

import accl_tpu_torch as at
from accl_tpu_torch import interop
from accl_tpu_torch import models as tm
from accl_tpu_torch.models.ring_attention import fused_hop_partial as t_hop
from accl_tpu_torch.ops import cuda as kc
from accl_tpu_torch.ops.cuda.attention import (
    MAX_HEAD_DIM,
    ring_attention_plain,
)

interpreted = pytest.mark.skipif(
    jax.default_backend() != "tpu" and not has_interpret_params(),
    reason=f"Pallas interpret tier unavailable: {interpret_params_reason()}",
)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
SEQ = PS(None, None, "sp", None)


def _global(seed, shapes, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(dtype) for s in shapes]


def _jax_sp(body, arrays, P):
    """``body`` under ``shard_map`` over a P-device "sp" axis, every
    operand and the result sequence-sharded; returns the global result."""
    mesh = Mesh(np.array(jax.devices()[:P]), ("sp",))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(SEQ,) * len(arrays),
                           out_specs=SEQ, check_vma=False))
    out = np.asarray(fn(*(jnp.asarray(a) for a in arrays)))
    return out.astype(np.float32) if out.dtype == ml_dtypes.bfloat16 else out


def _port_sp(fn, arrays, P, **kw):
    """``fn`` over the port's per-rank shards of ``arrays``; returns the
    reassembled global result."""
    shards = [interop.shards_from_numpy(a, P, device="cpu") for a in arrays]
    outs = fn(*shards, **kw)
    assert len(outs) == P
    return interop.shards_to_numpy(outs)


# ---------------------------------------------------------------------------
# ring and striped attention (the ppermute forms)
# ---------------------------------------------------------------------------

# (name, P, B, H, Hkv, T, D): test_models.py:146's ring shapes, :1149's
# striped shapes and its grouped-query ones
RING_CASES = [
    ("ring", 8, 2, 2, 2, 64, 16),
    ("striped", 4, 2, 2, 2, 32, 16),
    ("ring_gqa", 4, 2, 8, 2, 32, 16),
    ("striped_gqa", 4, 2, 8, 2, 32, 16),
]


@pytest.mark.parametrize("block_k", [None, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_ring_forms_equal_jax(case, causal, block_k):
    name, P, B, H, Hkv, T, D = case
    striped = name.startswith("striped")
    q, k, v = _global(RING_CASES.index(case) + 3,
                      [(B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D)])
    if striped:
        q, k, v = (np.asarray(jm.stripe_sequence(jnp.asarray(a), P))
                   for a in (q, k, v))
    jfn = jm.striped_attention if striped else jm.ring_attention
    tfn = tm.striped_attention if striped else tm.ring_attention
    want = _jax_sp(partial(jfn, axis_name="sp", causal=causal,
                           block_k=block_k), (q, k, v), P)
    got = _port_sp(tfn, (q, k, v), P, causal=causal, block_k=block_k)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_ring_attention_bfloat16_equals_jax():
    P, B, H, T, D = 4, 1, 2, 32, 16
    q, k, v = _global(40, [(B, H, T, D)] * 3, ml_dtypes.bfloat16)
    for jfn, tfn in ((jm.ring_attention, tm.ring_attention),
                     (jm.striped_attention, tm.striped_attention)):
        want = _jax_sp(partial(jfn, axis_name="sp", block_k=4), (q, k, v), P)
        got = _port_sp(tfn, (q, k, v), P, block_k=4)
        np.testing.assert_allclose(got, want, **BF16_TOL)


def test_ring_attention_gradients_equal_jax():
    """The model forms are differentiable: the gradients of sum(out * w)
    through the port's autograd equal ``jax.grad`` through the ppermute
    ring (float32, rtol 2e-4, atol 2e-5, the JAX gradient tests' own)."""
    P, B, H, Hkv, T, D = 4, 1, 4, 2, 16, 8
    q, k, v, w = _global(41, [(B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D),
                              (B, H, T, D)])
    mesh = Mesh(np.array(jax.devices()[:P]), ("sp",))
    ring = shard_map(partial(jm.ring_attention, axis_name="sp", block_k=2),
                     mesh=mesh, in_specs=(SEQ,) * 3, out_specs=SEQ,
                     check_vma=False)
    jgrads = jax.jit(jax.grad(
        lambda q, k, v: (ring(q, k, v) * w).sum(), argnums=(0, 1, 2)))(
            *(jnp.asarray(a) for a in (q, k, v)))
    shards = [[t.requires_grad_()
               for t in interop.shards_from_numpy(a, P, device="cpu")]
              for a in (q, k, v)]
    out = torch.cat(tm.ring_attention(*shards, block_k=2), dim=2)
    (out * torch.from_numpy(w)).sum().backward()
    for ts, jg in zip(shards, jgrads):
        got = interop.shards_to_numpy([t.grad for t in ts])
        np.testing.assert_allclose(got, np.asarray(jg), rtol=2e-4, atol=2e-5)


def test_stripe_roundtrip_bit_exact_and_equal_jax():
    x = np.arange(2 * 3 * 12 * 4, dtype=np.float32).reshape(2, 3, 12, 4)
    t = torch.from_numpy(x)
    for axis in (2, 1, -1):
        size = x.shape[axis]
        for P in (2, 3, 4, 6):
            if size % P:
                continue
            st = tm.stripe_sequence(t, P, axis)
            np.testing.assert_array_equal(
                st.numpy(), np.asarray(jm.stripe_sequence(x, P, axis)))
            back = tm.unstripe_sequence(st, P, axis)
            assert torch.equal(back, t)
    with pytest.raises(ValueError, match="divide"):
        tm.stripe_sequence(t, 5)
    with pytest.raises(ValueError, match="divide"):
        tm.unstripe_sequence(t, 5)


def test_reference_attention_equals_jax():
    q, k, v = _global(42, [(2, 2, 24, 16)] * 3)
    for causal in (True, False):
        want = np.asarray(jm.reference_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal))
        got = tm.reference_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


# ---------------------------------------------------------------------------
# Ulysses attention (rows 12's re-shard)
# ---------------------------------------------------------------------------


@interpreted
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ulysses_equals_jax(use_pallas):
    """test_pallas.py:568's shapes: (1, 4, 4 x 8, 32) over 4 ranks."""
    P, B, H, T, D = 4, 1, 4, 32, 32
    q, k, v = _global(43, [(B, H, T, D)] * 3, scale=0.5)
    want = _jax_sp(lambda q, k, v: jm.ulysses_attention(
        q, k, v, "sp", use_pallas_alltoall=use_pallas), (q, k, v), P)
    got = _port_sp(tm.ulysses_attention, (q, k, v), P,
                   use_pallas_alltoall=use_pallas)
    np.testing.assert_allclose(got, want, **F32_TOL)


@interpreted
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_bfloat16_equals_jax(causal):
    P, B, H, T, D = 2, 1, 4, 16, 16
    q, k, v = _global(44, [(B, H, T, D)] * 3, ml_dtypes.bfloat16)
    want = _jax_sp(lambda q, k, v: jm.ulysses_attention(
        q, k, v, "sp", causal=causal, use_pallas_alltoall=True), (q, k, v), P)
    for use_pallas in (False, True):
        got = _port_sp(tm.ulysses_attention, (q, k, v), P, causal=causal,
                       use_pallas_alltoall=use_pallas)
        np.testing.assert_allclose(got, want, **BF16_TOL)


def test_ulysses_forms_agree_bit_for_bit():
    """Row 12's re-shard and the tiled ``_a2a`` move the same bytes."""
    q, k, v = _global(45, [(2, 8, 8, 16)] * 3)
    for P in (2, 4, 8):
        shards = [interop.shards_from_numpy(a, P, device="cpu")
                  for a in (q, k, v)]
        a = tm.ulysses_attention(*shards)
        b = tm.ulysses_attention(*shards, use_pallas_alltoall=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ulysses_single_rank_is_reference_attention():
    q, k, v = (torch.from_numpy(a) for a in _global(46, [(1, 2, 8, 4)] * 3))
    (out,) = tm.ulysses_attention([q], [k], [v], causal=False)
    assert torch.equal(out, tm.reference_attention(q, k, v, causal=False))


# ---------------------------------------------------------------------------
# row 15's plain version against the interpreted Pallas kernel
# ---------------------------------------------------------------------------

# (B, H, T, D, striped, causal, dtype): test_pallas.py:400's, :427's and
# :863's shapes, and a bfloat16 case
KERNEL_CASES = [
    (1, 2, 64, 64, False, True, "float32"),
    (1, 2, 64, 64, False, False, "float32"),
    (2, 2, 32, 32, False, True, "float32"),
    (1, 2, 64, 32, True, True, "float32"),
    (1, 2, 64, 32, True, False, "float32"),
    (1, 2, 64, 32, True, True, "bfloat16"),
]


@interpreted
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_ring_attention_plain_equals_jax_pallas(case):
    B, H, T, D, striped, causal, dtype = case
    P = 4
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = _global(47 + T + D, [(B, H, T, D)] * 3, dt)
    if striped:
        q, k, v = (np.asarray(jm.stripe_sequence(jnp.asarray(a), P))
                   for a in (q, k, v))
    want = _jax_sp(partial(pk.attention.ring_attention, axis_name="sp",
                           causal=causal, striped=striped), (q, k, v), P)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for fn in (ring_attention_plain, tm.ring_attention_pallas):
        got = _port_sp(fn, (q, k, v), P, causal=causal, striped=striped)
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("P", [2, 3, 5])
def test_the_slice_against_the_full_sequence(P):
    """Every sequence-parallel form of the port over P ranks against the
    JAX package's ``reference_attention`` on the full sequence, causal,
    float32: contiguous and striped row 15, Ulysses with row 12, the
    ring and striped model forms."""
    B, H, T, D = 1, P * 2, P * 8, 16
    q, k, v = _global(48 + P, [(B, H, T, D)] * 3)
    want = np.asarray(jm.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True))
    striped = [tm.stripe_sequence(torch.from_numpy(a), P).numpy()
               for a in (q, k, v)]

    def unstripe(x):
        return tm.unstripe_sequence(torch.from_numpy(x), P).numpy()

    outs = {
        "ring_attention_pallas": _port_sp(tm.ring_attention_pallas,
                                          (q, k, v), P),
        "ring_attention_pallas striped": unstripe(_port_sp(
            tm.ring_attention_pallas, striped, P, striped=True)),
        "ulysses row 12": _port_sp(tm.ulysses_attention, (q, k, v), P,
                                   use_pallas_alltoall=True),
        "ring_attention": _port_sp(tm.ring_attention, (q, k, v), P),
        "striped_attention": unstripe(_port_sp(tm.striped_attention,
                                               striped, P)),
    }
    for name, got in outs.items():
        np.testing.assert_allclose(got, want, err_msg=name, **F32_TOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_shards_from_numpy_never_falls_back_to_cpu(monkeypatch):
    """``interop.shards_from_numpy`` goes to the card unless asked for the
    CPU, as ``params_from_numpy`` does: without a card, ``device=None``
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = np.arange(2 * 3 * 8 * 4, dtype=np.float32).reshape(2, 3, 8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.shards_from_numpy(q, 2)
    shards = interop.shards_from_numpy(q, 2, device="cpu")
    assert [t.device.type for t in shards] == ["cpu", "cpu"]
    np.testing.assert_array_equal(interop.shards_to_numpy(shards), q)


def test_refusals():
    z = torch.zeros
    with pytest.raises(ValueError, match="shapes"):
        tm.ring_attention_pallas([z(1, 1, 8, 32)], [z(1, 1, 16, 32)],
                                 [z(1, 1, 8, 32)])
    with pytest.raises(ValueError, match="dtypes"):
        tm.ring_attention_pallas(
            [z(1, 1, 8, 32)], [z(1, 1, 8, 32, dtype=torch.bfloat16)],
            [z(1, 1, 8, 32, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="multiple of 8"):
        tm.ring_attention_pallas([z(1, 1, 12, 32)] * 2, [z(1, 1, 12, 32)] * 2,
                                 [z(1, 1, 12, 32)] * 2)
    with pytest.raises(ValueError, match="ranks"):
        tm.ring_attention_pallas([z(1, 1, 8, 4)] * 2, [z(1, 1, 8, 4)],
                                 [z(1, 1, 8, 4)] * 2)
    with pytest.raises(ValueError, match="rank 0"):
        tm.ring_attention_pallas([z(1, 1, 8, 4), z(1, 1, 16, 4)],
                                 [z(1, 1, 8, 4), z(1, 1, 16, 4)],
                                 [z(1, 1, 8, 4), z(1, 1, 16, 4)])
    with pytest.raises(ValueError, match="not divisible by axis size 4"):
        tm.ulysses_attention(*([z(1, 6, 8, 4)] * 4,) * 3)
    with pytest.raises(ValueError, match="block_k"):
        tm.ring_attention(*([z(1, 2, 8, 4)] * 2,) * 3, block_k=3)
    with pytest.raises(ValueError, match="block_k"):
        tm.striped_attention(*([z(1, 2, 8, 4)] * 2,) * 3, block_k=5)


def test_refusal_messages_match_jax():
    """The JAX entries' messages, where both sides refuse the input."""
    with pytest.raises(ValueError) as jerr:
        pk.attention.ring_attention(jnp.zeros((1, 1, 12, 32)),
                                    jnp.zeros((1, 1, 12, 32)),
                                    jnp.zeros((1, 1, 12, 32)), "sp")
    with pytest.raises(ValueError) as terr:
        tm.ring_attention_pallas(*([torch.zeros(1, 1, 12, 32)],) * 3)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        _jax_sp(partial(jm.ring_attention, axis_name="sp", block_k=3),
                _global(49, [(1, 2, 16, 4)] * 3), 2)
    with pytest.raises(ValueError) as terr:
        _port_sp(tm.ring_attention, _global(49, [(1, 2, 16, 4)] * 3), 2,
                 block_k=3)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# fused_hop_partial over the facade's command ring
# ---------------------------------------------------------------------------


def _each_rank(group, fn):
    out, errors = [None] * len(group), []

    def run(r):
        try:
            out[r] = fn(group[r], r)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(len(group))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return out


@pytest.mark.parametrize("hop,scale", [(1, 0.5), (3, 2.0), (6, 1.0)])
def test_fused_hop_partial_equals_jax(hop, scale):
    """Each rank's partial ``scale * q * kv`` against the K/V block from
    ``hop`` positions behind, on ``cuda_group(4, device="cpu")`` and on
    ``xla_group(4)``: equal bit for bit."""
    kv, q = _global(50 + hop, [(4, 96), (4, 96)])
    jg, tg = xla_group(4), at.cuda_group(4, device="cpu")
    try:
        want = _each_rank(jg, lambda a, r: j_hop(a, kv[r], q[r], hop, scale))
        got = _each_rank(tg, lambda a, r: t_hop(a, kv[r], q[r], hop, scale))
    finally:
        for a in jg + tg:
            a.deinit()
    for r in range(4):
        assert got[r].dtype == np.float32
        np.testing.assert_array_equal(got[r], want[r])
        np.testing.assert_array_equal(
            got[r], (q[r] * kv[(r - hop) % 4]) * np.float32(scale))
    with pytest.raises(ValueError, match="equal width"):
        t_hop(None, kv[0], q[0][:5], 1)


# ---------------------------------------------------------------------------
# the kernels, where a card is present
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_ring_attention_kernel_on_the_card():
    """On CUDA tensors one launch (16-bit ones through the wgmma kernel,
    also at the sequence-parallel path's width), within 2e-5 (float32:
    FFMA, no TF32) or 1e-2 (16-bit) of the plain version; a head dim over
    the cap raises, never the plain version; Ulysses with row 12 launches
    it four times and equals the ``_a2a`` form bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    kern = kc.KERNELS["ring_attention"]
    for P, (B, H, T, D), dtype, causal, striped in (
            (4, (2, 2, 72, 24), torch.float32, True, False),
            (3, (1, 3, 128, 64), torch.bfloat16, True, True),
            (2, (1, 2, 64, 128), torch.float16, False, False),
            # the sequence-parallel path's width, both layouts
            (4, (2, 32, 1024, 128), torch.bfloat16, True, False),
            (4, (2, 32, 1024, 128), torch.bfloat16, True, True)):
        qs, ks, vs = ([torch.randn(B, H, T, D, device=dev).to(dtype)
                       for _ in range(P)] for _ in range(3))
        before = (kern.launches.count, kern.wgmma_launches.count)
        got = tm.ring_attention_pallas(qs, ks, vs, causal, striped=striped)
        torch.cuda.synchronize()
        assert kern.launches.count - before[0] == 1
        assert kern.wgmma_launches.count - before[1] == (
            dtype != torch.float32)  # 16-bit: the wgmma kernel
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for g, w in zip(got, ring_attention_plain(qs, ks, vs, causal,
                                                  striped=striped)):
            torch.testing.assert_close(g, w, **tol)
    big = [torch.zeros(1, 1, 8, MAX_HEAD_DIM + 8, device=dev)] * 2
    with pytest.raises(ValueError, match=str(MAX_HEAD_DIM)):
        tm.ring_attention_pallas(big, big, big)
    qs, ks, vs = ([torch.randn(1, 8, 32, 16, device=dev) for _ in range(4)]
                  for _ in range(3))
    before = kc.KERNELS["alltoall"].launches.count
    a = tm.ulysses_attention(qs, ks, vs, use_pallas_alltoall=True)
    assert kc.KERNELS["alltoall"].launches.count - before == 4
    b = tm.ulysses_attention(qs, ks, vs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
