"""The port's mixture-of-experts layer against the JAX package's.

``accl_tpu_torch.models.moe`` is ``accl_tpu/models/moe.py`` with the
expert axis's ranks virtual on one device: a leading rank axis, each
rank routing its own tokens with its own capacity, and the all-to-all
the transpose of the ranks' dispatch buffers.  JAX runs the same layer
under ``shard_map`` over an ``ep`` axis of the conftest's virtual CPU
devices.  Parameters come from JAX's ``init_moe_params`` through
``params_from_numpy``, activations from a numpy seed.  Outputs agree
within rtol = atol = 2e-5, JAX's own bound for the same comparison
(``tests/test_moe_pipeline.py:80``); the router terms within 1e-5
relative.  Capacity factors below 1 make tokens drop, so those cases
hold each rank's drops to JAX's.  The flagship's experts are
``tests/test_torch_moe_flagship.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from accl_tpu.models import moe as jm
from accl_tpu_torch.models import init_moe_params, moe_ffn, params_from_numpy
from accl_tpu_torch.models.moe import _top_k

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


def _jmesh(*shape, axes=("dp", "tp")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _moe_params(seed, D, F, E):
    jp = jm.init_moe_params(jax.random.PRNGKey(seed), D, F, E)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _jmoe(x, jp, **kw):
    """JAX's moe_ffn on one rank, jitted (its eager form dispatches op by
    op)."""
    return jax.jit(lambda x_, p_: jm.moe_ffn(x_, p_, None, **kw))(
        jnp.asarray(x), jp)


def _jax_ep(x, jp, ep, **kw):
    """JAX's moe_ffn over an ``ep`` axis of CPU devices, each rank its
    slab of ``x`` (ep, B, T, D); returns (y, load_balance per rank)."""

    def run(xl, g, w1, w2):
        y, aux = jm.moe_ffn(xl[0], {"gate": g, "w1": w1, "w2": w2}, "ep",
                            return_aux=True, **kw)
        return y[None], aux["load_balance"][None]

    fn = jax.jit(shard_map(
        run, mesh=_jmesh(ep, axes=("ep",)),
        in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=(P("ep"), P("ep")), check_vma=False))
    y, lb = fn(jnp.asarray(x), jp["gate"], jp["w1"], jp["w2"])
    return np.asarray(y), np.asarray(lb)


# ---------------------------------------------------------------------------
# the layer (tests/test_moe_pipeline.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf,k", [(8.0, 1), (8.0, 2), (1.5, 2), (0.5, 1),
                                  (0.25, 2)])
def test_moe_expert_parallel_matches_dense(cf, k):
    """The layer over 4 virtual ep ranks equals JAX's over 4 devices, and
    with the no-drop capacity also each rank's tokens through one rank
    with every expert local (``test_moe_pipeline.py:50``, ``:218``); at
    capacity factors below 1 (drop-heavy) every rank drops exactly what
    JAX's rank drops."""
    ep, B, T, D, F, E = 4, 2, 8, 16, 32, 8
    jp, tp = _moe_params(0, D, F, E)
    x = np.random.default_rng(1).standard_normal((ep, B, T, D)).astype(
        np.float32)
    want, want_lb = _jax_ep(x, jp, ep, capacity_factor=cf, k=k)
    got, aux = moe_ffn(torch.from_numpy(x), tp, ep=ep, capacity_factor=cf,
                       k=k, return_aux=True)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    np.testing.assert_allclose(aux["load_balance"].numpy(), want_lb,
                               rtol=1e-5)
    if cf == float(E):
        local = torch.stack([moe_ffn(torch.from_numpy(x[r]), tp, None,
                                     capacity_factor=cf, k=k)
                             for r in range(ep)])
        np.testing.assert_allclose(got.numpy(), local.numpy(), **LAYER_TOL)
    else:  # drops happened: fewer rows reached an expert than were routed
        routed = np.count_nonzero(np.abs(got.numpy()).sum(-1) > 1e-9)
        assert routed < ep * B * T or k > 1


def test_moe_capacity_drops_fall_through():
    """Over-capacity tokens contribute exactly zero, the first ``cap``
    routed to each expert survive (``test_moe_pipeline.py:86``), and the
    output equals JAX's."""
    B, T, D, F, E = 1, 16, 8, 16, 2
    jp, tp = _moe_params(3, D, F, E)
    x = np.random.default_rng(4).standard_normal((B, T, D)).astype(
        np.float32)
    cap = max(1, int(0.25 * B * T / E))
    y = moe_ffn(torch.from_numpy(x), tp, None, capacity_factor=0.25)
    want = _jmoe(x, jp, capacity_factor=0.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **LAYER_TOL)
    routed = (x.reshape(-1, D) @ np.asarray(jp["gate"])).argmax(-1)
    expect = sum(min((routed == e).sum(), cap) for e in range(E))
    nonzero = np.count_nonzero(np.abs(y.numpy()).sum(-1) > 1e-9)
    assert nonzero == expect and expect < B * T


@pytest.mark.parametrize("k", [1, 2])
def test_moe_is_differentiable(k):
    """Gradients of sum(y^2) with respect to the gate and both banks are
    finite and equal JAX's (``test_moe_pipeline.py:101``)."""
    B, T, D, F, E = 2, 4, 8, 16, 4
    jp, tp = _moe_params(5, D, F, E)
    x = np.random.default_rng(6).standard_normal((B, T, D)).astype(
        np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        jm.moe_ffn(jnp.asarray(x), p, None, k=k) ** 2)))(jp)
    for t in tp.values():
        t.requires_grad_()
    (moe_ffn(torch.from_numpy(x), tp, None, k=k) ** 2).sum().backward()
    for name in ("gate", "w1", "w2"):
        g = tp[name].grad.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(want[name]), rtol=2e-4,
                                   atol=2e-6)


def test_moe_top2_matches_dense_reference():
    """Top-2 equals the explicit sum of each token's two best experts'
    FFNs weighted by the renormalized gate (``test_moe_pipeline.py:193``),
    and JAX's layer."""
    B, T, D, F, E = 2, 8, 16, 32, 8
    jp, tp = _moe_params(2, D, F, E)
    x = np.random.default_rng(3).standard_normal((B, T, D)).astype(
        np.float32)
    out = moe_ffn(torch.from_numpy(x), tp, None, capacity_factor=float(E),
                  k=2).numpy()
    np.testing.assert_allclose(out, np.asarray(_jmoe(
        x, jp, capacity_factor=float(E), k=2)), **LAYER_TOL)
    flat = x.reshape(-1, D)
    probs = torch.softmax(torch.from_numpy(flat) @ tp["gate"], -1)
    top_p, top_e = torch.topk(probs, 2, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    expect = np.zeros_like(flat)
    for i in range(flat.shape[0]):
        for j in range(2):
            e = int(top_e[i, j])
            h = torch.nn.functional.gelu(
                torch.from_numpy(flat[i]) @ tp["w1"][e], approximate="tanh")
            expect[i] += float(top_p[i, j]) * (h @ tp["w2"][e]).numpy()
    np.testing.assert_allclose(out.reshape(-1, D), expect, rtol=2e-4,
                               atol=2e-5)


def test_moe_top2_expert_parallel_matches_local():
    """Top-2 over 4 virtual ep ranks equals top-2 with every expert local
    (``test_moe_pipeline.py:218``) and JAX's over 4 devices."""
    ep, B, T, D, F, E = 4, 1, 8, 16, 32, 8
    jp, tp = _moe_params(4, D, F, E)
    x = np.random.default_rng(5).standard_normal((ep, B, T, D)).astype(
        np.float32)
    got = moe_ffn(torch.from_numpy(x), tp, ep=ep, capacity_factor=float(E),
                  k=2)
    local = torch.stack([moe_ffn(torch.from_numpy(x[r]), tp, None,
                                 capacity_factor=float(E), k=2)
                         for r in range(ep)])
    np.testing.assert_allclose(got.numpy(), local.numpy(), **LAYER_TOL)
    want, _ = _jax_ep(x, jp, ep, capacity_factor=float(E), k=2)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_moe_tied_probabilities_pick_lower_experts(k):
    """A zero gate ties every expert's probability: ``lax.top_k`` picks
    the k lowest indices, and so must the port (``torch.topk`` promises no
    order on ties).  Every slot order then follows, so at a capacity that
    drops the outputs still equal JAX's."""
    B, T, D, F, E = 2, 8, 8, 16, 4
    jp, tp = _moe_params(7, D, F, E)
    jp = dict(jp, gate=jnp.zeros((D, E), jnp.float32))
    tp = dict(tp, gate=torch.zeros(D, E))
    x = np.random.default_rng(8).standard_normal((B, T, D)).astype(
        np.float32)
    _, top_e = _top_k(torch.full((3, E), 1.0 / E), k)
    assert top_e.tolist() == [list(range(k))] * 3
    for cf in (float(E), 0.5):
        got = moe_ffn(torch.from_numpy(x), tp, None, capacity_factor=cf, k=k)
        want = _jmoe(x, jp, capacity_factor=cf, k=k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)


def test_moe_aux_losses():
    """The router terms: load balance near 1 when the router spreads,
    near E when it collapses; the z-loss grows with the logits; both equal
    JAX's, and the load balance's gate gradient too
    (``test_moe_pipeline.py:651``)."""
    D, F, E = 16, 32, 4
    jp, tp = _moe_params(5, D, F, E)
    x = np.abs(np.random.default_rng(6).standard_normal((2, 16, D))).astype(
        np.float32)
    y, aux = moe_ffn(torch.from_numpy(x), tp, return_aux=True)
    _, jaux = _jmoe(x, jp, return_aux=True)
    assert y.shape == x.shape
    for name in ("load_balance", "router_z"):
        assert aux[name].dtype == torch.float32
        assert float(aux[name]) == pytest.approx(float(jaux[name]),
                                                 rel=1e-5)
    assert 0.9 < float(aux["load_balance"]) < 1.5
    collapsed = dict(tp, gate=torch.zeros(D, E).index_fill_(
        1, torch.tensor([0]), 50.0))
    _, aux_c = moe_ffn(torch.from_numpy(x), collapsed, return_aux=True)
    assert float(aux_c["load_balance"]) > 0.9 * E
    assert float(aux_c["router_z"]) > float(aux["router_z"])
    gate = tp["gate"].clone().requires_grad_()
    moe_ffn(torch.from_numpy(x), dict(tp, gate=gate),
            return_aux=True)[1]["load_balance"].backward()
    want = jax.jit(jax.grad(lambda p: jm.moe_ffn(
        jnp.asarray(x), p, return_aux=True)[1]["load_balance"]))(jp)
    assert float(gate.grad.abs().max()) > 0
    np.testing.assert_allclose(gate.grad.numpy(), np.asarray(want["gate"]),
                               rtol=1e-4, atol=1e-7)


def test_moe_aux_under_expert_parallelism():
    """With every rank seeing the same tokens, each rank's load balance
    equals the one-rank layer's (``test_moe_pipeline.py:680``)."""
    D, F, E, ep = 8, 16, 4, 4
    jp, tp = _moe_params(7, D, F, E)
    x = np.random.default_rng(8).standard_normal((2, 8, D)).astype(
        np.float32)
    _, dense = moe_ffn(torch.from_numpy(x), tp, None,
                       capacity_factor=float(E), return_aux=True)
    xs = torch.from_numpy(x)[None].expand(ep, *x.shape)
    _, aux = moe_ffn(xs, tp, ep=ep, capacity_factor=float(E),
                     return_aux=True)
    np.testing.assert_allclose(aux["load_balance"].numpy(),
                               float(dense["load_balance"]), rtol=1e-5)
    _, want = _jax_ep(np.broadcast_to(x, (ep,) + x.shape).copy(), jp, ep,
                      capacity_factor=float(E))
    np.testing.assert_allclose(aux["load_balance"].numpy(), want, rtol=1e-5)


def test_moe_layer_refusals():
    _, tp = _moe_params(0, 8, 16, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP B14"):
        moe_ffn(torch.zeros(1, 2, 8), tp, tp_axis="tp")
    with pytest.raises(ValueError, match="must divide"):
        moe_ffn(torch.zeros(3, 1, 2, 8), tp, ep=2)


def test_init_moe_params_shapes():
    p = init_moe_params(16, 32, 4, torch.Generator().manual_seed(0),
                        device="cpu")
    jp = jm.init_moe_params(jax.random.PRNGKey(0), 16, 32, 4)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert abs(float(p["w1"].std()) - 16 ** -0.5) < 0.02


def test_repeated_moe_backward_is_bitwise_equal():
    """The dispatch scatter-add and the combine's gather (whose gradient
    is a scatter-add) collide only on dropped entries, which add zero:
    a repeated backward gives the same bits (the card's check is
    ``chip_smoke.py`` phase 3o)."""
    ep, B, T, D, F, E = 4, 2, 8, 16, 32, 8
    _, tp = _moe_params(9, D, F, E)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (ep, B, T, D)).astype(np.float32))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (x, *tp.values())]
        y = moe_ffn(leaves[0], dict(zip(tp, leaves[1:])), ep=ep,
                    capacity_factor=0.5, k=2)
        runs.append(torch.autograd.grad((y * y).sum(), leaves))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
