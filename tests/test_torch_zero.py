"""The port's ZeRO-1 Adam against the JAX package's.

``accl_tpu_torch.parallel`` is ``accl_tpu/parallel/zero.py`` over virtual
dp ranks on one device: the moments (and master weights) in JAX's flat
per-leaf layout, each rank's 1/dp slice side by side, so a JAX state
tree carries across with ``params_from_numpy``.  JAX runs its maker on a
``("dp", "tp")`` mesh of the conftest's CPU devices whose tp is 1 (the
port's meshes; ``tests/test_zero.py``'s ``mesh42`` has tp 2, which the
port refuses until the multi-GPU slice), the cp cases on ``(4, 2)``.
Parameters come from JAX's ``init_params``, tokens from a numpy seed.

Tolerances are ``tests/test_zero.py``'s for the same comparisons: losses
1e-5 relative, parameters rtol 2e-4, atol 1e-5 (:113-118; Adam's first
steps are g / (|g| + eps), so reduction-order roundoff on near-zero
gradients reaches ~1e-5), accumulation rtol 1e-5, atol 1e-6 (:318), the
bfloat16 master track rtol 2e-2, atol 5e-4 (:391), and the MoE cases
rtol 2e-4, atol 1e-5 (:516; 2e-3, 2e-5 between the two expert layouts,
``tests/test_models.py:1516``).  The expert-bank, cp, bfloat16 and
state-crossing cases are ``tests/test_torch_zero_moe.py``, which reuses
these helpers.  The trainer's checkpoint cases (``tests/test_zero.py:145``,
``:163``) wait for the port's ``examples/train.py`` (ROADMAP A9d).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.models import transformer as jt
from accl_tpu.parallel import zero as jz
from accl_tpu_torch.models import (
    TransformerConfig,
    params_from_numpy,
    params_to_numpy,
)
from accl_tpu_torch.models import transformer as pt
from accl_tpu_torch.ops.driver import make_mesh
from accl_tpu_torch.parallel import (
    AdamConfig,
    clip_by_global_norm,
    make_zero_train_step,
    reshard_plan,
    schedule_lr,
    zero_state_specs,
)
from accl_tpu_torch.parallel import zero as pz

TOL = dict(rtol=2e-4, atol=1e-5)
#: tests/test_zero.py's cfg fixture
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32, attention="naive")


def _configs(dtype="float32", **kw):
    fields = {**BASE, **kw}
    return (jt.TransformerConfig(dtype=getattr(jnp, dtype), **fields),
            TransformerConfig(dtype=getattr(torch, dtype), **fields))


def _tree(jcfg, seed):
    return jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))


def _batch(seed, B=8, T=16):
    tokens = np.random.default_rng(seed).integers(
        0, BASE["vocab"], (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jmesh(*shape, axes=("dp", "tp")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _pmesh(*shape, axes=("dp", "tp")):
    return make_mesh(shape, axes=axes, device="cpu")


def _run_jax(jcfg, mesh, adam, tree, tokens, targets, steps=1, accum=1):
    step, shard, init_state = jz.make_zero_train_step(jcfg, mesh, adam,
                                                      accum_steps=accum)
    p, s = shard(tree), init_state(shard(tree))
    losses = []
    for _ in range(steps):
        p, s, loss = step(p, s, tokens, targets)
        losses.append(float(loss))
    return (losses, jax.tree.leaves(jax.tree.map(np.asarray, p)),
            jax.tree.map(np.asarray, s))


def _run_port(cfg, mesh, adam, tree, tokens, targets, steps=1, accum=1,
              state=None):
    step, shard, init_state = make_zero_train_step(cfg, mesh, adam,
                                                   accum_steps=accum)
    p = shard(params_from_numpy(tree, device="cpu"))
    s = init_state(p) if state is None else state
    losses = []
    for _ in range(steps):
        p, s, loss = step(p, s, torch.from_numpy(tokens),
                          torch.from_numpy(targets))
        losses.append(float(loss))
    return losses, jax.tree.leaves(params_to_numpy(p)), s


def _close(got, want, **tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **(tol or TOL))


def _reference_adam(cfg, tree, tokens, targets, adam, steps, clip=None):
    """Unsharded Adam (``tests/test_zero.py:54``) written out on whole
    tensors with the port's loss."""
    params = params_from_numpy(tree, device="cpu")
    leaves = pt._tree_leaves(params)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    for t in range(1, steps + 1):
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        loss = pt.loss_fn(pt._tree_map(lambda _: next(it), params),
                          torch.from_numpy(tokens), torch.from_numpy(targets),
                          cfg)
        grads = torch.autograd.grad(loss, live)
        if clip is not None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            grads = [g * (clip / torch.clamp(norm, min=clip)) for g in grads]
        bc1, bc2 = 1.0 - adam.b1 ** t, 1.0 - adam.b2 ** t
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(leaves, grads)):
                m[i] = adam.b1 * m[i] + (1 - adam.b1) * g
                v[i] = adam.b2 * v[i] + (1 - adam.b2) * g * g
                p -= adam.lr * (m[i] / bc1) / (torch.sqrt(v[i] / bc2)
                                                + adam.eps)
    return jax.tree.leaves(params_to_numpy(params))


def test_zero_matches_unsharded_adam():
    """Three steps over (dp 4, tp 1) equal JAX's on a (4, 1) mesh and
    unsharded Adam (``tests/test_zero.py:92``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 0)
    tokens, targets = _batch(1)
    adam = AdamConfig(lr=0.01)
    want = _run_jax(jcfg, _jmesh(4, 1), jz.AdamConfig(lr=0.01), tree,
                    tokens, targets, steps=3)
    got = _run_port(cfg, _pmesh(4, 1), adam, tree, tokens, targets, steps=3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    _close(got[1], want[1])
    _close(got[1], _reference_adam(cfg, tree, tokens, targets, adam, 3))


def test_zero_state_is_dp_sharded():
    """The state's layout is JAX's: each leaf's flat float32 moments
    padded to a multiple of dp, 1/dp a rank, the specs JAX's
    (``tests/test_zero.py:121``)."""
    jcfg, cfg = _configs(vocab=61)  # an embedding dp does not divide
    tree = _tree(jcfg, 0)
    _, _, jinit = jz.make_zero_train_step(jcfg, _jmesh(4, 1))
    jstate = jinit(tree)
    _, shard, init = make_zero_train_step(cfg, _pmesh(4, 1))
    state = init(shard(params_from_numpy(tree, device="cpu")))
    assert jax.tree.map(lambda t: tuple(t.shape), state) == jax.tree.map(
        lambda a: tuple(a.shape), jstate)
    m = state["m"]["embed"]
    assert m.dtype == torch.float32 and m.numel() == 4 * -(-61 * 32 // 4)
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    want = jz.zero_state_specs(jt.param_specs(jcfg))
    got = zero_state_specs(pt.param_specs(cfg))
    assert [tuple(s) for s in jax.tree.leaves(got)] == [
        tuple(s) for s in jax.tree.leaves(
            want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]


def test_zero_loss_decreases():
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 3)
    tokens, targets = _batch(4)
    losses, _, _ = _run_port(cfg, _pmesh(4, 1), AdamConfig(lr=0.02), tree,
                             tokens, targets, steps=6)
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("step", [1, 5, 10, 60, 110, 500])
def test_schedule_lr_warmup_cosine(step):
    """Warmup, the cosine's midpoint and its floor, and the constant rate,
    equal to JAX's (``tests/test_zero.py:171``)."""
    adam = dict(lr=1.0, warmup_steps=10, decay_steps=110, min_lr_ratio=0.1)
    got = schedule_lr(AdamConfig(**adam), step)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(jz.schedule_lr(
        jz.AdamConfig(**adam), step)), rel=1e-6, abs=1e-7)
    expect = {5: 0.5, 10: 1.0, 60: 0.55, 110: 0.1, 500: 0.1}
    if step in expect:
        assert float(got) == pytest.approx(expect[step], abs=1e-6)
    assert float(schedule_lr(AdamConfig(lr=0.3), 1234)) == pytest.approx(0.3)
    assert float(schedule_lr(AdamConfig(lr=1.0),
                             torch.tensor(step, dtype=torch.int32))) == 1.0


def test_zero_adamw_decays_matrices_not_vectors():
    """AdamW's decay shrinks matrices even at zero gradient and leaves 1-D
    leaves alone; the step equals JAX's (``tests/test_zero.py:187``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 5)
    tokens = np.zeros((4, 8), np.int32)
    out = {}
    for wd in (0.5, 0.0):
        out[wd] = _run_port(cfg, _pmesh(4, 1),
                            AdamConfig(lr=0.1, weight_decay=wd), tree,
                            tokens, tokens)
    w1 = [i for i, a in enumerate(jax.tree.leaves(tree))
          if a.shape == (32, 64)][0]
    assert np.linalg.norm(out[0.5][1][w1]) < np.linalg.norm(out[0.0][1][w1])
    for i, a in enumerate(jax.tree.leaves(tree)):
        if a.ndim == 1:
            np.testing.assert_array_equal(out[0.5][1][i], out[0.0][1][i])
    # against JAX at eps 1e-3: at 1e-8 the first step is lr * sign(g) on
    # near-zero gradients, and reduction order flips a few such signs
    # (tests/test_zero.py:290-294)
    adam = dict(lr=0.1, weight_decay=0.5, eps=1e-3)
    want = _run_jax(jcfg, _jmesh(4, 1), jz.AdamConfig(**adam), tree, tokens,
                    tokens)
    _close(_run_port(cfg, _pmesh(4, 1), AdamConfig(**adam), tree, tokens,
                     tokens)[1], want[1])


def test_zero_schedule_applies_inside_step():
    """A long warmup leaves the first step tiny: the schedule reads the
    state's step counter (``tests/test_zero.py:221``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 6)
    tokens, targets = _batch(7, B=4, T=8)

    def delta(adam):
        _, p, _ = _run_port(cfg, _pmesh(4, 1), adam, tree, tokens, targets)
        return float(np.abs(p[0] - jax.tree.leaves(tree)[0]).max())

    assert delta(AdamConfig(lr=0.1, warmup_steps=1000)) < delta(
        AdamConfig(lr=0.1)) / 100


def test_schedule_rejects_decay_before_warmup():
    with pytest.raises(ValueError, match="must exceed warmup"):
        schedule_lr(AdamConfig(warmup_steps=100, decay_steps=50), 1)


def test_step_builder_rejects_bad_schedule():
    _, cfg = _configs()
    with pytest.raises(ValueError, match="must exceed warmup"):
        make_zero_train_step(cfg, _pmesh(4, 1),
                             AdamConfig(warmup_steps=100, decay_steps=50))
    with pytest.raises(ValueError, match="unknown attention impl"):
        make_zero_train_step(jt.TransformerConfig(attention="dave"),
                             _pmesh(4, 1))
    with pytest.raises(ValueError, match="accum_steps"):
        make_zero_train_step(cfg, _pmesh(4, 1), accum_steps=0)


@pytest.mark.parametrize("clip", [0.05, 1e6])
def test_zero_clip_matches_unsharded(clip):
    """Global-norm clipping, clipping (0.05) and a no-op (1e6): three steps
    equal JAX's and unsharded clipped Adam (``tests/test_zero.py:257``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 0)
    tokens, targets = _batch(1)
    adam = AdamConfig(lr=0.01, clip_grad_norm=clip)
    want = _run_jax(jcfg, _jmesh(4, 1), jz.AdamConfig(lr=0.01,
                                                      clip_grad_norm=clip),
                    tree, tokens, targets, steps=3)
    got = _run_port(cfg, _pmesh(4, 1), adam, tree, tokens, targets, steps=3)
    _close(got[1], want[1])
    _close(got[1], _reference_adam(cfg, tree, tokens, targets, adam, 3,
                                   clip=clip))


def test_clip_by_global_norm_equals_jax():
    """The function alone: norm and clipped leaves equal JAX's (called
    with no mesh axis, where its psums are absent)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 8)
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    want, wnorm = jz.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), jt.param_specs(jcfg), 1.0)
    got, norm = clip_by_global_norm(params_from_numpy(grads, device="cpu"),
                                    pt.param_specs(cfg), 1.0, "tp", "dp")
    assert float(norm) == pytest.approx(float(wnorm), rel=1e-6)
    _close(jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(
        jax.tree.map(np.asarray, want)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("accum,B", [(2, 8), (4, 16)])
def test_zero_accumulation_matches_full_batch(accum, B):
    """Microbatched gradients (one optimizer step) equal the full batch's
    step and JAX's accumulated step (``tests/test_zero.py:282``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 2)
    tokens, targets = _batch(3, B=B)
    adam = AdamConfig(lr=0.01, eps=1e-3, clip_grad_norm=1.0)
    full = _run_port(cfg, _pmesh(4, 1), adam, tree, tokens, targets)
    got = _run_port(cfg, _pmesh(4, 1), adam, tree, tokens, targets,
                    accum=accum)
    assert got[0][0] == pytest.approx(full[0][0], rel=1e-6)
    _close(got[1], full[1], rtol=1e-5, atol=1e-6)
    want = _run_jax(jcfg, _jmesh(4, 1), jz.AdamConfig(lr=0.01, eps=1e-3,
                                                      clip_grad_norm=1.0),
                    tree, tokens, targets, accum=accum)
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-6)
    _close(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_zero_accumulation_rejects_ragged_batch():
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 2)
    tokens, targets = _batch(3)
    with pytest.raises(ValueError, match="divide|accum"):
        _run_port(cfg, _pmesh(4, 1), AdamConfig(), tree, tokens, targets,
                  accum=3)


def test_master_weights_state_and_f32_noop():
    """With float32 parameters the master track is exact: the step is the
    plain step, bit for bit, and the state gains float32 ``w`` in the
    moments' layout (``tests/test_zero.py:330``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 6)
    tokens, targets = _batch(7)
    plain = _run_port(cfg, _pmesh(4, 1), AdamConfig(lr=0.01), tree, tokens,
                      targets)
    master = _run_port(cfg, _pmesh(4, 1),
                       AdamConfig(lr=0.01, master_weights=True), tree,
                       tokens, targets)
    w = master[2]["w"]["embed"]
    assert w.dtype == torch.float32
    assert w.shape == master[2]["m"]["embed"].shape
    assert plain[0] == master[0]
    for a, b in zip(plain[1], master[1]):
        np.testing.assert_array_equal(a, b)


def test_master_weights_keep_sub_ulp_updates():
    """Updates far below bfloat16's ulp accumulate on the master track
    while the plain bfloat16 step loses them (``tests/test_zero.py:410``)."""
    jcfg, cfg = _configs("bfloat16", n_layers=1)
    tree = _tree(jcfg, 10)
    tokens, targets = _batch(11)
    plain = _run_port(cfg, _pmesh(4, 1), AdamConfig(lr=3e-7), tree, tokens,
                      targets, steps=5)
    master = _run_port(cfg, _pmesh(4, 1),
                       AdamConfig(lr=3e-7, master_weights=True), tree,
                       tokens, targets, steps=5)
    for a, b in zip(jax.tree.leaves(tree), plain[1]):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        big = np.abs(a) > 0.01
        np.testing.assert_array_equal(a[big], b[big])
    _, shard, init = make_zero_train_step(
        cfg, _pmesh(4, 1), AdamConfig(lr=3e-7, master_weights=True))
    w0 = pt._tree_leaves(init(shard(params_from_numpy(tree, device="cpu")))
                         ["w"])
    moved = max(float((a - b).abs().max())
                for a, b in zip(w0, pt._tree_leaves(master[2]["w"])))
    assert moved > 1e-7, moved


@pytest.mark.parametrize("n,old,new", [(10, 4, 3), (10, 3, 4), (7, 2, 5),
                                       (0, 3, 2), (16, 4, 4), (5, 1, 8)])
def test_reshard_plan_equals_jax(n, old, new):
    assert reshard_plan(n, old, new) == jz.reshard_plan(n, old, new)


def test_layout_helpers_equal_jax():
    x = np.arange(10, dtype=np.float32).reshape(2, 5) - 3.5
    assert pz._padded(10, 4) == jz._padded(10, 4) == 12
    for idx in range(4):
        np.testing.assert_array_equal(
            pz._dp_slice(torch.from_numpy(x), 4, idx).numpy(),
            np.asarray(jz._dp_slice(jnp.asarray(x), 4, idx)))
    np.testing.assert_array_equal(
        pz._pad_flat(torch.from_numpy(x), 12, torch.float32).numpy(),
        np.asarray(jz._pad_flat(jnp.asarray(x), 12, jnp.float32)))
    with pytest.raises(ValueError, match="n >= 0"):
        reshard_plan(-1, 2, 2)
