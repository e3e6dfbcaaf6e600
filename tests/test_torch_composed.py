"""The port's composed pp x dp x tp train step against the JAX package's.

``accl_tpu_torch.models.composed.make_pp_train_step`` runs on a ``("pp",
"dp", "tp")`` mesh of virtual ranks with tp = 1; JAX's runs under
``shard_map`` on the same shape of the conftest's 8 CPU devices.  The
parameters come from JAX's ``init_params`` (carried by
``params_from_numpy``), the tokens from a numpy seed; on the CPU the
port's attention is the plain one.  The cases mirror
``tests/test_moe_pipeline.py:431-650`` at tp = 1 (its tp = 2 cases and
the missing-transpose detector at :749 wait for ROADMAP B14).  Tolerances
are JAX's: loss rel 1e-5, parameters rtol 2e-4 / atol 2e-5, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.compat import has_modern_vma
from accl_tpu.models import composed as jc
from accl_tpu.models import transformer as jt
from accl_tpu.parallel import zero as jz
from accl_tpu_torch.models import (
    TransformerConfig,
    interleave_layer_order,
    make_pp_train_step,
    params_from_numpy,
    params_to_numpy,
    stack_params,
    unstack_params,
)
from accl_tpu_torch.models import composed as tc
from accl_tpu_torch.models import transformer as pt
from accl_tpu_torch.ops.driver import make_mesh
from accl_tpu_torch.parallel import AdamConfig

pytestmark = pytest.mark.skipif(
    not has_modern_vma(),
    reason="the JAX composed step needs modern shard_map varying-axis "
           "semantics",
)

LOSS_RTOL = 1e-5
TOL = dict(rtol=2e-4, atol=2e-5)
BASE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, max_seq=32,
            attention="naive")
#: (pp, dp, tp), layers, microbatches, batch, sequence
CASES = {
    "pp2xdp4": ((2, 4, 1), 2, 2, 8, 16),
    "pp4xdp2": ((4, 2, 1), 4, 2, 8, 16),
    "pp8xdp1": ((8, 1, 1), 8, 4, 4, 8),  # one layer a stage
}


def _cfgs(n_layers, **kw):
    fields = {**BASE, "n_layers": n_layers, **kw}
    return (jt.TransformerConfig(**fields),
            TransformerConfig(dtype=torch.float32, **fields))


def _batch(B, T, seed=1):
    tokens = np.random.default_rng(seed).integers(
        0, BASE["vocab"], (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jmesh(shape):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape),
                ("pp", "dp", "tp"))


def _pmesh(shape):
    return make_mesh(shape, "cpu", axes=("pp", "dp", "tp"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree(got, want, **tol):
    """Leaf by leaf, matched by key (a JAX tree's keys are sorted)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree(got[k], want[k], **tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree(g, w, **tol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def trees():
    """JAX's initial trees by depth, as numpy."""
    out = {}
    for L in (2, 4, 8):
        jcfg, _ = _cfgs(L)
        out[L] = _np(jt.init_params(jax.random.PRNGKey(0), jcfg))
    return out


def _run_jax(jcfg, shape, M, tree, tokens, targets, **kw):
    made = jc.make_pp_train_step(jcfg, _jmesh(shape), num_microbatches=M,
                                 lr=0.05, **kw)
    step, shard = made[:2]
    if kw.get("adam") is not None:
        p, s, loss = step(shard(tree), made[2](tree), tokens, targets)
        return _np(p), _np(s), float(loss)
    p, loss = step(shard(tree), tokens, targets)
    return _np(p), None, float(loss)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_composed_step_equals_jax(trees, case, schedule):
    """The loss and the updated stacked parameters equal JAX's on each
    mesh and schedule; the port's invariant error sits at its floor."""
    shape, L, M, B, T = CASES[case]
    jcfg, pcfg = _cfgs(L)
    tokens, targets = _batch(B, T)
    jp, _, jl = _run_jax(jcfg, shape, M, trees[L], tokens, targets,
                         schedule=schedule)
    step, shard = make_pp_train_step(pcfg, _pmesh(shape), M, lr=0.05,
                                     schedule=schedule, debug_invariants=True)
    params, loss, inv = step(shard(params_from_numpy(trees[L], "cpu")),
                             _t(tokens), _t(targets))
    assert float(loss) == pytest.approx(jl, rel=LOSS_RTOL)
    assert float(inv) <= 1e-6
    _assert_tree(params_to_numpy(params), jp, **TOL)


def test_composed_interleaved_equals_jax(trees):
    """v_stages = 2 on (2, 4, 1): the stack committed in device-major
    chunk order (:func:`interleave_layer_order`), the step equal to
    JAX's."""
    jcfg, pcfg = _cfgs(4)
    tokens, targets = _batch(8, 16)
    jp, _, jl = _run_jax(jcfg, (2, 4, 1), 2, trees[4], tokens, targets,
                         v_stages=2)
    step, shard = make_pp_train_step(pcfg, _pmesh((2, 4, 1)), 2, lr=0.05,
                                     v_stages=2)
    params, loss = step(shard(params_from_numpy(trees[4], "cpu")),
                        _t(tokens), _t(targets))
    assert float(loss) == pytest.approx(jl, rel=LOSS_RTOL)
    _assert_tree(params_to_numpy(params), jp, **TOL)


def test_composed_interleaved_deep_equals_the_flagship(trees):
    """v_stages = 2 on (4, 2, 1) (8 layers, each rank two round-robin
    chunks of one): the step equals the port's flagship step on (2, 1),
    which ``tests/test_torch_training.py`` holds to JAX's."""
    _, pcfg = _cfgs(8)
    tokens, targets = _batch(8, 16)
    tree = params_from_numpy(trees[8], "cpu")
    fstep, fshard = pt.make_sharded_train_step(
        pcfg, 0.05, make_mesh((2, 1), "cpu", axes=("dp", "tp")))
    fp, fl = fstep(fshard(tree), _t(tokens), _t(targets))
    step, shard = make_pp_train_step(pcfg, _pmesh((4, 2, 1)), 4, lr=0.05,
                                     v_stages=2)
    params, loss = step(shard(tree), _t(tokens), _t(targets))
    assert float(loss) == pytest.approx(float(fl), rel=LOSS_RTOL)
    perm = interleave_layer_order(8, 4, 2)
    assert perm == jc.interleave_layer_order(8, 4, 2)
    assert torch.equal(shard(tree)["layers"]["wq"][1],
                       tree["layers"][perm[1]]["wq"])
    inv = np.argsort(perm)
    got = dict(params, layers={k: a[inv] for k, a in
                               params["layers"].items()})
    _assert_tree(params_to_numpy(unstack_params(got)), params_to_numpy(fp),
                 **TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_composed_zero_adam_equals_jax(trees, schedule):
    """The ZeRO-1 Adam form (clip and master weights included): the
    parameters and the whole state (m, v, w, step in JAX's flat dp-sliced
    layout inside the stage split) equal JAX's after a step."""
    jcfg, pcfg = _cfgs(2)
    tokens, targets = _batch(8, 16)
    kw = dict(lr=0.01, eps=1e-3, clip_grad_norm=1.0, master_weights=True)
    jp, js, jl = _run_jax(jcfg, (2, 4, 1), 2, trees[2], tokens, targets,
                          schedule=schedule, adam=jz.AdamConfig(**kw))
    step, shard, init_state = make_pp_train_step(
        pcfg, _pmesh((2, 4, 1)), 2, schedule=schedule,
        adam=AdamConfig(**kw), debug_invariants=True)
    tree = params_from_numpy(trees[2], "cpu")
    params, state, loss, inv = step(shard(tree), init_state(tree),
                                    _t(tokens), _t(targets))
    assert float(loss) == pytest.approx(jl, rel=LOSS_RTOL)
    assert float(inv) <= 1e-6
    _assert_tree(params_to_numpy(params), jp, **TOL)
    _assert_tree(params_to_numpy(state), js, **TOL)


def test_composed_carries_jax_stacked_tree_and_state(trees):
    """Weights carried from JAX's stacked layouts: JAX's committed
    (interleaved-permuted) tree and its ZeRO state go into the port's step
    by ``params_from_numpy`` and give JAX's next step."""
    jcfg, pcfg = _cfgs(4)
    tokens, targets = _batch(8, 16, seed=3)
    adam = dict(lr=0.01, eps=1e-3)
    jstep, jshard, jinit = jc.make_pp_train_step(
        jcfg, _jmesh((2, 4, 1)), num_microbatches=2, v_stages=2,
        adam=jz.AdamConfig(**adam))
    jparams, jstate = jshard(trees[4]), jinit(trees[4])
    stacked, state0 = _np(jparams), _np(jstate)
    jp, js, jl = jstep(jparams, jstate, tokens, targets)
    step, _, _ = make_pp_train_step(pcfg, _pmesh((2, 4, 1)), 2, v_stages=2,
                                    adam=AdamConfig(**adam))
    params, state, loss = step(params_from_numpy(stacked, "cpu"),
                               params_from_numpy(state0, "cpu"), _t(tokens),
                               _t(targets))
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _assert_tree(params_to_numpy(params), _np(jp), **TOL)
    _assert_tree(params_to_numpy(state), _np(js), **TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_sgd_step_takes_either_key_order(trees, schedule):
    """A tree carried from JAX has its keys sorted (``layers`` before
    ``ln_f``); the port's stacks ``layers`` last.  The step updates each
    leaf by its own gradient in either order."""
    _, pcfg = _cfgs(2)
    tokens, targets = _batch(8, 16)
    step, shard = make_pp_train_step(pcfg, _pmesh((2, 4, 1)), 2, lr=0.05,
                                     schedule=schedule)
    ours = shard(params_from_numpy(trees[2], "cpu"))
    assert list(ours) == ["embed", "ln_f", "pos", "layers"]
    theirs = {k: ours[k].clone() if k != "layers" else
              {n: a.clone() for n, a in ours[k].items()}
              for k in sorted(ours)}
    a, _ = step(ours, _t(tokens), _t(targets))
    b, _ = step(theirs, _t(tokens), _t(targets))
    _assert_tree(params_to_numpy(b), params_to_numpy(a), rtol=0, atol=0)


def test_stack_and_specs_equal_jax(trees):
    """``stack_params`` / ``unstack_params`` and the stacked specs are
    JAX's; the stacked and unstacked layouts round-trip exactly."""
    jcfg, pcfg = _cfgs(4)
    tree = params_from_numpy(trees[4], "cpu")
    stacked = stack_params(tree)
    _assert_tree(params_to_numpy(stacked), _np(jc.stack_params(trees[4])),
                 rtol=0, atol=0)
    _assert_tree(params_to_numpy(unstack_params(stacked)), trees[4],
                 rtol=0, atol=0)
    jspecs = jc.stacked_param_specs(jcfg)
    pspecs = tc.stacked_param_specs(pcfg)
    for k, s in jspecs["layers"].items():
        assert tuple(pspecs["layers"][k]) == tuple(s)
    assert tuple(pspecs["embed"]) == tuple(jspecs["embed"])
    assert sorted(pspecs) == sorted(jspecs)


def _bits(x):
    x = np.asarray(x)
    return x.dtype, x.shape, x.tobytes()


def _assert_bits(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_bits(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_bits(g, w)
    else:
        assert _bits(got) == _bits(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["stacked", "interleaved", "zero_state"])
def test_layouts_round_trip(layout, dtype):
    """``params_from_numpy`` / ``params_to_numpy`` carry JAX's stacked
    tree, its interleave-permuted form and the composed ZeRO state (with
    master weights and the 0-d int32 step) there and back bit for bit."""
    jcfg = jt.TransformerConfig(**BASE, n_layers=4,
                                dtype=getattr(jnp, dtype))
    tree = _np(jt.init_params(jax.random.PRNGKey(5), jcfg))
    if layout == "stacked":
        want = dict(tree, layers={k: np.stack([lp[k] for lp in tree["layers"]])
                                  for k in tree["layers"][0]})
    else:
        made = jc.make_pp_train_step(
            jcfg, _jmesh((2, 4, 1)), num_microbatches=2,
            v_stages=2 if layout == "interleaved" else 1,
            adam=jz.AdamConfig(master_weights=True))
        want = _np(made[1](tree) if layout == "interleaved"
                   else made[2](tree))
    back = params_to_numpy(params_from_numpy(want, "cpu"))
    _assert_bits(back, want)


def test_debug_invariants_catch_a_missing_psum(trees, monkeypatch):
    """The invariant error reads every rank's own copy: with the
    gradients' psum over pp dropped (each rank keeping its own
    contribution), the embedding's copies differ at the gradient's
    magnitude."""
    _, pcfg = _cfgs(2)
    tokens, targets = _batch(8, 16)
    real = tc._psum

    def no_pp(grid, axis, every):
        ref = next(t for row in grid for t in row if t is not None)
        if axis == 0 and ref.dim():  # a gradient's: nothing held stays 0
            return [[torch.zeros_like(ref) if t is None else t for t in row]
                    for row in grid]
        return real(grid, axis, every)

    monkeypatch.setattr(tc, "_psum", no_pp)
    for schedule in ("gpipe", "1f1b"):
        step, shard = make_pp_train_step(pcfg, _pmesh((2, 4, 1)), 2,
                                         schedule=schedule,
                                         debug_invariants=True)
        _, _, inv = step(shard(params_from_numpy(trees[2], "cpu")),
                         _t(tokens), _t(targets))
        assert float(inv) > 1e-4


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_debug_invariants_floor_on_non_pow2_axis(trees, schedule):
    """:838: on dp = 3 each rank's ring-order sums may part in the last
    bits; the invariant error stays at that floor (<= 1e-6), far under a
    misplaced psum's gradient-sized signal."""
    _, pcfg = _cfgs(2)
    tokens, targets = _batch(6, 16)
    step, shard = make_pp_train_step(pcfg, _pmesh((2, 3, 1)), 2, lr=0.05,
                                     schedule=schedule,
                                     debug_invariants=True)
    _, loss, inv = step(shard(params_from_numpy(trees[2], "cpu")),
                        _t(tokens), _t(targets))
    assert np.isfinite(float(loss))
    assert float(inv) <= 1e-6


def test_composed_refusals_and_divisibility():
    """JAX's refusals with JAX's messages (:237-283, :636), then the
    port's: dense tp > 1 waits for ROADMAP B14."""
    _, pcfg = _cfgs(2)
    mesh = _pmesh((2, 4, 1))
    with pytest.raises(ValueError, match="must divide"):
        make_pp_train_step(dataclasses.replace(pcfg, n_layers=3), mesh, 2)
    with pytest.raises(ValueError, match="unknown composed"):
        make_pp_train_step(pcfg, mesh, 2, schedule="dave")
    with pytest.raises(ValueError, match="does not compose"):
        make_pp_train_step(pcfg, mesh, 2, schedule="1f1b", v_stages=2)
    with pytest.raises(ValueError, match="must be >= 1"):
        make_pp_train_step(pcfg, mesh, 2, v_stages=0)
    with pytest.raises(ValueError, match="context_parallel is supported"):
        make_pp_train_step(dataclasses.replace(pcfg, context_parallel=True),
                           mesh, 2)
    with pytest.raises(ValueError, match="n_experts"):
        make_pp_train_step(dataclasses.replace(pcfg, n_experts=4), mesh, 2)
    # the configs the port refuses at construction, reached by hand
    for field, msg in (("seq_parallel", "does not compose with seq_parallel"),
                       ("vocab_parallel", "vocab_parallel is supported")):
        cfg = dataclasses.replace(pcfg)
        object.__setattr__(cfg, field, True)
        with pytest.raises(ValueError, match=msg):
            make_pp_train_step(cfg, mesh, 2)
    with pytest.raises(ValueError, match=r"n_heads \(4\) must divide by tp"):
        make_pp_train_step(pcfg, _pmesh((1, 1, 3)), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP B14"):
        make_pp_train_step(pcfg, _pmesh((2, 2, 2)), 2)
    with pytest.raises(ValueError, match="axes"):
        make_pp_train_step(pcfg, make_mesh((2, 4), "cpu", axes=("dp", "tp")),
                           2)
    step, shard = make_pp_train_step(pcfg, mesh, 4)
    tree = shard(params_from_numpy(
        _np(jt.init_params(jax.random.PRNGKey(0), _cfgs(2)[0])), "cpu"))
    tokens, targets = _batch(8, 16)
    with pytest.raises(ValueError, match=r"per-dp-rank batch \(2\) must "
                                         r"divide into num_microbatches"):
        step(tree, _t(tokens), _t(targets))
