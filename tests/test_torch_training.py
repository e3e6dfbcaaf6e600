"""The port's training path against the JAX package's.

``accl_tpu_torch.models`` adds ``loss_fn`` and ``make_sharded_train_step``
(one SGD step on one device) to the serving path.  The JAX package's own
small configurations (``tests/test_models.py``'s ``cfg`` fixture and its
GQA and rope variants) are initialised by JAX and carried across with
``params_from_numpy``; the same numpy-seeded tokens, and targets rolled
by one, go through both.  In float32 the loss agrees within 1e-5
relative and the gradients within rtol 2e-3, atol 2e-5 under every
attention lowering, the JAX tests' tolerances for the same comparison
(``tests/test_models.py:115-118``); the JAX flash lowering runs its
interpreted Pallas kernels, the port's its plain versions (CPU tensors).
The updated parameters come back through ``params_to_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.models import transformer as jt
from accl_tpu_torch.models import (
    TransformerConfig,
    init_params,
    loss_fn,
    make_sharded_train_step,
    params_from_numpy,
    params_to_numpy,
)
from accl_tpu_torch.models.transformer import sgd_update_
from accl_tpu_torch.ops.driver import make_mesh

GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32)
VARIANTS = {
    "learned": {},
    "gqa": dict(n_kv_heads=2),
    "rope": dict(pos_embedding="rope", n_kv_heads=2),
}


def _configs(variant="learned", **kw):
    """(JAX config, port config) of one variant; ``dtype`` by name."""
    dtype = kw.pop("dtype", "float32")
    fields = {**BASE, **VARIANTS[variant], **kw}
    return (jt.TransformerConfig(dtype=getattr(jnp, dtype), **fields),
            TransformerConfig(dtype=getattr(torch, dtype), **fields))


def _batch(seed, B=4, T=16):
    """numpy tokens (B, T) and their next-token targets."""
    tokens = np.random.default_rng(seed).integers(
        0, BASE["vocab"], (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _cpu_mesh():
    return make_mesh(1, device="cpu")


def _jax_step(jcfg, jp, tokens, targets, lr):
    """One JAX train step on a (1, 1) mesh; (new params, loss) as numpy."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    step, shard = jt.make_sharded_train_step(jcfg, mesh, lr=lr)
    new, loss = step(shard(jp), jnp.asarray(tokens), jnp.asarray(targets))
    return jax.tree.map(np.asarray, new), float(loss)


def _skip_unless_runnable(impl):
    """The JAX flash lowering off the TPU needs the TPU interpret mode."""
    import jax.experimental.pallas.tpu as pltpu

    if impl == "flash" and jax.default_backend() != "tpu" and not hasattr(
        pltpu, "InterpretParams"
    ):
        pytest.skip("flash kernel needs Mosaic or pallas TPU interpret mode")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("impl", ["naive", "blockwise", "flash"])
def test_loss_and_grads_equal_jax(impl, variant):
    _skip_unless_runnable(impl)
    jcfg, cfg = _configs(variant, attention=impl)
    jp = jt.init_params(jax.random.PRNGKey(2), jcfg)
    tokens, targets = _batch(3)
    want_loss, want_grads = jax.value_and_grad(jt.loss_fn)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = jax.tree.leaves(params)  # the JAX tree's order
    for p in leaves:
        p.requires_grad_()
    loss = loss_fn(params, torch.from_numpy(tokens),
                   torch.from_numpy(targets), cfg)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    for p, g in zip(leaves, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   **GRAD_TOL)


def test_train_step_equals_jax():
    """One step on a (1, 1) mesh: the same loss and the same updated
    parameters, written into the sharded tree's own storage while the
    tree given to ``shard`` stays as it was."""
    jcfg, cfg = _configs()
    jp = jt.init_params(jax.random.PRNGKey(4), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tokens, targets = _batch(5)
    want, want_loss = _jax_step(jcfg, jp, tokens, targets, 0.05)

    step, shard = make_sharded_train_step(cfg, lr=0.05, mesh=_cpu_mesh())
    source = params_from_numpy(tree, device="cpu")
    params = shard(source)
    ptrs = [p.data_ptr() for p in jax.tree.leaves(params)]
    out, loss = step(params, torch.from_numpy(tokens),
                     torch.from_numpy(targets))
    assert out is params and not loss.requires_grad
    assert [p.data_ptr() for p in jax.tree.leaves(out)] == ptrs
    assert not any(p.requires_grad for p in jax.tree.leaves(out))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(out)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(source)),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _one_step(cfg, tree, tokens, targets, lr=0.05):
    step, shard = make_sharded_train_step(cfg, lr=lr, mesh=_cpu_mesh())
    out, loss = step(shard(params_from_numpy(tree, device="cpu")),
                     torch.from_numpy(tokens), torch.from_numpy(targets))
    return float(loss), jax.tree.leaves(params_to_numpy(out))


def test_lowerings_take_the_same_step():
    """Same loss and same updated params whichever attention lowering the
    step runs (``tests/test_models.py:447``'s tolerances)."""
    jcfg, cfg = _configs()
    tree = jax.tree.map(np.asarray,
                        jt.init_params(jax.random.PRNGKey(42), jcfg))
    tokens, targets = _batch(43)
    outs = [_one_step(dataclasses.replace(cfg, attention=impl), tree,
                      tokens, targets)
            for impl in ("naive", "blockwise", "flash")]
    for loss, leaves in outs[1:]:
        assert loss == pytest.approx(outs[0][0], rel=1e-5)
        for a, b in zip(outs[0][1], leaves):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_remat_step_equals_plain(impl):
    """remat recomputes each block on the backward pass (the flash
    forward runs twice); it changes the schedule, not the math
    (``tests/test_models.py:122``'s tolerances)."""
    jcfg, cfg = _configs(attention=impl)
    tree = jax.tree.map(np.asarray,
                        jt.init_params(jax.random.PRNGKey(4), jcfg))
    tokens, targets = _batch(5)
    plain = _one_step(cfg, tree, tokens, targets)
    remat = _one_step(dataclasses.replace(cfg, remat=True), tree, tokens,
                      targets)
    assert remat[0] == pytest.approx(plain[0], rel=1e-6)
    for a, b in zip(plain[1], remat[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_loss_falls_over_five_steps():
    _, cfg = _configs()
    step, shard = make_sharded_train_step(cfg, lr=0.1, mesh=_cpu_mesh())
    params = shard(init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu"))
    tokens, targets = (torch.from_numpy(a) for a in _batch(1))
    losses = []
    for _ in range(5):
        params, loss = step(params, tokens, targets)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_bfloat16_step_near_jax():
    """bfloat16 weights and activations: the two frameworks round matmul
    outputs and the layer norms' statistics at different places, so the
    logits differ by a few bf16 ulps; the loss (log-softmax in float32 on
    both sides) is held within 5e-4 relative (measured: 3.5e-5).  The
    gradients inherit those differences, so an updated weight, p - lr g
    rounded to bfloat16, may land one ulp from JAX's: held within rtol
    1e-2 and atol 2.5e-4, one ulp of weights in [2^-5, 2^-4) (measured: up
    to one ulp on under 10 % of entries)."""
    jcfg, cfg = _configs(dtype="bfloat16")
    jp = jt.init_params(jax.random.PRNGKey(6), jcfg)
    tokens, targets = _batch(7)
    want, want_loss = _jax_step(jcfg, jp, tokens, targets, 0.05)
    loss, leaves = _one_step(cfg, jax.tree.map(np.asarray, jp), tokens,
                             targets)
    assert loss == pytest.approx(want_loss, rel=5e-4)
    for a, b in zip(leaves, jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.astype(np.float32),
                                   b.astype(np.float32), rtol=1e-2,
                                   atol=2.5e-4)


def test_train_step_refusals():
    _, cfg = _configs()
    with pytest.raises(NotImplementedError, match="ROADMAP B14"):
        make_sharded_train_step(cfg, mesh=make_mesh(2, device="cpu"))
    with pytest.raises(TypeError, match="lr must be a number"):
        make_sharded_train_step(cfg, _cpu_mesh())  # the JAX argument order
    with pytest.raises(ValueError, match="unknown attention impl"):
        make_sharded_train_step(dataclasses.replace(cfg, attention="dave"),
                                mesh=_cpu_mesh())
    with pytest.raises(ValueError, match="unknown attention impl"):
        # a config built elsewhere (the JAX one does not validate it)
        make_sharded_train_step(jt.TransformerConfig(attention="dave"),
                                mesh=_cpu_mesh())


@pytest.mark.parametrize(
    "lr", [np.float32(0.05), np.float64(0.05), torch.tensor(0.05),
           torch.tensor(0.05, dtype=torch.float64)],
    ids=["np.float32", "np.float64", "tensor", "tensor-f64"])
def test_train_step_takes_any_real_scalar_lr(lr):
    """A NumPy or 0-d tensor learning rate takes the same float32 step as
    the Python float, bit for bit (JAX takes any scalar too)."""
    jcfg, cfg = _configs()
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(9),
                                                   jcfg))
    tokens, targets = _batch(10)
    want = _one_step(cfg, tree, tokens, targets, lr=0.05)
    got = _one_step(cfg, tree, tokens, targets, lr=lr)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["python", "np.float32", "np.float64",
                                  "bf16 scalar"])
def test_bfloat16_update_rounds_as_jax(kind):
    """The bfloat16 update against JAX's ``p - lr * g`` on the same
    weights and gradients: a Python lr is weakly typed (it becomes
    bfloat16); a float32 lr promotes the update to float32, where JAX
    returns float32 weights: the in-place update holds that result
    rounded to bfloat16."""
    import ml_dtypes

    rng = np.random.default_rng(11)
    p = rng.standard_normal(4096).astype(ml_dtypes.bfloat16)
    g = rng.standard_normal(4096).astype(ml_dtypes.bfloat16)
    lr = {"python": 0.0123, "np.float32": np.float32(0.0123),
          "np.float64": np.float64(0.0123),
          "bf16 scalar": jnp.asarray(0.0123, jnp.bfloat16)}[kind]
    want = np.asarray(jax.jit(lambda p, g: p - lr * g)(jnp.asarray(p),
                                                        jnp.asarray(g)))
    assert want.dtype == (np.float32 if kind.startswith("np")
                          else ml_dtypes.bfloat16)
    port_lr = (torch.tensor(0.0123, dtype=torch.bfloat16)
               if kind == "bf16 scalar" else lr)
    tp = torch.from_numpy(p.view(np.int16)).view(torch.bfloat16).clone()
    tg = torch.from_numpy(g.view(np.int16)).view(torch.bfloat16)
    sgd_update_([tp], [tg], port_lr)
    np.testing.assert_array_equal(
        tp.view(torch.int16).numpy(),
        want.astype(ml_dtypes.bfloat16).view(np.int16))


@pytest.mark.parametrize("lr", [torch.ones(2), np.ones(3), 1j, 0.1 + 0j,
                                np.complex64(1), "0.1", None])
def test_train_step_refuses_lr_by_name(lr):
    _, cfg = _configs()
    with pytest.raises(TypeError, match="lr must be a") as ei:
        make_sharded_train_step(cfg, lr=lr, mesh=_cpu_mesh())
    assert "mesh" not in str(ei.value)


def test_params_to_numpy_inverts_params_from_numpy():
    jcfg, _ = _configs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(8),
                                                   jcfg))
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
