"""The port's encoder family against the JAX package's.

``accl_tpu_torch.models.encoder`` is ``accl_tpu/models/encoder.py``: the
flagship's blocks with ``causal=False`` and a masked-LM head on the tied
unembedding, its step over a ``("dp", "tp")`` mesh of virtual ranks
whose tp is 1.  JAX's own small configurations (``tests/test_models.py``:
the ``cfg`` fixture and its rope variant) are initialised by JAX and
carried across with ``params_from_numpy``; tokens, targets and the MLM
mask come from a numpy seed.  Hidden states agree within rtol = atol =
2e-5 under every lowering (the JAX tests' bound for lowerings of the same
math, ``tests/test_models.py:528``; the JAX flash lowering runs its
interpreted Pallas kernels, the port's its plain versions on CPU
tensors), the step's loss within 1e-5 relative and its updated
parameters within rtol 2e-4, atol 2e-5 (:552-556).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.models import encoder as je
from accl_tpu.models import transformer as jt
from accl_tpu_torch.models import (
    TransformerConfig,
    encode,
    encoder_forward,
    forward,
    make_sharded_encoder_step,
    mlm_loss,
    params_from_numpy,
    params_to_numpy,
)
from accl_tpu_torch.ops.driver import make_mesh

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
#: tests/test_models.py's cfg fixture and its rope variant
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32)
ROPE = dict(pos_embedding="rope", n_kv_heads=2)


def _configs(**kw):
    fields = {**BASE, **kw}
    return jt.TransformerConfig(**fields), TransformerConfig(**fields)


def _params(jcfg, seed):
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))
    return tree, params_from_numpy(tree, device="cpu")


def _tokens(seed, B, T):
    return np.random.default_rng(seed).integers(0, BASE["vocab"],
                                                (B, T)).astype(np.int32)


def _mlm_batch(seed, B=4, T=16, rate=0.2):
    """(corrupted tokens, targets, mask): masked positions carry token 0,
    the [MASK] stand-in of ``tests/test_models.py:540``."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, BASE["vocab"], (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < rate).astype(np.float32)
    return np.where(mask.astype(bool), 0, targets).astype(np.int32), \
        targets, mask


def _jax_encoder(tree, tokens, jcfg):
    return np.asarray(jax.jit(lambda p, t: je.encoder_forward(p, t, jcfg))(
        tree, tokens))


def _skip_unless_runnable(impl):
    """The JAX flash lowering off the TPU needs the TPU interpret mode."""
    import jax.experimental.pallas.tpu as pltpu

    if impl == "flash" and jax.default_backend() != "tpu" and not hasattr(
        pltpu, "InterpretParams"
    ):
        pytest.skip("flash kernel needs Mosaic or pallas TPU interpret mode")


def test_encoder_is_bidirectional():
    """Changing the LAST token changes the FIRST position's hidden state,
    which the causal decoder forbids (``tests/test_models.py:500``); both
    hidden states equal JAX's."""
    jcfg, cfg = _configs()
    tree, params = _params(jcfg, 50)
    a = _tokens(51, 1, 16)
    b = a.copy()
    b[0, -1] = (a[0, -1] + 1) % cfg.vocab
    ha, hb = (encoder_forward(params, torch.from_numpy(t), cfg).numpy()
              for t in (a, b))
    assert np.abs(ha[0, 0] - hb[0, 0]).max() > 1e-6
    la, lb = (forward(params, torch.from_numpy(t), cfg).numpy()
              for t in (a, b))
    np.testing.assert_allclose(la[0, 0], lb[0, 0], rtol=1e-6)
    np.testing.assert_allclose(ha, _jax_encoder(tree, a, jcfg), **TOL)
    np.testing.assert_allclose(hb, _jax_encoder(tree, b, jcfg), **TOL)


@pytest.mark.parametrize("impl", ["naive", "blockwise", "flash"])
def test_encoder_attention_impls_match(impl):
    """Full attention under each lowering equals JAX's naive encoder
    (``tests/test_models.py:519``); T = 20 is ragged for every tile."""
    _skip_unless_runnable(impl)
    jcfg, cfg = _configs()
    tree, params = _params(jcfg, 52)
    tokens = _tokens(53, 2, 20)
    want = _jax_encoder(tree, tokens, dataclasses.replace(jcfg,
                                                          attention="naive"))
    got = encoder_forward(params, torch.from_numpy(tokens),
                          dataclasses.replace(cfg, attention=impl))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want = _jax_encoder(tree, tokens, dataclasses.replace(jcfg,
                                                          attention=impl))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_sharded_encoder_step_matches_single_device(dp):
    """The MLM step over (dp, 1) equals JAX's step on a (dp, 1) mesh and
    the unsharded step: the same loss (the dp sum of masked totals over
    the dp sum of counts) and the same updated parameters
    (``tests/test_models.py:532``)."""
    jcfg, cfg = _configs()
    tree, _ = _params(jcfg, 54)
    tokens, targets, mask = _mlm_batch(55)
    lr = 0.05
    loss_ref, grads = jax.jit(jax.value_and_grad(
        lambda p: je.mlm_loss(p, tokens, targets, mask, jcfg)))(tree)
    expected = jax.tree.map(lambda p, g: p - lr * g, tree, grads)
    jmesh = Mesh(np.array(jax.devices()[:dp]).reshape(dp, 1), ("dp", "tp"))
    jstep, jshard = je.make_sharded_encoder_step(jcfg, jmesh, lr=lr)
    jnew, jloss = jstep(jshard(tree), tokens, targets, mask)

    step, shard = make_sharded_encoder_step(
        cfg, lr=lr, mesh=make_mesh((dp, 1), axes=("dp", "tp"), device="cpu"))
    new, loss = step(shard(params_from_numpy(tree, device="cpu")),
                     torch.from_numpy(tokens), torch.from_numpy(targets),
                     torch.from_numpy(mask))
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = jax.tree.leaves(params_to_numpy(new))
    for want in (expected, jnew):
        for a, b in zip(got, jax.tree.leaves(jax.tree.map(np.asarray,
                                                          want))):
            np.testing.assert_allclose(a, b, **STEP_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.15, 1.0])
def test_mlm_loss_and_grads_equal_jax(rate):
    """``mlm_loss`` and its gradients equal JAX's, including a batch with
    no masked position (the count clamps at 1, so the loss is 0)."""
    jcfg, cfg = _configs()
    tree, params = _params(jcfg, 56)
    tokens, targets, mask = _mlm_batch(57, rate=rate)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p: je.mlm_loss(p, tokens, targets, mask, jcfg)))(tree)
    leaves = jax.tree.leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss = mlm_loss(params, torch.from_numpy(tokens),
                    torch.from_numpy(targets), torch.from_numpy(mask), cfg)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5,
                                                 abs=1e-7)
    for p, g in zip(leaves, jax.tree.leaves(wgrads)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   rtol=2e-3, atol=2e-5)


def test_encode_pools():
    """Pooled embeddings (B, d_model), finite, equal to JAX's
    (``tests/test_models.py:560``)."""
    jcfg, cfg = _configs()
    tree, params = _params(jcfg, 57)
    tokens = _tokens(58, 3, 12)
    emb = encode(params, torch.from_numpy(tokens), cfg).numpy()
    assert emb.shape == (3, cfg.d_model) and np.isfinite(emb).all()
    want = jax.jit(lambda p, t: je.encode(p, t, jcfg))(tree, tokens)
    np.testing.assert_allclose(emb, np.asarray(want), **TOL)


def test_rope_encoder_forward():
    """Rope flows through the non-causal blocks: hidden states equal
    JAX's, and one token at two positions of a varied sequence gets two
    states (``tests/test_models.py:923``)."""
    jcfg, cfg = _configs(**ROPE)
    tree, params = _params(jcfg, 19)
    toks = _tokens(20, 2, 12)
    h = encoder_forward(params, torch.from_numpy(toks), cfg).numpy()
    assert h.shape == (2, 12, cfg.d_model)
    np.testing.assert_allclose(h, _jax_encoder(tree, toks, jcfg), **TOL)
    varied = np.asarray([[7, 1, 2, 7, 3, 4, 5, 6, 8, 9, 10, 11]], np.int32)
    h2 = encoder_forward(params, torch.from_numpy(varied), cfg).numpy()
    assert not np.allclose(h2[0, 0], h2[0, 3], atol=1e-5)


def test_remat_encoder_step_equals_plain():
    """``remat`` recomputes each block on the backward pass: the step is
    the plain step."""
    jcfg, cfg = _configs()
    tree, _ = _params(jcfg, 59)
    tokens, targets, mask = _mlm_batch(60)
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        step, shard = make_sharded_encoder_step(c, lr=0.05,
                                                mesh=make_mesh(1, "cpu"))
        new, loss = step(shard(params_from_numpy(tree, device="cpu")),
                         torch.from_numpy(tokens), torch.from_numpy(targets),
                         torch.from_numpy(mask))
        out.append((float(loss), jax.tree.leaves(params_to_numpy(new))))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_encoder_refusals():
    """JAX's refusals, with its messages (``encoder.py:61-76``)."""
    _, cfg = _configs()
    tokens = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="decoder-only"):
        encoder_forward({}, tokens, dataclasses.replace(
            cfg, context_parallel=True))
    with pytest.raises(ValueError, match="decoder flagship only"):
        encoder_forward({}, tokens, dataclasses.replace(cfg, n_experts=4))
    vp = dataclasses.replace(cfg)
    object.__setattr__(vp, "vocab_parallel", True)  # refused at build
    with pytest.raises(ValueError, match="decoder flagship only"):
        encoder_forward({}, tokens, vp)
    with pytest.raises(ValueError, match="unknown attention impl"):
        make_sharded_encoder_step(jt.TransformerConfig(attention="dave"),
                                  mesh=make_mesh(1, "cpu"))
    step, _ = make_sharded_encoder_step(
        cfg, mesh=make_mesh((2, 1), axes=("dp", "tp"), device="cpu"))
    with pytest.raises(ValueError, match="must divide by dp"):
        step({"embed": torch.zeros(1)}, torch.zeros(3, 8, dtype=torch.int32),
             None, None)
