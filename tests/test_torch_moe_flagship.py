"""The flagship's experts (``n_experts``) against the JAX package's.

``accl_tpu_torch.models`` runs the makers on a ``("dp", "tp")`` mesh of
virtual ranks with the experts on dp, or on ``("dp", "ep", "tp")`` with a
dedicated expert axis, each data rank routing its own tokens with its
own capacity (and under context parallelism each (dp, ring) rank its
striped shard).  JAX runs the same makers under ``shard_map`` on the
conftest's virtual CPU devices (``(4, 1)``, ``(2, 2, 1)`` and the cp
mesh ``(2, 4)``).  Parameters come from JAX's ``init_params`` through
``params_from_numpy``, tokens from a numpy seed.  Tolerances are the JAX
tests' own for the same comparisons: logits rtol 2e-4, atol 2e-5
(``tests/test_models.py:1267``), the loss 1e-5 relative and the updated
parameters rtol 2e-3, atol 2e-5 (:1290-1294; 1e-4 relative for the loss
under cp, :1406); greedy tokens exactly.  Capacity factors below 1 make
tokens drop, so those cases hold the port's per-rank routing to JAX's
sharded programs, not to one device.
"""

import dataclasses

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

from accl_tpu.models import transformer as jt
from accl_tpu_torch.models import (
    TransformerConfig,
    forward,
    generate,
    init_params,
    loss_fn,
    make_sharded_forward,
    make_sharded_generate,
    make_sharded_train_step,
    params_from_numpy,
    params_to_numpy,
)
from accl_tpu_torch.models import transformer as pt
from accl_tpu_torch.ops.driver import make_mesh

LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
#: JAX's MoE fixture (``tests/test_models.py:1246``): capacity 4.0 drops
#: nothing
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32, n_experts=8, moe_capacity_factor=4.0,
            attention="naive")
LR = 0.05


def _configs(**kw):
    fields = {**BASE, **kw}
    return jt.TransformerConfig(**fields), TransformerConfig(**fields)


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


# ---------------------------------------------------------------------------
# the flagship (tests/test_models.py)
# ---------------------------------------------------------------------------


def test_moe_param_specs_and_init_tree_equal_jax():
    for kw in ({}, dict(moe_mesh_axis="ep"), dict(context_parallel=True)):
        jcfg, cfg = _configs(**kw)
        want = jax.tree.leaves(jt.param_specs(jcfg),
                               is_leaf=lambda s: isinstance(s, P))
        got = jax.tree.leaves(pt.param_specs(cfg))  # JAX's key order
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jax.tree.map(
        lambda a: tuple(a.shape), tree)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_flagship_forward_matches_single_device(cf):
    """The forward over (dp 4, tp 1), experts on dp, equals JAX's sharded
    forward on a (4, 1) mesh; with nothing dropped (capacity 4.0) also
    the one-rank forward of both (``tests/test_models.py:1256``)."""
    jcfg, cfg = _configs(moe_capacity_factor=cf)
    tree = _tree(jcfg, 20)
    tokens, _ = _batch(21, B=4)
    jfwd, jshard = jt.make_sharded_forward(jcfg, _jmesh(4, 1))
    want = np.asarray(jfwd(jshard(tree), jnp.asarray(tokens)))
    fwd, shard = make_sharded_forward(cfg, _pmesh(4, 1))
    params = shard(params_from_numpy(tree, device="cpu"))
    got = fwd(params, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    one = forward(params, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(one, np.asarray(jax.jit(
        lambda p, t: jt.forward(p, t, jcfg))(tree, tokens)), **LOGIT_TOL)
    if cf >= 1:
        np.testing.assert_allclose(got, one, **LOGIT_TOL)
    else:  # each rank's capacity drops tokens the one-rank forward keeps
        assert not np.allclose(got, one, **LOGIT_TOL)


@pytest.mark.parametrize("layout", ["ep", "cp"])
def test_moe_sharded_forward_on_ep_and_cp_meshes_equals_jax(layout):
    """The forward with tokens dropping (capacity 0.5) on a dedicated
    expert axis, (dp 2, ep 2, tp 1), and under cp, (dp 2, tp 4) with each
    (dp, ring) rank routing its striped shard: the logits equal JAX's
    sharded forward on the same meshes of CPU devices."""
    if layout == "ep":
        kw, shape, axes = dict(moe_mesh_axis="ep"), (2, 2, 1), (
            "dp", "ep", "tp")
    else:
        kw, shape, axes = dict(context_parallel=True), (2, 4), ("dp", "tp")
    jcfg, cfg = _configs(moe_capacity_factor=0.5, moe_top_k=2, **kw)
    tree = _tree(jcfg, 38)
    tokens, _ = _batch(39, B=4)
    jfwd, jshard = jt.make_sharded_forward(jcfg, _jmesh(*shape, axes=axes))
    want = np.asarray(jfwd(jshard(tree), jnp.asarray(tokens)))
    fwd, shard = make_sharded_forward(cfg, _pmesh(*shape, axes=axes))
    got = fwd(shard(params_from_numpy(tree, device="cpu")),
              torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def _jax_step(jcfg, mesh, tree, tokens, targets, lr=LR):
    step, shard = jt.make_sharded_train_step(jcfg, mesh, lr=lr)
    new, loss = step(shard(tree), jnp.asarray(tokens), jnp.asarray(targets))
    return float(loss), jax.tree.leaves(jax.tree.map(np.asarray, new))


def _port_step(cfg, mesh, tree, tokens, targets, lr=LR):
    step, shard = make_sharded_train_step(cfg, lr=lr, mesh=mesh)
    new, loss = step(shard(params_from_numpy(tree, device="cpu")),
                     torch.from_numpy(tokens), torch.from_numpy(targets))
    return float(loss), jax.tree.leaves(params_to_numpy(new))


def _assert_steps_close(got, want, rel=1e-5):
    assert got[0] == pytest.approx(want[0], rel=rel)
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, **PARAM_TOL)


@pytest.mark.parametrize("cf,k,aux", [(4.0, 1, False), (4.0, 2, True),
                                      (0.5, 2, True), (0.75, 1, False)])
def test_moe_flagship_train_matches_single_device(cf, k, aux):
    """One SGD step over (dp 4, tp 1), experts on dp, equals JAX's step on
    a (4, 1) mesh — loss and every updated parameter, the router penalty
    in each rank's local loss (``tests/test_models.py:1271``); with the
    penalty off and nothing dropped, also the one-rank step."""
    weights = {} if aux else dict(moe_aux_weight=0.0, moe_router_z_weight=0.0)
    jcfg, cfg = _configs(moe_capacity_factor=cf, moe_top_k=k, **weights)
    tree = _tree(jcfg, 22)
    tokens, targets = _batch(23)
    want = _jax_step(jcfg, _jmesh(4, 1), tree, tokens, targets)
    got = _port_step(cfg, _pmesh(4, 1), tree, tokens, targets)
    _assert_steps_close(got, want)
    if cf >= 1 and not aux:
        _assert_steps_close(_port_step(cfg, make_mesh(1, device="cpu"),
                                       tree, tokens, targets), want)


def test_moe_aux_terms_in_loss():
    """loss_fn adds the router penalty: positive, finite, and equal to
    JAX's loss with and without it (``tests/test_models.py:1299``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 24)
    tokens, targets = _batch(25, B=4)
    params = params_from_numpy(tree, device="cpu")
    bare_j = dataclasses.replace(jcfg, moe_aux_weight=0.0,
                                 moe_router_z_weight=0.0)
    bare = dataclasses.replace(cfg, moe_aux_weight=0.0,
                               moe_router_z_weight=0.0)
    t, y = torch.from_numpy(tokens), torch.from_numpy(targets)
    l0, l1 = float(loss_fn(params, t, y, bare)), float(loss_fn(params, t, y,
                                                                cfg))
    assert np.isfinite(l1) and l1 > l0
    for got, c in ((l0, bare_j), (l1, jcfg)):
        want = jax.jit(lambda p, t, y: jt.loss_fn(p, t, y, c))(
            tree, tokens, targets)
        assert got == pytest.approx(float(want), rel=1e-5)


def _naive_greedy(params, prompt, steps, cfg):
    """Greedy decode by re-running the whole forward every step."""
    seq = prompt
    for _ in range(steps):
        nxt = forward(params, seq, cfg)[:, -1].argmax(-1).to(seq.dtype)
        seq = torch.cat([seq, nxt[:, None]], 1)
    return seq[:, prompt.shape[1]:]


def test_moe_generate_matches_naive_greedy():
    """KV-cache decode through the expert blocks equals JAX's generate and
    re-running the forward every step (``tests/test_models.py:1316``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 26)
    prompt = np.random.default_rng(27).integers(0, 64, (2, 5)).astype(
        np.int32)
    params = params_from_numpy(tree, device="cpu")
    got = generate(params, torch.from_numpy(prompt), 6, cfg).numpy()
    jgen = jax.jit(lambda p, t: jt.generate(p, t, 6, jcfg))
    np.testing.assert_array_equal(got, np.asarray(jgen(tree, prompt)))
    np.testing.assert_array_equal(got, _naive_greedy(
        params, torch.from_numpy(prompt), 6, cfg).numpy())


@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_sharded_generate_equals_jax(cf):
    """Generation over (dp 4, tp 1): each rank's prefill routes its own
    prompt rows with the training capacity (dropping at 0.5) and each
    decode step its own tokens with the no-drop capacity, as JAX's
    ``make_sharded_generate`` on a (4, 1) mesh; the tokens are equal."""
    jcfg, cfg = _configs(moe_capacity_factor=cf, moe_top_k=2)
    tree = _tree(jcfg, 28)
    prompt = np.random.default_rng(29).integers(0, 64, (8, 6)).astype(
        np.int32)
    jfn, jshard = jt.make_sharded_generate(jcfg, _jmesh(4, 1), 5)
    want = np.asarray(jfn(jshard(tree), jnp.asarray(prompt)))
    fn, shard = make_sharded_generate(cfg, _pmesh(4, 1), 5)
    got = fn(shard(params_from_numpy(tree, device="cpu")),
             torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)


def test_moe_sharded_generate_on_ep_mesh_equals_jax():
    """Generation on (dp 2, ep 2, tp 1) with the experts on ep and a
    prefill that drops (capacity 0.5): the tokens equal JAX's."""
    axes = ("dp", "ep", "tp")
    jcfg, cfg = _configs(moe_capacity_factor=0.5, moe_top_k=2,
                         moe_mesh_axis="ep")
    tree = _tree(jcfg, 40)
    prompt = np.random.default_rng(41).integers(0, 64, (8, 6)).astype(
        np.int32)
    jfn, jshard = jt.make_sharded_generate(jcfg, _jmesh(2, 2, 1, axes=axes),
                                           5)
    want = np.asarray(jfn(jshard(tree), jnp.asarray(prompt)))
    fn, shard = make_sharded_generate(cfg, _pmesh(2, 2, 1, axes=axes), 5)
    got = fn(shard(params_from_numpy(tree, device="cpu")),
             torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)


def test_moe_rejections():
    """JAX's refusals (``tests/test_models.py:1330``); MoE with vocab
    parallelism or dense tp > 1 waits for the multi-GPU slice."""
    from accl_tpu_torch.models import encoder_forward

    jcfg, cfg = _configs()
    params = params_from_numpy(_tree(jcfg, 0), device="cpu")
    with pytest.raises(ValueError, match="decoder flagship only"):
        encoder_forward(params, torch.zeros(1, 8, dtype=torch.int32), cfg)
    with pytest.raises(ValueError, match="does not compose"):
        dataclasses.replace(cfg, seq_parallel=True)
    with pytest.raises(ValueError, match="cannot be 'tp'"):
        dataclasses.replace(cfg, moe_mesh_axis="tp")
    with pytest.raises(ValueError, match="not an axis"):
        make_sharded_train_step(dataclasses.replace(cfg, moe_mesh_axis="ep"),
                                mesh=_pmesh(4, 1))
    with pytest.raises(ValueError, match=r"n_experts \(6\) must divide by dp"):
        make_sharded_forward(dataclasses.replace(cfg, n_experts=6),
                             _pmesh(4, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP B14"):
        dataclasses.replace(cfg, vocab_parallel=True)
    with pytest.raises(NotImplementedError, match="ROADMAP B14"):
        make_sharded_train_step(cfg, mesh=_pmesh(2, 2))


@pytest.fixture(scope="module")
def mesh24():
    """dp 2 (the expert axis, welded) x tp 4 (the cp ring)."""
    return _jmesh(2, 4)


def test_moe_composes_with_context_parallelism(mesh24):
    """MoE x cp: the experts' all-to-all over dp while the K/V ring turns
    over tp; one step equals JAX's on the (2, 4) mesh and, with nothing
    dropped and the penalty off, the one-rank dense step
    (``tests/test_models.py:1384``)."""
    jcfg, cfg = _configs(context_parallel=True, moe_aux_weight=0.0,
                         moe_router_z_weight=0.0, moe_capacity_factor=8.0)
    tree = _tree(jcfg, 30)
    tokens, targets = _batch(31, B=4)
    want = _jax_step(jcfg, mesh24, tree, tokens, targets)
    got = _port_step(cfg, _pmesh(2, 4), tree, tokens, targets)
    _assert_steps_close(got, want, rel=1e-4)
    dense = dataclasses.replace(cfg, context_parallel=False)
    _assert_steps_close(_port_step(dense, make_mesh(1, device="cpu"), tree,
                                   tokens, targets), want, rel=1e-4)


@pytest.mark.parametrize("cf", [1.5, 0.5])
def test_moe_cp_aux_terms_flow(mesh24, cf):
    """Under MoE x cp the router penalty reaches the loss (above the
    loss with zero weights) and each (dp, ring) rank routes its striped
    shard with its own capacity: the losses equal JAX's, dropping at
    0.5 (``tests/test_models.py:1430``)."""
    jcfg, cfg = _configs(context_parallel=True, moe_capacity_factor=cf)
    tree = _tree(jcfg, 32)
    tokens, targets = _batch(33, B=4)
    want = _jax_step(jcfg, mesh24, tree, tokens, targets, lr=0.0)
    got = _port_step(cfg, _pmesh(2, 4), tree, tokens, targets, lr=0.0)
    assert got[0] == pytest.approx(want[0], rel=1e-4)
    bare = _port_step(dataclasses.replace(cfg, moe_aux_weight=0.0,
                                          moe_router_z_weight=0.0),
                      _pmesh(2, 4), tree, tokens, targets, lr=0.0)
    assert np.isfinite(got[0]) and got[0] > bare[0]


@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_expert_axis_unwelded_from_dp(cf):
    """Experts on a dedicated ep axis of a (dp 2, ep 2, tp 1) mesh: the
    batch splits over dp x ep, the bank over ep alone; one step equals
    JAX's on the same mesh of CPU devices (``tests/test_models.py:1439``)."""
    jcfg, cfg = _configs(moe_mesh_axis="ep", moe_capacity_factor=cf,
                         moe_aux_weight=0.0, moe_router_z_weight=0.0)
    assert pt.param_specs(cfg)["layers"][0]["moe"]["w1"][0] == "ep"
    tree = _tree(jcfg, 34)
    tokens, targets = _batch(35)
    axes = ("dp", "ep", "tp")
    want = _jax_step(jcfg, _jmesh(2, 2, 1, axes=axes), tree, tokens, targets)
    got = _port_step(cfg, _pmesh(2, 2, 1, axes=axes), tree, tokens, targets)
    _assert_steps_close(got, want)


def test_dense_config_ignores_ep_axis_unless_opted_in():
    """A dense config's batch splits over an "ep" axis only when it opts
    in (``ep_extends_dp``), as JAX's ``_data_axes`` says; the opted-in
    step computes the one-rank loss (``tests/test_models.py:1587``)."""
    fields = dict(d_model=32, n_heads=4, d_ff=64, max_seq=16)
    cfg = TransformerConfig(**fields)
    axes = ("dp", "ep", "tp")
    mesh = _pmesh(2, 2, 1, axes=axes)
    jmesh = _jmesh(2, 2, 2, axes=axes)
    opted = dataclasses.replace(cfg, ep_extends_dp=True)
    for c, jc in ((cfg, jt.TransformerConfig(**fields)),
                  (opted, jt.TransformerConfig(ep_extends_dp=True, **fields))):
        assert pt._data_axes(c, mesh) == jt._data_axes(jc, jmesh)
    assert pt._data_axes(opted, mesh) == ("dp", "ep")
    tree = _tree(jt.TransformerConfig(**fields), 40)
    tokens, targets = _batch(41)
    jcfg = jt.TransformerConfig(**fields)
    want = float(jax.jit(lambda p, t, y: jt.loss_fn(p, t, y, jcfg))(
        tree, tokens, targets))
    step, shard = make_sharded_train_step(opted, lr=0.0, mesh=mesh)
    _, loss = step(shard(params_from_numpy(tree, device="cpu")),
                   torch.from_numpy(tokens), torch.from_numpy(targets))
    assert float(loss) == pytest.approx(want, rel=1e-5)


def test_moe_bfloat16_forward_near_jax():
    """In bfloat16 the routing and the expert GEMMs run in bfloat16; the
    logits stay within the dense path's bfloat16 bound of JAX's
    (``test_torch_transformer.py``: 0.05 absolute)."""
    jcfg = jt.TransformerConfig(dtype=jnp.bfloat16, **BASE)
    cfg = TransformerConfig(dtype=torch.bfloat16, **BASE)
    tree = _tree(jcfg, 42)
    tokens, _ = _batch(43, B=2)
    want = np.asarray(jax.jit(lambda p, t: jt.forward(p, t, jcfg))(
        tree, tokens), np.float32)
    got = forward(params_from_numpy(tree, device="cpu"),
                  torch.from_numpy(tokens), cfg).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
