"""The port's context-parallel path against the JAX package's.

``accl_tpu_torch.models`` runs the flagship's ``context_parallel`` path on
one device: the makers take a ``("dp", "tp")`` mesh of virtual ranks
(``make_mesh((dp, tp), axes=("dp", "tp"))``), dp splitting the batch and
tp the ring over which the sequence is striped, and every block's
attention is the striped causal ring over the ranks.  JAX runs the same
step under ``shard_map`` on ``tests/test_models.py``'s ``mesh24`` (dp 2 x
tp 4 of the conftest's 8 virtual CPU devices).  Parameters come from
JAX's ``init_params`` through ``params_from_numpy`` and tokens from a
numpy seed.  In float32 the loss agrees within 1e-5 relative and every
updated parameter within rtol 2e-4, atol 2e-5, the bounds JAX's own cp
test holds its cp step to against the dense one
(``tests/test_models.py:1057-1083``); the same bounds hold the port's cp
step and forward against its own dense ones.
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
from accl_tpu.models.ring_attention import stripe_sequence as jstripe
from accl_tpu_torch.models import (
    TransformerConfig,
    forward,
    loss_fn,
    make_sharded_forward,
    make_sharded_generate,
    make_sharded_train_step,
    params_from_numpy,
    params_to_numpy,
    stripe_sequence,
)
from accl_tpu_torch.models import transformer as pt
from accl_tpu_torch.ops.driver import make_mesh

TOL = dict(rtol=2e-4, atol=2e-5)
#: JAX's cp configuration (``tests/test_models.py:1066``)
BASE = dict(vocab=64, d_model=64, n_heads=8, n_kv_heads=4, n_layers=2,
            d_ff=96, max_seq=32)
LR = 0.05


def _configs(dtype="float32", **kw):
    """(JAX config, port config), dense; ``dtype`` by name."""
    fields = {**BASE, **kw}
    return (jt.TransformerConfig(dtype=getattr(jnp, dtype), **fields),
            TransformerConfig(dtype=getattr(torch, dtype), **fields))


def _cp(cfg):
    return dataclasses.replace(cfg, context_parallel=True)


def _tree(jcfg, seed):
    return jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))


def _batch(seed, B=4, T=16):
    tokens = np.random.default_rng(seed).integers(
        0, BASE["vocab"], (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def mesh24():
    return Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "tp"))


def _cpu_mesh(dp=1, tp=1):
    return make_mesh((dp, tp), axes=("dp", "tp"), device="cpu")


def _jax_step(jcfg, mesh, tree, tokens, targets, lr=LR):
    step, shard = jt.make_sharded_train_step(jcfg, mesh, lr=lr)
    new, loss = step(shard(tree), jnp.asarray(tokens), jnp.asarray(targets))
    return float(loss), jax.tree.leaves(jax.tree.map(np.asarray, new))


def _port_step(cfg, mesh, tree, tokens, targets, lr=LR):
    step, shard = make_sharded_train_step(cfg, lr=lr, mesh=mesh)
    new, loss = step(shard(params_from_numpy(tree, device="cpu")),
                     torch.from_numpy(tokens), torch.from_numpy(targets))
    return float(loss), jax.tree.leaves(params_to_numpy(new))


def _assert_steps_close(got, want, rel=1e-5, **tol):
    assert got[0] == pytest.approx(want[0], rel=rel)
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float32),
                                   b.astype(np.float32), **(tol or TOL))


CASES = pytest.mark.parametrize(
    "pos,remat", [("learned", False), ("rope", False), ("rope", True)])


@CASES
def test_cp_train_step_equals_jax(mesh24, pos, remat):
    """The cp = 4 step on a (2, 4) mesh, GQA: weights replicated over the
    ring, striped shards, the ring in every block, the local loss's ring
    and dp means."""
    jcfg, cfg = _configs(pos_embedding=pos, remat=remat)
    tree = _tree(jcfg, 1)
    tokens, targets = _batch(40)
    want = _jax_step(_cp(jcfg), mesh24, tree, tokens, targets)
    got = _port_step(_cp(cfg), _cpu_mesh(2, 4), tree, tokens, targets)
    _assert_steps_close(got, want)


@CASES
def test_cp_train_step_equals_dense_step(pos, remat):
    """The port's cp step against its own dense single-rank step."""
    jcfg, cfg = _configs(pos_embedding=pos, remat=remat)
    tree = _tree(jcfg, 2)
    tokens, targets = _batch(41)
    dense = _port_step(cfg, make_mesh(1, device="cpu"), tree, tokens,
                       targets)
    ring = _port_step(_cp(cfg), _cpu_mesh(2, 4), tree, tokens, targets)
    _assert_steps_close(ring, dense)


def test_dp_step_equals_jax():
    """A dense step on a (2, 1) mesh: each dp group's rows, the dp mean of
    the local means."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 3)
    tokens, targets = _batch(42)
    mesh21 = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("dp", "tp"))
    want = _jax_step(jcfg, mesh21, tree, tokens, targets)
    got = _port_step(cfg, _cpu_mesh(2, 1), tree, tokens, targets)
    _assert_steps_close(got, want)


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_cp_sharded_forward_equals_jax_and_dense(mesh24, pos):
    """``make_sharded_forward`` under cp stripes in and unstripes out:
    token-order logits equal to JAX's on ``mesh24`` and to the port's
    dense form."""
    jcfg, cfg = _configs(pos_embedding=pos)
    tree = _tree(jcfg, 4)
    tokens, _ = _batch(43, B=2)
    jfn, jshard = jt.make_sharded_forward(_cp(jcfg), mesh24)
    want = np.asarray(jfn(jshard(tree), jnp.asarray(tokens)))
    params = params_from_numpy(tree, device="cpu")
    fn, shard = make_sharded_forward(_cp(cfg), _cpu_mesh(2, 4))
    got = fn(shard(params), torch.from_numpy(tokens))
    assert got.shape == (2, 16, BASE["vocab"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense, _ = make_sharded_forward(cfg, make_mesh(1, device="cpu"))
    np.testing.assert_allclose(got.numpy(),
                               dense(params, torch.from_numpy(tokens)).numpy(),
                               **TOL)


def test_cp_forward_and_loss_per_rank_equal_jax():
    """``forward`` and ``loss_fn`` on the ranks' striped shards (lists)
    against JAX's inside ``shard_map``: each rank's striped logits shard,
    and the ring mean of the local means."""
    jcfg, cfg = _configs(pos_embedding="rope")
    jcp, cp = _cp(jcfg), _cp(cfg)
    tree = _tree(jcfg, 5)
    tokens, targets = _batch(44, B=2)
    mesh14 = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("dp", "tp"))
    specs = jt.param_specs(jcp)
    seq = P(None, "tp")
    fwd = shard_map(lambda p, t: jt.forward(p, t, jcp, "tp", 4),
                    mesh=mesh14, in_specs=(specs, seq),
                    out_specs=P(None, "tp", None), check_vma=False)
    loss = shard_map(lambda p, t, y: jt.loss_fn(p, t, y, jcp, "tp", 4),
                     mesh=mesh14, in_specs=(specs, seq, seq), out_specs=P(),
                     check_vma=False)
    jtok = jstripe(jnp.asarray(tokens), 4, axis=1)
    jtgt = jstripe(jnp.asarray(targets), 4, axis=1)
    want_logits = np.asarray(jax.jit(fwd)(tree, jtok))
    want_loss = float(jax.jit(loss)(tree, jtok, jtgt))

    params = params_from_numpy(tree, device="cpu")
    shards = list(stripe_sequence(torch.from_numpy(tokens), 4,
                                  axis=1).split(4, dim=1))
    tgts = list(stripe_sequence(torch.from_numpy(targets), 4,
                                axis=1).split(4, dim=1))
    got = forward(params, shards, cp)
    assert len(got) == 4 and all(z.shape == (2, 4, 64) for z in got)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want_logits,
                               **TOL)
    assert float(loss_fn(params, shards, tgts, cp)) == pytest.approx(
        want_loss, rel=1e-5)


def test_plain_forward_and_loss_of_cp_config_run_dense():
    """With no ring (token tensors, not the ranks' shards) a cp config
    runs the dense path, as JAX's does with no tp axis."""
    jcfg, cfg = _configs(pos_embedding="rope")
    tree = _tree(jcfg, 6)
    tokens, targets = (torch.from_numpy(a) for a in _batch(45))
    params = params_from_numpy(tree, device="cpu")
    torch.testing.assert_close(forward(params, tokens, _cp(cfg)),
                               forward(params, tokens, cfg), rtol=0, atol=0)
    assert float(loss_fn(params, tokens, targets, _cp(cfg))) == float(
        loss_fn(params, tokens, targets, cfg))
    want = float(jt.loss_fn(tree, jnp.asarray(tokens.numpy()),
                            jnp.asarray(targets.numpy()), _cp(jcfg)))
    assert float(loss_fn(params, tokens, targets, _cp(cfg))) == \
        pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("t_local,impl", [
    (8192, "naive"), (8192, "blockwise"), (8192, "flash"),
    (pt._AUTO_FUSED_MIN_T // 2, "auto"), (pt._AUTO_FUSED_MIN_T, "auto"),
    (8, "flash"), (1024, "blockwise"), (192, "flash"), (100, "blockwise"),
])
def test_cp_block_k_equals_jax(t_local, impl):
    """``test_cp_block_k_honors_attention_contract``'s table and a few
    more shard lengths."""
    assert pt._AUTO_FUSED_MIN_T == jt._AUTO_FUSED_MIN_T
    assert pt._cp_block_k(t_local, impl) == jt._cp_block_k(t_local, impl)


@pytest.mark.parametrize("t_local", [1, 4, 1024])
def test_cp_positions_equal_jax(t_local):
    """Each rank's striped positions, against JAX's under ``shard_map``
    on a 4-rank axis, and the ranks' positions held as one sequence
    against the striped order of 0 .. T - 1."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("tp",))
    fn = shard_map(lambda: jt._cp_positions(t_local, "tp")[None], mesh=mesh,
                   in_specs=(), out_specs=P("tp"), check_vma=False)
    want = np.asarray(jax.jit(fn)())
    got = np.stack([pt._cp_positions(t_local, 4, r).numpy()
                    for r in range(4)])
    np.testing.assert_array_equal(got, want)
    T = 4 * t_local
    np.testing.assert_array_equal(
        pt._striped_positions(T, 4).numpy(),
        stripe_sequence(torch.arange(T), 4, axis=0).numpy())


def test_cp_trained_params_serve_as_jax(mesh24):
    """cp-trained parameters re-serve under the dense config:
    ``make_sharded_generate(base, mesh, 4)`` gives JAX's greedy tokens for
    the same parameters."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 7)
    tokens, targets = _batch(46, B=2)
    step, shard = make_sharded_train_step(_cp(cfg), lr=LR,
                                          mesh=_cpu_mesh(2, 4))
    trained, _ = step(shard(params_from_numpy(tree, device="cpu")),
                      torch.from_numpy(tokens), torch.from_numpy(targets))
    gen, shard_g = make_sharded_generate(cfg, make_mesh(1, device="cpu"), 4)
    got = gen(shard_g(trained), torch.from_numpy(tokens))
    jgen, jshard = jt.make_sharded_generate(jcfg, mesh24, 4)
    want = np.asarray(jgen(jshard(params_to_numpy(trained)),
                           jnp.asarray(tokens)))
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bfloat16_cp_step_near_jax(mesh24):
    """bfloat16 at ``test_bfloat16_step_near_jax``'s bounds (loss 5e-4
    relative; an updated weight within one bf16 ulp of weights in [2^-5,
    2^-4): rtol 1e-2, atol 2.5e-4)."""
    jcfg, cfg = _configs(dtype="bfloat16", pos_embedding="rope")
    tree = _tree(jcfg, 8)
    tokens, targets = _batch(47)
    want = _jax_step(_cp(jcfg), mesh24, tree, tokens, targets)
    got = _port_step(_cp(cfg), _cpu_mesh(2, 4), tree, tokens, targets)
    _assert_steps_close(got, want, rel=5e-4, rtol=1e-2, atol=2.5e-4)


@pytest.mark.parametrize("field", ["seq_parallel", "vocab_parallel"])
def test_cp_with_tp_strategies_is_incompatible(field):
    """JAX's ValueError, before the port's NotImplementedError for the
    field."""
    with pytest.raises(ValueError, match="incompatible"):
        TransformerConfig(context_parallel=True, **{field: True})
    with pytest.raises(ValueError, match="incompatible"):
        jt._check_axis_compat(jt.TransformerConfig(context_parallel=True,
                                                   **{field: True}))


def test_cp_refusals():
    _, cfg = _configs()
    cp = _cp(cfg)
    with pytest.raises(ValueError, match="no serving path"):
        make_sharded_generate(cp, make_mesh(1, device="cpu"), 4)
    x = torch.zeros(1, 8, BASE["d_model"])
    with pytest.raises(ValueError, match="no serving path"):
        pt._enter_block_layout(x, cp, return_kv=True, ring=4)
    with pytest.raises(ValueError, match="decoder-only"):
        pt._enter_block_layout(x, cp, causal=False, ring=4)
    tokens = [torch.zeros(1, 4, dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="need context_parallel"):
        forward({}, tokens, cfg)
    step, _ = make_sharded_train_step(cp, mesh=_cpu_mesh(2, 4))
    with pytest.raises(ValueError, match="must divide by dp"):
        step({"embed": torch.zeros(1)}, torch.zeros(3, 8, dtype=torch.int32),
             None)


@pytest.mark.parametrize("maker", ["train_step", "forward", "generate"])
def test_dense_tensor_parallelism_is_refused(maker):
    """tp > 1 without cp, and an unnamed mesh of more than one rank, wait
    for the multi-GPU slice."""
    _, cfg = _configs()
    make = {"train_step": lambda m: make_sharded_train_step(cfg, mesh=m),
            "forward": lambda m: make_sharded_forward(cfg, m),
            "generate": lambda m: make_sharded_generate(cfg, m, 4)}[maker]
    with pytest.raises(NotImplementedError, match="ROADMAP B14") as ei:
        make(_cpu_mesh(2, 4))
    assert "A9c" in str(ei.value)
    with pytest.raises(NotImplementedError, match="ROADMAP B14"):
        make(make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="axes"):
        make(make_mesh((1, 1), axes=("dp", "ep"), device="cpu"))
    make(_cpu_mesh(2, 1))  # a batch split: accepted


def test_named_mesh():
    m = make_mesh((2, 4), axes=("dp", "tp"), device="cpu")
    assert m.size == 8 and m.shape == {"dp": 2, "tp": 4}
    assert m.device == torch.device("cpu")
    plain = make_mesh(3, "cpu")  # the collectives' positional device
    assert plain.size == 3 and plain.axis_names == () and plain.shape == {}
    assert plain.device == torch.device("cpu")
    with pytest.raises(ValueError, match="names each of its axes"):
        make_mesh((2, 4), device="cpu")
    with pytest.raises(ValueError, match="names each of its axes"):
        make_mesh((2, 4), axes=("dp",), device="cpu")
    with pytest.raises(ValueError, match="at least one rank"):
        make_mesh((2, 0), axes=("dp", "tp"), device="cpu")
