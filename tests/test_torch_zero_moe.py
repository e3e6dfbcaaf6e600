"""The port's ZeRO-1 Adam against the JAX package's: the expert banks,
context parallelism, bfloat16 master weights and a JAX state carried
across.

The second half of ``tests/test_torch_zero.py``'s cases, with its
helpers, configurations and tolerances (see its docstring): the MoE
cases of ``tests/test_zero.py:471-557`` and
``tests/test_models.py:1468``, ZeRO x cp (``tests/test_zero.py:533``)
and the bfloat16 master track (:352).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from accl_tpu.models import transformer as jt
from accl_tpu.parallel import zero as jz
from accl_tpu_torch.models import (
    TransformerConfig,
    params_from_numpy,
    params_to_numpy,
)
from accl_tpu_torch.models import transformer as pt
from accl_tpu_torch.parallel import (
    AdamConfig,
    init_zero_state,
    make_zero_train_step,
    zero_state_specs,
)
from test_torch_zero import (
    BASE,
    _batch,
    _close,
    _configs,
    _jmesh,
    _pmesh,
    _reference_adam,
    _run_jax,
    _run_port,
    _tree,
)

#: tests/test_zero.py's moe_cfg fixture (:471)
MOE = dict(BASE, n_experts=8, moe_capacity_factor=4.0, moe_aux_weight=0.0,
           moe_router_z_weight=0.0)


def test_master_weights_bf16_matches_f32_track():
    """bfloat16 parameters with master weights follow the float32 track
    whose bfloat16 cast feeds each forward: three steps equal JAX's
    (``tests/test_zero.py:352``)."""
    jcfg, cfg = _configs("bfloat16")
    tree = _tree(jcfg, 8)
    tokens, targets = _batch(9)
    adam = dict(lr=1e-3, eps=1e-3, master_weights=True)
    want = _run_jax(jcfg, _jmesh(4, 1), jz.AdamConfig(**adam), tree, tokens,
                    targets, steps=3)
    got = _run_port(cfg, _pmesh(4, 1), AdamConfig(**adam), tree, tokens,
                    targets, steps=3)
    _close(got[1], want[1], rtol=2e-2, atol=5e-4)
    _close(jax.tree.leaves(params_to_numpy(got[2]["w"])),
           jax.tree.leaves(want[2]["w"]), rtol=2e-2, atol=5e-4)


def test_jax_state_carries_across():
    """A JAX state tree (m, v, w, step) after one JAX step crosses with
    ``params_from_numpy``; one more step on each side gives the same
    parameters and state."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 12)
    tokens, targets = _batch(13)
    jadam = jz.AdamConfig(lr=0.01, eps=1e-3, master_weights=True)
    mesh = _jmesh(4, 1)
    step, shard, init_state = jz.make_zero_train_step(jcfg, mesh, jadam)
    p, s = shard(tree), init_state(shard(tree))
    p, s, _ = step(p, s, tokens, targets)
    mid_p = jax.tree.map(np.asarray, p)
    mid_s = jax.tree.map(np.asarray, s)
    p, s, _ = step(p, s, tokens, targets)
    pstep, pshard, _ = make_zero_train_step(
        cfg, _pmesh(4, 1), AdamConfig(lr=0.01, eps=1e-3,
                                      master_weights=True))
    params = pshard(params_from_numpy(mid_p, device="cpu"))
    state = params_from_numpy(mid_s, device="cpu")
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    params, state, _ = pstep(params, state, torch.from_numpy(tokens),
                             torch.from_numpy(targets))
    _close(jax.tree.leaves(params_to_numpy(params)),
           jax.tree.leaves(jax.tree.map(np.asarray, p)))
    for key in ("m", "v", "w"):
        _close(jax.tree.leaves(params_to_numpy(state[key])),
               jax.tree.leaves(jax.tree.map(np.asarray, s[key])),
               rtol=2e-4, atol=1e-7 if key == "v" else 1e-5)
    assert int(state["step"]) == int(s["step"]) == 2


# ---------------------------------------------------------------------------
# MoE (expert banks dp-sharded) through the ZeRO optimizer
# ---------------------------------------------------------------------------


def _moe(**kw):
    fields = {**MOE, **kw}
    return jt.TransformerConfig(**fields), TransformerConfig(**fields)


def test_zero_moe_state_is_expert_sharded():
    """Expert-bank moments take no further dp split: each rank's state is
    its expert shard, unpadded; the gate's take the 1/dp split; shapes
    and specs equal JAX's (``tests/test_zero.py:477``)."""
    jcfg, cfg = _moe()
    tree = _tree(jcfg, 0)
    _, _, jinit = jz.make_zero_train_step(jcfg, _jmesh(4, 1))
    jstate = jinit(tree)
    _, shard, init = make_zero_train_step(cfg, _pmesh(4, 1))
    state = init(shard(params_from_numpy(tree, device="cpu")))
    assert jax.tree.map(lambda t: tuple(t.shape), state) == jax.tree.map(
        lambda a: tuple(a.shape), jstate)
    assert state["m"]["layers"][0]["moe"]["w1"].numel() == 8 * 32 * 64
    specs = zero_state_specs(pt.param_specs(cfg))
    assert tuple(specs["m"]["layers"][0]["moe"]["w1"]) == (("dp", "tp"),)
    assert tuple(specs["m"]["layers"][0]["moe"]["gate"]) == ("dp",)


@pytest.mark.parametrize("extras", ["plain", "clip_master_accum"])
def test_zero_moe_matches_unsharded_adam(extras):
    """ZeRO Adam with the expert banks on dp: one step equals JAX's on a
    (4, 1) mesh and unsharded Adam; the second case piles clipping,
    master weights and accumulation together (``tests/test_zero.py:498``)."""
    jcfg, cfg = _moe()
    if extras == "plain":
        adam, accum = dict(lr=0.01, eps=1e-3), 1
    else:
        adam = dict(lr=0.01, eps=1e-3, clip_grad_norm=0.05,
                    master_weights=True)
        accum = 2
    tree = _tree(jcfg, 30)
    tokens, targets = _batch(31)
    want = _run_jax(jcfg, _jmesh(4, 1), jz.AdamConfig(**adam), tree, tokens,
                    targets, accum=accum)
    got = _run_port(cfg, _pmesh(4, 1), AdamConfig(**adam), tree, tokens,
                    targets, accum=accum)
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-5)
    _close(got[1], want[1])
    _close(got[1], _reference_adam(cfg, tree, tokens, targets,
                                   AdamConfig(**adam), 1,
                                   clip=adam.get("clip_grad_norm")))


def test_zero_context_parallel_matches_dense():
    """ZeRO x cp stripes the tokens over the ring like the SGD maker: the
    cp step equals the dense step and JAX's cp step on (4, 2)
    (``tests/test_zero.py:533``)."""
    jcfg, cfg = _configs()
    tree = _tree(jcfg, 40)
    tokens, targets = _batch(41)
    adam = dict(lr=0.01, eps=1e-3, clip_grad_norm=1.0)
    dense = _run_port(cfg, _pmesh(4, 1), AdamConfig(**adam), tree, tokens,
                      targets)
    jcp = dataclasses.replace(jcfg, context_parallel=True)
    cp = dataclasses.replace(cfg, context_parallel=True)
    got = _run_port(cp, _pmesh(4, 2), AdamConfig(**adam), tree, tokens,
                    targets)
    assert got[0][0] == pytest.approx(dense[0][0], rel=1e-5)
    _close(got[1], dense[1])
    want = _run_jax(jcp, _jmesh(4, 2), jz.AdamConfig(**adam), tree, tokens,
                    targets)
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-5)
    _close(got[1], want[1])


def test_zero_moe_divisibility_diagnostic():
    """The maker raises JAX's n_experts / dp error
    (``tests/test_zero.py:550``)."""
    _, cfg = _configs(n_layers=1, n_experts=6)
    with pytest.raises(ValueError, match="n_experts .6. must divide by dp"):
        make_zero_train_step(cfg, _pmesh(4, 1), AdamConfig())


def test_moe_ep_axis_zero_step_matches_welded():
    """ZeRO Adam on (dp 2, ep 2, tp 1) with the experts on ep equals the
    welded step on (dp 4, tp 1), and JAX's on the same (2, 2, 1) mesh;
    the expert banks' moments split over dp inside each ep shard, as
    JAX's (``tests/test_models.py:1468``)."""
    jcfg, cfg = _moe()
    jun, un = (dataclasses.replace(c, moe_mesh_axis="ep")
               for c in (jcfg, cfg))
    tree = _tree(jcfg, 36)
    tokens, targets = _batch(37)
    adam = dict(lr=0.01, eps=1e-3)
    axes = ("dp", "ep", "tp")
    welded = _run_port(cfg, _pmesh(4, 1), AdamConfig(**adam), tree, tokens,
                       targets)
    got = _run_port(un, _pmesh(2, 2, 1, axes=axes), AdamConfig(**adam), tree,
                    tokens, targets)
    assert got[0][0] == pytest.approx(welded[0][0], rel=1e-5)
    _close(got[1], welded[1], rtol=2e-3, atol=2e-5)
    want = _run_jax(jun, _jmesh(2, 2, 1, axes=axes), jz.AdamConfig(**adam),
                    tree, tokens, targets)
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-5)
    _close(got[1], want[1], rtol=2e-3, atol=2e-5)
    assert jax.tree.map(lambda t: tuple(t.shape), got[2]) == jax.tree.map(
        lambda a: tuple(a.shape), want[2])


def test_init_zero_state_function():
    """``init_zero_state`` called directly: zeros in the layout, and the
    master copy equal to JAX's (``_dp_slice`` layout)."""
    jcfg, cfg = _moe(moe_mesh_axis="ep", vocab=61)
    tree = _tree(jcfg, 44)
    mesh = _pmesh(2, 2, 1, axes=("dp", "ep", "tp"))
    state = init_zero_state(params_from_numpy(tree, device="cpu"),
                            pt.param_specs(cfg), mesh, master_weights=True)
    jmesh = _jmesh(2, 2, 1, axes=("dp", "ep", "tp"))
    jstate = jz.init_zero_state(tree, jt.param_specs(jcfg), jmesh,
                                master_weights=True)
    for key in ("m", "v"):
        assert all(float(t.abs().max()) == 0
                   for t in pt._tree_leaves(state[key]))
    _close(jax.tree.leaves(params_to_numpy(state["w"])),
           jax.tree.leaves(jax.tree.map(np.asarray, jstate["w"])),
           rtol=0, atol=0)
