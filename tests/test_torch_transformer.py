"""The port's transformer serving path against the JAX package's.

``accl_tpu_torch.models`` is the single-device forward, prefill and
KV-cache generate of ``accl_tpu/models/transformer.py``.  The JAX
package's own small configurations (``tests/test_models.py``: the
``cfg`` fixture, and its GQA and rope variants) are initialised by JAX
and carried across with ``params_from_numpy``; the same numpy-seeded
tokens go through both.  In float32 logits and KV caches agree within
2e-5 under every attention lowering (the JAX tests' tolerance for
lowerings of the same math); greedy tokens agree exactly.  In bfloat16
the two frameworks round at different places (matmul outputs, the
layer norm's mean), so logits are held within 0.05 absolute, about
eight bf16 ulps of the largest logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.models import transformer as jt
from accl_tpu_torch import interop
from accl_tpu_torch.models import (
    TransformerConfig,
    forward,
    generate,
    init_params,
    make_sharded_train_step,
    params_from_numpy,
    prefill,
)
from accl_tpu_torch.models import transformer as pt

TOL = dict(rtol=2e-5, atol=2e-5)
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32)
VARIANTS = {
    "learned": {},
    "gqa": dict(n_kv_heads=2),
    "rope": dict(pos_embedding="rope", n_kv_heads=2),
}


def _configs(variant, **kw):
    """(JAX config, port config) of one variant; ``dtype`` by name."""
    dtype = kw.pop("dtype", "float32")
    fields = {**BASE, **VARIANTS[variant], **kw}
    return (jt.TransformerConfig(dtype=getattr(jnp, dtype), **fields),
            TransformerConfig(dtype=getattr(torch, dtype), **fields))


def _params(jcfg, seed=7):
    """JAX parameters and the port's copy of them on the CPU."""
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, B, T, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _skip_unless_runnable(impl):
    """The JAX flash lowering off the TPU needs the TPU interpret mode."""
    import jax.experimental.pallas.tpu as pltpu

    if impl == "flash" and jax.default_backend() != "tpu" and not hasattr(
        pltpu, "InterpretParams"
    ):
        pytest.skip("flash kernel needs Mosaic or pallas TPU interpret mode")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("impl", ["naive", "blockwise", "flash"])
def test_forward_equals_jax(impl, variant):
    _skip_unless_runnable(impl)
    jcfg, cfg = _configs(variant, attention=impl)
    jp, params = _params(jcfg)
    toks = _tokens(1, 2, 20)
    want = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    got = forward(params, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 20, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl", ["naive", "blockwise", "flash"])
def test_prefill_equals_jax(impl):
    _skip_unless_runnable(impl)
    jcfg, cfg = _configs("rope", attention=impl)
    jp, params = _params(jcfg, seed=9)
    toks = _tokens(2, 2, 13)
    jl, jc = jt.prefill(jp, jnp.asarray(toks), jcfg, cache_len=24)
    logits, caches = prefill(params, torch.from_numpy(toks), cfg,
                             cache_len=24)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert len(caches) == len(jc) == cfg.n_layers
    for (k, v), (jk, jv) in zip(caches, jc):
        assert k.shape == (2, cfg.kv_heads(), 24, 8)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generate_greedy_equals_jax(variant):
    jcfg, cfg = _configs(variant)
    jp, params = _params(jcfg, seed=11)
    prompt = _tokens(3, 2, 9)
    want = np.asarray(jt.generate(jp, jnp.asarray(prompt), 7, jcfg))
    got = generate(params, torch.from_numpy(prompt), 7, cfg)
    assert got.shape == (2, 7) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_flash_greedy_equals_jax():
    _skip_unless_runnable("flash")
    jcfg, cfg = _configs("gqa", attention="flash")
    jp, params = _params(jcfg, seed=13)
    prompt = _tokens(4, 2, 10)
    want = np.asarray(jt.generate(jp, jnp.asarray(prompt), 6, jcfg))
    got = generate(params, torch.from_numpy(prompt), 6, cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_equals_rerunning_forward():
    """KV-cache decode == the full forward re-run on the grown sequence
    (greedy), on the port alone: the in-place cache writes and the
    decode mask."""
    _, cfg = _configs("rope")
    params = init_params(cfg, torch.Generator().manual_seed(5),
                         device="cpu")
    seq = torch.from_numpy(_tokens(5, 3, 6))
    got = generate(params, seq, 8, cfg)
    for _ in range(8):
        nxt = forward(params, seq, cfg)[:, -1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None].to(seq.dtype)], dim=1)
    torch.testing.assert_close(got, seq[:, 6:])


def test_bfloat16_logits_near_jax():
    jcfg, cfg = _configs("rope", dtype="bfloat16")
    jp, params = _params(jcfg, seed=15)
    assert params["embed"].dtype == torch.bfloat16
    toks = _tokens(6, 2, 16)
    want = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg)).astype(
        np.float32)
    got = forward(params, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(interop.to_numpy(got), want, rtol=0,
                               atol=5e-2)
    logits, caches = prefill(params, torch.from_numpy(toks), cfg)
    assert all(k.dtype == torch.bfloat16 for kv in caches for k in kv)
    torch.testing.assert_close(logits, got[:, -1], rtol=0, atol=0)
    tokens = generate(params, torch.from_numpy(toks[:, :8]), 6, cfg)
    assert tokens.shape == (2, 6)


def test_auto_resolution():
    r = pt._resolve_attention
    assert r("auto", 1023, 128, on_card=True) == "naive"
    assert r("auto", 1024, 128, on_card=True) == "flash"
    assert r("auto", 1024, 256, on_card=True) == "blockwise"  # D > 128
    assert r("auto", 4096, 64, on_card=False) == "blockwise"
    assert r("auto", 16, 64, on_card=False) == "naive"
    for impl in ("naive", "blockwise", "flash"):
        assert r(impl, 4096, 512, on_card=True) == impl


def test_auto_on_the_cpu_runs_blockwise_from_1024():
    """On CPU tensors "auto" at T >= 1024 is the blockwise fold, as JAX
    resolves off the TPU."""
    _, cfg = _configs("learned", max_seq=1024, n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         device="cpu")
    toks = torch.from_numpy(_tokens(7, 1, 1024))
    auto = forward(params, toks, cfg)
    blockwise = forward(params, toks,
                        dataclasses.replace(cfg, attention="blockwise"))
    torch.testing.assert_close(auto, blockwise, rtol=0, atol=0)


@pytest.mark.parametrize("field,value", [
    ("n_experts", 4), ("seq_parallel", True), ("vocab_parallel", True),
    ("context_parallel", True),
])
def test_unported_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TransformerConfig(**{field: value})


def test_config_validates():
    with pytest.raises(ValueError, match="unknown attention"):
        TransformerConfig(attention="ring")
    with pytest.raises(TypeError, match="torch dtype"):
        TransformerConfig(dtype=np.float32)
    with pytest.raises(ValueError, match="divide"):
        TransformerConfig(n_heads=8, n_kv_heads=3).kv_heads()
    with pytest.raises(ValueError, match="even head dim"):
        TransformerConfig(d_model=40, n_heads=8,
                          pos_embedding="rope").uses_rope()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_params_tree_matches_jax(variant):
    jcfg, cfg = _configs(variant)
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    w = params["layers"][0]["wq"]
    assert 0.015 < float(w.std()) < 0.025 and abs(float(w.mean())) < 0.01


def test_sampling_stays_in_top_k():
    _, cfg = _configs("learned")
    params = init_params(cfg, torch.Generator().manual_seed(2),
                         device="cpu")
    prompt = torch.from_numpy(_tokens(8, 4, 5))
    gen = torch.Generator().manual_seed(3)
    got = generate(params, prompt, 8, cfg, temperature=1.5, top_k=3,
                   generator=gen)
    seq = prompt
    for i in range(8):
        top = forward(params, seq, cfg)[:, -1].topk(3, dim=-1).indices
        assert (top == got[:, i:i + 1].long()).any(-1).all()
        seq = torch.cat([seq, got[:, i:i + 1]], dim=1)
    again = generate(params, prompt, 8, cfg, temperature=1.5, top_k=3,
                     generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(again, got)  # one seed, one stream


def test_generate_checks():
    _, cfg = _configs("learned")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    prompt = torch.from_numpy(_tokens(9, 1, 20))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        generate(params, prompt, 13, cfg)
    with pytest.raises(ValueError, match="requires a generator"):
        generate(params, prompt, 2, cfg, temperature=1.0)
    with pytest.raises(ValueError, match="top_k"):
        generate(params, prompt, 2, cfg, top_k=65)
    assert generate(params, prompt, 0, cfg).shape == (1, 0)


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(**BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"embed": np.zeros((4, 2), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_train_step(cfg)  # no mesh: the card's
    assert init_params(cfg, torch.Generator().manual_seed(0),
                       device="cpu")["embed"].device.type == "cpu"
