"""The port's training example against the JAX package's.

``accl_tpu_torch.examples.train.train`` counts virtual ranks (``world``,
8: the conftest's CPU devices) where JAX's counts devices, and keeps its
mesh arithmetic, so each form builds the same mesh and model.  The
port's trainer starts from JAX's initial tree (its ``init_params`` is
swapped for JAX's, carried by ``params_from_numpy``) and both read the
same synthetic stream, ``np.random.default_rng([seed, step])``, or the
same token file, so the final losses agree to JAX's tolerance (rel 1e-5;
the Adam forms 1e-4: a first Adam step is ~ lr * sign(g), so a gradient
rounding to the other side of zero moves its element by a whole step).
Dense tp is 1 on both sides (the port clamps it until ROADMAP B14); the
context form keeps tp = 2, the ring.  Checkpoint resume is checked bit
for bit on the port, and its refusals and messages against JAX's
(``tests/test_models.py:657-1690``, ``tests/test_zero.py:145,163``,
``tests/test_data.py:90``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.compat import has_modern_vma
from accl_tpu.examples import train as jtrain
from accl_tpu.models import transformer as jt
from accl_tpu_torch.data import write_token_file
from accl_tpu_torch.examples import train as ttrain
from accl_tpu_torch.models import params_from_numpy

SGD_RTOL, ADAM_RTOL = 1e-5, 1e-4


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trainer draws JAX's initial tree for its config."""

    def init(cfg, generator, device):
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)}
        fields["dtype"] = getattr(jnp, str(cfg.dtype)[len("torch."):])
        tree = jt.init_params(jax.random.PRNGKey(generator.initial_seed()),
                              jt.TransformerConfig(**fields))
        return params_from_numpy(jax.tree.map(np.asarray, tree), device)

    monkeypatch.setattr(ttrain, "init_params", init)


@pytest.fixture(scope="module")
def token_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "train.bin"
    write_token_file(str(path), np.random.default_rng(11).integers(
        0, 128, 30_000))  # the trainer's vocab
    return str(path)


FORMS = {
    "dp_tp": (dict(tp=1), SGD_RTOL),
    "context_tp2": (dict(parallelism="context"), SGD_RTOL),
    "pipeline_gpipe": (dict(parallelism="pipeline", tp=1), SGD_RTOL),
    "pipeline_1f1b": (dict(parallelism="pipeline", pp_schedule="1f1b",
                           tp=1), SGD_RTOL),
    "pipeline_v2": (dict(parallelism="pipeline", v_stages=2, tp=1),
                    SGD_RTOL),
    "zero_adam": (dict(optimizer="zero_adam", tp=1), ADAM_RTOL),
    "pipeline_zero_adam": (dict(parallelism="pipeline", optimizer="zero_adam",
                                clip_grad_norm=1.0, tp=1), ADAM_RTOL),
    "moe": (dict(optimizer="zero_adam", n_experts=8, tp=1), ADAM_RTOL),
    "moe_ep2": (dict(optimizer="zero_adam", n_experts=8, ep=2, tp=1),
                ADAM_RTOL),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_final_loss_equals_jax(jax_init, form, token_path):
    """Two steps of each form end on JAX's loss; the dp_tp form reads
    the token file through both loaders."""
    kw, rtol = FORMS[form]
    if "pipeline" in form and not has_modern_vma():
        pytest.skip("the JAX pipeline needs modern shard_map semantics")
    if form == "dp_tp":
        kw = dict(kw, data=token_path)
    done, jl = jtrain.train(steps=2, log_every=0, **kw)
    got, tl = ttrain.train(steps=2, log_every=0, device="cpu", **kw)
    assert got == done == 2
    assert tl == pytest.approx(jl, rel=rtol)


def _ckpt(ckpt_dir, step):
    return torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"),
                      weights_only=True)["tree"]


def _equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(parallelism="pipeline", optimizer="zero_adam", clip_grad_norm=1.0),
    dict(data=True),
    dict(optimizer="zero_adam", n_experts=8, ep=2),
    dict(optimizer="zero_adam"),
], ids=["pipeline_zero_adam", "dp_tp_data", "moe_ep2", "zero_adam"])
def test_checkpoint_resume_is_bit_for_bit(tmp_path, token_path, kw):
    """Four steps saved every two, then a resume to six, end on the
    uninterrupted six-step run's loss and tree bit for bit; the last two
    checkpoints are kept, each written whole."""
    kw = dict(kw, data=token_path) if kw.get("data") else kw
    ckpt = str(tmp_path / "ckpt")
    done, loss_a = ttrain.train(steps=4, ckpt_dir=ckpt, save_every=2,
                                log_every=0, device="cpu", **kw)
    assert done == 4 and np.isfinite(loss_a)
    assert sorted(os.listdir(ckpt)) == ["ckpt_1.pt", "ckpt_3.pt"]
    ref = str(tmp_path / "ref")
    _, loss_b = ttrain.train(steps=6, ckpt_dir=ref, save_every=6,
                             log_every=0, device="cpu", **kw)
    done, loss_c = ttrain.train(steps=6, ckpt_dir=ckpt, save_every=2,
                                log_every=0, device="cpu", **kw)
    assert done == 6 and loss_c == loss_b
    assert sorted(os.listdir(ckpt)) == ["ckpt_3.pt", "ckpt_5.pt"]
    assert _equal_trees(_ckpt(ckpt, 5), _ckpt(ref, 5))
    # nothing left to do: reported as in JAX (:210)
    assert ttrain.train(steps=6, ckpt_dir=ckpt, log_every=0,
                        device="cpu", **kw) == (6, None)


def test_layout_mismatch_raises_jax_message(tmp_path):
    """A checkpoint of another layout raises JAX's ValueError naming the
    flags (``tests/test_models.py:685``, ``tests/test_zero.py:163``)."""
    ckpt = str(tmp_path / "ck")
    ttrain.train(steps=3, ckpt_dir=ckpt, save_every=2, log_every=0,
                 device="cpu")
    with pytest.raises(ValueError, match="--parallelism"):
        ttrain.train(steps=5, ckpt_dir=ckpt, save_every=2, log_every=0,
                     device="cpu", parallelism="pipeline")
    with pytest.raises(ValueError, match="different --optimizer"):
        ttrain.train(steps=5, ckpt_dir=ckpt, save_every=2, log_every=0,
                     device="cpu", optimizer="zero_adam")


def test_refusals_equal_jax():
    """The option refusals JAX's trainer raises, with its messages."""
    for kw, msg in (
            (dict(ep=2), "requires --n-experts"),
            (dict(n_experts=16, ep=16), "--ep 16 needs"),
            (dict(v_stages=2), "requires parallelism"),
            (dict(pp_schedule="1f1b"), "requires parallelism"),
            (dict(parallelism="pipeline", optimizer="zero_adam",
                  accum_steps=2), "microbatches"),
            (dict(accum_steps=2), "require optimizer='zero_adam'"),
            (dict(parallelism="dave"), "unknown parallelism"),
            (dict(dtype="float16"), "unknown dtype")):
        with pytest.raises(ValueError, match=msg):
            jtrain.train(steps=1, log_every=0, **kw)
        with pytest.raises(ValueError, match=msg):
            ttrain.train(steps=1, log_every=0, device="cpu", **kw)


def test_moe_with_context_parallelism_trains():
    """``tests/test_models.py:1659``: experts on dp beside the K/V ring on
    tp = 2."""
    done, loss = ttrain.train(steps=3, log_every=0, device="cpu",
                              parallelism="context", n_experts=8)
    assert done == 3 and np.isfinite(loss)


def test_dense_tp_clamps_and_says_so(capsys):
    """Dense tp clamps to 1 (ROADMAP B14) and the trainer prints it; the
    context form keeps its ring."""
    ttrain.train(steps=1, log_every=0, device="cpu", tp=2)
    assert "dense tp = 2 clamps to 1" in capsys.readouterr().out
    ttrain.train(steps=1, log_every=0, device="cpu", tp=2,
                 parallelism="context")
    assert "clamps" not in capsys.readouterr().out


def test_main_parses_the_flags(tmp_path, capsys):
    """The command line (``--device`` in place of ``--platform``)."""
    assert ttrain.main(["--device", "cpu", "--steps", "2", "--parallelism",
                        "pipeline", "--pp-schedule", "1f1b",
                        "--ckpt-dir", str(tmp_path / "c"),
                        "--save-every", "1", "--world", "4"]) == 0
    assert sorted(os.listdir(tmp_path / "c")) == ["ckpt_0.pt", "ckpt_1.pt"]
