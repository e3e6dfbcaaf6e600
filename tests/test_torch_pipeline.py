"""The port's pipeline schedules against the JAX package's.

``accl_tpu_torch.models.pipeline`` takes the pp axis as a list of virtual
ranks' stage parameters; JAX's functions run under ``shard_map`` on the
8-device CPU mesh.  The same seeded inputs go through both with the toy
stage ``tanh(x @ w)`` of ``tests/test_moe_pipeline.py``, whose cases
these mirror (:124, :152, :247, :298, :349, :387, :421).  Tolerances are
JAX's: the loss to rel 1e-5, gradients to rtol 2e-4 / atol 2e-5, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from accl_tpu import models as JM
from accl_tpu.compat import has_modern_vma
from accl_tpu_torch import models as TM

pytestmark = pytest.mark.skipif(
    not has_modern_vma(),
    reason="the JAX pipeline needs modern shard_map varying-axis semantics",
)

LOSS_RTOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5


def _mesh(n):
    return Mesh(jax.devices()[:n], ("pp",))


def _jstage(w, x):
    return jnp.tanh(x @ w)


def _tstage(w, x):
    return torch.tanh(x @ w)


def _jmse(a, b):
    return jnp.mean((a - b) ** 2)


def _tmse(a, b):
    return ((a - b) ** 2).mean()


def _data(seed, L, M, B=2, D=4):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((L, D, D)) * 0.5).astype(np.float32)
    mbs = rng.standard_normal((M, B, D)).astype(np.float32)
    tgt = rng.standard_normal((M, B, D)).astype(np.float32)
    return ws, mbs, tgt


def _t(x):
    return torch.from_numpy(np.array(x))


def test_pipeline_apply_equals_jax():
    """:124: the last rank's outputs equal JAX's, zeros elsewhere."""
    S, M = 4, 6
    ws, mbs, _ = _data(7, S, M, D=8)
    out = jax.jit(shard_map(
        lambda w, mb: JM.pipeline_apply(w[0], mb, "pp", _jstage)[None],
        mesh=_mesh(S), in_specs=(P("pp"), P()), out_specs=P("pp"),
        check_vma=False))(ws, mbs)
    got = TM.pipeline_apply(list(_t(ws)), _t(mbs), _tstage)
    assert len(got) == S
    for s in range(S):
        np.testing.assert_allclose(got[s].numpy(), np.asarray(out[s]),
                                   rtol=RTOL, atol=ATOL)
    assert not got[0].any()


def test_pipeline_loss_and_grads_equal_jax():
    """:152: ``pipeline_loss`` and its gradients equal JAX's."""
    S, M = 2, 3
    ws, mbs, tgt = _data(9, S, M)

    def pp_loss(w):
        return shard_map(
            lambda w_, mb, t: JM.pipeline_loss(w_[0], mb, t, "pp", _jstage,
                                               _jmse),
            mesh=_mesh(S), in_specs=(P("pp"), P(), P()), out_specs=P(),
            check_vma=False)(w, mbs, tgt)

    jl, jg = jax.jit(jax.value_and_grad(pp_loss))(ws)
    w = [x.requires_grad_() for x in _t(ws).unbind(0)]
    loss = TM.pipeline_loss(w, _t(mbs), _t(tgt), _tstage, _tmse)
    grads = torch.autograd.grad(loss, w)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    np.testing.assert_allclose(torch.stack(grads).numpy(), np.asarray(jg),
                               rtol=RTOL, atol=ATOL)


def _jax_schedule(ws, mbs, tgt, S, schedule, v_stages=1):
    return jax.jit(shard_map(
        lambda w, mb, t: JM.pipeline_loss_and_grads(
            w[0], mb, t, "pp", _jstage, _jmse, schedule=schedule,
            v_stages=v_stages),
        mesh=_mesh(S), in_specs=(P("pp"), P(), P()),
        out_specs=(P(), P("pp")), check_vma=False))(ws, mbs, tgt)


@pytest.mark.parametrize("S,M", [(4, 6), (2, 3), (4, 2)])
def test_pipeline_1f1b_equals_jax(S, M):
    """:247: the port's 1F1B equals JAX's 1F1B, and the port's GPipe the
    same numbers; (4, 2) is all warmup (M < S)."""
    ws, mbs, tgt = _data(9, S, M)
    jl, jg = _jax_schedule(ws, mbs, tgt, S, "1f1b")
    jg = np.asarray(jg).reshape(S, 4, 4)
    for schedule in ("1f1b", "gpipe"):
        loss, grads = TM.pipeline_loss_and_grads(
            list(_t(ws)), _t(mbs), _t(tgt), _tstage, _tmse,
            schedule=schedule)
        assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
        assert len(grads) == S
        np.testing.assert_allclose(torch.stack(grads).numpy(), jg,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S,V,M", [(2, 2, 4), (4, 2, 4), (2, 3, 4)])
def test_pipeline_interleaved_equals_jax(S, V, M):
    """:298: rank d's chunk v is global stage v S + d; loss and every
    chunk's gradient equal JAX's."""
    ws, mbs, tgt = _data(12, V * S, M)
    wsp = np.stack([ws[d::S] for d in range(S)])  # (S, V, D, D)
    jl, jg = _jax_schedule(wsp, mbs, tgt, S, "interleaved", V)
    loss, grads = TM.pipeline_loss_and_grads(
        list(_t(wsp)), _t(mbs), _t(tgt), _tstage, _tmse,
        schedule="interleaved", v_stages=V)
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    np.testing.assert_allclose(torch.stack(grads).numpy(),
                               np.asarray(jg).reshape(S, V, 4, 4),
                               rtol=RTOL, atol=ATOL)


def test_pipeline_interleaved_v1_equals_jax_gpipe():
    """:349: at V = 1 the interleaved schedule is the plain pipeline."""
    S, M = 4, 4
    ws, mbs, tgt = _data(15, S, M)
    jl, jg = _jax_schedule(ws, mbs, tgt, S, "gpipe")
    loss, grads = TM.pipeline_loss_and_grads(
        list(_t(ws[:, None])), _t(mbs), _t(tgt), _tstage, _tmse,
        schedule="interleaved", v_stages=1)
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    np.testing.assert_allclose(torch.stack(grads).numpy().reshape(S, 4, 4),
                               np.asarray(jg).reshape(S, 4, 4),
                               rtol=RTOL, atol=ATOL)


def test_pipeline_1f1b_head_and_input_grads_equal_jax():
    """The composed flagship's extensions of 1F1B: the loss head's
    gradients (last rank) and the stage-0 input gradients (rank 0), each
    one entry a rank with zeros elsewhere, as JAX returns them."""
    S, M = 2, 3
    ws, mbs, tgt = _data(21, S, M)
    head = np.random.default_rng(22).standard_normal(4).astype(np.float32)

    def jloss(h, y, t):
        return jnp.mean((y * h - t) ** 2)

    out = jax.jit(shard_map(
        lambda w, mb, t, h: tuple(
            x[None] for x in JM.pipeline_loss_and_grads_1f1b(
                w[0], mb, t, "pp", _jstage, jloss, head_params=h,
                return_input_grads=True)),
        mesh=_mesh(S), in_specs=(P("pp"), P(), P(), P()),
        out_specs=(P("pp"),) * 4, check_vma=False))(ws, mbs, tgt, head)
    got = TM.pipeline_loss_and_grads_1f1b(
        list(_t(ws)), _t(mbs), _t(tgt), _tstage,
        lambda h, y, t: ((y * h - t) ** 2).mean(), head_params=_t(head),
        return_input_grads=True)
    assert float(got[0]) == pytest.approx(float(out[0][0]), rel=LOSS_RTOL)
    for k in (1, 2, 3):
        assert len(got[k]) == S
        for s in range(S):
            np.testing.assert_allclose(got[k][s].numpy(),
                                       np.asarray(out[k][s]),
                                       rtol=RTOL, atol=ATOL)
    assert not got[2][0].any() and not got[3][1].any()


def test_pipeline_interleaved_constraints_and_bubble():
    """:387: M % S is refused with JAX's message, a chunk dim other than
    V too, and the bubble fractions equal JAX's."""
    ws = [torch.zeros(2, 4, 4) for _ in range(4)]
    with pytest.raises(ValueError, match="divisible"):
        TM.pipeline_apply_interleaved(ws, torch.zeros(6, 2, 4), _tstage, 2)
    with pytest.raises(ValueError, match="must equal v_stages"):
        TM.pipeline_apply_interleaved(ws, torch.zeros(8, 2, 4), _tstage, 3)
    for args in (("gpipe", 8, 16), ("1f1b", 8, 16), ("interleaved", 8, 16, 2),
                 ("interleaved", 4, 8, 3), ("gpipe", 1, 4)):
        assert TM.pipeline_bubble_fraction(*args) == \
            JM.pipeline_bubble_fraction(*args)
    with pytest.raises(ValueError, match="unknown"):
        TM.pipeline_bubble_fraction("dave", 8, 16)


def test_pipeline_unknown_schedule_raises():
    """:421, and JAX's refusal of v_stages outside the interleaved
    schedule."""
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        TM.pipeline_loss_and_grads(
            [None], torch.zeros(2, 2), torch.zeros(2, 2),
            lambda p, x: x, lambda a, b: 0.0, schedule="dave")
    with pytest.raises(ValueError, match="only applies to the interleaved"):
        TM.pipeline_loss_and_grads(
            [None], torch.zeros(2, 2), torch.zeros(2, 2),
            lambda p, x: x, lambda a, b: 0.0, schedule="1f1b", v_stages=2)
