"""The mixture-of-experts FFN with expert parallelism over virtual ranks.

The counterpart of ``accl_tpu/models/moe.py``: top-k gated routing
(Switch at k = 1), a fixed per-expert capacity so every shape is static,
the ``(E, cap, D)`` dispatch buffer, the all-to-all over the expert axis,
the batched expert FFN, the inverse all-to-all and the combine, and the
router's health terms.

On one device the expert axis's ranks are virtual: ``x`` carries a
leading rank axis, each rank routes ITS tokens (its own capacity, its own
slot order, JAX's per-rank semantics inside ``shard_map``), and the
all-to-all is the ``(src_rank, owner_rank)`` transpose of the ranks'
dispatch buffers.  JAX's all-to-all is ``lax.all_to_all`` (``:124,141``),
not a Pallas kernel, so here it is plain PyTorch, as the expert GEMMs
(``jnp.einsum`` there) are ``torch.bmm``; across cards it becomes NCCL
(ROADMAP A9c).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.driver import resolve_device

#: why tensor parallelism inside an expert is refused
_TP_LATER = ("tensor parallelism within an expert (tp_axis) is not ported "
             "yet: it comes with the multi-GPU tensor-parallel slice "
             "(ROADMAP B14)")


def init_moe_params(d_model: int, d_ff: int, n_experts: int,
                    generator: torch.Generator, dtype=torch.float32,
                    device=None) -> dict:
    """Gate and per-expert FFN weights (JAX's ``init_moe_params`` :28):
    normal draws from ``generator`` (in float32 on its own device, then
    cast to ``dtype``) scaled by ``d_model ** -0.5`` (the gate, ``w1``) and
    ``d_ff ** -0.5`` (``w2``), on ``device`` (the card unless the caller
    passes ``device="cpu"``).  The draws cannot equal JAX's PRNG: carry a
    JAX tree across with ``params_from_numpy``."""
    dev = resolve_device(device)

    def normal(scale, *shape):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=dtype)

    return {
        "gate": normal(d_model ** -0.5, d_model, n_experts),
        "w1": normal(d_model ** -0.5, n_experts, d_model, d_ff),
        "w2": normal(d_ff ** -0.5, n_experts, d_ff, d_model),
    }


def _top_k(probs, k: int):
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index (a stable descending sort keeps equal values in index order,
    where ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _all_to_all(buf, ep: int):
    """The expert axis's all-to-all over the ranks' stacked buffers: ``buf``
    (R, E, C, D), rank r's chunk e for expert e, becomes (E, R / ep * ep *
    C, D): each expert's rows from every rank of its group, ordered
    (group, source rank, slot) — JAX's ``(src_rank, local_expert)``
    transpose (:121-133) with every group's owners side by side."""
    R, E, C, D = buf.shape
    g, el = R // ep, E // ep
    return (buf.reshape(g, ep, ep, el, C, D).permute(2, 3, 0, 1, 4, 5)
            .reshape(E, g * ep * C, D))


def _all_to_all_back(out, R: int, ep: int):
    """The inverse all-to-all (:139-147): the experts' rows back to their
    source ranks, (R, E, C, D)."""
    E, _, D = out.shape
    g, el = R // ep, E // ep
    return (out.reshape(ep, el, g, ep, -1, D).permute(2, 3, 0, 1, 4, 5)
            .reshape(R, E, -1, D))


def moe_ffn(x, params: dict, ep: Optional[int] = None,
            capacity_factor: float = 1.5, k: int = 1,
            return_aux: bool = False, tp_axis=None):
    """Top-k gated MoE FFN (JAX's ``moe_ffn`` :41).

    ``ep=None``: ``x`` is (B, T, D) on one rank and every expert is local
    (JAX without ``ep_axis``).  ``ep`` = n: ``x`` is (R, B, T, D), the
    local tokens of R virtual ranks, R a multiple of n; each run of n
    consecutive ranks is one expert group, rank j of a group owning
    experts [j E / n, (j + 1) E / n) of the bank ``params["w1"]`` /
    ``["w2"]`` (E, ...) — the ranks' shards stacked, as JAX's
    ``P("ep")`` stacks them — and ``params["gate"]`` replicated.  Every
    rank routes its own N = B T tokens with its own capacity
    ``max(1, int(capacity_factor * N * k / E))``; dispatch and combine
    run through the group's all-to-all.

    Returns y, the expert outputs weighted by their gate probabilities
    (over-capacity entries add zero: callers add the residual), shaped
    like ``x``.  ``return_aux=True`` also returns ``{"load_balance",
    "router_z"}`` over each rank's own tokens, float32: scalars without
    ``ep``, (R,) with it.  ``tp_axis`` (an expert's d_ff split over tp)
    is refused (ROADMAP B14)."""
    if tp_axis is not None:
        raise NotImplementedError(_TP_LATER)
    if ep is None:
        out = moe_ffn(x[None], params, 1, capacity_factor, k, return_aux)
        if not return_aux:
            return out[0]
        y, aux = out
        return y[0], {name: v[0] for name, v in aux.items()}
    R, B, T, D = x.shape
    E = params["w1"].shape[0]
    if ep < 1 or R % ep or E % ep:
        raise ValueError(f"{R} ranks and {E} experts must divide by the "
                         f"expert axis's {ep} ranks")
    N = B * T
    flat = x.reshape(R, N, D)
    dt = x.dtype

    # routing, each rank on its own tokens (:88-106)
    logits = flat @ params["gate"]  # (R, N, E), x's dtype
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_e = _top_k(probs, k)  # (R, N, k)
    if k > 1:
        # top-k renormalizes over the chosen experts; k = 1 keeps the raw
        # probability, so the router keeps a gradient
        topk_p = topk_p / topk_p.sum(-1, keepdim=True)
    expert = topk_e.reshape(R, N * k)  # entries, token-major
    gate_p = topk_p.reshape(R, N * k)
    entry_tok = torch.arange(N, device=x.device).repeat_interleave(k)

    # the fixed capacity and each entry's slot in its expert's buffer, from
    # the cumulative one-hot count (:108-113)
    cap = max(1, int(capacity_factor * N * k / E))
    onehot = F.one_hot(expert, E).to(torch.int32)  # (R, N k, E)
    slot = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    keep = (slot >= 0) & (slot < cap)
    slot_c = slot.clamp(0, cap - 1)
    rank = torch.arange(R, device=x.device)[:, None].expand(R, N * k)

    # dispatch: (E, cap, D) a rank, scattered by (expert, slot); the
    # entries kept are unique, the dropped ones add zero (:116-119)
    disp = torch.zeros((R, E, cap, D), dtype=dt, device=x.device)
    disp = disp.index_put((rank, expert, slot_c),
                          flat[:, entry_tok] * keep[..., None].to(dt),
                          accumulate=True)

    # the all-to-all, the batched expert FFN (gelu's tanh form, JAX's
    # default) and the inverse all-to-all (:121-147)
    work = _all_to_all(disp, ep)
    h = F.gelu(torch.bmm(work, params["w1"]), approximate="tanh")
    combined = _all_to_all_back(torch.bmm(h, params["w2"]), R, ep)

    # combine: each entry's expert output, weighted by its gate, a token's
    # k entries summed (:149-153)
    got = combined[rank, expert, slot_c]  # (R, N k, D)
    weighted = got * (gate_p * keep.to(dt))[..., None]
    y = weighted.reshape(R, N, k, D).sum(2).reshape(R, B, T, D)
    if not return_aux:
        return y
    # the Switch load balance and the ST-MoE z-loss, float32 (:160-170)
    f = onehot.float().mean(1)  # (R, E) entry fractions
    P = probs.float().mean(1)
    load_balance = float(E) * (f * P).sum(-1)
    router_z = (torch.logsumexp(logits.float(), dim=-1) ** 2).mean(-1)
    return y, {"load_balance": load_balance, "router_z": router_z}
