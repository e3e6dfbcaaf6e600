"""ZeRO-1 Adam: the optimizer state split over the data-parallel axis.

The counterpart of ``accl_tpu/parallel/zero.py``.  Each dp rank owns 1/dp
of every dense leaf's float32 Adam moments (and, with master weights, of
its float32 copy), laid out as JAX lays them out: per leaf one flat
float32 array, the leaf's model shards (the mesh axes its spec splits it
over, major to minor) each flattened, zero-padded to a multiple of dp and
cut into the dp ranks' slices (``_dp_slice``).  An expert bank already
split over dp takes no further split: its moments are the bank's shards
flattened.  So a JAX state tree (``m``, ``v``, ``w``, ``step``) carries
across by ``params_from_numpy`` and back by ``params_to_numpy``.

On one device the dp ranks are virtual and their slices sit side by side
on it: the update runs once over the whole flat array, the same
elementwise formulas on the same numbers as each rank's slice in JAX,
and the "allgather" of the updated slices is the flat array itself.  So
on one card this saves no memory — state costs what unsharded Adam's
does — and the numbers are JAX's; the split saves memory across cards
(ROADMAP A9c).
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional

import torch

from ..models.transformer import (
    PartitionSpec as P,
    _check_batch,
    _global_loss,
    _mesh_dp_tp,
    _mesh_ranks,
    _nll,
    _reject_untrainable_attention,
    _sharder,
    _tree_leaves,
    _tree_map,
    param_specs,
)
from ..models.ring_attention import stripe_sequence


class AdamConfig(NamedTuple):
    """JAX's ``AdamConfig`` (:47): Adam's rates, AdamW's decoupled decay
    (skipping 1-D leaves), the warmup-cosine schedule, global-norm
    clipping and float32 master weights."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    min_lr_ratio: float = 0.0
    clip_grad_norm: Optional[float] = None
    master_weights: bool = False


def schedule_lr(cfg: AdamConfig, step):
    """The learning rate at ``step`` (1-based; a number or a tensor), a 0-d
    float32 tensor: linear warmup over ``warmup_steps``, then cosine
    decay to ``min_lr_ratio * lr`` by ``decay_steps`` when set (JAX's
    :77).  Fails fast when ``decay_steps`` does not exceed the warmup."""
    t = torch.as_tensor(step).to(torch.float32)
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=t.device)
    if cfg.decay_steps is not None and cfg.decay_steps <= cfg.warmup_steps:
        raise ValueError(
            f"decay_steps ({cfg.decay_steps}) must exceed warmup_steps "
            f"({cfg.warmup_steps})"
        )
    if cfg.warmup_steps:
        lr = lr * torch.clamp(t / float(cfg.warmup_steps), max=1.0)
    if cfg.decay_steps:
        span = cfg.decay_steps - cfg.warmup_steps
        prog = torch.clamp((t - cfg.warmup_steps) / span, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        floor = cfg.min_lr_ratio
        lr = lr * (floor + (1.0 - floor) * cos)
    return lr


def _padded(n: int, dp: int) -> int:
    return -(-n // dp) * dp


def _pad_flat(x, padded: int, dtype):
    """Row-major flatten, cast and zero-pad to ``padded``: the layout rule
    of every flat dp-sliced array."""
    flat = x.reshape(-1).to(dtype)
    if padded != flat.shape[0]:
        flat = torch.cat([flat, flat.new_zeros(padded - flat.shape[0])])
    return flat


def _dp_slice(x, dp: int, idx: int):
    """Rank ``idx``'s 1/dp slice of ``x`` flattened and padded, float32
    (JAX's :113): the slice the master copy and the update share."""
    padded = _padded(x.numel(), dp)
    n = padded // dp
    return _pad_flat(x, padded, torch.float32)[idx * n:(idx + 1) * n]


def reshard_plan(n: int, old_dp: int, new_dp: int) -> list:
    """The shard migration plan from ``old_dp`` to ``new_dp`` ranks over
    the ``_dp_slice`` layout (JAX's :127, pure integer math): one entry a
    new rank, ``{"rank", "begin", "end", "fetch": [{"src", "begin",
    "end"}, ...]}``, ``fetch`` the ranges it pulls from each old owner
    other than itself."""
    n = int(n)
    old_dp, new_dp = int(old_dp), int(new_dp)
    if n < 0 or old_dp < 1 or new_dp < 1:
        raise ValueError("reshard_plan needs n >= 0 and dp sizes >= 1")
    old_shard = _padded(n, old_dp) // old_dp
    new_shard = _padded(n, new_dp) // new_dp
    plan = []
    for j in range(new_dp):
        begin = min(j * new_shard, n)
        end = min(begin + new_shard, n)
        fetch = []
        i = begin
        while i < end:
            src = min(i // old_shard, old_dp - 1) if old_shard else 0
            seg_end = min(end, (src + 1) * old_shard) if old_shard else end
            if src != j:
                fetch.append({"src": src, "begin": i, "end": seg_end})
            i = seg_end
        plan.append({"rank": j, "begin": begin, "end": end,
                     "fetch": fetch})
    return plan


def _spec_axes(spec) -> tuple:
    """The mesh axes a spec splits over, flattened in order."""
    axes = []
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.extend(entry)
        else:
            axes.append(entry)
    return tuple(axes)


def _state_spec(pspec, dp_axis: str):
    """One leaf's flat state spec (JAX's :166): the dp slice axis inside
    the axes that split the leaf itself, or those alone when dp already
    splits it (an expert bank on dp)."""
    axes = _spec_axes(pspec)
    if dp_axis in axes:
        return P(tuple(axes))
    return P(tuple(axes) + (dp_axis,)) if axes else P(dp_axis)


def _paired(tree, *others) -> list:
    """``tree``'s leaves, each with the leaves at the same place in
    ``others`` (matched by key and index, not by order: a tree carried
    from JAX has its keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in tree
                for x in _paired(tree[k], *(o[k] for o in others))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _paired(t, *(o[i] for o in others))]
    return [(tree, *others)]


def _sizes(mesh) -> dict:
    """Axis name -> size of a mesh, every model axis named (1 where the
    mesh has no such axis)."""
    return {"dp": 1, "ep": 1, "tp": 1, **mesh.shape}


def _model_shards(p, spec, sizes: dict) -> list:
    """Views of ``p``'s shards over the axes its spec splits it over, in
    the state layout's order (those axes row-major, as a spec of several
    axes orders its blocks)."""
    axes = _spec_axes(spec)
    shards = []
    for coords in itertools.product(*(range(sizes[a]) for a in axes)):
        at = dict(zip(axes, coords))
        index = []
        for d, entry in enumerate(spec):
            names = () if entry is None else (
                tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))
            n, j = 1, 0
            for a in names:
                j, n = j * sizes[a] + at[a], n * sizes[a]
            size = p.shape[d] // n
            index.append(slice(j * size, (j + 1) * size))
        shards.append(p[tuple(index)])
    return shards


def _to_state(x, spec, sizes: dict, dp_axis: str = "dp"):
    """``x`` (a parameter or its gradient) in its state's flat float32
    layout: each model shard flattened and, unless dp splits the leaf,
    padded to a multiple of dp."""
    shards = _model_shards(x, spec, sizes)
    if dp_axis in _spec_axes(spec):
        return torch.cat([s.reshape(-1).to(torch.float32) for s in shards])
    dp = sizes[dp_axis]
    return torch.cat([_pad_flat(s, _padded(s.numel(), dp), torch.float32)
                      for s in shards])


def _from_state_(p, flat, spec, sizes: dict, dp_axis: str = "dp") -> None:
    """Write the state layout ``flat`` back into the parameter ``p`` in
    place, each shard's first elements cast to ``p``'s dtype (the
    allgather of the ranks' updated slices, and the cut of the pad)."""
    dp_local = dp_axis in _spec_axes(spec)
    at = 0
    for s in _model_shards(p, spec, sizes):
        n = s.numel()
        s.copy_(flat[at:at + n].reshape(s.shape))
        at += n if dp_local else _padded(n, sizes[dp_axis])


def init_zero_state(params, specs, mesh, dp_axis: str = "dp",
                    master_weights: bool = False) -> dict:
    """The ZeRO state of ``params`` (JAX's :194) on the mesh's device:
    ``m`` and ``v`` float32 zeros in each leaf's state layout, ``step`` a
    0-d int32 zero, and with ``master_weights`` ``w``, each leaf's
    float32 copy in the same layout."""
    sizes = _sizes(mesh)

    def zeros(p, spec):
        n = sum(s.numel() if dp_axis in _spec_axes(spec)
                else _padded(s.numel(), sizes[dp_axis])
                for s in _model_shards(p, spec, sizes))
        return torch.zeros(n, dtype=torch.float32, device=mesh.device)

    pairs = _paired(params, specs)

    def each(fn):
        it = iter(pairs)
        return _tree_map(lambda _: fn(*next(it)), params)

    state = {"m": each(zeros), "v": each(zeros),
             "step": torch.zeros((), dtype=torch.int32, device=mesh.device)}
    if master_weights:
        state["w"] = each(lambda p, spec: _to_state(p, spec, sizes, dp_axis)
                          .to(mesh.device))
    return state


def zero_state_specs(specs, dp_axis: str = "dp",
                     master_weights: bool = False) -> dict:
    """The state's spec tree (JAX's :265), matching
    :func:`init_zero_state`."""
    leafmap = lambda t: _tree_map(lambda s: _state_spec(s, dp_axis), t)
    out = {"m": leafmap(specs), "v": leafmap(specs), "step": P()}
    if master_weights:
        out["w"] = leafmap(specs)
    return out


def clip_by_global_norm(grads, specs, max_norm: float, tp_axis=None,
                        dp_axis=None, ep_axis=None, pp_axis=None):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``
    (JAX's :287); returns ``(clipped, norm)``.  On one device every leaf
    is whole, so JAX's psums over the axes that split a leaf are
    identities; the leaves' squared sums add in JAX's buckets (by those
    axes) so the sum runs in its order."""
    buckets: dict = {}
    for g, s in _paired(grads, specs):
        axes = tuple(a for a in (tp_axis, dp_axis, ep_axis, pp_axis)
                     if a is not None and a in _spec_axes(s))
        ss = torch.sum(torch.square(g.to(torch.float32)))
        buckets[axes] = buckets.get(axes, 0.0) + ss
    total = torch.zeros((), dtype=torch.float32,
                        device=_tree_leaves(grads)[0].device)
    for ss in buckets.values():
        total = total + ss
    norm = torch.sqrt(total)
    scale = (max_norm / torch.clamp(norm, min=max_norm)).to(torch.float32)
    clipped = _tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                        grads)
    return clipped, norm


def zero_adam_update(params, grads, state, dp_axis: str, cfg: AdamConfig,
                     specs=None, mesh=None):
    """One ZeRO Adam step (JAX's :321), IN PLACE: ``params`` and the
    state's ``m``, ``v``, ``w`` and ``step`` are written in their own
    storage (the port's form of JAX's donation) and returned as
    ``(params, state)``.

    Each leaf's gradient goes into its state layout; the moments, the
    bias corrections, AdamW's decay (leaves of more than one dimension)
    and the scheduled rate are JAX's, on the master copy when the state
    has one, else on the parameter's own layout; the parameter takes the
    result cast to its dtype.  ``specs`` (the parameter specs) mark the
    leaves dp already splits (expert banks on dp: no pad) and, with
    ``mesh`` (default one rank), give every leaf's layout."""
    sizes = _sizes(mesh) if mesh is not None else {"dp": 1, "ep": 1, "tp": 1}
    if specs is None:
        specs = _tree_map(lambda p: P(*([None] * p.dim())), params)
    master = state.get("w", _tree_map(lambda _: None, params))
    leaves = _paired(params, grads, state["m"], state["v"], master, specs)
    state["step"].add_(1)
    t = state["step"].to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr_t = schedule_lr(cfg, state["step"])
    with torch.no_grad():
        for p, g, m, v, w, spec in leaves:
            gs = _to_state(g, spec, sizes, dp_axis)
            m.mul_(cfg.b1).add_((1.0 - cfg.b1) * gs)
            v.mul_(cfg.b2).add_((1.0 - cfg.b2) * gs * gs)
            del gs
            shard = _to_state(p, spec, sizes, dp_axis) if w is None else w
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and p.dim() > 1:
                upd = upd + cfg.weight_decay * shard
            new_w = shard - lr_t * upd
            del upd
            _from_state_(p, new_w, spec, sizes, dp_axis)
            if w is not None:
                w.copy_(new_w)
    return params, state


def make_zero_train_step(model_cfg, mesh=None, adam: AdamConfig = AdamConfig(),
                         accum_steps: int = 1):
    """The dp x tp train step with ZeRO Adam (JAX's :440): ``(step, shard,
    init_state)``; ``step(params, state, tokens, targets)`` returns
    ``(params, state, loss)``, params and state updated in place.

    The loss is the SGD maker's global mean (each rank's local loss with
    its router penalty; under ``context_parallel`` the tokens striped
    over the tp ring).  ``accum_steps > 1`` splits each data rank's rows
    into that many microbatches, one forward / backward each, their
    float32 gradient sum over the steps (JAX's scan) feeding one update;
    ``adam.clip_grad_norm`` clips the gradient by its global norm first.
    ``mesh``: one rank, or a ``("dp", "tp")`` / ``("dp", "ep", "tp")``
    mesh of virtual ranks whose tp is 1 or the cp ring; the moments split
    over dp as JAX splits them (:func:`zero_adam_update`)."""
    _reject_untrainable_attention(model_cfg)
    mesh, data, tp, ep = _mesh_dp_tp(model_cfg, mesh)
    schedule_lr(adam, 1)  # fail fast on a decay before the warmup's end
    specs = param_specs(model_cfg)
    ring = tp if model_cfg.context_parallel else None
    ranks = _mesh_ranks(model_cfg, data, ring, ep)
    ep_ax = (model_cfg.moe_mesh_axis
             if model_cfg.n_experts and model_cfg.moe_mesh_axis != "dp"
             else None)
    if accum_steps < 1:
        raise ValueError(f"accum_steps ({accum_steps}) must be >= 1")

    def loss_of(tree, tokens, targets):
        nll, aux = _nll(tree, tokens, targets, model_cfg, ring, ranks)
        return _global_loss(nll, aux, model_cfg, data, ring)

    def step(params, state, tokens, targets):
        leaves = _tree_leaves(params)
        _check_batch(tokens, leaves[0].device, data)
        if ring is not None:
            tokens = stripe_sequence(tokens, ring, axis=1)
            targets = stripe_sequence(targets, ring, axis=1)
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        tree = _tree_map(lambda _: next(it), params)
        if accum_steps == 1:
            loss = loss_of(tree, tokens, targets)
            grads = torch.autograd.grad(loss, live)
        else:
            b = tokens.shape[0] // data
            if b % accum_steps:
                raise ValueError(
                    f"per-rank batch ({b}) must divide by accum_steps "
                    f"({accum_steps})"
                )
            mb = b // accum_steps

            def micro(x, j):  # every data rank's microbatch j
                return x.reshape(data, accum_steps, mb, -1)[:, j].reshape(
                    data * mb, -1)

            lsum, gsum = 0.0, None
            for j in range(accum_steps):
                loss = loss_of(tree, micro(tokens, j), micro(targets, j))
                g = torch.autograd.grad(loss, live)
                gsum = ([x.to(torch.float32) for x in g] if gsum is None
                        else [a + x.to(torch.float32)
                              for a, x in zip(gsum, g)])
                lsum = lsum + loss.detach()
                del g
            loss = lsum / accum_steps
            grads = [g / accum_steps for g in gsum]
            del gsum
        it = iter(grads)
        grads = _tree_map(lambda _: next(it), params)
        if adam.clip_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, specs, adam.clip_grad_norm,
                                           "tp", "dp", ep_ax)
        zero_adam_update(params, grads, state, "dp", adam, specs, mesh)
        return params, state, loss.detach()

    def init_state(params):
        return init_zero_state(params, specs, mesh,
                               master_weights=adam.master_weights)

    return step, _sharder(mesh), init_state
