"""Composed parallelism: pipeline x data x tensor in one train step.

The counterpart of ``accl_tpu/models/composed.py`` on a ``("pp", "dp",
"tp")`` mesh of virtual ranks on one device, tp = 1 (dense tensor
parallelism across cards comes with ROADMAP B14).  Each pp rank owns a
contiguous span of blocks, stored STACKED (a leading layer axis cut over
pp, :func:`stack_params`); the batch's rows split over dp and into
microbatches that stream through the stages by ``models/pipeline.py``'s
schedules; the embedding, the position table and the final layer norm
are replicated.

On one device the dp ranks' rows of a microbatch travel the pipeline as
one activation (every layer mixes no rows, so each rank's rows see the
same math), and a stage's layers run once a microbatch.  The replicated
parameters keep one copy a (pp, dp) rank, as under JAX's ``shard_map``:
each rank's copy takes the gradient of what that rank computed with it
(the embedding lookup on pp rank 0, the loss head on the last), and the
psums JAX's transposes place over pp and dp are sums over the ranks'
copies, each rank adding in ring order from itself (:func:`_psum`).  The
step updates rank (0, 0)'s sums; ``debug_invariants`` compares every
rank's own copy with its neighbours' on each axis.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..ops.driver import Mesh
from .pipeline import (_grad_trees, _live, _one_f_one_b, pipeline_apply,
                       pipeline_apply_interleaved)
from .transformer import (
    PartitionSpec as P,
    TransformerConfig,
    _block,
    _check_batch,
    _embed_rows,
    _layernorm,
    _lr_scalar,
    _mesh_pp_dp_tp,
    _refuse_dense_tp,
    _reject_untrainable_attention,
    _token_nll,
    _tree_leaves,
    _tree_map,
    sgd_update_,
)

#: the replicated leaves (one copy a (pp, dp) rank)
_REPLICATED = ("embed", "ln_f", "pos")


def stacked_param_specs(cfg: TransformerConfig) -> Dict:
    """The STACKED tree's specs (JAX's :63): per-layer leaves gain a
    leading layer axis split over ``pp``, the Megatron column / row specs
    over ``tp`` within a layer; the embedding and final norm replicate."""
    layer = {
        "wq": P("pp", None, "tp"),
        "wk": P("pp", None, "tp"),
        "wv": P("pp", None, "tp"),
        "wo": P("pp", "tp", None),
        "w1": P("pp", None, "tp"),
        "w2": P("pp", "tp", None),
        "ln1": P("pp", None),
        "ln2": P("pp", None),
    }
    out = {"embed": P(None, None), "ln_f": P(None), "layers": layer}
    if not cfg.uses_rope():
        out["pos"] = P(None, None)
    return out


def stack_params(params: Dict) -> Dict:
    """The flagship's per-layer list -> one stacked tensor a leaf, a
    leading layer axis (JAX's :88)."""
    layers = params["layers"]
    stacked = {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": stacked}


def unstack_params(params: Dict) -> Dict:
    """The inverse of :func:`stack_params` (JAX's :99): the layers as a
    list of views of the stacked leaves."""
    L = params["layers"]["wq"].shape[0]
    layers = [{k: v[i] for k, v in params["layers"].items()}
              for i in range(L)]
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": layers}


def _psum_identity_bwd(x, axis_name=None):
    """JAX's psum whose transpose is the identity (:120), placed at the
    block's row-parallel exits under the hand-written 1F1B backward.  At
    tp = 1 the block has no tp reduction, so it is the identity; the
    multi-GPU slice (ROADMAP B14) gives it its all-reduce."""
    return x


def _fanout_psum_bwd(x, axis_name=None):
    """JAX's identity whose transpose is a psum (:141), placed where a
    replicated activation fans out into tp-split branches.  At tp = 1 the
    identity both ways (ROADMAP B14 gives it its backward all-reduce)."""
    return x


def interleave_layer_order(n_layers: int, pp: int, v_stages: int):
    """The device-major layer permutation of the interleaved schedule
    (JAX's :153): position k of the permuted stack holds old layer
    ``perm[k]``, so rank d's contiguous slice holds its ``v_stages``
    round-robin chunks (global stage v pp + d) in (chunk, layer) order."""
    ls = n_layers // (v_stages * pp)
    perm = []
    for d in range(pp):
        for v in range(v_stages):
            j = v * pp + d
            perm.extend(range(j * ls, (j + 1) * ls))
    return perm


class _Rows:
    """A stacked leaf given as its rows (per-layer tensors): ``len``,
    ``shape[0]`` and ``[i]`` as the stacked tensor's, so the pipeline's
    chunk indexing and a stage's layer walk take it as that tensor."""

    def __init__(self, rows):
        self.rows = list(rows)
        self.shape = (len(self.rows),)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _psum(grid, axis: int, every: bool):
    """The psum over one axis of per-rank values ``grid[p][d]`` (None: a
    rank holding nothing, JAX's masked zeros): each rank's own sum, added
    in ring order from itself.  ``every=False`` gives rank 0's alone on
    that axis (the copy the step uses)."""
    n_p, n_d = len(grid), len(grid[0])
    n = (n_p, n_d)[axis]
    rows = range(n_p) if (axis == 1 or every) else [0]
    cols = range(n_d) if (axis == 0 or every) else [0]
    out = []
    for p in rows:
        row = []
        for d in cols:
            acc = None
            for k in range(n):
                t = (grid[(p + k) % n_p][d] if axis == 0
                     else grid[p][(d + k) % n_d])
                if t is not None:
                    acc = t if acc is None else acc + t
            row.append(acc)
        out.append(row)
    return out


def _repl_err(grid) -> torch.Tensor:
    """JAX's neighbour compare (:390): the largest |v - v shifted by one|
    along each axis of more than one rank, over every rank's own copy
    (float32)."""
    err = torch.zeros((), dtype=torch.float32, device=grid[0][0].device)
    n_p, n_d = len(grid), len(grid[0])
    for p in range(n_p):
        for d in range(n_d):
            v = grid[p][d].to(torch.float32)
            for q, e in (((p + 1) % n_p, d), (p, (d + 1) % n_d)):
                if (q, e) != (p, d):
                    err = torch.maximum(err, (v - grid[q][e].to(
                        torch.float32)).abs().max())
    return err


def make_pp_train_step(cfg: TransformerConfig, mesh: Mesh,
                       num_microbatches: int, lr: float = 1e-2,
                       v_stages: int = 1, schedule: str = "gpipe",
                       adam=None, debug_invariants: bool = False):
    """One SGD step over a ``("pp", "dp", "tp")`` mesh of virtual ranks
    (JAX's :168), tp = 1: ``(step, shard)``, ``step(params, tokens,
    targets) -> (params, loss)``, the stacked parameters (committed by
    ``shard``, which stacks a flagship tree onto the mesh's device)
    updated IN PLACE and returned.  ``tokens`` / ``targets`` are the
    global batch, its rows split over dp; a dp rank's rows divide into
    ``num_microbatches``.

    ``schedule="gpipe"`` differentiates the pipeline by autograd;
    ``"1f1b"`` runs the hand-scheduled backward
    (``pipeline._one_f_one_b``), the embedding's vjp in front and the
    loss head's gradients behind, the replicated leaves' psums placed by
    hand as JAX's :318-420 places them.  ``v_stages > 1`` runs the
    interleaved schedule; ``shard`` commits the layers permuted
    (:func:`interleave_layer_order`).

    ``adam`` (``parallel.zero.AdamConfig``) makes it the ZeRO-1 Adam
    step: ``(step, shard, init_state)``, ``step(params, state, tokens,
    targets) -> (params, state, loss)``, the moments (and master weights)
    in JAX's flat dp-sliced layout nested inside the stage split, the
    global-norm clip over every axis.  ``debug_invariants=True`` appends
    a float32 scalar: the largest difference between a (pp, dp) rank's
    own copy of the loss and of the embed / ln_f / pos gradients and its
    neighbour's, 0 up to the sums' rounding when every psum is placed."""
    _reject_untrainable_attention(cfg)
    if cfg.seq_parallel:
        raise ValueError(
            "make_pp_train_step does not compose with seq_parallel yet: "
            "the pipeline streams full-sequence microbatch activations "
            "between stages (sequence-shard them with the standalone "
            "Megatron-SP train step, or request the composition)"
        )
    pp, dp, tp = _mesh_pp_dp_tp(mesh)
    V = int(v_stages)
    if V < 1:
        raise ValueError(f"v_stages ({V}) must be >= 1")
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown composed pipeline schedule {schedule!r}")
    if schedule == "1f1b" and V != 1:
        raise ValueError(
            "schedule='1f1b' does not compose with v_stages > 1 yet"
        )
    if cfg.n_layers % (V * pp):
        raise ValueError(
            f"n_layers ({cfg.n_layers}) must divide by v_stages * pp "
            f"({V} * {pp})"
        )
    ls = cfg.n_layers // (V * pp)  # layers a (virtual) stage
    if cfg.n_heads % tp:
        raise ValueError(
            f"n_heads ({cfg.n_heads}) must divide by tp ({tp})"
        )
    if cfg.vocab_parallel:
        raise ValueError(
            "vocab_parallel is supported on the decoder flagship only "
            "(forward/loss_fn/generate), not the composed pipeline"
        )
    if cfg.context_parallel:
        raise ValueError(
            "context_parallel is supported on the decoder flagship only "
            "(forward/loss_fn), not the composed pipeline"
        )
    if cfg.n_experts:
        raise ValueError(
            "n_experts (MoE) is supported on the decoder flagship only "
            "(forward/loss_fn/generate), not the composed pipeline"
        )
    _refuse_dense_tp(tp)
    if adam is None:
        _lr_scalar(lr)  # refuse what the update cannot hold, before work
    M = int(num_microbatches)
    specs = stacked_param_specs(cfg)
    rope_base = cfg.rope_base if cfg.uses_rope() else None

    def block(x, lp):
        return _block(x, lp, cfg.n_heads, attn_impl=cfg.attention,
                      rope_base=rope_base)

    def stage_fn(stage_layers, x):
        """A stage's span of layers (each leaf a sequence of per-layer
        tensors), block by block, each recomputed on the backward pass
        under ``cfg.remat``."""
        for i in range(len(stage_layers["wq"])):
            lp = {k: a[i] for k, a in stage_layers.items()}
            if cfg.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(block, x, lp, use_reentrant=False)
            else:
                x = block(x, lp)
        return x

    def stages(layers, chunked: bool = True) -> List[dict]:
        """The pp ranks' stage parameters from the stacked leaves: each
        rank's contiguous span, a leaf the sequence of its layers' rows
        (one ``unbind`` a leaf, so a gradient stacks once instead of
        scattering into the whole stack at every layer's use); under the
        interleaved schedule a leaf holds the rank's V chunks of ls
        layers (``chunked``; else the span's layers as a list)."""
        n = V * ls
        rows = {k: a.unbind(0) for k, a in layers.items()}
        out = []
        for s in range(pp):
            span = {k: r[s * n:(s + 1) * n] for k, r in rows.items()}
            if not chunked:
                out.append({k: list(r) for k, r in span.items()})
            elif V == 1:
                out.append({k: _Rows(r) for k, r in span.items()})
            else:
                out.append({k: _Rows([_Rows(r[v * ls:(v + 1) * ls])
                                      for v in range(V)])
                            for k, r in span.items()})
        return out

    def loss_head(y, tgt, ln_f, embed):
        """The last stage's head (JAX's :313): final norm, tied unembed,
        the mean cross entropy, its softmax statistics in float32 as the
        flagship's loss takes them (JAX's composed head takes them in the
        activation dtype; ROADMAP §C)."""
        return _token_nll(_layernorm(y, ln_f) @ embed.T, tgt).mean()

    def grid(fill):
        return [[fill(p, d) for d in range(dp)] for p in range(pp)]

    def reduce_pp_dp(g, scale=None):
        """psum over pp, then over dp (each rank's own copy), optionally
        divided; every rank's copies under ``debug_invariants``."""
        out = _psum(_psum(g, 0, debug_invariants), 1, debug_invariants)
        if scale is not None:
            out = [[v / scale for v in row] for row in out]
        return out

    def embed_rows(rep, tokens_d, p, d):
        x = _embed_rows(rep["embed"][p][d], tokens_d)
        if "pos" in rep:
            x = x + rep["pos"][p][d][: tokens_d.shape[1]]
        return x

    def compute_grads(params, tokens, targets):
        """(loss, grads, invariant error or None) by the schedule."""
        B, T = tokens.shape
        b = B // dp  # a dp rank's rows
        if b % M:
            raise ValueError(
                f"per-dp-rank batch ({b}) must divide into "
                f"num_microbatches ({M})"
            )
        mb = b // M
        rows = [slice(d * mb, (d + 1) * mb) for d in range(dp)]

        def microbatched(x):  # the dp ranks' microbatch m as one tensor
            return (x.reshape((dp, M, mb) + x.shape[1:]).transpose(0, 1)
                    .reshape((M, dp * mb) + x.shape[1:]))

        tgts = microbatched(targets)
        keys = [k for k in _REPLICATED if k in params]
        # one copy of each replicated leaf a (pp, dp) rank
        rep = {k: grid(lambda p, d, k=k: params[k].detach()
                       .requires_grad_()) for k in keys}
        embed_in = [embed_rows(rep, tokens[d * b:(d + 1) * b], 0, d)
                    for d in range(dp)]
        mbs = microbatched(torch.cat(embed_in))

        if schedule == "gpipe":
            layers = _live(params["layers"])
            st = stages(layers)
            outs = (pipeline_apply(st, mbs, stage_fn) if V == 1 else
                    pipeline_apply_interleaved(st, mbs, stage_fn, V))[-1]
            per_mb = [[loss_head(outs[m][rows[d]], tgts[m][rows[d]],
                                 rep["ln_f"][pp - 1][d],
                                 rep["embed"][pp - 1][d])
                       for m in range(M)] for d in range(dp)]
            local = grid(lambda p, d: torch.stack(per_mb[d]).mean()
                         if p == pp - 1 else None)
            losses = reduce_pp_dp(local, dp)
            loss = losses[0][0]
            # the copies a rank computed with: the lookup on pp rank 0,
            # the head on the last; the others took no gradient
            used = {"embed": {0, pp - 1}, "pos": {0}, "ln_f": {pp - 1}}
            taken = [(k, p, d) for k in keys for p in sorted(used[k])
                     for d in range(dp)]
            g_layers, g_rep = _grad_trees(
                loss, [layers, [rep[k][p][d] for k, p, d in taken]])
            contrib = {k: grid(lambda p, d: None) for k in keys}
            for (k, p, d), g in zip(taken, g_rep):
                contrib[k][p][d] = g
            sums = {k: reduce_pp_dp(contrib[k]) for k in keys}
        else:
            head = {"ln_f": rep["ln_f"][pp - 1], "embed": rep["embed"][pp - 1]}

            def head_loss(hp, y, tgt):  # one term a dp rank
                return torch.stack([loss_head(y[rows[d]], tgt[rows[d]],
                                              hp["ln_f"][d], hp["embed"][d])
                                    for d in range(dp)])

            loss_sum, stage_g, head_g, in_g = _one_f_one_b(
                stages(params["layers"], chunked=False), mbs.detach(), tgts,
                stage_fn,
                head_loss, head, input_grads=True)
            # the stage-0 input gradients (psummed over pp: every rank
            # holds rank 0's) through each dp rank's embedding
            in_g = in_g.reshape((M, dp, mb) + in_g.shape[2:]).transpose(0, 1)
            path = {k: [None] * dp for k in ("embed", "pos") if k in keys}
            for d in range(dp):
                gs = torch.autograd.grad(
                    embed_in[d], [rep[k][0][d] for k in path],
                    in_g[d].reshape(embed_in[d].shape))
                for k, g in zip(path, gs):
                    path[k][d] = g.to(torch.float32)
            local = grid(lambda p, d: loss_sum[d] / M if p == pp - 1
                         else None)
            losses = reduce_pp_dp(local, dp)
            loss = losses[0][0]
            head_e = _psum(grid(lambda p, d: head_g["embed"][d]
                                if p == pp - 1 else None), 0,
                           debug_invariants)
            sums = {"embed": _psum([[path["embed"][d] + h[d]
                                     for d in range(dp)] for h in head_e],
                                   1, debug_invariants),
                    "ln_f": reduce_pp_dp(grid(
                        lambda p, d: head_g["ln_f"][d] if p == pp - 1
                        else None))}
            if "pos" in path:
                sums["pos"] = _psum([path["pos"]] * len(head_e), 1,
                                    debug_invariants)
            sums = {k: [[(v / dp).to(params[k].dtype) for v in row]
                         for row in s] for k, s in sums.items()}
            # the stage gradients stacked, dp-averaged leaf by leaf (a
            # 16-bit quotient rounds once from float32, as JAX's)
            g_layers = {}
            for k in params["layers"]:
                g_layers[k] = torch.stack(
                    [g for st in stage_g for g in st.pop(k)]).div_(dp)
        # in the parameters' own key order: the update pairs leaves by it
        grads = {k: g_layers if k == "layers" else sums[k][0][0]
                 for k in params}
        inv = None
        if debug_invariants:
            inv = _repl_err(losses)
            for k in keys:
                inv = torch.maximum(inv, _repl_err(sums[k]))
            inv = inv.detach()
        return loss.detach(), grads, inv

    def step(params, tokens, targets):
        leaves = _tree_leaves(params)
        _check_batch(tokens, leaves[0].device, dp)
        loss, grads, inv = compute_grads(params, tokens, targets)
        with torch.no_grad():
            sgd_update_(leaves, _tree_leaves(grads), lr)
        if debug_invariants:
            return params, loss, inv
        return params, loss

    def zero_step(params, state, tokens, targets):
        from ..parallel.zero import clip_by_global_norm, zero_adam_update

        _check_batch(tokens, _tree_leaves(params)[0].device, dp)
        loss, grads, inv = compute_grads(params, tokens, targets)
        if adam.clip_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, specs, adam.clip_grad_norm,
                                           "tp", "dp", pp_axis="pp")
        zero_adam_update(params, grads, state, "dp", adam, specs, mesh)
        if debug_invariants:
            return params, state, loss, inv
        return params, state, loss

    def _stacked(params):
        stacked = stack_params(_tree_map(
            lambda a: a.to(mesh.device, copy=True), params))
        if V > 1:
            perm = torch.tensor(interleave_layer_order(cfg.n_layers, pp, V))
            stacked["layers"] = {
                k: a.index_select(0, perm.to(a.device))
                for k, a in stacked["layers"].items()}
        return stacked

    if adam is None:
        return step, _stacked

    from ..parallel.zero import init_zero_state, schedule_lr

    schedule_lr(adam, 1)  # fail fast on a decay before the warmup's end

    def init_state(params):
        return init_zero_state(_stacked(params), specs, mesh,
                               master_weights=adam.master_weights)

    return zero_step, _stacked, init_state
