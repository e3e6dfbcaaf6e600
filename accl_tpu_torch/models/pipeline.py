"""Pipeline parallelism over a ``pp`` axis of virtual ranks on one device.

The counterpart of ``accl_tpu/models/pipeline.py``.  JAX runs these
functions inside ``shard_map`` over the ``pp`` mesh axis, each rank
holding its own stage's parameters; here a function takes the ranks'
stage parameters as a list (``stage_params[s]`` is rank s's, rank
order), the convention of the port's sequence-parallel functions:
``lax.axis_size`` is the list's length, ``lax.axis_index`` the position,
and a ``ppermute`` hop hands a rank's activation to the next entry.  A
result that varies over the axis comes back one entry a rank, zeros off
the rank that holds it, as JAX's do; a result JAX psums over the axis
(a loss) comes back once.

The schedules are JAX's tick for tick: GPipe streams M microbatches
through S stages in M + S - 1 ticks, stage s working on microbatch t - s
at tick t; the interleaved schedule walks each device's work queue of V
round-robin chunks in M V + S - 1 ticks; 1F1B runs JAX's forward and
backward ticks (:func:`pipeline_loss_and_grads_1f1b`).  JAX's ranks run
every tick and mask an idle one's result with ``jnp.where``; on one
device a tick with no valid microbatch for a rank is skipped, so no
stage computes on a bubble (the results are JAX's).  ``microbatches``
and ``targets`` are (M, ...) tensors, replicated as in JAX (stage 0
reads the microbatches, the last stage the targets).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from .transformer import _tree_leaves, _tree_map


def _ranks(stage_params) -> int:
    if not isinstance(stage_params, (list, tuple)) or not stage_params:
        raise ValueError("stage_params is the pp axis: a list of the ranks' "
                         "stage parameters, one entry a rank")
    return len(stage_params)


def _rebuild(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def pipeline_apply(stage_params: Sequence, microbatches: torch.Tensor,
                   stage_fn: Callable) -> List[torch.Tensor]:
    """Run ``microbatches`` (M, ...) through the S-stage pipeline (JAX's
    :40): ``stage_fn(stage_params[s], x) -> y`` is stage s, its input and
    output of one shape and dtype.  Returns one (M, ...) entry a rank:
    the final stage's outputs on the LAST rank, zeros on the others.
    Differentiable by autograd (JAX's GPipe backward)."""
    S = _ranks(stage_params)
    M = microbatches.shape[0]
    carry = [None] * S  # the activation arriving at each rank
    outs = [None] * M
    for t in range(M + S - 1):
        sent = [None] * S
        for s in range(S):
            mb = t - s
            if not 0 <= mb < M:
                continue  # a bubble tick: JAX computes and masks it
            act = stage_fn(stage_params[s],
                           microbatches[mb] if s == 0 else carry[s])
            if s == S - 1:
                outs[mb] = act
            else:
                sent[s + 1] = act  # the stage handoff: one hop
        carry = sent
    last = torch.stack(outs).to(microbatches.dtype)
    return [torch.zeros_like(microbatches) for _ in range(S - 1)] + [last]


def pipeline_apply_interleaved(stage_params: Sequence,
                               microbatches: torch.Tensor,
                               stage_fn: Callable,
                               v_stages: int) -> List[torch.Tensor]:
    """The interleaved virtual-stage forward (JAX's :100): rank d owns
    ``v_stages`` chunks (each leaf of ``stage_params[d]`` has a leading
    (V,) chunk dim), global stage j = v S + d its chunk v, and a
    microbatch hops rank 0, 1, .., S - 1 and wraps to rank 0 for the next
    chunk.  Rank d at tick t runs queue item q = t - d: round r = q //
    (V S), chunk v = (q % (V S)) // S, microbatch r S + q % S.  Needs M %
    S == 0.  Returns one (M, ...) entry a rank, the outputs on the last,
    zeros elsewhere."""
    S = _ranks(stage_params)
    M = microbatches.shape[0]
    V = int(v_stages)
    if M % S:
        raise ValueError(
            f"interleaved schedule needs microbatches ({M}) divisible "
            f"by pipeline stages ({S})"
        )
    for ps in stage_params:
        for leaf in _tree_leaves(ps):
            if leaf.shape[0] != V:
                raise ValueError(
                    f"stage_params leading chunk dim ({leaf.shape[0]}) must "
                    f"equal v_stages ({V})"
                )
    carry = [None] * S
    outs = [None] * M
    for t in range(M * V + S - 1):
        sent = [None] * S
        for d in range(S):
            q = t - d
            if not 0 <= q < M * V:
                continue
            v = (q % (V * S)) // S
            m = (q // (V * S)) * S + q % S
            chunk = _tree_map(lambda p: p[v], stage_params[d])
            inp = microbatches[m] if (d == 0 and v == 0) else carry[d]
            act = stage_fn(chunk, inp)
            if d == S - 1 and v == V - 1:
                outs[m] = act
            sent[(d + 1) % S] = act  # the ring, the wrap edge included
        carry = sent
    last = torch.stack(outs).to(microbatches.dtype)
    return [torch.zeros_like(microbatches) for _ in range(S - 1)] + [last]


def pipeline_bubble_fraction(schedule: str, n_stages: int,
                             n_microbatches: int, v_stages: int = 1) -> float:
    """Idle fraction of a rank's ticks (JAX's :193): GPipe and 1F1B share
    the wave-front bubble (S - 1) / (M + S - 1); the interleaved
    schedule's chunk ticks give (S - 1) / (M V + S - 1)."""
    S, M, V = n_stages, n_microbatches, v_stages
    if schedule in ("gpipe", "1f1b"):
        return (S - 1) / (M + S - 1)
    if schedule == "interleaved":
        return (S - 1) / (M * V + S - 1)
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


def _per_mb_mean(outs, targets, loss_fn):
    """JAX's ``jax.vmap(loss_fn)(outs, targets).mean()``."""
    return torch.stack([loss_fn(outs[m], targets[m])
                        for m in range(outs.shape[0])]).mean()


def pipeline_loss(stage_params: Sequence, microbatches: torch.Tensor,
                  targets: torch.Tensor, stage_fn: Callable,
                  loss_fn: Callable) -> torch.Tensor:
    """The pipeline forward and the mean of ``loss_fn(final, target)``
    over the microbatches (JAX's :210), computed on the last stage and
    psummed, so every rank holds it: returned once, a differentiable
    scalar."""
    outs = pipeline_apply(stage_params, microbatches, stage_fn)[-1]
    return _per_mb_mean(outs, targets, loss_fn)


def _grad_trees(loss, trees):
    """Autograd of ``loss`` into the leaves of each tree (zeros where a
    leaf took no part), returned tree by tree."""
    leaves = [_tree_leaves(t) for t in trees]
    flat = [x for ls in leaves for x in ls]
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(flat, gs)]
    out, at = [], 0
    for t, ls in zip(trees, leaves):
        out.append(_rebuild(t, gs[at:at + len(ls)]))
        at += len(ls)
    return out


def _live(tree):
    """Aliases of a tree's leaves that take a gradient (the caller's
    tensors keep their flags)."""
    return _tree_map(lambda p: p.detach().requires_grad_(), tree)


def _one_f_one_b(stage_params, microbatches, targets, stage_fn, loss_fn,
                 head_params=None, input_grads=False):
    """JAX's 1F1B tick loop (:328) over the virtual ranks.  Returns
    ``(loss_sum, grads, head, ibank)``: the last stage's sum of the
    microbatches' losses (float32), each rank's stage gradients (a list),
    the loss head's float32 gradients (last rank) and the stage-0 input
    gradients (M, ...), the last two None unless asked for.  ``loss_fn``
    may return a vector of independent terms (rows no two terms share):
    its gradient is that of their sum, and the loss sums term by term."""
    S = _ranks(stage_params)
    M = microbatches.shape[0]
    K = min(S, M)  # stash slots: the most in-flight forwards on a rank
    live = [_live(p) for p in stage_params]
    head = None if head_params is None else _live(head_params)
    head_leaves = [] if head is None else _tree_leaves(head)
    fc = [None] * S  # activation arriving from the previous stage
    bc = [None] * S  # gradient arriving from the next stage
    stash = [[None] * K for _ in range(S)]
    grads = [None] * S
    loss_sum = None
    head_acc = None
    ibank = torch.zeros_like(microbatches) if input_grads else None

    def fwd_index(s, t):
        off = t - s
        if 0 <= off < min(M, S - s):
            return off
        f = off // 2
        if off >= 0 and off % 2 == 0 and S - s <= f < M:
            return f
        return None

    def bwd_index(s, t):
        q = t - (2 * S - 1 - s)
        if q >= 0 and q % 2 == 0 and q // 2 < M:
            return q // 2
        return None

    for t in range(2 * (M + S - 1)):
        out_f = [None] * S
        out_b = [None] * S
        for s in range(S):
            f = fwd_index(s, t)
            b = None if f is not None else bwd_index(s, t)
            if f is not None:
                x = microbatches[f] if s == 0 else fc[s]
                with torch.no_grad():
                    out_f[s] = stage_fn(stage_params[s], x)
                stash[s][f % K] = x
            elif b is not None:
                # recompute the stage from its stashed input, then its vjp
                x = stash[s][b % K].detach().requires_grad_()
                leaves = _tree_leaves(live[s])
                with torch.enable_grad():
                    y = stage_fn(live[s], x)
                    if s == S - 1:
                        tgt = targets[b]
                        lval = (loss_fn(head, y, tgt) if head is not None
                                else loss_fn(y, tgt))
                        gs = torch.autograd.grad(lval.sum(),
                                                 head_leaves + [y],
                                                 retain_graph=True,
                                                 allow_unused=True)
                        dh, g_last = gs[:-1], gs[-1]
                        if head is not None:
                            dh = [(torch.zeros_like(h) if d is None else d / M)
                                  .to(torch.float32)
                                  for h, d in zip(head_leaves, dh)]
                            head_acc = dh if head_acc is None else [
                                a + d for a, d in zip(head_acc, dh)]
                        lv = lval.detach().to(torch.float32)
                        loss_sum = lv if loss_sum is None else loss_sum + lv
                        g_y = g_last / M
                    else:
                        g_y = bc[s]
                    gs = torch.autograd.grad(y, leaves + [x], g_y,
                                             allow_unused=True)
                dp = [torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, gs[:-1])]
                grads[s] = dp if grads[s] is None else [
                    a + g for a, g in zip(grads[s], dp)]
                if input_grads and s == 0:
                    ibank[b] = gs[-1]
                out_b[s] = gs[-1]
                del y, gs
        # the edges: a carry adopts only a valid arrival
        for s in range(S - 1):
            if out_f[s] is not None:
                fc[s + 1] = out_f[s]
        for s in range(1, S):
            if out_b[s] is not None:
                bc[s - 1] = out_b[s]
    grads = [_rebuild(stage_params[s], g) for s, g in enumerate(grads)]
    head_grads = None if head is None else _rebuild(head, head_acc)
    return loss_sum, grads, head_grads, ibank


def pipeline_loss_and_grads_1f1b(stage_params: Sequence,
                                 microbatches: torch.Tensor,
                                 targets: torch.Tensor, stage_fn: Callable,
                                 loss_fn: Callable, head_params=None,
                                 return_input_grads: bool = False):
    """One-forward-one-backward (JAX's :236): the same loss and stage
    gradients as GPipe, with a stash of only ``min(S, M)`` stage inputs a
    rank.  Forward of microbatch f at tick s + f in warmup (f < S - s),
    s + 2 f in steady state; backward of microbatch b at 2 S - 1 - s + 2 b.
    A forward tick runs the stage without a graph; a backward tick
    recomputes it from the stashed input with autograd and takes its
    vector-Jacobian product against the gradient handed back by the next
    stage (or, on the last, the loss's over M).

    Returns ``(loss, stage_grads)``: the loss once (JAX psums it) and one
    gradient tree a rank.  ``head_params``: ``loss_fn(head_params, y,
    target)``, and a third element, the loss head's float32 gradients a
    rank (zeros but on the last); ``return_input_grads``: a last element,
    the (M, ...) stage-0 input gradients a rank (zeros but on rank 0)."""
    S = _ranks(stage_params)
    M = microbatches.shape[0]
    loss_sum, grads, head, ibank = _one_f_one_b(
        stage_params, microbatches, targets, stage_fn, loss_fn, head_params,
        return_input_grads)
    out = (loss_sum / M, grads)
    if head is not None:
        zeros = _tree_map(torch.zeros_like, head)
        out = out + ([zeros] * (S - 1) + [head],)
    if return_input_grads:
        out = out + ([ibank] + [torch.zeros_like(ibank)] * (S - 1),)
    return out


def pipeline_loss_and_grads(stage_params: Sequence,
                            microbatches: torch.Tensor,
                            targets: torch.Tensor, stage_fn: Callable,
                            loss_fn: Callable, schedule: str = "gpipe",
                            v_stages: int = 1):
    """``(loss, stage_grads)`` by the schedule (JAX's :446): ``"gpipe"``
    autograd through :func:`pipeline_apply`, ``"1f1b"`` the hand-scheduled
    interleave, ``"interleaved"`` autograd through
    :func:`pipeline_apply_interleaved` with ``v_stages`` chunks a rank.
    The loss comes back once, the gradients one tree a rank."""
    if schedule != "interleaved" and v_stages != 1:
        raise ValueError(
            f"v_stages ({v_stages}) only applies to the interleaved "
            f"schedule, not {schedule!r}"
        )
    if schedule == "1f1b":
        return pipeline_loss_and_grads_1f1b(
            stage_params, microbatches, targets, stage_fn, loss_fn)
    if schedule not in ("gpipe", "interleaved"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    live = [_live(p) for p in stage_params]
    with torch.enable_grad():
        if schedule == "interleaved":
            outs = pipeline_apply_interleaved(live, microbatches, stage_fn,
                                              v_stages)[-1]
        else:
            outs = pipeline_apply(live, microbatches, stage_fn)[-1]
        loss = _per_mb_mean(outs, targets, loss_fn)
        grads = _grad_trees(loss, live)
    return loss.detach(), grads
