"""End-to-end training with checkpoint / resume, on one device.

The counterpart of ``accl_tpu/examples/train.py``: the flagship
transformer's train step over a mesh of virtual ranks (``("dp", "tp")``,
``("dp", "ep", "tp")`` with a dedicated expert axis, or the composed
``("pp", "dp", "tp")`` pipeline), SGD or ZeRO-1 Adam, synthetic tokens or
an ``ACCLTOK1`` file through the native loader, and torch checkpoints
saved on an interval and resumed after a restart.

Where the JAX trainer counts ``jax.devices()``, this one counts virtual
ranks (``world``, 8 by default, the size of the JAX tests' CPU mesh) and
keeps the JAX trainer's mesh arithmetic.  Dense tensor parallelism
clamps to tp = 1, as the JAX trainer's clamp does on a one-device host
(it comes across cards with ROADMAP B14); under ``parallelism="context"``
tp stays the sequence ring.

Runnable on the CPU or the card:

    python -m accl_tpu_torch.examples.train --device cpu --steps 20 \\
        --ckpt-dir /tmp/ckpt --parallelism pipeline

Re-running the same command resumes from the last saved step.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Optional

import numpy as np
import torch

from ..models.composed import make_pp_train_step
from ..models.transformer import (
    TransformerConfig,
    init_params,
    make_sharded_train_step,
)
from ..ops.driver import make_mesh, resolve_device
from ..parallel.zero import AdamConfig, make_zero_train_step

#: a checkpoint file: the step it was saved after
_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")
#: checkpoints kept (the JAX trainer's ``max_to_keep``)
KEEP = 2


def _leaves(tree, prefix=()) -> dict:
    """``{path: tensor}`` of a checkpoint tree's leaves."""
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (k,)))
    return out


def _layout(leaves: dict) -> dict:
    return {p: (tuple(t.shape), t.dtype) for p, t in leaves.items()}


def _steps_saved(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match,
                                                os.listdir(ckpt_dir)) if m)


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as the checkpoint of ``step`` atomically (a temporary
    file, then ``os.replace``) and keep the newest :data:`KEEP`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({"step": int(step), "tree": tree}, tmp)
    os.replace(tmp, path)
    for old in _steps_saved(ckpt_dir)[:-KEEP]:
        os.unlink(os.path.join(ckpt_dir, f"ckpt_{old}.pt"))
    return path


def train(
    steps: int = 20,
    ckpt_dir: Optional[str] = None,
    save_every: int = 10,
    dp: Optional[int] = None,
    tp: int = 2,
    seed: int = 0,
    log_every: int = 5,
    device=None,
    optimizer: str = "sgd",
    parallelism: str = "dp_tp",
    data: Optional[str] = None,
    accum_steps: int = 1,
    clip_grad_norm: Optional[float] = None,
    master_weights: bool = False,
    dtype: str = "float32",
    n_experts: int = 0,
    ep: int = 1,
    v_stages: int = 1,
    pp_schedule: str = "gpipe",
    world: int = 8,
):
    """Train the flagship transformer (the JAX trainer's :33, the same
    options; ``device`` replaces ``platform``: the card unless the caller
    passes ``device="cpu"``; ``world`` is the number of virtual ranks).

    ``data``: an ``ACCLTOK1`` token file (``accl_tpu_torch.data``), read
    by the native loader from the resumed step; without it, synthetic
    tokens from ``np.random.default_rng([seed, step])``, the JAX
    trainer's stream.  ``optimizer="zero_adam"``: ZeRO-1 Adam
    (``accum_steps``, ``clip_grad_norm``, ``master_weights`` with it).
    ``parallelism``: ``"dp_tp"``, ``"context"`` (tp the sequence ring) or
    ``"pipeline"`` (pp = 2, two microbatches, ``v_stages`` and
    ``pp_schedule``; the layers checkpoint stacked).  ``n_experts``: the
    MoE FFN, on dp or, with ``ep > 1``, a dedicated expert axis.

    Returns ``(steps_completed, final_loss)``; ``final_loss`` is None when
    a checkpoint already covers ``steps`` (nothing ran)."""
    dev = resolve_device(device)
    use_pp = parallelism == "pipeline"
    if parallelism not in ("dp_tp", "context", "pipeline"):
        raise ValueError(f"unknown parallelism {parallelism!r}")
    if use_pp and accum_steps != 1:
        raise ValueError(
            "parallelism='pipeline' accumulates through its "
            "microbatches; accum_steps is a dp_tp/context knob"
        )
    if (
        accum_steps != 1 or clip_grad_norm is not None or master_weights
    ) and optimizer != "zero_adam":
        raise ValueError(
            "accum_steps/clip_grad_norm/master_weights require "
            "optimizer='zero_adam'"
        )
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown dtype {dtype!r}")
    pp = 2 if use_pp else 1
    if use_pp and world < 2:
        raise ValueError(
            "parallelism='pipeline' needs >= 2 ranks (pp=2); --world is "
            f"{world}"
        )
    if ep > 1 and not n_experts:
        raise ValueError("--ep > 1 requires --n-experts")
    if ep > 1 and use_pp:
        raise ValueError("--ep does not combine with parallelism='pipeline'")
    if v_stages > 1 and not use_pp:
        raise ValueError("--v-stages requires parallelism='pipeline'")
    if pp_schedule != "gpipe" and not use_pp:
        raise ValueError("--pp-schedule requires parallelism='pipeline'")
    if ep > world:
        raise ValueError(
            f"--ep {ep} needs at least that many ranks; --world is "
            f"{world} (the dp x ep x tp mesh cannot fold)"
        )
    tp = min(tp, max(world // (pp * ep), 1))
    if tp > 1 and parallelism != "context":
        print(f"dense tp = {tp} clamps to 1: tensor parallelism across "
              "cards comes with ROADMAP B14")
        tp = 1
    if dp is None:
        dp = max(world // (pp * ep * tp), 1)
    if dp * ep * tp * pp > world:
        raise ValueError(
            f"pp ({pp}) x dp ({dp}) x ep ({ep}) x tp ({tp}) = "
            f"{pp * dp * ep * tp} exceeds the {world} ranks of --world "
            "— lower --dp or --ep (tp self-clamps)"
        )
    if use_pp:
        mesh = make_mesh((pp, dp, tp), dev, axes=("pp", "dp", "tp"))
    elif ep > 1:
        mesh = make_mesh((dp, ep, tp), dev, axes=("dp", "ep", "tp"))
    else:
        mesh = make_mesh((dp, tp), dev, axes=("dp", "tp"))

    heads = max(4, tp)
    heads += (-heads) % tp  # tp must divide heads (and so d_model/d_ff)
    cfg = TransformerConfig(
        vocab=128, d_model=16 * heads, n_heads=heads,
        # interleaved pipeline: every virtual stage needs a layer
        n_layers=2 * v_stages if use_pp else 2,
        d_ff=32 * heads, max_seq=32,
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
        context_parallel=parallelism == "context",
        n_experts=n_experts,
        moe_mesh_axis="ep" if ep > 1 else "dp",
    )
    use_zero = optimizer == "zero_adam"
    # a dp rank's batch: 2 samples a microbatch
    per_rank_b = 2 * accum_steps
    params0 = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    adam = AdamConfig(lr=0.01, clip_grad_norm=clip_grad_norm,
                      master_weights=master_weights)
    opt_state = None
    if use_pp:
        made = make_pp_train_step(
            cfg, mesh, num_microbatches=2, lr=0.1, v_stages=v_stages,
            schedule=pp_schedule, adam=adam if use_zero else None)
        step_fn, shard = made[:2]
        params = shard(params0)
        if use_zero:
            opt_state = made[2](params0)
    elif use_zero:
        step_fn, shard, init_state = make_zero_train_step(
            cfg, mesh, adam, accum_steps=accum_steps)
        params = shard(params0)
        opt_state = init_state(params0)
    else:
        step_fn, shard = make_sharded_train_step(cfg, 0.1, mesh)
        params = shard(params0)
    del params0

    def ckpt_tree():
        # one definition of the checkpoint layout
        return ({"params": params, "opt_state": opt_state}
                if use_zero else params)

    start_step = 0
    if ckpt_dir:
        ckpt_dir = os.path.abspath(ckpt_dir)
        saved = _steps_saved(ckpt_dir)
        if saved:
            latest = saved[-1]
            blob = torch.load(os.path.join(ckpt_dir, f"ckpt_{latest}.pt"),
                              map_location=dev, weights_only=True)
            want, got = _leaves(ckpt_tree()), _leaves(blob["tree"])
            if _layout(got) != _layout(want):
                raise ValueError(
                    f"failed to restore {ckpt_dir} at step {latest} "
                    f"with optimizer={optimizer!r}, "
                    f"parallelism={parallelism!r}, "
                    f"master_weights={master_weights}, "
                    f"n_experts={n_experts}; was the checkpoint "
                    "saved with a different --optimizer, "
                    "--parallelism, --master-weights, or "
                    "--n-experts? (pipeline mode stores layers "
                    "STACKED, dp_tp stores them as a list; master "
                    "weights add a 'w' subtree to the optimizer "
                    "state; MoE replaces w1/w2 with a 'moe' "
                    "subtree)"
                )
            with torch.no_grad():
                for path, dst in want.items():
                    dst.copy_(got[path])
            del blob, got
            start_step = latest + 1
            print(f"resumed from step {latest} in {ckpt_dir}")

    if start_step >= steps:
        print(
            f"nothing to do: checkpoint already at step {start_step - 1}, "
            f"requested --steps {steps}"
        )
        return start_step, None

    loss = None
    loader = None
    saved_at = None
    if data is not None:
        from ..data import TokenLoader

        # one loader feeds the whole dp-split batch, from the resumed step
        loader = TokenLoader(
            data, batch=per_rank_b * dp * ep, seq=cfg.max_seq, seed=seed,
            start_step=start_step,
        )
    try:
        for it in range(start_step, steps):
            if loader is not None:
                tokens, targets, got_step = loader.next()
                if got_step != it:
                    raise RuntimeError(
                        f"loader/step misalignment: loader at {got_step}, "
                        f"trainer at {it}"
                    )
                # the whole window: targets carry one id tokens do not
                if max(int(tokens.max()), int(targets.max())) >= cfg.vocab:
                    raise ValueError(
                        f"token file carries ids >= vocab ({cfg.vocab})"
                    )
                tokens, targets = tokens.to(dev), targets.to(dev)
            else:
                # a stream keyed by (seed, step): a resumed run consumes
                # the tokens an uninterrupted run would
                rng = np.random.default_rng([seed, it])
                ids = rng.integers(0, cfg.vocab,
                                   (per_rank_b * dp * ep, cfg.max_seq))
                tokens = torch.from_numpy(ids.astype(np.int32)).to(dev)
                targets = torch.roll(tokens, -1, dims=1)
            if use_zero:
                params, opt_state, loss = step_fn(params, opt_state, tokens,
                                                  targets)
            else:
                params, loss = step_fn(params, tokens, targets)
            loss = float(loss)
            if log_every and (it + 1) % log_every == 0:
                print(f"step {it + 1}/{steps} loss {loss:.4f}", flush=True)
            if ckpt_dir and (it + 1) % save_every == 0:
                save_checkpoint(ckpt_dir, it, ckpt_tree())
                saved_at = it
    finally:
        if loader is not None:
            loader.close()  # even when a step raises: stop the prefetch
    if ckpt_dir and saved_at != steps - 1:
        save_checkpoint(ckpt_dir, steps - 1, ckpt_tree())
    return steps, loss  # the last completed step's global loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the current CUDA device; 'cpu' runs "
        "on the CPU)",
    )
    ap.add_argument(
        "--world", type=int, default=8,
        help="virtual ranks the mesh is built from (the JAX trainer's "
        "device count)",
    )
    ap.add_argument(
        "--optimizer", default="sgd", choices=["sgd", "zero_adam"]
    )
    ap.add_argument(
        "--parallelism", default="dp_tp",
        choices=["dp_tp", "context", "pipeline"],
    )
    ap.add_argument(
        "--n-experts", type=int, default=0,
        help="MoE: expert count (sharded over dp, or over --ep); "
        "0 = dense FFN",
    )
    ap.add_argument(
        "--ep", type=int, default=1,
        help="dedicated expert-parallel mesh axis size (>1 un-welds "
        "experts from dp onto a (dp, ep, tp) mesh; requires --n-experts)",
    )
    ap.add_argument(
        "--v-stages", type=int, default=1,
        help="interleaved virtual stages per pipeline rank "
        "(parallelism=pipeline; bubble drops by this factor)",
    )
    ap.add_argument(
        "--pp-schedule", default="gpipe", choices=["gpipe", "1f1b"],
        help="composed pipeline backward: autograd through GPipe or the "
        "hand-scheduled 1F1B (min(pp,M)-input stash + recompute)",
    )
    ap.add_argument(
        "--data", default=None,
        help="ACCLTOK1 token file (native prefetching loader); "
        "default: synthetic tokens",
    )
    ap.add_argument(
        "--accum-steps", type=int, default=1,
        help="gradient accumulation microbatches per step (zero_adam)",
    )
    ap.add_argument(
        "--clip-grad-norm", type=float, default=None,
        help="global-L2-norm gradient clipping (zero_adam)",
    )
    ap.add_argument(
        "--master-weights", action="store_true",
        help="fp32 master-weight track in the optimizer state (zero_adam)",
    )
    ap.add_argument(
        "--dtype", default="float32", choices=["float32", "bfloat16"],
        help="parameter/activation dtype",
    )
    args = ap.parse_args(argv)
    train(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        save_every=args.save_every, tp=args.tp, seed=args.seed,
        device=args.device, optimizer=args.optimizer,
        parallelism=args.parallelism, data=args.data,
        accum_steps=args.accum_steps, clip_grad_norm=args.clip_grad_norm,
        master_weights=args.master_weights, dtype=args.dtype,
        n_experts=args.n_experts, ep=args.ep, v_stages=args.v_stages,
        pp_schedule=args.pp_schedule, world=args.world,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
