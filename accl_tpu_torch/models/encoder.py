"""The bidirectional encoder family (BERT-shaped) on one device.

The counterpart of ``accl_tpu/models/encoder.py``: the decoder flagship's
blocks with ``causal=False`` (full (T, T) visibility; from T = 1024 on the
card ``"auto"`` runs the flash kernels' non-causal forward and backward),
and a masked-language-model head on the tied unembedding.  The step runs
over a ``("dp", "tp")`` mesh of virtual ranks whose tp is 1, as the
decoder's makers do, and its loss is JAX's global mean: the dp sum of the
masked NLL totals over the dp sum of the masked counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.driver import Mesh
from .transformer import (
    TransformerConfig,
    _check_batch,
    _embed_tokens,
    _enter_block_layout,
    _layernorm,
    _mesh_dp_tp,
    _reject_untrainable_attention,
    _run_blocks,
    _sharder,
    _tree_leaves,
    _tree_map,
    sgd_update_,
)


def encoder_forward(params, tokens, cfg: TransformerConfig):
    """Bidirectional hidden states (B, T, d_model) of a token batch (B, T)
    — ``forward``'s encoder twin (no causal mask, no LM head), through
    the same entry path (remat, the attention lowering).  JAX's refusals
    (:61-76) hold, with its messages."""
    if cfg.vocab_parallel:
        raise ValueError(
            "vocab_parallel is supported on the decoder flagship only "
            "(forward/loss_fn/generate), not the encoder family"
        )
    if cfg.context_parallel:
        raise ValueError(
            "context_parallel is causal/decoder-only (the striped ring's "
            "load balance argument is the causal mask) — not the encoder "
            "family"
        )
    if cfg.n_experts:
        raise ValueError(
            "n_experts (MoE) is supported on the decoder flagship only "
            "(forward/loss_fn/generate), not the encoder family"
        )
    x = _embed_tokens(params, tokens, cfg)
    x, block = _enter_block_layout(x, cfg, causal=False)
    x, _ = _run_blocks(x, params, block, cfg)
    return _layernorm(x, params["ln_f"])


def _mlm_sums(params, tokens, targets, mask, cfg, dp: int = 1):
    """(masked NLL sum, masked count) (JAX's :111): the pieces before the
    division, so a dp step sums both over the ranks and divides once.
    With ``dp`` ranks each sums its own rows first, then the ranks' sums
    add, as JAX's psum adds them."""
    h = encoder_forward(params, tokens, cfg)
    logp = torch.log_softmax(h @ params["embed"].T, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long()).squeeze(-1)
    B = tokens.shape[0]
    total = (nll * mask).reshape(dp, B // dp, -1).sum((1, 2)).sum(0)
    count = mask.reshape(dp, B // dp, -1).sum((1, 2)).sum(0)
    return total, count


def mlm_loss(params, tokens, targets, mask, cfg: TransformerConfig):
    """The masked-LM objective (JAX's :123): the mean NLL of ``targets`` at
    the positions where ``mask`` is 1; ``tokens`` carry the corrupted
    input."""
    total, count = _mlm_sums(params, tokens, targets, mask, cfg)
    return total / torch.clamp(count, min=1.0)


def make_sharded_encoder_step(cfg: TransformerConfig, lr: float = 1e-2,
                              mesh: Optional[Mesh] = None):
    """One MLM SGD step (JAX's :134), the port's argument order and return
    shape of ``make_sharded_train_step``: ``(step, shard)``;
    ``step(params, tokens, targets, mask)`` returns ``(params, loss)``,
    the loss the dp sum of the masked totals over the dp sum of the
    counts, the parameters updated to ``p - lr * g`` in place.  ``mesh``
    is one rank or a ``("dp", "tp")`` mesh whose tp is 1."""
    _reject_untrainable_attention(cfg)
    mesh, dp, _, _ = _mesh_dp_tp(cfg, mesh)

    def step(params, tokens, targets, mask):
        leaves = _tree_leaves(params)
        _check_batch(tokens, leaves[0].device, dp)
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        total, count = _mlm_sums(_tree_map(lambda _: next(it), params),
                                 tokens, targets, mask, cfg, dp)
        loss = total / torch.clamp(count, min=1.0)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            sgd_update_(leaves, grads, lr)
        return params, loss.detach()

    return step, _sharder(mesh)


def encode(params, tokens, cfg: TransformerConfig):
    """Pooled (mean over T) sentence embeddings (B, d_model), the
    encoder's serving surface (JAX's :150)."""
    return encoder_forward(params, tokens, cfg).mean(1)
