"""The transformer LM on one device: forward, prefill and KV-cache
generate, the loss and the SGD train step.

The counterpart of ``accl_tpu/models/transformer.py`` on one card (tp = 1,
replicated activations).  Parameters are a plain dict with the JAX tree's
keys (``embed``, ``pos``, ``ln_f``, ``layers[i]`` with ``wq wk wv wo ln1
ln2 w1 w2``), weights stored (d_in, d_out) as there, so a JAX tree carries
across by :func:`params_from_numpy`.  The dtype rules are the JAX
module's: matmuls in the activation dtype, attention scores and softmax
statistics in float32, probabilities cast back to v's dtype before P @ V,
Python-float scales (so bfloat16 activations stay bfloat16).

Attention lowers as ``cfg.attention`` says: ``"naive"`` (materialized
scores), ``"blockwise"`` (``ops.attention.blockwise_attention``),
``"flash"`` (the hand-written kernels, ``ops.cuda.attention``: the
forward, and the dQ and dK/dV backward when a gradient is taken) or
``"auto"`` (:func:`_resolve_attention`).  Unlike the JAX module, decode
writes each step's k/v into the cache IN PLACE, and the train step
writes the updated parameters into their own storage (the port's form
of JAX's ``donate_argnums``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, or tensors already on the CPU); without a card they
raise.  Sharded serving and training, MoE, sequence, vocab and context
parallelism come with later slices, and a config or mesh that asks for
them is refused.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..buffer import host_tensor
from ..ops.attention import blockwise_attention
from ..ops.cuda.attention import MAX_HEAD_DIM, flash_attention
from ..ops.driver import Mesh, make_mesh, resolve_device

#: the JAX module's crossover (``_AUTO_FUSED_MIN_T``): "auto" runs naive
#: below this sequence length and a fused form from it up
_AUTO_FUSED_MIN_T = 1024

#: the fields the port refuses, and the slice each waits for
_LATER = {
    "n_experts": "the MoE slice (ROADMAP A9d, models/moe.py)",
    "seq_parallel": "the multi-GPU tensor-parallel slice (ROADMAP B14)",
    "vocab_parallel": "the multi-GPU tensor-parallel slice (ROADMAP B14)",
    "context_parallel": "the flagship's context-parallel slice (ROADMAP "
                        "A9e)",
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Every field of the JAX ``TransformerConfig``; ``dtype`` is a torch
    dtype.  ``n_experts > 0``, ``seq_parallel``, ``vocab_parallel`` and
    ``context_parallel`` raise NotImplementedError naming the slice that
    ports them; the ``moe_*`` and ``ep_extends_dp`` fields only matter
    with experts or a mesh.  ``remat`` recomputes each block on the
    backward pass (``torch.utils.checkpoint``) when a gradient is taken.
    ``attention``: "auto", "naive", "blockwise" or "flash"."""

    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_seq: int = 128
    dtype: torch.dtype = torch.float32
    n_kv_heads: Optional[int] = None
    pos_embedding: str = "learned"
    rope_base: float = 10000.0
    vocab_parallel: bool = False
    context_parallel: bool = False
    remat: bool = False
    seq_parallel: bool = False
    n_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.5
    moe_aux_weight: float = 0.01
    moe_router_z_weight: float = 1e-3
    moe_mesh_axis: str = "dp"
    ep_extends_dp: bool = False
    attention: str = "auto"

    def __post_init__(self):
        for name, slice_ in _LATER.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet: it "
                    f"comes with {slice_}"
                )
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch dtype, got {self.dtype!r}")
        _reject_untrainable_attention(self)

    def kv_heads(self) -> int:
        n_kv = self.n_heads if self.n_kv_heads is None else self.n_kv_heads
        if n_kv <= 0 or self.n_heads % n_kv:
            raise ValueError(
                f"n_kv_heads ({n_kv}) must divide n_heads ({self.n_heads})"
            )
        return n_kv

    def uses_rope(self) -> bool:
        if self.pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"unknown pos_embedding {self.pos_embedding!r}"
            )
        if self.pos_embedding == "rope" and (self.d_model // self.n_heads) % 2:
            raise ValueError("rope needs an even head dim")
        return self.pos_embedding == "rope"


Params = Dict


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """The JAX ``init_params`` tree (:314): weights normal(0, 0.02) drawn
    from ``generator`` on its own device (in float32, then cast to
    ``cfg.dtype``), layer norms ones, on ``device`` (the card unless the
    caller passes ``device="cpu"``).  The draws cannot equal JAX's PRNG:
    carry a JAX tree across with :func:`params_from_numpy` instead."""
    dev = resolve_device(device)

    def normal(*shape):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * 0.02).to(device=dev, dtype=cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    params = {"embed": normal(cfg.vocab, cfg.d_model),
              "ln_f": ones(cfg.d_model), "layers": []}
    if not cfg.uses_rope():  # rope has no learned position table
        params["pos"] = normal(cfg.max_seq, cfg.d_model)
    d_kv = cfg.kv_heads() * (cfg.d_model // cfg.n_heads)
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": normal(cfg.d_model, cfg.d_model),
            "wk": normal(cfg.d_model, d_kv),
            "wv": normal(cfg.d_model, d_kv),
            "wo": normal(cfg.d_model, cfg.d_model),
            "ln1": ones(cfg.d_model),
            "ln2": ones(cfg.d_model),
            "w1": normal(cfg.d_model, cfg.d_ff),
            "w2": normal(cfg.d_ff, cfg.d_model),
        })
    return params


def _tree_map(fn, tree):
    """``fn`` on every tensor or array of a parameter tree (dicts, lists
    and tuples), keeping its keys and nesting."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> List[torch.Tensor]:
    leaves = []
    _tree_map(leaves.append, tree)
    return leaves


def params_from_numpy(tree, device=None):
    """The port's tree for a JAX parameter tree given as numpy arrays
    (``jax.tree.map(np.asarray, params)``): same keys and nesting, each
    array copied onto ``device`` (the card unless ``device="cpu"``);
    bfloat16 arrays keep their bits."""
    dev = resolve_device(device)

    def conv(x):
        arr = np.array(x)  # a writable host copy (JAX arrays are not)
        return host_tensor(arr).reshape(arr.shape).to(dev)

    return _tree_map(conv, tree)


def params_to_numpy(params):
    """The inverse of :func:`params_from_numpy`: the tree as host numpy
    arrays, same keys and nesting; bfloat16 tensors keep their bits (as
    ``ml_dtypes.bfloat16`` arrays, the dtype JAX's numpy arrays have)."""

    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return _tree_map(conv, params)


def _layernorm(x, scale):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale


def _embed_rows(embed, ids):
    """Rows of the replicated embedding table."""
    return embed[ids]


def _embed_tokens(params, tokens, cfg):
    """Token embeddings, plus the learned position table unless the config
    uses rotary embeddings."""
    x = _embed_rows(params["embed"], tokens)
    if not cfg.uses_rope():
        x = x + params["pos"][: tokens.shape[1]]
    return x


def _lm_logits(x, embed):
    """The tied LM head ``x @ embed.T``."""
    return x @ embed.T


def _rope_tables(positions, half: int, base: float):
    """cos/sin rotary tables at the given absolute ``positions`` (T,), in
    float32, shared by the q and k rotations."""
    f32 = torch.float32
    freqs = torch.tensor(base, dtype=f32, device=positions.device) ** (
        -torch.arange(0, half, dtype=f32, device=positions.device) / half
    )
    ang = positions.to(f32)[:, None] * freqs[None, :]  # (T, half)
    return torch.cos(ang), torch.sin(ang)


def _rope_rotate(x, tables):
    """Rotate each (i, i + half) feature pair of every head of ``x``
    (B, H, T, hd) by position x freq_i, in float32, cast back to x's
    dtype."""
    cos, sin = tables
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _resolve_attention(impl: str, T: int, head_dim: int,
                       on_card: bool) -> str:
    """``"auto"``: naive below ``_AUTO_FUSED_MIN_T``; from it up, the
    flash kernel on the card (the TPU's role) while the head dim is within
    the kernel's limit, else the blockwise fold (JAX off the TPU).  The
    JAX resolver's VMEM and f16 gates are Mosaic rules and do not carry
    over."""
    if impl != "auto":
        return impl
    if T < _AUTO_FUSED_MIN_T:
        return "naive"
    if on_card and head_dim <= MAX_HEAD_DIM:
        return "flash"
    return "blockwise"


def _attention(q, k, v, impl: str = "naive", causal: bool = True):
    """Attention; q (B, H, T, hd), k/v (B, Hkv, T, hd); ``causal=False``
    is the bidirectional form."""
    impl = _resolve_attention(impl, q.shape[2], q.shape[3], q.is_cuda)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    if impl != "naive":
        raise ValueError(f"unknown attention impl {impl!r}")
    B, H, T, hd = q.shape
    Hkv = k.shape[1]
    # the group folds into the product: each kv head broadcasts across
    # its G query heads, k/v are never expanded.  Scores in float32 (the
    # 16-bit operands widened exactly), probabilities back in v's dtype
    qg = q.reshape(B, Hkv, H // Hkv, T, hd)
    scores = torch.matmul(
        qg.float(), k[:, :, None].float().transpose(-1, -2)
    ) * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v[:, :, None])
    return out.reshape(B, H, T, hd)


def _mlp(x, lp):
    """The block's dense MLP half: ln2, up, gelu (tanh form, JAX's
    default), down, residual."""
    h = _layernorm(x, lp["ln2"])
    return x + F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]


def _attn_partial(h, lp, n_heads, attn_impl="naive", causal=True,
                  rope_base=None):
    """Attention on a full-sequence activation: returns the output
    projection and the (k, v) head tensors (B, Hkv, T, hd) for the
    KV-cache prefill (rotated keys under rope)."""
    B, T, _ = h.shape
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    hd = q.shape[-1] // n_heads
    n_kv = k.shape[-1] // hd

    def heads(t, n):
        return t.reshape(B, T, n, hd).transpose(1, 2)

    q, k, v = heads(q, n_heads), heads(k, n_kv), heads(v, n_kv)
    if rope_base is not None:
        tables = _rope_tables(torch.arange(T, device=h.device), hd // 2,
                              rope_base)
        q = _rope_rotate(q, tables)
        k = _rope_rotate(k, tables)
    attn = _attention(q, k, v, impl=attn_impl, causal=causal)
    attn = attn.transpose(1, 2).reshape(B, T, -1)
    return attn @ lp["wo"], (k, v)


def _block(x, lp, n_heads, return_kv=False, attn_impl="naive", causal=True,
           rope_base=None):
    """One transformer block; ``return_kv=True`` also returns the (k, v)
    head tensors (the prefill path)."""
    h = _layernorm(x, lp["ln1"])
    o, kv = _attn_partial(h, lp, n_heads, attn_impl, causal, rope_base)
    out = _mlp(x + o, lp)
    return (out, kv) if return_kv else out


def _enter_block_layout(x, cfg, return_kv=False, causal=True):
    """The replicated layout of the JAX function (:773): activations stay
    whole on the card, blocks run :func:`_block`.  Returns ``(x,
    block_fn)``."""
    cfg.kv_heads()  # validates n_kv_heads
    return x, partial(_block, n_heads=cfg.n_heads, return_kv=return_kv,
                      attn_impl=cfg.attention, causal=causal,
                      rope_base=cfg.rope_base if cfg.uses_rope() else None)


def _final_hidden(params, tokens, cfg):
    """Embed, blocks, final layer norm."""
    x = _embed_tokens(params, tokens, cfg)
    x, block = _enter_block_layout(x, cfg)
    for lp in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(block, x, lp, use_reentrant=False)
        else:
            x = block(x, lp)
    return _layernorm(x, params["ln_f"])


def forward(params, tokens, cfg: TransformerConfig):
    """Logits (B, T, vocab) for a token batch (B, T)."""
    return _lm_logits(_final_hidden(params, tokens, cfg), params["embed"])


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def _block_decode(x_t, lp, cache_k, cache_v, pos: int, n_heads: int,
                  rope_tables=None):
    """One block for a single decode position: write this step's k/v into
    the cache at ``pos`` (in place), attend over positions <= pos with
    the JAX form's mask over the whole cache.  The cache is (B, Hkv, S,
    hd); query heads group onto kv head h // G.  Returns x_out."""
    B, _, D = x_t.shape
    h = _layernorm(x_t, lp["ln1"])
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    hd = q.shape[-1] // n_heads
    n_kv = k.shape[-1] // hd

    def heads(t, n):
        return t.reshape(B, 1, n, hd).transpose(1, 2)

    q, k, v = heads(q, n_heads), heads(k, n_kv), heads(v, n_kv)
    if rope_tables is not None:
        q = _rope_rotate(q, rope_tables)
        k = _rope_rotate(k, rope_tables)
    cache_k[:, :, pos] = k[:, :, 0]
    cache_v[:, :, pos] = v[:, :, 0]
    S = cache_k.shape[2]
    qg = q.reshape(B, n_kv, n_heads // n_kv, 1, hd)
    scores = torch.matmul(
        qg.float(), cache_k[:, :, None].float().transpose(-1, -2)
    ) * (1.0 / math.sqrt(hd))
    mask = torch.arange(S, device=x_t.device) <= pos
    scores = torch.where(mask, scores, -1e30)
    attn = torch.matmul(torch.softmax(scores, dim=-1).to(cache_v.dtype),
                        cache_v[:, :, None])
    attn = attn.reshape(B, n_heads, 1, hd).transpose(1, 2).reshape(B, 1, -1)
    return _mlp(x_t + attn @ lp["wo"], lp)


def prefill(params, tokens, cfg: TransformerConfig,
            cache_len: Optional[int] = None):
    """Run the prompt through the model once, building the KV cache.
    Returns (last-position logits (B, vocab), caches): a list of (k, v)
    tensors (B, Hkv, cache_len, hd), kv heads only under GQA.
    ``cache_len`` defaults to ``cfg.max_seq``."""
    B, T = tokens.shape
    S = cfg.max_seq if cache_len is None else int(cache_len)
    x = _embed_tokens(params, tokens, cfg)
    hd = cfg.d_model // cfg.n_heads
    x, block_kv = _enter_block_layout(x, cfg, return_kv=True)
    caches = []
    for lp in params["layers"]:
        x, (k, v) = block_kv(x, lp)
        shape = (B, cfg.kv_heads(), S, hd)
        ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
        ck[:, :, :T] = k
        cv[:, :, :T] = v
        caches.append((ck, cv))
    x = _layernorm(x, params["ln_f"])
    return _lm_logits(x[:, -1], params["embed"]), caches


def _select_token(logits, generator, temperature: float,
                  top_k: Optional[int]):
    """Greedy at temperature 0 (the first maximal index, as jnp.argmax),
    else temperature-scaled, optionally top-k-truncated, categorical
    sampling from ``generator``."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def _decode_step(params, caches: List[Tuple[torch.Tensor, torch.Tensor]],
                 tok, pos: int, cfg: TransformerConfig):
    """One decode step: the tokens ``tok`` (B,) at position ``pos``
    through every layer (each writing its cache at ``pos``); returns the
    next logits (B, vocab)."""
    x = _embed_rows(params["embed"], tok)[:, None, :]
    tables = None
    if cfg.uses_rope():
        hd = cfg.d_model // cfg.n_heads
        tables = _rope_tables(torch.tensor([pos], device=tok.device),
                              hd // 2, cfg.rope_base)
    else:
        x = x + params["pos"][pos:pos + 1][None]
    for lp, (ck, cv) in zip(params["layers"], caches):
        x = _block_decode(x, lp, ck, cv, pos, cfg.n_heads, tables)
    x = _layernorm(x, params["ln_f"])
    return _lm_logits(x[:, 0], params["embed"])


def generate(params, prompt, steps: int, cfg: TransformerConfig,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None):
    """Autoregressive decode on the device of ``params`` and ``prompt``:
    prefill the prompt, then single-token steps through the KV cache.
    Returns the (B, steps) generated ids g_0 .. g_{steps-1} in the
    prompt's dtype.  The JAX scan's last step computes a token it never
    emits; this loop stops after the last emitted one.

    ``temperature=0`` (default) is greedy and deterministic.
    ``temperature > 0`` samples from the temperature-scaled distribution,
    truncated to ``top_k`` logits when given, drawing from ``generator``
    (a ``torch.Generator`` on the params' device, in place of JAX's
    ``rng`` key): its tokens cannot equal JAX's PRNG stream."""
    B, T = prompt.shape
    if T + steps > cfg.max_seq and not cfg.uses_rope():
        raise ValueError(
            f"prompt {T} + steps {steps} exceeds max_seq {cfg.max_seq}"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    if top_k is not None and not 0 < top_k <= cfg.vocab:
        raise ValueError(
            f"top_k must be in [1, vocab={cfg.vocab}], got {top_k}"
        )
    if prompt.device != params["embed"].device:
        raise ValueError(
            f"prompt on {prompt.device}, params on {params['embed'].device}"
        )
    with torch.no_grad():
        logits, caches = prefill(params, prompt, cfg, cache_len=T + steps)
        tok = _select_token(logits, generator, temperature, top_k)
        toks = [tok]
        for i in range(steps - 1):
            logits = _decode_step(params, caches, tok, T + i, cfg)
            tok = _select_token(logits, generator, temperature, top_k)
            toks.append(tok)
    if steps <= 0:
        return torch.empty((B, 0), dtype=prompt.dtype, device=prompt.device)
    return torch.stack(toks, dim=1).to(prompt.dtype)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _token_nll(logits, targets):
    """Per-token next-token NLL from full-vocab logits, the softmax
    statistics in float32 (bfloat16 logits overflow exp quickly)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long()).squeeze(-1)


def loss_fn(params, tokens, targets, cfg: TransformerConfig):
    """Mean next-token NLL of a token batch (B, T) against ``targets``
    (B, T), at tp = 1 (the JAX function's non-vocab-parallel branch;
    vocab and context parallelism and experts are refused by the
    config)."""
    return _token_nll(forward(params, tokens, cfg), targets).mean()


def _reject_untrainable_attention(cfg) -> None:
    """Reject an attention lowering the model does not have.  Every one
    it has is trainable: ``"flash"`` differentiates through the dQ and
    dK/dV kernels."""
    if cfg.attention not in ("auto", "naive", "blockwise", "flash"):
        raise ValueError(f"unknown attention impl {cfg.attention!r}")


def _lr_scalar(lr) -> Tuple[float, Optional[torch.dtype]]:
    """``(value, dtype)`` of a learning rate: dtype None for a Python
    number (weakly typed: it takes the parameter's dtype, as in JAX);
    a NumPy scalar or a 0-d tensor keeps its dtype, 64-bit ones narrowed
    to 32 as JAX without x64 narrows them.  Anything the in-place update
    cannot hold (a tensor of more than one element, a complex number, a
    non-number) is refused."""
    if isinstance(lr, torch.Tensor) or isinstance(lr, (np.generic,
                                                       np.ndarray)):
        t = lr if isinstance(lr, torch.Tensor) else torch.from_numpy(
            np.asarray(lr))
        if t.dim() != 0:
            raise TypeError(f"lr must be a number: a scalar, got a "
                            f"{tuple(t.shape)} array")
        if t.is_complex() or t.dtype == torch.bool:
            raise TypeError(f"lr must be a real number, got {t.dtype}")
        dtype = {torch.float64: torch.float32,
                 torch.int64: torch.int32}.get(t.dtype, t.dtype)
        return t.item(), dtype
    if isinstance(lr, (int, float)) and not isinstance(lr, bool):
        return float(lr), None
    raise TypeError(f"lr must be a number (a real scalar: Python, NumPy "
                    f"or a 0-d tensor), got {type(lr).__name__}")


def _weak_scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python number as a 0-d tensor of ``dtype``, rounded once from the
    double (JAX's conversion of a weakly typed scalar)."""
    if dtype == torch.bfloat16:  # round the double's mantissa to 7 bits
        u = struct.unpack("<Q", struct.pack("<d", value))[0]
        u = (u + (1 << 44) - 1 + ((u >> 45) & 1)) >> 45 << 45
        value = struct.unpack("<d", struct.pack("<Q", u))[0]
    elif dtype in (torch.float16, torch.float32):
        return torch.from_numpy(np.array(value, dtype=str(dtype)[6:]))
    return torch.tensor(value, dtype=torch.float64).to(dtype)


def sgd_update_(leaves: List[torch.Tensor], grads: List[torch.Tensor],
                lr) -> None:
    """``p <- p - lr * g`` in place, rounded as JAX rounds ``p - lr * g``
    for this lr's type: a Python number takes each parameter's dtype; a
    typed scalar promotes with it (a float32 lr on bfloat16 weights
    computes in float32, where JAX would return float32 weights; the
    in-place update rounds that result to the weights' dtype)."""
    value, lr_dtype = _lr_scalar(lr)
    by_dtype: Dict[torch.dtype, Tuple[list, list]] = {}
    for p, g in zip(leaves, grads):
        ps, gs = by_dtype.setdefault(p.dtype, ([], []))
        ps.append(p)
        gs.append(g)
    for dtype, (ps, gs) in by_dtype.items():
        if lr_dtype is None:
            cdt, lr_t = dtype, _weak_scalar(value, dtype)
        else:
            cdt = torch.promote_types(dtype, lr_dtype)
            lr_t = torch.tensor(value, dtype=lr_dtype).to(cdt)
        lr_t = lr_t.to(ps[0].device)
        if cdt == dtype:
            torch._foreach_sub_(ps, torch._foreach_mul(gs, lr_t))
            continue
        for p, g in zip(ps, gs):
            p.copy_(p.to(cdt) - lr_t * g.to(cdt))


def make_sharded_train_step(cfg: TransformerConfig, lr: float = 1e-2,
                            mesh: Optional[Mesh] = None):
    """One SGD train step, JAX's return shape: ``(step, shard)``.

    ``shard(tree)`` copies a parameter tree onto the mesh's device (the
    card unless ``mesh`` says otherwise); ``step(params, tokens,
    targets)`` takes the mean loss's gradient with respect to every
    parameter and returns ``(params, loss)``, the parameters updated to
    ``p - lr * g`` IN PLACE (rounded as JAX rounds it for this lr's
    type, :func:`sgd_update_`) and the same tree returned.  ``lr`` is any
    real scalar: a Python number, a NumPy scalar or a 0-d tensor.

    Only one device so far: a mesh of more than one raises
    NotImplementedError (data and tensor parallelism come with the
    multi-GPU slice, ROADMAP B14)."""
    _reject_untrainable_attention(cfg)
    _lr_scalar(lr)  # refuse what the update cannot hold, before any work
    if mesh is None:
        mesh = make_mesh(1)
    if mesh.size != 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices is not ported yet: sharded "
            f"training comes with the multi-GPU slice (ROADMAP B14)"
        )

    def shard(tree):
        return _tree_map(lambda p: p.to(mesh.device, copy=True), tree)

    def step(params, tokens, targets):
        leaves = _tree_leaves(params)
        if tokens.device != leaves[0].device:
            raise ValueError(
                f"tokens on {tokens.device}, params on {leaves[0].device}"
            )
        # gradients of aliases: the caller's tensors keep their flags
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        loss = loss_fn(_tree_map(lambda _: next(it), params), tokens,
                       targets, cfg)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            sgd_update_(leaves, grads, lr)
        return params, loss.detach()

    return step, shard
