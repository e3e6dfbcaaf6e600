"""The transformer LM on one device: forward, prefill and KV-cache
generate, the loss and the SGD train step, dense or with experts.

The counterpart of ``accl_tpu/models/transformer.py`` on one card (tp = 1,
replicated activations).  Parameters are a plain dict with the JAX tree's
keys (``embed``, ``pos``, ``ln_f``, ``layers[i]`` with ``wq wk wv wo ln1
ln2`` and ``w1 w2``, or ``moe`` = ``{gate, w1, w2}`` with experts),
weights stored (d_in, d_out) as there, so a JAX tree carries across by
:func:`params_from_numpy`.  The dtype rules are the JAX module's: matmuls
in the activation dtype, attention scores and softmax statistics in
float32, probabilities cast back to v's dtype before P @ V, Python-float
scales (so bfloat16 activations stay bfloat16).

Attention lowers as ``cfg.attention`` says: ``"naive"`` (materialized
scores), ``"blockwise"`` (``ops.attention.blockwise_attention``),
``"flash"`` (the hand-written kernels, ``ops.cuda.attention``: the
forward, and the dQ and dK/dV backward when a gradient is taken) or
``"auto"`` (:func:`_resolve_attention`).  Unlike the JAX module, decode
writes each step's k/v into the cache IN PLACE, and the train step
writes the updated parameters into their own storage (the port's form
of JAX's ``donate_argnums``).

The makers take a mesh of virtual ranks on one device with JAX's axes
(:func:`~accl_tpu_torch.ops.driver.make_mesh`): ``("dp", "tp")`` or
``("dp", "ep", "tp")``.  The batch's rows split over the data axes (dp,
and ep where it carries experts, :func:`_data_axes`); tp is 1 or, under
``context_parallel``, the ring over which the sequence is striped.  The
ranks' activations are held as one tensor: layers that mix no tokens run
on the whole, attention splits the ring's shards (:func:`_block_cp`),
and an expert layer routes each rank's tokens on their own, with its own
capacity, through the expert axis's all-to-all (:func:`_moe`,
``models/moe.py``), as JAX's ``shard_map`` runs them.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, or tensors already on the CPU); without a card they
raise.  Tensor parallelism across cards (inside an expert too), sequence
and vocab parallelism come with later slices, and a config or mesh that
asks for them is refused.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..buffer import host_tensor
from ..ops.attention import blockwise_attention
from ..ops.cuda.attention import MAX_HEAD_DIM, flash_attention
from ..ops.driver import Mesh, make_mesh, resolve_device
from .moe import init_moe_params, moe_ffn
from .ring_attention import (stripe_sequence, striped_attention,
                             unstripe_sequence)

#: the JAX module's crossover (``_AUTO_FUSED_MIN_T``): "auto" runs naive
#: below this sequence length and a fused form from it up
_AUTO_FUSED_MIN_T = 1024

#: the fields the port refuses, and the slice each waits for
_LATER = {
    "seq_parallel": "the multi-GPU tensor-parallel slice (ROADMAP B14)",
    "vocab_parallel": "the multi-GPU tensor-parallel slice (ROADMAP B14)",
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Every field of the JAX ``TransformerConfig``; ``dtype`` is a torch
    dtype.  ``seq_parallel`` and ``vocab_parallel`` raise
    NotImplementedError naming the slice that ports them (after JAX's
    ValueErrors for ``context_parallel`` or ``n_experts`` with either).
    ``n_experts > 0`` replaces every block's dense FFN with the top-k
    routed expert FFN (``models/moe.py``), its bank sharded over the
    mesh axis ``moe_mesh_axis`` ("dp" or a dedicated "ep");
    ``ep_extends_dp`` makes a dense config's batch split over an "ep"
    axis too.  ``context_parallel`` stripes the sequence over
    the mesh's ``tp`` ring (a plain ``forward`` / ``loss_fn`` of token
    tensors runs the dense path, as JAX's with no tp axis).  ``remat``
    recomputes each block on the backward pass
    (``torch.utils.checkpoint``) when a gradient is taken.
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
        _check_axis_compat(self)
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


def _check_axis_compat(cfg) -> None:
    """context_parallel turns the tp axis into the sequence ring: JAX's
    ``_check_axis_compat`` (:165) refuses the strategies that give tp
    other jobs."""
    if cfg.context_parallel and (cfg.seq_parallel or cfg.vocab_parallel):
        raise ValueError(
            "context_parallel is incompatible with seq_parallel and "
            "vocab_parallel: the tp mesh axis becomes the sequence ring "
            "(weights replicated over it)"
        )
    if cfg.n_experts and cfg.seq_parallel:
        raise ValueError(
            "n_experts (MoE) does not compose with seq_parallel — the "
            "MLP entry would need a sequence gather in front of every "
            "routed dispatch; use context_parallel for sequence sharding "
            "with MoE (experts on the expert axis, ring on tp)"
        )
    if cfg.n_experts and cfg.moe_mesh_axis == "tp":
        raise ValueError(
            "moe_mesh_axis cannot be 'tp': tp carries the within-expert "
            "column/row split (and the cp ring) — put experts on 'dp' or "
            "a dedicated 'ep' mesh axis"
        )


class PartitionSpec:
    """A leaf's mesh axes, one entry a dimension, as
    ``jax.sharding.PartitionSpec``: None (not split), an axis name, or a
    tuple of names.  Not a tuple, so the tree functions take it as a
    leaf; ``tuple(spec)`` gives its entries."""

    def __init__(self, *parts):
        self.parts = parts

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"PartitionSpec{self.parts!r}"


def param_specs(cfg: TransformerConfig) -> Dict:
    """JAX's ``param_specs`` (:255) over ``("dp", "tp")`` or ``("dp",
    "ep", "tp")``: column-parallel weights split their output dim on tp,
    row-parallel their input dim (everything replicated under
    ``context_parallel``), and an expert bank its expert dim over
    ``cfg.moe_mesh_axis`` (and, but under cp, each expert's d_ff over
    tp).  On one card tp is 1 or the cp ring, so only the expert banks
    are really split; ZeRO's state layout reads the specs
    (``parallel/zero.py``)."""
    P = PartitionSpec
    _check_axis_compat(cfg)
    if cfg.context_parallel:
        layer = {k: P(None, None) if k[0] == "w" else P(None)
                 for k in ("wq", "wk", "wv", "wo", "w1", "w2", "ln1", "ln2")}
    else:
        layer = {"wq": P(None, "tp"), "wk": P(None, "tp"),
                 "wv": P(None, "tp"), "wo": P("tp", None),
                 "w1": P(None, "tp"), "w2": P("tp", None),
                 "ln1": P(None), "ln2": P(None)}
    if cfg.n_experts:
        for k_ in ("w1", "w2"):
            layer.pop(k_)
        ep_ax = cfg.moe_mesh_axis
        if cfg.context_parallel:
            layer["moe"] = {"gate": P(None, None), "w1": P(ep_ax, None, None),
                            "w2": P(ep_ax, None, None)}
        else:
            layer["moe"] = {"gate": P(None, None), "w1": P(ep_ax, None, "tp"),
                            "w2": P(ep_ax, "tp", None)}
    out = {"embed": P("tp", None) if cfg.vocab_parallel else P(None, None),
           "ln_f": P(None),
           "layers": [dict(layer) for _ in range(cfg.n_layers)]}
    if not cfg.uses_rope():
        out["pos"] = P(None, None)
    return out


Params = Dict


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """The JAX ``init_params`` tree (:314): weights normal(0, 0.02) drawn
    from ``generator`` on its own device (in float32, then cast to
    ``cfg.dtype``), layer norms ones, and with experts each layer's
    ``moe`` bank from :func:`init_moe_params` in place of ``w1`` / ``w2``
    (:346-351), on ``device`` (the card unless the caller passes
    ``device="cpu"``).  The draws cannot equal JAX's PRNG: carry a JAX
    tree across with :func:`params_from_numpy` instead."""
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
        layer = {
            "wq": normal(cfg.d_model, cfg.d_model),
            "wk": normal(cfg.d_model, d_kv),
            "wv": normal(cfg.d_model, d_kv),
            "wo": normal(cfg.d_model, cfg.d_model),
            "ln1": ones(cfg.d_model),
            "ln2": ones(cfg.d_model),
        }
        if cfg.n_experts:
            layer["moe"] = init_moe_params(cfg.d_model, cfg.d_ff,
                                           cfg.n_experts, generator,
                                           cfg.dtype, dev)
        else:
            layer["w1"] = normal(cfg.d_model, cfg.d_ff)
            layer["w2"] = normal(cfg.d_ff, cfg.d_model)
        params["layers"].append(layer)
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
    """The port's tree for a JAX tree given as numpy arrays
    (``jax.tree.map(np.asarray, tree)``): same keys and nesting, each
    array copied onto ``device`` (the card unless ``device="cpu"``);
    bfloat16 arrays keep their bits.  Every layout the port shares with
    JAX carries this way: the flagship's per-layer tree, the composed
    step's STACKED tree (``composed.stack_params``; under ``v_stages > 1``
    its layers in ``interleave_layer_order``, as JAX's ``shard`` commits
    them) and a ZeRO state (``m``, ``v``, ``w``: each leaf's flat
    dp-sliced float32 layout, nested inside the stage split for the
    composed step; ``step`` a 0-d int32)."""
    dev = resolve_device(device)

    def conv(x):
        arr = np.array(x)  # a writable host copy (JAX arrays are not)
        return host_tensor(arr).reshape(arr.shape).to(dev)

    return _tree_map(conv, tree)


def params_to_numpy(params):
    """The inverse of :func:`params_from_numpy`, for each of its layouts:
    the tree as host numpy arrays, same keys and nesting; bfloat16 tensors
    keep their bits (as ``ml_dtypes.bfloat16`` arrays, the dtype JAX's
    numpy arrays have)."""

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
    """Rows of the replicated embedding table (``F.embedding``: its
    backward adds a row's gradients in a fixed order, where indexing's
    accumulates them in parallel on the CPU, run to run differently)."""
    return F.embedding(ids, embed)


def _embed_tokens(params, tokens, cfg, positions=None):
    """Token embeddings, plus the learned position table unless the config
    uses rotary embeddings: its first rows, or its rows at ``positions``
    (the striped shards' global positions under context parallelism)."""
    x = _embed_rows(params["embed"], tokens)
    if not cfg.uses_rope():
        pos = params["pos"]
        x = x + (pos[: tokens.shape[1]] if positions is None
                 else pos[positions])
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


class _Ranks(NamedTuple):
    """The virtual ranks one activation (B, T, D) holds: ``data`` over its
    rows (the batch's data axes, rank-major), ``ring`` over its sequence
    (the cp ring's striped shards, in rank order), and ``ep`` the expert
    axis's size, its groups runs of ``ep`` consecutive data ranks (dp
    under experts on dp; ep, minor to dp, on a dedicated axis)."""

    data: int = 1
    ring: int = 1
    ep: int = 1


def _moe(h, p, cfg, ranks: Optional[_Ranks], capacity_factor: float,
         with_aux: bool):
    """The expert FFN on ``h`` (B, T, D), each rank's tokens (B / data,
    T / ring) routed on their own through the expert axis's all-to-all;
    without ``ranks`` one rank with every expert local (JAX with no
    expert axis).  Returns (y, aux): aux each rank's router terms, (R,)
    float32, ranks ordered (ring, data), or None."""
    ranks = ranks or _Ranks()
    B, T, D = h.shape
    d, r = ranks.data, ranks.ring
    slabs = (h.reshape(d, B // d, r, T // r, D).permute(2, 0, 1, 3, 4)
             .reshape(r * d, B // d, T // r, D))
    out = moe_ffn(slabs, p, ranks.ep, capacity_factor, cfg.moe_top_k,
                  with_aux)
    y, aux = out if with_aux else (out, None)
    y = (y.reshape(r, d, B // d, T // r, D).permute(1, 2, 0, 3, 4)
         .reshape(B, T, D))
    return y, aux


def _mlp(x, lp, moe_cfg=None, ranks: Optional[_Ranks] = None,
         with_aux: bool = False, moe_no_drop: bool = False):
    """The block's MLP half (JAX's ``_mlp`` :569): ln2, then the dense
    pair (up, gelu in its tanh form, JAX's default, down) or, when the
    layer carries an expert bank, the routed expert FFN (:func:`_moe`);
    residual.  ``moe_no_drop`` (decode) routes with capacity factor E, so
    a step of a few tokens drops none; ``with_aux=True`` returns ``(out,
    aux)``, aux None for a dense layer."""
    h = _layernorm(x, lp["ln2"])
    if "moe" in lp:
        cf = (float(moe_cfg.n_experts) if moe_no_drop
              else moe_cfg.moe_capacity_factor)
        y, aux = _moe(h, lp["moe"], moe_cfg, ranks, cf, with_aux)
        return (x + y, aux) if with_aux else x + y
    out = x + F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]
    return (out, None) if with_aux else out


def _attn_partial(h, lp, n_heads, attn_impl="naive", causal=True,
                  rope_base=None, positions=None, attention_fn=None):
    """Attention on a full-sequence activation: returns the output
    projection and the (k, v) head tensors (B, Hkv, T, hd) for the
    KV-cache prefill (rotated keys under rope).  ``positions`` overrides
    the rope positions and ``attention_fn`` the :func:`_attention`
    lowering (context parallelism passes the striped shards' global
    positions and the ring)."""
    B, T, _ = h.shape
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    hd = q.shape[-1] // n_heads
    n_kv = k.shape[-1] // hd

    def heads(t, n):
        return t.reshape(B, T, n, hd).transpose(1, 2)

    q, k, v = heads(q, n_heads), heads(k, n_kv), heads(v, n_kv)
    if rope_base is not None:
        pos = torch.arange(T, device=h.device) if positions is None \
            else positions
        tables = _rope_tables(pos, hd // 2, rope_base)
        q = _rope_rotate(q, tables)
        k = _rope_rotate(k, tables)
    if attention_fn is not None:
        attn = attention_fn(q, k, v)
    else:
        attn = _attention(q, k, v, impl=attn_impl, causal=causal)
    attn = attn.transpose(1, 2).reshape(B, T, -1)
    return attn @ lp["wo"], (k, v)


def _block(x, lp, n_heads, return_kv=False, attn_impl="naive", causal=True,
           rope_base=None, moe_cfg=None, ranks=None, with_aux=False):
    """One transformer block; ``return_kv=True`` also returns the (k, v)
    head tensors (the prefill path), ``with_aux=True`` (training)
    returns ``(out, aux)`` with the layer's router terms."""
    h = _layernorm(x, lp["ln1"])
    o, kv = _attn_partial(h, lp, n_heads, attn_impl, causal, rope_base)
    out = _mlp(x + o, lp, moe_cfg, ranks, with_aux)
    return (out, kv) if return_kv else out


def _cp_active(cfg, ring: Optional[int]) -> bool:
    return bool(cfg.context_parallel) and ring is not None


def _cp_positions(t_local: int, size: int, rank: int, device=None):
    """Global token positions of rank ``rank``'s STRIPED shard of a ring
    of ``size`` (JAX's ``_cp_positions`` :379, whose axis gives both):
    local position ``t`` holds global token ``t * size + rank``."""
    return torch.arange(t_local, device=device) * size + rank


def _striped_positions(T: int, size: int, device=None):
    """The positions of the ring's striped shards held as one sequence
    (rank order)."""
    return torch.cat([_cp_positions(T // size, size, r, device)
                      for r in range(size)])


def _cp_block_k(t_local: int, attn_impl: str) -> Optional[int]:
    """The ring fold's within-hop key chunk (JAX's ``_cp_block_k`` :691):
    whole hops under "naive"; under "blockwise" and "flash", and under
    "auto" from ``_AUTO_FUSED_MIN_T`` up, the largest of 512, 256, 128
    and 64 that divides the shard and is shorter than it."""
    if attn_impl == "naive":
        return None
    if attn_impl == "auto" and t_local < _AUTO_FUSED_MIN_T:
        return None
    for b in (512, 256, 128, 64):
        if t_local % b == 0 and b < t_local:
            return b
    return None  # tiny or ragged shard: whole-hop folds are small


def _block_cp(x, lp, n_heads, ring: int, rope_base=None, attn_impl="auto",
              moe_cfg=None, ranks=None, with_aux=False):
    """The context-parallel block (JAX's ``_block_cp`` :708) on the
    ``ring`` ranks' STRIPED shards held as one sequence: ``x`` (B, T, D)
    is their (B, T / ring, D) shards concatenated in rank order.  The
    layer norms, the projections and the MLP mix no tokens, so they run
    on the whole; attention cuts q, k and v into the ranks' shards for
    the striped causal ring (:func:`striped_attention`, kv heads rotating
    unexpanded under GQA, ``block_k`` from :func:`_cp_block_k`), and rope
    rotates by each shard's global positions.  An expert layer routes
    each (data, ring) rank's striped shard on its own (``ranks``), over
    the expert axis, as JAX's MoE x cp does."""
    T = x.shape[1]
    t_local = T // ring
    block_k = _cp_block_k(t_local, attn_impl)

    def attention(q, k, v):
        shards = (t.split(t_local, dim=2) for t in (q, k, v))
        return torch.cat(striped_attention(*shards, causal=True,
                                           block_k=block_k), dim=2)

    h = _layernorm(x, lp["ln1"])
    o, _ = _attn_partial(h, lp, n_heads, rope_base=rope_base,
                         positions=_striped_positions(T, ring, x.device),
                         attention_fn=attention)
    return _mlp(x + o, lp, moe_cfg, ranks, with_aux)


def _enter_block_layout(x, cfg, return_kv=False, causal=True,
                        ring: Optional[int] = None,
                        ranks: Optional[_Ranks] = None):
    """The block stack's layout and block (JAX's :773): under context
    parallelism with a ring, ``x`` is ALREADY the ranks' striped shards
    (held as one sequence) and blocks run :func:`_block_cp`; otherwise
    activations stay whole and blocks run :func:`_block`.  With experts
    the blocks route over ``ranks`` and, but on the serving path
    (``return_kv``), return their router terms.  Returns ``(x,
    block_fn)``."""
    cfg.kv_heads()  # validates n_kv_heads
    rope_base = cfg.rope_base if cfg.uses_rope() else None
    moe = {}
    if cfg.n_experts:
        moe = dict(moe_cfg=cfg, ranks=ranks, with_aux=not return_kv)
    if _cp_active(cfg, ring):
        if return_kv:
            raise ValueError(
                "context_parallel has no serving path: decode with "
                "dataclasses.replace(cfg, context_parallel=False) — cp "
                "params are replicated over tp and re-shard directly"
            )
        if not causal:
            raise ValueError(
                "context_parallel is causal/decoder-only (the striped "
                "ring's load balance argument is the causal mask)"
            )
        return x, partial(_block_cp, n_heads=cfg.n_heads, ring=ring,
                          rope_base=rope_base, attn_impl=cfg.attention,
                          **moe)
    return x, partial(_block, n_heads=cfg.n_heads, return_kv=return_kv,
                      attn_impl=cfg.attention, causal=causal,
                      rope_base=rope_base, **moe)


def _run_blocks(x, params, block, cfg):
    """``x`` through every layer's block (recomputed on the backward pass
    under ``cfg.remat``); returns ``(x, aux)``, aux the layer sums of the
    router terms with experts (JAX's :866-874), else None."""
    aux = None
    for lp in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            out = checkpoint(block, x, lp, use_reentrant=False)
        else:
            out = block(x, lp)
        if not cfg.n_experts:
            x = out
            continue
        x, a = out
        aux = a if aux is None else {n: aux[n] + a[n] for n in a}
    return x, aux


def _final_hidden(params, tokens, cfg, ring: Optional[int] = None,
                  ranks: Optional[_Ranks] = None):
    """Embed, blocks, final layer norm; with a ``ring``, ``tokens`` (B, T)
    are its ranks' striped shards held as one sequence (each its own
    expert rank unless ``ranks`` says more).  Returns ``(x, aux)``."""
    positions = None
    if _cp_active(cfg, ring):
        positions = _striped_positions(tokens.shape[1], ring, tokens.device)
        ranks = ranks or _Ranks(1, ring, 1)
    x = _embed_tokens(params, tokens, cfg, positions)
    x, block = _enter_block_layout(x, cfg, ring=ring, ranks=ranks)
    x, aux = _run_blocks(x, params, block, cfg)
    return _layernorm(x, params["ln_f"]), aux


def _ring_of(tokens, cfg) -> Optional[int]:
    """The ring size when ``tokens`` are the ranks' shards (a list or
    tuple, rank order), else None."""
    if not isinstance(tokens, (list, tuple)):
        return None
    if not cfg.context_parallel:
        raise ValueError("per-rank token shards need context_parallel")
    if len({tuple(t.shape) for t in tokens}) != 1:
        raise ValueError(f"the ranks' shards differ in shape: "
                         f"{[tuple(t.shape) for t in tokens]}")
    return len(tokens)


def forward(params, tokens, cfg: TransformerConfig):
    """Logits (B, T, vocab) for a token batch (B, T).

    Under ``cfg.context_parallel``, ``tokens`` given as the ring's ranks
    (a list of P striped shards (B, T / P), rank order, as
    :func:`stripe_sequence` and a contiguous split cut them) returns each
    rank's striped (B, T / P, vocab) logits shard, as JAX's forward does
    inside the makers' ``shard_map``; a (B, T) tensor runs the dense
    path, as JAX's with no tp axis.  Experts route over one rank, or
    over each ring rank on its own."""
    ring = _ring_of(tokens, cfg)
    if ring is None:
        return _lm_logits(_final_hidden(params, tokens, cfg)[0],
                          params["embed"])
    z = _lm_logits(
        _final_hidden(params, torch.cat(tokens, 1), cfg, ring)[0],
        params["embed"])
    return list(z.split(z.shape[1] // ring, dim=1))


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def _block_decode(x_t, lp, cache_k, cache_v, pos: int, n_heads: int,
                  rope_tables=None, moe_cfg=None, ranks=None):
    """One block for a single decode position: write this step's k/v into
    the cache at ``pos`` (in place), attend over positions <= pos with
    the JAX form's mask over the whole cache.  The cache is (B, Hkv, S,
    hd); query heads group onto kv head h // G.  An expert layer routes
    with the no-drop capacity (JAX's ``moe_no_drop``, :1060).  Returns
    x_out."""
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
    return _mlp(x_t + attn @ lp["wo"], lp, moe_cfg, ranks, moe_no_drop=True)


def prefill(params, tokens, cfg: TransformerConfig,
            cache_len: Optional[int] = None, ranks: Optional[_Ranks] = None):
    """Run the prompt through the model once, building the KV cache.
    Returns (last-position logits (B, vocab), caches): a list of (k, v)
    tensors (B, Hkv, cache_len, hd), kv heads only under GQA.
    ``cache_len`` defaults to ``cfg.max_seq``.  Expert layers route over
    ``ranks`` (one rank by default) with the training capacity, as
    JAX's prefill does."""
    B, T = tokens.shape
    S = cfg.max_seq if cache_len is None else int(cache_len)
    x = _embed_tokens(params, tokens, cfg)
    hd = cfg.d_model // cfg.n_heads
    x, block_kv = _enter_block_layout(x, cfg, return_kv=True, ranks=ranks)
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
                 tok, pos: int, cfg: TransformerConfig,
                 ranks: Optional[_Ranks] = None):
    """One decode step: the tokens ``tok`` (B,) at position ``pos``
    through every layer (each writing its cache at ``pos``, its experts
    routed over ``ranks``); returns the next logits (B, vocab)."""
    x = _embed_rows(params["embed"], tok)[:, None, :]
    tables = None
    if cfg.uses_rope():
        hd = cfg.d_model // cfg.n_heads
        tables = _rope_tables(torch.tensor([pos], device=tok.device),
                              hd // 2, cfg.rope_base)
    else:
        x = x + params["pos"][pos:pos + 1][None]
    for lp, (ck, cv) in zip(params["layers"], caches):
        x = _block_decode(x, lp, ck, cv, pos, cfg.n_heads, tables,
                          cfg if cfg.n_experts else None, ranks)
    x = _layernorm(x, params["ln_f"])
    return _lm_logits(x[:, 0], params["embed"])


def generate(params, prompt, steps: int, cfg: TransformerConfig,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             ranks: Optional[_Ranks] = None):
    """Autoregressive decode on the device of ``params`` and ``prompt``:
    prefill the prompt, then single-token steps through the KV cache.
    Returns the (B, steps) generated ids g_0 .. g_{steps-1} in the
    prompt's dtype.  The JAX scan's last step computes a token it never
    emits; this loop stops after the last emitted one.

    ``temperature=0`` (default) is greedy and deterministic.
    ``temperature > 0`` samples from the temperature-scaled distribution,
    truncated to ``top_k`` logits when given, drawing from ``generator``
    (a ``torch.Generator`` on the params' device, in place of JAX's
    ``rng`` key): its tokens cannot equal JAX's PRNG stream.  ``ranks``
    (:func:`make_sharded_generate` sets them) are the virtual ranks the
    expert layers route over."""
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
        logits, caches = prefill(params, prompt, cfg, T + steps, ranks)
        tok = _select_token(logits, generator, temperature, top_k)
        toks = [tok]
        for i in range(steps - 1):
            logits = _decode_step(params, caches, tok, T + i, cfg, ranks)
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


def _nll(params, tokens, targets, cfg, ring: Optional[int] = None,
         ranks: Optional[_Ranks] = None):
    """Per-token NLL (B, T) and the router terms (None, or each rank's
    layer sums); with a ``ring``, of its ranks' striped shards held as
    one sequence."""
    x, aux = _final_hidden(params, tokens, cfg, ring, ranks)
    return _token_nll(_lm_logits(x, params["embed"]), targets), aux


def _ring_mean(nll, dp: int = 1, ring: Optional[int] = None):
    """JAX's reduction of the per-token NLL (B, T) over a (dp, ring) mesh:
    each rank's local mean (rows of its dp group, its striped shard), the
    ring's mean of those (``loss_fn``'s psum / tp, :923-937), then the dp
    mean (``_mean_over_axes`` :242)."""
    if dp == 1 and ring is None:
        return nll.mean()
    B, T = nll.shape
    r = ring or 1
    local = nll.reshape(dp, B // dp, r, T // r).mean((1, 3))
    return (local.sum(1) / r).sum(0) / dp


def _moe_penalty(cfg, aux):
    """The router health penalty (JAX's :428): the Switch load balance and
    the ST-MoE z-loss, each weighted and averaged over layers (``aux``
    carries their layer sums, one a rank)."""
    n = float(cfg.n_layers)
    return (cfg.moe_aux_weight * aux["load_balance"] / n
            + cfg.moe_router_z_weight * aux["router_z"] / n)


def _global_loss(nll, aux, cfg, dp: int = 1, ring: Optional[int] = None):
    """The global mean loss: :func:`_ring_mean` of the NLL, plus, with
    experts, the ranks' mean of their own router penalties — each rank
    adds its penalty to its local loss before the ring and dp means
    (:930-937, :948-951)."""
    loss = _ring_mean(nll, dp, ring)
    if aux is not None:
        loss = loss + _moe_penalty(cfg, aux).mean()
    return loss


def loss_fn(params, tokens, targets, cfg: TransformerConfig):
    """Mean next-token NLL of a token batch (B, T) against ``targets``
    (B, T), at tp = 1 (the JAX function's non-vocab-parallel branch;
    vocab parallelism is refused by the config), plus the router penalty
    with experts (one rank, every expert local).

    Under ``cfg.context_parallel``, ``tokens`` and ``targets`` given as
    the ring's ranks (lists of striped shards, as :func:`forward` takes
    them) give the ring mean of each rank's local loss, JAX's cp
    branch."""
    ring = _ring_of(tokens, cfg)
    if ring is None:
        return _global_loss(*_nll(params, tokens, targets, cfg), cfg)
    return _global_loss(*_nll(params, torch.cat(tokens, 1),
                              torch.cat(targets, 1), cfg, ring),
                        cfg, ring=ring)


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


def _check_moe_mesh(cfg, mesh: Mesh) -> None:
    """JAX's divisibility errors for the expert sharding (:190), which name
    ``n_experts`` and the axis."""
    if not cfg.n_experts:
        return
    ep_ax = cfg.moe_mesh_axis
    if ep_ax not in mesh.axis_names:
        raise ValueError(
            f"moe_mesh_axis {ep_ax!r} is not an axis of this mesh "
            f"({mesh.axis_names}) — expert parallelism needs its axis "
            "in the mesh"
        )
    ep = mesh.shape[ep_ax]
    tp = mesh.shape["tp"]
    if cfg.n_experts % ep:
        raise ValueError(
            f"n_experts ({cfg.n_experts}) must divide by {ep_ax} ({ep}) "
            "— expert parallelism shards the expert bank over "
            f"the {ep_ax!r} axis"
        )
    if not cfg.context_parallel and cfg.d_ff % tp:
        raise ValueError(
            f"d_ff ({cfg.d_ff}) must divide by tp ({tp}) — each "
            "expert's FFN is column/row-split over tp"
        )


def _data_axes(cfg, mesh: Mesh) -> tuple:
    """The mesh axes the batch (and the loss mean) splits over (JAX's
    :219): "dp", and the dedicated expert axis when the mesh has one —
    or, for a config that opts in (``ep_extends_dp``, :131), an "ep"
    axis as more data parallelism."""
    ep_ax = cfg.moe_mesh_axis
    if cfg.n_experts and ep_ax != "dp" and ep_ax in mesh.axis_names:
        return ("dp", ep_ax)
    if cfg.ep_extends_dp and "ep" in mesh.axis_names:
        return ("dp", "ep")
    return ("dp",)


def _mesh_dp_tp(cfg, mesh: Optional[Mesh]) -> Tuple[Mesh, int, int, int]:
    """``(mesh, data, tp, ep)`` of a model mesh (None: one rank on the
    card).  A mesh names JAX's axes ``("dp", "tp")`` or ``("dp", "ep",
    "tp")``: ``data`` is the number of ranks the batch's rows split over
    (:func:`_data_axes`), ``ep`` the expert axis's size (1 without
    experts), and tp is 1 or, under ``cfg.context_parallel``, the ring.
    Dense tensor parallelism and a mesh of more than one rank without
    axis names come with the multi-GPU slice."""
    mesh = make_mesh(1) if mesh is None else mesh
    if not mesh.axis_names:
        if mesh.size != 1:
            raise NotImplementedError(
                f"a mesh of {mesh.size} devices is not ported yet: sharded "
                f"models come with the multi-GPU slice (ROADMAP B14); "
                f"name the axes (\"dp\", \"tp\") for data or context "
                f"parallelism on one device"
            )
        return mesh, 1, 1, 1
    if sorted(mesh.axis_names) not in (["dp", "tp"], ["dp", "ep", "tp"]):
        raise ValueError(f"a model mesh has the axes ('dp', 'tp') or ('dp', "
                         f"'ep', 'tp'), got {mesh.axis_names}")
    _check_moe_mesh(cfg, mesh)
    tp = mesh.shape["tp"]
    if not cfg.context_parallel:
        _refuse_dense_tp(tp)
    data = math.prod(mesh.shape[a] for a in _data_axes(cfg, mesh))
    ep = mesh.shape[cfg.moe_mesh_axis] if cfg.n_experts else 1
    return mesh, data, tp, ep


def _refuse_dense_tp(tp: int) -> None:
    """Dense tensor parallelism comes with the multi-GPU slice."""
    if tp > 1:
        raise NotImplementedError(
            f"tensor parallelism over tp = {tp} is not ported yet: it comes "
            f"with the multi-GPU slice (ROADMAP B14, queue item A9c)"
        )


def _mesh_pp_dp_tp(mesh: Mesh) -> Tuple[int, int, int]:
    """``(pp, dp, tp)`` of the composed pipeline's mesh, JAX's ``("pp",
    "dp", "tp")`` of virtual ranks on one device (``models/composed.py``
    refuses tp > 1 after JAX's own checks, :func:`_refuse_dense_tp`)."""
    if sorted(mesh.axis_names) != ["dp", "pp", "tp"]:
        raise ValueError(f"the composed pipeline's mesh has the axes ('pp', "
                         f"'dp', 'tp'), got {mesh.axis_names}")
    return mesh.shape["pp"], mesh.shape["dp"], mesh.shape["tp"]


def _mesh_ranks(cfg, data: int, ring: Optional[int], ep: int):
    """The ranks a maker's expert layers route over (None when dense)."""
    return _Ranks(data, ring or 1, ep) if cfg.n_experts else None


def _check_batch(tokens, device, dp: int) -> None:
    """Tokens on the parameters' device, their rows split evenly over
    dp."""
    if tokens.device != device:
        raise ValueError(f"tokens on {tokens.device}, params on {device}")
    if tokens.shape[0] % dp:
        raise ValueError(f"batch {tokens.shape[0]} must divide by dp {dp}")


def _sharder(mesh: Mesh):
    """The makers' ``shard``: a copy of a parameter tree on the mesh's
    device (every weight is replicated over the mesh)."""
    return lambda tree: _tree_map(lambda p: p.to(mesh.device, copy=True),
                                  tree)


def make_sharded_train_step(cfg: TransformerConfig, lr: float = 1e-2,
                            mesh: Optional[Mesh] = None):
    """One SGD train step, JAX's return shape: ``(step, shard)``.

    ``shard(tree)`` copies a parameter tree onto the mesh's device (the
    card unless ``mesh`` says otherwise); ``step(params, tokens,
    targets)`` takes the gradient of the global mean loss (JAX's: each
    rank's local mean, plus its router penalty with experts, the ring's
    mean, the data axes' mean) with respect to every parameter and
    returns ``(params, loss)``, the parameters updated to ``p - lr * g``
    IN PLACE (rounded as JAX rounds it for this lr's type,
    :func:`sgd_update_`) and the same tree returned.  ``lr`` is any real
    scalar: a Python number, a NumPy scalar or a 0-d tensor.

    ``mesh`` is one rank, or a ``("dp", "tp")`` or ``("dp", "ep", "tp")``
    mesh of virtual ranks on one device (:func:`_mesh_dp_tp`): each data
    rank takes its rows of the batch, and its experts' tokens route on
    their own; under ``cfg.context_parallel`` the tokens and targets are
    striped over the tp ring outside the step (``stripe_sequence``) and
    the ranks run :func:`_block_cp`."""
    _reject_untrainable_attention(cfg)
    _lr_scalar(lr)  # refuse what the update cannot hold, before any work
    mesh, data, tp, ep = _mesh_dp_tp(cfg, mesh)
    ring = tp if cfg.context_parallel else None
    ranks = _mesh_ranks(cfg, data, ring, ep)

    def step(params, tokens, targets):
        leaves = _tree_leaves(params)
        _check_batch(tokens, leaves[0].device, data)
        if ring is not None:
            tokens = stripe_sequence(tokens, ring, axis=1)
            targets = stripe_sequence(targets, ring, axis=1)
        # gradients of aliases: the caller's tensors keep their flags
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        nll, aux = _nll(_tree_map(lambda _: next(it), params), tokens,
                        targets, cfg, ring, ranks)
        loss = _global_loss(nll, aux, cfg, data, ring)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            sgd_update_(leaves, grads, lr)
        return params, loss.detach()

    return step, _sharder(mesh)


def make_sharded_forward(cfg: TransformerConfig, mesh: Optional[Mesh] = None):
    """The forward over a mesh (JAX's :1310): ``(fn, shard)``, ``fn(params,
    tokens)`` giving the (B, T, vocab) logits of a (B, T) token batch.
    Dense on a mesh whose tp is 1, each data rank's experts routing on
    their own; under ``cfg.context_parallel`` the tokens are striped over
    the tp ring on the way in and the logits unstriped on the way out, so
    the caller sees token order."""
    mesh, data, tp, ep = _mesh_dp_tp(cfg, mesh)
    ring = tp if cfg.context_parallel else None
    ranks = _mesh_ranks(cfg, data, ring, ep)

    def fn(params, tokens):
        _check_batch(tokens, params["embed"].device, data)
        if ring is not None:
            tokens = stripe_sequence(tokens, ring, axis=1)
        z = _lm_logits(_final_hidden(params, tokens, cfg, ring, ranks)[0],
                       params["embed"])
        return z if ring is None else unstripe_sequence(z, ring, axis=1)

    return fn, _sharder(mesh)


def make_sharded_generate(cfg: TransformerConfig, mesh: Optional[Mesh],
                          steps: int, temperature: float = 0.0,
                          top_k: Optional[int] = None):
    """Generation over a mesh whose tp is 1 (JAX's :1203): ``(fn,
    shard)``, ``fn(params, prompt)`` giving the (B, steps) generated
    tokens of :func:`generate` (``fn(params, prompt, generator)`` when
    ``temperature > 0``), each data rank's experts routing its own rows
    of the prompt and of every step.  Context parallelism has no serving
    path: decode with ``context_parallel=False``, on the same
    parameters."""
    if cfg.context_parallel:
        raise ValueError(
            "context_parallel has no serving path: decode with "
            "dataclasses.replace(cfg, context_parallel=False) — cp "
            "params are replicated over tp and re-shard directly"
        )
    mesh, data, _, ep = _mesh_dp_tp(cfg, mesh)
    ranks = _mesh_ranks(cfg, data, None, ep)

    def fn(params, prompt, generator=None):
        _check_batch(prompt, params["embed"].device, data)
        return generate(params, prompt, steps, cfg, temperature=temperature,
                        top_k=top_k, generator=generator, ranks=ranks)

    return fn, _sharder(mesh)
