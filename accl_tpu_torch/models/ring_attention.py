"""Ring attention: sequence parallelism over P ranks, in plain PyTorch.

The counterpart of ``accl_tpu/models/ring_attention.py``.  JAX runs these
functions inside ``shard_map`` over a 1-D mesh axis, each rank holding its
``(B, H, T_local, D)`` shard; here a function takes the ranks' shards as
lists (``qs``, ``ks``, ``vs``, each of length P, rank order), the
convention of the port's collectives, and returns one result per rank.
``lax.axis_size`` is ``len(qs)``, ``lax.axis_index`` the list position,
and a ``ppermute`` hop an index rotation of the list, which copies
nothing.  Everything is differentiable through autograd, as the JAX forms
are under ``jax.grad``.

These are the model-level forms: masks of -inf with the ``isneginf``
guards, grouped-query K/V rotated unexpanded, optional ``block_k``
chunks.  The one-launch kernel form (row 15, -1e30 masks, whole hops) is
``accl_tpu_torch.ops.cuda.attention.ring_attention``, exported as
``ring_attention_pallas``; the two are held against each other within
tolerance, not bit for bit, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

Ranks = Sequence[torch.Tensor]


def _scores(q, k_blk):
    """``einsum(..., preferred_element_type=f32)``: 16-bit operands widen
    exactly and the products accumulate in float32; grouped-query K/V
    (Hkv heads dividing H) serve kv-major groups of H / Hkv query heads,
    never expanded."""
    B, H, Tq, D = q.shape
    Hkv = k_blk.shape[1]
    kt = k_blk.float().transpose(-1, -2)
    if H == Hkv:
        return torch.matmul(q.float(), kt)
    qg = q.float().reshape(B, Hkv, H // Hkv, Tq, D)
    return torch.matmul(qg, kt[:, :, None]).reshape(B, H, Tq, -1)


def _weighted(p, v_blk, H: int):
    """``p @ v`` in float32 with ``p`` already rounded to v's dtype, under
    the same kv-major grouping."""
    B, _, Tq, Tk = p.shape
    Hkv, D = v_blk.shape[1], v_blk.shape[3]
    if H == Hkv:
        return torch.matmul(p.float(), v_blk.float())
    pg = p.float().reshape(B, Hkv, H // Hkv, Tq, Tk)
    return torch.matmul(pg, v_blk.float()[:, :, None]).reshape(B, H, Tq, D)


def _fold_block(q, k_blk, v_blk, o, m, l, block_mask):
    """Online-softmax accumulation of one K/V block (``_fold_block`` :29).

    q: (B, H, Tq, D); k_blk / v_blk: (B, Hkv, Tk, D), Hkv dividing H; o:
    (B, H, Tq, D) float32 numerator; m, l: (B, H, Tq, 1) float32 running
    max and denominator; block_mask: (Tq, Tk) bool, True = attend.
    Masked scores are -inf; a fully masked block contributes nothing."""
    D = q.shape[-1]
    scores = _scores(q, k_blk) * (1.0 / math.sqrt(D))
    scores = torch.where(block_mask, scores, -math.inf)
    m_blk = scores.amax(-1, keepdim=True)
    m_new = torch.maximum(m, m_blk)
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(scores - m_safe)
    p = torch.where(torch.isneginf(scores), 0.0, p)
    alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    acc = _weighted(p.to(v_blk.dtype), v_blk, q.shape[1])
    o = o * alpha + acc
    l = l * alpha + p.sum(-1, keepdim=True)
    return o, m_new, l


def _fold_visiting(q, k_blk, v_blk, o, m, l, mask, block_k):
    """Fold one visiting block, in ``block_k``-key chunks when given
    (``_fold_visiting`` :85): the per-hop score tile is then (Tq,
    block_k)."""
    Tk = k_blk.shape[2]
    if block_k is None or block_k >= Tk:
        return _fold_block(q, k_blk, v_blk, o, m, l, mask)
    if Tk % block_k:
        raise ValueError(
            f"block_k ({block_k}) must divide the local K length ({Tk})")
    for c in range(0, Tk, block_k):
        o, m, l = _fold_block(q, k_blk[:, :, c:c + block_k],
                              v_blk[:, :, c:c + block_k], o, m, l,
                              mask[:, c:c + block_k])
    return o, m, l


def _ring_scan(qs: Ranks, ks: Ranks, vs: Ranks,
               mask_for: Callable[[int, int], torch.Tensor],
               block_k: Optional[int] = None) -> List[torch.Tensor]:
    """The shared rotation (``_ring_scan`` :109) on every rank ``me``:
    fold the own block, then the block of origin (me - 1 - s) mod P for s =
    0..P-2 — the one the ring's s + 1-th hop delivers — each under
    ``mask_for(me, origin)``."""
    P = len(qs)
    if len(ks) != P or len(vs) != P:
        raise ValueError(f"{P} q shards but {len(ks)} k and {len(vs)} v")
    outs = []
    for me, q in enumerate(qs):
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[:3] + (1,), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(q.shape[:3] + (1,), dtype=torch.float32,
                        device=q.device)
        o, m, l = _fold_visiting(q, ks[me], vs[me], o, m, l,
                                 mask_for(me, me), block_k)
        for s in range(P - 1):
            origin = (me - 1 - s) % P
            o, m, l = _fold_visiting(q, ks[origin], vs[origin], o, m, l,
                                     mask_for(me, origin), block_k)
        outs.append((o / l.clamp_min(1e-30)).to(q.dtype))
    return outs


def _masks(Tq: int, Tk: int, device):
    full = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    return full, torch.tril(full), torch.tril(full, diagonal=-1)


def ring_attention(qs: Ranks, ks: Ranks, vs: Ranks, causal: bool = True,
                   block_k: Optional[int] = None) -> List[torch.Tensor]:
    """Attention over the full sequence, sharded contiguously in rank
    order (``ring_attention`` :139).  qs[r]: (B, H, T_local, D); ks[r],
    vs[r]: (B, Hkv, T_local, D) with Hkv dividing H (rotated unexpanded).
    Returns each rank's query rows attended over every rank's keys."""
    full, tri, _ = _masks(qs[0].shape[2], ks[0].shape[2], qs[0].device)
    none = torch.zeros_like(full)

    def mask_for(me, origin):
        if not causal:
            return full
        return tri if origin == me else full if origin < me else none

    return _ring_scan(qs, ks, vs, mask_for, block_k)


def reference_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Single-device ground truth (``reference_attention`` :167): q, k, v
    (B, H, T, D) of the full sequence; scores in float32 masked to -1e30,
    softmax in float32, probabilities rounded to v's dtype, then P @ V
    (computed in float32 and rounded to v's dtype)."""
    T = q.shape[2]
    scores = _scores(q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        tri = torch.tril(torch.ones(T, T, dtype=torch.bool, device=q.device))
        scores = torch.where(tri, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


# ---------------------------------------------------------------------------
# striped layout: load-balanced causal ring attention
# ---------------------------------------------------------------------------


def stripe_sequence(x: torch.Tensor, size: int, axis: int = 2) -> torch.Tensor:
    """Reorder a full sequence so CONTIGUOUS sharding over ``size`` ranks
    yields the STRIPED (round-robin) assignment: shard r's local position
    t holds global token t * size + r (``stripe_sequence`` :184).  A
    reshape and a transpose."""
    T = x.shape[axis]
    if T % size:
        raise ValueError(f"sequence length {T} must divide by ring size {size}")
    x = torch.movedim(x, axis, -1)
    x = x.reshape(x.shape[:-1] + (T // size, size)).transpose(-2, -1)
    return torch.movedim(x.reshape(x.shape[:-2] + (T,)), -1, axis)


def unstripe_sequence(x: torch.Tensor, size: int,
                      axis: int = 2) -> torch.Tensor:
    """Inverse of :func:`stripe_sequence` (``unstripe_sequence`` :207)."""
    T = x.shape[axis]
    if T % size:
        raise ValueError(f"sequence length {T} must divide by ring size {size}")
    x = torch.movedim(x, axis, -1)
    x = x.reshape(x.shape[:-1] + (size, T // size)).transpose(-2, -1)
    return torch.movedim(x.reshape(x.shape[:-2] + (T,)), -1, axis)


def striped_attention(qs: Ranks, ks: Ranks, vs: Ranks, causal: bool = True,
                      block_k: Optional[int] = None) -> List[torch.Tensor]:
    """Ring attention over STRIPED shards (``striped_attention`` :219):
    global q position tq * P + me, k position tk * P + origin, so the
    causal mask of every (rank, origin) pair is triangular, ties broken by
    rank order (``me >= origin`` attends the diagonal).  Shapes as
    :func:`ring_attention`; returns striped shards."""
    full, tri, tri_strict = _masks(qs[0].shape[2], ks[0].shape[2],
                                   qs[0].device)

    def mask_for(me, origin):
        if not causal:
            return full
        return tri if me >= origin else tri_strict

    return _ring_scan(qs, ks, vs, mask_for, block_k)


# ---------------------------------------------------------------------------
# command-ring opt-in: attention hops as sequencer slots (FUSED_ATTN_HOP)
# ---------------------------------------------------------------------------


def fused_hop_partial(accl, kv_block, q_block, hop, scale=1.0, comm=None,
                      timeout_s=60.0):
    """One ring-attention hop issued as a command-ring slot
    (``fused_hop_partial`` :262, over the facade's ``fused_attn_hop``):
    this rank's K/V block relays around the ring while the slot computes
    ``scale * q * kv`` against the block from ``hop`` positions behind.
    ``kv_block`` and ``q_block`` are equal-width 1-D float blocks; returns
    the partial block, a host-side float32 copy."""
    kv = np.asarray(kv_block, np.float32).ravel()
    q = np.asarray(q_block, np.float32).ravel()
    if kv.size != q.size:
        raise ValueError(
            f"kv block ({kv.size}) and q block ({q.size}) must be "
            "equal width — FUSED_ATTN_HOP packs them as one operand row")
    send = accl.create_buffer_from(np.concatenate([kv, q]))
    out = accl.create_buffer(q.size, np.float32)
    with accl.batch():
        req = accl.fused_attn_hop(send, out, hop=hop, count=q.size,
                                  scale=scale, comm=comm, run_async=True)
    if not req.wait(timeout_s):
        raise TimeoutError("fused attention hop timed out")
    req.check()
    out.sync_from_device()
    return out.data[:out.count].copy()
