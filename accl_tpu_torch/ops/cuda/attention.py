"""Rows 16-18: the single-device flash attention, forward and backward;
row 15: ring attention over P ranks.

The counterpart of ``accl_tpu/ops/pallas/attention.py::flash_attention``
(:656): the forward ``_flash_fwd_impl`` :396 (kernel ``_flash_kernel``
:293) and the custom_vjp backward ``_flash_bwd_impl`` :562 (kernels
``_flash_bwd_dq_kernel`` :451 and ``_flash_bwd_dkv_kernel`` :503, after
the delta pass :570-572).  The kernels are ``csrc/attention.cu`` and
``csrc/attention_bwd.cu``; :func:`flash_attention_plain`,
:func:`flash_attention_bwd_delta_plain`,
:func:`flash_attention_bwd_dq_plain` and
:func:`flash_attention_bwd_dkv_plain` are their plain PyTorch versions,
the folds of the TPU kernels written with torch operations, which CPU
tensors take and the card's checks compare against.

A call that needs a gradient runs through :class:`_Flash`, a
``torch.autograd.Function`` whose forward keeps the logsumexp and whose
backward launches the delta, dQ and dK/dV kernels, on either device.

Row 15, :func:`ring_attention` (the TPU entry ``ring_attention`` :216,
kernel ``_attention_kernel`` :111), is ``csrc/ring_attention.cu`` with
:func:`ring_attention_plain` beside it.  Its ranks are virtual: each
rank's shard is its own tensor on one device, and one launch folds every
rank's query tiles over every rank's K/V.

The 16-bit kernels of rows 15-18 share one core
(``csrc/flash_sm90.cuh``: wgmma tiles fed by TMA) and read each operand
through a 4-D tensor map, whose geometry :func:`_tma_geometry` works out
here; an operand TMA cannot address where it lies is copied first
(:func:`_tma_operand`, counted in :data:`tma_copies`).  float32 operands
take FFMA kernels (no TF32).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ...constants import torch_to_dtype
from . import _build
from ._build import FLOAT, INT, PTR
from ._common import (
    MAX_RANKS,
    LaunchCounter,
    aligned16,
    check_launch,
    on_cuda,
    pointer_table,
    pointers,
    stream_of,
)

#: the C prototypes of ``csrc/attention.cu``, ``csrc/attention_bwd.cu``
#: and ``csrc/ring_attention.cu`` (declared once, at load); each library
#: also exports ``flash_sm90.cuh``'s ``accl_wgmma_smem``
_SHAPE = (INT,) * 8 + (FLOAT, PTR)  # B, H, Hkv, T, D, dtype, causal, vec
PROTOTYPES = {
    "attention": {
        "accl_flash_attention": (PTR,) * 8 + _SHAPE,
        "accl_wgmma_smem": (INT,),
    },
    "attention_bwd": {
        "accl_flash_bwd_dq": (PTR,) * 10 + _SHAPE,
        "accl_flash_bwd_dkv": (PTR,) * 11 + _SHAPE,
        "accl_flash_bwd_delta": (PTR,) * 4 + (INT,) * 6 + (PTR,),
        "accl_flash_bwd_smem": (INT,),
        "accl_wgmma_smem": (INT,),
    },
    "ring_attention": {
        "accl_ring_attention": (PTR,) * 6 + (INT,) * 9 + (FLOAT, PTR),
        "accl_wgmma_smem": (INT,),
    },
}


def _lib(name: str = "attention"):
    return _build.library(name, PROTOTYPES[name])

#: widest head dim the kernel takes (its register tiles hold D <= 128)
MAX_HEAD_DIM = 128
#: the 16-bit kernels' tiles: 128 rows (query rows of a block, keys of a
#: K/V tile; the backward also streams tiles of 64), loaded by TMA in
#: boxes of 64 columns (one 128-byte swizzle row of 16-bit elements)
TILE_ROWS = 128
BOX_COLS = 64

_NEG = -1e30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _flash_block(T: int, dtype: torch.dtype, block: int) -> int:
    """The TPU kernel's block height (``_flash_block`` :358): a sublane
    multiple (f32 8, 16-bit 16) no taller than T rounded up to it.  The
    plain version folds keys in tiles of this height, as the TPU kernel
    does."""
    sub = {4: 8, 2: 16, 1: 32}.get(dtype.itemsize, 8)
    return min(max(block // sub * sub, sub), (T + sub - 1) // sub * sub)


def online_softmax_fold(q, k, v, causal: bool, block: int,
                        scale: float | None = None):
    """The online-softmax fold over key tiles of ``block`` keys: q
    (..., T, D), k/v broadcastable to q's leading dims, scores scaled by
    ``scale`` (default ``1/sqrt(D)``).  Scores and the
    (m, l, acc) state in float32 (16-bit operands are widened exactly, so
    each product is the one an f32-accumulating matmul forms), masked
    scores -1e30, probabilities rounded to v's dtype before P @ V.
    Returns ``(out in q's dtype, lse float32 (..., T))``.

    Every query row folds every tile: the tiles a causal row would skip
    are wholly masked, and after the first tile (key 0 is always visible)
    they add exact zeros."""
    T, D = q.shape[-2], q.shape[-1]
    if scale is None:
        scale = 1.0 / D ** 0.5
    qf = q.float()
    q_pos = torch.arange(T, device=q.device)[:, None]
    m = torch.full(q.shape[:-1] + (1,), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, T, block):
        kb = k[..., k0:k0 + block, :]
        vb = v[..., k0:k0 + block, :]
        s = torch.matmul(qf, kb.float().transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[-2], device=q.device)
            s = torch.where(q_pos >= k_pos[None, :], s, _NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    den = l.clamp_min(1e-30)
    return (acc / den).to(q.dtype), (m + torch.log(den)).squeeze(-1)


def flash_attention_plain(q, k, v, causal: bool = True, *,
                          with_lse: bool = False):
    """What the kernel computes, in plain PyTorch: the TPU kernel's fold
    (its ``_flash_block(T, dtype, 512)`` key tile, its -1e30 mask) with
    k/v indexed per kv-head group, never expanded."""
    _check(q, k, v)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, T, D)
    out, lse = online_softmax_fold(qg, k[:, :, None], v[:, :, None], causal,
                                   _flash_block(T, q.dtype, 512))
    out, lse = out.reshape(B, H, T, D), lse.reshape(B, H, T)
    return (out, lse) if with_lse else out


def _check(q, k, v) -> None:
    """The TPU entry's checks (``flash_attention`` :689-704)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    if k.shape != v.shape:
        raise ValueError(
            f"k/v shapes must match, got {tuple(k.shape)}/{tuple(v.shape)}")
    B, H, T, D = q.shape
    Bk, Hkv, Tk, Dk = k.shape
    if (Bk, Tk, Dk) != (B, T, D) or Hkv <= 0 or H % Hkv:
        raise ValueError(
            f"q/k shapes must match outside the head dim and q heads must "
            f"be a multiple of kv heads, got {tuple(q.shape)}/"
            f"{tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q/k/v dtypes must match (tiles and accumulators are typed "
            f"from q), got {q.dtype}/{k.dtype}/{v.dtype}")


def _check_bwd(q, do, lse, delta) -> None:
    """The backward's residuals: dO like q, lse and delta (B, H, T)
    float32."""
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(
            f"dO must match q, got {do.dtype}{tuple(do.shape)} for "
            f"{q.dtype}{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 {tuple(q.shape[:3])}, got "
                f"{t.dtype}{tuple(t.shape)}")


def _grouped(B, H, Hkv, T, D):
    """Shapes of the per-group views: (B, Hkv, G, T, D) for q-shaped
    tensors, (B, Hkv, G, T, 1) for per-row statistics."""
    G = H // Hkv
    return (B, Hkv, G, T, D), (B, Hkv, G, T, 1)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                 causal: bool = True):
    """What the dQ kernel computes, in plain PyTorch: the TPU kernel's
    fold over key tiles of ``_flash_block(T, dtype, 512)`` keys, with p =
    ``where(mask, exp(s - lse), 0)`` (mask: keys and queries below T, and
    query >= key when causal), dp = dO V^T and ds = p (dp - delta) scale
    in float32, ds rounded to k's dtype before ds K.  Every query row
    folds every tile (the tiles a causal row would skip add exact
    zeros)."""
    _check(q, k, v)
    _check_bwd(q, do, lse, delta)
    B, H, T, D = q.shape
    rows, stats = _grouped(B, H, k.shape[1], T, D)
    scale = 1.0 / D ** 0.5
    qf, dof = q.reshape(rows).float(), do.reshape(rows).float()
    lse, delta = lse.reshape(stats), delta.reshape(stats)
    q_pos = torch.arange(T, device=q.device)[:, None]
    acc = torch.zeros(rows, dtype=torch.float32, device=q.device)
    block = _flash_block(T, q.dtype, 512)
    for k0 in range(0, T, block):
        kb = k[:, :, None, k0:k0 + block].float()
        vb = v[:, :, None, k0:k0 + block].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[-2], device=q.device)
        p = torch.exp(s - lse)
        if causal:
            p = torch.where(q_pos >= k_pos[None, :], p, 0.0)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta) * scale
        acc = acc + torch.matmul(ds.to(k.dtype).float(), kb)
    return acc.to(q.dtype).reshape(B, H, T, D)


def _group_sum(x, Hkv: int, dtype):
    """Per-q-head dK or dV (B, H, T, D) summed over each group of H / Hkv
    heads in float32, then cast (``_flash_bwd_impl`` :627-631)."""
    B, H, T, D = x.shape
    if H == Hkv:
        return x
    return x.reshape(B, Hkv, H // Hkv, T, D).float().sum(2).to(dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                  causal: bool = True):
    """What the dK/dV kernel computes, in plain PyTorch: the TPU kernel's
    fold over query tiles of ``_flash_block(T, dtype, 512)`` rows, with p
    and ds as in :func:`flash_attention_bwd_dq_plain`, p rounded to dO's
    dtype before p^T dO and ds to q's dtype before ds^T Q; dK and dV per
    q head in q's dtype, then summed over each kv group (:func:`_group_sum`).
    Returns ``(dk, dv)`` shaped like k."""
    _check(q, k, v)
    _check_bwd(q, do, lse, delta)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    rows, stats = _grouped(B, H, Hkv, T, D)
    scale = 1.0 / D ** 0.5
    qg, dog = q.reshape(rows), do.reshape(rows)
    lse, delta = lse.reshape(stats), delta.reshape(stats)
    kf, vf = k[:, :, None].float(), v[:, :, None].float()
    k_pos = torch.arange(T, device=q.device)[None, :]
    dk = torch.zeros(rows, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    block = _flash_block(T, q.dtype, 512)
    for q0 in range(0, T, block):
        qb = qg[..., q0:q0 + block, :]
        dob = dog[..., q0:q0 + block, :]
        s = torch.matmul(qb.float(), kf.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., q0:q0 + block, :])
        if causal:
            q_pos = torch.arange(q0, q0 + qb.shape[-2], device=q.device)
            p = torch.where(q_pos[:, None] >= k_pos, p, 0.0)
        dv = dv + torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                               dob.float())
        dp = torch.matmul(dob.float(), vf.transpose(-1, -2))
        ds = p * (dp - delta[..., q0:q0 + block, :]) * scale
        dk = dk + torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                               qb.float())
    dk, dv = (t.to(q.dtype).reshape(B, H, T, D) for t in (dk, dv))
    return _group_sum(dk, Hkv, k.dtype), _group_sum(dv, Hkv, v.dtype)


def _fwd_rows(dtype: torch.dtype) -> int:
    """Rows of one block of the kernels: 128 for the 16-bit wgmma kernels
    (rows 15 and 16's query rows, row 17's work items of query rows and
    row 18's of keys), 64 for the float32 FFMA kernels."""
    return 64 if dtype == torch.float32 else TILE_ROWS


def _grid_fits(T: int, rows: int, ranks: int = 1) -> bool:
    """Whether ``ranks`` x ceil(T / rows) query blocks fit the kernels'
    grid (its y dimension, at most 65535)."""
    return ranks * -(-T // rows) <= 65535


def _kernel_operands(what: str, q, *others, rows: int = 64):
    """The kernels' contract: float32, bfloat16 or float16, D <=
    ``MAX_HEAD_DIM``, at most 65535 blocks of ``rows`` rows, each
    operand's head dim contiguous (else it is copied).  Returns the
    operands and whether every one allows 16-byte loads."""
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} takes f32/bf16/f16, got {q.dtype}")
    T, D = q.shape[2], q.shape[3]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}, the kernel's limit")
    if not _grid_fits(T, rows):
        raise ValueError(f"sequence length {T} exceeds the kernel's grid")
    ts = tuple(t if t.stride(-1) == 1 else t.contiguous()
               for t in (q, *others))
    width = 16 // q.element_size()
    vec = D % width == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % width == 0 for s in t.stride()[:3])
        for t in ts)
    return ts, vec


def _tma_geometry(t, box_rows: int, box_cols: int):
    """The 4-D tensor map of a (B, H, T, D) operand, as the C side encodes
    it: ``(dims, strides, box)`` with dims ``(D, T, H, B)`` innermost
    first, the byte strides of T, H and B, and the box ``(box_cols,
    box_rows, 1, 1)``.  T stays a real boundary (TMA zero-fills the rows
    of a tile at or past it, and the columns at or past D), and the
    operand's own strides are kept (a transposed view needs no copy).  A
    dimension of extent 1 is never stepped over, so its stride is given
    as the whole extent inside it, rounded up to 16 bytes."""
    B, H, T, D = t.shape
    es = t.element_size()
    strides, inner = [], D * es
    for size, stride in ((T, t.stride(2)), (H, t.stride(1)),
                         (B, t.stride(0))):
        s = stride * es if size > 1 else -(-inner // 16) * 16
        strides.append(s)
        inner = s * size
    return (D, T, H, B), tuple(strides), (box_cols, box_rows, 1, 1)


def _tma_ready(t) -> bool:
    """Whether TMA can address the operand where it lies: a 16-byte
    aligned base, the head dim contiguous, every stride a positive
    multiple of 16 bytes (an expanded gradient's stride 0 is copied)."""
    _, strides, _ = _tma_geometry(t, TILE_ROWS, BOX_COLS)
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(s > 0 and s % 16 == 0 for s in strides))


def _tma_operand(t):
    """The operand, or, where TMA cannot address it (:func:`_tma_ready`),
    a contiguous copy with the head dim padded with zeros to a multiple of
    8 (16 bytes), counted in :data:`tma_copies`.  The zero columns add
    nothing to a score or an output column below D, and the scale stays
    that of the logical head dim."""
    if _tma_ready(t):
        return t
    B, H, T, D = t.shape
    out = t.new_zeros((B, H, T, -(-D // 8) * 8))
    out[..., :D] = t
    tma_copies.bump()
    return out


def _tma_table(ts):
    """The geometries of the operands, 9 values each, as a C array."""
    vals = []
    for t in ts:
        dims, strides, box = _tma_geometry(t, TILE_ROWS, BOX_COLS)
        vals += [*dims, *strides, *box[:2]]
    return (ctypes.c_longlong * len(vals))(*vals)


#: the C arrays of the 16-bit kernels' host arguments by the operands'
#: layout (see :func:`_tma_args`): a serving or training loop calls with
#: the same few layouts over and over, and the host path is what a short
#: sequence waits for
_TMA_ARGS: dict = {}


def _tma_args(ts, out, key):
    """The operands as the 16-bit kernels read them (each through
    :func:`_tma_operand`) and ``(table, strides)``: the C array of their
    geometries and, when ``out`` is given, of the (b, h, t) strides of
    the first three and ``out`` (:func:`_strides`).  When every operand
    is read where it lies, the arrays are kept under ``key``, the
    caller's statement of the layout (dtype, shapes, strides), for the
    next call with a 16-byte-aligned base."""
    copied = [_tma_operand(t) for t in ts]
    arrays = (_tma_table(copied),
              None if out is None else _strides(*copied[:3], out))
    if all(a is b for a, b in zip(copied, ts)):
        if len(_TMA_ARGS) >= 256:
            _TMA_ARGS.clear()
        _TMA_ARGS[key] = arrays
    return copied, arrays


#: the 16-bit kernels' work counters by (device, stream): two int32 that
#: every launch's blocks draw their work items from and leave at zero, so
#: launches in turn on one stream share them and other streams get theirs
_COUNTERS: dict = {}


def _work_counters(device, stream) -> int:
    """The device pointer of ``stream``'s work counters on ``device``."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(2, dtype=torch.int32,
                                           device=device)
    return buf.data_ptr()


def _strides(*ts):
    """The (b, h, t) element strides of each tensor, as a C array."""
    return (ctypes.c_longlong * (3 * len(ts)))(
        *[s for t in ts for s in t.stride()[:3]])


def _forward(q, k, v, causal: bool, with_lse: bool):
    """The forward on either device: the plain version for CPU tensors,
    the kernel for CUDA ones (float32: the FFMA kernel; 16-bit: the wgmma
    kernel, its operands read through TMA)."""
    if not on_cuda([q, k, v]):
        return flash_attention_plain(q, k, v, causal, with_lse=with_lse)
    (q, k, v), vec = _kernel_operands("flash_attention", q, k, v,
                                      rows=_fwd_rows(q.dtype))
    B, H, T, D = q.shape
    out = torch.empty_like(q)  # q's strides when dense, else contiguous
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * H * T * D == 0:
        return (out, lse) if with_lse else out
    stream = stream_of(q.device)
    ptrs = pointers((q, k, v))
    if q.dtype == torch.float32:
        tma, strides, sched = None, _strides(q, k, v, out), None
    else:
        sched = _work_counters(q.device, stream)
        key = (q.dtype, q.shape, q.stride(), k.shape, k.stride(), v.stride(),
               out.stride())
        hit = _TMA_ARGS.get(key)
        if hit is None or not aligned16(ptrs):
            (q, k, v), hit = _tma_args((q, k, v), out, key)
            ptrs = pointers((q, k, v))
        tma, strides = hit
    lib = _lib()
    rc = lib.accl_flash_attention(
        *ptrs, out.data_ptr(), None if lse is None else lse.data_ptr(),
        strides, tma, sched,
        B, H, k.shape[1], T, D, int(torch_to_dtype(q.dtype)), int(causal),
        int(vec), 1.0 / D ** 0.5, stream,
    )
    check_launch(lib, rc, "flash_attention")
    flash_attention.launches.bump()
    if tma is not None:
        flash_attention.wgmma_launches.bump()
    if not causal:
        flash_attention.full_launches.bump()
    return (out, lse) if with_lse else out


def _bwd_tma(q, k, v, do):
    """The backward kernels' operands as they read them and the C array
    of their geometries: float32 operands as given, with None; 16-bit
    ones each read through TMA, copied first where it cannot read them
    (:func:`_tma_args`).  The kernels load each map's tiles in boxes of
    64 columns by 128 rows (a work item's operands: dQ's q and do, dK/dV's
    k and v) or 64 rows (the streamed ones)."""
    if q.dtype == torch.float32:
        return (q, k, v, do), None
    key = ("bwd", q.dtype, q.shape, q.stride(), k.shape, k.stride(),
           v.stride(), do.stride())
    hit = _TMA_ARGS.get(key)
    if hit is None or (q.data_ptr() | k.data_ptr() | v.data_ptr()
                       | do.data_ptr()) % 16:
        (q, k, v, do), hit = _tma_args((q, k, v, do), None, key)
    return (q, k, v, do), hit[0]


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dQ (B, H, T, D) of attention from the forward's operands, the
    output gradient ``do`` (like q), its float32 logsumexp ``lse`` and
    ``delta = rowsum(dO * O)`` (both (B, H, T)).

    CPU tensors take :func:`flash_attention_bwd_dq_plain`.  CUDA tensors
    launch the kernel (the forward's dtypes and head dims: float32 the
    FFMA kernel, 16-bit the wgmma kernel, its operands read through TMA;
    dQ takes q's strides) or raise."""
    _check(q, k, v)
    _check_bwd(q, do, lse, delta)
    if not on_cuda([q, k, v, do, lse, delta]):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    (q, k, v, do), vec = _kernel_operands("flash_attention_bwd_dq",
                                          q, k, v, do,
                                          rows=_fwd_rows(q.dtype))
    B, H, T, D = q.shape
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    (q, k, v, do), tma = _bwd_tma(q, k, v, do)
    stream = stream_of(q.device)
    sched = None if tma is None else _work_counters(q.device, stream)
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = _lib("attention_bwd")
    rc = lib.accl_flash_bwd_dq(
        *pointers((q, k, v, do)), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(),
        _strides(q, k, v, do, dq), tma, sched, B, H, k.shape[1], T, D,
        int(torch_to_dtype(q.dtype)), int(causal), int(vec), 1.0 / D ** 0.5,
        stream,
    )
    check_launch(lib, rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches.bump()
    if tma is not None:
        flash_attention_bwd_dq.wgmma_launches.bump()
    if not causal:
        flash_attention_bwd_dq.full_launches.bump()
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """``(dk, dv)``, each shaped like k, from the same inputs as
    :func:`flash_attention_bwd_dq`.  The kernel writes them per q head;
    under grouped-query attention each group of H / Hkv heads is then
    summed in float32 (PyTorch, as the TPU form sums it in XLA).

    CPU tensors take :func:`flash_attention_bwd_dkv_plain`.  CUDA tensors
    launch the kernel or raise."""
    _check(q, k, v)
    _check_bwd(q, do, lse, delta)
    if not on_cuda([q, k, v, do, lse, delta]):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    (q, k, v, do), vec = _kernel_operands("flash_attention_bwd_dkv",
                                          q, k, v, do,
                                          rows=_fwd_rows(q.dtype))
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    if H == Hkv:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    else:
        dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(2))
    if dk.numel() == 0:
        return _group_sum(dk, Hkv, k.dtype), _group_sum(dv, Hkv, v.dtype)
    (q, k, v, do), tma = _bwd_tma(q, k, v, do)
    stream = stream_of(q.device)
    sched = None if tma is None else _work_counters(q.device, stream)
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = _lib("attention_bwd")
    rc = lib.accl_flash_bwd_dkv(
        *pointers((q, k, v, do)), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), tma, sched, B, H, Hkv, T, D,
        int(torch_to_dtype(q.dtype)), int(causal), int(vec), 1.0 / D ** 0.5,
        stream,
    )
    check_launch(lib, rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches.bump()
    if tma is not None:
        flash_attention_bwd_dkv.wgmma_launches.bump()
    if not causal:
        flash_attention_bwd_dkv.full_launches.bump()
    return _group_sum(dk, Hkv, k.dtype), _group_sum(dv, Hkv, v.dtype)


def flash_attention_bwd_delta_plain(do, out):
    """What the delta kernel computes, in plain PyTorch: ``rowsum(dO *
    O)`` (B, H, T) in float32, both widened first, as JAX forms it
    (``_flash_bwd_impl`` :570-572)."""
    return (do.float() * out.float()).sum(-1)


def flash_attention_bwd_delta(do, out):
    """``delta = rowsum(dO * O)``, (B, H, T) float32, from the output
    gradient and the forward's output, (B, H, T, D) of one dtype: one
    read of each.

    CPU tensors take :func:`flash_attention_bwd_delta_plain`.  CUDA
    tensors launch the kernel (float32, bfloat16 or float16, the head dim
    contiguous, else copied) or raise."""
    if do.dim() != 4 or do.shape != out.shape or do.dtype != out.dtype:
        raise ValueError(
            f"dO and O must match, (B, H, T, D), got {do.dtype}"
            f"{tuple(do.shape)} and {out.dtype}{tuple(out.shape)}")
    if not on_cuda([do, out]):
        return flash_attention_bwd_delta_plain(do, out)
    if do.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"flash_attention_bwd_delta takes f32/bf16/f16, got {do.dtype}")
    do, out = (t if t.stride(-1) == 1 else t.contiguous() for t in (do, out))
    B, H, T, D = do.shape
    delta = torch.empty((B, H, T), dtype=torch.float32, device=do.device)
    if delta.numel() == 0 or D == 0:
        return delta.zero_()
    vec = D % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0
        and all(s % 4 == 0 for s in t.stride()[:3]) for t in (do, out))
    lib = _lib("attention_bwd")
    rc = lib.accl_flash_bwd_delta(
        do.data_ptr(), out.data_ptr(), delta.data_ptr(), _strides(do, out),
        B, H, T, D, int(torch_to_dtype(do.dtype)), int(vec),
        stream_of(do.device),
    )
    check_launch(lib, rc, "flash_attention_bwd_delta")
    flash_attention_bwd_delta.launches.bump()
    return delta


class _Flash(torch.autograd.Function):
    """The TPU entry's custom_vjp (:635-653): the forward saves q, k, v,
    the output and its logsumexp; the backward forms delta = rowsum(dO *
    O) (:570-572, XLA's fused pass there, the delta kernel here), then
    runs the dQ and dK/dV wrappers."""

    @staticmethod
    def forward(ctx, q, k, v, causal, with_lse):
        out, lse = _forward(q, k, v, causal, True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        if with_lse:
            ctx.mark_non_differentiable(lse)
            return out, lse
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do, *_):
        q, k, v, out, lse = ctx.saved_tensors
        delta = flash_attention_bwd_delta(do, out)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, *, with_lse: bool = False):
    """Fused attention, ``(B, H, T, D) -> (B, H, T, D)``, with the (T, T)
    scores never leaving the chip: q (B, H, T, D), k and v (B, Hkv, T, D)
    with ``H % Hkv == 0`` (q head h reads kv head h // (H // Hkv)).
    ``with_lse=True`` returns ``(out, lse)`` with the float32 per-row
    logsumexp (B, H, T), which takes no gradient.

    Differentiable: when q, k or v needs a gradient the call runs through
    :class:`_Flash`, whose backward launches the dQ and dK/dV kernels.
    CPU tensors take the plain versions.  CUDA tensors launch the kernels
    (float32, bfloat16 or float16, D <= ``MAX_HEAD_DIM``, the head dim
    contiguous, else copied; the output takes q's strides) or raise; a
    16-bit operand TMA cannot read where it lies is copied first."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, with_lse)
    return _forward(q, k, v, causal, with_lse)


flash_attention.launches = LaunchCounter()
#: of those, the 16-bit launches: the wgmma kernel
flash_attention.wgmma_launches = LaunchCounter()
#: operands the 16-bit kernels (rows 15-18) could not read through TMA
#: where they lay, and so copied first (:func:`_tma_operand`)
tma_copies = LaunchCounter()
flash_attention_bwd_dq.launches = LaunchCounter()
flash_attention_bwd_dkv.launches = LaunchCounter()
#: of those, the 16-bit launches: the wgmma kernels
flash_attention_bwd_dq.wgmma_launches = LaunchCounter()
flash_attention_bwd_dkv.wgmma_launches = LaunchCounter()
#: of rows 16-18's launches, the non-causal ones (full attention: the
#: encoder's)
for _f in (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _f.full_launches = LaunchCounter()
del _f
flash_attention_bwd_delta.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# row 15: ring attention over P ranks (accl_tpu/ops/pallas/attention.py
# ``ring_attention`` :216, kernel ``_attention_kernel`` :111)
# ---------------------------------------------------------------------------


def _ring_check(qs, ks, vs) -> int:
    """The TPU entry's checks (:242-256) on every rank, and the ranks'
    agreement; returns P."""
    P = len(qs)
    if not 1 <= P <= MAX_RANKS or len(ks) != P or len(vs) != P:
        raise ValueError(
            f"ring_attention takes 1..{MAX_RANKS} ranks of q, k and v, got "
            f"{len(qs)}/{len(ks)}/{len(vs)}")
    q0 = qs[0]
    if q0.dim() != 4:
        raise ValueError(f"q must be (B, H, T_local, D), got {tuple(q0.shape)}")
    for q, k, v in zip(qs, ks, vs):
        if k.shape != q.shape or v.shape != q.shape:
            raise ValueError(
                f"q/k/v shapes must match, got {tuple(q.shape)}/"
                f"{tuple(k.shape)}/{tuple(v.shape)}")
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(
                f"q/k/v dtypes must match (every rank's tiles are typed from "
                f"q), got {q.dtype}/{k.dtype}/{v.dtype}")
        if q.shape != q0.shape or q.dtype != q0.dtype:
            raise ValueError("every rank's q/k/v must match rank 0's shape "
                             "and dtype")
    if q0.shape[2] % 8:
        raise ValueError("T_local must be a multiple of 8")
    return P


def _ring_mask(T: int, me: int, origin: int, causal: bool, striped: bool,
               device) -> torch.Tensor:
    """The TPU kernel's ``mask_for(origin)`` on rank ``me`` (:128-141), a
    (T, T) bool mask, True = attend: all keys when not causal; striped,
    triangular when me >= origin and strictly triangular otherwise;
    contiguous, triangular when origin == me, all keys when origin < me,
    none when origin > me."""
    ones = torch.ones(T, T, dtype=torch.bool, device=device)
    if not causal:
        return ones
    if striped:
        return torch.tril(ones, diagonal=0 if me >= origin else -1)
    return torch.tril(ones) if origin == me else ones if origin < me \
        else torch.zeros_like(ones)


def ring_attention_plain(qs, ks, vs, causal: bool = True, *,
                         striped: bool = False):
    """What the kernel computes, in plain PyTorch: the TPU kernel's fold
    (``_fold`` :77) hop by hop on every rank — own block first, then the
    block of origin (me - s) mod P for s = 1..P-1; scores in float32 (16-bit
    operands widened exactly), masked to -1e30; (o, m, l) float32 from m =
    -1e30; p rounded to v's dtype before P @ V while l sums the unrounded
    p; out = o / max(l, 1e-30) in q's dtype.  Returns one (B, H, T_local, D)
    tensor per rank."""
    P = _ring_check(qs, ks, vs)
    B, H, T, D = qs[0].shape
    scale = 1.0 / D ** 0.5
    outs = []
    for me in range(P):
        q = qs[me].float()
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m = torch.full((B, H, T, 1), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for s in range(P):
            origin = (me - s) % P
            k, v = ks[origin], vs[origin]
            mask = _ring_mask(T, me, origin, causal, striped, q.device)
            scores = torch.matmul(q, k.float().transpose(-1, -2)) * scale
            scores = torch.where(mask, scores, _NEG)
            m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
            p = torch.exp(scores - m_new)
            alpha = torch.exp(m - m_new)
            o = o * alpha + torch.matmul(p.to(v.dtype).float(), v.float())
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_new
        outs.append((o / l.clamp_min(1e-30)).to(qs[me].dtype))
    return outs


def ring_attention(qs, ks, vs, causal: bool = True, *, striped: bool = False):
    """Sequence-parallel attention over P ranks in one launch (row 15):
    ``qs``, ``ks`` and ``vs`` hold each rank's ``(B, H, T_local, D)``
    shard of one sequence (contiguous shards in rank order, or the striped
    shards of ``models.stripe_sequence`` with ``striped=True``), every
    rank the same shape and dtype; T_local a multiple of 8.  Returns one
    ``(B, H, T_local, D)`` tensor per rank: its query rows attended over
    every rank's keys.  Forward only, as the TPU kernel.

    CPU tensors take :func:`ring_attention_plain`.  CUDA tensors launch
    the kernel (float32, bfloat16 or float16, D <= ``MAX_HEAD_DIM``; a
    larger D raises) or raise."""
    P = _ring_check(qs, ks, vs)
    if not on_cuda(list(qs) + list(ks) + list(vs)):
        return ring_attention_plain(qs, ks, vs, causal, striped=striped)
    q0 = qs[0]
    if q0.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"ring_attention takes f32/bf16/f16, got {q0.dtype}")
    B, H, T, D = q0.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {D} > {MAX_HEAD_DIM}, the ring_attention kernel's "
            f"limit (MAX_HEAD_DIM)")
    if not _grid_fits(T, _fwd_rows(q0.dtype), P) or B * H >= 2**31:
        raise ValueError(f"shape {tuple(q0.shape)} over {P} ranks exceeds "
                         f"the kernel's grid")
    qs, ks, vs = ([t.contiguous() for t in ts] for ts in (qs, ks, vs))
    outs = [torch.empty((B, H, T, D), dtype=q0.dtype, device=q0.device)
            for _ in qs]
    if B * H * T * D == 0:
        return outs
    width = 16 // q0.element_size()
    pin, pout = pointers(qs + ks + vs), pointers(outs)
    vec = D % width == 0 and aligned16(pin + pout)
    stream = stream_of(q0.device)
    tma = sched = None
    if q0.dtype != torch.float32:  # the wgmma kernel reads through TMA
        sched = _work_counters(q0.device, stream)
        key = (q0.dtype, q0.shape, P)  # every operand contiguous, one shape
        hit = _TMA_ARGS.get(key)
        if hit is None or not aligned16(pin):
            ts, hit = _tma_args(qs + ks + vs, None, key)
            pin = pointers(ts)
        tma = hit[0]
    lib = _lib("ring_attention")
    rc = lib.accl_ring_attention(
        pointer_table(pin[:P]), pointer_table(pin[P:2 * P]),
        pointer_table(pin[2 * P:]), pointer_table(pout), tma, sched, P, B,
        H, T, D,
        int(torch_to_dtype(q0.dtype)), int(causal), int(striped), int(vec),
        1.0 / D ** 0.5, stream,
    )
    check_launch(lib, rc, "ring_attention")
    ring_attention.launches.bump()
    if tma is not None:
        ring_attention.wgmma_launches.bump()
    return outs


ring_attention.launches = LaunchCounter()
#: of those, the 16-bit launches: the wgmma kernel
ring_attention.wgmma_launches = LaunchCounter()
