"""Row 16: the single-device flash-attention forward.

The counterpart of ``accl_tpu/ops/pallas/attention.py::flash_attention``
(:656, forward ``_flash_fwd_impl`` :396, kernel ``_flash_kernel`` :293).
The kernel is ``csrc/attention.cu``; :func:`flash_attention_plain` is its
plain PyTorch version, the fold of the TPU kernel written with torch
operations, which CPU tensors take and the card's checks compare
against.

The backward kernels (rows 17-18) come with the training slice: until
then a call on CUDA tensors that would need a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...constants import torch_to_dtype
from . import _build
from ._common import LaunchCounter, check_launch, on_cuda, stream_of

#: widest head dim the kernel takes (its register tiles hold D <= 128)
MAX_HEAD_DIM = 128

_NEG = -1e30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _flash_block(T: int, dtype: torch.dtype, block: int) -> int:
    """The TPU kernel's block height (``_flash_block`` :358): a sublane
    multiple (f32 8, 16-bit 16) no taller than T rounded up to it.  The
    plain version folds keys in tiles of this height, as the TPU kernel
    does."""
    sub = {4: 8, 2: 16, 1: 32}.get(dtype.itemsize, 8)
    return min(max(block // sub * sub, sub), (T + sub - 1) // sub * sub)


def online_softmax_fold(q, k, v, causal: bool, block: int):
    """The online-softmax fold over key tiles of ``block`` keys: q
    (..., T, D), k/v broadcastable to q's leading dims.  Scores and the
    (m, l, acc) state in float32 (16-bit operands are widened exactly, so
    each product is the one an f32-accumulating matmul forms), masked
    scores -1e30, probabilities rounded to v's dtype before P @ V.
    Returns ``(out in q's dtype, lse float32 (..., T))``.

    Every query row folds every tile: the tiles a causal row would skip
    are wholly masked, and after the first tile (key 0 is always visible)
    they add exact zeros."""
    T, D = q.shape[-2], q.shape[-1]
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


def _lib():
    lib = _build.library("attention")
    lib.accl_flash_attention.restype = ctypes.c_int
    lib.accl_flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    return lib


def flash_attention(q, k, v, causal: bool = True, *, with_lse: bool = False):
    """Fused attention, ``(B, H, T, D) -> (B, H, T, D)``, with the (T, T)
    scores never leaving the chip: q (B, H, T, D), k and v (B, Hkv, T, D)
    with ``H % Hkv == 0`` (q head h reads kv head h // (H // Hkv)).
    ``with_lse=True`` returns ``(out, lse)`` with the float32 per-row
    logsumexp (B, H, T), the residual the backward kernels will read.

    CPU tensors take :func:`flash_attention_plain`.  CUDA tensors launch
    the kernel (float32, bfloat16 or float16, D <= ``MAX_HEAD_DIM``, the
    head dim contiguous; the output takes q's strides) or raise."""
    _check(q, k, v)
    if not on_cuda([q, k, v]):
        return flash_attention_plain(q, k, v, causal, with_lse=with_lse)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention on the card has no backward kernels yet (they "
            "come with the training slice): call it under torch.no_grad()")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash_attention takes f32/bf16/f16, got {q.dtype}")
    B, H, T, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}, the kernel's limit")
    if -(-T // 64) > 65535:
        raise ValueError(f"sequence length {T} exceeds the kernel's grid")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)  # q's strides when dense, else contiguous
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * H * T * D == 0:
        return (out, lse) if with_lse else out
    width = 16 // q.element_size()
    vec = D % width == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % width == 0 for s in t.stride()[:3])
        for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    lib = _lib()
    rc = lib.accl_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), strides,
        B, H, k.shape[1], T, D, int(torch_to_dtype(q.dtype)), int(causal),
        int(vec), 1.0 / D ** 0.5, stream_of(q.device),
    )
    check_launch(lib, rc, "flash_attention")
    flash_attention.launches.bump()
    return (out, lse) if with_lse else out


flash_attention.launches = LaunchCounter()
