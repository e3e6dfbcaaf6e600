"""Shared plumbing of the hand-written CUDA kernel tier.

The counterpart of ``accl_tpu/ops/pallas/_common.py``.  What carries
over is the PADDING RULE: the ring kernels cut each rank's operand into
blocks whose boundaries come from the TPU tile packing (``pack_lanes``
with a ``sublanes_for`` row multiple), and the block a given element falls
in decides which ranks' fold order reduces it.  Keeping the same rule
keeps every float result bit-identical to the JAX package's.

The kernels never materialise that padding: they read elements past the
operand's end as zeros and never write them.

Every wrapper follows one rule: a CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence

import torch

from ...wire import astype

# TPU lane width: the last dim of every packed tile (kept for the
# padding rule; the CUDA kernels have no lane layout of their own)
LANES = 128

#: most ranks one kernel launch takes (the pointer table is a kernel
#: argument: 2 x 64 pointers = 1 KiB of the 4 KiB parameter space)
MAX_RANKS = 64


def sublanes_for(dtype: torch.dtype) -> int:
    """Minimum sublane multiple of a dtype's TPU tile: f32 8, bf16/f16
    16, int8/fp8 32."""
    return {4: 8, 2: 16, 1: 32}.get(dtype.itemsize, 8)


#: ``pack_lanes``' default row multiple (the JAX tier's SUBLANES)
SUBLANES = 32


def pack_lanes(x: torch.Tensor, min_rows: int = SUBLANES):
    """Flatten ``x`` and zero-pad it into a ``(rows, LANES)`` tile-aligned
    2-D tensor, rows a positive multiple of ``min_rows``; returns
    ``(packed, n)`` with ``n`` the original element count."""
    flat = x.reshape(-1)
    n = flat.numel()
    packed = torch.zeros(packed_len(n, min_rows), dtype=x.dtype,
                         device=x.device)
    packed[:n] = flat
    return packed.view(-1, LANES), n


def unpack_lanes(packed: torch.Tensor, n: int, shape,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    out = packed.reshape(-1)[:n].reshape(shape)
    return out if dtype is None else astype(out, dtype)


def block_rows(total_rows: int, want: int = 512) -> int:
    """A grid block height: the divisor of ``total_rows`` nearest below
    ``want`` that keeps tiles sublane-aligned (all of them when
    ``total_rows <= want``)."""
    if total_rows <= want:
        return total_rows
    for cand in range(want, SUBLANES - 1, -SUBLANES):
        if total_rows % cand == 0:
            return cand
    return total_rows


def packed_len(n: int, min_rows: int) -> int:
    """Element count of ``n`` elements packed into (rows, LANES) with rows
    a positive multiple of ``min_rows`` (``pack_lanes``'s shape)."""
    rows = -(-n // LANES)
    rows = max(-(-rows // min_rows), 1) * min_rows
    return rows * LANES


def ring_len(n: int, parts: int, num_segments: int, dtype: torch.dtype,
             wire_dtype=None) -> int:
    """Padded per-rank length of a ring operand (``_pack_ring``): whole
    tiles of both the operand's and the wire's sublane minimum, in
    ``parts * num_segments`` equal row groups."""
    sub = sublanes_for(dtype)
    if wire_dtype is not None:
        sub = max(sub, sublanes_for(wire_dtype))
    return packed_len(n, parts * num_segments * sub)


class LaunchCounter:
    """How many times a wrapper launched its kernel (locked: rank threads
    launch concurrently)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self) -> None:
        lock = self._lock  # acquire / release: cheaper than ``with``
        lock.acquire()
        self.count += 1
        lock.release()

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def on_cuda(tensors: Sequence[Optional[torch.Tensor]]) -> bool:
    """True when every tensor lies on one CUDA device, False when every one
    lies on the CPU; raises on a mix or any other device.  None entries
    (ranks that take no result) are skipped.  One pass, one ``device``
    read a tensor: the launch path's only device check (and no
    ``torch.device.type``, which costs a launch path more than the read)."""
    first = dev = None
    for t in tensors:
        if t is None:
            continue
        if first is None:
            first, dev = t, t.device
        elif t.device != dev:
            first = None
            break
    if first is not None:
        if first.is_cuda:
            return True
        if first.is_cpu:
            return False
    raise ValueError(
        f"kernel operands must all lie on the CPU or on one CUDA device, "
        f"got {sorted({str(t.device) for t in tensors if t is not None})}"
    )


def check_ranks(xs: Sequence[torch.Tensor], what: str) -> None:
    """Per-rank operands: 1..MAX_RANKS contiguous 1-D tensors of one
    length and dtype."""
    if not 1 <= len(xs) <= MAX_RANKS:
        raise ValueError(f"{what}: {len(xs)} ranks (1..{MAX_RANKS})")
    x0 = xs[0]
    for x in xs:
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous 1-D")
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(f"{what}: operands must match in shape and dtype")


def pointers(tensors: Sequence[Optional[torch.Tensor]]
             ) -> List[Optional[int]]:
    """The tensors' device pointers, one ``data_ptr()`` call a tensor (None
    stays None: a rank that takes no result)."""
    return [None if t is None else t.data_ptr() for t in tensors]


def aligned16(ptrs: Sequence[Optional[int]]) -> bool:
    """Whether every pointer of :func:`pointers` is 16-byte aligned."""
    return not any(p % 16 for p in ptrs if p is not None)


def pointer_table(ptrs: Sequence[Optional[int]]):
    """A C array of :func:`pointers`' values; a None entry is a null
    pointer (the kernel skips that rank's stores)."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors share any byte of memory."""
    if not a.numel() or not b.numel():
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def stream_of(device: torch.device) -> int:
    """The pointer of PyTorch's current stream on ``device`` (an int, which
    the prototypes' ``c_void_p`` takes as it is).  ``torch.accelerator``
    reads it without building a ``torch.cuda.Stream``, several times
    faster on the H100's host than ``torch.cuda.current_stream(device)``
    (``chip_smoke.py``'s ``launch_path`` times both)."""
    return torch.accelerator.current_stream(device.index).native_handle


def check_launch(lib, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (the C entry points return
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = lib.accl_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")
