"""Rows 5-8: the wire compression kernels — the ``hp_compression`` plugin.

The counterpart of ``accl_tpu/ops/pallas/compression.py``.  Four kernels
(``csrc/compression.cu``), each over R rows at once (the ranks of one gang
call) with a seed per row:

* ``cast_rows`` (row 5): the dtype cast between float32, bfloat16,
  float16 and fp8 e4m3 / e5m2, as JAX's ``astype`` computes it;
* ``stochastic_cast_rows`` (row 6): mask-add-truncate rounding of the
  float32 mantissa bits the target drops, with the wire codec's counter
  bits (``sr_bits``); row 6 proper is float32 -> bfloat16, the wire's
  stochastic cast lanes are its other parametrisations;
* ``quantize_rows`` (row 7): blockwise int8, one absmax / 127 scale per
  segment, round half to even or stochastic ``floor(q + u)``;
* ``dequantize_rows`` (row 8): int8 times its segment's scale.

Each ``*_plain`` function is the kernel's plain PyTorch version (the CPU
path, and what the card's checks compare the kernel with, bit for bit).
Every wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises.  ``cast``, ``quantize_int8`` and
``dequantize_int8`` are the Pallas tier's entry points, with its
signatures and ``(rows, 128)`` / ``(nblk, 1)`` layouts.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ...constants import torch_to_dtype
from ...wire import astype, widen
from . import _build
from ._build import FLOAT, INT, LL, PTR
from ._common import (
    LANES,
    MAX_RANKS,
    SUBLANES,
    LaunchCounter,
    block_rows,
    check_launch,
    on_cuda,
    packed_len,
    pointer_table,
    pointers,
    stream_of,
    unpack_lanes,
)

_F8 = (torch.float8_e4m3fn, torch.float8_e5m2)
CAST_DTYPES = (torch.float32, torch.bfloat16, torch.float16) + _F8
SR_SOURCES = (torch.float32, torch.bfloat16)
SR_TARGETS = (torch.bfloat16, torch.float16) + _F8
QUANT_SOURCES = (torch.float32, torch.bfloat16, torch.float16)
DEQUANT_TARGETS = (torch.float32, torch.bfloat16, torch.float16)

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in [0, 2^32), in two 16-bit
    halves of ``c`` so no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sr_bits(n: int, seed, device=None) -> torch.Tensor:
    """``n`` uniform uint32 draws (as int64 values) from the Murmur3
    finalizer of ``(index, seed)`` — the torch form of
    :func:`accl_tpu_torch.wire.sr_bits`.  ``seed`` is an int, or an
    int64 tensor that broadcasts against the index (a ``(R, 1)`` column
    gives one stream per row)."""
    h = _mul32(torch.arange(n, dtype=torch.int64, device=device),
               2654435761)
    if isinstance(seed, torch.Tensor):
        h = h ^ (seed.to(torch.int64) & _M32)
    else:
        h = h ^ (int(seed) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


#: ``csrc/compression.cu``'s C prototypes (declared once, at load)
PROTOTYPES = {"compression": {
    "accl_cast": (PTR, PTR, INT, LL, INT, INT, INT, PTR),
    "accl_stochastic_cast": (PTR, PTR, PTR, INT, LL, INT, INT, INT, FLOAT,
                             INT, PTR),
    "accl_quantize_int8": (PTR, PTR, INT, LL, LL, LL, LL, PTR, PTR, INT,
                           INT, INT, INT, PTR),
    "accl_dequantize_int8": (PTR, LL, PTR, LL, PTR, INT, LL, LL, INT, PTR),
}}


def _lib():
    return _build.library("compression", PROTOTYPES["compression"])


def _rows(xs: Sequence[torch.Tensor], what: str) -> List[torch.Tensor]:
    """1..MAX_RANKS rows of one length and dtype, each flattened."""
    rows = [x.reshape(-1) for x in xs]
    if not 1 <= len(rows) <= MAX_RANKS:
        raise ValueError(f"{what}: {len(rows)} rows (1..{MAX_RANKS})")
    r0 = rows[0]
    if any(r.shape != r0.shape or r.dtype != r0.dtype for r in rows):
        raise ValueError(f"{what}: rows must match in length and dtype")
    return rows


def _seed_list(seeds, R: int) -> List[int]:
    if isinstance(seeds, int):
        seeds = [seeds] * R
    seeds = [int(s) & _M32 for s in seeds]
    if len(seeds) != R:
        raise ValueError(f"{len(seeds)} seeds for {R} rows")
    return seeds


def _seed_array(seeds: List[int]):
    return (ctypes.c_uint32 * len(seeds))(*seeds)


def _check_dtype(dtype, allowed, what: str) -> None:
    if dtype not in allowed:
        raise ValueError(f"{what} takes {allowed}, got {dtype}")


def _row_outputs(rows, out, dtype, what):
    if out is None:
        return [torch.empty_like(r, dtype=dtype) for r in rows]
    out = [o.reshape(-1) for o in out]
    if len(out) != len(rows) or any(
            o.numel() != rows[0].numel() or o.dtype != dtype
            or not o.is_contiguous() for o in out):
        raise ValueError(f"{what}: out must be {len(rows)} contiguous "
                         f"tensors of {rows[0].numel()} {dtype}")
    return out


# ---------------------------------------------------------------------------
# row 5: cast
# ---------------------------------------------------------------------------


def cast_plain(x: torch.Tensor, dtype: torch.dtype,
               e5m2_nan_unsigned: bool = False) -> torch.Tensor:
    """``x.astype(dtype)`` as JAX computes it (see ``wire.astype``).
    ``e5m2_nan_unsigned``: a NaN of a float8_e5m2 operand loses its sign,
    as the Pallas kernel's interpreted cast loses it (JAX's ``astype``
    and the numpy codec keep it)."""
    if e5m2_nan_unsigned and x.dtype == torch.float8_e5m2:
        b = x.view(torch.uint8)
        x = torch.where(torch.isnan(x.float()), b & 0x7F, b).view(x.dtype)
    return astype(x, dtype)


def cast_rows(xs: Sequence[torch.Tensor], dtype: torch.dtype,
              out: Optional[Sequence[torch.Tensor]] = None,
              e5m2_nan_unsigned: bool = False) -> List[torch.Tensor]:
    """Each row cast to ``dtype`` (row 5), one launch for all rows."""
    rows = _rows(xs, "cast")
    outs = _row_outputs(rows, out, dtype, "cast")
    if not on_cuda(rows + outs):
        for o, r in zip(outs, rows):
            o.copy_(cast_plain(r, dtype, e5m2_nan_unsigned))
        return outs
    _check_dtype(rows[0].dtype, CAST_DTYPES, "cast")
    _check_dtype(dtype, CAST_DTYPES, "cast")
    n = rows[0].numel()
    if n:
        lib = _lib()
        rc = lib.accl_cast(
            pointer_table(pointers(rows)), pointer_table(pointers(outs)),
            len(rows), n,
            int(torch_to_dtype(rows[0].dtype)), int(torch_to_dtype(dtype)),
            int(e5m2_nan_unsigned), stream_of(rows[0].device),
        )
        check_launch(lib, rc, "cast")
        cast_rows.launches.bump()
    return outs


cast_rows.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# row 6: stochastic cast
# ---------------------------------------------------------------------------


def stochastic_cast_plain(x: torch.Tensor, dtype: torch.dtype, seed: int,
                          drop: int, tiny: float, always: bool = False,
                          bits: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mask-add-truncate: where ``x`` is finite, ``|x| >= tiny`` and
    (``seed`` is nonzero or ``always``), add ``bits`` (default
    ``sr_bits(i, seed)``) to the ``drop`` low float32 mantissa bits
    the target drops, truncate them, then cast to ``dtype``."""
    x32 = widen(x)
    if bits is None:
        bits = sr_bits(x32.numel(), seed, x32.device).reshape(x32.shape)
    mask = (1 << drop) - 1
    u = x32.view(torch.int32).to(torch.int64) & _M32
    r = ((u + (bits & mask)) & (_M32 ^ mask))
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    use = torch.isfinite(x32) & (x32.abs() >= tiny)
    if not (always or seed & _M32):
        use = torch.zeros_like(use)
    return astype(torch.where(use, r.view(torch.float32), x32), dtype)


def stochastic_cast_rows(xs: Sequence[torch.Tensor], dtype: torch.dtype,
                         seeds, drop: int, tiny: float,
                         always: bool = False,
                         out: Optional[Sequence[torch.Tensor]] = None
                         ) -> List[torch.Tensor]:
    """Each row rounded stochastically to ``dtype`` with its own seed
    (row 6), one launch for all rows.  ``always`` rounds stochastically
    under seed 0 too (the Pallas tier's ``cast(stochastic=True)``); else
    a row of seed 0 takes the round-to-nearest-even cast."""
    rows = _rows(xs, "stochastic_cast")
    seeds = _seed_list(seeds, len(rows))
    outs = _row_outputs(rows, out, dtype, "stochastic_cast")
    if not 1 <= drop <= 23:
        raise ValueError(f"stochastic_cast: drop {drop} not in 1..23")
    if not on_cuda(rows + outs):
        for o, r, s in zip(outs, rows, seeds):
            o.copy_(stochastic_cast_plain(r, dtype, s, drop, tiny, always))
        return outs
    _check_dtype(rows[0].dtype, SR_SOURCES, "stochastic_cast")
    _check_dtype(dtype, SR_TARGETS, "stochastic_cast")
    n = rows[0].numel()
    if n:
        lib = _lib()
        rc = lib.accl_stochastic_cast(
            pointer_table(pointers(rows)), pointer_table(pointers(outs)),
            _seed_array(seeds),
            len(rows), n, int(torch_to_dtype(rows[0].dtype)),
            int(torch_to_dtype(dtype)), int(drop), float(tiny),
            int(bool(always)), stream_of(rows[0].device),
        )
        check_launch(lib, rc, "stochastic_cast")
        stochastic_cast_rows.launches.bump()
    return outs


stochastic_cast_rows.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# rows 7-8: int8 quantize and dequantize
# ---------------------------------------------------------------------------


def _nseg(n: int, seg: int) -> int:
    return max(1, -(-n // seg))


def quantize_plain(x: torch.Tensor, seed: int, seg: int,
                   out_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 of out_len (default n), scales float32 of nseg)``: one
    ``max(absmax / 127, 1e-30)`` scale per ``seg`` elements (the tail
    padded with zeros), ``q = clip(rint(x / scale), +-127)``, or
    ``floor(x / scale + u)`` with ``u = sr_bits * 2^-32`` when ``seed``
    is nonzero; a NaN q is 0."""
    x32 = widen(x).reshape(-1)
    n = x32.numel()
    nseg = _nseg(n, seg)
    out_len = n if out_len is None else out_len
    xp = torch.zeros(nseg * seg, dtype=torch.float32, device=x32.device)
    xp[:n] = x32
    m = xp.view(nseg, seg)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not IEEE division
    scales = torch.maximum(m.abs().amax(1) / torch.tensor(127.0,
                                                          device=m.device),
                           torch.tensor(1e-30, device=m.device))
    q = m / scales[:, None]
    if seed & _M32:
        u = sr_bits(nseg * seg, seed, m.device).view(nseg, seg).to(
            torch.float32) * (1.0 / 4294967296.0)
        q = torch.floor(q + u)
    else:
        q = torch.round(q)  # half to even, as rint
    q = torch.clamp(q, -127, 127)
    q = torch.where(torch.isnan(q), 0.0, q).to(torch.int8).reshape(-1)
    return q[:out_len].clone(), scales


#: row 7's segment paths (``csrc/compression.cu``)
QP_LANES, QP_CLUSTER, QP_TWO_PASS = 0, 1, 2
#: elements a lane of the LANES path; elements a CTA of the CLUSTER path
#: holds at most, its threads a CTA and most CTAs a cluster
QUANT_LANE_ELEMS = 16
QUANT_CTA_ELEMS = 8192
QUANT_CTA_THREADS = 256
QUANT_MAX_CLUSTER = 8
#: the largest segment one cluster holds; longer ones take TWO_PASS
QUANT_CLUSTER_CAP = QUANT_MAX_CLUSTER * QUANT_CTA_ELEMS


def quantize_geometry(seg: int, dtype: torch.dtype = torch.float32
                      ) -> Tuple[int, int, int]:
    """Row 7's path for segments of ``seg`` elements of ``dtype``: ``(path,
    cluster, threads)``.  LANES (``seg`` <= 512: a half-warp of 16 lanes
    holds a segment, a warp above 256, 16 elements a lane), CLUSTER
    (``seg`` <= ``QUANT_CLUSTER_CAP``: a cluster of the fewest CTAs of
    256 threads, at most 8192 elements each, holds it in shared memory)
    or TWO_PASS (longer: one block reads the segment twice).  Every
    element is read from HBM once but on TWO_PASS.  The same for every
    source dtype."""
    if dtype not in QUANT_SOURCES:
        raise ValueError(f"quantize_int8 takes {QUANT_SOURCES}, got {dtype}")
    if seg < 1:
        raise ValueError(f"quantize_int8: segment {seg}")
    if seg <= 32 * QUANT_LANE_ELEMS:
        return QP_LANES, 1, 16 if seg <= 16 * QUANT_LANE_ELEMS else 32
    if seg <= QUANT_CLUSTER_CAP:
        cluster = 1
        while cluster * QUANT_CTA_ELEMS < seg:
            cluster *= 2
        return QP_CLUSTER, cluster, QUANT_CTA_THREADS
    return QP_TWO_PASS, 1, 256


def quantize_rows(xs: Sequence[torch.Tensor], seeds, seg: int,
                  out_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 7 over R rows in one launch: ``(values (R, out_len) int8,
    scales (R, nseg) float32)``.  The scales come from the kernel's own
    absmax reduction."""
    rows = _rows(xs, "quantize_int8")
    seeds = _seed_list(seeds, len(rows))
    n = rows[0].numel()
    out_len = n if out_len is None else int(out_len)
    if seg < 1 or out_len < n:
        raise ValueError(f"quantize_int8: segment {seg}, out_len {out_len}"
                         f" for {n} elements")
    nseg = _nseg(n, seg)
    if not on_cuda(rows):
        parts = [quantize_plain(r, s, seg, out_len)
                 for r, s in zip(rows, seeds)]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))
    _check_dtype(rows[0].dtype, QUANT_SOURCES, "quantize_int8")
    path, cluster, threads = quantize_geometry(seg, rows[0].dtype)
    dev = rows[0].device
    values = torch.empty((len(rows), out_len), dtype=torch.int8, device=dev)
    scales = torch.empty((len(rows), nseg), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.accl_quantize_int8(
        pointer_table(pointers(rows)), _seed_array(seeds), len(rows), n,
        seg, nseg, out_len, values.data_ptr(), scales.data_ptr(),
        int(torch_to_dtype(rows[0].dtype)), path, cluster, threads,
        stream_of(dev),
    )
    check_launch(lib, rc, "quantize_int8")
    quantize_rows.launches.bump()
    return values, scales


quantize_rows.launches = LaunchCounter()


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor, n: int,
                     seg: int, dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """The first ``n`` elements of ``float(q) * scale`` (each element
    times its segment's scale), cast to ``dtype``."""
    q = q.reshape(-1)
    nseg = scales.numel()
    qf = torch.zeros(nseg * seg, dtype=torch.float32, device=q.device)
    qf[:q.numel()] = q[:nseg * seg].to(torch.float32)
    out = (qf.view(nseg, seg) * scales.reshape(-1, 1)).reshape(-1)[:n]
    return astype(out, dtype)


def dequantize_rows(values: torch.Tensor, scales: torch.Tensor, n: int,
                    seg: int, dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Row 8 over the R rows of ``values (R, m)`` and ``scales (R, nseg)``
    in one launch: ``(R, n)`` of ``dtype``."""
    if values.dim() != 2 or scales.dim() != 2 or (
            values.shape[0] != scales.shape[0]):
        raise ValueError("dequantize_int8: values (R, m), scales (R, nseg)")
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("dequantize_int8: int8 values, float32 scales")
    R, m = values.shape
    if n > m or n > scales.shape[1] * seg:
        raise ValueError(f"dequantize_int8: {n} outputs from {m} values in "
                         f"{scales.shape[1]} segments of {seg}")
    if not on_cuda([values, scales]):
        return torch.stack([dequantize_plain(values[r], scales[r], n, seg,
                                             dtype) for r in range(R)])
    _check_dtype(dtype, DEQUANT_TARGETS, "dequantize_int8")
    values, scales = values.contiguous(), scales.contiguous()
    out = torch.empty((R, n), dtype=dtype, device=values.device)
    if n:
        lib = _lib()
        rc = lib.accl_dequantize_int8(
            values.data_ptr(), m, scales.data_ptr(), scales.shape[1],
            out.data_ptr(), R, n, seg, int(torch_to_dtype(dtype)),
            stream_of(values.device),
        )
        check_launch(lib, rc, "dequantize_int8")
        dequantize_rows.launches.bump()
    return out


dequantize_rows.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# the Pallas tier's entry points
# ---------------------------------------------------------------------------


def cast(x: torch.Tensor, dtype: torch.dtype, *, stochastic: bool = False,
         seed: int = 0) -> torch.Tensor:
    """``x`` converted to ``dtype`` (ref ``pallas.cast``).
    ``stochastic=True`` (float32 -> bfloat16 only) rounds stochastically
    with the counter bits of ``seed`` (any seed, 0 included)."""
    flat = x.reshape(-1)
    if stochastic:
        if x.dtype != torch.float32 or dtype != torch.bfloat16:
            raise ValueError(
                "stochastic rounding supports float32 -> bfloat16")
        out = stochastic_cast_rows([flat], dtype, [seed], 16, 0.0,
                                   always=True)
    else:
        out = cast_rows([flat], dtype, e5m2_nan_unsigned=True)
    return out[0].reshape(x.shape)


def tiles(n: int) -> Tuple[int, int, int]:
    """``(rows, block rows, tiles)`` of ``n`` float32 elements packed as
    ``pack_lanes`` packs them."""
    rows = packed_len(n, SUBLANES) // LANES
    br = block_rows(rows)
    return rows, br, rows // br


def quantize_int8(x: torch.Tensor):
    """Blockwise int8 quantization (ref ``pallas.quantize_int8``):
    ``(values (rows, 128) int8, scales (nblk, 1) float32, n)``, one
    absmax / 127 scale per ``block_rows(rows) x 128`` tile."""
    n = x.numel()
    rows, br, nblk = tiles(n)
    values, scales = quantize_rows([x.reshape(-1)], [0], br * LANES,
                                   out_len=rows * LANES)
    return values.view(rows, LANES), scales.view(nblk, 1), n


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor, n: int,
                    shape, dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (ref ``pallas.dequantize_int8``):
    ``dtype`` restores the operand dtype."""
    rows = values.shape[0]
    nblk = scales.shape[0]
    seg = rows // nblk * LANES
    out = dequantize_rows(values.reshape(1, -1), scales.reshape(1, -1), n,
                          seg, dtype)
    return unpack_lanes(out, n, shape)
