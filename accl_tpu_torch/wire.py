"""Quantized wire protocols: the host-side codec of every wire lane.

The port's own copy of ``accl_tpu/wire.py``, with the same names.  The
lanes:

* **cast lanes** (float16 / bfloat16 / fp8 e4m3 / fp8 e5m2): elementwise
  narrowing, with **stochastic rounding** for the fp8 lanes when a call
  carries a seed;
* **scaled lanes** (int8): blockwise absmax quantization, one float32
  scale per :data:`~accl_tpu_torch.constants.WIRE_SEGMENT_ELEMS`
  elements beside the int8 payload (``q = round(x / scale)``,
  ``scale = absmax / 127``), stochastic when seeded.

Stochastic rounding is counter-based: the random bits are a Murmur3
finalizer of ``(element index, seed)``, so the device codec
(:mod:`accl_tpu_torch.ops.wire`, and on the card the kernels of
``csrc/compression.cu``) derives the identical stream from the same seed
and the two codecs agree byte for byte.  Seed 0 means round to nearest
even.

The element arithmetic is numpy (as in the JAX package); the narrowing
casts go through :func:`astype`, which converts as JAX's ``astype`` does
on the CPU (numpy has no bfloat16 or fp8 of its own, and the port does
not depend on the package that adds them).
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import torch

from .constants import (
    DataType,
    SCALED_WIRE_DTYPES,
    STOCHASTIC_WIRE_DTYPES,
    WIRE_LANE_DTYPES,
    WIRE_SEGMENT_ELEMS,
    dtype_size,
    dtype_to_torch,
)

__all__ = [
    "astype",
    "call_seed",
    "decode_bytes",
    "dropped_mantissa_bits",
    "encode_bytes",
    "is_scaled",
    "is_stochastic",
    "is_wire_dtype",
    "lane_tiny",
    "options_rank_seed",
    "rank_seed",
    "roundtrip",
    "seg_count",
    "sr_bits",
    "wire_lane_dtypes",
    "wire_nbytes",
]

#: float32 mantissa bits DROPPED per float wire lane (23 - the target's
#: mantissa bits): the stochastic-rounding mask width
_DROPPED_MANTISSA = {
    DataType.FLOAT16: 13,
    DataType.BFLOAT16: 16,
    DataType.FLOAT8_E4M3: 20,
    DataType.FLOAT8_E5M2: 21,
}

#: smallest NORMAL magnitude per float wire lane (2^(1 - bias)): below it
#: the mantissa-bit trick misaligns with the target's subnormal spacing,
#: so those elements take the deterministic cast
_LANE_TINY = {
    DataType.FLOAT16: 2.0 ** -14,
    DataType.BFLOAT16: 2.0 ** -126,
    DataType.FLOAT8_E4M3: 2.0 ** -6,
    DataType.FLOAT8_E5M2: 2.0 ** -14,
}

_WIRE_SET = frozenset(DataType[n] for n in WIRE_LANE_DTYPES)
_SCALED_SET = frozenset(DataType[n] for n in SCALED_WIRE_DTYPES)
_STOCHASTIC_SET = frozenset(DataType[n] for n in STOCHASTIC_WIRE_DTYPES)


def lane_tiny(dt) -> Optional[float]:
    """Smallest normal magnitude of a float cast lane (None for scaled
    lanes): the stochastic-rounding floor both codecs share."""
    return _LANE_TINY.get(DataType(dt))


def wire_lane_dtypes() -> Tuple[DataType, ...]:
    """The registered wire lanes, as DataType members (sorted by value)."""
    return tuple(sorted(_WIRE_SET))


def is_wire_dtype(dt) -> bool:
    try:
        return DataType(dt) in _WIRE_SET
    except ValueError:
        return False


def is_scaled(dt) -> bool:
    """True for lanes carrying a per-segment absmax scale sidecar."""
    return DataType(dt) in _SCALED_SET


def is_stochastic(dt) -> bool:
    """True for lanes that round stochastically by default (the facade
    derives a nonzero call seed for them)."""
    return DataType(dt) in _STOCHASTIC_SET


def dropped_mantissa_bits(dt) -> Optional[int]:
    """Stochastic-rounding mask width of a float cast lane; None for
    scaled lanes."""
    return _DROPPED_MANTISSA.get(DataType(dt))


def seg_count(n: int) -> int:
    """Scale blocks covering ``n`` elements (scaled lanes)."""
    return max(1, -(-int(n) // WIRE_SEGMENT_ELEMS))


def wire_nbytes(n: int, dt) -> int:
    """Bytes on the wire for ``n`` elements in lane ``dt``: the narrow
    payload plus, for scaled lanes, the float32 scale sidecar."""
    dt = DataType(dt)
    nb = int(n) * dtype_size(dt)
    if dt in _SCALED_SET:
        nb += seg_count(n) * 4
    return nb


# ---------------------------------------------------------------------------
# seeds: counter-based, SPMD-uniform, rank-mixed
# ---------------------------------------------------------------------------


def call_seed(comm_id: int, epoch: int, counter: int, wire: int) -> int:
    """Per-call stochastic-rounding seed from SPMD-uniform facts only
    (crc32, never the process-salted ``hash``), so every rank derives
    the same seed; nonzero by construction (0 means round to nearest
    even)."""
    data = f"wire|{comm_id}|{epoch}|{counter}|{int(wire)}".encode()
    return (zlib.crc32(data) & 0x7FFFFFFF) or 1


def options_rank_seed(options) -> int:
    """The per-rank seed of one engine call: the call's ``wire_seed``
    mixed with its communicator-local rank (0 for unseeded calls and
    calls without a communicator)."""
    seed = getattr(options, "wire_seed", 0)
    comm = getattr(options, "comm", None)
    if not seed or comm is None:
        return 0
    return rank_seed(seed, comm.local_rank)


def rank_seed(seed: int, rank: int) -> int:
    """Mix a rank into a call seed, so ranks draw independent streams
    from one call seed; 0 stays 0 (deterministic)."""
    if not seed:
        return 0
    h = (int(seed) ^ ((int(rank) * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h or 1


#: cached ``arange(n) * Knuth`` ramps for sr_bits (seed-independent);
#: bounded, cleared wholesale on overflow
_SR_BASE: dict = {}


def sr_bits(n: int, seed: int):
    """``n`` uniform uint32 draws (numpy): the Murmur3 finalizer over
    ``(element index * 2654435761) ^ seed``.  Stateless, so the device
    codec and the kernels recompute the identical stream."""
    import numpy as np

    base = _SR_BASE.get(n)
    if base is None:
        if len(_SR_BASE) > 64:
            _SR_BASE.clear()
        base = _SR_BASE[n] = (
            np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
        )
    h = base ^ np.uint32(seed & 0xFFFFFFFF)
    tmp = np.empty_like(h)
    np.right_shift(h, 16, out=tmp)
    h ^= tmp
    h *= np.uint32(0x85EBCA6B)
    np.right_shift(h, 13, out=tmp)
    h ^= tmp
    h *= np.uint32(0xC2B2AE35)
    np.right_shift(h, 16, out=tmp)
    h ^= tmp
    return h


# ---------------------------------------------------------------------------
# dtype conversion as JAX's astype computes it
# ---------------------------------------------------------------------------

_BITS = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
#: quiet NaN of each lane dtype, sign bit clear
_QNAN = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC0,
         torch.float16: 0x7E00, torch.float8_e4m3fn: 0x7F,
         torch.float8_e5m2: 0x7E}
#: float8_e4m3fn's largest finite value, and the float32 magnitude above
#: which round-to-nearest-even leaves its range (it has no infinity:
#: JAX's astype gives NaN there, where torch's conversion saturates)
_E4M3_OVERFLOW = 464.0


def _as_bits(values: torch.Tensor, nbytes: int) -> torch.Tensor:
    """int64 bit patterns -> the signed (or uint8) view type of an
    ``nbytes``-wide dtype, wrapping as the bit pattern says."""
    if nbytes == 1:
        return values.to(torch.uint8)
    top = 1 << (8 * nbytes)
    values = torch.where(values >= top // 2, values - top, values)
    return values.to(_BITS[nbytes])


def _float32_bits(x32: torch.Tensor) -> torch.Tensor:
    return x32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32, exactly, with NaN bits as JAX widens them:
    bfloat16 by a shift, float16 keeping its payload with the quiet bit
    set, fp8 as the quiet NaN (sign kept)."""
    if x.dtype == torch.float32:
        return x
    x32 = x.float()
    if x.dtype == torch.bfloat16 or not x.is_floating_point():
        return x32
    nan = torch.isnan(x32)
    if x.dtype == torch.float16:
        h = x.view(torch.int16).to(torch.int64) & 0xFFFF
        bits = ((h & 0x8000) << 16) | 0x7FC00000 | ((h & 0x3FF) << 13)
    else:
        bits = torch.where(torch.signbit(x32), 0x80000000, 0) | 0x7FC00000
    return torch.where(nan, _as_bits(bits, 4).view(torch.float32), x32)


def astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as JAX computes it on the CPU, for the wire
    dtypes (float32, bfloat16, float16, fp8 e4m3 / e5m2): round to
    nearest even, subnormals kept; float8_e4m3fn has no infinity, so
    infinities and magnitudes above 464 become NaN (torch's own
    conversion saturates them to 448); a NaN becomes the target's quiet
    NaN with its sign (float16 keeps the top of the payload), except
    that JAX gives 0x7F, unsigned, for float8_e5m2 from bfloat16,
    float16 and float8_e4m3fn (``ROADMAP.md``'s divergences)."""
    if dtype == x.dtype:
        return x.clone()
    x32 = widen(x)
    if dtype == torch.float32:
        return x32.clone() if x32 is x else x32
    if not dtype.is_floating_point:
        return x32.to(dtype)
    y = x32.to(dtype)
    nbytes = dtype.itemsize
    nan = torch.isnan(x32)
    if dtype == torch.float8_e4m3fn:
        nan = nan | torch.isinf(x32) | (x32.abs() > _E4M3_OVERFLOW)
    sign = torch.signbit(x32).to(torch.int64) << (8 * nbytes - 1)
    bits = sign | _QNAN[dtype]
    if dtype == torch.float16:
        bits = bits | ((_float32_bits(x32) & 0x7FFFFF) >> 13)
    elif dtype == torch.float8_e5m2 and x.dtype in (
            torch.bfloat16, torch.float16, torch.float8_e4m3fn):
        bits = torch.full_like(bits, 0x7F)
    out = torch.where(nan, _as_bits(bits, nbytes), y.view(_BITS[nbytes]))
    return out.view(dtype)


# ---------------------------------------------------------------------------
# the lanes (numpy arithmetic)
# ---------------------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a contiguous CPU tensor of its own
    dtype (a numpy bfloat16 array through its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    import numpy as np

    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _float32(x):
    """``x`` as a contiguous float32 numpy array."""
    return widen(_tensor(x)).numpy()


def _cast_lane_encode(x, dt: DataType, seed: int) -> torch.Tensor:
    """float32 -> narrow float wire values (a CPU tensor of the lane's
    dtype).  ``seed`` nonzero rounds stochastically: add uniform random
    bits to the dropped mantissa bits, truncate, cast (exact for
    normals; non-finite values and the target's subnormals take the
    deterministic cast)."""
    import numpy as np

    x32 = _float32(x)
    if seed:
        drop = _DROPPED_MANTISSA[dt]
        mask = np.uint32((1 << drop) - 1)
        bits = sr_bits(x32.size, seed).reshape(x32.shape)
        bits &= mask
        bits += x32.view(np.uint32)
        bits &= ~mask
        rounded = bits.view(np.float32)
        use_sr = np.isfinite(x32)
        use_sr &= np.abs(x32) >= np.float32(_LANE_TINY[dt])
        x32 = np.where(use_sr, rounded, x32)
    return astype(torch.from_numpy(np.ascontiguousarray(x32)),
                  dtype_to_torch(dt))


def _scaled_lane_encode(x, seed: int):
    """float32 -> (int8 values, per-segment float32 scales), numpy:
    blockwise absmax quantization.  ``seed`` nonzero:
    ``q = floor(x / scale + u)`` with ``u`` uniform in [0, 1); 0:
    ``q = rint(x / scale)`` (half to even)."""
    import numpy as np

    x32 = _float32(x).reshape(-1)
    n = x32.size
    nseg = seg_count(n)
    pad = nseg * WIRE_SEGMENT_ELEMS - n
    xp = np.concatenate([x32, np.zeros(pad, np.float32)]) if pad else x32
    m = xp.reshape(nseg, WIRE_SEGMENT_ELEMS)
    scales = np.maximum(
        np.max(np.abs(m), axis=1) / np.float32(127.0), np.float32(1e-30)
    ).astype(np.float32)
    q_real = m / scales[:, None]
    if seed:
        u = sr_bits(m.size, seed).reshape(m.shape).astype(np.float32)
        u *= np.float32(1.0 / 4294967296.0)
        q_real += u
        q = np.floor(q_real, out=q_real)
    else:
        q = np.rint(q_real, out=q_real)
    q = np.clip(q, -127, 127, out=q)
    q[np.isnan(q)] = 0  # a NaN operand's segment: defined as 0
    return q.astype(np.int8).reshape(-1)[:n], scales


def _scaled_lane_decode(q, scales, out_dtype: torch.dtype) -> torch.Tensor:
    import numpy as np

    n = q.shape[0]
    nseg = scales.shape[0]
    pad = nseg * WIRE_SEGMENT_ELEMS - n
    qf = q.astype(np.float32)
    if pad:
        qf = np.concatenate([qf, np.zeros(pad, np.float32)])
    out = (qf.reshape(nseg, WIRE_SEGMENT_ELEMS) * scales[:, None]).reshape(
        -1)[:n]
    return astype(torch.from_numpy(np.ascontiguousarray(out)), out_dtype)


def _out_dtype(x) -> torch.dtype:
    """The dtype a roundtrip returns: float16 / float32 / float64 keep
    their own, anything else (bfloat16 included, whose numpy dtype is
    not of kind "f") comes back as float32, as in the JAX package."""
    dtype = _tensor(x).dtype
    keep = (torch.float16, torch.float32, torch.float64)
    return dtype if dtype in keep else torch.float32


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


# ---------------------------------------------------------------------------
# wire frames
# ---------------------------------------------------------------------------


def encode_bytes(data, dt, seed: int = 0) -> bytes:
    """One logical chunk as wire bytes: the narrow payload, then (for
    scaled lanes) the float32 scale sidecar."""
    dt = DataType(dt)
    if dt in _SCALED_SET:
        q, scales = _scaled_lane_encode(data, seed)
        return q.tobytes() + scales.tobytes()
    if dt in _DROPPED_MANTISSA:
        return _tensor_bytes(_cast_lane_encode(data, dt, seed))
    # identity / widening lanes (the uncompressed wire): plain cast
    return _tensor_bytes(astype(_tensor(data), dtype_to_torch(dt)))


def decode_bytes(raw: bytes, dt, n: int, out_dtype) -> torch.Tensor:
    """Inverse of :func:`encode_bytes` for ``n`` elements, as a CPU
    tensor of ``out_dtype`` (a torch dtype)."""
    import numpy as np

    dt = DataType(dt)
    n = int(n)
    if dt in _SCALED_SET:
        vals = np.frombuffer(raw[:n], np.int8)[:n]
        scales = np.frombuffer(raw[n: n + seg_count(n) * 4],
                               np.float32).copy()
        return _scaled_lane_decode(vals, scales, out_dtype)
    wire = dtype_to_torch(dt)
    payload = torch.frombuffer(bytearray(raw[: n * wire.itemsize]),
                               dtype=torch.uint8)
    return astype(payload.view(wire), out_dtype)


def roundtrip(data, dt, seed: int = 0) -> torch.Tensor:
    """``decode(encode(x))`` without the bytes: the single rounding one
    contribution takes on the wire, as a CPU tensor of the operand's
    dtype (float32 for a non-float operand) and shape."""
    dt = DataType(dt)
    out_dtype = _out_dtype(data)
    shape = tuple(data.shape)
    if dt in _SCALED_SET:
        q, scales = _scaled_lane_encode(data, seed)
        return _scaled_lane_decode(q, scales, out_dtype).reshape(shape)
    if dt in _DROPPED_MANTISSA:
        return astype(_cast_lane_encode(data, dt, seed),
                      out_dtype).reshape(shape)
    return astype(astype(_tensor(data), dtype_to_torch(dt)),
                  out_dtype).reshape(shape)
