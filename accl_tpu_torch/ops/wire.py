"""Device-side wire codec: the counterpart of ``accl_tpu/ops/wire.py``.

The same lanes as the host codec (:mod:`accl_tpu_torch.wire`), byte for
byte for the same input and seed, on torch tensors: on the card through
the compression kernels (``ops/cuda/compression.py``: the stochastic
cast and the cast for the float lanes, quantize and dequantize for the
int8 lane), on the CPU through their plain versions.  Every operation is
integer arithmetic or an IEEE-exact float operation, so kernel, plain
version and numpy agree bit for bit.

:func:`wire_lane_roundtrip_rows` rounds every rank's contribution of a
gang call in one launch per kernel, each row with its own seed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..constants import WIRE_SEGMENT_ELEMS, as_datatype, dtype_to_torch
from ..wire import (
    dropped_mantissa_bits,
    is_scaled,
    lane_tiny,
    rank_seed,
)
from .cuda import compression as kcomp
from .cuda.compression import sr_bits

__all__ = [
    "dequantize_int8",
    "quantize_int8",
    "rank_seed",
    "sr_bits",
    "wire_lane_roundtrip",
    "wire_lane_roundtrip_rows",
]


#: "scaled" lanes quantize blockwise


def quantize_int8(x: torch.Tensor, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scaled int8 lane's encode: ``(q int8 (n,), scales float32
    (nseg,))``, one absmax / 127 scale per WIRE_SEGMENT_ELEMS block;
    ``floor(x / scale + u)`` under a nonzero seed, else ``rint``."""
    values, scales = kcomp.quantize_rows([x.reshape(-1)], [seed],
                                         WIRE_SEGMENT_ELEMS)
    return values[0], scales[0]


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The scaled int8 lane's decode."""
    return kcomp.dequantize_rows(q.reshape(1, -1), scales.reshape(1, -1), n,
                                 WIRE_SEGMENT_ELEMS, out_dtype)[0]


def wire_lane_roundtrip_rows(xs: Sequence[torch.Tensor], wire_dtype,
                             seeds=0) -> List[torch.Tensor]:
    """Every row narrowed to ``wire_dtype`` and widened back to its own
    dtype — the single rounding each contribution takes on the wire —
    with one launch of each kernel for all rows.  ``seeds`` is one seed
    per row, or one for every row (0: round to nearest even)."""
    rows = [x.reshape(-1) for x in xs]
    n, orig, device = rows[0].numel(), rows[0].dtype, rows[0].device
    dt = as_datatype(wire_dtype)
    if is_scaled(dt):
        values, scales = kcomp.quantize_rows(rows, seeds, WIRE_SEGMENT_ELEMS)
        wide = kcomp.dequantize_rows(values, scales, n, WIRE_SEGMENT_ELEMS,
                                     orig)
    elif dropped_mantissa_bits(dt) is not None:
        # float -> narrow per row; stochastic where a row's seed is
        # nonzero (the deterministic cast for non-finite values and the
        # target's subnormals), then back to the operand dtype
        narrow = torch.empty((len(rows), n), dtype=dtype_to_torch(dt),
                             device=device)
        kcomp.stochastic_cast_rows(rows, narrow.dtype, seeds,
                                   dropped_mantissa_bits(dt), lane_tiny(dt),
                                   out=narrow.unbind(0))
        wide = torch.empty((len(rows), n), dtype=orig, device=device)
        kcomp.cast_rows(narrow.unbind(0), orig, out=wide.unbind(0))
    else:
        raise ValueError(f"{dt.name} is not a wire lane")
    return [w.view(x.shape) for w, x in zip(wide.unbind(0), xs)]


def wire_lane_roundtrip(x: torch.Tensor, wire_dtype, seed: int = 0
                        ) -> torch.Tensor:
    """One contribution narrowed to ``wire_dtype`` (stochastically under
    a nonzero ``seed``) and widened back to ``x``'s dtype, over every
    registered lane (ref ``ops/wire.py::wire_lane_roundtrip``)."""
    return wire_lane_roundtrip_rows([x], wire_dtype, [seed])[0]
