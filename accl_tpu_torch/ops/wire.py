"""Device-side wire lanes: the counterpart of ``accl_tpu/ops/wire.py``.

This port carries the two CAST lanes, float16 and bfloat16, rounded to
nearest-even like ``astype``.  The stochastic fp8 lanes and the scaled
int8 lane arrive with the quantize kernels.
"""

from __future__ import annotations

import torch

from ..constants import WIRE_LANE_DTYPES, dtype_to_torch

CAST_LANES = tuple(dtype_to_torch(dt) for dt in WIRE_LANE_DTYPES)


def wire_lane_roundtrip(x: torch.Tensor, wire_dtype: torch.dtype) -> torch.Tensor:
    """Narrow ``x`` to ``wire_dtype`` and widen it back: the single
    rounding one contribution takes on the wire."""
    if wire_dtype not in CAST_LANES:
        raise NotImplementedError(
            f"wire lane {wire_dtype} is not ported (cast lanes: {CAST_LANES})"
        )
    return x.to(wire_dtype).to(x.dtype)
