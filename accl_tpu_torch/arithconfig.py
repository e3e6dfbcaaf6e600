"""Arithmetic/compression configuration: for each (uncompressed,
compressed) dtype pair, its element sizes and the reductions it allows.
The port's copy of ``accl_tpu/arithconfig.py``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .constants import DataType, ReduceFunction, dtype_size


def reduce_op(function: ReduceFunction):
    """The elementwise torch operation of a reduce function."""
    if function == ReduceFunction.SUM:
        return torch.add
    if function == ReduceFunction.MAX:
        return torch.maximum
    raise ValueError(f"unsupported reduce function {function}")


@dataclasses.dataclass(frozen=True)
class ArithConfig:
    uncompressed: DataType
    compressed: DataType
    reduce_functions: Tuple[ReduceFunction, ...] = (
        ReduceFunction.SUM,
        ReduceFunction.MAX,
    )

    @property
    def uncompressed_elem_bytes(self) -> int:
        return dtype_size(self.uncompressed)

    @property
    def compressed_elem_bytes(self) -> int:
        return dtype_size(self.compressed)

    @property
    def is_compressed(self) -> bool:
        return self.uncompressed != self.compressed

    @property
    def elem_ratio(self) -> int:
        """How many compressed elements fit in one uncompressed element's bytes."""
        return max(1, self.uncompressed_elem_bytes // self.compressed_elem_bytes)

    def supports(self, fn: ReduceFunction) -> bool:
        return fn in self.reduce_functions


def _identity(dt: DataType) -> ArithConfig:
    return ArithConfig(dt, dt)


#: identity configs for every dtype plus the wire pairs: f32 -> f16 /
#: bf16, f32 and bf16 -> fp8 e4m3 / e5m2, and f32 and bf16 -> int8
#: (blockwise absmax-scaled, SUM only: MAX over differently scaled
#: blocks is not order-independent)
DEFAULT_ARITH_CONFIG: Dict[Tuple[DataType, DataType], ArithConfig] = {
    (DataType.FLOAT16, DataType.FLOAT16): _identity(DataType.FLOAT16),
    (DataType.FLOAT32, DataType.FLOAT32): _identity(DataType.FLOAT32),
    (DataType.FLOAT64, DataType.FLOAT64): _identity(DataType.FLOAT64),
    (DataType.INT32, DataType.INT32): _identity(DataType.INT32),
    (DataType.INT64, DataType.INT64): _identity(DataType.INT64),
    (DataType.BFLOAT16, DataType.BFLOAT16): _identity(DataType.BFLOAT16),
    (DataType.FLOAT32, DataType.FLOAT16): ArithConfig(
        DataType.FLOAT32, DataType.FLOAT16
    ),
    (DataType.FLOAT32, DataType.BFLOAT16): ArithConfig(
        DataType.FLOAT32, DataType.BFLOAT16
    ),
    (DataType.FLOAT32, DataType.FLOAT8_E4M3): ArithConfig(
        DataType.FLOAT32, DataType.FLOAT8_E4M3
    ),
    (DataType.FLOAT32, DataType.FLOAT8_E5M2): ArithConfig(
        DataType.FLOAT32, DataType.FLOAT8_E5M2
    ),
    (DataType.BFLOAT16, DataType.FLOAT8_E4M3): ArithConfig(
        DataType.BFLOAT16, DataType.FLOAT8_E4M3
    ),
    (DataType.BFLOAT16, DataType.FLOAT8_E5M2): ArithConfig(
        DataType.BFLOAT16, DataType.FLOAT8_E5M2
    ),
    (DataType.FLOAT32, DataType.INT8): ArithConfig(
        DataType.FLOAT32, DataType.INT8,
        reduce_functions=(ReduceFunction.SUM,),
    ),
    (DataType.BFLOAT16, DataType.INT8): ArithConfig(
        DataType.BFLOAT16, DataType.INT8,
        reduce_functions=(ReduceFunction.SUM,),
    ),
}


def lookup(
    table: Dict[Tuple[DataType, DataType], ArithConfig],
    uncompressed: DataType,
    compressed: DataType,
) -> ArithConfig:
    key = (uncompressed, compressed)
    if key not in table:
        raise KeyError(
            f"no arithmetic configuration for dtype pair {uncompressed.name}"
            f" -> {compressed.name}"
        )
    return table[key]
