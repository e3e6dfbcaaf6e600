"""Core vocabulary of the port: operations, registers, dtypes, error codes.

The enum VALUES are the JAX package's (``accl_tpu/constants.py``), so a
register dict, a DataType code or an ErrorCode carries across the two
packages unchanged.  This is the port's own copy: it imports nothing of
``accl_tpu``.  The dtype tables map onto ``torch`` dtypes.
"""

from __future__ import annotations

import enum

import torch


class Operation(enum.IntEnum):
    """Every callable scenario of the engine."""

    CONFIG = 0
    COPY = 1
    COMBINE = 2
    SEND = 3
    RECV = 4
    BCAST = 5
    SCATTER = 6
    GATHER = 7
    REDUCE = 8
    ALLGATHER = 9
    ALLREDUCE = 10
    REDUCE_SCATTER = 11
    ALLTOALL = 12
    BARRIER = 13
    NOP = 14


class ConfigFunction(enum.IntEnum):
    """Sub-functions of Operation.CONFIG (the subset this port serves)."""

    RESET = 0
    SET_TIMEOUT = 2
    SET_TUNING = 5


class TuningKey(enum.IntEnum):
    """Runtime tuning registers.  The port's gang engine honours
    ALLREDUCE_ALGORITHM, the four rooted algorithm registers (BCAST,
    REDUCE, SCATTER and GATHER_ALGORITHM), RING_SEGMENTS and WIRE_DTYPE;
    the other values are kept so register numbers stay the JAX
    package's."""

    GATHER_FLAT_TREE_MAX_FANIN = 0
    GATHER_FLAT_TREE_MAX_COUNT = 1
    BCAST_FLAT_TREE_MAX_RANKS = 2
    REDUCE_FLAT_TREE_MAX_RANKS = 3
    REDUCE_FLAT_TREE_MAX_COUNT = 4
    ALLREDUCE_ALGORITHM = 5
    RING_SEGMENTS = 6
    BCAST_ALGORITHM = 7
    REDUCE_ALGORITHM = 8
    SCATTER_ALGORITHM = 9
    GATHER_ALGORITHM = 10
    PIPELINE_THRESHOLD = 11
    WIRE_DTYPE = 12
    CMDRING_RUN_WINDOWS = 13
    CMDRING_LINGER_US = 14
    HIERARCHICAL = 15
    WIRE_DTYPE_ICI = 16
    WIRE_DTYPE_DCN = 17


class AllreduceAlgorithm(enum.IntEnum):
    """Values of TuningKey.ALLREDUCE_ALGORITHM."""

    XLA = 0                # the plain stacked-rank lowering (ops.collectives)
    RING = 1               # the explicit segmented ring pipeline (ops.ring)
    PALLAS_RING = 2        # the hand-written ring kernel (ops.cuda.ring)
    PALLAS_RING_BIDIR = 3  # the same kernel, halves in opposite directions


#: lowerings valid for the ROOTED algorithm registers (no ppermute-ring /
#: bidirectional form exists for rooted ops)
ROOTED_ALGORITHMS = (AllreduceAlgorithm.XLA, AllreduceAlgorithm.PALLAS_RING)

#: tuning keys that select a collective lowering (value: AllreduceAlgorithm)
ALGORITHM_TUNING_KEYS = (
    TuningKey.ALLREDUCE_ALGORITHM,
    TuningKey.BCAST_ALGORITHM,
    TuningKey.REDUCE_ALGORITHM,
    TuningKey.SCATTER_ALGORITHM,
    TuningKey.GATHER_ALGORITHM,
)

#: register names the port's gang engine accepts, with their defaults
TUNING_DEFAULTS = {
    "allreduce_algorithm": "xla",
    "bcast_algorithm": "xla",
    "reduce_algorithm": "xla",
    "scatter_algorithm": "xla",
    "gather_algorithm": "xla",
    "ring_segments": 1,
    "wire_dtype": 0,
}


class ReduceFunction(enum.IntEnum):
    SUM = 0
    MAX = 1


class DataType(enum.IntEnum):
    NONE = 0
    FLOAT16 = 1
    FLOAT32 = 2
    FLOAT64 = 3
    INT32 = 4
    INT64 = 5
    BFLOAT16 = 6
    INT8 = 7
    FLOAT8_E4M3 = 8
    FLOAT8_E5M2 = 9


#: the cast wire lanes this slice runs (the scaled int8 and fp8 lanes
#: come with the quantize kernels)
WIRE_LANE_DTYPES = (DataType.FLOAT16, DataType.BFLOAT16)

_DTYPE_ITEMSIZE = {
    DataType.FLOAT16: 2,
    DataType.FLOAT32: 4,
    DataType.FLOAT64: 8,
    DataType.INT32: 4,
    DataType.INT64: 8,
    DataType.BFLOAT16: 2,
    DataType.INT8: 1,
    DataType.FLOAT8_E4M3: 1,
    DataType.FLOAT8_E5M2: 1,
}

#: numpy dtype NAME -> DataType (by name, so a bfloat16 numpy array is
#: recognised without importing the package that defines it)
_NUMPY_NAMES = {
    "float16": DataType.FLOAT16,
    "float32": DataType.FLOAT32,
    "float64": DataType.FLOAT64,
    "int32": DataType.INT32,
    "int64": DataType.INT64,
    "bfloat16": DataType.BFLOAT16,
    "int8": DataType.INT8,
    "float8_e4m3fn": DataType.FLOAT8_E4M3,
    "float8_e5m2": DataType.FLOAT8_E5M2,
}


_TORCH_DTYPES = {
    DataType.FLOAT16: torch.float16,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.INT8: torch.int8,
    DataType.FLOAT8_E4M3: torch.float8_e4m3fn,
    DataType.FLOAT8_E5M2: torch.float8_e5m2,
}
_FROM_TORCH = {tdt: dt for dt, tdt in _TORCH_DTYPES.items()}


def dtype_size(dt: DataType) -> int:
    return _DTYPE_ITEMSIZE[DataType(dt)]


def dtype_to_torch(dt: DataType) -> torch.dtype:
    return _TORCH_DTYPES[DataType(dt)]


def torch_to_dtype(tdt: torch.dtype) -> DataType:
    try:
        return _FROM_TORCH[tdt]
    except KeyError:
        raise ValueError(f"unsupported dtype {tdt}") from None


def as_datatype(dt) -> DataType:
    """DataType from a DataType, a torch dtype, a numpy dtype or a name."""
    if isinstance(dt, DataType):
        return dt
    if isinstance(dt, str):
        name = dt
    elif isinstance(dt, torch.dtype):
        return torch_to_dtype(dt)
    else:
        import numpy as np

        name = np.dtype(dt).name
    try:
        return _NUMPY_NAMES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dt!r}") from None


class CompressionFlags(enum.IntFlag):
    NO_COMPRESSION = 0
    ETH_COMPRESSED = 8


class ErrorCode(enum.IntFlag):
    OK = 0
    RECEIVE_TIMEOUT = 1 << 3
    COLLECTIVE_NOT_IMPLEMENTED = 1 << 5
    INVALID_RANK = 1 << 8
    INVALID_COUNT = 1 << 9
    INVALID_OPERATION = 1 << 11
    INVALID_DTYPE = 1 << 12
    ARITH_ERROR = 1 << 13
    DEADLOCK_SUSPECTED = 1 << 20
    CONFIG_ERROR = 1 << 21

    @staticmethod
    def describe(code: "ErrorCode") -> str:
        if code == ErrorCode.OK:
            return "no error"
        return " | ".join(f.name for f in ErrorCode if f and (code & f))


class ACCLError(RuntimeError):
    """A call that completed with errors.  ``details`` carries the
    engine's structured failure context (op, comm, error text)."""

    def __init__(self, code: ErrorCode, context: str = "", details=None):
        self.code = ErrorCode(code)
        self.details = dict(details) if details else {}
        msg = f"ACCL call failed [{ErrorCode.describe(self.code)}]"
        if context:
            msg += f" during {context}"
        if self.details:
            msg += " (" + ", ".join(
                f"{k}={v}" for k, v in sorted(self.details.items())
            ) + ")"
        super().__init__(msg)


DEFAULT_TIMEOUT_S = 30.0
