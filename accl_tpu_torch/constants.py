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


#: the registered wire lanes: DataType member name -> torch dtype name
#: (the JAX package's table, with its numpy names read as torch's)
WIRE_LANE_DTYPES = {
    "FLOAT16": "float16",
    "BFLOAT16": "bfloat16",
    "FLOAT8_E4M3": "float8_e4m3fn",
    "FLOAT8_E5M2": "float8_e5m2",
    "INT8": "int8",
}

#: wire lanes that carry a per-segment absmax scale beside the payload
#: (blockwise quantization) instead of a plain dtype cast
SCALED_WIRE_DTYPES = ("INT8",)

#: elements per int8 scale block: one float32 scale (absmax / 127) per
#: WIRE_SEGMENT_ELEMS elements of payload
WIRE_SEGMENT_ELEMS = 256

#: wire lanes rounded stochastically by default (the facade derives a
#: nonzero call seed for them); float16 / bfloat16 round to nearest even
STOCHASTIC_WIRE_DTYPES = (
    "FLOAT8_E4M3", "FLOAT8_E5M2", "INT8",
)

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


def dtype_to_numpy(dt: DataType):
    """The numpy dtype of a DataType (bfloat16 and the fp8 dtypes through
    ``ml_dtypes``, imported only for them)."""
    import numpy as np

    name = WIRE_LANE_DTYPES.get(DataType(dt).name, DataType(dt).name.lower())
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))
    return np.dtype(name)


class StreamFlags(enum.IntFlag):
    """Whether an operand comes from, or the result goes to, the rank's
    device stream port instead of a buffer."""

    NO_STREAM = 0
    OP0_STREAM = 1
    RES_STREAM = 2


class CompressionFlags(enum.IntFlag):
    """Which operands are in the compressed dtype (ETH: on the wire)."""

    NO_COMPRESSION = 0
    OP0_COMPRESSED = 1
    OP1_COMPRESSED = 2
    RES_COMPRESSED = 4
    ETH_COMPRESSED = 8


class ErrorCode(enum.IntFlag):
    OK = 0
    DMA_TIMEOUT = 1 << 2
    RECEIVE_TIMEOUT = 1 << 3
    SEND_TIMEOUT = 1 << 4
    COLLECTIVE_NOT_IMPLEMENTED = 1 << 5
    INVALID_RANK = 1 << 8
    INVALID_COUNT = 1 << 9
    INVALID_OPERATION = 1 << 11
    INVALID_DTYPE = 1 << 12
    ARITH_ERROR = 1 << 13
    COMPRESSION_ERROR = 1 << 14
    TRANSPORT_ERROR = 1 << 18
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


def drain_deadline_s(timeout_s: float) -> float:
    """How long the facade waits on a synchronous call: 4x the engine
    timeout with a 60 s floor (the JAX package's ``drain_deadline_s``), so
    the engine's own deadlines (a parked send or recv, a stream pop) fire
    first and a first build of the kernels does not trip it."""
    return max(60.0, 4.0 * float(timeout_s))


# ---------------------------------------------------------------------------
# the command ring (the JAX package's ``CmdOpcode`` ... ``CMDRING_*``)
# ---------------------------------------------------------------------------


class CmdOpcode(enum.IntEnum):
    """Opcode space of a command-ring slot: the sequencer's dispatch
    vocabulary (the reference CCLO's run-loop opcode set)."""

    NOP = 0        # padding slot: decoded, skipped, status OK
    ALLREDUCE = 1
    BCAST = 2
    HALT = 3       # teardown marker (the persistent run; not ported)
    REDUCE_SCATTER = 4
    ALLGATHER = 5
    ALLTOALL = 6
    BARRIER = 7    # the gather IS the sync; orders the slots around it
    SEND = 8       # matched p2p pair as one slot (root=src, peer=dst)
    RECV = 9       # the complementary spelling of the same pair slot
    FUSED_MATMUL_RS = 10   # scaled GEMM-partial epilogue feeding a
                           # reduce-scatter (alpha in fparam)
    FUSED_APPLY = 11       # optimizer apply-on-arrival: p - lr * g, the
                           # param chunk riding the operand tail
    FUSED_ATTN_HOP = 12    # ring-attention hop: (q * kv) * scale, hop
                           # offset in peer


class FusedCompute(enum.IntEnum):
    """Fuse hint of a call (``CallOptions.fuse``): which compute epilogue
    rides the collective's ring slot.  Fused calls that miss the ring run
    the host decomposition (the packed operand has no plain spelling)."""

    NONE = 0
    MATMUL_RS = 1
    APPLY = 2
    ATTN_HOP = 3


#: Operation -> CmdOpcode: the sequencer's warm-path subset.  Fused
#: opcodes are keyed by their fuse-hint name (they share a base Operation
#: with a plain entry).  SEND/RECV keep their entries so the table stays
#: the JAX package's; the port's ring refuses them (no p2p channel yet).
CMDRING_OPCODES = {
    Operation.ALLREDUCE: CmdOpcode.ALLREDUCE,
    Operation.BCAST: CmdOpcode.BCAST,
    Operation.REDUCE_SCATTER: CmdOpcode.REDUCE_SCATTER,
    Operation.ALLGATHER: CmdOpcode.ALLGATHER,
    Operation.ALLTOALL: CmdOpcode.ALLTOALL,
    Operation.BARRIER: CmdOpcode.BARRIER,
    Operation.SEND: CmdOpcode.SEND,
    Operation.RECV: CmdOpcode.RECV,
    "fused_matmul_rs": CmdOpcode.FUSED_MATMUL_RS,
    "fused_apply": CmdOpcode.FUSED_APPLY,
    "fused_attn_hop": CmdOpcode.FUSED_ATTN_HOP,
}

#: FusedCompute -> the CmdOpcode a fuse hint encodes as
CMDRING_FUSED_OPCODES = {
    FusedCompute.MATMUL_RS: CmdOpcode.FUSED_MATMUL_RS,
    FusedCompute.APPLY: CmdOpcode.FUSED_APPLY,
    FusedCompute.ATTN_HOP: CmdOpcode.FUSED_ATTN_HOP,
}

#: Q16.16 unit of the fparam slot word (a fused epilogue's scalar)
CMDRING_FPARAM_ONE = 65536

#: int32 words per slot
CMDRING_SLOT_WORDS = 11

#: field name -> word index within a slot
CMDRING_FIELDS = {
    "seqn": 0,      # monotone completion sequence number (mod 2^31)
    "opcode": 1,    # CmdOpcode
    "count": 2,     # element count of the collective
    "dtype": 3,     # DataType of the operand
    "function": 4,  # ReduceFunction
    "root": 5,      # comm-relative root rank (BCAST)
    "flags": 6,     # stochastic-rounding seed of the wire lane (0 here)
    "nseg": 7,      # ring segmentation register snapshot
    "peer": 8,      # hop OFFSET for FUSED_ATTN_HOP (SPMD-uniform)
    "wire": 9,      # DataType of the compressed wire lane (0 = none)
    "fparam": 10,   # Q16.16 scalar of a fused epilogue (0 for plain slots)
}

#: per-slot status-word retcodes the sequencer writes back
CMDRING_ST_OK = 1
CMDRING_ST_BAD_OP = 2

#: ring knobs: ACCL_CMDRING=0 disables the ring, =eager also routes single
#: calls through one-slot windows; ACCL_CMDRING_DEPTH sizes a window;
#: payloads above ACCL_CMDRING_MAX_BYTES per rank take the per-call path
CMDRING_ENV = "ACCL_CMDRING"
CMDRING_DEPTH_ENV = "ACCL_CMDRING_DEPTH"
CMDRING_MAX_BYTES_ENV = "ACCL_CMDRING_MAX_BYTES"
CMDRING_DEPTH_DEFAULT = 8
CMDRING_MAX_DEPTH = 64
CMDRING_MAX_PAYLOAD_BYTES = 4 * 1024 * 1024
