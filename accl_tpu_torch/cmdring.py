"""Command-ring host half: the slot codec and the window shape.

The port's own copy of the jax-free codec of ``accl_tpu/cmdring.py``:
``encode_slot`` / ``decode_slot`` / ``encode_window`` pack a collective
into ``CMDRING_SLOT_WORDS`` int32 words through the one layout table
(:data:`accl_tpu_torch.constants.CMDRING_FIELDS`), ``ring_widths`` gives a
slot's operand and result widths, ``fused_slot_eligible`` says why a fused
call cannot ride a slot, and :class:`WindowShape` is what selects the
sequencer's code path.  The device half is ``ops/cmdring.py``, the gang
engine's window management ``backends/cuda/cmdring.py``.

The persistent mailbox of the JAX package (``SequencerMailbox``) and the
SEND/RECV pair definition are not ported: on the card a window is one
kernel launch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .constants import (
    CMDRING_FIELDS,
    CMDRING_FPARAM_ONE,
    CMDRING_SLOT_WORDS,
    CmdOpcode,
    FusedCompute,
    Operation,
    ReduceFunction,
)

_F = CMDRING_FIELDS


def encode_slot(
    seqn: int,
    opcode: CmdOpcode,
    count: int,
    dtype: int = 0,
    function: ReduceFunction = ReduceFunction.SUM,
    root: int = 0,
    flags: int = 0,
    nseg: int = 1,
    peer: int = 0,
    wire: int = 0,
    fparam: int = 0,
) -> np.ndarray:
    """One command slot as ``(CMDRING_SLOT_WORDS,)`` int32, every field
    written through :data:`CMDRING_FIELDS`."""
    words = np.zeros(CMDRING_SLOT_WORDS, np.int32)
    words[_F["seqn"]] = int(seqn) & 0x7FFFFFFF
    words[_F["opcode"]] = int(opcode)
    words[_F["count"]] = int(count)
    words[_F["dtype"]] = int(dtype)
    words[_F["function"]] = int(function)
    words[_F["root"]] = int(root)
    words[_F["flags"]] = int(flags)
    words[_F["nseg"]] = max(1, int(nseg))
    words[_F["peer"]] = int(peer)
    words[_F["wire"]] = int(wire)
    words[_F["fparam"]] = int(fparam)
    return words


def encode_fparam(x: float) -> int:
    """A fused epilogue's scalar as the Q16.16 fparam word (exact for the
    power-of-two scales training uses), clamped to int32."""
    q = int(round(float(x) * CMDRING_FPARAM_ONE))
    return max(-(2 ** 31), min(2 ** 31 - 1, q))


def decode_fparam(word: int) -> float:
    """The host-side inverse of :func:`encode_fparam`."""
    return float(int(word)) / CMDRING_FPARAM_ONE


def decode_slot(words) -> dict:
    """The encoder's inverse."""
    w = np.asarray(words).reshape(-1)
    if w.size != CMDRING_SLOT_WORDS:
        raise ValueError(
            f"slot has {w.size} words, layout says {CMDRING_SLOT_WORDS}"
        )
    out = {name: int(w[idx]) for name, idx in _F.items()}
    out["opcode"] = CmdOpcode(out["opcode"])
    return out


def encode_window(slots: Sequence[np.ndarray], depth: int) -> np.ndarray:
    """Stack encoded slots into a ``(depth, CMDRING_SLOT_WORDS)`` window,
    NOP-padding the tail (padding slots report OK and move nothing)."""
    if len(slots) > depth:
        raise ValueError(f"{len(slots)} slots into a depth-{depth} window")
    rows = [np.asarray(s, np.int32).reshape(-1) for s in slots]
    while len(rows) < depth:
        rows.append(encode_slot(0, CmdOpcode.NOP, 0))
    return np.stack(rows).astype(np.int32)


def ring_widths(
    op: Operation, count: int, size: int, fuse: int = 0
) -> Tuple[int, int]:
    """(operand width, result width) in elements of one ring slot.
    BARRIER rides a one-element token.  Fused slots pack their compute
    operands into the same operand row: MATMUL_RS the reduce-scatter
    geometry ``(n*size, n)``, APPLY gradients plus this rank's param chunk
    ``(n*(size+1), n)``, ATTN_HOP kv then q ``(2n, n)``."""
    n = int(count)
    fuse = FusedCompute(int(fuse))
    if fuse == FusedCompute.APPLY:
        return n * (size + 1), n
    if fuse == FusedCompute.ATTN_HOP:
        return 2 * n, n
    if op in (Operation.REDUCE_SCATTER, Operation.ALLTOALL):
        in_w = n * size
    elif op == Operation.BARRIER:
        in_w = 1
    else:
        in_w = n
    if op in (Operation.ALLGATHER, Operation.ALLTOALL):
        out_w = n * size
    elif op == Operation.BARRIER:
        out_w = 1
    else:
        out_w = n
    return in_w, out_w


#: FusedCompute -> the base Operation its call rides
FUSED_BASE_OPS = {
    FusedCompute.MATMUL_RS: Operation.REDUCE_SCATTER,
    FusedCompute.APPLY: Operation.ALLREDUCE,
    FusedCompute.ATTN_HOP: Operation.ALLREDUCE,
}


def _dtype_of(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    from .constants import as_datatype, dtype_to_torch

    return dtype_to_torch(as_datatype(dtype))


#: the dtypes numpy counts as floats (kind "f"): the JAX predicate's test,
#: under which bfloat16 (an ml_dtypes kind "V") is refused as fused_dtype
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def fused_slot_eligible(
    fuse: int,
    op: Operation,
    size: int,
    count: int,
    operand_count: int,
    dtype,
    compressed: bool = False,
) -> Optional[str]:
    """Why a fused call CANNOT ride a ring slot (None = eligible): it
    needs its base operation, a world of at least 2, a float16, float32 or
    float64 operand (bfloat16 is refused, as by the JAX predicate), an
    operand row of exactly the fused width and no wire compression.
    ``dtype`` is a torch dtype, a DataType or a dtype name."""
    try:
        fuse = FusedCompute(int(fuse))
    except ValueError:
        return "unknown_fuse"
    if fuse == FusedCompute.NONE:
        return None
    base = FUSED_BASE_OPS.get(fuse)
    if base is None or op != base:
        return "fused_base_op"
    if int(size) < 2:
        return "fused_world_too_small"
    if _dtype_of(dtype) not in _NUMPY_FLOATS:
        return "fused_dtype"
    in_w, _ = ring_widths(base, count, size, fuse=fuse)
    if int(operand_count) != in_w:
        return "fused_operand_width"
    if compressed:
        return "fused_compressed"
    return None


def dtype_name(dtype: Optional[torch.dtype]) -> Optional[str]:
    """A torch dtype's name as numpy spells it (``torch.bfloat16`` ->
    ``"bfloat16"``); None stays None."""
    return None if dtype is None else str(dtype).rsplit(".", 1)[-1]


class WindowShape:
    """Static shape of a refill window: the depth, every slot's operand
    and result width, its wire dtype (None for none) and the payload
    dtype.  Slot CONTENT (opcode, function, root, peer, fparam, seqn)
    stays data, read by the sequencer from the slot words; the shape may
    select its code path, as it keys the JAX program cache.  ``key()``
    equals the JAX package's for the same window."""

    __slots__ = ("depth", "in_ws", "out_ws", "wires", "dtype")

    def __init__(self, depth: int, in_ws, out_ws, wires, dtype):
        self.depth = int(depth)
        self.in_ws = tuple(int(w) for w in in_ws)
        self.out_ws = tuple(int(w) for w in out_ws)
        self.wires = tuple(None if w is None else _dtype_of(w)
                           for w in wires)
        self.dtype = _dtype_of(dtype)

    def key(self) -> tuple:
        return (self.depth, self.in_ws, self.out_ws,
                tuple(dtype_name(w) for w in self.wires),
                dtype_name(self.dtype))

    def __eq__(self, other) -> bool:
        return isinstance(other, WindowShape) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())
