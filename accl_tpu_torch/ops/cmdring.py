"""The command ring's device half: what one window computes.

The counterpart of ``accl_tpu/ops/pallas/cmdring.py``.  There, a window
of up to ``depth`` collectives is one sequencer program: per slot it
gathers every rank's block, reads the slot's opcode, function, root, peer
and fparam words on the device, and runs :func:`slot_epilogue`.  Here
:func:`run_window` does the same for ranks that share one device: on CPU
tensors through the plain sequencer, on CUDA tensors through one launch of
the hand-written sequencer kernel (``ops/cuda/cmdring.py``).

:func:`slot_epilogue` is written in plain PyTorch and keeps the JAX
function's classification: the width RELATIONS of a slot pick the class
(allgather, fused apply, reduce-scatter, attention hop, same width), and
the opcode word selects within it, so a mis-encoded slot passes its own
operand through exactly as the JAX one does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..arithconfig import reduce_op
from ..cmdring import WindowShape
from ..constants import (
    CMDRING_FIELDS,
    CMDRING_FPARAM_ONE,
    CMDRING_ST_BAD_OP,
    CMDRING_ST_OK,
    CmdOpcode,
    ReduceFunction,
)

_F = CMDRING_FIELDS
_MAX_OPCODE = max(int(o) for o in CmdOpcode)


def hop_source(me, hop, size):
    """Rank whose block rank ``me`` holds after ``hop`` ring hops (the
    FUSED_ATTN_HOP peer word is the hop OFFSET; ``ops/pallas/ring.py``)."""
    return (me - hop + size) % size


def attn_hop_partial(q, kv, scale):
    """One FUSED_ATTN_HOP epilogue: ``(q * kv) * scale``
    (``ops/pallas/attention.py``)."""
    return (q * kv) * scale


def _reduce_chain(blocks, fn):
    """Rank-order fold ``b0 op b1 op ...`` (MAX when ``fn`` says MAX,
    else SUM, as the JAX chain selects)."""
    op = reduce_op(ReduceFunction.MAX if int(fn) == int(ReduceFunction.MAX)
                   else ReduceFunction.SUM)
    acc = blocks[0]
    for b in blocks[1:]:
        acc = op(acc, b)
    return acc


def _root_select(blocks, root):
    """``blocks[root]``; a root outside 1..P-1 selects block 0, as the JAX
    where-chain does."""
    root = int(root)
    return blocks[root] if 0 < root < len(blocks) else blocks[0]


def fparam_scale(fparam, dtype: torch.dtype) -> torch.Tensor:
    """The fused epilogue's scalar from its Q16.16 word:
    ``float32(fparam) * (1/65536)`` cast to the operand dtype."""
    fp = torch.tensor(int(fparam or 0), dtype=torch.int32).to(torch.float32)
    return (fp * (1.0 / CMDRING_FPARAM_ONE)).to(dtype)


def _attn_hop_result(blocks, own, me, peer, out_lead, fp):
    src = hop_source(int(me), int(peer), len(blocks))
    visiting = _root_select(blocks, src)
    return attn_hop_partial(own[out_lead:2 * out_lead], visiting[:out_lead],
                            fp)


def slot_epilogue(blocks, own, me, op, fn, root, peer, out_lead,
                  chunk: Optional[int] = None, fparam=None):
    """One slot's result on rank ``me``: ``blocks`` are every rank's
    (wire-rounded) operand rows, ``own`` this rank's unrounded row,
    ``op``/``fn``/``root``/``peer``/``fparam`` the slot words, ``out_lead``
    the result width and ``chunk`` the per-rank sub-block width of the
    P-wide ops.  By class, then opcode, as the JAX ``slot_epilogue``:

    * ``out == in * P``: ALLGATHER (else ``own`` tiled P times);
    * ``in == out * (P+1)``: FUSED_APPLY, ``own[P*n:(P+1)*n] - fp * grad``
      with ``grad`` this rank's chunk of the fold (else ``own[:out]``);
    * ``in == out * P``: REDUCE_SCATTER (this rank's chunk of the fold),
      FUSED_MATMUL_RS (``fp *`` that chunk), FUSED_ATTN_HOP at P = 2
      (else this rank's chunk of ``own``);
    * ``in == out * 2``, P > 2: FUSED_ATTN_HOP (else ``own[:out]``);
    * same width: ALLREDUCE (the fold), BCAST (``blocks[root]``), BARRIER
      and every other opcode (``own``), SEND/RECV (``blocks[root]`` where
      ``me == peer``), ALLTOALL (``concat_j blocks[j][me*chunk:...]``).
    """
    op, me = int(op), int(me)
    size = len(blocks)
    in_lead = own.shape[0]
    if size == 1:
        return own[:out_lead] if out_lead <= in_lead else own
    if out_lead == in_lead * size:
        if op == CmdOpcode.ALLGATHER:
            return torch.cat(list(blocks))
        return torch.cat([own] * size)
    reduced = _reduce_chain(blocks, fn)
    fp = fparam_scale(fparam, own.dtype)
    if in_lead == out_lead * (size + 1):
        if op != CmdOpcode.FUSED_APPLY:
            return own[:out_lead]
        grad = reduced[me * out_lead:(me + 1) * out_lead]
        mine = own[size * out_lead:(size + 1) * out_lead]
        return mine - fp * grad
    if in_lead == out_lead * size:
        mine = reduced[me * out_lead:(me + 1) * out_lead]
        if op == CmdOpcode.REDUCE_SCATTER:
            return mine
        if op == CmdOpcode.FUSED_MATMUL_RS:
            return fp * mine
        if size == 2 and op == CmdOpcode.FUSED_ATTN_HOP:
            return _attn_hop_result(blocks, own, me, peer, out_lead, fp)
        return own[me * out_lead:(me + 1) * out_lead]
    if in_lead == out_lead * 2:
        if op == CmdOpcode.FUSED_ATTN_HOP:
            return _attn_hop_result(blocks, own, me, peer, out_lead, fp)
        return own[:out_lead]
    if op == CmdOpcode.ALLREDUCE:
        return reduced
    if op == CmdOpcode.BCAST:
        return _root_select(blocks, root)
    if op in (CmdOpcode.SEND, CmdOpcode.RECV):
        return _root_select(blocks, root) if me == int(peer) else own
    if (op == CmdOpcode.ALLTOALL and chunk is not None
            and chunk * size == in_lead and chunk > 0):
        return torch.cat([blocks[j][me * chunk:(me + 1) * chunk]
                          for j in range(size)])
    return own


def status_words(slots) -> np.ndarray:
    """Per-slot ``(seqn, retcode)``: OK for every CmdOpcode, BAD_OP for an
    opcode outside the enum."""
    slots = np.asarray(slots, np.int32).reshape(-1, len(_F))
    op = slots[:, _F["opcode"]]
    ok = (op >= 0) & (op <= _MAX_OPCODE)
    ret = np.where(ok, CMDRING_ST_OK, CMDRING_ST_BAD_OP).astype(np.int32)
    return np.stack([slots[:, _F["seqn"]], ret], axis=1)


def run_window(slots, xs: Sequence[Sequence[Optional[torch.Tensor]]],
               outs: Sequence[Sequence[Optional[torch.Tensor]]],
               shape: WindowShape, device=None) -> torch.Tensor:
    """Run one refill window: ``slots`` the ``(n, CMDRING_SLOT_WORDS)``
    int32 words (host), ``xs[i][r]`` rank r's operand row of slot i (at
    least ``shape.in_ws[i]`` elements; None reads as zeros), ``outs[i][r]``
    the tensor that takes rank r's result of slot i (exactly
    ``result width`` elements; None: no result).  Slots run in order, each
    reading its operands as they were before the window; a slot whose
    operand an earlier slot of the window writes is refused (the engine
    counts it as ``data_dependency``).  Returns the ``(n, 2)`` int32
    status words on the operands' device (on ``device`` for a window of
    barriers alone).  CPU tensors run the plain sequencer; CUDA tensors
    launch the sequencer kernel or raise."""
    from .cuda.cmdring import sequencer

    return sequencer(slots, xs, outs, shape, device=device)
