"""Row 12: the all-to-all block transpose across P ranks.

The counterpart of ``accl_tpu/ops/pallas/alltoall.py::alltoall`` (:82):
rank r's output block p is rank p's input block r, the blocks cut along
the leading dim.  JAX runs it inside ``shard_map``, one kernel per rank
behind a global barrier, each issuing P - 1 one-sided remote writes;
here every rank's operand lies on one device and ONE launch of
``csrc/alltoall.cu`` copies every (source rank, block) pair through a
pointer table.  :func:`alltoall_plain` is the plain version (a stack of
each rank's blocks); CPU tensors take it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import _build
from ._build import INT, LL, PTR
from ._common import (
    LaunchCounter,
    MAX_RANKS,
    aligned16,
    check_launch,
    on_cuda,
    pointer_table,
    pointers,
    stream_of,
)

#: ``csrc/alltoall.cu``'s C prototypes (declared once, at load)
PROTOTYPES = {"alltoall": {
    "accl_alltoall": (PTR, PTR, INT, LL, INT, INT, PTR)}}


def _check(xs: Sequence[torch.Tensor]) -> int:
    """The TPU entry's checks (:99-102) over the ranks' operands: one
    shape and dtype, the leading dim divisible by P.  Returns P."""
    P = len(xs)
    if not 1 <= P <= MAX_RANKS:
        raise ValueError(f"alltoall: {P} ranks (1..{MAX_RANKS})")
    x0 = xs[0]
    if x0.dim() == 0:
        raise ValueError("alltoall operands need a leading dim")
    if any(x.shape != x0.shape or x.dtype != x0.dtype for x in xs):
        raise ValueError("alltoall operands must match in shape and dtype")
    if x0.shape[0] % P:
        raise ValueError(
            f"leading dim {x0.shape[0]} not divisible by axis size {P}")
    return P


def alltoall_plain(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """What the kernel computes, in plain PyTorch: rank r gets the stack
    of every rank's block r.  With P = 1, the input."""
    P = _check(xs)
    if P == 1:
        return list(xs)
    blocks = [x.reshape(P, -1) for x in xs]
    return [torch.stack([b[r] for b in blocks]).reshape(xs[0].shape)
            for r in range(P)]


def alltoall(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Block transpose across the ranks (row 12): ``xs`` holds P operands
    of one shape ``(P * b, ...)`` and dtype, one per rank; returns P new
    tensors, rank r's block p being rank p's block r.  With P = 1 the
    input itself (as the TPU entry returns ``x``).

    CPU tensors take :func:`alltoall_plain`.  CUDA tensors launch the
    kernel once (any dtype: the elements' bits are copied) or raise."""
    P = _check(xs)
    if P == 1:
        return list(xs)
    xs = [x.contiguous() for x in xs]
    if not on_cuda(xs):
        return alltoall_plain(xs)
    outs = [torch.empty_like(x) for x in xs]
    m = xs[0].numel() // P
    if m:
        itemsize = xs[0].element_size()
        pin, pout = pointers(xs), pointers(outs)
        vec = aligned16(pin + pout) and (m * itemsize) % 16 == 0
        lib = _build.library("alltoall", PROTOTYPES["alltoall"])
        rc = lib.accl_alltoall(
            pointer_table(pin), pointer_table(pout), P, m, itemsize,
            int(vec), stream_of(xs[0].device),
        )
        check_launch(lib, rc, "alltoall")
        alltoall.launches.bump()
    return outs


alltoall.launches = LaunchCounter()
