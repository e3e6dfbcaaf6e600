"""K4: the fused elementwise combine — the ``reduce_ops`` plugin.

The counterpart of ``accl_tpu/ops/pallas/combine.py``.  The kernel is
``csrc/combine.cu``; :func:`combine_plain` is its plain PyTorch version,
which CPU tensors take and the card's checks compare against.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...arithconfig import reduce_op
from ...constants import ReduceFunction, torch_to_dtype
from . import _build
from ._build import INT, LL, PTR
from ._common import LaunchCounter, check_launch, on_cuda, stream_of

#: ``csrc/combine.cu``'s C prototypes (declared once, at load)
PROTOTYPES = {"combine": {
    "accl_combine": (PTR, PTR, PTR, LL, INT, INT, INT, INT, PTR)}}


def combine_plain(a: torch.Tensor, b: torch.Tensor,
                  function: ReduceFunction = ReduceFunction.SUM,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``function(a, b)`` in ``a``'s dtype, then cast to ``out_dtype``."""
    out = reduce_op(function)(a, b)
    return out if out_dtype is None else out.to(out_dtype)


def combine(
    a: torch.Tensor,
    b: torch.Tensor,
    function: ReduceFunction = ReduceFunction.SUM,
    out_dtype: Optional[torch.dtype] = None,
    *,
    accumulate: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``function(a, b).astype(out_dtype)`` for any shape — ref
    ``ACCL::combine`` executed by the reduce_ops lane.

    ``accumulate=True`` is the in-place form: the result is written into
    ``a`` itself (``a <- f(a, b)``) and ``a`` is returned.  ``out`` names
    another tensor to write into (same shape, contiguous, of
    ``out_dtype``)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError("combine operands must match in shape and dtype")
    reduce_op(function)  # validates the function
    out_dtype = out_dtype or a.dtype
    if accumulate:
        if out_dtype != a.dtype:
            raise ValueError("accumulate=True requires out_dtype == a.dtype")
        if out is not None or not a.is_contiguous():
            raise ValueError("accumulate=True writes into a contiguous a")
        out = a
    if out is not None and (
        out.shape != a.shape or out.dtype != out_dtype
        or not out.is_contiguous()
    ):
        raise ValueError("combine out must match a's shape and out_dtype")
    tensors = [a, b] if out is None else [a, b, out]
    if not on_cuda(tensors):
        res = combine_plain(a, b, function, out_dtype)
        if out is None:
            return res
        out.copy_(res)
        return out
    a, b = a.contiguous(), b.contiguous()
    if out is None:
        out = torch.empty(a.shape, dtype=out_dtype, device=a.device)
    n = a.numel()
    if n == 0:
        return out
    lib = _build.library("combine", PROTOTYPES["combine"])
    pa, pb, po = a.data_ptr(), b.data_ptr(), out.data_ptr()
    rc = lib.accl_combine(
        pa, pb, po, n, int(torch_to_dtype(a.dtype)),
        int(torch_to_dtype(out_dtype)), int(function),
        int(not (pa | pb | po) % 16), stream_of(a.device),
    )
    check_launch(lib, rc, "combine")
    combine.launches.bump()
    return out


combine.launches = LaunchCounter()
