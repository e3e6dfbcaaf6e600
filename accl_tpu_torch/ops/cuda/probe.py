"""Row 19: the kernel-load probe's copy kernel.

The counterpart of the copy kernel ``k`` inside
``accl_tpu/compat.py::_probe_interpret_params``: a copy of one (8, 128)
float32 block whose only job is to show that a kernel of this package
builds, loads and runs here (``accl_tpu_torch.compat`` holds the copy
against its input).  The kernel is ``csrc/probe.cu``;
:func:`probe_copy_plain` is its plain version, which CPU tensors take.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import LL, PTR
from ._common import LaunchCounter, check_launch, on_cuda, stream_of

#: ``csrc/probe.cu``'s C prototypes (declared once, at load)
PROTOTYPES = {"probe": {"accl_probe_copy": (PTR, PTR, LL, PTR)}}


def probe_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x``."""
    return x.clone()


def probe_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of a contiguous float32 tensor (row 19)."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe_copy takes a contiguous float32 tensor")
    if not on_cuda([x]):
        return probe_copy_plain(x)
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        lib = _build.library("probe", PROTOTYPES["probe"])
        rc = lib.accl_probe_copy(x.data_ptr(), out.data_ptr(), n,
                                 stream_of(x.device))
        check_launch(lib, rc, "probe_copy")
        probe_copy.launches.bump()
    return out


probe_copy.launches = LaunchCounter()
