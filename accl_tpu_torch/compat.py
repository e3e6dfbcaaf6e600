"""Capability probes of the port (its own copy of the probe pattern in
``accl_tpu/compat.py``).

:func:`has_kernels` answers whether the hand-written kernels really run
here: it builds ``csrc/probe.cu`` (row 19), launches its copy kernel on
one (8, 128) float32 block on the current CUDA device and holds the copy
against its input.  Presence of a card or of ``nvcc`` is not evidence; a
launch that returns the input is.  The probe runs once per process and
its answer is cached; :func:`kernels_reason` says why it is False ('' when
it is True).  There is no fallback behind it: ``chip_smoke.py`` fails with
the reason, and only the tests that need the card skip with it.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

_lock = threading.Lock()
_probe: Optional[Tuple[bool, str]] = None


def _probe_kernels() -> Tuple[bool, str]:
    """(ok, reason) for the kernel tier on this machine."""
    import torch

    if not torch.cuda.is_available():
        return False, "no CUDA device is available"
    from .ops.cuda.probe import probe_copy

    try:
        x = torch.arange(8 * 128, dtype=torch.float32,
                         device="cuda").reshape(8, 128) * 0.5 - 7.0
        out = probe_copy(x)
        torch.cuda.synchronize()
    except Exception as e:  # no nvcc, a failed build, load or launch
        return False, (f"the probe kernel (csrc/probe.cu) did not run: "
                       f"{type(e).__name__}: {e}"[:600])
    if not torch.equal(out, x):
        return False, "the probe kernel ran but its copy differs from its input"
    return True, ""


def _probed() -> Tuple[bool, str]:
    global _probe
    with _lock:
        if _probe is None:
            _probe = _probe_kernels()
        return _probe


def has_kernels() -> bool:
    """True when a kernel of this package builds, loads and RUNS on the
    current CUDA device (probed once, cached)."""
    return _probed()[0]


def kernels_reason() -> str:
    """Why :func:`has_kernels` is False ('' when it is True)."""
    return _probed()[1]
