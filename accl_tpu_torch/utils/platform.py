"""Platform selection (the counterpart of ``accl_tpu/utils/platform.py``).

JAX's entry points mirror ``JAX_PLATFORMS`` into ``jax.config`` before
their first backend use.  The port has no global backend to configure:
every entry point takes a ``device`` and resolves it by
``ops/driver.py::resolve_device``'s rule.  So here "applying" a platform
string means resolving it by that rule, and nothing global changes.
"""

from __future__ import annotations

import os
from typing import Optional

from ..ops.driver import resolve_device

#: the platform names JAX's ``JAX_PLATFORMS`` takes for the card
_GPU_NAMES = ("gpu", "cuda")


def mirror_platform_env(explicit: Optional[str] = None) -> Optional[str]:
    """Resolve ``explicit`` (or the ``JAX_PLATFORMS`` env var): ``"cpu"``
    gives the CPU, ``"gpu"`` or ``"cuda"`` the current CUDA device (raising
    when there is none), any other platform raises ``ValueError``.  Returns
    the platform string applied, or None if nothing was requested.  No
    global default device changes."""
    platform = explicit or os.environ.get("JAX_PLATFORMS")
    if not platform:
        return None
    name = platform.strip().lower()
    if name == "cpu":
        resolve_device("cpu")
    elif name in _GPU_NAMES:
        resolve_device("cuda")
    else:
        raise ValueError(
            f"platform {platform!r}: the port runs on 'cpu' or 'gpu' "
            f"('cuda')")
    return platform
