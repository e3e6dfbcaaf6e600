"""Error-feedback accounting for the compressed (quantized-wire) allreduce.

The port's copy of ``accl_tpu/errorfeedback.py``.  A wire lane that
rounds every gradient contribution to 8 bits throws information away each
step; error feedback carries the per-element compression error forward
and adds it back into the next contribution before compressing:

    x_eff     = grad + residual
    wire      = compress(x_eff)
    residual' = x_eff - decompress(wire)

so the error the wire drops this step re-enters the sum the next.

:class:`ResidualStore` keeps one residual per key (the facade's ``(comm
id, comm epoch, op, count, segment, link class)``).  Residuals are
tensors on the operand's device, and the roundtrip is the device wire
codec (:mod:`accl_tpu_torch.ops.wire`: the compression kernels on the
card) with the call's per-rank seed, byte for byte what the numpy codec
gives.  Every event that may change the wire a key's calls ride (a
register write, disarming) clears the store.  The JAX store's epoch
migration serves elastic membership cutovers, which the port does not
have.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from .ops.wire import wire_lane_roundtrip

__all__ = ["ResidualStore"]

#: entry cap: clearing wholesale past it is correct (zeros are always a
#: safe residual)
DEFAULT_MAX_ENTRIES = 64


class ResidualStore:
    """Per-key compression-residual accumulators.  :meth:`apply` is the
    whole protocol: add the carried residual into the contribution,
    round the sum through the wire codec, store the new residual, return
    what to send."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, torch.Tensor] = {}
        self.updates = 0
        self.invalidations = 0
        self.last_invalidation: Optional[str] = None

    def apply(self, key: Tuple, x: torch.Tensor, wire_dtype,
              seed: int = 0) -> torch.Tensor:
        """One error-feedback step for contribution ``x`` (a 1-D float
        tensor): returns ``x + residual``, the tensor to dispatch.  A
        change of shape, dtype or device within the key restarts the
        residual at zeros."""
        with self._lock:
            r = self._entries.get(key)
        if r is not None and (r.shape != x.shape or r.dtype != x.dtype
                              or r.device != x.device):
            r = None
        x_eff = x + r if r is not None else x.clone()
        new_r = x_eff - wire_lane_roundtrip(x_eff, wire_dtype, seed)
        with self._lock:
            if (len(self._entries) >= self.max_entries
                    and key not in self._entries):
                self._entries.clear()
            self._entries[key] = new_r
            self.updates += 1
        return x_eff

    def residual(self, key: Tuple) -> Optional[torch.Tensor]:
        """The carried residual for a key (a copy)."""
        with self._lock:
            r = self._entries.get(key)
        return None if r is None else r.clone()

    def invalidate(self, reason: str = "") -> None:
        """Drop every residual (register writes, disarming: anything that
        may change the wire verdict a key's calls ride)."""
        with self._lock:
            self._entries.clear()
            self.invalidations += 1
            self.last_invalidation = reason or None

    def stats(self) -> dict:
        """Counters and the largest residual's L2 norm (the convergence
        health signal: a norm that grows without bound means the lane is
        too aggressive for the workload)."""
        with self._lock:
            entries = list(self._entries.values())
            out = {
                "entries": len(entries),
                "updates": self.updates,
                "invalidations": self.invalidations,
                "last_invalidation": self.last_invalidation,
            }
        norms = [float(torch.linalg.vector_norm(r.double())) for r in entries]
        out["max_residual_norm"] = round(max(norms, default=0.0), 6)
        return out
