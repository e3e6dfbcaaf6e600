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
register write, disarming) clears the store, but for an elastic join's
cutover: it re-epochs the communicators without changing the wire, so the
survivors' residuals migrate to the new epoch lazily, each at its key's
first use after the cutover (:meth:`ResidualStore.migrate_epoch`).
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
#: pending epoch migrations kept before the store clears wholesale
MAX_MIGRATIONS = 64


class ResidualStore:
    """Per-key compression-residual accumulators.  :meth:`apply` is the
    whole protocol: add the carried residual into the contribution,
    round the sum through the wire codec, store the new residual, return
    what to send."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, torch.Tensor] = {}
        # (comm id, new epoch) -> (comm id, old epoch): the join
        # cutovers' lazy re-keys
        self._migrations: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.migrations = 0
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
            if r is None and self._migrations:
                # a join re-epoched the comm: walk the chain of mappings
                # (joins before this key's first use compose) and move
                # the residual under the new key once
                src = self._migrations.get((key[0], key[1]))
                seen = set()
                while src is not None and src not in seen:
                    seen.add(src)
                    old_key = src + key[2:]
                    r = self._entries.pop(old_key, None)
                    if r is not None:
                        self._entries[key] = r
                        self.migrations += 1
                        break
                    src = self._migrations.get(src)
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

    def migrate_epoch(self, comm_id: int, old_epoch: int,
                      new_epoch: int) -> None:
        """``comm_id``'s residuals continue under ``new_epoch`` (a join
        re-epoched it without changing the wire): each key re-keys at
        its first :meth:`apply` after the cutover.  Past
        :data:`MAX_MIGRATIONS` pending mappings everything clears."""
        with self._lock:
            if len(self._migrations) >= MAX_MIGRATIONS:
                self._entries.clear()
                self._migrations.clear()
                return
            if int(old_epoch) != int(new_epoch):
                self._migrations[(int(comm_id), int(new_epoch))] = (
                    int(comm_id), int(old_epoch))

    def invalidate(self, reason: str = "") -> None:
        """Drop every residual (register writes, disarming, soft_reset,
        a shrink: anything that may change the wire verdict a key's calls
        ride); a ``membership_join`` keeps the residuals that have a
        pending migration."""
        with self._lock:
            if not (reason.startswith("membership_join")
                    and self._migrations):
                self._entries.clear()
                self._migrations.clear()
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
                "migrations": self.migrations,
                "pending_migrations": len(self._migrations),
            }
        norms = [float(torch.linalg.vector_norm(r.double())) for r in entries]
        out["max_residual_norm"] = round(max(norms, default=0.0), 6)
        return out
