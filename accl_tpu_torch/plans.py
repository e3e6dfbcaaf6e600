"""Collective call plans: the cached per-call dispatch state.

The port's own copy of ``accl_tpu/plans.py``.  The facade resolves a
collective's plan once per ``(op, communicator id + epoch, dtype, size
bucket, options fingerprint)`` -- arithmetic config, compression flags,
the ``wire_dtype`` verdict, the algorithm snapshot -- so a warm call goes
pool lookup -> dispatch instead of re-deriving it in Python on every
call.  The plan's ``engine`` slot holds the gang's prepared state (the
call template and the resolved lowering with its pointer tables, by
operand width), so the warm path skips the engine's re-validation and
register look-ups too.

Invalidation: ``set_tuning`` clears the whole pool (a register write may
change the lowering or the wire); a communicator epoch change re-keys
naturally (the epoch is part of the key), so a re-created same-id
sub-communicator never reuses a stale plan.  Hit / miss / invalidation
counters surface through ``ACCL.capabilities()["plan_cache"]`` beside
``device_interactions``.  Imports nothing but the standard library.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

__all__ = ["CollectivePlan", "PlanCache", "size_bucket"]


def size_bucket(count: int) -> int:
    """Power-of-two bucket of an element count: ``floor(log2(count))``
    (0 for counts <= 1).  Counts in ``[2^k, 2^(k+1))`` share a plan —
    the same bucketing the dist tier's wire shapes ride, so one plan
    covers one compiled wire shape.  SPMD-uniform by contract: plan
    keys (and so register overlays) must bucket identically on every
    rank or protocol choices diverge across the mesh."""
    return max(0, int(count).bit_length() - 1)


class CollectivePlan:
    """Everything the facade resolves per collective call, snapshotted.

    Immutable by convention once stored (engines only write the
    ``engine`` slot, which is keyed/invalidated independently via the
    engine's own epoch counters)."""

    __slots__ = (
        "key", "arithcfg", "compression", "wire_dtype", "bucket",
        "eager", "algorithm", "tuning", "engine",
        "pipeline_threshold", "pipeline_segments", "cmdring_slot",
        "hierarchical", "link_class",
    )

    def __init__(self, key, arithcfg, compression, wire_dtype, bucket,
                 eager, algorithm, tuning=None,
                 pipeline_threshold=0, pipeline_segments=1,
                 hierarchical=False, link_class=None):
        self.key = key
        self.arithcfg = arithcfg          # resolved ArithConfig
        self.compression = compression    # CompressionFlags
        self.wire_dtype = wire_dtype      # DataType on the wire (or None)
        self.bucket = bucket              # power-of-two size bucket (log2)
        self.eager = eager               # bucket-wide protocol verdict:
        #   True/False when the whole bucket is eager/rendezvous, None
        #   when the threshold falls inside the bucket (engines always
        #   re-derive per call; this is the introspection snapshot)
        self.algorithm = algorithm        # register snapshot at plan time
        self.tuning = tuning              # per-bucket register overlay
        self.engine: Dict[str, Any] = {}  # engine-private prepared state
        # overlap plane: the segmented-pipelining verdict for this plan's
        # (op, bucket) — payloads above pipeline_threshold bytes split
        # into pipeline_segments sub-launches (0 / <=1 disables).  Cached
        # here so the warm path never re-reads engine registers.
        self.pipeline_threshold = int(pipeline_threshold or 0)
        self.pipeline_segments = int(pipeline_segments or 1)
        # topology plane: the hierarchical-dispatch verdict for this
        # plan's (op, bucket, topology) — True routes the call through
        # the facade's slice/cross-slice decomposition — and the comm's
        # uniform LinkClass (or None when classes mix), the axis the
        # per-class wire verdict was resolved against.  Both cached so
        # the warm path never re-reads registers or the slice table.
        self.hierarchical = bool(hierarchical)
        self.link_class = link_class
        # command-ring plane: the plan -> slot encoding, cached by the
        # gang engine on first ring-resident dispatch (an int32 word
        # template from accl_tpu_torch.cmdring.encode_slot covering the FULL
        # opcode space; per-call fields — seqn/count/root/peer/function/
        # wire — are patched at refill).  Opaque here: this module
        # stays standard-library only.
        self.cmdring_slot = None

    def pipeline_for(self, nbytes: int) -> int:
        """Sub-launch count for a payload of ``nbytes``: the cached
        segment count when host-level pipelining applies, else 1."""
        if (
            self.pipeline_segments > 1
            and self.pipeline_threshold > 0
            and nbytes > self.pipeline_threshold
        ):
            return self.pipeline_segments
        return 1

    @property
    def fuse(self) -> int:
        """FusedCompute value folded into this plan's key extra tuple
        (0 = plain collective).  The facade keys fused calls separately
        from their plain base op, so a fused plan's cached
        ``cmdring_slot`` template carries the FUSED opcode and is never
        shared with the plain shape's template."""
        extra = self.key[-1] if self.key else ()
        try:
            i = extra.index("fuse")
            return int(extra[i + 1])
        except (AttributeError, ValueError, IndexError, TypeError):
            return 0

    def describe(self) -> dict:
        """Introspection form (tests / debug dumps)."""
        return {
            "key": self.key,
            "bucket": self.bucket,
            "wire_dtype": getattr(self.wire_dtype, "name", None),
            "eager": self.eager,
            "algorithm": self.algorithm,
            "tuning": dict(self.tuning) if self.tuning else None,
            "pipeline_threshold": self.pipeline_threshold,
            "pipeline_segments": self.pipeline_segments,
            "cmdring_slot_cached": self.cmdring_slot is not None,
            "fuse": self.fuse,
            "hierarchical": self.hierarchical,
            "link_class": getattr(self.link_class, "name", None),
        }


class PlanCache:
    """Bounded pool of :class:`CollectivePlan`, with honest counters.

    Thread-safe: rank handles are commonly driven from per-rank threads
    (the test harness) and plans may be built concurrently.  On capacity
    the pool is cleared wholesale — plans are cheap to rebuild and the
    bound only guards pathological key churn (epoch-heavy soaks)."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = int(maxsize)
        self._plans: Dict[Tuple, CollectivePlan] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.last_invalidation: Optional[str] = None
        # warm-handoff bookkeeping (elastic expansion): the verdict
        # digest adopted at admission, kept for introspection only
        self._handoff_seed: list = []
        self.handoffs_adopted = 0
        # companion-state invalidation hooks: state that lives BESIDE
        # the plan cache with the plan cache's lifecycle (the error-
        # feedback residual store) registers here so every invalidation
        # site clears it too — one lifecycle, not N call sites
        self._hooks: list = []

    def add_invalidation_hook(self, fn) -> None:
        """Call ``fn(reason)`` on every :meth:`invalidate` — for state
        whose validity is coupled to the cached plans (e.g. compression
        residuals accumulated under a plan's wire verdict)."""
        self._hooks.append(fn)

    # -- lookup / store ------------------------------------------------------
    def get(self, key: Tuple) -> Optional[CollectivePlan]:
        return self.get_with_flag(key)[0]

    def get_with_flag(self, key: Tuple):
        """(plan, hit): the lookup plus its verdict in one locked step —
        the per-call ``plan_hit`` fact the telemetry flight recorder
        stamps on every CallRecord (reading the counters before/after
        would race concurrent rank threads)."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                self.misses += 1
            else:
                self.hits += 1
            return plan, plan is not None

    def store(self, plan: CollectivePlan) -> CollectivePlan:
        with self._lock:
            if len(self._plans) >= self.maxsize and plan.key not in self._plans:
                self._plans.clear()
            self._plans[plan.key] = plan
            return plan

    # -- invalidation --------------------------------------------------------
    def invalidate(self, reason: str = "") -> None:
        """Drop every plan (register writes / soft reset: anything built
        before the event may embed stale algorithm choices or engine
        state)."""
        with self._lock:
            self._plans.clear()
            self.invalidations += 1
            self.last_invalidation = reason or None
            hooks = list(self._hooks)
        for fn in hooks:  # outside the lock: hooks take their own
            try:
                fn(reason)
            except Exception:  # pragma: no cover - must not fail config
                pass

    # -- warm handoff (elastic expansion) ------------------------------------
    def export_verdicts(self, limit: int = 32) -> list:
        """The tuned-verdict digest a JOIN handoff carries: the cached
        plans' ``describe()`` dicts (bounded, deterministic order).
        Plans embed engine state (cmdring slots, buffer geometry) that
        does NOT transfer — the admitted rank rebuilds its own plans —
        so this is *seed context*, not a cache transplant: the verdicts
        tell the joiner what wire/eager/pipeline decisions its first
        window will meet, keeping it contract-conformant without a
        warm-up divergence."""
        with self._lock:
            plans = [
                self._plans[k].describe()
                for k in sorted(self._plans, key=repr)
            ]
        return plans[: max(0, int(limit))]

    def adopt_verdicts(self, verdicts) -> int:
        """Record a handoff's verdict digest (the admitted rank's side).
        Nothing is installed into the cache — keys embed live engine
        state — but the seed is retained for introspection and counted,
        so tests and the snapshot can assert the warm handoff actually
        rode the admission."""
        seed = [dict(v) for v in (verdicts or []) if isinstance(v, dict)]
        with self._lock:
            self._handoff_seed = seed
            self.handoffs_adopted += 1
        return len(seed)

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> dict:
        """The ``capabilities()["plan_cache"]`` report."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "size": len(self._plans),
                "invalidations": self.invalidations,
                "last_invalidation": self.last_invalidation,
                "handoffs_adopted": self.handoffs_adopted,
                "handoff_seed_verdicts": len(self._handoff_seed),
            }
