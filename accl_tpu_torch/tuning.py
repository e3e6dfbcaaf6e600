"""Measurement-driven collective autotuning: the port's own copy of
``accl_tpu/tuning.py``.

* the measurement harness (:func:`post_rank_op` / :func:`rank_op` /
  :func:`run_group_op`): one synchronized collective run across a
  group of rank handles;
* :func:`autotune`: races candidate register sets (algorithm x
  ``ring_segments`` x pipelining x wire lanes x the command ring's
  posture x hierarchical, tier-appropriate) per (collective, size) and
  returns a :class:`TuningPlan`;
* :class:`TuningPlan`: per-size-bucket register winners with their
  provenance, as JSON; :meth:`ACCL.load_tuning_plan` or the
  ``ACCL_TUNING_PLAN`` env adopts one.  The JSON keys and register
  names are the JAX package's, so a plan written by either package
  loads in the other.

The port's gang engine (``CudaEngine``) is the ``cuda`` tier, raced as
JAX's device tier: ``include_pallas`` races the hand-written kernels
(K1's two forms, the rooted relays and K3's root-only gather) against
the plain lowerings, and the command ring's posture axes are included.

CLI: ``python -m accl_tpu_torch.tuning --world 4 --out plan.json`` (on
the card; ``--backend cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .constants import (
    AllreduceAlgorithm,
    CMDRING_MAX_RUN_WINDOWS,
    DataType,
    EAGER_THRESHOLD_DEFAULT,
    MAX_EAGER_SIZE_LIMIT,
    ROOTED_ALGORITHMS,
    TUNING_DEFAULTS,
    TUNING_KEY_NAMES,
    WIRE_LANE_DTYPES,
)
from .hierarchical import HIER_OPS, multi_slice
from .plans import size_bucket

#: env var naming a TuningPlan JSON file; loaded (non-strict) by every
#: ACCL handle at construction, so one-process-per-rank tiers inherit it
TUNING_PLAN_ENV = "ACCL_TUNING_PLAN"

#: the nine facade collectives the harness can drive
COLLECTIVES = [
    "sendrecv",
    "bcast",
    "scatter",
    "gather",
    "allgather",
    "reduce",
    "reduce_scatter",
    "allreduce",
    "alltoall",
]

#: register names a plan may carry: the engine tuning tables' names plus
#: the eager-protocol threshold (applied via SET_MAX_EAGER_SIZE)
VALID_REGISTERS = frozenset(TUNING_KEY_NAMES.values()) | {"max_eager_size"}

#: algorithm-select registers (string values from AllreduceAlgorithm)
_ALGO_REGISTERS = frozenset(
    n for n in TUNING_KEY_NAMES.values() if n.endswith("_algorithm")
)


def wire_dtype_value(val) -> int:
    """Normalize a wire-dtype register value to its DataType int: 0 /
    "off" disables; DataType member names ("INT8", "float8_e4m3") and
    numpy lane names ("float8_e4m3fn", "int8") both resolve — plan
    files should be writable by humans."""
    if isinstance(val, str):
        name = val.strip().lower()
        if name in ("", "0", "off", "none"):
            return 0
        for member, np_name in WIRE_LANE_DTYPES.items():
            if name in (member.lower(), np_name.lower()):
                return int(DataType[member])
        raise ValueError(
            f"unknown wire dtype {val!r}; valid: off, "
            f"{sorted(n.lower() for n in WIRE_LANE_DTYPES)}"
        )
    ival = int(val)
    if ival != 0 and DataType(ival).name not in WIRE_LANE_DTYPES:
        raise ValueError(
            f"wire_dtype {ival} ({DataType(ival).name}) is not a "
            f"registered wire lane ({sorted(WIRE_LANE_DTYPES)})"
        )
    return ival

#: the full restoration state: every register the autotuner may touch,
#: at its engine default (the port's table already holds the algorithm
#: registers and ring_segments)
REGISTER_DEFAULTS = dict(
    TUNING_DEFAULTS,
    max_eager_size=EAGER_THRESHOLD_DEFAULT,
)


def validate_registers(regs: Dict[str, object]) -> Dict[str, object]:
    """Reject unknown register names / malformed algorithm values before
    they reach an engine (a stale plan file must fail loudly at load, not
    as a CONFIG_ERROR mid-collective)."""
    out: Dict[str, object] = {}
    for name, val in (regs or {}).items():
        if name not in VALID_REGISTERS:
            raise ValueError(
                f"unknown tuning register {name!r}; valid: "
                f"{sorted(VALID_REGISTERS)}"
            )
        if name in _ALGO_REGISTERS:
            if isinstance(val, str):
                try:
                    algo = AllreduceAlgorithm[val.upper()]
                except KeyError:
                    raise ValueError(
                        f"register {name}: unknown algorithm {val!r}"
                    ) from None
            else:
                algo = AllreduceAlgorithm(int(val))
            if name != "allreduce_algorithm" and algo not in ROOTED_ALGORITHMS:
                # same rule the engines enforce at SET_TUNING: no
                # ppermute-ring/bidir form exists for rooted collectives
                # — fail at plan load, not as CONFIG_ERROR mid-apply (or
                # worse, a silent xla fallback on the overlay path)
                raise ValueError(
                    f"register {name}: {algo.name.lower()!r} is not a "
                    "rooted lowering (valid: "
                    f"{[a.name.lower() for a in ROOTED_ALGORITHMS]})"
                )
            val = algo.name.lower()
        elif name in ("wire_dtype", "wire_dtype_ici", "wire_dtype_dcn"):
            # the per-link-class lanes validate exactly like the generic
            # register: 0 on a per-class lane means "defer to wire_dtype",
            # not "uncompressed" — the facade's resolution order
            try:
                val = wire_dtype_value(val)
            except ValueError as e:
                raise ValueError(f"register {name}: {e}") from None
        elif name == "hierarchical":
            val = int(val)
            if val not in (0, 1):
                # same bound the engines enforce at SET_TUNING
                raise ValueError(f"register {name}: {val} not in (0, 1)")
        else:
            val = int(val)
            if val < 0:
                raise ValueError(f"register {name}: negative value {val}")
            # engine-parity bounds, enforced at load: the overlay path
            # bypasses SET_TUNING validation entirely, and a defaults
            # value the engine would CONFIG_ERROR must not half-apply
            if name == "max_eager_size" and not (
                0 < val <= MAX_EAGER_SIZE_LIMIT
            ):
                raise ValueError(
                    f"register {name}: {val} outside "
                    f"(0, {MAX_EAGER_SIZE_LIMIT}]"
                )
            if name in ("ring_segments", "gather_flat_tree_max_fanin") \
                    and val < 1:
                raise ValueError(f"register {name}: {val} < 1")
            # persistent-sequencer posture registers: the same clamps
            # the engines enforce at SET_TUNING (an unbounded run /
            # >1s linger would pin the device stream)
            if name == "cmdring_run_windows" and val > CMDRING_MAX_RUN_WINDOWS:
                raise ValueError(
                    f"register {name}: {val} > {CMDRING_MAX_RUN_WINDOWS}"
                )
            if name == "cmdring_linger_us" and val > 1_000_000:
                raise ValueError(
                    f"register {name}: {val} > 1000000 (1s)"
                )
        out[name] = val
    return out


# ---------------------------------------------------------------------------
# TuningPlan: the serializable measurement artifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TuningPlan:
    """Per-(collective, size bucket) register selections with provenance.

    ``entries[collective][bucket]`` is ``{"registers": {...},
    "measured_ns": float, "candidates": {label: ns}}`` — ``registers``
    holds only the overrides vs ``defaults`` (empty = the defaults won).
    Buckets are ``floor(log2(element count))`` (see
    :func:`accl_tpu_torch.plans.size_bucket`)."""

    world: int
    tier: str
    defaults: Dict[str, object] = dataclasses.field(default_factory=dict)
    entries: Dict[str, Dict[int, dict]] = dataclasses.field(
        default_factory=dict
    )
    provenance: Dict[str, object] = dataclasses.field(default_factory=dict)
    version: int = 1
    #: link-class layout the race ran under: a Topology signature string
    #: (e.g. "2x4"), or None for a flat/unclassified group.  Load-time
    #: provenance, not a register: `ACCL.load_tuning_plan` refuses a
    #: plan raced on a different layout — a hierarchical/per-class-wire
    #: winner is only meaningful on the topology it was measured on.
    topology: Optional[str] = None

    # -- dispatch-side lookup ------------------------------------------------
    def registers_for(self, collective: str, bucket: int) -> Dict[str, object]:
        """Register overrides for a collective at a size bucket; the
        nearest measured bucket answers for unmeasured sizes (clamping —
        a 2^20 call uses the 2^19 winner when the sweep stopped there)."""
        per_op = self.entries.get(collective)
        if not per_op:
            return {}
        if bucket in per_op:
            return dict(per_op[bucket].get("registers") or {})
        nearest = min(per_op, key=lambda b: (abs(b - bucket), b))
        return dict(per_op[nearest].get("registers") or {})

    # -- serialization -------------------------------------------------------
    def to_json(self) -> str:
        doc = {
            "version": self.version,
            "world": self.world,
            "tier": self.tier,
            "defaults": self.defaults,
            "entries": {
                op: {str(b): e for b, e in per_op.items()}
                for op, per_op in self.entries.items()
            },
            "provenance": self.provenance,
            "topology": self.topology,
        }
        return json.dumps(doc, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TuningPlan":
        doc = json.loads(text)
        entries: Dict[str, Dict[int, dict]] = {}
        for op, per_op in (doc.get("entries") or {}).items():
            entries[op] = {}
            for b, e in per_op.items():
                e = dict(e)
                e["registers"] = validate_registers(e.get("registers") or {})
                entries[op][int(b)] = e
        return cls(
            world=int(doc.get("world", 0)),
            tier=str(doc.get("tier", "")),
            defaults=validate_registers(doc.get("defaults") or {}),
            entries=entries,
            provenance=dict(doc.get("provenance") or {}),
            version=int(doc.get("version", 1)),
            topology=(
                None if doc.get("topology") is None
                else str(doc["topology"])
            ),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "TuningPlan":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Measurement harness
# ---------------------------------------------------------------------------


def _rank_buffers(accl, world: int, op: str, n: int, rank: int):
    """One rank's operand and result buffers for one run of ``op``
    (made before the timed window)."""
    ones, empty = (lambda k: accl.create_buffer_from(np.ones(k, np.float32)),
                   lambda k: accl.create_buffer(k, np.float32))
    if op == "sendrecv":
        if rank == 0:
            return (ones(n),)
        return (empty(n),) if rank == 1 else None
    if op == "bcast":
        return (ones(n),)
    if op in ("scatter", "reduce_scatter"):
        return ones(world * n), empty(n)
    if op in ("gather", "allgather"):
        return ones(n), empty(world * n)
    if op in ("reduce", "allreduce"):
        return ones(n), empty(n)
    if op == "alltoall":
        return ones(world * n), empty(world * n)
    raise ValueError(op)


def _rank_call(accl, rank: int, op: str, n: int, bufs):
    """Post one rank's side of ``op`` on its buffers asynchronously."""
    if op == "sendrecv":
        if rank == 0:
            return accl.send(bufs[0], n, dst=1, tag=0, run_async=True)
        return accl.recv(bufs[0], n, src=0, tag=0, run_async=True)
    if op == "bcast":
        return accl.bcast(bufs[0], n, root=0, run_async=True)
    if op in ("scatter", "gather", "reduce"):
        return getattr(accl, op)(bufs[0], bufs[1], n, root=0,
                                 run_async=True)
    return getattr(accl, op)(bufs[0], bufs[1], n, run_async=True)


def post_rank_op(accl, rank: int, world: int, op: str, n: int):
    """Post one rank's side of one collective run asynchronously;
    returns the Request, or None when this rank does not participate."""
    bufs = _rank_buffers(accl, world, op, n, rank)
    if bufs is None:
        return None
    return _rank_call(accl, rank, op, n, bufs)


def rank_op(accl, rank: int, world: int, op: str, n: int):
    """One rank's side of one collective run, posted and waited; returns
    the engine-reported duration in ns (the launch's host time on this
    tier), or None when this rank does not participate."""
    req = post_rank_op(accl, rank, world, op, n)
    if req is None:
        return None
    assert req.wait(120), f"{op} count={n} rank={rank} timed out"
    req.check()
    return req.get_duration_ns()


def run_group_op(group, op: str, count: int) -> float:
    """One synchronized run across all rank handles, posted
    asynchronously from this one thread; returns its wall time in ns,
    from the first post to the last rank's device completion.  (JAX's
    harness takes the engines' reported durations; the port's requests
    complete when their device work is launched, so a duration would
    time the launch alone.)  Buffers are made before the clock starts."""
    world = len(group)
    bufs = [_rank_buffers(group[i], world, op, count, i)
            for i in range(world)]
    t0 = time.perf_counter_ns()
    reqs: List = []
    for i in range(world):
        if bufs[i] is not None:
            reqs.append((i, _rank_call(group[i], i, op, count, bufs[i])))
    for i, req in reqs:
        assert req.wait(120), f"{op} count={count} rank={i} timed out"
        req.check()
    return float(time.perf_counter_ns() - t0)


# ---------------------------------------------------------------------------
# The autotuner
# ---------------------------------------------------------------------------


def detect_tier(group) -> str:
    """Engine tier of a rank-handle group, by the engine's class name:
    the port's gang engine is ``cuda`` (JAX's names kept for the rest)."""
    name = type(group[0].engine).__name__
    return {
        "CudaEngine": "cuda",
        "EmuEngine": "emulator",
        "NativeEngine": "native",
        "XLAEngine": "xla",
        "DistEngine": "dist",
    }.get(name, name.lower())


#: tiers raced as JAX's device tiers (the port's gang is one)
_DEVICE_TIERS = ("xla", "dist", "cuda")


def _candidates(
    tier: str,
    op: str,
    world: int,
    include_pallas: bool,
    eager_candidates: Sequence[int],
    segments: Sequence[int],
    pipeline_thresholds: Sequence[int] = (),
    wire_dtypes: Sequence = (),
    cmdring_run_windows: Sequence[int] = (),
    cmdring_linger_us: Sequence[int] = (),
    race_hierarchical: bool = False,
    wire_dtypes_ici: Sequence = (),
    wire_dtypes_dcn: Sequence = (),
) -> List[Dict[str, object]]:
    """Tier-appropriate register sets to race for one collective.  The
    empty dict (the defaults) is always candidate 0 — a plan can only
    ever *beat* the defaults, never silently regress them.  The
    emulator / native lists are JAX's, kept so the candidate lists of
    the two packages compare."""
    cands: List[Dict[str, object]] = [{}]
    if tier in _DEVICE_TIERS:
        if op == "allreduce":
            cands += [
                {"allreduce_algorithm": "ring", "ring_segments": int(s)}
                for s in segments
            ]
            if include_pallas:
                cands += [
                    {"allreduce_algorithm": "pallas_ring",
                     "ring_segments": int(segments[0])},
                    {"allreduce_algorithm": "pallas_ring_bidir",
                     "ring_segments": int(segments[0])},
                ]
        elif op in ("bcast", "reduce", "scatter", "gather") and include_pallas:
            cands += [
                {f"{op}_algorithm": "pallas_ring", "ring_segments": int(s)}
                for s in segments
            ]
        if op in ("allreduce", "bcast"):
            # overlap plane axes: host-level segmented pipelining —
            # threshold x segment count (the split only fires above the
            # threshold, so small sizes race it as a no-op and the
            # hysteresis margin keeps the defaults)
            cands += [
                {"pipeline_threshold": int(t), "ring_segments": int(s)}
                for t in pipeline_thresholds
                for s in segments
                if int(s) > 1
            ]
    elif tier in ("emulator", "native"):
        if op == "bcast":
            cands += [
                {"bcast_flat_tree_max_ranks": 0},          # always tree
                {"bcast_flat_tree_max_ranks": 1 << 20},    # always flat
            ]
        elif op == "reduce":
            cands += [
                {"reduce_flat_tree_max_ranks": 0,
                 "reduce_flat_tree_max_count": 0},
                {"reduce_flat_tree_max_ranks": 1 << 20,
                 "reduce_flat_tree_max_count": 1 << 30},
            ]
        elif op == "gather":
            fanins = sorted({1, 2, max(1, world - 1)})
            cands += [{"gather_flat_tree_max_fanin": f} for f in fanins]
    if tier in _DEVICE_TIERS and op == "allreduce":
        # persistent-sequencer posture axes (command ring): the
        # run-window budget and mailbox linger raced per size bucket —
        # winners dispatch per plan key through the per-bucket overlay
        # (CallOptions.effective_tuning -> the gang ring's
        # _window_posture), so a hot training bucket can hold a long
        # resident run while cold buckets keep the env defaults
        cands += [
            {"cmdring_run_windows": int(rw)}
            for rw in cmdring_run_windows
            if 0 < int(rw) <= CMDRING_MAX_RUN_WINDOWS
        ]
        cands += [
            {"cmdring_linger_us": int(lu)}
            for lu in cmdring_linger_us
            if 0 < int(lu) <= 1_000_000
        ]
    if op == "allreduce":
        # quantized wire plane: per-bucket compression verdicts raced
        # like any register — off is always candidate 0 (the defaults),
        # so a lane only wins where the byte saving beats its cast cost
        # by the hysteresis margin (the wall-clock race; correctness is
        # gated separately by check_compression's convergence leg)
        cands += [
            {"wire_dtype": wire_dtype_value(wd)}
            for wd in wire_dtypes
            if wire_dtype_value(wd) != 0
        ]
        # per-link-class wire ladders: an ICI/DCN lane only resolves on a
        # communicator whose link class is uniform — on a mixed parent
        # comm it no-ops (and ties with the defaults), on the derived
        # slice/leader subcomms it is the actual per-hop verdict
        cands += [
            {"wire_dtype_ici": wire_dtype_value(wd)}
            for wd in wire_dtypes_ici
            if wire_dtype_value(wd) != 0
        ]
        cands += [
            {"wire_dtype_dcn": wire_dtype_value(wd)}
            for wd in wire_dtypes_dcn
            if wire_dtype_value(wd) != 0
        ]
    if race_hierarchical and op in HIER_OPS:
        # topology plane: race the slice/cross-slice decomposition
        # against the flat lowering per bucket; for allreduce also race
        # "hierarchical + fp8-on-DCN" — the cross-slice leader hop is
        # the only leg a DCN lane compresses, so the combination is the
        # shape the paper's multi-slice numbers come from
        cands.append({"hierarchical": 1})
        if op == "allreduce":
            cands += [
                {"hierarchical": 1, "wire_dtype_dcn": wire_dtype_value(wd)}
                for wd in wire_dtypes_dcn
                if wire_dtype_value(wd) != 0
            ]
    for e in eager_candidates:
        cands.append({"max_eager_size": int(e)})
    return cands


def _apply_registers(group, regs: Dict[str, object]) -> None:
    """Write a full register state (defaults overlaid with ``regs``)
    through the facade's SET_TUNING / SET_MAX_EAGER_SIZE paths on every
    rank handle of the group."""
    full = dict(REGISTER_DEFAULTS)
    full.update(regs)
    for a in group:
        a.set_max_eager_size(int(full["max_eager_size"]))
        for name, val in full.items():
            if name == "max_eager_size":
                continue
            a.set_tuning(name, val)


def _cand_label(regs: Dict[str, object]) -> str:
    if not regs:
        return "defaults"
    return ",".join(f"{k}={v}" for k, v in sorted(regs.items()))


def autotune(
    group,
    collectives: Optional[Sequence[str]] = None,
    sizes: Optional[Sequence[int]] = None,
    runs: int = 3,
    include_pallas: bool = False,
    eager_candidates: Sequence[int] = (),
    segments: Sequence[int] = (1, 2, 4),
    pipeline_thresholds: Sequence[int] = (),
    wire_dtypes: Sequence = (),
    cmdring_run_windows: Sequence[int] = (),
    cmdring_linger_us: Sequence[int] = (),
    wire_dtypes_ici: Sequence = (),
    wire_dtypes_dcn: Sequence = (),
    topology=None,
    margin: float = 0.10,
    log=None,
) -> TuningPlan:
    """Race tier-appropriate register sets per (collective, size) over a
    live rank-handle group and return the winning :class:`TuningPlan`.

    One warm run per candidate (the first launch of a kernel or a
    prepared handle), then ``runs`` measured runs
    (:func:`run_group_op`), scored by the **minimum** — the steady-state
    number a cached-plan dispatch path will see.  A non-default
    candidate only wins by beating the defaults by ``margin`` (ties go
    to the defaults), so host-timer noise never bakes a fake winner
    into the plan.  Registers are restored to the defaults before
    returning (the group keeps serving)."""
    world = len(group)
    tier = detect_tier(group)
    if topology is None:
        # the group's attached descriptor, when the caller didn't pass
        # one explicitly — hierarchical candidates only make sense on
        # the layout the group actually dispatches under
        topology = getattr(group[0], "topology", None)
    race_hier = topology is not None and multi_slice(topology)
    collectives = list(collectives or COLLECTIVES)
    sizes = list(sizes or [2**e for e in range(4, 17, 4)])
    say = log or (lambda msg: None)

    entries: Dict[str, Dict[int, dict]] = {}
    try:
        for op in collectives:
            if op == "sendrecv":
                continue  # p2p has no algorithm registers to race
            per_op: Dict[int, dict] = {}
            for n in sizes:
                scores: Dict[str, float] = {}
                measured: List[tuple] = []
                for regs in _candidates(
                    tier, op, world, include_pallas, eager_candidates,
                    segments, pipeline_thresholds, wire_dtypes,
                    cmdring_run_windows, cmdring_linger_us,
                    race_hierarchical=race_hier,
                    wire_dtypes_ici=wire_dtypes_ici,
                    wire_dtypes_dcn=wire_dtypes_dcn,
                ):
                    try:
                        # the register writes are part of the candidate:
                        # one the engine refuses (e.g. an out-of-bounds
                        # --eager value) is a SKIP, not a lost race
                        _apply_registers(group, regs)
                    except Exception as e:
                        say(f"# {op} n={n} {_cand_label(regs)}: SKIP ({e})")
                        continue
                    # a candidate that fails to run raises: a kernel that
                    # does not build or launch never drops out of the race
                    # and leaves the plain lowering the winner
                    run_group_op(group, op, n)  # warm (compile)
                    ns = min(
                        run_group_op(group, op, n)
                        for _ in range(max(1, runs))
                    )
                    scores[_cand_label(regs)] = ns
                    measured.append((ns, regs))
                if not measured:
                    continue
                default_ns = scores.get("defaults")
                best_ns, best_regs = min(measured, key=lambda t: t[0])
                if (
                    best_regs
                    and default_ns is not None
                    and best_ns >= (1.0 - margin) * default_ns
                ):
                    # not a clear win over the defaults: keep them
                    best_ns, best_regs = default_ns, {}
                bucket = size_bucket(n)
                per_op[bucket] = {
                    "registers": dict(best_regs),
                    "measured_ns": best_ns,
                    "default_ns": default_ns,
                    "size": int(n),
                    "candidates": scores,
                }
                say(
                    f"{op} n={n} (bucket {bucket}): "
                    f"{_cand_label(best_regs)} @ {best_ns:.0f} ns"
                )
            if per_op:
                entries[op] = per_op
    finally:
        _apply_registers(group, {})  # restore defaults

    provenance: Dict[str, object] = {
        "generated_by": "accl_tpu_torch.tuning.autotune",
        "engine": type(group[0].engine).__name__,
        "sizes": sizes,
        "runs": int(runs),
        "include_pallas": bool(include_pallas),
        "eager_candidates": [int(e) for e in eager_candidates],
        "segments": [int(s) for s in segments],
        "pipeline_thresholds": [int(t) for t in pipeline_thresholds],
        "wire_dtypes": [wire_dtype_value(w) for w in wire_dtypes],
        "cmdring_run_windows": [int(r) for r in cmdring_run_windows],
        "cmdring_linger_us": [int(u) for u in cmdring_linger_us],
        "wire_dtypes_ici": [wire_dtype_value(w) for w in wire_dtypes_ici],
        "wire_dtypes_dcn": [wire_dtype_value(w) for w in wire_dtypes_dcn],
        "topology": None if topology is None else topology.signature(),
        "hierarchical_raced": bool(race_hier),
        "margin": float(margin),
    }
    import torch

    provenance["torch"] = torch.__version__
    provenance["cuda"] = torch.version.cuda
    device = getattr(group[0].engine, "device", None)
    provenance["platform"] = None if device is None else device.type
    if device is not None and device.type == "cuda":
        provenance["device_name"] = torch.cuda.get_device_name(device)
    return TuningPlan(
        world=world,
        tier=tier,
        defaults=dict(REGISTER_DEFAULTS),
        entries=entries,
        provenance=provenance,
        topology=None if topology is None else topology.signature(),
    )


# ---------------------------------------------------------------------------
# CLI: python -m accl_tpu_torch.tuning --world 4 --out plan.json
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="Autotune collective algorithm registers on the port's "
        "gang; emit a TuningPlan JSON artifact."
    )
    ap.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                    help="the gang on the card (default) or on the CPU")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--min-exp", type=int, default=4)
    ap.add_argument("--max-exp", type=int, default=16)
    ap.add_argument("--step-exp", type=int, default=2,
                    help="exponent stride between swept sizes")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--collectives", nargs="*", default=None)
    ap.add_argument("--include-pallas", action="store_true",
                    help="also race the hand-written kernels (K1's two "
                    "forms, the rooted relays, K3's root-only gather)")
    ap.add_argument("--eager", nargs="*", type=int, default=[],
                    help="max_eager_size candidates (bytes) to race")
    ap.add_argument("--segments", nargs="*", type=int, default=[1, 2, 4])
    ap.add_argument(
        "--pipeline-thresholds", nargs="*", type=int, default=[],
        help="pipeline_threshold candidates (bytes) to race against the "
             "segment counts (segmented pipelining)",
    )
    ap.add_argument(
        "--wire-dtypes", nargs="*", default=[],
        help="wire-compression verdicts to race for allreduce: names of "
             "the registered lanes, e.g. float16 bfloat16 float8_e4m3 "
             "int8 ('off', the defaults, is always candidate 0)",
    )
    ap.add_argument("--cmdring-run-windows", nargs="*", type=int, default=[],
                    help="command-ring run-window budgets to race for "
                    "allreduce (e.g. 32 128)")
    ap.add_argument("--cmdring-linger-us", nargs="*", type=int, default=[],
                    help="command-ring mailbox linger candidates in "
                    "microseconds (e.g. 500 5000)")
    ap.add_argument("--wire-dtypes-ici", nargs="*", default=[],
                    help="per-link-class wire lanes to race on ICI-uniform "
                    "communicators (WIRE_DTYPE_ICI)")
    ap.add_argument("--wire-dtypes-dcn", nargs="*", default=[],
                    help="per-link-class wire lanes to race on cross-slice "
                    "hops (WIRE_DTYPE_DCN); with --slice-size also races "
                    "'hierarchical + lane' for allreduce")
    ap.add_argument(
        "--slice-size", type=int, default=None,
        help="attach a symmetric multi-slice Topology (world/slice-size "
             "slices) to the group, which arms the hierarchical-vs-flat "
             "race and stamps the plan's topology provenance",
    )
    for flag in ("--ici-gbps", "--dcn-gbps", "--wire-gbps"):
        ap.add_argument(flag, type=float, default=None,
                        help="refused: it models the emulated fabric")
    ap.add_argument("--margin", type=float, default=0.10,
                    help="a non-default candidate must beat the defaults "
                    "by this fraction to win its bucket")
    ap.add_argument("--out", default="-")
    ap.add_argument("--csv-default", default=None,
                    help="also write the defaults-candidate measurements "
                    "as a sweep CSV")
    ap.add_argument("--csv-tuned", default=None,
                    help="also write the per-point winner measurements as "
                    "a sweep CSV")
    args = ap.parse_args(argv)
    # JAX's wording; the port has no emulated fabric (ROADMAP A12)
    if args.wire_gbps:
        raise SystemExit("--wire-gbps models the emulated fabric "
                         "(use --backend emulator)")
    if args.ici_gbps or args.dcn_gbps:
        raise SystemExit("--ici-gbps/--dcn-gbps model the emulated "
                         "fabric (use --backend emulator)")

    from . import core
    from .topology import Topology

    topology = None
    if args.slice_size:
        topology = Topology.from_slice_size(args.world, args.slice_size)
    group = core.cuda_group(
        args.world, device="cpu" if args.backend == "cpu" else None,
        topology=topology)
    try:
        plan = autotune(
            group,
            collectives=args.collectives,
            sizes=[2**e for e in range(
                args.min_exp, args.max_exp + 1, max(1, args.step_exp)
            )],
            runs=args.runs,
            include_pallas=args.include_pallas,
            eager_candidates=args.eager,
            segments=args.segments,
            pipeline_thresholds=args.pipeline_thresholds,
            wire_dtypes=args.wire_dtypes,
            cmdring_run_windows=args.cmdring_run_windows,
            cmdring_linger_us=args.cmdring_linger_us,
            wire_dtypes_ici=args.wire_dtypes_ici,
            wire_dtypes_dcn=args.wire_dtypes_dcn,
            topology=topology,
            margin=args.margin,
            log=lambda msg: print(msg, file=sys.stderr),
        )
    finally:
        for a in group:
            a.deinit()
    plan.provenance["backend"] = args.backend
    text = plan.to_json()
    if args.out == "-":
        print(text)
    else:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    for path, key in ((args.csv_default, "default_ns"),
                      (args.csv_tuned, "measured_ns")):
        if not path:
            continue
        import csv

        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["collective", "count", "bytes",
                                              "duration_ns", "gbps"])
            w.writeheader()
            for op in sorted(plan.entries):
                for bucket in sorted(plan.entries[op]):
                    e = plan.entries[op][bucket]
                    ns, n = e.get(key), e.get("size")
                    if ns is None or n is None:
                        continue
                    w.writerow({"collective": op, "count": n,
                                "bytes": n * 4, "duration_ns": int(ns),
                                "gbps": 8 * n * 4 / max(ns, 1)})
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
