"""Hierarchical collective decomposition rules (pure math, no wire).

The port's own copy of ``accl_tpu/hierarchical.py``.  Given a
:class:`~accl_tpu_torch.topology.Topology`, a facade collective that can
decompose runs as sub-collectives on derived sub-communicators, so the
slow cross-slice links carry ``1/slice_size`` of a flat ring's bytes:

* **allreduce, rail mode** (symmetric topology, count divisible by the
  slice size): reduce-scatter within the slice -> allreduce over the
  *rail* (the ranks holding the same chunk in every slice, count/S
  elements) -> allgather within the slice;
* **allreduce, leader mode** (any other multi-slice shape): reduce to
  the slice leader -> allreduce over the leaders (full count) -> bcast
  within the slice;
* **allgather** (symmetric + contiguous): intra allgather -> rail
  allgather;
* **reduce_scatter** (symmetric + contiguous): permute the send blocks
  (:func:`reduce_scatter_permutation`) -> intra reduce-scatter over
  L*n-element blocks -> rail reduce-scatter over n-element blocks;
* **bcast** (any multi-slice topology): bcast over one representative
  per slice (:func:`bcast_representatives`), then within each slice.

Every decision is a function of (topology, op, count) only, so every
rank picks the same decomposition with no exchange.  Imports nothing
but the standard library and the port's topology module.
"""

from __future__ import annotations

from typing import List, Optional

from .topology import Topology

__all__ = [
    "HIER_OPS",
    "allreduce_mode",
    "bcast_eligible",
    "bcast_representatives",
    "eligible",
    "gatherlike_eligible",
    "multi_slice",
    "reduce_scatter_permutation",
]

#: facade collectives with a hierarchical decomposition (lower-case op
#: names — the register/plan vocabulary)
HIER_OPS = ("allreduce", "allgather", "reduce_scatter", "bcast")


def multi_slice(topo: Optional[Topology]) -> bool:
    """The baseline eligibility every decomposition shares: at least
    two slices AND at least one slice with two members.  All-singleton
    slices (a pure-DCN comm — e.g. a rail subcomm) must NOT decompose:
    the decomposition would recurse into an identical call."""
    return (
        topo is not None
        and topo.num_slices >= 2
        and topo.world > topo.num_slices
    )


def allreduce_mode(topo: Optional[Topology],
                   count: int) -> Optional[str]:
    """``"rail"`` / ``"leader"`` / None (stay flat).  Rail needs every
    slice the same size and the count divisible by it (the intra
    reduce-scatter hands each rank an equal chunk); leader mode covers
    every other multi-slice shape at full-count DCN cost."""
    if not multi_slice(topo):
        return None
    if topo.symmetric and count > 0 and count % len(topo.slices[0]) == 0:
        return "rail"
    return "leader"


def gatherlike_eligible(topo: Optional[Topology]) -> bool:
    """allgather / reduce_scatter eligibility: the rail stage places
    blocks slice-major, which equals the flat rank-major placement only
    when slices are contiguous ascending runs of equal size."""
    return bool(multi_slice(topo) and topo.symmetric and topo.contiguous)


def bcast_eligible(topo: Optional[Topology]) -> bool:
    """bcast decomposes on any multi-slice topology (representatives
    need no symmetry or contiguity)."""
    return multi_slice(topo)


def eligible(op: str, topo: Optional[Topology], count: int) -> bool:
    """One predicate over (op name, topology, count) — the callable
    the facade and the autotuner share, so a raced ``hierarchical``
    register can only arm decompositions that exist."""
    if op == "allreduce":
        return allreduce_mode(topo, count) is not None
    if op in ("allgather", "reduce_scatter"):
        return gatherlike_eligible(topo)
    if op == "bcast":
        return bcast_eligible(topo)
    return False


def bcast_representatives(topo: Topology, root: int) -> List[int]:
    """One rank per slice for the cross-slice bcast stage: the ROOT
    for its own slice (no extra hop — the root already holds the
    payload), the slice leader elsewhere.  Sorted ascending: every
    rank derives the same member list, and the cross subcomm's rank
    order is reproducible."""
    rs = topo.slice_of(root)
    reps = [
        int(root) if si == rs else s[0]
        for si, s in enumerate(topo.slices)
    ]
    return sorted(reps)


def reduce_scatter_permutation(topo: Topology) -> List[int]:
    """Block permutation staging a hierarchical reduce-scatter.

    With L contiguous slices of size S (world W = L*S, flat chunk c
    belongs to global rank c), the staged send buffer orders the W
    per-rank blocks as::

        [ s*S + i  for i in range(S) for s in range(L) ]

    so intra block i (L consecutive blocks) carries the chunks of
    local index i across ALL slices.  The intra reduce-scatter (count
    L*n) then hands rank (s, i) the slice-partial sums of those L
    chunks; the rail reduce-scatter (count n) hands it block s of that
    — the fully-reduced chunk of global rank ``s*S + i``, exactly the
    flat result."""
    if not (topo.symmetric and topo.contiguous):
        raise ValueError(
            "reduce_scatter staging needs a symmetric contiguous "
            "topology"
        )
    L, S = topo.num_slices, len(topo.slices[0])
    return [s * S + i for i in range(S) for s in range(L)]
