"""Topology descriptor: slice membership and per-rank-pair link class.

The port's own copy of ``accl_tpu/topology.py``.  A :class:`Topology`
partitions a communicator's ranks (in its own rank space) into slices:
ranks of one slice share the fast interconnect (``LinkClass.ICI``; on
GPUs an NVLink group), ranks of different slices the slow network
(``LinkClass.DCN``).  Everything derives from the slice table by pure
math, so two ranks holding equal tables derive equal answers with no
exchange: the link class of a pair, slice leaders, cross-slice *rails*,
the plan-key axis (:meth:`Topology.signature`) and the hierarchical
decomposition's eligibility (:mod:`accl_tpu_torch.hierarchical`).  The
signature and the JSON form are the JAX package's strings, so a tuning
plan's topology provenance compares across the two packages.

Construction: ``Topology(slices)``, :meth:`Topology.from_slice_size`,
:meth:`Topology.flat`, :meth:`Topology.from_json`, or
:meth:`Topology.from_env` (``ACCL_TOPOLOGY``, inline JSON or ``@path``,
then ``ACCL_SLICE_SIZE``, then an initialized ``torch.distributed``).
Imports nothing but the standard library.
"""

from __future__ import annotations

import enum
import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "LinkClass",
    "Topology",
    "TOPOLOGY_ENV",
    "SLICE_SIZE_ENV",
]

#: inline JSON (or ``@path``) describing the world topology
TOPOLOGY_ENV = "ACCL_TOPOLOGY"
#: shortcut: uniform slice size; world must divide evenly
SLICE_SIZE_ENV = "ACCL_SLICE_SIZE"


class LinkClass(enum.IntEnum):
    """The wire class between one rank pair: the axis per-class wire
    ladders and the two-class paced bandwidth model key on."""

    LOOPBACK = 0  # same rank (self-delivery; never paced)
    ICI = 1       # same slice: the fast intra-slice interconnect
    DCN = 2       # different slices: the slow cross-slice network


class Topology:
    """A partition of a communicator's ranks into slices.

    ``slices`` is a tuple of tuples of comm-relative rank indices:
    disjoint, each sorted ascending, jointly covering ``0..world-1``.
    Immutable once built; every derived fact below is pure math over
    that table.
    """

    __slots__ = ("slices", "_slice_of", "_index_in", "_sig")

    def __init__(self, slices: Sequence[Sequence[int]]):
        norm = tuple(
            tuple(sorted(int(r) for r in s)) for s in slices if len(s)
        )
        if not norm:
            raise ValueError("topology needs at least one slice")
        # slices ordered by their smallest member: ONE canonical form
        # per partition, so equal partitions produce equal signatures
        norm = tuple(sorted(norm, key=lambda s: s[0]))
        slice_of: Dict[int, int] = {}
        index_in: Dict[int, int] = {}
        for si, members in enumerate(norm):
            for li, r in enumerate(members):
                if r in slice_of:
                    raise ValueError(f"rank {r} appears in two slices")
                slice_of[r] = si
                index_in[r] = li
        world = sum(len(s) for s in norm)
        if sorted(slice_of) != list(range(world)):
            raise ValueError(
                f"slices must cover ranks 0..{world - 1} exactly; got "
                f"{sorted(slice_of)}"
            )
        self.slices: Tuple[Tuple[int, ...], ...] = norm
        self._slice_of = slice_of
        self._index_in = index_in
        self._sig: Optional[str] = None

    # -- basic facts ---------------------------------------------------------
    @property
    def world(self) -> int:
        return len(self._slice_of)

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    def slice_of(self, rank: int) -> int:
        return self._slice_of[int(rank)]

    def slice_members(self, s: int) -> Tuple[int, ...]:
        return self.slices[int(s)]

    def slice_size(self, s: int) -> int:
        return len(self.slices[int(s)])

    def local_index(self, rank: int) -> int:
        """Position of ``rank`` within its own (sorted) slice."""
        return self._index_in[int(rank)]

    @property
    def symmetric(self) -> bool:
        """Every slice the same size (the rail decomposition's shape
        requirement: local index i exists in every slice)."""
        first = len(self.slices[0])
        return all(len(s) == first for s in self.slices)

    @property
    def contiguous(self) -> bool:
        """Each slice a contiguous ascending rank run, slices ordered
        ascending — the layout where ``rank = slice*S + local`` holds,
        which the hierarchical allgather/reduce-scatter placements
        need to land blocks at their global offsets."""
        expect = 0
        for s in self.slices:
            for r in s:
                if r != expect:
                    return False
                expect += 1
        return True

    # -- link classification --------------------------------------------------
    def link_class(self, a: int, b: int) -> LinkClass:
        if int(a) == int(b):
            return LinkClass.LOOPBACK
        return (
            LinkClass.ICI
            if self._slice_of[int(a)] == self._slice_of[int(b)]
            else LinkClass.DCN
        )

    def comm_link_class(self) -> Optional[LinkClass]:
        """The ONE link class every pair of this communicator shares,
        or None when classes mix: single rank -> LOOPBACK, single
        slice -> ICI, all-singleton slices -> DCN.  The per-class
        WIRE_DTYPE ladder keys on it — a subcomm whose wire is purely
        DCN may ride fp8 while its intra-slice sibling keeps full
        width; a mixed comm defers to the generic register."""
        if self.world == 1:
            return LinkClass.LOOPBACK
        if self.num_slices == 1:
            return LinkClass.ICI
        if all(len(s) == 1 for s in self.slices):
            return LinkClass.DCN
        return None

    # -- leaders / rails ------------------------------------------------------
    def leaders(self) -> Tuple[int, ...]:
        """One leader per slice: the smallest member (deterministic —
        every rank derives the same list with zero wire bytes)."""
        return tuple(s[0] for s in self.slices)

    def slice_leader(self, rank: int) -> int:
        """The leader of ``rank``'s slice."""
        return self.slices[self._slice_of[int(rank)]][0]

    def is_leader(self, rank: int) -> bool:
        return self.slice_leader(rank) == int(rank)

    def rail(self, local_idx: int) -> Tuple[int, ...]:
        """Ranks holding ``local_idx`` in EVERY slice (requires a
        symmetric topology): the cross-slice subcomm of the rail
        decomposition — after an intra-slice reduce-scatter, chunk i's
        partial sums live exactly on rail i."""
        if not self.symmetric:
            raise ValueError("rails need a symmetric topology")
        return tuple(s[local_idx] for s in self.slices)

    # -- identity -------------------------------------------------------------
    def signature(self) -> str:
        """Compact SPMD-uniform identity, the plan-key axis: ``LxS``
        for the symmetric-contiguous common case (2 slices of 4 ->
        ``"2x4"``), else sizes + a partition crc (``"s1-3/1a2b3c4d"``).
        Equal partitions yield equal signatures; a topology change
        re-keys every cached plan like an epoch bump does."""
        if self._sig is None:
            if self.symmetric and self.contiguous:
                self._sig = f"{self.num_slices}x{len(self.slices[0])}"
            else:
                crc = zlib.crc32(repr(self.slices).encode()) & 0xFFFFFFFF
                sizes = "-".join(str(len(s)) for s in self.slices)
                self._sig = f"s{sizes}/{crc:08x}"
        return self._sig

    def fingerprint(self) -> int:
        """32-bit partition fingerprint (capture/provenance stamping)."""
        return zlib.crc32(repr(self.slices).encode()) & 0xFFFFFFFF

    def __eq__(self, other) -> bool:
        return isinstance(other, Topology) and self.slices == other.slices

    def __hash__(self) -> int:
        return hash(self.slices)

    def __repr__(self) -> str:
        return f"Topology({self.signature()}, slices={self.slices})"

    # -- derivation -----------------------------------------------------------
    def subtopology(self, members: Sequence[int]) -> "Topology":
        """The topology of a subcommunicator keeping ``members`` (old
        rank indices, in the new comm's rank order): kept ranks are
        renumbered to their position in ``members``, empty slices drop.
        This is what :meth:`Communicator.split` applies, so a derived
        subcomm's link classes stay truthful — an intra-slice subcomm
        classifies ICI-uniform, a rail subcomm DCN-uniform."""
        remap = {int(old): new for new, old in enumerate(members)}
        if len(remap) != len(members):
            raise ValueError("duplicate members in subtopology")
        subs: List[List[int]] = []
        for s in self.slices:
            kept = [remap[r] for r in s if r in remap]
            if kept:
                subs.append(kept)
        if sum(len(s) for s in subs) != len(members):
            missing = [m for m in members if int(m) not in self._slice_of]
            raise ValueError(f"members not in topology: {missing}")
        return Topology(subs)

    def with_appended_rank(self) -> "Topology":
        """Topology after one JOIN: the admitted rank takes the next
        index in ITS OWN new slice — the conservative classification
        (a joiner's placement is unknown until re-described; DCN is
        the class that can only over-pay, never corrupt a decomposition
        built on a fast-link assumption).  Re-attach an explicit
        topology via ``ACCL.set_topology`` once the real placement is
        known."""
        return Topology(tuple(self.slices) + ((self.world,),))

    # -- construction ---------------------------------------------------------
    @classmethod
    def flat(cls, world: int) -> "Topology":
        """Every rank in one slice: the single-interconnect default
        (all links ICI; hierarchical decomposition never fires)."""
        return cls((tuple(range(int(world))),))

    @classmethod
    def from_slice_size(cls, world: int, slice_size: int) -> "Topology":
        world, slice_size = int(world), int(slice_size)
        if slice_size <= 0 or world % slice_size:
            raise ValueError(
                f"slice size {slice_size} does not divide world {world}"
            )
        return cls(tuple(
            tuple(range(b, b + slice_size))
            for b in range(0, world, slice_size)
        ))

    # -- serialization --------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": 1,
            "world": self.world,
            "slices": [list(s) for s in self.slices],
            "signature": self.signature(),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, doc: dict) -> "Topology":
        topo = cls(doc.get("slices") or ())
        want = doc.get("world")
        if want is not None and int(want) != topo.world:
            raise ValueError(
                f"topology document says world={want} but slices cover "
                f"{topo.world} ranks"
            )
        return topo

    @classmethod
    def from_json(cls, text: str) -> "Topology":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_env(cls, world: int,
                 environ=None) -> Optional["Topology"]:
        """The construction path every ACCL handle tries at build time:
        ``ACCL_TOPOLOGY`` (inline JSON / ``@path``), then
        ``ACCL_SLICE_SIZE``, then ``torch.distributed`` facts when it is
        already initialized (process count x even split — the
        one-process-per-slice deployment shape).  None when nothing
        describes a topology (flat world, no hierarchical plane)."""
        env = environ if environ is not None else os.environ
        raw = env.get(TOPOLOGY_ENV, "").strip()
        if raw:
            if raw.startswith("@"):
                with open(raw[1:]) as f:
                    raw = f.read()
            topo = cls.from_json(raw)
            if topo.world != int(world):
                raise ValueError(
                    f"{TOPOLOGY_ENV} describes world={topo.world}, "
                    f"this group is world={world}"
                )
            return topo
        ss = env.get(SLICE_SIZE_ENV, "").strip()
        if ss:
            return cls.from_slice_size(world, int(ss))
        if environ is None:
            return cls._from_torch(world)
        return None

    @classmethod
    def _from_torch(cls, world: int) -> Optional["Topology"]:
        """``torch.distributed`` derivation (the counterpart of JAX's
        ``_from_jax``), guarded: only consulted when ``torch.distributed``
        is already imported and initialized, and only when its process
        count divides the world evenly -- each process's ranks form one
        slice.  The port's single-process gang never initializes it, so
        this returns None there."""
        import sys

        dist = sys.modules.get("torch.distributed")
        if dist is None:
            return None
        try:
            if not (dist.is_available() and dist.is_initialized()):
                return None
            nproc = int(dist.get_world_size())
        except Exception:
            return None
        if nproc <= 1 or int(world) % nproc:
            return None
        return cls.from_slice_size(world, int(world) // nproc)
