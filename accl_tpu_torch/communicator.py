"""Communicators: ordered groups of ranks with per-peer session state.
The port's copy of ``accl_tpu/communicator.py`` without the elastic-
membership cutovers (shrink / grow / restore, ROADMAP A11c).  A
communicator may carry a :class:`~accl_tpu_torch.topology.Topology` in
its own rank space; :meth:`Communicator.split` derives the subcomm's.

Several communicators may cover overlapping rank sets
(``ACCL.create_communicator``, :meth:`Communicator.split`); the gang keys
its slots and sequence numbers by the communicator id, so calls on
different communicators never match each other.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Sequence

DEFAULT_MAX_SEGMENT_SIZE = 4 * 1024


@dataclasses.dataclass
class Rank:
    address: str  # transport-specific endpoint for this rank
    session: int = 0  # stable per-peer session id (the global rank)
    max_segment_size: int = DEFAULT_MAX_SEGMENT_SIZE


_comm_ids = itertools.count(0)
# Epochs tell apart INSTANCES that share a deterministic comm id
# (create_communicator derives ids from membership, so re-creating a
# subgroup reuses the id): the plan cache and the per-call wire seeds are
# keyed by (id, epoch), so a re-created communicator never reuses a stale
# plan.  One process-wide counter, as in the JAX package.
_comm_epochs = itertools.count(1)


class Communicator:
    def __init__(
        self,
        ranks: Sequence[Rank],
        local_rank: int,
        comm_id: Optional[int] = None,
    ):
        if not 0 <= local_rank < len(ranks):
            raise ValueError(f"local_rank {local_rank} out of range")
        self.ranks: List[Rank] = list(ranks)
        self.local_rank = int(local_rank)
        self.id = next(_comm_ids) if comm_id is None else comm_id
        self.epoch = next(_comm_epochs)
        self._lock = threading.Lock()
        # per-peer monotone sequence numbers (ordering for eager matching)
        self._outbound_seq: Dict[int, int] = {i: 0 for i in range(len(ranks))}
        self._inbound_seq: Dict[int, int] = {i: 0 for i in range(len(ranks))}
        # the slice / link-class descriptor in THIS communicator's rank
        # space, or None (flat): attached by the facade at construction
        # or set_topology, derived by split; _full_topology is kept for
        # the elastic restore path (A11c), which the port lacks yet
        self.topology = None
        self._full_topology = None

    # -- introspection ------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        return self.local_rank

    def prev_rank(self, distance: int = 1) -> int:
        return (self.local_rank - distance) % self.size

    def next_rank(self, distance: int = 1) -> int:
        return (self.local_rank + distance) % self.size

    # -- sequence numbers ---------------------------------------------------
    def next_outbound_seq(self, peer: int) -> int:
        with self._lock:
            seq = self._outbound_seq[peer]
            self._outbound_seq[peer] = seq + 1
            return seq

    def peek_inbound_seq(self, peer: int) -> int:
        with self._lock:
            return self._inbound_seq[peer]

    def advance_inbound_seq(self, peer: int) -> None:
        with self._lock:
            self._inbound_seq[peer] += 1

    def reset_sequences(self) -> None:
        """Zero every per-peer sequence counter and start a fresh epoch
        (every member resets, so the counters realign)."""
        with self._lock:
            self.epoch = next(_comm_epochs)
            for i in self._outbound_seq:
                self._outbound_seq[i] = 0
                self._inbound_seq[i] = 0

    # -- derivation ---------------------------------------------------------
    def split(
        self, members: Sequence[int], comm_id: Optional[int] = None
    ) -> Optional["Communicator"]:
        """A new communicator over a subset of this one's ranks.

        ``members`` are rank indices in THIS communicator, in the order
        they take in the new one.  None when the local rank is not a
        member (MPI_Comm_split's semantics)."""
        members = list(members)
        if len(set(members)) != len(members):
            raise ValueError("duplicate members in communicator split")
        for m in members:
            if not 0 <= m < self.size:
                raise ValueError(f"member {m} out of range")
        if self.local_rank not in members:
            return None
        sub = Communicator([self.ranks[m] for m in members],
                           members.index(self.local_rank), comm_id=comm_id)
        if self.topology is not None:
            # member m of the parent becomes rank members.index(m) of the
            # child, and subtopology() maps slices through that order, so
            # the subcomm's link classes stay truthful
            sub.topology = self.topology.subtopology(members)
        return sub

    # -- debug --------------------------------------------------------------
    def as_dict(self) -> dict:
        """The structured form of :meth:`dump` (the topology by its
        signature, None when flat)."""
        with self._lock:
            return {
                "id": self.id,
                "epoch": self.epoch,
                "size": self.size,
                "local_rank": self.local_rank,
                "topology": (None if self.topology is None
                             else self.topology.signature()),
                "ranks": [
                    {
                        "address": r.address,
                        "session": r.session,
                        "max_segment_size": r.max_segment_size,
                        "seq_out": self._outbound_seq[i],
                        "seq_in": self._inbound_seq[i],
                    }
                    for i, r in enumerate(self.ranks)
                ],
            }

    def dump(self) -> str:
        head = (f"communicator {self.id}: size={self.size} "
                f"local={self.local_rank}")
        if self.topology is not None:
            head += f" topology={self.topology.signature()}"
        lines = [head]
        with self._lock:
            for i, r in enumerate(self.ranks):
                lines.append(
                    f"  rank {i}: addr={r.address} session={r.session} "
                    f"seg={r.max_segment_size} "
                    f"seq_out={self._outbound_seq[i]} "
                    f"seq_in={self._inbound_seq[i]}"
                )
        return "\n".join(lines)
