"""Communicators: ordered groups of ranks with per-peer session state.
The port's copy of ``accl_tpu/communicator.py``, with the elastic-
membership cutovers (:meth:`Communicator.shrink`, :meth:`~Communicator.
grow`, :meth:`~Communicator.restore`).  A communicator may carry a
:class:`~accl_tpu_torch.topology.Topology` in its own rank space;
:meth:`Communicator.split` derives the subcomm's, and a shrink or grow
carries it through the cutover.

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
        # the membership plane: the pre-shrink membership stashed by
        # shrink() so soft_reset can restore it
        self._full_ranks: Optional[List[Rank]] = None
        self._full_local: Optional[int] = None
        # the slice / link-class descriptor in THIS communicator's rank
        # space, or None (flat): attached by the facade at construction
        # or set_topology, derived by split, shrink and grow;
        # _full_topology mirrors _full_ranks for the restore path
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
            self._fresh_epoch()

    # -- the membership plane (accl_tpu_torch.membership) -------------------
    def shrink(self, keep: Sequence[int]) -> Optional[Dict[int, int]]:
        """Cut this communicator over IN PLACE to the surviving members
        (``keep``: comm-relative ranks, local rank included): a fresh
        epoch, every per-peer sequence counter at 0, the topology cut to
        the survivors.  Returns ``{old comm-relative rank -> new}``; None
        when the local rank is not a survivor (the evicted side never
        shrinks)."""
        keep = sorted(set(int(k) for k in keep))
        for k in keep:
            if not 0 <= k < self.size:
                raise ValueError(f"survivor rank {k} out of range")
        with self._lock:
            if self.local_rank not in keep:
                return None
            if self._full_ranks is None:
                self._full_ranks = list(self.ranks)
                self._full_local = self.local_rank
            translation = {old: new for new, old in enumerate(keep)}
            self.ranks = [self.ranks[k] for k in keep]
            self.local_rank = translation[self.local_rank]
            if self.topology is not None:
                if self._full_topology is None:
                    self._full_topology = self.topology
                self.topology = self.topology.subtopology(keep)
            self._fresh_epoch()
            return translation

    def grow(self, admit: Sequence[int],
             rank_info: Optional[Dict[int, Rank]] = None,
             ) -> Optional[Dict[int, int]]:
        """Cut this communicator over IN PLACE to a GROWN membership
        (``admit``: world sessions).  Sessions of the pre-shrink
        membership return to their original slots (so every member
        derives the same order); new sessions need a :class:`Rank` in
        ``rank_info`` and append in ascending session order.  Admitted
        ranks land in singleton slices of the topology.  A fresh epoch,
        zeroed counters; returns ``{old comm-relative rank -> new}``."""
        admit = {int(s) for s in admit}
        with self._lock:
            base = (list(self._full_ranks) if self._full_ranks is not None
                    else list(self.ranks))
            current = {r.session for r in self.ranks}
            target = current | admit
            known = {r.session for r in base}
            extras = []
            for s in sorted(admit - known):
                if rank_info is None or s not in rank_info:
                    raise ValueError(
                        f"admitted session {s} unknown to this "
                        "communicator and no rank_info given")
                extras.append(rank_info[s])
            new_ranks = [r for r in base if r.session in target] + extras
            old_index = {r.session: i for i, r in enumerate(self.ranks)}
            translation = {old_index[r.session]: new
                           for new, r in enumerate(new_ranks)
                           if r.session in old_index}
            local_session = self.ranks[self.local_rank].session
            if self.topology is not None:
                if self._full_topology is None:
                    self._full_topology = self.topology
                from .topology import Topology

                subs = [[translation[r] for r in s if r in translation]
                        for s in self.topology.slices]
                subs = [s for s in subs if s]
                covered = {r for s in subs for r in s}
                subs += [[i] for i in range(len(new_ranks))
                         if i not in covered]
                self.topology = Topology(subs)
            self.ranks = new_ranks
            self.local_rank = next(i for i, r in enumerate(new_ranks)
                                   if r.session == local_session)
            if (self._full_ranks is not None
                    and len(new_ranks) >= len(self._full_ranks)
                    and known <= {r.session for r in new_ranks}):
                # grown back to the stashed membership: nothing is left
                # for soft_reset to re-admit
                self._full_ranks = None
                self._full_local = None
            self._fresh_epoch()
            return translation

    def restore(self) -> bool:
        """Undo every shrink: the full pre-shrink membership and topology
        (soft_reset's re-admission).  False when it never shrank."""
        with self._lock:
            if self._full_ranks is None:
                return False
            self.ranks = list(self._full_ranks)
            self.local_rank = int(self._full_local)
            self._full_ranks = None
            self._full_local = None
            if self._full_topology is not None:
                self.topology = self._full_topology
                self._full_topology = None
            self._fresh_epoch()
            return True

    @property
    def shrunk(self) -> bool:
        return self._full_ranks is not None

    def _fresh_epoch(self) -> None:
        """A cutover's fresh epoch and zeroed counters (lock held)."""
        self.epoch = next(_comm_epochs)
        self._outbound_seq = {i: 0 for i in range(len(self.ranks))}
        self._inbound_seq = {i: 0 for i in range(len(self.ranks))}

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
