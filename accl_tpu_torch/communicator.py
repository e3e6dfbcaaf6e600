"""Communicators: ordered groups of ranks.  The port's copy of
``accl_tpu/communicator.py`` without the elastic-membership cutovers
(shrink / grow / restore)."""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

DEFAULT_MAX_SEGMENT_SIZE = 4 * 1024


@dataclasses.dataclass
class Rank:
    address: str  # transport-specific endpoint for this rank
    session: int = 0  # stable per-peer session id
    max_segment_size: int = DEFAULT_MAX_SEGMENT_SIZE


_comm_ids = itertools.count(0)
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
        # a fresh epoch per communicator, from one process-wide counter as
        # in the JAX package (the per-call wire seeds are keyed by it; the
        # port has no membership cutovers that would start another)
        self.epoch = next(_comm_epochs)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        return self.local_rank

    def prev_rank(self, distance: int = 1) -> int:
        return (self.local_rank - distance) % self.size

    def next_rank(self, distance: int = 1) -> int:
        return (self.local_rank + distance) % self.size
