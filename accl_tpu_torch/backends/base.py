"""Backend interface: what the facade needs from a collective engine.
The port's copy of ``accl_tpu/backends/base.py`` (a subset of
``CallOptions``: no stream ports, host flags or plans)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..arithconfig import ArithConfig
from ..buffer import BaseBuffer
from ..communicator import Communicator
from ..constants import CompressionFlags, Operation, ReduceFunction


@dataclasses.dataclass
class CallOptions:
    """One engine call, fully resolved."""

    op: Operation
    comm: Optional[Communicator] = None
    count: int = 0  # element count in *uncompressed* dtype
    root_src: int = 0  # root / source rank (op-dependent)
    root_dst: int = 0  # destination rank
    tag: int = 0
    reduce_function: ReduceFunction = ReduceFunction.SUM
    arithcfg: Optional[ArithConfig] = None
    compression: CompressionFlags = CompressionFlags.NO_COMPRESSION
    op0: Optional[BaseBuffer] = None
    op1: Optional[BaseBuffer] = None
    res: Optional[BaseBuffer] = None
    # fused compute slots: which epilogue rides the call (FusedCompute)
    # and its scalar (alpha / lr / scale)
    fuse: int = 0
    fuse_param: float = 0.0
    # Operation.CONFIG only:
    cfg_function: int = 0
    cfg_value: float = 0.0
    cfg_key: int = 0  # tuning register selector for SET_TUNING


class BaseEngine:
    """One rank's collective engine."""

    def start(self, options: CallOptions):
        """Start a call; returns a Request."""
        raise NotImplementedError

    def start_batch(self, items) -> None:
        """Dispatch a flushed batch of ``(options, request)`` pairs (the
        requests were made by the facade), preserving issue order."""
        raise NotImplementedError

    def create_buffer(self, count: int, dtype, data=None):
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError
