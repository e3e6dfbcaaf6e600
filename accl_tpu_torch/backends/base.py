"""Backend interface: what the facade needs from a collective engine.
The port's copy of ``accl_tpu/backends/base.py`` (a subset of
``CallOptions``: no host flags or plans), with the device stream ports
(:class:`StreamPortMixin`)."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch

from ..arithconfig import ArithConfig
from ..buffer import BaseBuffer
from ..communicator import Communicator
from ..constants import (
    CompressionFlags,
    Operation,
    ReduceFunction,
    StreamFlags,
    dtype_to_torch,
)
from ..ops.cuda.compression import CAST_DTYPES, cast_rows
from ..wire import astype


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
    stream: StreamFlags = StreamFlags.NO_STREAM
    op0: Optional[BaseBuffer] = None
    op1: Optional[BaseBuffer] = None
    res: Optional[BaseBuffer] = None
    stream_id: int = 0  # the stream port of a streamed operand or result
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

    # -- device stream ports (stream_put / streaming operands) --------------
    def stream_push(self, stream_id: int, data: bytes) -> None:
        raise NotImplementedError

    def stream_pop(self, stream_id: int,
                   timeout: Optional[float] = None) -> bytes:
        raise NotImplementedError


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a tensor, copied to the host (a device-to-host
    copy for a CUDA tensor)."""
    return t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()


def bytes_tensor(raw: bytes, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` over a copy of ``raw``."""
    if not raw:
        return torch.empty(0, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dtype)


def convert(t: torch.Tensor, dtype: torch.dtype,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``t`` in ``dtype``, written into ``out`` (1-D, contiguous) when
    given.  A card tensor between two of the wire dtypes takes row 5's
    kernel (``cast_rows``); host bytes and other floating pairs take JAX's
    ``astype`` rules (``wire.astype``), any other pair PyTorch's
    conversion."""
    if t.dtype == dtype:
        r = t
    elif t.is_cuda and t.dtype in CAST_DTYPES and dtype in CAST_DTYPES:
        return cast_rows([t], dtype, out=None if out is None else [out])[0]
    elif t.is_floating_point() and dtype.is_floating_point and (
            t.dtype != torch.float64 and dtype != torch.float64):
        r = astype(t, dtype)
    else:
        r = t.to(dtype)
    return r if out is None else out.copy_(r)


class StreamPortMixin:
    """Local device stream ports (the external-kernel AXIS interface) and
    the streaming-operand/result payload helpers.  As in the JAX package,
    a port holds HOST bytes: a device operand pushed into one, or a
    streamed result, crosses to the host.  Hosts call
    :meth:`_init_streams` and provide ``self.timeout_s``."""

    def _init_streams(self) -> None:
        self._streams: dict = {}
        self._stream_cv = threading.Condition()

    def stream_push(self, stream_id: int, data: bytes) -> None:
        with self._stream_cv:
            self._streams.setdefault(stream_id, []).append(bytes(data))
            self._stream_cv.notify_all()

    def stream_pop(self, stream_id: int,
                   timeout: Optional[float] = None) -> bytes:
        with self._stream_cv:
            ok = self._stream_cv.wait_for(
                lambda: self._streams.get(stream_id), timeout
            )
            if not ok:
                raise TimeoutError(f"stream {stream_id} empty")
            return self._streams[stream_id].pop(0)

    def _pop_stream_payload(self, options: CallOptions,
                            count=None) -> Optional[torch.Tensor]:
        """Blocking pop of a full streaming operand from this rank's stream
        port, as a CPU tensor in the operand's dtype (the compressed one
        under OP0_COMPRESSED); None on timeout (the engine's deadline,
        ``set_timeout``)."""
        cfg = options.arithcfg
        src_dt = (cfg.compressed
                  if options.compression & CompressionFlags.OP0_COMPRESSED
                  else cfg.uncompressed)
        tdt = dtype_to_torch(src_dt)
        n = options.count if count is None else int(count)
        need = n * tdt.itemsize
        raw = b""
        deadline = time.monotonic() + self.timeout_s
        try:
            while len(raw) < need:
                raw += self.stream_pop(
                    options.stream_id,
                    timeout=max(0.01, deadline - time.monotonic()),
                )
        except TimeoutError:
            return None
        return bytes_tensor(raw[:need], tdt)

    def _push_stream_result(self, options: CallOptions,
                            data: torch.Tensor) -> None:
        """Result row to this rank's stream port, in the dtype the
        compression flags ask for (the RES_STREAM lane)."""
        cfg = options.arithcfg
        res_dt = (cfg.compressed
                  if options.compression & CompressionFlags.RES_COMPRESSED
                  else cfg.uncompressed)
        out = convert(data.reshape(-1)[: options.count],
                      dtype_to_torch(res_dt))
        self.stream_push(options.stream_id, tensor_bytes(out))

