"""vadd_put: a device computation handing its result to the collective
engine (the port's copy of ``accl_tpu/examples/vadd_put.py``).

Role model: the reference's ``vadd_put`` plugin — an FPGA kernel reads
float32, adds a constant, streams the result into the engine and issues
``stream_put`` to a remote rank.  Three forms:

* :func:`vadd_put`: compute on the rank's device, push the result into
  the local stream port, then ``send(from_stream=True)`` to the
  destination's tag-matched receive;
* :func:`vadd_put_streamed`: operand from the local stream port AND
  delivery into the destination's stream port (OP0_STREAM | RES_STREAM),
  no tag-matched buffer anywhere;
* :func:`vadd_put_kernel`: compute and put in ONE kernel launch over the
  P ranks' rows (row 13, ``ops.cuda.put.fused_shift``) — the counterpart
  of ``vadd_put_pallas``.

The stream ports hold host bytes, as in the JAX package, so the first two
forms copy the computed result from the card to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backends.base import CallOptions
from ..constants import DataType, Operation, StreamFlags
from ..ops.cuda.put import Add, fused_shift


def _vadd(accl, data, increment: float) -> torch.Tensor:
    """``data + increment`` in float32 on the rank's device."""
    x = torch.as_tensor(np.asarray(data, np.float32)).to(accl.engine.device)
    return x + increment


def vadd_put(accl, data, dst: int, stream_id: int = 0,
             increment: float = 1.0) -> None:
    """Compute ``data + increment`` on the device, push it into the local
    stream port, then send from the port to ``dst``'s receive of tag
    ``stream_id`` (the OP0_STREAM path)."""
    out = _vadd(accl, data, increment)
    accl.stream_push(out, stream_id=stream_id)
    accl.send(None, out.numel(), dst=dst, tag=stream_id, from_stream=True,
              stream_id=stream_id)


def vadd_put_streamed(accl, data, dst: int, stream_id: int = 0,
                      increment: float = 1.0) -> None:
    """Compute ``data + increment``, push it into the local stream port,
    and let the engine carry it from there into ``dst``'s stream port
    (OP0_STREAM | RES_STREAM) — the exact vadd_put flow."""
    out = _vadd(accl, data, increment)
    accl.stream_push(out, stream_id=stream_id)
    cfg, flags = accl._resolve_arithcfg(DataType.FLOAT32, None)
    opts = CallOptions(
        op=Operation.SEND, comm=accl.comm, count=out.numel(), root_dst=dst,
        tag=stream_id, arithcfg=cfg, compression=flags,
        stream=StreamFlags.OP0_STREAM | StreamFlags.RES_STREAM,
        stream_id=stream_id,
    )
    accl._launch(opts, False, "vadd_put_streamed")


def vadd_put_kernel(xs, increment: float = 1.0, distance: int = 1):
    """The fully fused form: ``xs[r] + increment`` computed and stored into
    rank ``(r + distance) mod P``'s output in ONE launch of row 13 (the
    counterpart of ``accl_tpu/examples/vadd_put.py::vadd_put_pallas``).
    ``xs`` is a ``(P, n)`` float32 tensor or P float32 tensors on one
    device; returns the results the same way (row r = what rank r
    received)."""
    return fused_shift(xs, distance, Add(increment))
