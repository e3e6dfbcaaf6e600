"""Host-level drivers: every rank's operand in, every rank's result out.

The counterpart of ``accl_tpu/ops/driver.py``, keeping its STACKED
convention: ``stacked[r]`` is rank r's operand and results come back the
same way.  ``stacked`` is a 2-D tensor (its rows are the ranks) or a
sequence of per-rank 1-D tensors, each its own allocation — the form the
gang engine passes, so no rank's buffer is copied into a stack.  A 2-D
operand gives a 2-D result; a sequence gives a list.  ``out`` names the
per-rank tensors to write the results into.

An ``out`` entry of None is a rank that takes no result: the rooted
reduce and gather write the root's alone, as the JAX engine does (its
``xla`` lowering computes zeros for the other ranks, its Pallas lowering
partials or full copies; a caller with no ``out`` gets those rows).

A :class:`Mesh` is the rank count and the one device every rank's tensors
lie on.  :func:`make_mesh` runs on the card unless the caller asks for
the CPU, and raises when there is no card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from ..constants import ReduceFunction, as_datatype, dtype_to_torch
from . import collectives, ring
from .cuda import ring as kring
from .cuda import rooted as krooted


@dataclasses.dataclass(frozen=True)
class Mesh:
    size: int
    device: torch.device


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raises when CUDA is asked
    for and there is none (no quiet fall back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n: int, device=None) -> Mesh:
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    return Mesh(int(n), resolve_device(device))


def _rows(stacked, mesh: Mesh) -> List[torch.Tensor]:
    xs = list(stacked.unbind(0)) if isinstance(stacked, torch.Tensor) else list(stacked)
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} operands for a mesh of {mesh.size}")
    for x in xs:
        if x.device != mesh.device:
            raise ValueError(f"operand on {x.device}, mesh on {mesh.device}")
    return xs


def _run(stacked, mesh: Mesh, width: int,
         compute: Callable[[List[torch.Tensor], List[torch.Tensor]], None],
         out: Optional[Sequence[torch.Tensor]]):
    """Allocate (or take) the per-rank outputs of ``width`` elements, let
    ``compute(xs, outs)`` fill them, and return them in the operand's
    form."""
    xs = _rows(stacked, mesh)
    x0 = xs[0]
    if out is not None:
        outs = list(out)
        result = out
    elif isinstance(stacked, torch.Tensor):
        result = torch.empty((mesh.size, width), dtype=x0.dtype,
                             device=mesh.device)
        outs = list(result.unbind(0))
    else:
        outs = [torch.empty(width, dtype=x0.dtype, device=mesh.device)
                for _ in xs]
        result = outs
    compute(xs, outs)
    return result


def _copy_into(outs, results) -> None:
    """Copy each rank's result into its output; a None output is a rank
    that takes no result (the engine's non-root reduce and gather)."""
    for o, r in zip(outs, results):
        if o is not None:
            o.copy_(r)


def _torch_dtype(name) -> torch.dtype:
    return dtype_to_torch(as_datatype(name))


def run_allreduce(stacked, mesh: Mesh, function=ReduceFunction.SUM, out=None):
    """The ``xla`` lowering: a plain rank-order reduction."""
    def compute(xs, outs):
        _copy_into(outs, collectives.allreduce(xs, function))

    return _run(stacked, mesh, _width(stacked), compute, out)


def run_ring_allreduce(stacked, mesh: Mesh, function=ReduceFunction.SUM,
                       num_segments: int = 1, out=None):
    """The explicit segmented-ring pipeline (algorithm-faithful mode)."""
    def compute(xs, outs):
        _copy_into(outs, ring.ring_allreduce(xs, function, num_segments))

    return _run(stacked, mesh, _width(stacked), compute, out)


def run_pallas_allreduce(stacked, mesh: Mesh, function=ReduceFunction.SUM,
                         num_segments: int = 1, wire_dtype: str = None,
                         bidirectional: bool = False, out=None):
    """The segmented ring as one hand-written kernel (K1).  The name keeps
    the JAX driver's; ``wire_dtype`` is a dtype name."""
    wire = _torch_dtype(wire_dtype) if wire_dtype is not None else None

    def compute(xs, outs):
        kring.ring_allreduce(xs, function, num_segments,
                             bidirectional=bidirectional, wire_dtype=wire,
                             out=outs)

    return _run(stacked, mesh, _width(stacked), compute, out)


def run_compressed_allreduce(stacked, mesh: Mesh, function=ReduceFunction.SUM,
                             wire_dtype: str = "bfloat16", out=None):
    """Allreduce with operands narrowed to ``wire_dtype`` (any registered
    lane, by dtype name) on the wire."""
    wire = _torch_dtype(wire_dtype)

    def compute(xs, outs):
        _copy_into(outs, collectives.compressed_allreduce(xs, wire, function))

    return _run(stacked, mesh, _width(stacked), compute, out)


def run_reduce_scatter(stacked, mesh: Mesh, function=ReduceFunction.SUM,
                       out=None):
    def compute(xs, outs):
        _copy_into(outs, collectives.reduce_scatter(xs, function))

    return _run(stacked, mesh, _width(stacked) // mesh.size, compute, out)


def run_allgather(stacked, mesh: Mesh, out=None):
    def compute(xs, outs):
        _copy_into(outs, collectives.allgather(xs))

    return _run(stacked, mesh, _width(stacked) * mesh.size, compute, out)


def run_bcast(stacked, mesh: Mesh, root: int = 0, out=None):
    def compute(xs, outs):
        _copy_into(outs, collectives.bcast(xs, root))

    return _run(stacked, mesh, _width(stacked), compute, out)


def run_reduce(stacked, mesh: Mesh, root: int = 0,
               function=ReduceFunction.SUM, out=None):
    """The ``xla`` lowering: a rank-order fold on the root, zeros
    elsewhere."""
    def compute(xs, outs):
        _copy_into(outs, collectives.reduce(xs, root, function))

    return _run(stacked, mesh, _width(stacked), compute, out)


def run_pallas_reduce(stacked, mesh: Mesh, root: int = 0,
                      function=ReduceFunction.SUM, num_segments: int = 1,
                      out=None):
    """Reduce-to-root as the ring relay kernel (row 10); the root's row is
    the reduction, the others hold partials."""
    def compute(xs, outs):
        krooted.ring_reduce(xs, root, function, num_segments, out=outs)

    return _run(stacked, mesh, _width(stacked), compute, out)


def run_pallas_bcast(stacked, mesh: Mesh, root: int = 0,
                     num_segments: int = 1, out=None):
    """Bcast as the ring relay kernel (row 9); ``out`` may be the operands
    themselves (in place)."""
    def compute(xs, outs):
        krooted.ring_bcast(xs, root, num_segments, out=outs)

    return _run(stacked, mesh, _width(stacked), compute, out)


def run_scatter(stacked, mesh: Mesh, root: int = 0, out=None):
    """Rank r gets block r of the root's operand (width ``size * n``)."""
    def compute(xs, outs):
        _copy_into(outs, collectives.scatter(xs, root))

    return _run(stacked, mesh, _width(stacked) // mesh.size, compute, out)


def run_pallas_scatter(stacked, mesh: Mesh, root: int = 0,
                       num_segments: int = 1, out=None):
    """Scatter as the ring relay kernel (row 11)."""
    def compute(xs, outs):
        krooted.ring_scatter(xs, root, num_segments, out=outs)

    return _run(stacked, mesh, _width(stacked) // mesh.size, compute, out)


def run_gather(stacked, mesh: Mesh, root: int = 0, out=None):
    """The rank-order concatenation on the root, zeros elsewhere."""
    def compute(xs, outs):
        _copy_into(outs, collectives.gather(xs, root))

    return _run(stacked, mesh, _width(stacked) * mesh.size, compute, out)


def run_pallas_gather(stacked, mesh: Mesh, root: int = 0,
                      num_segments: int = 1, out=None):
    """Gather through K3 (store-and-relay).  Every output it is given
    receives the gather (with no ``out``, every row, as in JAX); the
    engine gives the root's alone."""
    def compute(xs, outs):
        krooted.ring_gather(xs, root, num_segments, out=outs)

    return _run(stacked, mesh, _width(stacked) * mesh.size, compute, out)


def run_alltoall(stacked, mesh: Mesh, out=None):
    """Block transpose: rank r's block p is rank p's block r."""
    def compute(xs, outs):
        _copy_into(outs, collectives.alltoall(xs))

    return _run(stacked, mesh, _width(stacked), compute, out)



def _width(stacked) -> int:
    return (stacked.shape[1] if isinstance(stacked, torch.Tensor)
            else stacked[0].shape[0])
