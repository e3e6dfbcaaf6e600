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
lie on; a mesh for the models also names its axes, as JAX's ``("dp",
"tp")`` mesh does, every rank still virtual on the one device.
:func:`make_mesh` runs on the card unless the caller asks for the CPU,
and raises when there is no card.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..constants import ReduceFunction, as_datatype, dtype_to_torch
from . import collectives, ring
from .cuda import ring as kring
from .cuda import rooted as krooted
from .wire import wire_lane_roundtrip_rows


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``size`` ranks on ``device``; ``axis_names`` and ``axis_sizes``
    name the axes of a model mesh (empty for the collectives' 1-D one)."""

    size: int
    device: torch.device
    axis_names: Tuple[str, ...] = ()
    axis_sizes: Tuple[int, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


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


def make_mesh(n: Union[int, Sequence[int]], device=None, *,
              axes: Sequence[str] = ()) -> Mesh:
    """``n`` ranks, or a mesh of the shape ``n`` with one name in ``axes``
    for each of its axes (``make_mesh((dp, tp), axes=("dp", "tp"))``)."""
    shape = (int(n),) if isinstance(n, int) else tuple(int(d) for d in n)
    if (axes or not isinstance(n, int)) and len(axes) != len(shape):
        raise ValueError(f"a mesh of shape {shape} names each of its "
                         f"axes, got {tuple(axes)}")
    if not shape or min(shape) < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    return Mesh(math.prod(shape), resolve_device(device), tuple(axes),
                shape if axes else ())


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


# ---------------------------------------------------------------------------
# prepared handles (the gang's warm path)
# ---------------------------------------------------------------------------


class Prepared:
    """A resolved lowering for one planned call shape: ``handle(xs,
    outs)`` runs it over the per-rank operand tensors ``xs`` (each at
    least ``prep``'s width) into ``outs`` (None: a rank that takes no
    result).  The kernel routes (K1, rows 10 and 11, K3's root-only
    gather) are the kernels' prepared forms, which keep their pointer
    tables by pointers (``ops.cuda._common.PreparedLaunch``).  ``prep = (in_w, wire name or None)`` cuts each operand to
    the call's width and rounds it through the wire (the rooted and
    data-movement ops' compressed lane; the allreduce keeps its lane in
    its lowering)."""

    __slots__ = ("op", "run", "in_w", "wire", "root")

    def __init__(self, op: str, run, in_w: Optional[int], wire, root):
        self.op, self.run, self.in_w, self.wire = op, run, in_w, wire
        self.root = root

    def __call__(self, xs, outs) -> None:
        if self.in_w is not None:
            xs = [x[:self.in_w] for x in xs]
        if self.wire is not None:
            xs = wire_lane_roundtrip_rows(xs, as_datatype(self.wire))
        if self.root is not None:  # the scatter reads the root's alone
            xs = [xs[self.root]] * len(xs)
        self.run(xs, outs)


def prepare(op: str, mesh: Mesh, function=ReduceFunction.SUM, extra=None,
            prep=None) -> Prepared:
    """The prepared handle of a driver op (the JAX driver's ``prepare``):
    ``op`` names the lowering (``allreduce``, ``pallas_allreduce``,
    ``compressed_allreduce``, ``ring_allreduce``, ``reduce`` /
    ``pallas_reduce``, ``scatter`` / ``pallas_scatter``, ``gather`` /
    ``pallas_gather``, ``allgather``, ``reduce_scatter``, ``alltoall``)
    and ``extra`` its resolved arguments.  Handles are cached by the whole
    argument list, so the call form must stay the same between callers:
    ``extra`` omitted here is ``extra=None`` there, as in JAX (whose
    ``lru_cache`` keys tell the two forms apart)."""
    if extra is None:
        return _prepared(op, mesh, function, prep=prep)
    return _prepared(op, mesh, function, extra, prep=prep)


@functools.lru_cache(maxsize=256)
def _prepared(op: str, mesh: Mesh, function=ReduceFunction.SUM, extra=None,
              prep=None) -> Prepared:
    in_w, wire = prep if prep is not None else (None, None)
    fn = ReduceFunction(int(function))
    root = None
    if op == "pallas_allreduce":
        nseg, wire_name, bidir = extra
        run = kring.PreparedAllreduce(
            fn, nseg, bidirectional=bidir,
            wire_dtype=_torch_dtype(wire_name) if wire_name else None)
    elif op == "allreduce":
        def run(xs, outs):
            run_allreduce(xs, mesh, fn, out=outs)
    elif op == "compressed_allreduce":
        def run(xs, outs):
            run_compressed_allreduce(xs, mesh, fn, wire_dtype=extra, out=outs)
    elif op == "ring_allreduce":
        def run(xs, outs):
            run_ring_allreduce(xs, mesh, fn, extra, out=outs)
    elif op == "reduce":
        def run(xs, outs):
            run_reduce(xs, mesh, extra, fn, out=outs)
    elif op in ("scatter", "gather"):
        lowering = run_scatter if op == "scatter" else run_gather
        root = extra if op == "scatter" else None

        def run(xs, outs):
            lowering(xs, mesh, extra, out=outs)
    elif op in ("pallas_reduce", "pallas_scatter", "pallas_gather"):
        r, nseg = extra
        if op == "pallas_reduce":
            run = krooted.PreparedReduce(r, fn, nseg)
        elif op == "pallas_scatter":
            run, root = krooted.PreparedScatter(r, nseg), r
        else:
            run = krooted.PreparedGather(r, nseg)
    elif op == "allgather":
        def run(xs, outs):
            run_allgather(xs, mesh, out=outs)
    elif op == "reduce_scatter":
        def run(xs, outs):
            run_reduce_scatter(xs, mesh, fn, out=outs)
    elif op == "alltoall":
        def run(xs, outs):
            run_alltoall(xs, mesh, out=outs)
    else:
        raise ValueError(f"no prepared lowering {op!r}")
    return Prepared(op, run, in_w, wire, root)

