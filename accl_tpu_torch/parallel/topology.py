"""Topology bootstrap: from "what hardware is there" to a ready ACCL group
(the counterpart of ``accl_tpu/parallel/topology.py``).

Role model: ``driver/utils/accl_network_utils`` — the ``acclDesign`` enum
{AXIS3x, TCP, UDP, CYT_TCP, CYT_RDMA} (include/accl_network_utils.hpp:32),
rank generation from JSON cluster files or synthetic subnets
(``generate_ranks``), and the one-call ``initialize_accl``.  In the port
the ICI design is the gang on one card's virtual ranks (``cuda_group``);
the emulated and native host tiers (ROADMAP A12) and the multi-process
tier (A6) are not ported yet, and their designs raise
``NotImplementedError`` naming the item.  The ``xclbin_scan``
memory-topology role maps to the CUDA caching allocator's figures.
"""

from __future__ import annotations

import enum
import json
from typing import Dict, List, Optional

import torch

from ..communicator import Rank
from ..constants import DEFAULT_RX_BUFFER_SIZE
from ..ops.driver import Mesh, make_mesh, resolve_device


class Design(enum.Enum):
    """Which transport/backend fabric to bootstrap (ref acclDesign)."""

    INPROC = "inproc"  # emulated, all ranks in one process (CI tier)
    SOCKET = "socket"  # emulated, one process per rank over TCP
    NATIVE = "native"  # C++ engine, all ranks in one process
    NATIVE_SOCKET = "native_socket"  # C++ engine, one process per rank
    ICI = "ici"  # the gang: every rank virtual on one device
    XLA_DIST = "xla_dist"  # one process per rank


#: the designs whose tiers the port has not yet, by ROADMAP item
_UNPORTED = {
    Design.INPROC: "A12", Design.SOCKET: "A12", Design.NATIVE: "A12",
    Design.NATIVE_SOCKET: "A12", Design.XLA_DIST: "A6",
}


def generate_ranks(
    design: Design,
    world: int,
    json_path: Optional[str] = None,
    base_port: int = 47000,
    segment_size: int = DEFAULT_RX_BUFFER_SIZE,
) -> List[Rank]:
    """Rank table for a world (ref generate_ranks: JSON cluster file or
    synthetic subnet)."""
    if json_path is not None:
        with open(json_path) as f:
            entries = json.load(f)
        return [
            Rank(
                address=e["address"],
                session=e.get("session", i),
                max_segment_size=e.get("max_segment_size", segment_size),
            )
            for i, e in enumerate(entries)
        ]
    if design == Design.INPROC:
        return [
            Rank(f"inproc:{i}", session=i, max_segment_size=segment_size)
            for i in range(world)
        ]
    if design == Design.SOCKET:
        return [
            Rank(f"127.0.0.1:{base_port + i}", session=i, max_segment_size=segment_size)
            for i in range(world)
        ]
    return [Rank(f"xla:{i}", session=i, max_segment_size=segment_size) for i in range(world)]


def bootstrap(
    design: Design,
    world: int,
    rank: Optional[int] = None,
    json_path: Optional[str] = None,
    base_port: int = 47000,
    **kwargs,
):
    """One-call group construction (ref initialize_accl), with JAX's
    signature: ``Design.ICI`` returns the whole gang, ``cuda_group(world,
    **kwargs)`` (on the card unless ``device=`` asks for another; raising
    when there is no card), and ignores ``rank``, ``json_path`` and
    ``base_port`` as JAX's ICI design does.  The other designs raise
    ``NotImplementedError`` until their tiers are ported."""
    from ..core import cuda_group

    if design == Design.ICI:
        return cuda_group(world, **kwargs)
    if design in _UNPORTED:
        raise NotImplementedError(
            f"Design.{design.name}: its tier is not ported yet (ROADMAP "
            f"{_UNPORTED[design]}); Design.ICI runs the gang")
    raise ValueError(design)


def mesh_from_topology(axes: Optional[Dict[str, int]] = None,
                       device=None) -> Mesh:
    """A :class:`~accl_tpu_torch.ops.driver.Mesh` of named axes, every
    rank virtual on ``device`` (the card unless the caller asks for the
    CPU): the card's memory, not a device count, bounds the ranks.  With
    no axes, one rank per visible CUDA device on the axis ``"ranks"`` (one
    on the CPU)."""
    if axes:
        return make_mesh(tuple(axes.values()), device,
                         axes=tuple(axes.keys()))
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_mesh((n,), dev, axes=("ranks",))


def device_memory_report(device=None) -> List[Dict]:
    """Per-device memory (the xclbin_scan role: what memory banks exist
    and how full they are): one entry per CUDA device with the caching
    allocator's allocated bytes and the card's total memory; raises when
    there is no card.  ``device="cpu"`` gives one ``"cpu"`` entry, whose
    byte counts are None, as JAX's CPU devices report none."""
    if resolve_device(device).type != "cuda":
        return [{"id": 0, "platform": "cpu", "kind": "cpu",
                 "bytes_in_use": None, "bytes_limit": None}]
    report = []
    for i in range(torch.cuda.device_count()):
        report.append({
            "id": i, "platform": "gpu",
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        })
    return report
