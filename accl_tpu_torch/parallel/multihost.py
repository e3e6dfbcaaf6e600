"""Multi-host bootstrap: DCN x ICI meshes over ``torch.distributed`` (the
counterpart of ``accl_tpu/parallel/multihost.py``).

The reference scales beyond one FPGA cluster node with MPI process launch
plus per-rank IP/session tables; on TPU pods JAX splits that role into
ICI (chips inside a slice) and DCN (the network between hosts).  In the
port a node's NVLink group plays ICI and the network between nodes plays
DCN.  ``torch.distributed`` is the process bootstrap (the mpirun +
rank-table role): a coordinator address and (rank, world size) wire every
process into one group, NCCL on the card and gloo on the CPU.

A mesh here is :class:`~accl_tpu_torch.ops.driver.Mesh`: ranks virtual on
one device.  :func:`hybrid_mesh` lays the DCN axis outermost, as JAX's
does, so the trainers read a dp-over-DCN layout unchanged; ranks on
distinct devices need the collectives across cards (ROADMAP A9c, B14).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.driver import Mesh, make_mesh, resolve_device


def _visible_devices(ids: Optional[Sequence[int]] = None) -> List[torch.device]:
    """This process's devices: the listed CUDA devices, else every visible
    one, else the CPU."""
    if ids is not None:
        return [torch.device("cuda", int(i)) for i in ids]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([torch.device("cuda", i) for i in range(n)]
            or [torch.device("cpu")])


@dataclass
class MultihostContext:
    """What ``bootstrap_multihost`` gives back: identity + topology."""

    process_id: int
    num_processes: int
    coordinator_address: Optional[str]
    local_device_ids: Optional[Sequence[int]] = None
    #: every process's devices in process order, gathered at bootstrap
    _global: Optional[List[torch.device]] = field(default=None, repr=False)

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def local_devices(self) -> List[torch.device]:
        return _visible_devices(self.local_device_ids)

    def global_devices(self) -> List[torch.device]:
        """Every process's devices, in process order (``jax.devices()``'s
        role); this process's alone on the single-process path."""
        return list(self._global) if self._global is not None \
            else self.local_devices()

    def process_count(self) -> int:
        import torch.distributed as dist

        return dist.get_world_size() if dist.is_initialized() else 1


def bootstrap_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    auto: bool = False,
) -> MultihostContext:
    """Join (or run standalone in) a multi-process ``torch.distributed``
    group.

    With ``auto=True`` torchrun's environment supplies the coordinator and
    ranks (``init_method="env://"``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``) — the counterpart of JAX's cluster
    detection.  Otherwise pass ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id``: they play the role of the
    reference's rank JSON + ``mpirun`` rank/size.  ``local_device_ids``
    names this process's CUDA devices; the first becomes current.

    With no coordinator, no explicit world size, and ``auto=False`` this is
    the single-process path — ``torch.distributed`` is never touched, so
    the same code works in tests and single-host runs.
    """
    if (
        not auto
        and coordinator_address is None
        and num_processes is None
        and process_id is None
    ):
        return MultihostContext(0, 1, None, local_device_ids)
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    if auto:
        dist.init_process_group(backend, init_method="env://")
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "bootstrap_multihost needs coordinator_address, "
                "num_processes and process_id together (or auto=True)")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    local = _visible_devices(local_device_ids)
    every: List[Optional[List[str]]] = [None] * dist.get_world_size()
    dist.all_gather_object(every, [str(d) for d in local])
    return MultihostContext(
        dist.get_rank(), dist.get_world_size(), coordinator_address,
        local_device_ids,
        [torch.device(d) for devs in every for d in devs])


def _default_devices() -> List[torch.device]:
    """One rank per visible CUDA device, virtual on the current one (the
    port's meshes hold one device); raises when there is no card."""
    dev = resolve_device(None)
    return [dev] * torch.cuda.device_count()


def hybrid_mesh(
    dcn_axis: str = "dcn",
    ici_axes: Optional[Dict[str, int]] = None,
    *,
    devices: Optional[Sequence] = None,
    allow_split_physical_axes: bool = False,
) -> Mesh:
    """A mesh whose outer axis crosses hosts (DCN) and whose inner axes
    stay inside a node's NVLink group (ICI), named ``(dcn_axis,
    *ici_axes)``.

    ``devices`` lists one device a rank (on one card the list repeats
    it; default: one rank per visible CUDA device).  ``ici_axes`` maps
    axis names to sizes for the per-node sub-mesh (default ``{"ici":
    <local devices>}``); the DCN axis size is ``len(devices) //
    prod(ici_axes)``.  The ranks run virtual on the one device the list
    names; a list of distinct devices raises ``NotImplementedError``
    until the collectives run across cards.  ``allow_split_physical_axes``
    is JAX's option for slice-aware TPU layouts; no CUDA device has
    slices, so the split is always contiguous."""
    del allow_split_physical_axes  # no slice topology to split
    devs = ([resolve_device(d) for d in devices] if devices is not None
            else _default_devices())
    n = len(devs)
    if ici_axes:
        ici = math.prod(ici_axes.values())
    else:
        per = len(_visible_devices())
        ici_axes = {"ici": per}
        ici = per
    if n % ici:
        raise ValueError(
            f"{n} devices do not divide into ICI submeshes of {ici}"
        )
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"ranks on distinct devices {sorted(map(str, set(devs)))} need "
            f"the collectives across cards (ROADMAP A9c, B14)")
    return make_mesh((n // ici, *ici_axes.values()), devs[0],
                     axes=(dcn_axis, *ici_axes.keys()))


def dp_over_dcn_mesh(tp: int = 1, dcn_axis: str = "dp", tp_axis: str = "tp",
                     *, devices: Optional[Sequence] = None) -> Mesh:
    """The canonical two-level training layout: model (tp) inside a node
    on ICI, data parallel across nodes on DCN."""
    n = len(devices) if devices is not None else len(_default_devices())
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return hybrid_mesh(dcn_axis, {tp_axis: tp}, devices=devices)
