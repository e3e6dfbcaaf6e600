"""Carrying state across from the JAX package.

The system holds no weights: its state is the ranks' operands and the
gang's tuning registers.  :func:`stacked_from_numpy` builds the per-rank
operand tensors from the host arrays a JAX caller stacks, and
:func:`tuning_from_jax` maps the JAX gang's register dict
(``XLAGangContext.tuning``, as a plain dict) onto this port's registers.
The sequence-parallel models take a JAX caller's sequence-sharded
operands: :func:`shards_from_numpy` cuts a global array into the per-rank
shards a ``PartitionSpec`` naming the mesh axis on one dim makes (e.g.
``P(None, None, "sp", None)``), and :func:`shards_to_numpy` reassembles
them as ``shard_map``'s out_specs do.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .buffer import host_tensor
from .constants import (
    ALGORITHM_TUNING_KEYS,
    AllreduceAlgorithm,
    DataType,
    ROOTED_ALGORITHMS,
    TUNING_DEFAULTS,
    TuningKey,
)
from .ops.driver import resolve_device
from .wire import is_wire_dtype

_ROOTED_REGISTERS = tuple(k.name.lower() for k in ALGORITHM_TUNING_KEYS
                          if k != TuningKey.ALLREDUCE_ALGORITHM)


def stacked_from_numpy(arrays, device) -> List[torch.Tensor]:
    """One tensor per rank on ``device``, each its own allocation, from a
    stacked ``(P, n)`` numpy array or a sequence of per-rank arrays
    (bfloat16 arrays keep their bits)."""
    return [
        host_tensor(np.ascontiguousarray(a)).to(device, copy=True)
        for a in arrays
    ]


def shards_from_numpy(array, parts: int, axis: int = 2,
                      device=None) -> List[torch.Tensor]:
    """The ``parts`` contiguous shards of ``array`` along ``axis``, in
    rank order, each its own allocation on ``device`` (the card unless
    ``device="cpu"``; raises when there is no card, as the other entry
    points do); bfloat16 arrays keep their bits; the dim must divide by
    ``parts``."""
    device = resolve_device(device)
    arr = np.asarray(array)
    if arr.shape[axis] % parts:
        raise ValueError(
            f"dim {axis} of {arr.shape} does not divide into {parts} shards")
    return [
        host_tensor(np.ascontiguousarray(a)).reshape(a.shape).to(
            device, copy=True)
        for a in np.split(arr, parts, axis=axis)
    ]


def shards_to_numpy(shards, axis: int = 2) -> np.ndarray:
    """The global host array of per-rank shards (the inverse of
    :func:`shards_from_numpy`); bfloat16 widens exactly to float32."""
    return np.concatenate([to_numpy(t) for t in shards], axis=axis)


def tuning_from_jax(tuning: dict) -> dict:
    """This port's register dict for a JAX gang register dict: every
    register of JAX's table carries across by name, checked as the
    port's engine checks a write; a name the table lacks raises."""
    out = dict(TUNING_DEFAULTS)
    for name, value in tuning.items():
        if name == "allreduce_algorithm":
            AllreduceAlgorithm[str(value).upper()]  # raises on an unknown name
            out[name] = str(value)
        elif name in _ROOTED_REGISTERS:
            if AllreduceAlgorithm[str(value).upper()] not in ROOTED_ALGORITHMS:
                raise ValueError(
                    f"{name}={value!r}: a rooted register takes "
                    f"{[a.name.lower() for a in ROOTED_ALGORITHMS]}"
                )
            out[name] = str(value)
        elif name == "ring_segments":
            if int(value) < 1:
                raise ValueError(f"ring_segments {value} < 1")
            out[name] = int(value)
        elif name in ("wire_dtype", "wire_dtype_ici", "wire_dtype_dcn"):
            if int(value) and not is_wire_dtype(int(value)):
                raise ValueError(
                    f"{DataType(int(value)).name} is not a wire lane"
                )
            out[name] = int(value)
        elif name in TUNING_DEFAULTS:
            out[name] = int(value)
        else:
            raise ValueError(f"register {name}={value!r} is not ported")
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``; bfloat16 widens (exactly) to float32,
    since numpy has no bfloat16 of its own."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
