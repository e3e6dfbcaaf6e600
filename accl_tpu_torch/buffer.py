"""Buffers: a typed 1-D region with a host side and a device side.

The port's counterpart of ``accl_tpu/buffer.py``.  A :class:`DeviceBuffer`
is one torch tensor on the rank's device (a CUDA tensor on the card, a CPU
tensor when the caller asked for the CPU) beside a host tensor on the CPU.
Unlike the JAX package, whose arrays are immutable, the port WRITES
RESULTS IN PLACE: a collective stores into the device tensor, and a slice
is a view that aliases its parent's storage on both sides.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from .constants import DataType, dtype_size, dtype_to_torch

if TYPE_CHECKING:
    import numpy as np


class BaseBuffer:
    """A typed 1-D region with a host view and a device residence."""

    def __init__(self, count: int, dtype: DataType):
        self._count = int(count)
        self._dtype = DataType(dtype)

    @property
    def count(self) -> int:
        return self._count

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nbytes(self) -> int:
        return self._count * dtype_size(self._dtype)

    @property
    def is_dummy(self) -> bool:
        return False

    def sync_to_device(self) -> None:
        raise NotImplementedError

    def sync_from_device(self) -> None:
        raise NotImplementedError

    def slice(self, start: int, stop: int) -> "BaseBuffer":
        raise NotImplementedError

    def host_view(self) -> np.ndarray:
        """The host side as a numpy array sharing its memory (mutating it
        mutates host memory)."""
        raise NotImplementedError


class DeviceBuffer(BaseBuffer):
    """One rank's buffer: ``tensor`` on ``device`` plus a CPU host tensor.

    ``ready`` is the CUDA event recorded after the last device work that
    wrote ``tensor`` (None when nothing is pending, and always None on the
    CPU); readers on another thread or stream wait on it."""

    def __init__(
        self,
        count: int,
        dtype: DataType,
        device,
        tensor: Optional[torch.Tensor] = None,
        host: Optional[torch.Tensor] = None,
    ):
        super().__init__(count, dtype)
        self.device = torch.device(device)
        tdt = dtype_to_torch(dtype)
        self._host = host if host is not None else torch.zeros(count, dtype=tdt)
        if tensor is None:
            tensor = torch.zeros(count, dtype=tdt, device=self.device)
        self.tensor = tensor
        # one event slot shared with every slice of the same storage
        self._ready = [None]

    @property
    def ready(self):
        return self._ready[0]

    @ready.setter
    def ready(self, event) -> None:
        self._ready[0] = event

    @property
    def data(self):
        """The host side as a numpy array sharing its memory, as the JAX
        package's ``data`` is (bfloat16 through ``ml_dtypes``, the dtype
        numpy bfloat16 arrays come from)."""
        if self._host.dtype == torch.bfloat16:
            import ml_dtypes

            return self._host.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
        return self._host.numpy()

    def host_view(self) -> np.ndarray:
        """The host side as a numpy array sharing its memory, as the JAX
        package's ``host_view`` returns it: :attr:`data` (bfloat16 through
        ``ml_dtypes``)."""
        return self.data

    def sync_to_device(self) -> None:
        self.wait_ready()
        self.tensor.copy_(self._host)

    def sync_from_device(self) -> None:
        self.wait_ready()
        self._host.copy_(self.tensor)

    def wait_ready(self) -> None:
        """Block the host until the last device write has finished."""
        ev = self.ready
        if ev is not None:
            ev.synchronize()

    def slice(self, start: int, stop: int) -> "DeviceBuffer":
        """A view of ``[start, stop)`` sharing this buffer's storage on
        both sides."""
        if not 0 <= start <= stop <= self._count:
            raise IndexError(
                f"slice [{start}:{stop}) out of range 0..{self._count}"
            )
        view = DeviceBuffer(
            stop - start, self._dtype, self.device,
            tensor=self.tensor[start:stop], host=self._host[start:stop],
        )
        view._ready = self._ready
        return view


class DummyBuffer(BaseBuffer):
    """Placeholder operand for ranks that contribute no data."""

    def __init__(self, count: int = 0, dtype: DataType = DataType.FLOAT32):
        super().__init__(count, dtype)

    @property
    def is_dummy(self) -> bool:
        return True

    def sync_to_device(self) -> None:
        pass

    def sync_from_device(self) -> None:
        pass

    def slice(self, start: int, stop: int) -> "DummyBuffer":
        return DummyBuffer(stop - start, self._dtype)

    def host_view(self) -> np.ndarray:
        raise RuntimeError("dummy buffer has no storage")


def host_tensor(array) -> torch.Tensor:
    """A 1-D CPU tensor ALIASING ``array`` (numpy or torch).  A numpy
    bfloat16 array is reinterpreted through its 16-bit pattern."""
    if isinstance(array, torch.Tensor):
        return array.reshape(-1).cpu()
    import numpy as np

    arr = np.ascontiguousarray(array).reshape(-1)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def make_buffer(device, count: int, dtype: DataType, data=None) -> DeviceBuffer:
    """A buffer on ``device``; ``data`` (numpy or torch, 1-D after
    flattening) seeds it: the host side aliases it and the device side is
    synced on return."""
    if data is None:
        return DeviceBuffer(count, dtype, device)
    host = host_tensor(data)
    tensor = torch.empty(host.numel(), dtype=host.dtype, device=device)
    tensor.copy_(host)
    return DeviceBuffer(host.numel(), dtype, device, tensor=tensor, host=host)
