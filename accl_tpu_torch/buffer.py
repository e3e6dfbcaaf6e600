"""Buffers: a typed 1-D region with a host side and a device side.

The port's counterpart of ``accl_tpu/buffer.py``.  A :class:`DeviceBuffer`
is one torch tensor on the rank's device (a CUDA tensor on the card, a CPU
tensor when the caller asked for the CPU) beside a host tensor on the CPU.
Unlike the JAX package, whose arrays are immutable, the port WRITES
RESULTS IN PLACE: a collective stores into the device tensor, and a slice
is a view that aliases its parent's storage on both sides.  A
:class:`HostBuffer` (``create_buffer(..., host_only=True)``) is host
memory alone.
"""

from __future__ import annotations

import threading
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

    @property
    def is_host_only(self) -> bool:
        return False

    def sync_to_device(self) -> None:
        raise NotImplementedError

    def sync_from_device(self) -> None:
        raise NotImplementedError

    def free_buffer(self) -> None:
        pass

    def slice(self, start: int, stop: int) -> "BaseBuffer":
        raise NotImplementedError

    def host_view(self) -> np.ndarray:
        """The host side as a numpy array sharing its memory (mutating it
        mutates host memory)."""
        raise NotImplementedError

    def device_view(self) -> np.ndarray:
        """A numpy array of the device side (the host-staged path's
        reader)."""
        raise NotImplementedError


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array sharing its memory (bfloat16 through
    ``ml_dtypes``, the dtype numpy bfloat16 arrays come from)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _check_range(start: int, stop: int, count: int) -> None:
    if not 0 <= start <= stop <= count:
        raise IndexError(f"slice [{start}:{stop}) out of range 0..{count}")


class HostBuffer(BaseBuffer):
    """A host-only buffer: host memory with no device side (the JAX
    package's ``EmuBuffer`` with ``host_only``).  A collective with such
    an operand or result takes the gang's host-staged path; the device
    view IS the host memory, so the syncs have nothing to do."""

    def __init__(self, count: int, dtype: DataType,
                 host: Optional[torch.Tensor] = None):
        super().__init__(count, dtype)
        self._host = (host if host is not None
                      else torch.zeros(count, dtype=dtype_to_torch(dtype)))
        self.device = torch.device("cpu")

    @property
    def is_host_only(self) -> bool:
        return True

    @property
    def tensor(self) -> torch.Tensor:
        """The host memory as a CPU tensor."""
        return self._host

    @property
    def data(self):
        return _numpy(self._host)

    def host_view(self) -> np.ndarray:
        return self.data

    def device_view(self) -> np.ndarray:
        return self.data

    def sync_to_device(self) -> None:
        pass

    def sync_from_device(self) -> None:
        pass

    def slice(self, start: int, stop: int) -> "HostBuffer":
        _check_range(start, stop, self._count)
        return HostBuffer(stop - start, self._dtype,
                          host=self._host[start:stop])


class DeviceBuffer(BaseBuffer):
    """One rank's buffer: ``tensor`` on ``device`` plus a CPU host tensor.

    ``ready`` is the CUDA event recorded after the last device work that
    wrote ``tensor`` (None when nothing is pending, and always None on the
    CPU); readers on another thread or stream wait on it.

    A slice is a view: its ``tensor`` and host side alias the parent's
    storage, and ``_parent`` / ``_offset`` name where it lies.  An engine
    may park a result placement on a buffer (:meth:`defer_store`, the
    lazy adoption of the JAX package's ``DeviceBuffer``); it lives on the
    ROOT buffer and runs, in issue order, on :meth:`resolve_pending`,
    which every device read (:meth:`device_array`, :meth:`device_view`,
    the syncs, :meth:`store`) calls first, as the gang does before a call
    reads or writes the buffer."""

    def __init__(
        self,
        count: int,
        dtype: DataType,
        device,
        tensor: Optional[torch.Tensor] = None,
        host: Optional[torch.Tensor] = None,
        parent: Optional["DeviceBuffer"] = None,
        offset: int = 0,
    ):
        super().__init__(count, dtype)
        self.device = torch.device(device)
        tdt = dtype_to_torch(dtype)
        self._host = host if host is not None else torch.zeros(count, dtype=tdt)
        if tensor is None:
            tensor = torch.zeros(count, dtype=tdt, device=self.device)
        self.tensor = tensor
        self._parent = parent
        self._offset = int(offset)
        # one event slot shared with every slice of the same storage
        self._ready = [None]
        # the parked result placement (root buffers only), and the
        # reentrant lock that makes park / resolve atomic and ordered:
        # a resolver that loses the race waits until the winner's thunk
        # has landed, and a thunk's own store() re-entering
        # resolve_pending on the same thread cannot deadlock
        self._pending = None
        self._plock = threading.RLock()

    @property
    def ready(self):
        return self._ready[0]

    @ready.setter
    def ready(self, event) -> None:
        self._ready[0] = event

    @property
    def data(self):
        """The host side as a numpy array sharing its memory, as the JAX
        package's ``data`` is (bfloat16 through ``ml_dtypes``)."""
        return _numpy(self._host)

    def host_view(self) -> np.ndarray:
        """The host side as a numpy array sharing its memory, as the JAX
        package's ``host_view`` returns it: :attr:`data`."""
        return self.data

    # -- lazy result placement ---------------------------------------------
    def _root(self) -> "DeviceBuffer":
        buf = self
        while buf._parent is not None:
            buf = buf._parent
        return buf

    def _root_offset(self) -> int:
        buf, off = self, 0
        while buf._parent is not None:
            off += buf._offset
            buf = buf._parent
        return off

    def defer_store(self, thunk) -> None:
        """Park a result-placement thunk (engine side), chained after any
        earlier pending one so partial writes land in issue order."""
        root = self._root()
        with root._plock:
            prev = root._pending
            if prev is None:
                root._pending = thunk
            else:
                def chained(prev=prev, thunk=thunk):
                    prev()
                    thunk()

                root._pending = chained

    def resolve_pending(self) -> None:
        """Run the parked placement, once (idempotent; the thunk runs
        inside the reentrant lock, so a concurrent resolver cannot read
        the storage before it has landed)."""
        root = self._root()
        if root._pending is None:
            return
        with root._plock:
            thunk, root._pending = root._pending, None
            if thunk is not None:
                thunk()

    # -- the device side ----------------------------------------------------
    def device_array(self) -> torch.Tensor:
        """The device tensor (a view for a slice), after any parked
        placement."""
        self.resolve_pending()
        return self.tensor

    def device_view(self) -> np.ndarray:
        """A host copy of the device side (the host-staged path's reader;
        the device path never calls it)."""
        self.resolve_pending()
        self.wait_ready()
        return _numpy(self.tensor.detach().cpu())

    def store(self, array: torch.Tensor, count: Optional[int] = None) -> bool:
        """Engine-side result placement: write the first ``count``
        elements of ``array`` (on any device) into the device side.  The
        port's kernels write results in place, and a slice aliases its
        parent's storage, so a store is always a copy into that storage
        (the JAX package's writeback; it never swaps pointers).  Returns
        True when a copy ran."""
        self.resolve_pending()
        n = self._count if count is None else int(count)
        if array.dim() != 1 or array.shape[0] < n or n > self._count:
            raise ValueError(
                f"store of shape {tuple(array.shape)} into {n} elements of "
                f"a {self._count}-element buffer"
            )
        if array.dtype != self.tensor.dtype:
            raise TypeError(
                f"store dtype {array.dtype} != buffer dtype {self._dtype.name}"
            )
        if n == 0:
            return False
        dst = self.tensor[:n]
        if dst.is_cuda:
            stream = torch.cuda.current_stream(dst.device)
            if self.ready is not None:
                stream.wait_event(self.ready)
            dst.copy_(array[:n], non_blocking=not array.is_cpu)
            ev = torch.cuda.Event()
            ev.record(stream)
            self.ready = ev
        else:
            dst.copy_(array[:n])
        return True

    def sync_to_device(self) -> None:
        self.resolve_pending()
        self.wait_ready()
        self.tensor.copy_(self._host)

    def sync_from_device(self) -> None:
        self.resolve_pending()
        self.wait_ready()
        self._host.copy_(self.tensor)

    def wait_ready(self) -> None:
        """Block the host until the last device write has finished."""
        ev = self.ready
        if ev is not None:
            ev.synchronize()

    def free_buffer(self) -> None:
        """Release the device side.  Only the ROOT's free drops a parked
        placement (moot once the storage dies); freeing a slice must not
        discard a store meant for the root or a sibling."""
        root = self._root()
        if root is self:
            with root._plock:
                root._pending = None
            self.wait_ready()
            self.tensor = self.tensor.new_empty(0)

    def slice(self, start: int, stop: int) -> "DeviceBuffer":
        """A view of ``[start, stop)`` sharing this buffer's storage on
        both sides."""
        _check_range(start, stop, self._count)
        view = DeviceBuffer(
            stop - start, self._dtype, self.device,
            tensor=self.tensor[start:stop], host=self._host[start:stop],
            parent=self, offset=start,
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

    def device_view(self) -> np.ndarray:
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


def make_buffer(device, count: int, dtype: DataType, data=None,
                host_only: bool = False) -> BaseBuffer:
    """A buffer on ``device`` (a :class:`HostBuffer` when ``host_only``);
    ``data`` (numpy or torch, 1-D after flattening) seeds it: the host
    side aliases it and the device side is synced on return."""
    if host_only:
        if data is None:
            return HostBuffer(count, dtype)
        host = host_tensor(data)
        return HostBuffer(host.numel(), dtype, host=host)
    if data is None:
        return DeviceBuffer(count, dtype, device)
    host = host_tensor(data)
    tensor = torch.empty(host.numel(), dtype=host.dtype, device=device)
    tensor.copy_(host)
    return DeviceBuffer(host.numel(), dtype, device, tensor=tensor, host=host)
