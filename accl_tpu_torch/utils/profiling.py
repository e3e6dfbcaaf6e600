"""Profiler hooks: ``torch.profiler`` and NVTX ranges — the device-side
tracing surface (the counterpart of ``accl_tpu/utils/profiling.py``).

The reference's tracing story is a free-running hardware counter copied
into exchange memory per call (`ccl_offload_control.c:2279-2303`) plus
host timers; the port layers up as the JAX package does:

* per-call ns: ``Request.get_duration_ns`` (``ACCL.get_duration``);
* per-call records: the telemetry plane (``accl_tpu_torch.telemetry``)
  rings every completion into the flight recorder and exports
  Chrome/Perfetto spans named ``accl::<op>`` — the SAME naming the gang
  engine's :func:`annotate` ranges carry, so host ranges and exported
  spans line up;
* host ranges: :func:`annotate` names a region as an NVTX range (seen by
  ``nsys``) and, while a ``torch.profiler`` session runs, as a
  ``record_function`` range of the profiler's trace, which encloses the
  CUDA runtime launches made inside it (their kernels' device events
  correlate to those launches);
* whole-program capture: :func:`trace` / :func:`start_server` drive
  ``torch.profiler`` and write a Chrome trace (open it in Perfetto or
  ``chrome://tracing``);
* device memory: :func:`device_memory_profile` is the caching
  allocator's snapshot, in the format ``torch/cuda/_memory_viz.py``
  reads.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from ..ops.driver import resolve_device

#: ``/capture``'s longest window (ms): a scrape must not hold the
#: profiler, which admits one session a process, for long
MAX_CAPTURE_MS = 60_000


class annotate:
    """A named host range: an NVTX range once CUDA is initialised, and a
    ``torch.profiler.record_function`` range while a profiler session is
    active (checked by the profiler's own flag, so a warm call pays no
    range object when nothing records).  A context manager either way;
    an exception from the wrapped code passes through."""

    __slots__ = ("_name", "_nvtx", "_range")

    def __init__(self, name: str):
        self._name = name
        self._nvtx = False
        self._range = None

    def __enter__(self):
        if torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(self._name)
            self._nvtx = True
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        return False


def device_scope(name: str) -> annotate:
    """JAX names a region inside a jitted program (XLA op metadata).
    Eager PyTorch has no in-program scope: each kernel is launched from
    the host, so this is the same host range as :func:`annotate`, whose
    launches the profiler correlates to their kernels."""
    return annotate(name)


@contextlib.contextmanager
def trace(logdir: str, *, host_tracer_level: int = 2) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of everything inside the block,
    on every thread of the process, into a Chrome trace file
    (``trace_*.json``) in ``logdir``.  The CPU activity always, the CUDA
    activity (runtime launches and kernels) when a card is present.
    ``host_tracer_level`` maps JAX's host tracer levels: up to 2 (JAX's
    default) records ops, ranges and launches; 3 or more also records
    each op's input shapes and Python stacks."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    verbose = host_tracer_level >= 3
    # every thread: the gang runs a call on the thread of the rank that
    # completed it, not on the thread that opened the trace
    prof = profile(activities=activities, record_shapes=verbose,
                   with_stack=verbose,
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    prof.start()
    if torch.cuda.is_initialized():
        # CUPTI sets up its activity buffers at a session's first kernel,
        # whose device record can then be lost (seen on an H100 in a
        # process that had traced before): a one-element fill takes that
        # launch
        torch.zeros(1, device=torch.cuda.current_device())
        torch.cuda.synchronize()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json",
                                    dir=logdir)
        os.close(fd)
        prof.export_chrome_trace(path)


def _capture(query: dict) -> str:
    """``/capture?ms=N``: profile the process for N ms; the Chrome trace."""
    ms = int(query.get("ms", ["1000"])[0])
    if not 0 < ms <= MAX_CAPTURE_MS:
        raise ValueError(f"ms={ms}: a capture takes 1 to {MAX_CAPTURE_MS}")
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            time.sleep(ms / 1e3)
        (name,) = os.listdir(logdir)
        with open(os.path.join(logdir, name)) as f:
            return f.read()


def start_server(port: int = 9012):
    """Live capture endpoint (JAX's profiler server's role): a stdlib HTTP
    server on an ``accl-monitor`` thread whose ``GET /capture?ms=N``
    profiles the whole process for N ms and returns the Chrome trace.
    Port 0 takes a free one (``server.port``); ``server.stop()`` ends
    it."""
    from ..monitor import MonitorServer

    return MonitorServer(
        {"/capture": (_capture, "application/json", True)},
        port=port).start()


def device_memory_profile(backend: Optional[str] = None) -> bytes:
    """The caching allocator's snapshot of live device memory, pickled
    (``torch.cuda.memory._snapshot()``; ``torch/cuda/_memory_viz.py``
    reads it).  ``None`` means the card, and raises when there is none;
    ``backend="cpu"`` gives the same structure with no segments."""
    if backend == "cpu":
        return pickle.dumps({"segments": [], "device_traces": []})
    if backend not in (None, "gpu", "cuda"):
        raise ValueError(f"backend {backend!r}: 'cpu', 'gpu' or None")
    resolve_device("cuda")
    return pickle.dumps(torch.cuda.memory._snapshot())
