"""Build the CUDA sources under ``accl_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries land in ``csrc/build/`` named by a hash
of their sources, so an edited source rebuilds and an unchanged one is
reused; beside each, ``lib<name>-<hash>.log`` keeps nvcc's output (with
ptxas's register and spill counts, :func:`build_log`).  :func:`build_all` starts one ``nvcc`` per source at once.

Each wrapper module holds a table of its libraries' C prototypes
(``PROTOTYPES``: library name -> entry point -> ctypes argument types;
every entry point returns its launch's ``cudaError_t`` as an ``int``).
:func:`library` declares them once, when it loads the library, so no
launch re-declares them (``tests/test_torch_launch_path.py`` holds each table
against the ``extern "C"`` signatures in ``csrc``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers and spills per kernel, into the build log
    "--split-compile=0",  # a source's kernels optimised on every core
]

# the ctypes kinds of the C parameters: a pointer, long long, int, float
# and double
PTR, LL, INT, FLOAT, DOUBLE = (ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_float, ctypes.c_double)

#: the entry point every library has (``common.cuh``): its restype and
#: argument types
ERROR_STRING = ("accl_error_string", ctypes.c_char_p, (INT,))

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels are built on first use"
        )
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(process, tmp, out, log)`` or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, log


def _finish(name: str, job) -> None:
    proc, tmp, out, log = job
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> List[str]:
    """Build every source not yet built, all ``nvcc`` runs in parallel;
    returns the names built."""
    with _lock:
        jobs = {name: _start(name) for name in sources()}
        jobs = {k: v for k, v in jobs.items() if v is not None}
        errors = []
        for name, job in jobs.items():
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return sorted(jobs)


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu``'s current library."""
    return _lib_path(name).with_suffix(".log").read_text()


def library(name: str,
            prototypes: Mapping[str, Sequence[type]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``prototypes`` (entry point -> argument types, each returning an
    ``int``) declared when it loads."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn, restype, argtypes = ERROR_STRING
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
            for fn, argtypes in prototypes.items():
                getattr(lib, fn).restype = INT
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
    return lib
