"""Token-stream input pipeline over the native C++ prefetching loader.

The counterpart of ``accl_tpu/data.py``.  ``csrc/dataloader.cpp`` (the
port's own copy of the JAX package's loader) mmaps a binary token file
and assembles ``(batch, seq + 1)`` windows on a background thread into a
bounded ring, so the step loop only copies a ready batch while the next
one is being built.  Sampling is stateless and deterministic
(splitmix64 of ``seed ^ step ^ row`` into this shard's stripe): exact
checkpoint resume by ``seek(step)``, disjoint dp shards, and the same
batch as the JAX loader for the same (file, seed, step, shard).

The library is built with the host's ``g++`` at first use into
``csrc/build/`` (named by a hash of its source, so an edited source
rebuilds); a failed build raises with the compiler's output.  Batches
come back as int32 CPU tensors; the trainer moves them to its device.

File format ``ACCLTOK1``: 8-byte magic, u32 dtype code (2 = uint16,
4 = uint32), u64 token count, raw little-endian ids.
:func:`write_token_file` produces it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_MAGIC = b"ACCLTOK1"

_ERRORS = {
    -1: "cannot open file",
    -2: "bad magic/header (not an ACCLTOK1 file?)",
    -3: "file too small for one window (need seq+2 tokens per shard)",
    -4: "invalid arguments",
    -5: "loader closed",
}

_SOURCE = Path(__file__).resolve().parent / "csrc" / "dataloader.cpp"
_BUILD_DIR = _SOURCE.parent / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall"]

_lock = threading.Lock()
_lib = None


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a 1-D integer token array in the ``ACCLTOK1`` format (uint16
    when every id fits, else uint32), published atomically."""
    tokens = np.ascontiguousarray(np.asarray(tokens).reshape(-1))
    if not np.issubdtype(tokens.dtype, np.integer):
        raise ValueError(f"token ids must be integers, got {tokens.dtype}")
    if tokens.size and int(tokens.min()) < 0:
        raise ValueError("token ids must be non-negative")
    wide = tokens.size and int(tokens.max()) > 0xFFFF
    arr = tokens.astype(np.uint32 if wide else np.uint16)
    header = _MAGIC + np.uint32(arr.itemsize).tobytes() + np.uint64(
        arr.size
    ).tobytes()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(arr.tobytes())
    os.replace(tmp, path)  # atomic publish


def library_path() -> Path:
    """The loader library for the current source and flags."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _BUILD_DIR / f"libaccl_dataloader-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the loader library unless it exists; raises RuntimeError with
    the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {_SOURCE.name} with {cxx} failed: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {_SOURCE.name} with {cxx} failed "
            f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c = ctypes
        lib.accl_dl_open.restype = c.c_int
        lib.accl_dl_open.argtypes = [
            c.c_char_p, c.c_uint64, c.c_uint64, c.c_uint64, c.c_uint64,
            c.c_uint64, c.c_uint64, c.c_uint64, c.POINTER(c.c_void_p),
        ]
        lib.accl_dl_next.restype = c.c_int
        lib.accl_dl_next.argtypes = [
            c.c_void_p, c.POINTER(c.c_uint32), c.POINTER(c.c_uint64),
        ]
        lib.accl_dl_seek.restype = c.c_int
        lib.accl_dl_seek.argtypes = [c.c_void_p, c.c_uint64]
        lib.accl_dl_token_count.restype = c.c_int
        lib.accl_dl_token_count.argtypes = [c.c_void_p,
                                            c.POINTER(c.c_uint64)]
        lib.accl_dl_close.restype = c.c_int
        lib.accl_dl_close.argtypes = [c.c_void_p]
        _lib = lib
        return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: {_ERRORS.get(rc, f'error {rc}')}")


class TokenLoader:
    """Prefetching reader of an ``ACCLTOK1`` token file.

    Each :meth:`next` returns ``(tokens, targets, step)``: int32 CPU
    tensors of shape ``(batch, seq)`` (targets the one-position shift of
    the same window) and the step the window was drawn for."""

    def __init__(self, path: str, batch: int, seq: int, *, shard: int = 0,
                 num_shards: int = 1, seed: int = 0, start_step: int = 0,
                 prefetch_depth: int = 2):
        self._lib = _load_lib()
        self._handle = None
        self.batch, self.seq = int(batch), int(seq)
        handle = ctypes.c_void_p()
        rc = self._lib.accl_dl_open(
            str(path).encode(), self.batch, self.seq, shard, num_shards,
            seed, start_step, prefetch_depth, ctypes.byref(handle),
        )
        _check(rc, f"open {path}")
        self._handle = handle
        self._buf = np.empty(self.batch * (self.seq + 1), np.uint32)

    @property
    def token_count(self) -> int:
        out = ctypes.c_uint64()
        _check(
            self._lib.accl_dl_token_count(self._handle, ctypes.byref(out)),
            "token_count",
        )
        return int(out.value)

    def next(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        step = ctypes.c_uint64()
        rc = self._lib.accl_dl_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.byref(step),
        )
        _check(rc, "next")
        win = torch.from_numpy(
            self._buf.reshape(self.batch, self.seq + 1).astype(np.int32))
        return (win[:, :-1].contiguous(), win[:, 1:].contiguous(),
                int(step.value))

    def seek(self, step: int) -> None:
        """Reposition at ``step`` (checkpoint resume): prefetched batches
        are dropped and production restarts there."""
        _check(self._lib.accl_dl_seek(self._handle, int(step)), "seek")

    def close(self) -> None:
        if self._handle is not None:
            self._lib.accl_dl_close(self._handle)
            self._handle = None

    def __enter__(self) -> "TokenLoader":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
