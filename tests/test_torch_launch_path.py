"""The kernel tier's launch path, on the CPU.

* Every ``extern "C"`` entry point in ``accl_tpu_torch/csrc/*.cu`` (and
  the headers each includes) against the ctypes prototype its wrapper
  module declares in ``PROTOTYPES``, which ``_build.library`` applies
  once when it loads the library: the same count and kinds of arguments
  (a pointer is ``c_void_p``, ``long long`` ``c_longlong``, ``int``
  ``c_int``, ``float`` ``c_float``, ``double`` ``c_double``) and an
  ``int`` return.  A wrong table would pass a pointer as a 32-bit int
  without a word; no library is built here, so this is where it shows.
* The launch-path helpers the wrappers share (``on_cuda``, ``pointers``,
  ``aligned16``, ``pointer_table``) and row 19's wrapper on the CPU.
"""

import ctypes
import importlib
import pkgutil
import re
from pathlib import Path

import pytest
import torch

from accl_tpu_torch.ops import cuda as kc
from accl_tpu_torch.ops.cuda import _build
from accl_tpu_torch.ops.cuda._common import (
    aligned16,
    on_cuda,
    pointer_table,
    pointers,
)

_EXTERN = re.compile(r'extern\s+"C"\s+([^;{}()]*?)\s*\b(\w+)\s*\(([^)]*)\)'
                     r'\s*\{', re.S)
_INCLUDE = re.compile(r'#include\s+"([\w.]+)"')
_KINDS = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
          "float": ctypes.c_float, "double": ctypes.c_double}


def _c_kind(param: str):
    """The ctypes type a C parameter declaration takes."""
    if "*" in param:
        return ctypes.c_void_p
    words = [w for w in param.split() if w != "const"][:-1]  # drop the name
    return _KINDS[" ".join(words)]


def _entries(path: Path, seen=None) -> dict:
    """``{name: (return type, [ctypes kinds])}`` of the ``extern "C"``
    functions of one source and the headers it includes."""
    seen = set() if seen is None else seen
    if path in seen:
        return {}
    seen.add(path)
    text = path.read_text()
    out = {}
    for inc in _INCLUDE.findall(text):
        out.update(_entries(path.parent / inc, seen))
    for ret, name, params in _EXTERN.findall(text):
        params = [p.strip() for p in params.split(",") if p.strip()]
        out[name] = (" ".join(ret.split()), [_c_kind(p) for p in params])
    return out


def _tables() -> dict:
    """Every wrapper module's ``PROTOTYPES``, by library; fails when two
    modules declare one library."""
    tables = {}
    for mod in pkgutil.iter_modules(kc.__path__):
        m = importlib.import_module(f"{kc.__name__}.{mod.name}")
        for lib, table in getattr(m, "PROTOTYPES", {}).items():
            assert lib not in tables, f"{lib} declared twice"
            tables[lib] = table
    return tables


def test_every_library_has_its_table():
    assert sorted(_tables()) == _build.sources()


@pytest.mark.parametrize("name", _build.sources())
def test_prototypes_match_the_c_entry_points(name):
    entries = _entries(_build.CSRC / f"{name}.cu")
    fn, restype, argtypes = _build.ERROR_STRING
    assert entries.pop(fn) == ("const char*", list(argtypes))
    assert restype is ctypes.c_char_p
    table = _tables()[name]
    assert sorted(entries) == sorted(table)
    for fn, (ret, kinds) in entries.items():
        assert ret == "int", fn
        assert list(table[fn]) == kinds, fn


def test_a_wrong_table_is_caught():
    """The parse sees what a 32-bit int in place of a pointer would break:
    ``accl_probe_copy``'s stream is a pointer, its count a long long,
    ``accl_cast``'s row count an int."""
    kinds = _entries(_build.CSRC / "probe.cu")["accl_probe_copy"][1]
    assert kinds == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_void_p]
    kinds = _entries(_build.CSRC / "compression.cu")["accl_cast"][1]
    assert kinds == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p]
    assert _c_kind("const long long* strides") is ctypes.c_void_p
    assert _c_kind("float tiny") is ctypes.c_float
    assert _c_kind("double c") is ctypes.c_double


def test_on_cuda_reads_the_devices_once():
    cpu = torch.zeros(4)
    assert on_cuda([cpu]) is False
    assert on_cuda([cpu, None, cpu[1:]]) is False
    for bad in ([], [None], [cpu, torch.zeros(4, device="meta")],
                [torch.zeros(4, device="meta")]):
        with pytest.raises(ValueError, match="one CUDA device"):
            on_cuda(bad)


def test_pointers_alignment_and_table():
    base = torch.zeros(64)
    ts = [base, None, base[1:], base[4:]]
    ptrs = pointers(ts)
    assert ptrs == [base.data_ptr(), None, base.data_ptr() + 4,
                    base.data_ptr() + 16]
    assert aligned16([ptrs[0], ptrs[1], ptrs[3]]) is (base.data_ptr() % 16
                                                       == 0)
    assert not aligned16(ptrs[2:3])
    table = pointer_table(ptrs)
    assert isinstance(table, ctypes.Array) and len(table) == 4
    assert [table[i] for i in range(4)] == ptrs


def test_probe_copy_on_the_cpu_is_its_plain_version():
    """Row 19's wrapper on a CPU tensor: the plain copy, no launch; other
    dtypes and layouts are refused, as on the card."""
    kc.probe_copy.launches.reset()
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128) * 0.5
    got = kc.probe_copy(x)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    assert torch.equal(got, kc.probe_copy_plain(x))
    assert kc.probe_copy.launches.count == 0
    for bad in (x.double(), x.t()):
        with pytest.raises(ValueError, match="contiguous float32"):
            kc.probe_copy(bad)
