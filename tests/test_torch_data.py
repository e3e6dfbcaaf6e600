"""The port's token loader against the JAX package's.

``accl_tpu_torch.data`` builds its own copy of the native loader
(``accl_tpu_torch/csrc/dataloader.cpp``) with ``g++`` at first use; the
two ``write_token_file``s write the same bytes and the two loaders draw
the same batches for each (seed, step, shard, num_shards).  The cases
mirror ``tests/test_data.py:20-88``.
"""

import os

import numpy as np
import pytest
import torch

from accl_tpu import data as jd
from accl_tpu_torch import data as td


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "toks.bin"
    td.write_token_file(str(path), np.random.default_rng(3).integers(
        0, 40000, 50_000))
    return str(path)


@pytest.mark.parametrize("ids", [np.arange(300) % 7, np.arange(70_000,
                                                                75_000)],
                         ids=["uint16", "uint32"])
def test_write_token_file_equals_jax_bytes(tmp_path, ids):
    """The same header and ids (uint16 when every id fits, else uint32)."""
    jd.write_token_file(str(tmp_path / "j.bin"), ids)
    td.write_token_file(str(tmp_path / "t.bin"), ids)
    assert (tmp_path / "t.bin").read_bytes() == (
        tmp_path / "j.bin").read_bytes()
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


@pytest.mark.parametrize("seed,shard,num_shards",
                         [(5, 0, 1), (0, 1, 2), (9, 2, 3)])
def test_batches_equal_jax(token_file, seed, shard, num_shards):
    """Every step's (tokens, targets, step) equals the JAX loader's, as
    int32 CPU tensors, targets the one-position shift."""
    kw = dict(seed=seed, shard=shard, num_shards=num_shards)
    with jd.TokenLoader(token_file, 4, 16, **kw) as a, \
            td.TokenLoader(token_file, 4, 16, **kw) as b:
        assert b.token_count == a.token_count == 50_000
        for want_step in range(4):
            ja, jg, js = a.next()
            t, g, s = b.next()
            assert s == js == want_step
            assert t.dtype == g.dtype == torch.int32
            assert t.device.type == "cpu" and t.shape == (4, 16)
            np.testing.assert_array_equal(t.numpy(), ja)
            np.testing.assert_array_equal(g.numpy(), jg)
            np.testing.assert_array_equal(t[:, 1:].numpy(),
                                          g[:, :-1].numpy())


def test_seek_and_start_step_equal_jax(token_file):
    """``seek`` repositions without replay and ``start_step`` opens
    mid-stream, as in JAX (:31)."""
    with jd.TokenLoader(token_file, 4, 16, seed=5) as a, \
            td.TokenLoader(token_file, 4, 16, seed=5) as b:
        first = b.next()[0]
        for _ in range(3):
            b.next()
        b.seek(0)
        again, _, s = b.next()
        assert s == 0 and torch.equal(again, first)
        a.seek(7)
        b.seek(7)
        ja, _, js = a.next()
        t, _, s = b.next()
        assert s == js == 7
        np.testing.assert_array_equal(t.numpy(), ja)
    with td.TokenLoader(token_file, 4, 16, seed=5, start_step=2) as c:
        tc, _, sc = c.next()
    with jd.TokenLoader(token_file, 4, 16, seed=5, start_step=2) as d:
        jt_, _, js = d.next()
    assert sc == js == 2
    np.testing.assert_array_equal(tc.numpy(), jt_)


def test_shards_draw_from_disjoint_stripes(token_file):
    with td.TokenLoader(token_file, 4, 16, seed=5, shard=0,
                        num_shards=2) as s0, \
            td.TokenLoader(token_file, 4, 16, seed=5, shard=1,
                           num_shards=2) as s1:
        assert not torch.equal(s0.next()[0], s1.next()[0])


def test_wide_tokens_use_uint32(tmp_path):
    path = str(tmp_path / "wide.bin")
    td.write_token_file(path, np.arange(70_000, 75_000))
    with td.TokenLoader(path, 2, 8) as dl:
        t, _, _ = dl.next()
    assert int(t.max()) > 0xFFFF


def test_error_paths_equal_jax(tmp_path, token_file):
    """The native codes' texts (``_ERRORS``) and the writer's refusals are
    JAX's; a loader used after ``close`` or a failed open is harmless."""
    assert td._ERRORS == jd._ERRORS
    with pytest.raises(RuntimeError, match="cannot open"):
        td.TokenLoader(str(tmp_path / "missing.bin"), 2, 8)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"NOTATOKENFILE" + b"\0" * 64)
    with pytest.raises(RuntimeError, match="bad magic"):
        td.TokenLoader(str(bad), 2, 8)
    with pytest.raises(RuntimeError, match="too small"):
        td.TokenLoader(token_file, 2, 8, num_shards=50_000)
    with pytest.raises(RuntimeError, match="invalid arguments"):
        td.TokenLoader(token_file, 2, 8, shard=2, num_shards=2)
    with pytest.raises(ValueError, match="non-negative"):
        td.write_token_file(str(tmp_path / "x.bin"), np.array([-3]))
    with pytest.raises(ValueError, match="integers"):
        td.write_token_file(str(tmp_path / "x.bin"), np.array([1.5]))
    dl = td.TokenLoader(token_file, 2, 8)
    dl.close()
    dl.close()


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A failed build names the compiler's complaint; it never falls back
    to another library."""
    src = tmp_path / "dataloader.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(td, "_SOURCE", src)
    monkeypatch.setattr(td, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed") as e:
        td.build()
    assert "dataloader.cpp" in str(e.value) and "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_built_from_the_port_source():
    """The loader's library is the port's own build, in ``csrc/build``."""
    path = td.build()
    assert path.parent.name == "build" and path.parent.parent.name == "csrc"
    assert "accl_tpu_torch" in path.parts
