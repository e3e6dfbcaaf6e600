"""The port's platform layer (``accl_tpu_torch.parallel``'s topology and
multi-host modules, ``accl_tpu_torch.utils``) against the JAX package's.

Each case is the JAX package's own test of the same function
(``tests/test_aux.py``, ``tests/test_telemetry.py``), run on the port
beside the JAX function on the same numpy-seeded inputs.  The port's
ranks are virtual on one device, so a mesh here is a
``ops.driver.Mesh`` whose ``shape`` and axis names are compared with
JAX's ``jax.sharding.Mesh``; the meshes run on the CPU (``device="cpu"``
or ``devices=["cpu"] * n``), where JAX runs its 8-device virtual CPU
mesh.  Float32 collectives agree to rtol 1e-6 (XLA folds in its own
order); the train step at tp = 1 agrees with JAX's within JAX's own
``rtol=2e-4, atol=2e-5`` and with the port's plain-mesh step bit for
bit.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import accl_tpu.parallel as jpar
import accl_tpu.utils as jutils
from accl_tpu.core import xla_group
from accl_tpu.models import transformer as jt
from helpers import run_parallel

import accl_tpu_torch as at
from accl_tpu_torch import parallel as tpar
from accl_tpu_torch import telemetry as T
from accl_tpu_torch import utils as tutils
from accl_tpu_torch.models import (
    TransformerConfig,
    make_sharded_train_step,
    params_from_numpy,
    params_to_numpy,
)
from accl_tpu_torch.ops import driver as opdriver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-6, atol=1e-6)


def _deinit(group):
    for a in group:
        a.deinit()


def _fields(ranks):
    return [(r.address, r.session, r.max_segment_size) for r in ranks]


# ---------------------------------------------------------------------------
# parallel.topology
# ---------------------------------------------------------------------------


def test_design_members_equal_jax():
    assert [(d.name, d.value) for d in tpar.Design] == [
        (d.name, d.value) for d in jpar.Design]


@pytest.mark.parametrize("design", [d.name for d in jpar.Design])
def test_generate_ranks_synthetic_equals_jax(design):
    got = tpar.generate_ranks(tpar.Design[design], 4, base_port=48000)
    want = jpar.generate_ranks(jpar.Design[design], 4, base_port=48000)
    assert _fields(got) == _fields(want)
    if design == "SOCKET":  # test_aux.py:13
        assert [r.address for r in got] == [
            f"127.0.0.1:{48000 + i}" for i in range(4)]


def test_generate_ranks_json_equals_jax(tmp_path):
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps([
        {"address": "10.0.0.1:5000", "max_segment_size": 2048},
        {"address": "10.0.0.2:5000", "session": 7},
    ]))
    for d in jpar.Design:
        got = tpar.generate_ranks(tpar.Design[d.name], 2,
                                  json_path=str(path))
        assert _fields(got) == _fields(
            jpar.generate_ranks(d, 2, json_path=str(path)))
    assert got[0].max_segment_size == 2048 and got[1].session == 7


def test_bootstrap_ici_allreduce_equals_jax():
    """``bootstrap(Design.ICI, 2)`` is the gang: its allreduce equals
    ``xla_group(2)``'s (JAX's ICI bootstrap)."""
    rows = np.random.default_rng(30).standard_normal((2, 257)).astype(
        np.float32)

    def work(a, r):
        s = a.create_buffer_from(rows[r].copy())
        d = a.create_buffer(257, np.float32)
        a.allreduce(s, d, 257)
        d.sync_from_device()
        return np.asarray(d.host_view()).copy()

    jg = xla_group(2)
    tg = tpar.bootstrap(tpar.Design.ICI, 2, device="cpu")
    try:
        assert len(tg) == 2 and all(isinstance(a, at.ACCL) for a in tg)
        want, got = run_parallel(jg, work), run_parallel(tg, work)
    finally:
        _deinit(jg + tg)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **F32_TOL)


@pytest.mark.parametrize("design,item", [
    ("INPROC", "A12"), ("SOCKET", "A12"), ("NATIVE", "A12"),
    ("NATIVE_SOCKET", "A12"), ("XLA_DIST", "A6")])
def test_bootstrap_unported_designs_name_their_item(design, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tpar.bootstrap(tpar.Design[design], 2, rank=0, device="cpu")


def test_mesh_from_topology_equals_jax():
    want = jpar.mesh_from_topology({"dp": 2, "tp": 4})
    got = tpar.mesh_from_topology({"dp": 2, "tp": 4}, device="cpu")
    assert got.shape == dict(want.shape) == {"dp": 2, "tp": 4}
    assert got.axis_names == tuple(want.axis_names)
    assert got.size == want.devices.size
    # virtual ranks: no device count bounds the axes
    assert tpar.mesh_from_topology({"dp": 16, "tp": 4},
                                   device="cpu").size == 64
    flat = tpar.mesh_from_topology(device="cpu")
    assert flat.axis_names == ("ranks",) and flat.size == 1


def test_device_memory_report_keys_equal_jax():
    want = jpar.device_memory_report()
    got = tpar.device_memory_report(device="cpu")
    assert len(got) == 1
    assert set(got[0]) == set(want[0])
    assert got[0] == want[0]  # JAX's CPU device reports no byte counts


def test_no_card_raises(monkeypatch):
    """No fallback: the card's entry points raise without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.device_memory_report()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tutils.device_memory_profile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.bootstrap(tpar.Design.ICI, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.hybrid_mesh("dcn", {"x": 1})


# ---------------------------------------------------------------------------
# utils: timing and logging
# ---------------------------------------------------------------------------


def test_timer():
    import time

    with tutils.Timer() as t:
        time.sleep(0.01)
    assert 8_000 < t.elapsed_us() < 1_000_000
    assert t.elapsed_ns() == pytest.approx(t.elapsed_us() * 1e3, abs=1)


@pytest.mark.parametrize("utils", [jutils, tutils], ids=["jax", "port"])
def test_log_levels(capsys, utils):
    log = utils.Log("test", level=utils.LogLevel.INFO)
    log.info("visible")
    log.trace("hidden")
    err = capsys.readouterr().err
    assert "visible" in err and "hidden" not in err


@pytest.mark.parametrize("raw,level", [("4", "TRACE"), ("trace", "TRACE"),
                                       ("9", "TRACE"), ("bogus", "NONE"),
                                       ("2", "INFO")])
def test_log_env_levels_equal_jax(monkeypatch, raw, level):
    monkeypatch.setenv("ACCL_DEBUG", raw)
    assert tutils.Log("x").level.name == jutils.Log("x").level.name == level


def test_trace_events_buffer_into_ring_not_stderr(capsys, monkeypatch):
    monkeypatch.delenv("ACCL_TRACE_STDERR", raising=False)
    T.wire_reset()
    log = tutils.Log("wiretest", level=tutils.LogLevel.TRACE)
    log.trace("send EAGER comm=0 src=0 dst=1")
    assert capsys.readouterr().err == ""  # nothing synchronous
    snap = T.wire_snapshot()
    assert snap["seen"] == 1
    assert snap["events"][-1]["src"] == "wiretest"
    assert "EAGER" in snap["events"][-1]["event"]
    log.error("boom")  # non-TRACE levels keep stderr
    assert "boom" in capsys.readouterr().err
    T.wire_reset()


def test_trace_stderr_opt_in(capsys, monkeypatch):
    monkeypatch.setenv("ACCL_TRACE_STDERR", "1")
    T.wire_reset()
    log = tutils.Log("wiretest", level=tutils.LogLevel.TRACE)
    log.trace("synchronous again")
    assert "synchronous again" in capsys.readouterr().err
    assert T.wire_snapshot()["seen"] == 0
    T.wire_reset()


def test_wire_sampling_through_log(monkeypatch):
    monkeypatch.delenv("ACCL_TRACE_STDERR", raising=False)
    monkeypatch.setenv("ACCL_TELEMETRY_SAMPLE", "4")
    T.wire_reset()
    log = tutils.Log("s", level=tutils.LogLevel.TRACE)
    for i in range(16):
        log.trace(f"ev{i}")
    snap = T.wire_snapshot()
    assert snap["seen"] == 16
    assert snap["recorded"] == 4  # 1-in-4
    assert [e["event"] for e in snap["events"]] == ["ev0", "ev4", "ev8",
                                                    "ev12"]
    T.wire_reset()


# ---------------------------------------------------------------------------
# utils.platform
# ---------------------------------------------------------------------------


def test_mirror_platform_env(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert tutils.mirror_platform_env() is None
    assert tutils.mirror_platform_env("cpu") == "cpu"
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert tutils.mirror_platform_env() == "cpu"
    with pytest.raises(ValueError, match="tpu"):
        tutils.mirror_platform_env("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("gpu", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tutils.mirror_platform_env(name)
    assert torch.get_default_device() == torch.device("cpu")


# ---------------------------------------------------------------------------
# parallel.multihost
# ---------------------------------------------------------------------------


def test_multihost_singleprocess_bootstrap():
    import torch.distributed as dist

    want = jpar.bootstrap_multihost()
    ctx = tpar.bootstrap_multihost()
    assert (ctx.process_id, ctx.num_processes, ctx.coordinator_address) == (
        want.process_id, want.num_processes, want.coordinator_address)
    assert ctx.is_coordinator and ctx.num_processes == 1
    assert ctx.process_count() == 1 and not dist.is_initialized()
    assert len(ctx.global_devices()) >= 1
    assert ctx.global_devices() == ctx.local_devices()


def test_multihost_partial_arguments_raise():
    with pytest.raises(ValueError, match="together"):
        tpar.bootstrap_multihost("127.0.0.1:1", num_processes=2)


_TWO_PROCESS = """
import sys
import torch, torch.distributed as dist
from accl_tpu_torch.parallel import bootstrap_multihost
rank, port = int(sys.argv[1]), int(sys.argv[2])
ctx = bootstrap_multihost(f"127.0.0.1:{port}", 2, rank)
x = torch.full((4,), float(rank + 1))
dist.all_reduce(x)
print(ctx.process_id, ctx.num_processes, ctx.process_count(),
      ctx.is_coordinator, dist.get_backend(), len(ctx.global_devices()),
      x.tolist())
dist.destroy_process_group()
"""


def test_multihost_two_processes_over_gloo():
    """Two processes join one gloo group through ``tcp://`` on a port
    found by binding port 0 (a fixed port flakes under parallel runs)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROCESS, str(r), str(port)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, o in enumerate(outs):
        assert o[:6] == [str(r), "2", "2", str(r == 0), "gloo", "2"]
        assert " ".join(o[6:]) == "[3.0, 3.0, 3.0, 3.0]"


def test_hybrid_mesh_layout_equals_jax():
    """test_aux.py:168 on the port: the outer axis is DCN, the inner axes
    stay inside a node."""
    n = len(jax.devices())
    cpu = ["cpu"] * n
    cases = [
        (jpar.hybrid_mesh("dcn", {"x": 4}),
         tpar.hybrid_mesh("dcn", {"x": 4}, devices=cpu)),
        (jpar.hybrid_mesh("dcn", {"x": 2}, devices=jax.devices()[:4]),
         tpar.hybrid_mesh("dcn", {"x": 2}, devices=cpu[:4])),
        (jpar.dp_over_dcn_mesh(tp=2), tpar.dp_over_dcn_mesh(tp=2,
                                                            devices=cpu)),
    ]
    for want, got in cases:
        assert got.axis_names == tuple(want.axis_names)
        assert got.axis_sizes == want.devices.shape
        assert got.shape == dict(want.shape)
        assert got.device == torch.device("cpu")
    assert cases[0][1].axis_sizes == (n // 4, 4)
    assert cases[1][1].axis_sizes == (2, 2)
    assert cases[2][1].axis_names == ("dp", "tp")


@pytest.mark.parametrize("ici", [3, 5])
def test_hybrid_mesh_refuses_what_jax_refuses(ici):
    n = len(jax.devices())
    with pytest.raises(ValueError) as want:
        jpar.hybrid_mesh("dcn", {"x": ici})
    with pytest.raises(ValueError) as got:
        tpar.hybrid_mesh("dcn", {"x": ici}, devices=["cpu"] * n)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jpar.dp_over_dcn_mesh(tp=ici)
    with pytest.raises(ValueError) as got:
        tpar.dp_over_dcn_mesh(tp=ici, devices=["cpu"] * n)
    assert str(got.value) == str(want.value)


def test_hybrid_mesh_refuses_distinct_devices():
    with pytest.raises(NotImplementedError, match="ROADMAP A9c, B14"):
        tpar.hybrid_mesh("dcn", {"x": 1}, devices=["cpu", "meta"])


def _two_level_sum(rows, mesh):
    """psum over the inner axis, then over the outer one, through the
    port's collectives: each (dcn, x) rank's row, as the JAX program's
    ``psum(psum(v, "x"), "dcn")``."""
    n_dcn, n_x = mesh.axis_sizes
    inner = opdriver.make_mesh(n_x, mesh.device)
    outer = opdriver.make_mesh(n_dcn, mesh.device)
    grid = [opdriver.run_allreduce([rows[d * n_x + x] for x in range(n_x)],
                                   inner) for d in range(n_dcn)]
    return [opdriver.run_allreduce([grid[d][x] for d in range(n_dcn)],
                                   outer) for x in range(n_x)]


def test_hybrid_mesh_two_level_sum_equals_jax():
    """test_aux.py:187 on the port: an ICI sum, then a DCN sum, over
    ``hybrid_mesh("dcn", {"x": 4})`` of 8 ranks."""
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    jm = jpar.hybrid_mesh("dcn", {"x": 4})
    n, width = jm.devices.size, 64
    data = np.random.default_rng(31).standard_normal(
        (n, width)).astype(np.float32)

    def body(v):
        return jax.lax.psum(jax.lax.psum(v, "x"), "dcn")

    fn = jax.jit(shard_map(body, mesh=jm, in_specs=PS(("dcn", "x")),
                           out_specs=PS(), check_vma=False))
    want = np.asarray(fn(jnp.asarray(data.reshape(-1))))

    mesh = tpar.hybrid_mesh("dcn", {"x": 4}, devices=["cpu"] * n)
    got = _two_level_sum([torch.from_numpy(r) for r in data], mesh)
    for per_x in got:
        for row in per_x:
            np.testing.assert_allclose(row.numpy(), want, **F32_TOL)
    ones = _two_level_sum([torch.ones(width) for _ in range(n)], mesh)
    assert all(bool((row == n).all()) for per_x in ones for row in per_x)


def test_flagship_train_step_on_hybrid_mesh():
    """test_aux.py:295 at tp = 1: the step on a DCN-aware hybrid mesh
    equals the plain-mesh step bit for bit, and JAX's hybrid-mesh step
    within JAX's own tolerances."""
    fields = dict(vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                  max_seq=16)
    jcfg = jt.TransformerConfig(**fields)
    cfg = TransformerConfig(dtype=torch.float32, **fields)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tokens = np.random.default_rng(32).integers(
        0, fields["vocab"], (4, 8)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)

    hyb = jpar.hybrid_mesh("dp", {"tp": 1}, devices=jax.devices()[:4])
    js, jsh = jt.make_sharded_train_step(jcfg, hyb, lr=0.05)
    jnew, jloss = js(jsh(jp), jnp.asarray(tokens), jnp.asarray(targets))

    def port_step(mesh):
        step, shard = make_sharded_train_step(cfg, lr=0.05, mesh=mesh)
        params = shard(params_from_numpy(tree, device="cpu"))
        new, loss = step(params, torch.from_numpy(tokens),
                         torch.from_numpy(targets))
        return params_to_numpy(new), float(loss)

    mesh = tpar.hybrid_mesh("dp", {"tp": 1}, devices=["cpu"] * 4)
    assert mesh.axis_names == ("dp", "tp") and mesh.shape == {"dp": 4,
                                                              "tp": 1}
    got, loss = port_step(mesh)
    plain, plain_loss = port_step(opdriver.make_mesh(
        (4, 1), "cpu", axes=("dp", "tp")))
    assert loss == plain_loss
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(plain)):
        np.testing.assert_array_equal(a, b)
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# utils.profiling
# ---------------------------------------------------------------------------


def _trace_events(logdir):
    (name,) = os.listdir(logdir)
    assert name.startswith("trace_") and name.endswith(".json")
    with open(os.path.join(logdir, name)) as f:
        return json.load(f)["traceEvents"]


def _names(events):
    return {e.get("name") for e in events}


def test_trace_captures_annotate_and_the_gang_ranges(tmp_path):
    """test_aux.py:219 on the port: a trace around ``annotate("test-span")``
    and a gang allreduce holds both ranges, the call's named as JAX names
    it; a batch of 8 names its launch ``accl::batch[8]`` or
    ``accl::cmdring[8]``, whichever path the gang's own counters say it
    took."""
    g = at.cuda_group(2, device="cpu")
    n = 64
    try:
        bufs = [(a.create_buffer_from(np.full(n, float(r), np.float32)),
                 [a.create_buffer(n, np.float32) for _ in range(8)])
                for r, a in enumerate(g)]
        logdir = str(tmp_path / "trace")
        with tutils.trace(logdir):
            with tutils.annotate("test-span"):
                run_parallel(g, lambda a, r: a.allreduce(
                    bufs[r][0], bufs[r][1][0], n))
        names = _names(_trace_events(logdir))
        assert {"test-span", "accl::allreduce"} <= names

        def batch(a, r):
            with a.batch():
                reqs = [a.allreduce(bufs[r][0], d, n, run_async=True)
                        for d in bufs[r][1]]
            for q in reqs:
                assert q.wait(60)
                q.check()

        ring = g[0].engine.gang.cmdring
        d0 = ring.dispatches
        i0 = g[0].capabilities()["device_interactions"]
        logdir = str(tmp_path / "batch")
        with tutils.trace(logdir):
            run_parallel(g, batch)
        names = _names(_trace_events(logdir))
        interactions = g[0].capabilities()["device_interactions"] - i0
        assert interactions == 1  # one window or one fused batch
        want = ("accl::cmdring[8]" if ring.dispatches > d0
                else "accl::batch[8]")
        assert want in names
        for r in range(2):
            for d in bufs[r][1]:
                d.sync_from_device()
                np.testing.assert_array_equal(d.host_view(), np.full(n, 1.0))
    finally:
        _deinit(g)


def test_trace_names_the_fused_batch_and_the_decomposed_call(tmp_path,
                                                            monkeypatch):
    """The two other launch sites: a batch the ring refuses runs as one
    fused dispatch (``accl::batch[n]``), and a fused call off the ring
    decomposes (``accl::fused<n>_decomposed``)."""
    monkeypatch.setenv("ACCL_CMDRING", "0")
    g = at.cuda_group(2, device="cpu")
    n = 32
    try:
        src = [a.create_buffer_from(np.full(n, r + 1.0, np.float32))
               for r, a in enumerate(g)]
        outs = [[a.create_buffer(n, np.float32) for _ in range(3)]
                for a in g]
        fa = [a.create_buffer_from(np.ones(3 * n, np.float32)) for a in g]
        fout = [a.create_buffer(n, np.float32) for a in g]

        def work(a, r):
            with a.batch():
                reqs = [a.allreduce(src[r], d, n, run_async=True)
                        for d in outs[r]]
            for q in reqs:
                assert q.wait(60)
                q.check()
            a.fused_apply(fa[r], fout[r], n, lr=0.5)

        logdir = str(tmp_path / "t")
        with tutils.trace(logdir):
            run_parallel(g, work)
        names = _names(_trace_events(logdir))
    finally:
        _deinit(g)
    assert "accl::batch[3]" in names
    assert any(s.startswith("accl::fused") and s.endswith("_decomposed")
               for s in names if s)


def test_trace_verbose_level_records_shapes(tmp_path):
    logdir = str(tmp_path / "v")
    with tutils.trace(logdir, host_tracer_level=3):
        with tutils.annotate("shaped"):
            torch.ones(3, 5).sum()
    events = _trace_events(logdir)
    assert "shaped" in _names(events)
    assert any("Input Dims" in e.get("args", {}) for e in events)


def test_annotate_passes_exceptions_and_costs_nothing_unprofiled():
    with pytest.raises(KeyError):
        with tutils.annotate("raises"):
            raise KeyError("x")
    with pytest.raises(KeyError):
        with tutils.device_scope("raises"):
            raise KeyError("x")
    span = tutils.annotate("idle")
    with span:
        assert span._range is None  # no profiler: no record_function
    assert isinstance(tutils.device_scope("s"), tutils.annotate)


def test_device_memory_profile_cpu():
    blob = tutils.device_memory_profile(backend="cpu")
    assert isinstance(blob, bytes) and len(blob) > 0
    snap = pickle.loads(blob)
    assert snap["segments"] == [] and "device_traces" in snap
    with pytest.raises(ValueError):
        tutils.device_memory_profile(backend="tpu")


def test_start_server_captures_a_trace():
    server = tutils.start_server(0)
    try:
        url = f"http://127.0.0.1:{server.port}/capture?ms=50"

        def spin():
            for _ in range(50):
                torch.ones(64).sum()

        t = threading.Thread(target=spin, name="accl-test-spin")
        t.start()
        with urllib.request.urlopen(url, timeout=60) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "application/json"
            doc = json.loads(r.read())
        t.join(10)
        assert not t.is_alive()
        assert isinstance(doc["traceEvents"], list)
        bad = f"http://127.0.0.1:{server.port}/capture?ms=0"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad, timeout=10)
    finally:
        assert server.stop()


def test_platform_modules_export_jax_names():
    assert set(tpar.__dict__) >= {n for n in jpar.__dict__
                                  if not n.startswith("_")
                                  and n not in ("topology", "multihost",
                                                "zero")}
    want = {n for n in jutils.__dict__ if not n.startswith("_")}
    assert set(tutils.__dict__) >= want
