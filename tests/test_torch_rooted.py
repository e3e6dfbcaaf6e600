"""The PyTorch port's rooted collectives against the JAX package.

Rows 9-11 of the kernel table (``accl_tpu/ops/pallas/rooted.py``'s bcast,
reduce and scatter ring relays) and the rooted gather over K3 have
hand-written CUDA kernels in ``accl_tpu_torch/ops/cuda/rooted.py``; on a
CPU tensor each wrapper runs its plain PyTorch version, which walks the
same hop schedule with the same fold order.  Here the same numpy-seeded
inputs go through the Pallas kernel (run by the Pallas TPU interpreter on
the virtual CPU mesh, as ``tests/test_torch_kernels.py`` runs it) and
through the port: every rank's result must agree EXACTLY, reduce
partials included.

Above the kernels, the port's driver and facade (``cuda_group(4,
device="cpu")``) run the same programs as the JAX driver and
``xla_group(4)`` under both rooted registers, and the rooted and
alltoall scenarios of ``tests/shared_scenarios.py`` run on the port's
gang.  The ``xla`` SUM reduce folds in rank order, XLA in its own, so it
agrees to float32 rounding (rtol 1e-6); everything else is exact.  Sizes
stay at P <= 4 and a few thousand elements: the interpreter's ring
busy-spins on its semaphores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from accl_tpu.compat import (
    has_interpret_params,
    has_pallas_interpret,
    interpret_params_reason,
)
from accl_tpu.constants import ReduceFunction as JaxReduceFunction
from accl_tpu.core import xla_group
from accl_tpu.ops import driver as jdriver
from accl_tpu.ops import pallas as pk
from helpers import run_parallel
from shared_scenarios import SCENARIOS

import accl_tpu_torch as at
from accl_tpu_torch import interop
from accl_tpu_torch.constants import ReduceFunction
from accl_tpu_torch.ops import cuda as kc
from accl_tpu_torch.ops import driver as tdriver

SUM, MAX = ReduceFunction.SUM, ReduceFunction.MAX
P4 = 4

interpreted = pytest.mark.skipif(
    jax.default_backend() != "tpu" and not has_interpret_params(),
    reason=f"Pallas interpret tier unavailable: {interpret_params_reason()}",
)

#: (ranks, root, num_segments): both ring sizes, both end roots
RINGS = [(2, 0, 1), (2, 1, 2), (4, 0, 2), (4, 3, 1)]
N = 777  # ragged against the 128-lane packing


def _jax_ring(body, data):
    """``body(x)`` on one rank's shard under shard_map over ``len(data)``
    devices; returns the stacked per-rank results."""
    devs = jax.devices()[: len(data)]
    if len(devs) < len(data):
        pytest.skip(f"needs {len(data)} devices")
    mesh = Mesh(np.array(devs), ("x",))
    fn = jax.jit(shard_map(
        lambda x: body(x[0])[None], mesh=mesh, in_specs=PS("x"),
        out_specs=PS("x"), check_vma=False,
    ))
    return np.asarray(fn(jnp.asarray(data)))


def _data(seed, shape, dtype, nans=False):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, size=shape).astype(np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if nans:
        x.reshape(-1)[::97] = np.nan
    return x


def _ranks(data):
    return interop.stacked_from_numpy(data, "cpu")


# ---------------------------------------------------------------------------
# rows 9-11 and the rooted gather: plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------


@interpreted
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("P,root,S", RINGS)
def test_ring_bcast_equals_pallas(P, root, S, dtype):
    data = _data(P * 10 + root, (P, N), dtype)
    want = _jax_ring(lambda x: pk.ring_bcast(x, "x", root, S), data)
    got = kc.ring_bcast(_ranks(data), root, S)
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])
        np.testing.assert_array_equal(got[r].numpy(), data[root])


@interpreted
@pytest.mark.parametrize("function", [SUM, MAX])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("P,root,S", RINGS)
def test_ring_reduce_equals_pallas(P, root, S, dtype, function):
    """Every rank's result, the non-roots' partials included; int32 SUM
    wraps, NaNs propagate under MAX."""
    data = _data(P * 20 + root, (P, N), dtype, nans=function == MAX)
    want = _jax_ring(
        lambda x: pk.ring_reduce(x, "x", root,
                                 JaxReduceFunction(int(function)), S),
        data,
    )
    got = kc.ring_reduce(_ranks(data), root, function, S)
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    assert not np.array_equal(want[root], want[(root + 1) % P])


@interpreted
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("P,root,S", RINGS)
def test_ring_scatter_equals_pallas(P, root, S, dtype):
    n = 333
    data = _data(P * 30 + root, (P, P * n), dtype)
    want = _jax_ring(lambda x: pk.ring_scatter(x, "x", root, S), data)
    got = kc.ring_scatter(_ranks(data), root, S)
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])
        np.testing.assert_array_equal(got[r].numpy(),
                                      data[root][r * n:(r + 1) * n])


@interpreted
@pytest.mark.parametrize("P,root,S", RINGS)
def test_ring_gather_equals_pallas(P, root, S):
    """The port writes the root's result alone (K3 with null outputs);
    the JAX kernel materialises it on every rank."""
    data = _data(P * 40 + root, (P, N), "float32")
    want = _jax_ring(lambda x: pk.ring_gather(x, "x", root, S), data)
    got = kc.ring_gather(_ranks(data), root, S)
    np.testing.assert_array_equal(got[root].numpy(), want[root])
    assert [r for r in range(P) if got[r] is not None] == [root]
    plain = kc.ring_gather_plain(_ranks(data), root, S)
    assert torch.equal(plain[root], got[root])


@interpreted
@pytest.mark.parametrize("P,root,S", RINGS)
def test_ring_gather_root_only_table_equals_pallas(P, root, S):
    """The facade's form: an ``out`` table naming the root alone takes
    K3's root-only kernel (on the CPU its plain version), which writes
    into that tensor and no other; a table naming every rank takes the
    all-rank allgather into each.  Both equal the JAX kernel's result."""
    data = _data(P * 50 + root, (P, N), "float32")
    want = _jax_ring(lambda x: pk.ring_gather(x, "x", root, S), data)
    xs = _ranks(data)
    out = [None] * P
    out[root] = torch.full((P * N,), 7.0)
    got = kc.ring_gather(xs, root, S, out=out)
    assert got[root].data_ptr() == out[root].data_ptr()
    assert [r for r in range(P) if got[r] is not None] == [root]
    np.testing.assert_array_equal(out[root].numpy(), want[root])
    every = [torch.full((P * N,), 7.0) for _ in range(P)]
    kc.ring_gather(xs, root, S, out=every)
    for r in range(P):
        np.testing.assert_array_equal(every[r].numpy(), want[root])


@interpreted
@pytest.mark.parametrize("n", [1, 255, 257])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_scatter_odd_blocks_equal_pallas(n, dtype):
    """Per-rank blocks shorter than one tile of the card's kernel and past
    it by one element (its scalar path), written into an ``out`` table of
    views at an element offset (every row misaligned on the card)."""
    P, root = 4, 2
    data = _data(70 + n, (P, P * n), "float32").astype(jnp.dtype(dtype))
    want = _jax_ring(lambda x: pk.ring_scatter(x, "x", root, 1), data)
    base = torch.full((P, n + 1), 7.0, dtype=getattr(torch, dtype))
    out = [row[1:] for row in base.unbind(0)]
    got = kc.ring_scatter(_ranks(data), root, out=out)
    for r in range(P):
        assert got[r].data_ptr() == out[r].data_ptr()
        np.testing.assert_array_equal(interop.to_numpy(out[r]),
                                      want[r].astype(np.float32))
    assert torch.equal(base[:, 0], torch.full((P,), 7.0, dtype=base.dtype))


@interpreted
@pytest.mark.parametrize("bad", ["root_none", "shape", "noncontiguous",
                                 "dtype"])
def test_ring_gather_refuses_bad_root_output(bad):
    """The root-only gather's argument checks: ``out[root]`` None, an
    output of the wrong length or dtype, or a non-contiguous one, is
    refused before anything is written; the same call with a good output
    equals the JAX kernel."""
    P, root = 4, 3
    data = _data(61, (P, N), "float32")
    want = _jax_ring(lambda x: pk.ring_gather(x, "x", root, 1), data)
    xs = _ranks(data)
    good = [None] * P
    good[root] = torch.empty(P * N)
    kc.ring_gather(xs, root, out=good)
    np.testing.assert_array_equal(good[root].numpy(), want[root])
    wrong = {"root_none": None,
             "shape": torch.full((P * N - 1,), 7.0),
             "noncontiguous": torch.full((2 * P * N,), 7.0)[::2],
             "dtype": torch.full((P * N,), 7.0, dtype=torch.float64)}[bad]
    out = [None] * P
    out[root] = wrong
    with pytest.raises(ValueError, match="out\\[root\\]"):
        kc.ring_gather(xs, root, out=out)
    if wrong is not None:
        assert bool((wrong == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ring_reduce_plain_16bit_rounds_each_hop(dtype):
    """16-bit partials round after every fold, in the relay's order."""
    xs = [torch.full((5,), v, dtype=dtype) for v in (1.0, 2.0**-9, 2.0**-9)]
    got = kc.ring_reduce(xs, 0, SUM)
    # rank 2 keeps its operand, rank 1 folds 2**-8, the root rounds
    # 1 + 2**-8 to the nearest even 16-bit value
    assert got[1][0].item() == 2.0**-8
    want = (torch.tensor(1.0, dtype=dtype) + torch.tensor(2.0**-8, dtype=dtype))
    assert got[0][0].item() == want.item()


# ---------------------------------------------------------------------------
# wrapper contracts: in place, aliases, null outputs, launches
# ---------------------------------------------------------------------------


def test_ring_bcast_in_place_and_refused_alias():
    xs = [torch.arange(8.0) * (r + 1) for r in range(3)]
    root_ptr = xs[1].data_ptr()
    got = kc.ring_bcast(xs, 1, out=xs)
    assert xs[1].data_ptr() == root_ptr
    for r in range(3):
        assert got[r].data_ptr() == xs[r].data_ptr()
        assert torch.equal(xs[r], torch.arange(8.0) * 2)
    with pytest.raises(ValueError, match="overlaps"):
        kc.ring_bcast(xs, 1, out=[xs[0], xs[2], xs[1]])
    src = torch.arange(16.0)
    with pytest.raises(ValueError, match="overlaps"):
        kc.ring_bcast([src[:8], torch.zeros(8)], 0,
                      out=[src[8:], src[4:12]])


def test_ring_reduce_null_outputs_and_in_place():
    data = _data(5, (3, 50), "float32")
    xs = _ranks(data)
    want = kc.ring_reduce_plain(xs, 2, SUM)
    keep = torch.full((50,), 7.0)
    got = kc.ring_reduce(xs, 2, SUM, out=[None, keep, xs[2]])
    assert got[0] is None
    assert torch.equal(keep, want[1]) and torch.equal(xs[2], want[2])
    ys = _ranks(data)
    with pytest.raises(ValueError, match="overlaps"):
        kc.ring_reduce(ys, 0, SUM, out=[None, ys[0], None])
    with pytest.raises(ValueError, match="out must be"):
        kc.ring_allreduce(_ranks(data), out=[None, keep, keep])


def test_rooted_wrappers_reject():
    xs = [torch.zeros(10), torch.zeros(10)]
    for fn in (kc.ring_bcast, kc.ring_scatter, kc.ring_gather):
        with pytest.raises(ValueError, match="root"):
            fn(xs, 2)
        with pytest.raises(ValueError, match="num_segments"):
            fn(xs, 0, 0)
    with pytest.raises(ValueError, match="root"):
        kc.ring_reduce(xs, -1)
    with pytest.raises(ValueError, match="reduce function"):
        kc.ring_reduce(xs, 0, 7)
    with pytest.raises(ValueError, match="divisible"):
        kc.ring_scatter([torch.zeros(9)] * 2)
    with pytest.raises(ValueError, match="out\\[root\\]"):
        kc.ring_gather(xs, 1, out=[torch.zeros(20), None])


def test_rooted_wrappers_on_cpu_launch_nothing():
    for k in kc.KERNELS.values():
        k.launches.reset()
    xs = [torch.ones(300), torch.ones(300)]
    kc.ring_bcast(xs, 1)
    kc.ring_reduce(xs, 0, MAX)
    kc.ring_scatter(xs, 1)
    kc.ring_gather(xs, 0)
    assert {k: f.launches.count for k, f in kc.KERNELS.items()} == {
        k: 0 for k in kc.KERNELS
    }


# ---------------------------------------------------------------------------
# the driver: stacked operands, the JAX driver's rows
# ---------------------------------------------------------------------------


def _drivers(name, root):
    j, t = getattr(jdriver, name), getattr(tdriver, name)
    if name == "run_alltoall":
        return j, t, {}
    return j, t, {"root": root}


@pytest.mark.parametrize("root", [0, 3])
@pytest.mark.parametrize(
    "name,width",
    [("run_reduce", N), ("run_scatter", P4 * 200), ("run_gather", N),
     ("run_alltoall", P4 * 200), ("run_bcast", N)],
)
def test_xla_driver_equals_jax(name, width, root):
    """The ``xla`` lowerings, zeros on the non-roots of reduce and gather
    included."""
    data = _data(width + root, (P4, width), "float32")
    jrun, trun, kw = _drivers(name, root)
    want = np.asarray(jrun(data, jdriver.make_mesh(P4), **kw))
    got = trun(torch.from_numpy(data), tdriver.make_mesh(P4, "cpu"), **kw)
    assert got.shape == want.shape
    if name == "run_reduce":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@interpreted
@pytest.mark.parametrize(
    "name,width,args",
    [("run_pallas_reduce", N, (MAX, 2)), ("run_pallas_bcast", N, (2,)),
     ("run_pallas_scatter", P4 * 200, (1,)), ("run_pallas_gather", N, (2,))],
)
def test_pallas_driver_equals_jax(name, width, args):
    """Every row of the JAX driver's result: partials for reduce, the
    gather on every row when no ``out`` is given."""
    data = _data(width, (P4, width), "float32", nans=True)
    jargs = tuple(JaxReduceFunction(int(a)) if isinstance(a, ReduceFunction)
                  else a for a in args)
    want = np.asarray(getattr(jdriver, name)(
        data, jdriver.make_mesh(P4), 3, *jargs))
    got = getattr(tdriver, name)(
        torch.from_numpy(data), tdriver.make_mesh(P4, "cpu"), 3, *args)
    np.testing.assert_array_equal(got.numpy(), want)


def test_driver_refuses_bad_segments():
    xs = [torch.zeros(8)] * 2
    with pytest.raises(ValueError, match="num_segments"):
        tdriver.run_pallas_reduce(xs, tdriver.make_mesh(2, "cpu"), 0, SUM, 0)


# ---------------------------------------------------------------------------
# the facade: cuda_group(4, device="cpu") vs xla_group(4)
# ---------------------------------------------------------------------------

ROOTED_REGISTERS = ("reduce_algorithm", "bcast_algorithm",
                    "scatter_algorithm", "gather_algorithm")


@pytest.fixture
def groups():
    jg = xla_group(P4)
    tg = at.cuda_group(P4, device="cpu")
    yield jg, tg
    for a in jg + tg:
        a.deinit()


def _set_rooted(group, algo, segments=2):
    for a in group:
        a.set_tuning("ring_segments", segments)
        for key in ROOTED_REGISTERS:
            a.set_tuning(key, algo)


def _tune_both(groups, algo):
    """The registers written into the JAX gang carry across to the
    port's through ``interop.tuning_from_jax``."""
    jg, tg = groups
    _set_rooted(jg, algo)
    port = interop.tuning_from_jax(dict(jg[0].engine.gang.tuning))
    for a in tg:
        for key, value in port.items():
            a.set_tuning(key, value)
    assert tg[0].engine.gang.tuning == port
    assert all(port[k] == algo for k in ROOTED_REGISTERS)


def _rooted_work(root, count, nans):
    rng = np.random.default_rng(100 + root)
    rows = rng.standard_normal((P4, count)).astype(np.float32)
    if nans:
        rows[:, ::41] = np.nan  # MAX must propagate them
    big = rng.standard_normal((P4, P4 * count)).astype(np.float32)

    def host(buf):
        buf.sync_from_device()
        return buf.data.copy()

    def work(a, r):
        out = {}
        send = a.create_buffer_from(rows[r].copy())
        for fn in (SUM, MAX):
            recv = (a.create_buffer(count, np.float32) if r == root
                    else None)
            a.reduce(send, recv, count, root=root, function=int(fn))
            if r == root:
                out[f"reduce {fn.name}"] = host(recv)
        # a non-root result buffer of reduce and gather is left as it was
        kept = a.create_buffer_from(np.full(P4 * count, 7.0, np.float32))
        a.reduce(send, kept.slice(0, count), count, root=root)
        a.gather(send, kept, count, root=root)
        out["kept"] = host(kept)
        bc = a.create_buffer_from(rows[r].copy())
        a.bcast(bc, count, root=root)
        out["bcast"] = host(bc)
        sc_send = a.create_buffer_from(big[r].copy()) if r == root else None
        sc_recv = a.create_buffer(count, np.float32)
        a.scatter(sc_send, sc_recv, count, root=root)
        out["scatter"] = host(sc_recv)
        ga_recv = (a.create_buffer(P4 * count, np.float32) if r == root
                   else None)
        a.gather(send, ga_recv, count, root=root)
        if r == root:
            out["gather"] = host(ga_recv)
        a2a_recv = a.create_buffer(P4 * count, np.float32)
        a.alltoall(a.create_buffer_from(big[r].copy()), a2a_recv, count)
        out["alltoall"] = host(a2a_recv)
        return out

    return rows, big, work


@pytest.mark.parametrize("root", [0, 3])
@pytest.mark.parametrize("algo", ["xla", "pallas_ring"])
def test_rooted_facade_equals_jax(groups, algo, root):
    if algo == "pallas_ring" and not has_pallas_interpret():
        pytest.skip("the JAX pallas lowering off-chip needs the interpreter")
    _tune_both(groups, algo)
    count = 300
    # NaNs only under the ring: XLA's CPU all-reduce MAX drops NaN
    # operands (all NaN gives -inf), where the port's fold keeps them
    rows, big, work = _rooted_work(root, count, nans=algo == "pallas_ring")
    jg, tg = groups
    want, got = run_parallel(jg, work), run_parallel(tg, work)
    for r in range(P4):
        w, g = want[r], got[r]
        assert set(g) == set(w)
        for key in g:
            if key == "kept":
                continue
            if key == "reduce SUM" and algo == "xla":
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        if r != root:
            np.testing.assert_array_equal(g["kept"], 7.0)
    np.testing.assert_array_equal(got[root]["gather"], rows.reshape(-1))
    np.testing.assert_array_equal(got[1]["bcast"], rows[root])
    np.testing.assert_array_equal(got[2]["scatter"],
                                  big[root][2 * count:3 * count])


def test_rooted_registers_launch_through_the_kernel_wrappers(monkeypatch):
    """Under ``pallas_ring`` the facade's rooted calls go through the
    kernel wrappers (on the CPU, their plain versions); under ``xla``
    they do not."""
    calls = []
    for name in ("ring_reduce", "ring_bcast", "ring_scatter", "ring_gather"):
        real = getattr(tdriver.krooted, name)
        monkeypatch.setattr(
            tdriver.krooted, name,
            lambda *a, _n=name, _f=real, **k: (calls.append(_n), _f(*a, **k))[1],
        )
    g = at.cuda_group(2, device="cpu")
    try:
        for algo in ("xla", "pallas_ring"):
            _set_rooted(g, algo, segments=1)

            def work(a, r):
                buf = a.create_buffer_from(np.arange(4, dtype=np.float32))
                big = a.create_buffer(8, np.float32)
                a.reduce(buf, buf if r == 0 else None, root=0)
                a.bcast(buf, root=1)
                a.scatter(big if r == 1 else None, buf, 4, root=1)
                a.gather(buf, big if r == 0 else None, root=0)

            run_parallel(g, work)
            assert sorted(calls) == ([] if algo == "xla" else sorted(
                ["ring_reduce", "ring_bcast", "ring_scatter", "ring_gather"]))
    finally:
        for a in g:
            a.deinit()


# ---------------------------------------------------------------------------
# registers and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ROOTED_REGISTERS)
def test_rooted_registers_refuse_ring_forms(key):
    g = at.cuda_group(2, device="cpu")
    try:
        for algo in ("ring", "pallas_ring_bidir"):
            with pytest.raises(at.ACCLError) as ei:
                g[0].set_tuning(key, algo)
            assert ei.value.code == at.ErrorCode.CONFIG_ERROR
        g[0].set_tuning(key, "pallas_ring")
        assert g[0].engine.gang.tuning[key] == "pallas_ring"
        with pytest.raises(ValueError, match="rooted"):
            interop.tuning_from_jax({key: "pallas_ring_bidir"})
    finally:
        for a in g:
            a.deinit()


@pytest.mark.parametrize("stream", ["from_stream", "to_stream"])
def test_reduce_stream_operands_not_ported(stream):
    """The reduce's stream operands, refused until the stream ports were
    ported, now run on both ranks' ports (root 1): ``from_stream`` takes
    each rank's operand from its port, ``to_stream`` hands the root's
    result to its port.  A reduce with neither ``sendbuf`` nor
    ``from_stream`` still fails with INVALID_OPERATION."""
    rows = np.random.default_rng(5).standard_normal((2, 6)).astype(
        np.float32)
    g = at.cuda_group(2, device="cpu")
    try:
        def work(a, r):
            if stream == "from_stream":
                a.stream_push(rows[r], stream_id=2)
                out = a.create_buffer(6, np.float32) if r == 1 else None
                a.reduce(None, out, 6, root=1, from_stream=True,
                         stream_id=2, dtype=np.float32)
                if out is None:
                    return None
                out.sync_from_device()
                return out.data.copy()
            a.reduce(a.create_buffer_from(rows[r]), None, 6, root=1,
                     to_stream=True, stream_id=2)
            return a.stream_pop(6, np.float32, stream_id=2) if r else None

        got = run_parallel(g, work)
        assert got[0] is None
        np.testing.assert_array_equal(got[1], rows[0] + rows[1])
        buf = g[0].create_buffer(4, np.float32)
        with pytest.raises(at.ACCLError) as ei:
            g[0].reduce(None, buf)
        assert ei.value.code == at.ErrorCode.INVALID_OPERATION
    finally:
        for a in g:
            a.deinit()


@pytest.mark.parametrize("op", ["reduce", "gather"])
def test_ranks_disagreeing_on_the_root_all_fail(op):
    """The gang call signature carries both roots: ranks that disagree on
    the root fail with INVALID_OPERATION, none runs."""
    g = at.cuda_group(4, device="cpu")
    try:
        def work(a, r):
            root = r % 2
            send = a.create_buffer_from(np.ones(8, np.float32))
            recv = (a.create_buffer(8 * (4 if op == "gather" else 1),
                                    np.float32) if r == root else None)
            with pytest.raises(at.ACCLError) as ei:
                getattr(a, op)(send, recv, root=root)
            return ei.value.code

        assert run_parallel(g, work) == [at.ErrorCode.INVALID_OPERATION] * 4
    finally:
        for a in g:
            a.deinit()


# ---------------------------------------------------------------------------
# the shared scenarios on the port's gang
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name",
    ["bcast_roots", "bcast_rendezvous_tree", "bcast_compressed",
     "scatter_roots", "gather_roots", "reduce_roots", "alltoall",
     "allreduce_fp8_wire", "allreduce", "allgather", "reduce_scatter",
     "allreduce_int_dtypes", "barrier_then_allreduce",
     "tuning_allreduce_algorithm", "tuning_invalid", "sendrecv",
     "streams_local", "stream_put_remote"],
)
@pytest.mark.parametrize("algo", ["xla", "pallas_ring"])
def test_shared_scenario_on_port(name, algo):
    work, check, tiers = SCENARIOS[name]
    assert "gang" in tiers
    g = at.cuda_group(P4, device="cpu")
    try:
        _set_rooted(g, algo)
        results = run_parallel(g, lambda a, r: work(a, r, P4), timeout=120.0)
        check(results, P4)
    finally:
        for a in g:
            a.deinit()
