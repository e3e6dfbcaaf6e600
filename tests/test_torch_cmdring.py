"""The PyTorch port's command ring (``accl_tpu_torch``) against the JAX
package's.

The same numpy-seeded inputs go through both packages:

* the host codec (slot words, fparam, widths, fused eligibility, window
  shape) must be identical;
* the port's ``slot_epilogue`` must equal ``accl_tpu.ops.pallas.cmdring.
  slot_epilogue`` run eagerly with jnp on the CPU, bit for bit, for every
  width class and opcode;
* a window through the port's ``run_window`` (the plain sequencer on CPU
  tensors) must equal the JAX ``run_windows(..., lowering="xla")`` on the
  virtual CPU mesh: results and status words, wire lanes included;
* the facade's batched windows on ``xla_group(4)`` and
  ``cuda_group(4, device="cpu")`` must agree exactly in results, status
  words and ring counter deltas, and every fallback reason must be
  counted alike;
* the fp8 and int8 lanes (seeded from the slot's flags word), the
  mailbox of the persistent run, the SEND/RECV pair definition and the
  JAX package's own persistence tests (``tests/test_cmdring.py``) on the
  port's group.

The CUDA sequencer kernel itself is held against its plain version on the
card by ``chip_smoke.py``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

import accl_tpu.cmdring as jring
import accl_tpu.constants as jconst
from accl_tpu.core import xla_group
from accl_tpu.ops import driver as jdriver
from accl_tpu.ops.pallas import cmdring as jdev
from helpers import run_parallel

import accl_tpu_torch as at
import accl_tpu_torch.cmdring as tring
import accl_tpu_torch.constants as tconst
from accl_tpu_torch import interop
from accl_tpu_torch.ops import cmdring as tdev
from accl_tpu_torch.ops.cuda import cmdring as kseq

Op = tconst.CmdOpcode
SUM, MAX = 0, 1


# ---------------------------------------------------------------------------
# the host codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "CmdOpcode", "FusedCompute", "CMDRING_FIELDS", "CMDRING_SLOT_WORDS",
    "CMDRING_FPARAM_ONE", "CMDRING_ST_OK", "CMDRING_ST_BAD_OP",
    "CMDRING_ENV", "CMDRING_DEPTH_ENV", "CMDRING_MAX_BYTES_ENV",
    "CMDRING_DEPTH_DEFAULT", "CMDRING_MAX_DEPTH",
    "CMDRING_MAX_PAYLOAD_BYTES", "CMDRING_RUN_WINDOWS_ENV",
    "CMDRING_LINGER_ENV", "CMDRING_RUN_WINDOWS_DEFAULT",
    "CMDRING_MAX_RUN_WINDOWS", "CMDRING_LINGER_MS_DEFAULT",
])
def test_ring_vocabulary_equals_jax(name):
    mine, theirs = getattr(tconst, name), getattr(jconst, name)
    if isinstance(mine, type):
        assert {m.name: int(m) for m in mine} == {
            m.name: int(m) for m in theirs}
    else:
        assert mine == theirs


def test_opcode_tables_equal_jax():
    def norm(table):
        return {(k.name if hasattr(k, "name") else k): int(v)
                for k, v in table.items()}

    assert norm(tconst.CMDRING_OPCODES) == norm(jconst.CMDRING_OPCODES)
    assert norm(tconst.CMDRING_FUSED_OPCODES) == norm(
        jconst.CMDRING_FUSED_OPCODES)


@pytest.mark.parametrize("seqn", [0, 7, 2 ** 31 + 5])
@pytest.mark.parametrize("opcode", list(Op))
def test_encode_decode_slot_equal_jax(seqn, opcode):
    kw = dict(dtype=2, function=1, root=3, flags=9, nseg=0, peer=2, wire=6,
              fparam=-32768)
    mine = tring.encode_slot(seqn, opcode, 1000, **kw)
    theirs = jring.encode_slot(seqn, jconst.CmdOpcode(int(opcode)), 1000,
                               **kw)
    np.testing.assert_array_equal(mine, theirs)
    d_mine, d_theirs = tring.decode_slot(mine), jring.decode_slot(theirs)
    assert {k: int(v) for k, v in d_mine.items()} == {
        k: int(v) for k, v in d_theirs.items()}
    with pytest.raises(ValueError):
        tring.decode_slot(np.zeros(tconst.CMDRING_SLOT_WORDS + 1))


@pytest.mark.parametrize("nslots,depth", [(0, 1), (3, 8), (8, 8), (9, 8)])
def test_encode_window_equals_jax(nslots, depth):
    slots = [tring.encode_slot(i, Op.ALLREDUCE, i + 1) for i in range(nslots)]
    if nslots > depth:
        with pytest.raises(ValueError):
            tring.encode_window(slots, depth)
        with pytest.raises(ValueError):
            jring.encode_window(slots, depth)
        return
    np.testing.assert_array_equal(tring.encode_window(slots, depth),
                                  jring.encode_window(slots, depth))


@pytest.mark.parametrize("x", [0.0, 1.0, -0.5, 0.001, 3.25e-5, 1e5, -1e9,
                               123.456])
def test_fparam_equals_jax(x):
    assert tring.encode_fparam(x) == jring.encode_fparam(x)
    w = tring.encode_fparam(x)
    assert tring.decode_fparam(w) == jring.decode_fparam(w)


@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("fuse", [0, 1, 2, 3])
def test_ring_widths_equal_jax(size, fuse):
    for op in (jconst.Operation.ALLREDUCE, jconst.Operation.BCAST,
               jconst.Operation.REDUCE_SCATTER, jconst.Operation.ALLGATHER,
               jconst.Operation.ALLTOALL, jconst.Operation.BARRIER):
        for count in (0, 1, 5, 1000):
            assert tring.ring_widths(
                tconst.Operation(int(op)), count, size, fuse) == \
                jring.ring_widths(op, count, size, fuse)


@pytest.mark.parametrize("fuse", [0, 1, 2, 3, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_fused_slot_eligible_equals_jax(fuse, dtype):
    np_dtype = jnp.dtype(dtype)
    for op in (jconst.Operation.ALLREDUCE, jconst.Operation.REDUCE_SCATTER):
        for size in (1, 2, 4):
            for count, opn_extra in ((4, 0), (4, 1)):
                for compressed in (False, True):
                    in_w = (jring.ring_widths(op, count, size, fuse)[0]
                            if fuse in (0, 1, 2, 3) else count)
                    args = (fuse, op, size, count, in_w + opn_extra)
                    want = jring.fused_slot_eligible(
                        *args, np_dtype, compressed=compressed)
                    got = tring.fused_slot_eligible(
                        fuse, tconst.Operation(int(op)), size, count,
                        in_w + opn_extra, dtype, compressed=compressed)
                    assert got == want


def test_window_shape_key_equals_jax():
    args = (3, (8, 32, 1), (8, 8, 1), (None, "bfloat16", None))
    assert tring.WindowShape(*args, "float32").key() == jring.WindowShape(
        *args, np.float32).key()
    assert tring.WindowShape(*args, torch.float32) == tring.WindowShape(
        *args, "float32")


# ---------------------------------------------------------------------------
# slot_epilogue, every width class and opcode
# ---------------------------------------------------------------------------


def _classes(P, n):
    """(in_w, out_w, opcodes) per width class at world size P."""
    fused = [Op.FUSED_MATMUL_RS, Op.FUSED_APPLY, Op.FUSED_ATTN_HOP]
    cases = [
        (n, n * P, [Op.ALLGATHER, Op.ALLREDUCE]),
        (n * (P + 1), n, [Op.FUSED_APPLY, Op.ALLREDUCE]),
        (n * P, n, [Op.REDUCE_SCATTER, Op.FUSED_MATMUL_RS,
                    Op.FUSED_ATTN_HOP, Op.NOP]),
        (n * P, n * P, [Op.ALLREDUCE, Op.BCAST, Op.BARRIER, Op.ALLTOALL,
                        Op.SEND, Op.NOP, Op.HALT]),
        (n, n, [Op.ALLREDUCE, Op.BCAST, Op.ALLTOALL]),
    ]
    if P > 2:
        cases.append((2 * n, n, [Op.FUSED_ATTN_HOP, Op.ALLREDUCE]))
    return cases, fused


def _rows(rng, P, w, dtype):
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, (P, w), dtype=np.int32)
    x = rng.standard_normal((P, w)).astype(np.float32)
    if w > 1:
        x[0, 1] = np.nan
    return x.astype(jnp.dtype(dtype))


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(interop.to_numpy(got),
                                  np.asarray(want).astype(
                                      interop.to_numpy(got).dtype))


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("fn", [SUM, MAX])
def test_slot_epilogue_equals_jax(P, dtype, fn):
    rng = np.random.default_rng(100 + P)
    n = 5
    cases, fused = _classes(P, n)
    fparam = tring.encode_fparam(-0.375)
    for in_w, out_w, opcodes in cases:
        rows = _rows(rng, P, in_w, dtype)
        jblocks = [jnp.asarray(r) for r in rows]
        tblocks = interop.stacked_from_numpy(rows, "cpu")
        chunk = in_w // P if in_w % P == 0 else None
        for op in opcodes:
            if dtype == "int32" and op in fused:
                continue
            for me in range(P):
                for root, peer in ((0, 1), (P - 1, P - 1)):
                    args = (me, int(op), fn, root, peer, out_w)
                    want = jdev.slot_epilogue(
                        jblocks, jblocks[me], *args, chunk=chunk,
                        fparam=fparam)
                    got = tdev.slot_epilogue(
                        tblocks, tblocks[me], *args, chunk=chunk,
                        fparam=fparam)
                    assert got.shape[0] == np.asarray(want).shape[0]
                    _same(got, want)


def test_status_words_equal_jax():
    slots = np.stack([tring.encode_slot(i, op, 4) for i, op in
                      enumerate([0, 1, 12, 13, -1, 0x7F])])
    np.testing.assert_array_equal(
        tdev.status_words(slots), np.asarray(jdev.status_words(
            jnp.asarray(slots))))


def test_hop_source_and_attn_partial():
    from accl_tpu.ops.pallas.attention import attn_hop_partial
    from accl_tpu.ops.pallas.ring import hop_source

    for P in (2, 3, 5):
        for me in range(P):
            for hop in range(-P, 2 * P):
                assert tdev.hop_source(me, hop, P) == hop_source(me, hop, P)
    q, kv = np.float32([1.5, -2.0]), np.float32([3.0, 0.25])
    _same(tdev.attn_hop_partial(torch.from_numpy(q), torch.from_numpy(kv),
                                0.5), attn_hop_partial(q, kv, 0.5))


# ---------------------------------------------------------------------------
# one window: the port's run_window against the JAX run_windows (xla)
# ---------------------------------------------------------------------------


def _window(P, n, dtype, wire):
    """A mixed window: (slots, per-slot stacked operand rows, shape
    args)."""
    specs = [  # (opcode, in_w, out_w, function, root, peer, fparam, wire)
        (Op.ALLREDUCE, n, n, SUM, 0, 0, 0, wire),
        (Op.ALLREDUCE, n, n, MAX, 0, 0, 0, None),
        (Op.BCAST, n, n, SUM, P - 1, 0, 0, wire),
        (Op.REDUCE_SCATTER, n * P, n, SUM, 0, 0, 0, wire),
        (Op.ALLGATHER, n, n * P, SUM, 0, 0, 0, wire),
        (Op.ALLTOALL, n * P, n * P, SUM, 0, 0, 0, None),
        (Op.BARRIER, 1, 1, SUM, 0, 0, 0, None),
    ]
    if dtype != "int32" and wire is None:
        fp = tring.encode_fparam(0.25)
        specs += [
            (Op.FUSED_APPLY, n * (P + 1), n, SUM, 0, 0, fp, None),
            (Op.FUSED_MATMUL_RS, n * P, n, SUM, 0, 0, fp, None),
            (Op.FUSED_ATTN_HOP, 2 * n, n, SUM, 0, 1, fp, None),
        ]
    rng = np.random.default_rng(7)
    slots, rows = [], []
    for i, (op, in_w, out_w, fn, root, peer, fp, w) in enumerate(specs):
        slots.append(tring.encode_slot(40 + i, op, n, function=fn, root=root,
                                       peer=peer, fparam=fp))
        rows.append(_rows(rng, P, in_w, dtype))
    shape = (len(specs), [s[1] for s in specs], [s[2] for s in specs],
             [s[7] for s in specs])
    return np.stack(slots), rows, shape


@pytest.mark.parametrize("dtype,wire", [
    ("float32", None), ("float32", "bfloat16"), ("float32", "float16"),
    ("int32", None),
])
def test_run_window_equals_jax_run_windows(dtype, wire):
    P, n = 4, 12
    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} devices")
    slots, rows, (depth, in_ws, out_ws, wires) = _window(P, n, dtype, wire)
    mesh = jdriver.make_mesh(P)
    sharding = NamedSharding(mesh, PS(jdriver.AXIS))
    globals_ = [jax.device_put(r.reshape(-1), sharding) for r in rows]
    jshape = jring.WindowShape(depth, in_ws, out_ws, wires, jnp.dtype(dtype))
    st, results = jdev.run_windows([(slots, globals_)], mesh, jshape,
                                   lowering="xla")
    tshape = tring.WindowShape(depth, in_ws, out_ws, wires, dtype)
    xs = [interop.stacked_from_numpy(r, "cpu") for r in rows]
    outs = [[torch.empty(kseq.result_width(in_ws[i], out_ws[i], P),
                         dtype=xs[i][0].dtype) for _ in range(P)]
            for i in range(depth)]
    status = tdev.run_window(slots, xs, outs, tshape)
    np.testing.assert_array_equal(status.numpy(), jdev.status_view(st))
    for i in range(depth):
        want = np.asarray(results[0][i]).reshape(P, -1)
        if in_ws[i] == 1:  # the barrier token: never written back
            continue
        for r in range(P):
            _same(outs[i][r], want[r])


def _plain_reference(slots, rows, shape):
    """Every slot from the operands as they were before the window."""
    depth, in_ws, out_ws, wires = shape
    P = len(rows[0])
    res = []
    for i, w in enumerate(slots):
        blocks = [torch.from_numpy(np.array(r[:in_ws[i]])) for r in rows[i]]
        res.append([tdev.slot_epilogue(
            blocks, blocks[me], me, w[1], w[4], w[5], w[8], out_ws[i],
            chunk=in_ws[i] // P if in_ws[i] % P == 0 else None,
            fparam=w[10]) for me in range(P)])
    return res


def test_run_window_in_place_and_hazards():
    """In-place allreduce, reduce-scatter and allgather, a later slot
    writing what an earlier one reads (WAR) and two slots writing one
    buffer (WAW) run in slot order from the pre-window operands; a slot
    reading an earlier slot's result is refused."""
    P, n = 4, 6
    rng = np.random.default_rng(3)
    a = [torch.from_numpy(rng.standard_normal(P * n).astype(np.float32))
         for _ in range(P)]
    b = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
         for _ in range(P)]
    ag = [torch.zeros(P * n) for _ in range(P)]
    for r in range(P):
        ag[r][r * n:(r + 1) * n] = torch.from_numpy(
            rng.standard_normal(n).astype(np.float32))
    snap = [[x.clone() for x in t] for t in (a, b, ag)]
    slots = np.stack([
        tring.encode_slot(0, Op.ALLREDUCE, n),       # b in place
        tring.encode_slot(1, Op.REDUCE_SCATTER, n),  # a -> a[:n], in place
        tring.encode_slot(2, Op.ALLGATHER, n),       # MPI in-place allgather
        tring.encode_slot(3, Op.BCAST, n, root=1),   # WAR + WAW on b
    ])
    xs = [b, a, [g[r * n:(r + 1) * n] for r, g in enumerate(ag)],
          [x[:n] for x in snap[1]]]
    outs = [b, [x[:n] for x in a], ag, b]
    shape = tring.WindowShape(4, (n, P * n, n, n), (n, n, P * n, n),
                              (None,) * 4, torch.float32)
    tdev.run_window(slots, xs, outs, shape)
    ref = _plain_reference(slots, [
        snap[1], snap[0], [g[r * n:(r + 1) * n] for r, g in
                           enumerate(snap[2])], [x[:n] for x in snap[1]]],
        (4, shape.in_ws, shape.out_ws, shape.wires))
    for r in range(P):
        _same(a[r][:n], ref[1][r])
        _same(ag[r], ref[2][r])
        _same(b[r], ref[3][r])  # the later bcast wins
    b2 = [torch.zeros(n) for _ in range(P)]
    raw = np.stack([tring.encode_slot(0, Op.ALLREDUCE, n),
                    tring.encode_slot(1, Op.ALLREDUCE, n)])
    with pytest.raises(ValueError, match="reads what slot"):
        tdev.run_window(raw, [b, b2], [b2, [torch.zeros(n)
                                            for _ in range(P)]],
                        tring.WindowShape(2, (n, n), (n, n), (None, None),
                                          torch.float32))


def test_sequencer_wrapper_runs_plain_on_cpu():
    P, n = 3, 10
    slots, rows, (depth, in_ws, out_ws, wires) = _window(P, n, "float32",
                                                         None)
    xs = [interop.stacked_from_numpy(r, "cpu") for r in rows]
    outs = [[torch.empty(kseq.result_width(in_ws[i], out_ws[i], P))
             for _ in range(P)] for i in range(depth)]
    kseq.sequencer.launches.reset()
    shape = tring.WindowShape(depth, in_ws, out_ws, wires, "float32")
    status = kseq.sequencer(slots, xs, outs, shape)
    assert kseq.sequencer.launches.count == 0
    ref = [[torch.empty_like(o) for o in row] for row in outs]
    np.testing.assert_array_equal(
        status.numpy(), kseq.sequencer_plain(slots, xs, ref, shape).numpy())
    for row, ref_row in zip(outs, ref):
        for o, w in zip(row, ref_row):
            _same(o, w.numpy())
    assert kseq.launches_for(4, 8) == 1 and kseq.launches_for(8, 64) == 1
    assert kseq.launches_for(16, 64) == 2


# ---------------------------------------------------------------------------
# the card's launch path on the host: the packed descriptor, the cached
# hazard verdicts
# ---------------------------------------------------------------------------


def _tensors(rows, in_ws, out_ws, P):
    xs = [interop.stacked_from_numpy(r, "cpu") for r in rows]
    outs = [[torch.empty(kseq.result_width(in_ws[i], out_ws[i], P),
                         dtype=xs[i][0].dtype) for _ in range(P)]
            for i in range(len(rows))]
    return xs, outs


def _unpack_window(d: np.ndarray) -> dict:
    """A descriptor's fields as Python values (the slots and rank-slots it
    holds; pointers 0 read as None)."""
    k, P = int(d["n_slots"]), int(d["P"])
    per_slot = ("in_w", "out_w", "chunk", "cols", "cls", "wire", "sync",
                "parts")
    out = {f: [int(v) for v in d[f][:k]] for f in per_slot}
    out["words"] = np.array(d["words"][:k])
    out["n_slots"], out["P"], out["dtype"] = k, P, int(d["dtype"])
    for f in ("in", "out"):
        out[f] = [int(p) or None for p in d[f][:k * P]]
    return out



@pytest.mark.parametrize("dtype,wire", [
    ("float32", None), ("float32", "bfloat16"), ("float32", "float16"),
    ("int32", None),
])
def test_packed_descriptor_round_trips(dtype, wire):
    """``pack_window`` keeps the window's words, widths, width classes,
    wires, barrier flags, work geometry and pointers, in the place the
    kernel's ``Window`` reads them, for the windows of
    ``test_run_window_equals_jax_run_windows``; the barrier rank's results
    (none) give its slot no work."""
    P, n = 4, 12
    slots, rows, (depth, in_ws, out_ws, wires) = _window(P, n, dtype, wire)
    shape = tring.WindowShape(depth, in_ws, out_ws, wires, dtype)
    xs, outs = _tensors(rows, in_ws, out_ws, P)
    outs[-1][1] = None  # a rank that takes no result
    barrier = [i for i, w in enumerate(slots) if w[1] == Op.BARRIER][0]
    outs[barrier] = [None] * P
    words = kseq._words(slots)
    spans = kseq.spans_of(xs, outs, shape, P)
    sync = [i % 3 == 1 for i in range(depth)]
    in_ptrs = [t.data_ptr() for row in xs for t in row]
    out_ptrs = [None if t is None else t.data_ptr()
                for row in outs for t in row]
    assert spans[0::2] == tuple(
        p or 0 for i in range(depth) for p in
        in_ptrs[i * P:(i + 1) * P] + out_ptrs[i * P:(i + 1) * P])
    got = _unpack_window(kseq.pack_window(words, shape, P, sync,
                                              in_ptrs, out_ptrs))
    np.testing.assert_array_equal(got["words"], slots)
    assert (got["n_slots"], got["P"]) == (depth, P)
    assert got["dtype"] == int(tconst.torch_to_dtype(shape.dtype))
    assert got["in_w"] == list(in_ws) and got["out_w"] == list(out_ws)
    assert got["cls"] == [kseq.slot_class(a, b, P)
                          for a, b in zip(in_ws, out_ws)]
    assert got["wire"] == [0 if w is None else
                           int(tconst.torch_to_dtype(w))
                           for w in shape.wires]
    assert got["sync"] == [int(f and i > 0) for i, f in enumerate(sync)]
    assert got["in"] == in_ptrs
    assert got["out"] == out_ptrs
    split = (Op.REDUCE_SCATTER, Op.FUSED_MATMUL_RS, Op.FUSED_APPLY)
    for i, w in enumerate(slots):  # every result apart from the operands
        cls, chunk, cols, parts = kseq.geometry(in_ws[i], out_ws[i], P,
                                                w[1], i != barrier, True)
        assert (got["chunk"][i], got["cols"][i], got["parts"][i]) == (
            chunk, cols, parts)
        if i == barrier:
            assert parts == 0
        elif w[1] == Op.ALLTOALL:
            assert (cols, parts) == (n, P * (P + 1) // 2)
        else:
            assert parts == (P if w[1] in split else 1)
            assert cols == kseq.result_width(in_ws[i], out_ws[i], P) // (
                P if cls == kseq.CLS_AG else 1)
    # a reduce-scatter in place (rank 0's result over its operand) takes
    # every rank's result an item
    rs = [i for i, w in enumerate(slots) if w[1] == Op.REDUCE_SCATTER][0]
    in_place = list(out_ptrs)
    in_place[rs * P] = in_ptrs[rs * P]
    assert _unpack_window(kseq.pack_window(
        words, shape, P, sync, in_ptrs, in_place))["parts"][rs] == 1
    # slots 3: of the window, as the second launch of a split window
    part = _unpack_window(kseq.pack_window(words, shape, P, sync,
                                               in_ptrs, out_ptrs, 3, 6))
    np.testing.assert_array_equal(part["words"], slots[3:6])
    assert part["in"] == in_ptrs[3 * P:6 * P]
    assert part["sync"] == [0, int(sync[4]), int(sync[5])]


def test_window_layout_equals_the_kernel_struct():
    """``WINDOW``'s offsets and size are those ``csrc/cmdring.cu`` asserts
    of its ``Window``."""
    import re

    from accl_tpu_torch.ops.cuda import _build

    src = (_build.CSRC / "cmdring.cu").read_text()
    asserted = dict(re.findall(
        r"static_assert\(offsetof\(Window, (\w+)\) == (\d+)", src))
    assert asserted and all(kseq.WINDOW.fields[f][1] == int(v)
                            for f, v in asserted.items())
    size = re.search(r"static_assert\(sizeof\(Window\) == (\d+)", src)
    assert kseq.WINDOW.itemsize == int(size.group(1))



def _planned_window(P, n, dtype, wire, depth=None):
    """``pack_window``'s descriptor of a mixed window of every slot class
    under ``wire`` (its first ``depth`` slots), with an item prefix and
    int8 segments filled in as ``accl_sequencer_plan`` would fill them
    (the CPU has no kernel library)."""
    slots, rows, (d_, in_ws, out_ws, wires) = _window(P, n, dtype, None)
    depth = d_ if depth is None else depth
    slots, rows = slots[:depth], rows[:depth]
    wires = [wire if w_ is None else w_ for w_ in wires[:depth]]
    for w_ in slots:
        w_[6] = 77  # a seed word: the lanes' flags
    shape = tring.WindowShape(depth, in_ws[:depth], out_ws[:depth], wires,
                              dtype)
    xs, outs = _tensors(rows, in_ws[:depth], out_ws[:depth], P)
    in_ptrs = [t.data_ptr() for row in xs for t in row]
    out_ptrs = [t.data_ptr() for row in outs for t in row]
    d = kseq.pack_window(kseq._words(slots), shape, P,
                         [i % 3 == 2 for i in range(depth)], in_ptrs,
                         out_ptrs)
    d["first"][:depth + 1] = np.cumsum([0] + list(d["parts"][:depth]) * 1)
    d["maxseg"] = 5
    return d, slots


@pytest.mark.parametrize("P", [2, 3, 4, 8])
@pytest.mark.parametrize("wire", [None, "bfloat16", "float16", "float8_e4m3fn",
                                  "float8_e5m2", "int8"])
def test_posted_form_expands_to_the_descriptor(P, wire):
    """A run's window travels in its posted form (the used extents of the
    descriptor): written into the run's stage as its fetching warp writes
    it, it is
    ``pack_window``'s planned descriptor byte for byte, for every slot
    class and wire, at odd and even depths (a 4-byte field of odd depth
    carries its next, zero entry)."""
    for depth in (1, 3, 6, 7):
        d, _ = _planned_window(P, 12, "float32", wire, depth)
        form = kseq.posted_form(d, depth, P)
        assert form.nbytes == kseq.run_bytes(depth, P)
        assert form.nbytes % 16 == 0
        got = kseq.expand_posted(form, depth, P)
        assert got.tobytes() == d.tobytes()
    # the main path's window, 8 slots of 4 ranks, crosses the bus in
    # 1,344 bytes of the descriptor's 14,616
    assert kseq.run_bytes(8, 4) == 1344
    assert kseq.run_bytes(64, 8) <= (kseq._MAPPED_BYTES - kseq._DESCS) // (
        tconst.CMDRING_MAX_RUN_WINDOWS)


def test_run_descriptor_plans_once_a_template(monkeypatch):
    """A warm post plans nothing: the posted form of a descriptor template
    is planned once an instantiation, and each window copies its slot
    words into it; a window with staged operand copies is planned on its
    own, with the copies' pointers."""
    P, depth = 4, 7
    d, slots = _planned_window(P, 12, "float32", None, depth)
    plans = []

    def plan(desc):
        plans.append(1)
        rec = desc.view(kseq.WINDOW).reshape(())
        rec["first"][:depth + 1] = np.arange(depth + 1) * 3
        rec["maxseg"] = 2

    monkeypatch.setattr(kseq, "_plan", plan)
    packed = {0: (d.reshape(1).view(np.int32), True)}
    words = kseq._words(slots)
    forms = []
    for seqn in (100, 101, 102):
        w = words.copy()
        w[:, 0] = seqn + np.arange(depth)
        forms.append((w, kseq._run_descriptor(packed, w, depth, P, False,
                                              {})))
    assert len(plans) == 1
    for w, form in forms:
        got = kseq.expand_posted(form, depth, P)
        np.testing.assert_array_equal(got["words"][:depth], w)
        assert list(got["first"][:depth + 1]) == list(
            np.arange(depth + 1) * 3)
        assert int(got["maxseg"]) == 2
    kseq._run_descriptor(packed, words, depth, P, True, {})
    assert len(plans) == 2  # the LANES instantiation plans its own
    copy = torch.zeros(12)
    form = kseq._run_descriptor(packed, words, depth, P, False,
                                {(0, 1): copy})
    assert len(plans) == 3
    assert int(kseq.expand_posted(form, depth, P)["in"][1]) == copy.data_ptr()


def test_run_layout_equals_the_kernel_table():
    """``RUN_SEGMENTS`` is ``csrc/cmdring.cu``'s ``kRunSeg`` row for row,
    and the run's control words sit where the kernel asserts ``RunCtl``'s
    fields."""
    import re

    from accl_tpu_torch.ops.cuda import _build

    src = (_build.CSRC / "cmdring.cu").read_text()
    rows = re.findall(r"\{offsetof\(Window, (\w+)\), (\d+), (\d+), "
                      r"(\d+)\}", src)
    assert [(f, int(a), int(b), int(c)) for f, a, b, c in rows] == list(
        kseq.RUN_SEGMENTS)
    ctl = dict(re.findall(r"static_assert\(offsetof\(RunCtl, (\w+)\) == "
                          r"(\d+)", src))
    assert int(ctl["done"]) == 4 * kseq._DONE
    assert int(ctl["ahead"]) == 4 * kseq._AHEAD
    assert kseq._EXITED == kseq._DONE + 1 == kseq._CLOSING - 1
    assert re.search(r"static_assert\(sizeof\(RunCtl\) == (\d+)",
                     src).group(1) == str(kseq._CTL_BYTES)

def _hazard_case(P, n):
    """In-place allreduce and reduce-scatter, a bcast writing what slot 0
    reads and writes (WAR, WAW), and an allreduce whose rank-0 result lies
    over rank 1's operand (staged)."""
    rng = np.random.default_rng(11)

    def t(m):
        return torch.from_numpy(rng.standard_normal(m).astype(np.float32))

    a = [t(P * n) for _ in range(P)]
    b, c, f = ([t(n) for _ in range(P)] for _ in range(3))
    slots = np.stack([
        tring.encode_slot(0, Op.ALLREDUCE, n),
        tring.encode_slot(1, Op.REDUCE_SCATTER, n),
        tring.encode_slot(2, Op.BCAST, n, root=1),
        tring.encode_slot(3, Op.ALLREDUCE, n),
    ])
    xs = [b, a, c, f]
    outs = [b, [x[:n] for x in a], b[:1] + [t(n) for _ in range(P - 1)],
            f[1:2] + [t(n) for _ in range(P - 1)]]
    shape = tring.WindowShape(4, (n, P * n, n, n), (n, n, n, n),
                              (None,) * 4, torch.float32)
    return slots, xs, outs, shape


def test_hazard_cache_equals_uncached_hazards():
    """The cached verdict equals ``_hazards`` on fresh buffers, again on
    the same buffers (a hit), and where a buffer is freed and another of
    another size takes its address (a new key: here slot 3's larger
    results reach into slot 0's operand, a write after read)."""
    P, n = 4, 8
    kseq._verdicts.clear()
    slots, xs, outs, shape = _hazard_case(P, n)
    words = kseq._words(slots)

    def both(xs_, outs_, shape_):
        spans = kseq.spans_of(xs_, outs_, shape_, P)
        sync, stage = kseq._hazards(words, spans, shape_, P)
        assert kseq._cached(words, spans, shape_, P)[:2] == (
            sync, frozenset(stage))
        return sync, stage

    sync, stage = both(xs, outs, shape)
    assert sync == [False, False, True, False] and stage == {(3, 1)}
    assert (kseq._verdicts.hits, kseq._verdicts.misses) == (0, 1)
    assert both(xs, outs, shape) == (sync, stage)
    assert (kseq._verdicts.hits, kseq._verdicts.misses) == (1, 1)
    base = torch.zeros(3 * n)  # slot 0's rank-0 operand at its end
    xs2 = [[base[2 * n:]] + xs[0][1:]] + xs[1:3] + [
        [torch.zeros(2 * n) for _ in range(P)]]
    assert both(xs2, outs[:3] + [[torch.empty(n) for _ in range(P)]],
                shape) == (sync, set())
    # the buffer at slot 3's rank-0 result, now twice the size
    outs2 = outs[:3] + [[base[n:]] + [torch.empty(2 * n)
                                      for _ in range(P - 1)]]
    shape2 = tring.WindowShape(4, (n, P * n, n, 2 * n), (n, n, n, 2 * n),
                               (None,) * 4, torch.float32)
    assert both(xs2, outs2, shape2) == ([False, False, True, True], set())
    assert (kseq._verdicts.hits, kseq._verdicts.misses) == (1, 3)


def test_cached_refusal_raises_the_same_message():
    P, n = 4, 6
    kseq._verdicts.clear()
    b = [torch.zeros(n) for _ in range(P)]
    b2 = [torch.zeros(n) for _ in range(P)]
    raw = kseq._words(np.stack([tring.encode_slot(0, Op.ALLREDUCE, n),
                                tring.encode_slot(1, Op.ALLREDUCE, n)]))
    shape = tring.WindowShape(2, (n, n), (n, n), (None, None),
                              torch.float32)
    spans = kseq.spans_of([b, b2], [b2, [torch.zeros(n) for _ in range(P)]],
                          shape, P)
    with pytest.raises(ValueError) as first:
        kseq._hazards(raw, spans, shape, P)
    for _ in range(2):
        with pytest.raises(ValueError) as cached:
            kseq._cached(raw, spans, shape, P)
        assert str(cached.value) == str(first.value)
        assert "reads what slot" in str(cached.value)
    assert (kseq._verdicts.hits, kseq._verdicts.misses) == (1, 1)


# ---------------------------------------------------------------------------
# the facade: batched windows on both gangs
# ---------------------------------------------------------------------------

P4 = 4


@pytest.fixture(scope="module")
def gangs():
    jg = xla_group(P4)
    tg = at.cuda_group(P4, device="cpu")
    yield jg, tg
    for a in jg + tg:
        a.deinit()


def _ring_of(group):
    return group[0].engine.gang.cmdring


def _counters(group):
    st = _ring_of(group).stats()
    return {k: st[k] for k in ("refills", "doorbells", "slots", "wraps")}, \
        dict(st["ops"]), dict(st["fallbacks"])


def _delta(before, after):
    c0, o0, f0 = before
    c1, o1, f1 = after
    dc = {k: c1[k] - c0[k] for k in c0}
    do = {k: v - o0.get(k, 0) for k, v in o1.items() if v != o0.get(k, 0)}
    df = {k: v - f0.get(k, 0) for k, v in f1.items() if v != f0.get(k, 0)}
    return dc, do, df


def _both(gangs, work):
    """``work(accl, rank)`` on both gangs; returns (jax results, port
    results, jax counter delta, port counter delta)."""
    jg, tg = gangs
    out = []
    for g in (jg, tg):
        before = _counters(g)
        res = run_parallel(g, work)
        out.append((res, _delta(before, _counters(g))))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _host(buf):
    buf.sync_from_device()
    d = buf.data
    return np.array(d, dtype=np.float32 if d.dtype.name == "bfloat16"
                    else d.dtype)


def _assert_same(want, got):
    for w_rank, g_rank in zip(want, got):
        for w, g in zip(w_rank, g_rank):
            np.testing.assert_array_equal(g, w)


def _window_a(n, data, params, grads):
    def work(a, r):
        P = a.size
        s = a.create_buffer_from(data[r].copy())
        bufs = [a.create_buffer(n, np.float32) for _ in range(3)]
        bc = a.create_buffer_from(data[r][:n].copy())
        ag = a.create_buffer(P * n, np.float32)
        a2 = a.create_buffer(P * n, np.float32)
        fa = a.create_buffer_from(np.concatenate([grads[r], params[r]]))
        fout = a.create_buffer(n, np.float32)
        with a.batch():
            reqs = [
                a.allreduce(s, bufs[0], n, run_async=True),
                a.allreduce(s, bufs[1], n, function=MAX, run_async=True),
                a.bcast(bc, n, root=2, run_async=True),
                a.reduce_scatter(s, bufs[2], n, run_async=True),
                a.allgather(s, ag, n, run_async=True),
                a.alltoall(s, a2, n, run_async=True),
                a.barrier(run_async=True),
                a.fused_apply(fa, fout, n, lr=0.5, run_async=True),
            ]
        for q in reqs:
            assert q.wait(60)
            q.check()
            assert q.ring_resident is True
        status = a.engine.gang.cmdring.last_status(a.comm.id)
        return [_host(b) for b in bufs + [bc, ag, a2, fout]] + [status]

    return work


def test_batched_window_equals_jax(gangs):
    n = 24
    rng = np.random.default_rng(21)
    data = rng.standard_normal((P4, P4 * n)).astype(np.float32)
    data[1, 3] = np.nan  # NaN rides the MAX and SUM folds
    params = rng.standard_normal((P4, n)).astype(np.float32)
    grads = rng.standard_normal((P4, P4 * n)).astype(np.float32)
    want, got, dj, dt = _both(gangs, _window_a(n, data, params, grads))
    _assert_same(want, got)
    assert dj == dt
    assert dt[0]["refills"] == 1 and dt[0]["slots"] == 8
    assert dt[2] == {}
    # the results are the collectives' (numpy, rank-order fold)
    fold = data[0].copy()
    for r in range(1, P4):
        fold = fold + data[r]
    for r in range(P4):
        np.testing.assert_array_equal(got[r][0], fold[:n])
        np.testing.assert_array_equal(got[r][3], data[2][:n])
        np.testing.assert_array_equal(got[r][2], fold[r * n:(r + 1) * n])


def test_fused_window_and_wire_lane_equal_jax(gangs):
    n = 16
    rng = np.random.default_rng(22)
    parts = rng.standard_normal((P4, P4 * n)).astype(np.float32)
    kvq = rng.standard_normal((P4, 2 * n)).astype(np.float32)
    rows = rng.standard_normal((P4, n)).astype(np.float32)

    def work(a, r):
        mm = a.create_buffer_from(parts[r].copy())
        at_ = a.create_buffer_from(kvq[r].copy())
        s = a.create_buffer_from(rows[r].copy())
        outs = [a.create_buffer(n, np.float32) for _ in range(3)]
        with a.batch():
            reqs = [
                a.fused_matmul_reduce_scatter(mm, outs[0], n, scale=0.25,
                                              run_async=True),
                a.fused_attn_hop(at_, outs[1], hop=1, count=n, scale=2.0,
                                 run_async=True),
                a.allreduce(s, outs[2], n, compress_dtype="bfloat16",
                            run_async=True),
            ]
        for q in reqs:
            assert q.wait(60)
            q.check()
            assert q.ring_resident is True
        return [_host(b) for b in outs] + [
            a.engine.gang.cmdring.last_status(a.comm.id)]

    want, got, dj, dt = _both(gangs, work)
    _assert_same(want, got)
    assert dj == dt and dt[0]["refills"] == 1 and dt[2] == {}
    assert dt[1] == {"FUSED_MATMUL_RS": 1, "FUSED_ATTN_HOP": 1,
                     "ALLREDUCE": 1}


def _set_max_bytes(gangs, value):
    old = [_ring_of(g).max_bytes for g in gangs]
    for g in gangs:
        _ring_of(g).max_bytes = value
    return old


@pytest.mark.parametrize("reason", [
    "oversized", "unsupported_op", "mixed_dtype", "data_dependency",
    "tuning_override",
])
def test_fallback_reasons_equal_jax(gangs, reason):
    n = 32
    rng = np.random.default_rng(23)
    data = rng.standard_normal((P4, n)).astype(np.float32)
    ints = rng.integers(-1000, 1000, (P4, n)).astype(np.int32)

    def work(a, r):
        s = a.create_buffer_from(data[r].copy())
        d1 = a.create_buffer(n, np.float32)
        d2 = a.create_buffer(n, np.float32)
        with a.batch():
            reqs = [a.allreduce(s, d1, n, run_async=True)]
            if reason == "unsupported_op":
                reqs.append(a.reduce(s, d2 if r == 0 else None, n, root=0,
                                     run_async=True))
            elif reason == "mixed_dtype":
                si = a.create_buffer_from(ints[r].copy())
                di = a.create_buffer(n, np.int32)
                reqs.append(a.allreduce(si, di, n, run_async=True))
            elif reason == "data_dependency":
                reqs.append(a.allreduce(d1, d2, n, run_async=True))
            else:
                reqs.append(a.allreduce(s, d2, n, function=MAX,
                                        run_async=True))
        for q in reqs:
            assert q.wait(60)
            q.check()
            assert not q.ring_resident
        return [_host(d1), _host(d2)] + (
            [_host(di)] if reason == "mixed_dtype" else [])

    old = None
    if reason == "oversized":
        old = _set_max_bytes(gangs, 64)
    if reason == "tuning_override":
        for g in gangs:
            for a in g:
                a.set_tuning("reduce_algorithm", "pallas_ring")
    try:
        want, got, dj, dt = _both(gangs, work)
    finally:
        if old is not None:
            for g, v in zip(gangs, old):
                _ring_of(g).max_bytes = v
        if reason == "tuning_override":
            for g in gangs:
                for a in g:
                    a.set_tuning("reduce_algorithm", "xla")
    _assert_same(want, got)
    assert dj == dt
    assert dt[2] == {reason: 1} and dt[0]["refills"] == 0


def test_fused_call_outside_batch_decomposes_as_jax(gangs):
    n = 20
    rng = np.random.default_rng(24)
    grads = rng.standard_normal((P4, P4 * n)).astype(np.float32)
    params = rng.standard_normal((P4, n)).astype(np.float32)

    def work(a, r):
        fa = a.create_buffer_from(np.concatenate([grads[r], params[r]]))
        out = a.create_buffer(n, np.float32)
        mm = a.create_buffer_from(grads[r].copy())
        out2 = a.create_buffer(n, np.float32)
        a.fused_apply(fa, out, n, lr=0.125)
        a.fused_matmul_reduce_scatter(mm, out2, n, scale=3.0)
        return [_host(out), _host(out2)]

    want, got, dj, dt = _both(gangs, work)
    _assert_same(want, got)
    assert dj == dt and dt[2] == {"fused_decomposed": 2}


def test_mismatched_fuse_param_fails_every_rank(gangs):
    n = 8

    def work(a, r):
        fa = a.create_buffer(n * (P4 + 1), np.float32)
        out = a.create_buffer(n, np.float32)
        with pytest.raises(Exception) as ei:
            a.fused_apply(fa, out, n, lr=0.5 + r)
        return int(ei.value.code)

    jg, tg = gangs
    want = run_parallel(jg, work)
    got = run_parallel(tg, work)
    assert got == want == [int(at.ErrorCode.INVALID_OPERATION)] * P4


def test_torn_batch_fails_every_rank(gangs):
    n = 8

    def work(a, r):
        s = a.create_buffer(n, np.float32)
        d = a.create_buffer(n, np.float32)
        if r % 2:
            a.begin_batch()
            req = a.allreduce(s, d, n, run_async=True)
            a.end_batch()
            assert req.wait(60)
            return int(req.get_retcode())
        try:
            a.allreduce(s, d, n)
        except Exception as e:
            return int(e.code)
        return 0

    jg, tg = gangs
    want = run_parallel(jg, work)
    got = run_parallel(tg, work)
    assert got == want == [int(at.ErrorCode.INVALID_OPERATION)] * P4


def test_slot_wrap_around_counts_as_jax(gangs):
    n = 16

    def work(a, r):
        s = a.create_buffer_from(np.full(n, float(r + 1), np.float32))
        d = a.create_buffer(n, np.float32)
        for _ in range(4):
            with a.batch():
                reqs = [a.allreduce(s, d, n, run_async=True)
                        for _ in range(3)]
            for q in reqs:
                assert q.wait(60)
                q.check()
        return [_host(d)]

    want, got, dj, dt = _both(gangs, work)
    _assert_same(want, got)
    assert dj == dt and dt[0]["wraps"] >= 1 and dt[0]["refills"] == 4
    np.testing.assert_array_equal(got[0][0], np.full(n, 10.0, np.float32))


def test_eager_mode_routes_single_calls(monkeypatch):
    monkeypatch.setenv("ACCL_CMDRING", "eager")
    g = at.cuda_group(2, device="cpu")
    try:
        ring = _ring_of(g)
        assert ring.eager and ring.stats()["mode"] == "eager"

        def work(a, r):
            s = a.create_buffer_from(np.full(8, r + 1.0, np.float32))
            d = a.create_buffer(8, np.float32)
            req = a.allreduce(s, d)
            assert req.ring_resident is True
            return _host(d)

        for got in run_parallel(g, work):
            np.testing.assert_array_equal(got, np.full(8, 3.0, np.float32))
        assert ring.stats()["refills"] == 1
    finally:
        for a in g:
            a.deinit()


def test_disabled_ring_stays_off(monkeypatch):
    monkeypatch.setenv("ACCL_CMDRING", "0")
    g = at.cuda_group(2, device="cpu")
    try:
        def work(a, r):
            s = a.create_buffer_from(np.full(8, r + 1.0, np.float32))
            d = a.create_buffer(8, np.float32)
            with a.batch():
                req = a.allreduce(s, d, run_async=True)
            assert req.wait(30) and req.ring_resident is None
            return _host(d)

        for got in run_parallel(g, work):
            np.testing.assert_array_equal(got, np.full(8, 3.0, np.float32))
        assert _ring_of(g).stats()["refills"] == 0
    finally:
        for a in g:
            a.deinit()


# ---------------------------------------------------------------------------
# the fp8 and int8 lanes
# ---------------------------------------------------------------------------

_LANES = ("float8_e4m3fn", "float8_e5m2", "int8")


def _jax_eager_slot(rows, op, n, wire, flags, out_w, P):
    """A slot's per-rank results from JAX's EAGER codec (each rank's row
    through ``wire_lane_roundtrip`` with ``rank_seed(flags, r)``) and
    JAX's ``slot_epilogue``: the port's int8 reference, since JAX's jitted
    ring divides by 127 as a multiply
    (``test_torch_wire.py::test_int8_scale_divergence``)."""
    from accl_tpu.ops import wire as jdw

    own = [jnp.asarray(r) for r in rows]
    blocks = [jdw.wire_lane_roundtrip(
        x, jnp.dtype(wire), jdw.rank_seed(jnp.uint32(flags), r))
        for r, x in enumerate(own)]
    in_w = rows.shape[1]
    chunk = in_w // P if in_w % P == 0 else None
    return [np.asarray(jdev.slot_epilogue(
        blocks, own[me], me, int(op), 0, P - 1, 1, out_w, chunk=chunk))
        for me in range(P)]


@pytest.mark.parametrize("wire", _LANES)
@pytest.mark.parametrize("seed", [0, 12345])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_sequencer_plain_lanes_equal_jax_decode_slot(wire, seed, P):
    """Every opcode class under the fp8 / int8 lanes, seeded from the
    flags word, against JAX's ``run_windows(..., lowering="xla")`` (its
    ``_decode_slot_xla``): fp8 bit for bit; int8 bit for bit against
    JAX's eager codec and within one ulp of the scale of JAX's jitted
    ring.  The reduce-scatter and alltoall chunks of n = 300 start off
    the 256-element segments."""
    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} devices")
    n = 300
    specs = [(Op.ALLREDUCE, n, n), (Op.BCAST, n, n),
             (Op.REDUCE_SCATTER, n * P, n), (Op.ALLGATHER, n, n * P),
             (Op.ALLTOALL, n * P, n * P)]
    rng = np.random.default_rng(40 + P)
    mesh = jdriver.make_mesh(P)
    sharding = NamedSharding(mesh, PS(jdriver.AXIS))
    for i, (op, in_w, out_w) in enumerate(specs):
        rows = rng.standard_normal((P, in_w)).astype(np.float32) * 3
        slots = np.stack([tring.encode_slot(9 + i, op, n, root=P - 1,
                                            flags=seed, wire=7)])
        st, res = jdev.run_windows(
            [(slots, [jax.device_put(rows.reshape(-1), sharding)])], mesh,
            jring.WindowShape(1, (in_w,), (out_w,), (wire,), jnp.float32),
            lowering="xla")
        shape = tring.WindowShape(1, (in_w,), (out_w,), (wire,), "float32")
        xs = [interop.stacked_from_numpy(rows, "cpu")]
        outs = [[torch.empty(kseq.result_width(in_w, out_w, P))
                 for _ in range(P)]]
        status = tdev.run_window(slots, xs, outs, shape)
        np.testing.assert_array_equal(status.numpy(), jdev.status_view(st))
        want = np.asarray(res[0][0]).reshape(P, -1)
        if wire == "int8":
            eager = _jax_eager_slot(rows, op, n, wire, seed, out_w, P)
        for r in range(P):
            got = outs[0][r].numpy()
            if wire == "int8":
                np.testing.assert_array_equal(got, eager[r])
                np.testing.assert_allclose(got, want[r], rtol=0,
                                           atol=4 * 2.0 ** -23 * 9)
            else:
                np.testing.assert_array_equal(got, want[r])


def test_lane_selection_and_scale_segments():
    """The LANES instantiation takes fp8 / int8 wires and a 16-bit wire
    under a nonzero seed; the scale scratch holds the widest int8 row's
    segments, 256 elements each, the last one partial."""
    f16, i8, e4 = torch.float16, torch.int8, torch.float8_e4m3fn
    words = np.stack([tring.encode_slot(0, Op.ALLREDUCE, 4),
                      tring.encode_slot(1, Op.ALLREDUCE, 4, flags=3)])
    assert not kseq.takes_lanes(words, (None, None))
    assert not kseq.takes_lanes(words, (f16, None))
    assert kseq.takes_lanes(words, (None, f16))
    assert kseq.takes_lanes(words, (e4, None))
    assert kseq.takes_lanes(words, (i8, None))
    shape = tring.WindowShape(3, (257, 2048, 10), (257, 512, 10),
                              (i8, e4, i8), "float32")
    assert kseq.scale_segments(shape) == 2
    assert kseq.scale_segments(shape, 1, 2) == 0
    assert kseq.scale_segments(shape, 2, 3) == 1


def test_lane_sequencer_refuses_other_dtypes_only_on_the_card():
    """On the CPU the plain sequencer takes an int8 lane on any float
    operand; the kernel's LANES instantiation takes float32, bfloat16 and
    float16 (its wrapper raises for others before any launch)."""
    with pytest.raises(ValueError, match="fp8 / int8 lanes"):
        kseq._check_lanes(tring.WindowShape(1, (8,), (8,), (torch.int8,),
                                            torch.float64))
    kseq._check_lanes(tring.WindowShape(1, (8,), (8,), (torch.int8,),
                                        torch.bfloat16))


# ---------------------------------------------------------------------------
# the persistent run's host half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["default_run_windows", "default_linger_s"])
@pytest.mark.parametrize("env", [None, "7", "1000", "0.5", "junk", "-3"])
def test_run_knobs_equal_jax(monkeypatch, name, env):
    for key in (jconst.CMDRING_RUN_WINDOWS_ENV, jconst.CMDRING_LINGER_ENV):
        if env is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, env)
    try:
        want = getattr(jring, name)()
    except ValueError:  # JAX's int() of "0.5"
        with pytest.raises(ValueError):
            getattr(tring, name)()
        return
    assert getattr(tring, name)() == want


class _Call:
    """The fields of a call the pair definition reads."""

    def __init__(self, op, root_src=0, root_dst=0, count=8, tag=0,
                 dtype=2, compression=0):
        from types import SimpleNamespace

        self.op, self.root_src, self.root_dst = op, root_src, root_dst
        self.count, self.tag, self.compression = count, tag, compression
        self.arithcfg = SimpleNamespace(uncompressed=dtype)


@pytest.mark.parametrize("case", range(8))
def test_complementary_pair_equals_jax(case):
    S, R = tconst.Operation.SEND, tconst.Operation.RECV
    pairs = [
        [_Call(S, root_dst=1), _Call(R, root_src=0)],
        [_Call(R, root_src=1), _Call(S, root_dst=0)],
        [_Call(S, root_dst=1), _Call(S, root_dst=0)],          # cross
        [_Call(S, root_dst=1, tag=3), _Call(R, root_src=0)],   # tag
        [_Call(S, root_dst=1, count=9), _Call(R, root_src=0)],
        [_Call(S, root_dst=1, dtype=6), _Call(R, root_src=0)],
        [_Call(S, root_dst=1, compression=1), _Call(R, root_src=0)],
        [_Call(S, root_dst=1)],
    ]
    calls = pairs[case]
    jcalls = [_Call(jconst.Operation(int(c.op)), c.root_src, c.root_dst,
                    c.count, c.tag, c.arithcfg.uncompressed, c.compression)
              for c in calls]
    assert tring.complementary_pair(calls) == jring.complementary_pair(
        jcalls)


def test_mailbox_protocol_equals_jax():
    """The same posts, pulls, pushes and halt through the port's
    SequencerMailbox and JAX's: the same decisions per step on every
    rank (the first pull decides), the same completions in order, the
    same depth, budget and drain."""

    def drive(module, dtype):
        done = []
        shape = module.WindowShape(2, (3, 1), (3, 1), (None, None), dtype)
        mb = module.SequencerMailbox(
            2, shape, run_windows=3, linger_s=0.01,
            on_window_done=lambda wid, st, res: done.append(
                (wid, np.asarray(st).tolist(), sorted(res))))
        slots = np.arange(2 * tconst.CMDRING_SLOT_WORDS, dtype=np.int32
                          ).reshape(2, -1)
        log = [mb.post(10, slots, [[np.ones(3), None], None]),
               mb.post(11, slots + 1, [[None, np.ones(3)], None]),
               mb.depth(), mb.accepting]
        for step in range(3):
            for r in (1, 0):
                live, sl, rows = mb.pull(r)
                log.append((int(live), np.asarray(sl).sum(),
                            [float(np.asarray(x).sum()) for x in rows]))
                mb.push(r, live, np.full((2, 2), step), [rows[0]])
        log += [mb.post(12, slots, [None, None]), mb.accepting,
                mb.drained.is_set(), mb.depth(),
                sorted(mb.take_timing(10) or {})]
        return log, done

    want = drive(jring, np.float32)
    got = drive(tring, torch.float32)
    assert got == want
    assert got[1] == [(10, [[0, 0], [0, 0]], [0, 1]),
                      (11, [[1, 1], [1, 1]], [0, 1])]


def test_registry_round_trip():
    mb = object()
    mid = tring.register_mailbox(mb)
    assert tring.mailbox_for(mid) is mb
    tring.unregister_mailbox(mid)
    assert tring.mailbox_for(mid) is None


# ---------------------------------------------------------------------------
# the facade: fp8 / int8 windows, the stream of windows, teardown
# ---------------------------------------------------------------------------


def _align_epochs(gangs):
    """The per-call seeds key on the communicator's id, its epoch and its
    count of seeded calls so far: take JAX's epoch and count."""
    jg, tg = gangs
    for j, t in zip(jg, tg):
        t.comm.epoch = j.comm.epoch
        t._wire_ctr = dict(j._wire_ctr)


def _slot_flags(group, comm_id, n):
    """The flags words of the last ``n`` slots the ring encoded."""
    s = _ring_of(group)._sessions[comm_id]
    idx = [(s.head - n + k) % s.ring.shape[0] for k in range(n)]
    return [int(s.ring[i][tconst.CMDRING_FIELDS["flags"]]) for i in idx]


@pytest.mark.parametrize("wire", _LANES)
def test_lane_windows_ride_the_ring_as_jax(gangs, wire):
    """Two batched windows of an allreduce, a reduce_scatter and an
    alltoall under an fp8 / int8 lane on both gangs, seeds aligned: no
    fallback, the same counters and slot seeds, a new seed for the second
    window (the per-comm counter advancing); fp8 results bit for bit,
    int8 bit for bit against JAX's eager codec on the same seeds and
    within an ulp of the scale of JAX's ring.  The seeded results differ
    from the same calls unbatched in both packages."""
    _align_epochs(gangs)
    n = 600
    rng = np.random.default_rng(50)
    data = rng.standard_normal((P4, P4 * n)).astype(np.float32)

    def work(a, r):
        s = a.create_buffer_from(data[r].copy())
        outs = []
        for _ in range(2):
            o = [a.create_buffer(n, np.float32), a.create_buffer(
                n, np.float32), a.create_buffer(P4 * n, np.float32)]
            with a.batch():
                reqs = [a.allreduce(s, o[0], n, compress_dtype=wire,
                                    run_async=True),
                        a.reduce_scatter(s, o[1], n, compress_dtype=wire,
                                         run_async=True),
                        a.alltoall(s, o[2], n, compress_dtype=wire,
                                   run_async=True)]
            for q in reqs:
                assert q.wait(60)
                q.check()
                assert q.ring_resident is True
            outs += [_host(b) for b in o]
        single = a.create_buffer(n, np.float32)
        a.allreduce(s, single, n, compress_dtype=wire)
        return outs + [_host(single)]

    want, got, dj, dt = _both(gangs, work)
    jg, tg = gangs
    fj = _slot_flags(jg, jg[0].comm.id, 6)
    ft = _slot_flags(tg, tg[0].comm.id, 6)
    assert ft == fj
    assert dj[0] == dt[0] and dt[0]["refills"] == 2
    assert dj[2] == dt[2] == {}
    assert dt[1] == {"ALLREDUCE": 2, "REDUCE_SCATTER": 2, "ALLTOALL": 2}
    # the second window's allreduce draws the next seed of the counter
    assert ft[0] != ft[3] and ft[0] != 0
    for r in range(P4):
        assert not np.array_equal(got[r][0], got[r][6])
        assert not np.array_equal(want[r][0], want[r][6])
        assert not np.array_equal(got[r][0], got[r][3])
    if wire != "int8":
        _assert_same(want, got)
        return
    specs = [(Op.ALLREDUCE, n, n, data[:, :n]),
             (Op.REDUCE_SCATTER, P4 * n, n, data),
             (Op.ALLTOALL, P4 * n, P4 * n, data)]
    for w in range(2):
        for k, (op, in_w, out_w, rows) in enumerate(specs):
            eager = _jax_eager_slot(rows, op, n, wire, ft[3 * w + k],
                                    out_w, P4)
            for r in range(P4):
                np.testing.assert_array_equal(got[r][3 * w + k], eager[r])
                np.testing.assert_allclose(got[r][3 * w + k],
                                           want[r][3 * w + k], rtol=0,
                                           atol=2.0 ** -20)


def test_halt_sessions_parks_the_ring(gangs):
    """``halt_sessions`` (an engine's shutdown) halts and joins every run:
    the ring is parked after it."""
    _ring_of(gangs[1]).halt_sessions()
    assert _ring_of(gangs[1]).parked
    assert _ring_of(gangs[1]).stats()["state"] == "parked"


@pytest.fixture(scope="module")
def g4():
    """A port gang for the JAX package's own ring tests."""
    g = at.cuda_group(P4, device="cpu")
    yield g
    for a in g:
        a.deinit()


@pytest.mark.parametrize("name", [
    "test_warm_window_is_one_refill_interaction",
    "test_mixed_opcode_window_rides_ring",
    "test_sustained_stream_zero_redispatch",
    "test_refill_underrun_parks_sequencer",
])
def test_jax_ring_tests_on_the_port(g4, name):
    """``tests/test_cmdring.py``'s own tests, unedited, on the port's
    group (its ``_ring`` and ``_interactions`` helpers read the port's
    ring and interaction counter as they read JAX's)."""
    import test_cmdring

    getattr(test_cmdring, name)(g4)


def _stream(group, windows, calls=3, n=32, linger=0.5):
    """``windows`` windows of ``calls`` allreduces posted without a drain
    between them, then one ``end_batch``: returns the ring's stats before
    and after."""
    ring = _ring_of(group)
    send = [a.create_buffer_from(np.full(n, r + 1.0, np.float32))
            for r, a in enumerate(group)]
    out = [a.create_buffer(n, np.float32) for a in group]

    def work(a, r):
        reqs = []
        a.begin_batch()
        try:
            for _ in range(windows):
                reqs += [a.allreduce(send[r], out[r], n, run_async=True)
                         for _ in range(calls)]
                a._dispatch_pending()
        finally:
            a.end_batch()
        for q in reqs:
            assert q.wait(60)
            q.check()

    saved = ring.linger_s
    ring.linger_s = linger
    try:
        before = ring.stats()
        run_parallel(group, work)
        after = ring.stats()
    finally:
        ring.linger_s = saved
    for buf in out:
        np.testing.assert_array_equal(_host(buf), np.full(
            n, sum(range(1, len(group) + 1)), np.float32))
    return before, after


def _run_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "accl-cmdring-run"]


def test_reset_and_deinit_leave_no_run_thread():
    """A stream arms a run (one ``accl-cmdring-run`` thread); ``reset()``
    halts it and its thread ends; a second run ends at ``deinit``."""
    g = at.cuda_group(2, device="cpu")
    try:
        ring = _ring_of(g)
        before, after = _stream(g, 4, linger=5.0)
        assert after["dispatches"] - before["dispatches"] == 2
        assert after["mailbox_posts"] - before["mailbox_posts"] == 2
        assert after["state"] == "resident" and _run_threads()
        ring.reset()
        deadline = time.monotonic() + 10
        while _run_threads() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not _run_threads() and ring.stats()["resets"] == 1
        _stream(g, 3, linger=5.0)
        assert _run_threads()
    finally:
        for a in g:
            a.deinit()
    assert not _run_threads()
    assert ring.stats()["state"] == "parked"


def test_lowering_pallas_keeps_windows_inline(monkeypatch):
    """``ACCL_CMDRING_LOWERING=pallas``: a stream of windows runs inline,
    one dispatch a window and no run."""
    monkeypatch.setenv("ACCL_CMDRING_LOWERING", "pallas")
    g = at.cuda_group(2, device="cpu")
    try:
        assert _ring_of(g).stats()["lowering"] == "pallas"
        before, after = _stream(g, 4)
        assert after["dispatches"] - before["dispatches"] == 4
        assert after["mailbox_posts"] == before["mailbox_posts"]
        assert not _run_threads()
    finally:
        for a in g:
            a.deinit()


def test_default_lowering_follows_the_device(monkeypatch):
    """As JAX's ``default_lowering``: the persistent session (``xla``)
    off the accelerator, every window inline (``pallas``) on it; the env
    var overrides both, and the CPU gang's ring reports JAX's choice."""
    from accl_tpu.backends.xla.cmdring import default_lowering as jlowering
    from accl_tpu_torch.backends.cuda.cmdring import default_lowering

    monkeypatch.delenv("ACCL_CMDRING_LOWERING", raising=False)
    assert default_lowering(torch.device("cpu")) == jlowering() == "xla"
    assert default_lowering(torch.device("cuda", 0)) == "pallas"
    g = at.cuda_group(2, device="cpu")
    try:
        assert _ring_of(g).stats()["lowering"] == "xla"
    finally:
        for a in g:
            a.deinit()
    for mode in ("xla", "pallas"):
        monkeypatch.setenv("ACCL_CMDRING_LOWERING", mode)
        for dev in (torch.device("cpu"), torch.device("cuda", 0)):
            assert default_lowering(dev) == mode


class _PendingEnd:
    """A run's end event that has not passed."""

    def query(self):
        return False


@pytest.mark.parametrize("device_says", ["took", "closed", "closed_late"])
def test_run_closing_handshake_host_side(device_says):
    """The host's half of a card run's closing handshake
    (``PersistentRun._took``), on control words written as the kernel
    writes them: a post that found the run closing at its window waits for
    the run's decision; the window was taken when the run cleared
    ``closing`` (or has completed it), and not when the run returned with
    ``done`` at most the window's index."""
    import threading

    k = 3
    ctl = np.zeros(64, np.int32)
    ctl[kseq._CLOSING] = k + 1
    ctl[kseq._DONE] = k
    run = object.__new__(kseq.PersistentRun)
    run.ctl, run.launched, run.end_event, run.fault = (ctl, True,
                                                       _PendingEnd(), None)

    def decide():
        time.sleep(0.02)
        if device_says == "took":
            ctl[kseq._CLOSING] = 0
        else:
            ctl[kseq._EXITED] = kseq.EXIT_LINGER

    if device_says == "closed":
        ctl[kseq._EXITED] = kseq.EXIT_LINGER
        assert run._took(k) is False
        return
    t = threading.Thread(target=decide)
    t.start()
    try:
        assert run._took(k) is (device_says == "took")
    finally:
        t.join()
    ctl[kseq._DONE] = k + 1  # a window the run completed was taken
    assert run._took(k) is True


def test_run_posture_registers():
    """``cmdring_run_windows`` / ``cmdring_linger_us`` (0: the env
    default) give the arming window's run its budget and linger; the
    registers refuse a budget above CMDRING_MAX_RUN_WINDOWS and a linger
    above 1 s."""
    g = at.cuda_group(2, device="cpu")
    try:
        ring = _ring_of(g)
        assert ring._window_posture() == (ring.run_windows, ring.linger_s)
        for a in g:
            a.set_tuning("cmdring_run_windows", 3)
            a.set_tuning("cmdring_linger_us", 900000)
        assert ring._window_posture() == (3, 0.9)
        with pytest.raises(Exception):
            g[0].set_tuning("cmdring_run_windows",
                            tconst.CMDRING_MAX_RUN_WINDOWS + 1)
        _stream(g, 3, linger=0.001)  # the register's linger wins
        run = ring._sessions[g[0].comm.id].run
        assert run.mbox.run_windows == 3 and run.mbox.linger_s == 0.9
    finally:
        for a in g:
            a.deinit()
