"""The port's plain sequencer on the operating points of the fp8 / int8
kernel's segment form, against the JAX package's ring.

``csrc/cmdring.cu`` runs a window of the fp8 / int8 lanes with no scale
phase when every int8 slot reads whole 256-element segments of its rows:
the columns of every class a multiple of 256, so every chunk at a * n
starts a segment.  These windows (every class at n = 256, 512 and 768, P
2-4, int8, e4m3 and e5m2, seeds 0 and 12345, and one window of edge
values: a segment with a NaN, one of zeros only, one with +-inf, one
whose absmax is its last element) go through the port's ``run_window``
(``sequencer_plain`` on CPU tensors, the kernel's reference on the card)
and JAX's ``run_windows(..., lowering="xla")``:

* the fp8 lanes bit for bit;
* the int8 lane bit for bit against JAX's eager codec (each rank's row
  through ``wire_lane_roundtrip``, then ``slot_epilogue``), and against
  JAX's jitted ring, which divides by 127 as a multiply, within
  ``test_torch_cmdring.py``'s tolerance, 4 * 2^-23 * 9 (four ulps of
  the rows' magnitude), and 4 * 2^-23 * 1000 on the edge rows, whose
  absmax is 1000.

The kernel itself is held against ``sequencer_plain`` on the card by
``chip_smoke.py`` (phase 2), on these windows at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

import accl_tpu.cmdring as jring
from accl_tpu.ops import driver as jdriver
from accl_tpu.ops import wire as jdw
from accl_tpu.ops.pallas import cmdring as jdev

import accl_tpu_torch.cmdring as tring
import accl_tpu_torch.constants as tconst
from accl_tpu_torch import interop
from accl_tpu_torch.ops import cmdring as tdev
from accl_tpu_torch.ops.cuda import cmdring as kseq

Op = tconst.CmdOpcode
SUM, MAX = 0, 1
LANES = ("int8", "float8_e4m3fn", "float8_e5m2")


def _specs(P, n):
    """Every class that rounds through a wire, at count n: (opcode, in_w,
    out_w, function, root, peer, fparam)."""
    fp = tring.encode_fparam(0.375)
    return [
        (Op.ALLREDUCE, n, n, SUM, 0, 0, 0),
        (Op.ALLREDUCE, n, n, MAX, 0, 0, 0),
        (Op.BCAST, n, n, SUM, P - 1, 0, 0),
        (Op.REDUCE_SCATTER, P * n, n, SUM, 0, 0, 0),
        (Op.ALLGATHER, n, P * n, SUM, 0, 0, 0),
        (Op.ALLTOALL, P * n, P * n, SUM, 0, 0, 0),
        (Op.FUSED_APPLY, (P + 1) * n, n, SUM, 0, 0, fp),
        (Op.FUSED_MATMUL_RS, P * n, n, MAX, 0, 0, fp),
        (Op.FUSED_ATTN_HOP, 2 * n, n, SUM, 0, 1, fp),
    ]


def _edges(rows):
    """Edge values in the int8 segments of each row: on rank 0 mod 4
    zeros only in the second, on rank 1 +-inf in the second, on rank 2
    the second's absmax (1000) at its last element, on rank 3 a NaN in
    the first."""
    for r in range(rows.shape[0]):
        if r % 4 == 3:
            rows[r, 5] = np.nan
        elif r % 4 == 0:
            rows[r, 256:512] = 0
        elif r % 4 == 1:
            rows[r, 256], rows[r, 300] = np.inf, -np.inf
        elif r % 4 == 2:
            rows[r, 511] = 1000.0
    return rows


def _eager(rows, spec, wire, flags, P):
    """One slot's per-rank results from JAX's eager codec and its
    ``slot_epilogue``."""
    op, in_w, out_w, fn, root, peer, fp = spec
    own = [jnp.asarray(r) for r in rows]
    blocks = [jdw.wire_lane_roundtrip(
        x, jnp.dtype(wire), jdw.rank_seed(jnp.uint32(flags), r))
        for r, x in enumerate(own)]
    chunk = in_w // P if in_w % P == 0 else None
    return [np.asarray(jdev.slot_epilogue(
        blocks, own[me], me, int(op), fn, root, peer, out_w, chunk=chunk,
        fparam=fp)) for me in range(P)]


def _check(P, n, wire, seed, edges=False):
    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} devices")
    specs = _specs(P, n)
    rng = np.random.default_rng(1000 * P + n + len(wire))
    rows = []
    for spec in specs:
        x = rng.standard_normal((P, spec[1])).astype(np.float32) * 3
        rows.append(_edges(x) if edges else x)
    slots = np.stack([tring.encode_slot(20 + i, op, n, function=fn,
                                        root=root, peer=peer, fparam=fp,
                                        flags=seed)
                      for i, (op, _, _, fn, root, peer, fp)
                      in enumerate(specs)])
    in_ws = tuple(s[1] for s in specs)
    out_ws = tuple(s[2] for s in specs)
    wires = (wire,) * len(specs)
    mesh = jdriver.make_mesh(P)
    sharding = NamedSharding(mesh, PS(jdriver.AXIS))
    st, res = jdev.run_windows(
        [(slots, [jax.device_put(r.reshape(-1), sharding) for r in rows])],
        mesh, jring.WindowShape(len(specs), in_ws, out_ws, wires,
                                jnp.float32), lowering="xla")
    shape = tring.WindowShape(len(specs), in_ws, out_ws, wires, "float32")
    xs = [interop.stacked_from_numpy(r, "cpu") for r in rows]
    outs = [[torch.empty(kseq.result_width(in_ws[i], out_ws[i], P))
             for _ in range(P)] for i in range(len(specs))]
    status = tdev.run_window(slots, xs, outs, shape)
    np.testing.assert_array_equal(status.numpy(), jdev.status_view(st))
    atol = 4 * 2.0 ** -23 * (1000.0 if edges else 9.0)
    for i, spec in enumerate(specs):
        want = np.asarray(res[0][i]).reshape(P, -1)
        eager = (_eager(rows[i], spec, wire, seed, P) if wire == "int8"
                 else None)
        for r in range(P):
            got = outs[i][r].numpy()
            if wire == "int8":
                np.testing.assert_array_equal(got, eager[r])
                np.testing.assert_allclose(got, want[r], rtol=0, atol=atol)
            else:
                np.testing.assert_array_equal(got, want[r])


@pytest.mark.parametrize("wire", LANES)
@pytest.mark.parametrize("seed", [0, 12345])
@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("n", [256, 512, 768])
def test_whole_segment_window_equals_jax(n, P, seed, wire):
    """Every class at whole int8 segments (the kernel's segment form)."""
    _check(P, n, wire, seed)


@pytest.mark.parametrize("wire", LANES)
@pytest.mark.parametrize("seed", [0, 12345])
def test_edge_segments_equal_jax(seed, wire):
    """A segment with a NaN, one of zeros (the 1e-30 scale), one with
    +-inf and one whose absmax is its last element, at P = 4."""
    _check(4, 512, wire, seed, edges=True)
