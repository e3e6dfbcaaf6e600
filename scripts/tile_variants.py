"""Time the streaming tile core against the access patterns it was chosen
over, on one GPU.

    python3 scripts/tile_variants.py

At the main path's shapes (``chip_smoke.py`` phase 4): K3's root-only
gather of 4 x 16 Mi float32 into one 256 MiB output, K3's all-rank
allgather of 4 x 4 Mi into 4 x 16 Mi, K4's combine of 64 Mi float32, row
11's scatter of a 4 x 16 Mi float32 operand into 4 outputs and row 13's
put of 4 x 16 Mi float32 with + 1.0.  For each: the port's kernel
(through its wrapper), the library call ``chip_smoke.py`` sets beside
it, and the variants of ``scripts/tile_variants.cu`` (the grid-stride
pattern each kernel had before the tile core, one tile a warp at U = 1,
2, 4 (and 8) chunks, PyTorch's elementwise shape for the combine, and
Hopper's 1-D bulk copy through shared memory for the gather at four
stage geometries).  Every variant's result is held
against the library call's first.

Then row 14's window of 8 allreduces of 1 Mi float32 a rank at P = 4:
the port's sequencer (its wrapper), the library call, the parent's
scalar grid-stride kernel, and the port's kernel at U = 1, 2 and 4
chunks a tile (the port's: U = 4); and row 7 at 32 Mi float32, in the Pallas tier's
segments of 65,536 (the wrapper: a cluster of 8 CTAs holding the
segment in shared memory filled by ``cp.async.bulk``; the same with
persistent clusters holding two segments; the parent's two-read kernel; the segment held in registers by a
cluster of CTAs x threads x elements a thread, 8 x 512 x 16 with one
cluster a segment and persistent clusters that load the next segment
into a second register set first, 4 x 512 x 32 and 8 x 256 x 32
persistent) and
in the wire's segments of 256 (the wrapper at seeds 0 and 9, the
parent's).  Each is held against the port's kernel (row 14, which
``chip_smoke.py`` holds against ``sequencer_plain``) or against
``quantize_plain`` (row 7) first, bit for bit.  Then every variant is
timed by device time alone (``chip_smoke.device_ms``, 20 launches) in
three rounds, the order reversed each round.  Prints one line a variant
(the median, its share of the bound, every round) and, last, one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(nvcc_flags, nvcc, out_dir) -> str:
    """Compile ``scripts/tile_variants.cu`` into ``out_dir``; returns the
    library's path."""
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libtile_variants.so")
    proc = subprocess.run(
        [nvcc, *nvcc_flags, "-o", lib,
         os.path.join(ROOT, "scripts", "tile_variants.cu")],
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from accl_tpu_torch.ops import cuda as kc
    from accl_tpu_torch.ops.cuda import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kc.build_all()
    lib = ctypes.CDLL(build(_build.NVCC_FLAGS, _build.nvcc(),
                            str(_build.BUILD_DIR)))
    PTR, LL, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tv_gather.argtypes = (PTR, PTR, INT, LL, INT, PTR)
    lib.tv_gather_bulk.argtypes = (PTR, PTR, INT, LL, INT, INT, INT, PTR)
    lib.tv_combine.argtypes = (PTR, PTR, PTR, LL, INT, PTR)
    lib.tv_allgather.argtypes = (PTR, PTR, INT, LL, INT, PTR)
    lib.tv_scatter.argtypes = (PTR, PTR, INT, LL, INT, PTR)
    lib.tv_put.argtypes = (PTR, PTR, INT, INT, LL, ctypes.c_float, INT,
                           PTR)
    lib.accl_error_string.restype = ctypes.c_char_p

    def run(rc):
        if rc:
            raise RuntimeError(lib.accl_error_string(rc).decode())

    def table(ts):
        return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

    def stream():
        return torch.cuda.current_stream().cuda_stream

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    P, n = cs.P_MAIN, cs.N_RANK
    xs = [torch.randn(n, generator=gen, device=dev) for _ in range(P)]
    gat = torch.empty(P * n, device=dev)
    xt = table(xs)
    root = [gat] + [None] * (P - 1)
    gather = {
        "kernel": lambda: kc.ring_gather(xs, 0, out=root),
        "torch.cat(out=)": lambda: torch.cat(xs, out=gat),
        "parent": lambda: run(lib.tv_gather(xt, gat.data_ptr(), P, 4 * n, 0,
                                            stream())),
    }
    for u in (1, 2, 4, 8):
        gather[f"tile U={u}"] = (lambda u=u: run(lib.tv_gather(
            xt, gat.data_ptr(), P, 4 * n, u, stream())))
    for chunk, stages, per_sm in ((8192, 4, 4), (16384, 4, 2),
                                  (16384, 8, 1), (32768, 4, 1)):
        gather[f"bulk {chunk // 1024} KiB x {stages}, {per_sm}/SM"] = (
            lambda c=chunk, s=stages, b=per_sm: run(lib.tv_gather_bulk(
                xt, gat.data_ptr(), P, 4 * n, c, s, b, stream())))

    blocks = [x[: n // P] for x in xs]
    outs = [torch.empty(n, device=dev) for _ in range(P)]
    bt, ot = table(blocks), table(outs)
    allgather = {
        "kernel": lambda: kc.ring_allgather(blocks, out=outs),
        "P x torch.cat(out=)": lambda: [torch.cat(blocks, out=o)
                                        for o in outs],
        "parent": lambda: run(lib.tv_allgather(bt, ot, P, n // P * 4, 0,
                                               stream())),
    }
    for u in (1, 2, 4):
        allgather[f"tile U={u}"] = (lambda u=u: run(lib.tv_allgather(
            bt, ot, P, n // P * 4, u, stream())))

    m = cs.N_COMBINE
    a = torch.randn(m, generator=gen, device=dev)
    b = torch.randn(m, generator=gen, device=dev)
    c = torch.empty_like(a)
    combine = {
        "kernel": lambda: kc.combine(a, b, 0, out=c),
        "torch.add(out=)": lambda: torch.add(a, b, out=c),
        "parent": lambda: run(lib.tv_combine(a.data_ptr(), b.data_ptr(),
                                             c.data_ptr(), m, 0, stream())),
    }
    for u in (1, 2, 4, 8):
        combine[f"tile U={u}"] = (lambda u=u: run(lib.tv_combine(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, u, stream())))
    for u in (1, 4):
        combine[f"PyTorch's shape, U={u}"] = (lambda u=u: run(lib.tv_combine(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, 100 + u, stream())))

    big = torch.randn(P * n, generator=gen, device=dev)
    sc_out = [torch.empty(n, device=dev) for _ in range(P)]
    sct = table(sc_out)
    scatter = {
        "kernel": lambda: kc.ring_scatter([big] * P, 0, out=sc_out),
        "4 x copy_": lambda: [o.copy_(s) for o, s in
                              zip(sc_out, big.chunk(P))],
        "parent": lambda: run(lib.tv_scatter(big.data_ptr(), sct, P, 4 * n,
                                             0, stream())),
    }
    for u in (1, 2, 4):
        scatter[f"tile U={u}"] = (lambda u=u: run(lib.tv_scatter(
            big.data_ptr(), sct, P, 4 * n, u, stream())))

    put_out = [torch.empty(n, device=dev) for _ in range(P)]
    pit, pot = table(xs), table(put_out)
    add = kc.Add(1.0)
    put = {
        "kernel": lambda: kc.fused_shift(xs, 1, add, out=put_out),
        "4 x torch.add(out=)": lambda: [
            torch.add(x, 1.0, out=put_out[(r + 1) % P])
            for r, x in enumerate(xs)],
        "parent": lambda: run(lib.tv_put(pit, pot, P, 1, n, 1.0, 0,
                                         stream())),
    }
    for u in (1, 2, 4):
        put[f"tile U={u}"] = (lambda u=u: run(lib.tv_put(
            pit, pot, P, 1, n, 1.0, u, stream())))

    f4 = 4
    groups = {
        "ring_gather": (gather, [gat], 2 * P * n * f4),
        "ring_allgather": (allgather, outs, (P + P * P) * (n // P) * f4),
        "combine": (combine, [c], 3 * m * f4),
        "ring_scatter": (scatter, sc_out, 2 * P * n * f4),
        "fused_shift": (put, put_out, 2 * P * n * f4),
    }
    for name, (variants, results, _) in groups.items():
        fns = list(variants.values())
        fns[1]()  # the library call's result is the reference
        torch.cuda.synchronize()
        want = [r.clone() for r in results]
        for label, fn in variants.items():
            for r in results:
                r.zero_()
            fn()
            torch.cuda.synchronize()
            if not all(torch.equal(r, w) for r, w in zip(results, want)):
                raise RuntimeError(f"{name} {label}: wrong result")
        del want

    groups.update(row14_and_row7(lib, run, stream, dev, gen))

    report = {}
    for name, (variants, _, nbytes) in groups.items():
        bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        rounds = {label: [] for label in variants}
        order = list(variants)
        for k in range(3):
            for label in (order if k % 2 == 0 else order[::-1]):
                rounds[label].append(cs.device_ms(variants[label], iters=20,
                                                  warmup=3))
        rows = {}
        for label, times in rounds.items():
            med = statistics.median(times)
            rows[label] = {"device_ms": med, "of_bound": bound_ms / med,
                           "rounds": times}
            print(f"{name:15s} {label:28s} device_ms={med:.4f} "
                  f"({bound_ms / med:.3f} of {bound_ms:.4f}) "
                  f"rounds={[round(t, 4) for t in times]}", flush=True)
        report[name] = {"bound_ms": bound_ms, "variants": rows}
    print(json.dumps({"tile_variants": {"card": card, **report}}))
    return 0


def row14_and_row7(lib, run, stream, dev, gen) -> dict:
    """Row 14's and row 7's variants, each held against its reference
    here; returns their groups (variants, results, bytes) for the timing
    rounds."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from accl_tpu_torch.cmdring import WindowShape, encode_slot
    from accl_tpu_torch.constants import CmdOpcode as Op
    from accl_tpu_torch.ops.cuda import cmdring as kseq
    from accl_tpu_torch.ops.cuda import compression as kcomp

    PTR, LL, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tv_sequencer_parent.argtypes = (PTR, PTR, PTR, PTR, INT, INT, PTR,
                                        PTR)
    lib.tv_sequencer.argtypes = (PTR, PTR, INT, PTR)
    lib.tv_quantize_parent.argtypes = (PTR, PTR, INT, LL, LL, LL, LL, PTR,
                                       PTR, PTR)
    lib.tv_quantize_cluster.argtypes = (PTR, PTR, INT, LL, LL, LL, LL, PTR,
                                        PTR, INT, INT, INT, INT, PTR)
    lib.tv_quantize_persistent.argtypes = (PTR, PTR, INT, LL, LL, LL, LL,
                                           PTR, PTR, PTR)

    P, N, S = cs.P_MAIN, cs.SEQ_N, 8
    xs = [[torch.randn(N, generator=gen, device=dev) for _ in range(P)]
          for _ in range(S)]
    outs = [[torch.empty(N, device=dev) for _ in range(P)] for _ in range(S)]
    slots = np.stack([encode_slot(i, Op.ALLREDUCE, N) for i in range(S)])
    shape = WindowShape(S, (N,) * S, (N,) * S, (None,) * S, torch.float32)
    win = (slots, xs, outs, shape)
    flat_in = [t.data_ptr() for row in xs for t in row]
    flat_out = [t.data_ptr() for row in outs for t in row]
    desc = kseq.pack_window(kseq._words(slots), shape, P, [False] * S,
                            flat_in, flat_out).reshape(1).view(np.int32)
    status = torch.empty((S, 2), dtype=torch.int32, device=dev)
    ins = (ctypes.c_void_p * (S * P))(*flat_in)
    ous = (ctypes.c_void_p * (S * P))(*flat_out)
    cols = (ctypes.c_longlong * S)(*([N] * S))
    fops = (ctypes.c_int * S)(*([0] * S))
    word = torch.zeros(1, dtype=torch.int32, device=dev)

    def library():
        for row_x, row_o in zip(xs, outs):
            acc = torch.stack(row_x).sum(0)
            for o in row_o:
                o.copy_(acc)

    seq = {
        "kernel": lambda: kseq.sequencer(*win),
        "library": library,
        "parent": lambda: run(lib.tv_sequencer_parent(
            ins, ous, cols, fops, S, P, word.data_ptr(), stream())),
    }
    for u in (1, 2, 4):  # the port's: U = 4
        seq[f"U={u}"] = (lambda u=u: run(lib.tv_sequencer(
            desc.ctypes.data, status.data_ptr(), u, stream())))
    results = [o for row in outs for o in row]
    seq["kernel"]()
    torch.cuda.synchronize()
    want = [r.clone() for r in results]
    ref = [[torch.empty(N, device=dev) for _ in range(P)] for _ in range(S)]
    kseq.sequencer_plain(slots, xs, ref, shape)
    if not all(torch.equal(a, b) for a, b in zip(
            want, [o for row in ref for o in row])):
        raise RuntimeError("sequencer: the kernel differs from "
                           "sequencer_plain")
    for label, fn in seq.items():
        if label == "library":  # another fold order: timed, not held
            continue
        for r in results:
            r.zero_()
        fn()
        torch.cuda.synchronize()
        if not all(torch.equal(r, w) for r, w in zip(results, want)):
            raise RuntimeError(f"sequencer {label}: wrong result")
    del want, ref

    n = cs.N_COMP
    x = torch.randn(n, generator=gen, device=dev)
    rows, br, nblk = kcomp.tiles(n)
    L = br * 128
    xt = (ctypes.c_void_p * 1)(x.data_ptr())
    seeds = (ctypes.c_uint32 * 1)(0)
    v = torch.empty(rows * 128, dtype=torch.int8, device=dev)
    sc = torch.empty(nblk, dtype=torch.float32, device=dev)
    wv = torch.empty(n, dtype=torch.int8, device=dev)
    ws = torch.empty(n // 256, dtype=torch.float32, device=dev)

    def tv(fn, *extra, seg=L, nseg=nblk, out_len=rows * 128, q=v, s=sc):
        return lambda: run(fn(xt, seeds, 1, n, seg, nseg, out_len,
                              q.data_ptr(), s.data_ptr(), *extra, stream()))

    tiles = {
        "kernel": lambda: kcomp.quantize_rows([x], [0], L, rows * 128),
        "parent": tv(lib.tv_quantize_parent),
        "shared memory, persistent, 2 stages": tv(
            lib.tv_quantize_persistent),
        "registers 8 x 512 x 16, persistent": tv(
            lib.tv_quantize_cluster, 8, 16, 512, 1),
        "registers 8 x 512 x 16": tv(lib.tv_quantize_cluster, 8, 16, 512, 0),
        "registers 4 x 512 x 32, persistent": tv(
            lib.tv_quantize_cluster, 4, 32, 512, 1),
        "registers 8 x 256 x 32, persistent": tv(
            lib.tv_quantize_cluster, 8, 32, 256, 1),
    }
    wire = {
        "kernel": lambda: kcomp.quantize_rows([x], [0], 256),
        "kernel, seed 9": lambda: kcomp.quantize_rows([x], [9], 256),
        "parent": tv(lib.tv_quantize_parent, seg=256, nseg=n // 256,
                     out_len=n, q=wv, s=ws),
    }
    for label, variants, seg, q, s_, out_len in (
            ("quantize_tiles", tiles, L, v, sc, rows * 128),
            ("quantize_wire", wire, 256, wv, ws, n)):
        pv, ps = kcomp.quantize_plain(x, 0, seg, out_len)
        for name, fn in variants.items():
            seed = 9 if "seed 9" in name else 0
            if seed:
                pv9, ps9 = kcomp.quantize_plain(x, 9, seg, out_len)
            q.zero_()
            got = fn()
            torch.cuda.synchronize()
            gv, gs = (got[0][0], got[1][0]) if got is not None else (q, s_)
            wv_, ws_ = (pv9, ps9) if seed else (pv, ps)
            if not (torch.equal(gv, wv_) and torch.equal(gs, ws_)):
                raise RuntimeError(f"{label} {name}: differs from "
                                   f"quantize_plain")
    f4 = 4
    return {
        "sequencer": (seq, results, 2 * S * P * N * f4),
        "quantize_tiles": (tiles, [v, sc], 5 * n + 4 * nblk),
        "quantize_wire": (wire, [wv, ws], 5 * n + 4 * (n // 256)),
    }


if __name__ == "__main__":
    sys.exit(main())
