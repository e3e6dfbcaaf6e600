"""Time the streaming tile core against the access patterns it was chosen
over, on one GPU.

    python3 scripts/tile_variants.py

At the main path's shapes (``chip_smoke.py`` phase 4): K3's root-only
gather of 4 x 16 Mi float32 into one 256 MiB output, K3's all-rank
allgather of 4 x 4 Mi into 4 x 16 Mi, and K4's combine of 64 Mi float32.
For each: the port's kernel (through its wrapper), the library call
``chip_smoke.py`` sets beside it, and the variants of
``scripts/tile_variants.cu`` (the parent tree's grid-stride pattern, one
tile a warp at U = 1, 2, 4 and 8 chunks, PyTorch's elementwise shape for
the combine, and Hopper's 1-D bulk copy through shared memory for the
gather at four stage geometries).  Every variant's result is held
against the library call's first; then each is timed by device time
alone (``chip_smoke.device_ms``, 20 launches) in three rounds, the order
reversed each round.  Prints one line a variant (the median, its share
of the bound, every round) and, last, one JSON object with the card's
name and power limit.
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

    f4 = 4
    groups = {
        "ring_gather": (gather, [gat], 2 * P * n * f4),
        "ring_allgather": (allgather, outs, (P + P * P) * (n // P) * f4),
        "combine": (combine, [c], 3 * m * f4),
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


if __name__ == "__main__":
    sys.exit(main())
