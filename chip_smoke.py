#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``accl_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi), build every
   kernel from ``accl_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes — float results must match EXACTLY (same operation
   order, same round-to-nearest-even; NaN positions must agree);
3. the main path: ``cuda_group(4)``, one thread per rank, 16M float32
   (64 MiB) per rank — three ``pallas_ring`` allreduces (4 segments), one
   with a bfloat16 wire, one ``pallas_ring_bidir``, one ``xla``, a facade
   ``combine``, and the kernel tier's ring reduce-scatter and allgather on
   the ranks' buffers — each result checked against a float64 numpy
   reference; every kernel's launch counter is zeroed just before and read
   just after, and each must have launched;
4. time each kernel at those shapes beside its bound, its plain version
   and one PyTorch library call computing the same function;
5. time the facade allreduce end to end (host clock around each
   synchronous call on rank 0's thread, rendezvous included) for the
   ``xla``, ``pallas_ring`` and ``pallas_ring_bidir`` registers at 256 KiB,
   4 MiB and 64 MiB per rank: p50 latency and bus bandwidth
   (bytes per rank x 2(P-1)/P over the p50).

The second-to-last line is the ``{"kernels": [...]}`` JSON object, the last
``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and float32 operations/s
# outside the tensor cores (the kernels' folds are scalar float32 adds)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
N_RANK = 16 * 1024 * 1024  # elements per rank on the main path (64 MiB f32)
N_COMBINE = 64 * 1024 * 1024  # combine operand elements (256 MB f32)
P_MAIN = 4
SEED = 1234


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def compare(name: str, got, want) -> float:
    """Exact agreement (NaN where NaN); returns the max abs difference."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: {got.dtype}{tuple(got.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    same = got == want
    if got.is_floating_point():
        same |= torch.isnan(got) & torch.isnan(want)
    if not bool(same.all()):
        bad = int((~same).sum())
        fail(f"{name}: {bad} elements differ from the plain version")
    if not got.is_floating_point():
        return 0.0
    d = (got.double() - want.double()).abs()
    d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    return float(d.max()) if d.numel() else 0.0


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def facade_latency(sizes, algos, iters: int = 20) -> list:
    """p50 and p90 of the facade allreduce per (register, elements per
    rank), and the p50 of the gang's launch time (the host time from the
    last rank's arrival to every request's completion, kernel launch
    included, device time not).  Every (size, register) pair runs twice
    over; only the second pass is kept, so no pair pays the first pass's
    warm-up."""
    import numpy as np

    import accl_tpu_torch as at

    samples = {}
    errors = []

    def rank_main(a, r):
        try:
            a.set_tuning("ring_segments", 4)
            bufs = {n: (a.create_buffer(n, np.float32),
                        a.create_buffer(n, np.float32)) for n in sizes}
            for _pass in range(2):
                for n, (s, d) in bufs.items():
                    for algo in algos:
                        a.set_tuning("allreduce_algorithm", algo)
                        times, launch = [], []
                        for _ in range(iters):
                            t = time.perf_counter()
                            req = a.allreduce(s, d)
                            times.append(time.perf_counter() - t)
                            launch.append(req.get_duration_ns() * 1e-9)
                        if r == 0:
                            samples[(algo, n)] = (times, launch)
        except BaseException as e:  # reported by the main thread
            errors.append(f"rank {r}: {type(e).__name__}: {e}")

    group = at.cuda_group(P_MAIN)
    threads = [threading.Thread(target=rank_main, args=(group[r], r))
               for r in range(P_MAIN)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    for a in group:
        a.deinit()
    if errors or any(t.is_alive() for t in threads):
        fail(f"facade timing failed: {errors or 'a rank thread hung'}")
    rows = []
    for (algo, n), (times, launch) in samples.items():
        p50 = float(np.median(times))
        nbytes = 4 * n
        rows.append({
            "algo": algo, "bytes_per_rank": nbytes, "p50_ms": p50 * 1e3,
            "p90_ms": float(np.percentile(times, 90)) * 1e3,
            "launch_p50_ms": float(np.median(launch)) * 1e3,
            "busbw_GBps": nbytes * 2 * (P_MAIN - 1) / P_MAIN / p50 / 1e9,
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    import accl_tpu_torch as at
    from accl_tpu_torch.ops import cuda as kc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    t0 = time.time()
    built = kc.build_all()
    print(f"built {built} in {time.time() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err = {k: 0.0 for k in kc.KERNELS}
    F32, BF16, F16, I32 = (torch.float32, torch.bfloat16, torch.float16,
                           torch.int32)
    SUM, MAX = at.ReduceFunction.SUM, at.ReduceFunction.MAX

    def rand(n, dtype):
        if dtype == I32:
            return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                 device=dev, dtype=I32)
        return torch.randn(n, generator=gen, device=dev).to(dtype)

    # -- phase 2: every kernel against its plain version ---------------------
    t0 = time.time()
    for dtype in (F32, BF16, F16, I32):
        a, b = rand(N_COMBINE, dtype), rand(N_COMBINE, dtype)
        if dtype.is_floating_point:
            a[::997] = float("nan")
            b[5::1009] = float("nan")
        for fn in (SUM, MAX):
            tag = f"combine {dtype} {fn.name}"
            err["combine"] = max(err["combine"], compare(
                tag, kc.combine(a, b, fn), kc.combine_plain(a, b, fn)))
            acc = a.clone()
            kc.combine(acc, b, fn, accumulate=True)
            err["combine"] = max(err["combine"], compare(
                tag + " accumulate", acc, kc.combine_plain(a, b, fn)))
        torch.cuda.synchronize()
    a, b = rand(N_COMBINE, F32), rand(N_COMBINE, F32)
    for out_dtype in (BF16, F16):
        err["combine"] = max(err["combine"], compare(
            f"combine f32->{out_dtype}",
            kc.combine(a, b, SUM, out_dtype),
            kc.combine_plain(a, b, SUM, out_dtype)))
    del a, b, acc
    torch.cuda.synchronize()

    cases = [
        (P, S, bidir, wire, SUM, F32, N_RANK)
        for P in (2, 4, 8) for S in (1, 4) for bidir in (False, True)
        for wire in (None, BF16, F16)
    ]
    cases += [
        (4, 4, False, None, MAX, F32, N_RANK),
        (4, 2, True, BF16, MAX, F32, N_RANK),
        (4, 4, False, F16, SUM, BF16, N_RANK),
        (4, 1, True, None, SUM, I32, N_RANK),
        (4, 4, False, None, MAX, I32, N_RANK),
        (3, 4, True, BF16, SUM, F32, 1_000_003),  # ragged: scalar path
    ]
    for P, S, bidir, wire, fn, dtype, n in cases:
        xs = [rand(n, dtype) for _ in range(P)]
        got = kc.ring_allreduce(xs, fn, S, bidirectional=bidir,
                                wire_dtype=wire)
        want = kc.ring_allreduce_plain(xs, fn, S, bidirectional=bidir,
                                       wire_dtype=wire)
        for r in range(P):
            err["ring_allreduce"] = max(err["ring_allreduce"], compare(
                f"ring_allreduce P={P} S={S} bidir={bidir} wire={wire} "
                f"{fn.name} {dtype} n={n} rank {r}", got[r], want[r]))
        torch.cuda.synchronize()
    for fn, dtype, n, S in ((SUM, F32, N_RANK, 4), (MAX, F32, N_RANK, 1),
                            (SUM, BF16, N_RANK, 2), (SUM, F32, 999_999, 4)):
        xs = [rand(n, dtype) for _ in range(P_MAIN)]
        got = kc.ring_reduce_scatter(xs, fn, S)
        want = kc.ring_reduce_scatter_plain(xs, fn, S)
        for r in range(P_MAIN):
            err["ring_reduce_scatter"] = max(
                err["ring_reduce_scatter"],
                compare(f"ring_reduce_scatter {fn.name} {dtype} n={n} "
                        f"rank {r}", got[r], want[r]))
    for dtype, n in ((F32, N_RANK // P_MAIN), (BF16, N_RANK // P_MAIN),
                     (F32, 1_000_001)):
        xs = [rand(n, dtype) for _ in range(P_MAIN)]
        got = kc.ring_allgather(xs)
        want = kc.ring_allgather_plain(xs)
        for r in range(P_MAIN):
            err["ring_allgather"] = max(err["ring_allgather"], compare(
                f"ring_allgather {dtype} n={n} rank {r}", got[r], want[r]))
    del xs, got, want
    torch.cuda.synchronize()
    print(f"kernels agree with their plain versions exactly "
          f"({time.time() - t0:.1f} s)", flush=True)

    # -- phase 3: the main path ----------------------------------------------
    t0 = time.time()
    rng = np.random.default_rng(SEED)
    data = rng.standard_normal((P_MAIN, N_RANK), dtype=np.float32)
    other = rng.standard_normal((P_MAIN, N_RANK), dtype=np.float32)
    exact = data.astype(np.float64).sum(0)
    results = {}
    errors = []

    def rank_main(a, r):
        try:
            s = a.create_buffer_from(data[r])
            d = a.create_buffer(N_RANK, np.float32)
            o = a.create_buffer_from(other[r])
            c = a.create_buffer(N_RANK, np.float32)
            outs = []

            def allreduce(**kw):
                a.allreduce(s, d, **kw)
                d.sync_from_device()
                outs.append(d.data.numpy().copy())

            a.set_tuning("allreduce_algorithm", "pallas_ring")
            a.set_tuning("ring_segments", 4)
            for _ in range(3):
                allreduce()
            allreduce(compress_dtype="bfloat16")
            a.set_tuning("allreduce_algorithm", "pallas_ring_bidir")
            allreduce()
            a.set_tuning("allreduce_algorithm", "xla")
            allreduce()
            a.combine(SUM, s, o, c)
            c.sync_from_device()
            outs.append(c.data.numpy().copy())
            results[r] = (outs, s, o)
        except BaseException as e:  # reported by the main thread
            errors.append(f"rank {r}: {type(e).__name__}: {e}")

    for k in kc.KERNELS.values():
        k.launches.reset()
    group = at.cuda_group(P_MAIN)
    threads = [threading.Thread(target=rank_main, args=(group[r], r))
               for r in range(P_MAIN)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        fail(f"main path failed: {errors or 'a rank thread hung'}")
    # the kernel tier's ring reduce-scatter and allgather on the same
    # per-rank buffers
    srcs = [results[r][1].tensor for r in range(P_MAIN)]
    rs = kc.ring_reduce_scatter(srcs, SUM, 4)
    ag = kc.ring_allgather(rs)
    torch.cuda.synchronize()
    launches = {k: f.launches.count for k, f in kc.KERNELS.items()}
    for a in group:
        a.deinit()

    names = ["pallas_ring #1", "pallas_ring #2", "pallas_ring #3",
             "pallas_ring bf16 wire", "pallas_ring_bidir", "xla"]
    # float32 ring sums of 4 normals: a few ulp of the running sums; the
    # bfloat16 wire rounds each hop's partial to 8 mantissa bits
    tol = {"pallas_ring bf16 wire": (3e-2, 3e-2)}
    for r in range(P_MAIN):
        outs = results[r][0]
        for name, got in zip(names, outs):
            rtol, atol = tol.get(name, (1e-5, 1e-5))
            if not np.allclose(got, exact, rtol=rtol, atol=atol):
                fail(f"allreduce {name} rank {r}: max abs err "
                     f"{np.abs(got - exact).max()}")
        if not np.array_equal(outs[-1], data[r] + other[r]):
            fail(f"combine rank {r} differs from numpy")
    for r in range(P_MAIN):
        blk = rs[r].numel()
        lo, hi = r * blk, min((r + 1) * blk, N_RANK)
        if not np.allclose(rs[r][:hi - lo].cpu().numpy(), exact[lo:hi],
                           rtol=1e-5, atol=1e-5):
            fail(f"ring_reduce_scatter rank {r} off the reference")
        if not torch.equal(ag[r], torch.cat(rs)):
            fail(f"ring_allgather rank {r} differs from the blocks")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path never launched {missing}: {launches}")
    print(f"main path ok ({time.time() - t0:.1f} s): launches {launches}",
          flush=True)

    # -- phase 4: timing at the main path's shapes ---------------------------
    xs = [rand(N_RANK, F32) for _ in range(P_MAIN)]
    outs = [torch.empty_like(x) for x in xs]
    gathered = [torch.empty(N_RANK, device=dev) for _ in range(P_MAIN)]
    blocks = [x[: N_RANK // P_MAIN] for x in xs]
    a, b = rand(N_COMBINE, F32), rand(N_COMBINE, F32)
    c = torch.empty_like(a)
    f4 = 4  # bytes per float32
    timing = {
        "ring_allreduce": dict(
            ms=time_ms(lambda: kc.ring_allreduce(xs, SUM, 4, out=outs)),
            plain_ms=time_ms(lambda: kc.ring_allreduce_plain(xs, SUM, 4)),
            library_ms=time_ms(lambda: torch.stack(xs).sum(0)),
            bytes=2 * P_MAIN * N_RANK * f4,
            ops=(P_MAIN - 1) * N_RANK,
        ),
        "ring_reduce_scatter": dict(
            ms=time_ms(lambda: kc.ring_reduce_scatter(xs, SUM, 4)),
            plain_ms=time_ms(lambda: kc.ring_reduce_scatter_plain(xs, SUM, 4)),
            library_ms=time_ms(lambda: torch.stack(xs).sum(0)),
            bytes=(P_MAIN + 1) * N_RANK * f4,
            ops=(P_MAIN - 1) * N_RANK,
        ),
        "ring_allgather": dict(
            ms=time_ms(lambda: kc.ring_allgather(blocks, out=gathered)),
            plain_ms=time_ms(lambda: kc.ring_allgather_plain(blocks)),
            library_ms=time_ms(lambda: torch.cat(blocks)),
            bytes=(P_MAIN + P_MAIN * P_MAIN) * (N_RANK // P_MAIN) * f4,
            ops=0,
        ),
        "combine": dict(
            ms=time_ms(lambda: kc.combine(a, b, SUM, out=c)),
            plain_ms=time_ms(lambda: kc.combine_plain(a, b, SUM)),
            library_ms=time_ms(lambda: torch.add(a, b, out=c)),
            bytes=3 * N_COMBINE * f4,
            ops=N_COMBINE,
        ),
    }
    meta = {
        "ring_allreduce": ("accl_tpu_torch/csrc/ring.cu",
                           "accl_tpu/ops/pallas/ring.py:123"),
        "ring_reduce_scatter": ("accl_tpu_torch/csrc/ring.cu",
                                "accl_tpu/ops/pallas/ring.py:224"),
        "ring_allgather": ("accl_tpu_torch/csrc/ring.cu",
                           "accl_tpu/ops/pallas/ring.py:288"),
        "combine": ("accl_tpu_torch/csrc/combine.cu",
                    "accl_tpu/ops/pallas/combine.py:40"),
    }
    kernels = []
    for name in kc.KERNELS:
        t = timing[name]
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["ops"] / F32_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t["library_ms"],
        })
    for k in kernels:
        print(f"{k['name']}: kernel_ms={k['ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} plain_ms={k['plain_ms']:.4f} "
              f"library_ms={k['library_ms']:.4f}")
    del xs, outs, gathered, blocks, a, b, c
    torch.cuda.synchronize()

    # -- phase 5: the facade allreduce end to end ----------------------------
    facade = facade_latency([64 * 1024, 1024 * 1024, N_RANK],
                            ["xla", "pallas_ring", "pallas_ring_bidir"])
    print(json.dumps({"facade_allreduce": facade}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
