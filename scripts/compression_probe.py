"""A short first call for the compressed wire's kernels on one GPU.

    python3 scripts/compression_probe.py

Builds every kernel (one nvcc per source), prints ptxas's register and
spill lines for ``csrc/compression.cu``, then runs the compression
phases of ``chip_smoke.py`` alone: rows 5-8 against their plain versions
(phase 2's ``check_compression``), the ring allreduce's fp8 lanes and raw
int8 cast against its plain hop schedule, the compressed facade path and
bench.py's convergence leg (phase 3f), and rows 5-8's times beside their
bounds (phase 4).  Each part reports its failure and the next one runs,
so one call shows every fault; it exits non-zero if any part failed.
A quicker probe than the whole of ``chip_smoke.py`` when only the
compression kernels changed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("compression_probe: no CUDA device available", file=sys.stderr)
        return 2
    import accl_tpu_torch as at
    import chip_smoke as cs
    from accl_tpu_torch.ops import cuda as kc
    from accl_tpu_torch.ops.cuda import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    t0 = time.time()
    print("built", kc.build_all(), f"{time.time() - t0:.1f} s", flush=True)
    print("\n".join(line for line in _build.build_log("compression")
                    .splitlines() if "registers" in line or "spill" in line))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    err = {k: 0.0 for k in kc.KERNELS}
    failed = []

    def part(name, fn):
        t = time.time()
        try:
            out = fn()
            print(f"{name} ok ({time.time() - t:.1f} s)", out or "",
                  flush=True)
        except Exception as e:  # report, then run the next part
            failed.append(name)
            print(f"{name} FAILED: {type(e).__name__}: {str(e)[:2000]}",
                  flush=True)

    part("rows 5-8 vs plain", lambda: cs.check_compression(kc, err, gen, dev))
    SUM, MAX = at.ReduceFunction.SUM, at.ReduceFunction.MAX
    F32, BF16 = torch.float32, torch.bfloat16
    E4M3, E5M2, I8 = torch.float8_e4m3fn, torch.float8_e5m2, torch.int8
    ring_cases = [(4, 4, b, w, SUM, F32, cs.N_RANK)
                  for w in (E4M3, E5M2, I8) for b in (False, True)]
    ring_cases += [(4, 2, False, E5M2, SUM, BF16, cs.N_RANK),
                   (4, 1, True, E4M3, MAX, F32, cs.N_RANK),
                   (3, 4, True, I8, SUM, F32, 1_000_003)]

    def ring():
        for P, S, bidir, wire, fn, dtype, n in ring_cases:
            xs = [torch.randn(n, generator=gen, device=dev).to(dtype)
                  for _ in range(P)]
            got = kc.ring_allreduce(xs, fn, S, bidirectional=bidir,
                                    wire_dtype=wire)
            want = kc.ring_allreduce_plain(xs, fn, S, bidirectional=bidir,
                                           wire_dtype=wire)
            for r in range(P):
                cs.compare(f"ring {wire} bidir={bidir} {dtype} rank {r}",
                           got[r], want[r])
        torch.cuda.synchronize()

    part("ring wire lanes vs plain", ring)
    part("compressed path", lambda: cs.compressed_main_path(kc))

    def leg():
        cs.reset_launches(kc)
        return cs.convergence_leg(), cs.read_launches(kc)

    part("convergence leg", leg)

    def timing():
        out = cs.time_compression(kc, dev)
        for name, t in out.items():
            b = cs.bound(t["bytes"], t["ops"])
            print(f"{name}: ms={t['ms']:.4f} bound_ms={b['bound_ms']:.4f} "
                  f"plain_ms={t['plain_ms']:.4f} library_ms="
                  f"{t['library_ms']}", {k: v for k, v in t.items()
                                         if k.startswith("wire_seg")})

    part("timing", timing)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
