"""Time the warm 256 KiB allreduce of the port's gang on one GPU, for a
comparison of two trees of the package on the same card (one with the
in-flight window and one without; one with the gang's named ranges and
one without).

    PYTHONSAFEPATH=1 PYTHONPATH=<tree> python3 scripts/window_cost.py

``PYTHONPATH`` picks the tree whose ``accl_tpu_torch`` is timed (the
script imports nothing else of the repo, and builds that tree's ring
kernels).  On ``cuda_group(4)``, every rank on its own thread, the
``pallas_ring`` allreduce of 256 KiB float32 a rank (4 segments), warmed
three times, then ``--rounds`` rounds of 30 synchronous calls: rank 0's
call time on the host clock and the gang's duration
(``Request.get_duration_ns``).  Prints one JSON object: the card's name
and power limit, the tree's package path, its window depth (None without
one), each round's call p50 and the p50 / p90 over every call.  Compare
two trees only within one run of the machine, in turns (parent, tree,
tree, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--calls", type=int, default=30)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("window_cost: no CUDA device available", file=sys.stderr)
        return 2
    import accl_tpu_torch as at
    from accl_tpu_torch.ops import cuda as kc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kc.build_all(["ring"])
    P, n = 4, 64 * 1024
    g = at.cuda_group(P)
    window = getattr(g[0].engine.gang, "window", None)
    calls, gang, rounds = [], [], []
    try:
        for a in g:
            a.set_tuning("allreduce_algorithm", "pallas_ring")
            a.set_tuning("ring_segments", 4)
        bufs = [(a.create_buffer_from(np.full(n, r + 1.0, np.float32)),
                 a.create_buffer(n, np.float32)) for r, a in enumerate(g)]

        def run(fn):
            errors = []

            def runner(a, r):
                try:
                    fn(a, r)
                except BaseException as e:  # reported below
                    errors.append(f"rank {r}: {type(e).__name__}: {e}")

            threads = [threading.Thread(target=runner, args=(a, r))
                       for r, a in enumerate(g)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(errors or "a rank thread hung")

        for _ in range(3):
            run(lambda a, r: a.allreduce(*bufs[r]))

        def timed(a, r):
            mine = []
            for _ in range(args.calls):
                t = time.perf_counter()
                req = a.allreduce(*bufs[r])
                if r == 0:
                    mine.append(time.perf_counter() - t)
                    gang.append(req.get_duration_ns() * 1e-9)
            if r == 0:
                calls.extend(mine)
                rounds.append(float(np.median(mine)) * 1e3)

        for _ in range(args.rounds):
            run(timed)
        got = bufs[0][1].device_array().cpu().numpy()
        if not np.array_equal(got, np.full(n, P * (P + 1) / 2, np.float32)):
            raise RuntimeError("the allreduce's sum differs")
    finally:
        for a in g:
            a.deinit()

    def pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3

    print(json.dumps({"window_cost": {
        "card": card, "package": at.__file__,
        "inflight_window": None if window is None else window.depth,
        "bytes_per_rank": 4 * n, "calls_per_round": args.calls,
        "rounds_call_p50_ms": rounds,
        "call_p50_ms": pct(calls, 50), "call_p90_ms": pct(calls, 90),
        "gang_p50_ms": pct(gang, 50), "gang_p90_ms": pct(gang, 90),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
