"""Time row 14's fp8 / int8 instantiation (the LANES kernel of
``csrc/cmdring.cu``) on windows that split its cost, on one GPU.

    python3 scripts/lane_profile.py [--out FILE] [--rounds R]

Every window is 8 slots of allreduce at 1 Mi float32 a rank, P = 4, made
by ``chip_smoke.seq_window`` from phase 4's seed (NaNs every 997
elements), and differs from phase 4's lane windows (int8 and e4m3, slot
seeds from 12345) in one thing:

* ``int8`` / ``e4m3``: phase 4's two windows;
* ``e4m3 rne``, ``int8 rne``: slot seed 0 (round to nearest even: no
  counter hash per element);
* ``e5m2``, ``bf16 sr``: the other fp8 wire, and the 16-bit wire under a
  seed (the LANES kernel with the cheapest rounding);
* ``lanes no wire``: 9 slots, the first e4m3 and eight unwired: the
  LANES kernel's loads, folds and stores with no rounding (less one
  slot's e4m3 share);
* ``plain``: 8 unwired slots through the plain instantiation;
* ``int8 nop`` / ``e4m3 nop``: 8 NOP slots (each rank's operand copied
  to its result, nothing rounded) under an int8 and an e4m3 wire: their
  difference is the int8 scale phase where a window takes it.

Each window is first held against ``sequencer_plain`` (exactly), then
timed by device time alone (``chip_smoke.device_ms``, 20 launches) in
``R`` rounds, the order reversed each round.  Prints one line a window
(median, every round, the counters that show which form it took) and the
ptxas lines of the LANES kernels, then one JSON object with the card's
name and power limit, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def windows():
    """name -> (ops, wires, flags) for ``chip_smoke.seq_window``."""
    import torch

    from accl_tpu_torch.constants import CmdOpcode as Op

    AR, NOP = (Op.ALLREDUCE, 0, 0), (Op.NOP, 0, 0)
    I8, E4, E5, BF = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2,
                      torch.bfloat16)
    return {
        "int8": ([AR] * 8, [I8], 12345),
        "e4m3": ([AR] * 8, [E4], 12345),
        "e4m3 rne": ([AR] * 8, [E4], 0),
        "int8 rne": ([AR] * 8, [I8], 0),
        "e5m2": ([AR] * 8, [E5], 12345),
        "bf16 sr": ([AR] * 8, [BF], 12345),
        "lanes no wire": ([AR] * 9, [E4] + [None] * 8, 12345),
        "plain": ([AR] * 8, None, 0),
        "int8 nop": ([NOP] * 8, [I8], 12345),
        "e4m3 nop": ([NOP] * 8, [E4], 12345),
    }


def ptxas_lines(kc) -> list:
    """``[kernel, registers, stack bytes, spill-store bytes]`` of every
    LANES kernel in ``csrc/cmdring.cu``'s build log."""
    rows, entry = [], None
    for line in kc._build.build_log("cmdring").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = None
            for tag in ("22sequencer_lanes_kernel",
                        "23persistent_lanes_kernel"):
                if tag in m.group(1):
                    entry = [m.group(1), 0, 0, 0]
                    rows.append(entry)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and entry:
            entry[2:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            entry[1] = int(m.group(1))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lane_profile: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from accl_tpu_torch.ops import cuda as kc
    from accl_tpu_torch.ops.cuda import cmdring as kseq

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kc.build_all(["cmdring"])
    F32 = torch.float32
    wins, forms, failed = {}, {}, []
    for name, (ops, wires, flags) in windows().items():
        got = cs.seq_window(cs.P_MAIN, F32, ops, cs.SEQ_N, cs.SEED + 5,
                            wires=wires, flags=flags)
        want = cs.seq_window(cs.P_MAIN, F32, ops, cs.SEQ_N, cs.SEED + 5,
                             wires=wires, flags=flags)
        seg = getattr(kseq.sequencer_lanes, "segment_launches", None)
        before = (kseq.sequencer_lanes.launches.count,
                  seg.count if seg is not None else 0)
        try:
            kseq.sequencer(*got[:4])
            kseq.sequencer_plain(*want[:4])
            torch.cuda.synchronize()
            for i, (rg, rw) in enumerate(zip(got[2], want[2])):
                for o, w in zip(rg, rw):
                    cs.compare(f"lane_profile {name} slot {i}", o, w)
        except (RuntimeError, ValueError) as e:  # reported, not timed
            print(f"{name}: FAILED {e}", flush=True)
            failed.append(name)
            continue
        forms[name] = {
            "lanes": kseq.sequencer_lanes.launches.count - before[0],
            "segment": (seg.count if seg is not None else 0) - before[1]}
        del want
        wins[name] = got
    names = list(wins)
    times = {k: [] for k in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            w = wins[name]
            times[name].append(cs.device_ms(lambda: kseq.sequencer(*w[:4]),
                                            iters=20))
    rows = {}
    for name in names if args.rounds else ():
        med = statistics.median(times[name])
        rows[name] = {"device_ms": med, "rounds": times[name], **forms[name]}
        print(f"{name}: device_ms={med:.4f} rounds="
              f"{[round(t, 4) for t in times[name]]} launches {forms[name]}",
              flush=True)
    ptx = ptxas_lines(kc)
    for row in ptx:
        print(f"ptxas {row}", flush=True)
    result = {"lane_profile": {"card": card, "windows": rows,
                               "failed": failed, "ptxas": ptx}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
