"""Split a window's time inside row 14's persistent run (``csrc/cmdring.cu``'s
``persistent_kernel`` / ``persistent_lanes_kernel``) by the card's own
clock, on one GPU.

    python3 scripts/run_profile.py [--out FILE] [--rounds R] [--windows W]

Builds ``csrc/cmdring.cu`` a second time with ``-DACCL_RUN_STAMPS`` (into
``csrc/build/``, beside the plain library): a run of that build writes
``%globaltimer`` stamps a window to device memory, read once it returned.
Then, for windows of 8 x allreduce at P = 4 (``chip_smoke.py``'s data:
plain at 1 Mi float32 from ``SEED + 6``; ``tiny``, the same at 4,096
elements, a window's cost in a run less its items; int8 and e4m3 at 1 Mi,
seeded from 12345, from ``SEED + 5``), ``R`` rounds of ``W`` windows
posted into one run of the stamped build (the first post, the launch, the
rest), each window split by the run's clock into

* (a) ``fetch``: from the doorbell seen to the window staged in device
  memory by the fetching warp (during the window before it, when it was
  posted in time: ``fetched ahead``);
* (b) ``publish``: from the later of that and the barrier that ended the
  window before it, to the last block's start of the window;
* (c) ``work``: from there to the last block's end of the window's items;
* (d) ``close``: from there to the release store of ``done`` (the
  closing barrier, the fence and the store);
* (e) ``idle``: from window k - 1's ``done`` to window k's doorbell seen
  (the run waiting for the host's post, and its poll);

and ``period``, window k's ``done`` less window k - 1's: a window's time
in the run.  Medians over windows 1..W-1 of every round.  Beside them, in
the same call: the host's time inside ``PersistentRun.post`` and its parts
(each function ``post`` calls, timed in rounds of their own); the device
time a window of a run of 64 windows all posted before its launch (CUDA
events around the launch), in the stamped and in the plain build; the wall
time a window of the plain build from before the run is built and from
its launch; the one-shot kernel's device time on the same window launched
as the wrapper launches it and cooperatively at a run's grid
(``accl_sequencer_grid``; the co-resident blocks, and fewer), each by
``chip_smoke.device_ms`` (20 launches).  Every run's results are held
against ``sequencer_plain`` first, bit for bit.  Prints one line a figure
and, last, one JSON object with the card's name and power limit, also
written to ``--out``.  Run it from two checkouts in one call to compare
commits.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# csrc/cmdring.cu's stamp indices (ST_*) and its kMaxRunWindows
ST_POLL, ST_SEEN, ST_STAGED, ST_COPY_MIN, ST_COPY_MAX, ST_WORK_MAX, \
    ST_CLOSED, ST_DONE, ST_GRID, ST_N = range(10)
MAX_RUN_WINDOWS = 128


def build_stamped():
    """Build ``csrc/cmdring.cu`` with the run stamps compiled in; returns
    the library (:func:`use` makes it the process's)."""
    import hashlib

    from accl_tpu_torch.ops.cuda import _build
    from accl_tpu_torch.ops.cuda import cmdring as kseq

    flags = [*_build.NVCC_FLAGS, "-DACCL_RUN_STAMPS"]
    src = _build.CSRC / "cmdring.cu"
    h = hashlib.sha256()
    for p in [src] + sorted(_build.CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    out = _build.BUILD_DIR / f"libcmdring_stamps-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_build.nvcc(), *flags, "-o", str(tmp),
                               str(src)], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    fn, restype, argtypes = _build.ERROR_STRING
    getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    for fn, argtypes in kseq.PROTOTYPES["cmdring"].items():
        getattr(lib, fn).restype = _build.INT
        getattr(lib, fn).argtypes = argtypes
    return lib


def use(lib) -> None:
    """Make ``lib`` the process's ``cmdring`` library."""
    from accl_tpu_torch.ops.cuda import _build

    _build._libs["cmdring"] = lib


class Timer:
    """Wraps a callable and adds its host time to ``spent[name]``."""

    def __init__(self, fn, name, spent):
        self.fn, self.name, self.spent = fn, name, spent

    def __call__(self, *a, **kw):
        t = time.perf_counter_ns()
        try:
            return self.fn(*a, **kw)
        finally:
            self.spent[self.name] = (self.spent.get(self.name, 0)
                                     + time.perf_counter_ns() - t)


class _TimedCtypes:
    """``ctypes`` with ``memmove`` timed (``PersistentRun.post``'s copy
    into the mapped block)."""

    def __init__(self, spent):
        self.memmove = Timer(ctypes.memmove, "memmove", spent)

    def __getattr__(self, name):
        return getattr(ctypes, name)


#: the functions ``PersistentRun.post`` may call, timed where the module
#: has them: (owner, attribute)
POST_PARTS = (("kseq", "_packed"), ("kseq", "_descriptor"),
              ("kseq", "_run_descriptor"), ("lib", "accl_sequencer_plan"),
              ("lib", "accl_sequencer_ring"))


def one_run(kseq, lib, win, lanes, windows, spent=None, stamped=True):
    """Post ``windows`` windows into one run; returns (wall ms a window from
    before the run is built, the same from its launch, host ns of each
    post, the stamps).  With ``spent``, the post's parts are timed into
    it."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    init = np.zeros((MAX_RUN_WINDOWS, ST_N), np.uint64)
    init[:, ST_COPY_MIN] = np.iinfo(np.uint64).max
    if stamped:
        check(lib, lib.accl_run_stamps(init.ctypes.data, 1), "stamps")
    saved = []
    if spent is not None:
        owners = {"kseq": kseq, "lib": lib}
        for owner, attr in POST_PARTS:
            obj = owners[owner]
            if hasattr(obj, attr):
                saved.append((obj, attr, getattr(obj, attr)))
                setattr(obj, attr, Timer(getattr(obj, attr), attr, spent))
        saved.append((kseq, "ctypes", kseq.ctypes))
        kseq.ctypes = _TimedCtypes(spent)
    posts = []
    gc.collect()
    gc.disable()  # a full collection (~0.1 s) would stall the posts
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = kseq.PersistentRun(win[3], len(win[1][0]), dev, windows, 0.5,
                                 lanes)
        for i in range(windows):
            t = time.perf_counter_ns()
            if run.post(*win[:3]) is None:
                raise RuntimeError(
                    f"post {i} was refused: exited {run.exited()}, done "
                    f"{run.done()}, posted {run.posted}, failed {run.failed}")
            posts.append(time.perf_counter_ns() - t)
            if i == 0:
                t1 = time.perf_counter()
                run.launch()
        if not run.wait_window(windows - 1, 60.0):
            raise RuntimeError(f"the run failed: {run.failed}")
        t2 = time.perf_counter()
    finally:
        gc.enable()
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)
    run.join(5.0)
    torch.cuda.synchronize()
    stamps = np.zeros((MAX_RUN_WINDOWS, ST_N), np.uint64)
    if stamped:
        check(lib, lib.accl_run_stamps(stamps.ctypes.data, 0), "stamps")
    return ((t2 - t0) * 1e3 / windows, (t2 - t1) * 1e3 / windows, posts,
            stamps[:windows].astype(np.int64))


def split(stamps) -> dict:
    """Per window k >= 1, (a)-(e), the period and whether block 0 had
    fetched the window ahead (staged before window k - 1's closing
    barrier), in ms."""
    import numpy as np

    s = stamps
    k = slice(1, None)
    start = np.maximum(s[k, ST_STAGED], s[:-1, ST_CLOSED])
    parts = {
        "fetch": s[k, ST_STAGED] - s[k, ST_SEEN],
        "publish": s[k, ST_COPY_MAX] - start,
        "work": s[k, ST_WORK_MAX] - s[k, ST_COPY_MAX],
        "close": s[k, ST_DONE] - s[k, ST_WORK_MAX],
        "idle": np.maximum(s[k, ST_SEEN] - s[:-1, ST_DONE], 0),
        "period": s[k, ST_DONE] - s[:-1, ST_DONE],
        "copy_skew": s[k, ST_COPY_MAX] - s[k, ST_COPY_MIN],
    }
    out = {name: [float(x) / 1e6 for x in v] for name, v in parts.items()}
    out["ahead"] = [float(x) for x in s[k, ST_STAGED] < s[:-1, ST_CLOSED]]
    return out


def check(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what}: {lib.accl_error_string(rc).decode()}")


def med(xs):
    return statistics.median(xs) if xs else float("nan")


def run_device_ms(kseq, win, lanes, windows) -> float:
    """Device time a window of a run with every window posted before its
    launch (each but the first fetched ahead): CUDA events around the
    launch, over ``windows``."""
    import torch

    dev = torch.device("cuda", 0)
    run = kseq.PersistentRun(win[3], len(win[1][0]), dev, windows, 0.5,
                             lanes)
    for i in range(windows):
        if run.post(*win[:3]) is None:
            raise RuntimeError(f"post {i} was refused")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run.launch()
    end.record()
    end.synchronize()
    if run.done() != windows:
        raise RuntimeError(f"the run did {run.done()} of {windows} windows")
    run.join(5.0)
    return start.elapsed_time(end) / windows


def profile(cs, kseq, libs, name, win, lanes, rounds, windows) -> dict:
    """The split (the stamped build), the host's post, the wall time, the
    device time a window of a preposted run (both builds) and both
    one-shot forms (the plain build) of one window kind."""
    import torch

    dev = torch.device("cuda", 0)
    lib = libs["stamped"]
    use(lib)
    want = [[None if o is None else torch.empty_like(o) for o in row]
            for row in win[2]]
    kseq.sequencer_plain(win[0], win[1], want, win[3])
    one_run(kseq, lib, win, lanes, 2)  # warm: the build, the pool
    torch.cuda.synchronize()
    for i, (rg, rw) in enumerate(zip(win[2], want)):
        for o, w in zip(rg, rw):
            if o is not None:
                cs.compare(f"run_profile {name} slot {i}", o, w)
    parts = {}
    posts = []
    for _ in range(rounds):
        _, _, post, stamps = one_run(kseq, lib, win, lanes, windows)
        grid = int(stamps[0, ST_GRID])
        posts += post[1:]
        for key, v in split(stamps).items():
            parts.setdefault(key, []).extend(v)
    spent = {}
    timed_posts = []
    for _ in range(rounds):
        timed_posts += one_run(kseq, lib, win, lanes, windows, spent)[2][1:]
    n_posts = rounds * windows
    out = {"split_ms": {k: med(v) for k, v in parts.items()
                        if k != "ahead"},
           "ahead_share": statistics.mean(parts["ahead"]),
           "grid": grid,
           "period_ms_rounds": [med(parts["period"][i * (windows - 1):
                                                    (i + 1) * (windows - 1)])
                                for i in range(rounds)],
           "post_ms": med(posts) / 1e6,
           "post_parts_ms": {k: v / n_posts / 1e6 for k, v in spent.items()},
           "post_timed_ms": med(timed_posts) / 1e6}
    stamped_dev = [run_device_ms(kseq, win, lanes, 64) for _ in range(rounds)]
    # the plain build from here on: the run as chip_smoke.py runs it
    use(libs["plain"])
    walls, walls_launch = [], []
    for _ in range(rounds):
        wall, wall_l, _, _ = one_run(kseq, libs["plain"], win, lanes,
                                     windows, stamped=False)
        walls.append(wall)
        walls_launch.append(wall_l)
    dev_ms = [run_device_ms(kseq, win, lanes, 64) for _ in range(rounds)]
    out.update({"run_device_ms": med(dev_ms), "run_device_ms_rounds": dev_ms,
                "run_device_ms_stamped": med(stamped_dev),
                "wall_ms": med(walls), "wall_ms_rounds": walls,
                "wall_from_launch_ms": med(walls_launch)})
    # the one-shot kernel on the same window: the wrapper's launch, and
    # cooperative at a run's grid (co-resident blocks, then fewer)
    lib = libs["plain"]
    out["oneshot_device_ms"] = cs.device_ms(lambda: kseq.sequencer(*win),
                                            iters=20)
    out["oneshot_ms"] = cs.time_ms(lambda: kseq.sequencer(*win), iters=20)
    words = kseq._words(win[0])
    P, _, _, packed, _ = kseq._packed(words, win[1], win[2], win[3])
    d, _ = kseq._descriptor(packed, words, 0, words.shape[0], P, {})
    status = torch.empty((words.shape[0], 2), dtype=torch.int32, device=dev)
    bar = torch.zeros(4, dtype=torch.int32, device=dev)
    maxseg = kseq.scale_segments(win[3])
    scales = torch.empty(max(1, words.shape[0] * P * maxseg),
                         dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    grids = {}
    for grid in (1 << 20, 264, 132, 66):
        def coop(grid=grid):
            check(lib, lib.accl_sequencer_grid(
                d.ctypes.data, status.data_ptr(), bar.data_ptr(),
                scales.data_ptr(), scales.numel(), grid, stream),
                "accl_sequencer_grid")
        coop()
        torch.cuda.synchronize()
        for i, (rg, rw) in enumerate(zip(win[2], want)):
            for o, w in zip(rg, rw):
                if o is not None:
                    cs.compare(f"run_profile {name} grid {grid} slot {i}",
                               o, w)
        grids["co_resident" if grid == 1 << 20 else str(grid)] = (
            cs.device_ms(coop, iters=20))
    out["oneshot_coop_device_ms"] = grids
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--windows", type=int, default=16)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("run_profile: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from accl_tpu_torch.constants import CmdOpcode as Op
    from accl_tpu_torch.ops.cuda import cmdring as kseq

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    from accl_tpu_torch.ops.cuda import _build

    libs = {"plain": _build.library("cmdring", kseq.PROTOTYPES["cmdring"]),
            "stamped": build_stamped()}
    print(f"built cmdring.cu, plain and stamped, in {time.time() - t0:.1f} s",
          flush=True)
    F32, AR = torch.float32, [(Op.ALLREDUCE, 0, 0)] * 8
    kinds = {
        "plain": (lambda: cs.seq_window(cs.P_MAIN, F32, AR, cs.SEQ_N,
                                        cs.SEED + 6), False),
        # 8 x allreduce of 4,096 elements: a window's cost in a run less
        # its items, beside a launch's
        "tiny": (lambda: cs.seq_window(cs.P_MAIN, F32, AR, 4096,
                                       cs.SEED + 6), False),
        "int8": (lambda: cs.seq_window(cs.P_MAIN, F32, AR, cs.SEQ_N,
                                       cs.SEED + 5, wires=[torch.int8],
                                       flags=12345), True),
        "e4m3": (lambda: cs.seq_window(cs.P_MAIN, F32, AR, cs.SEQ_N,
                                       cs.SEED + 5,
                                       wires=[torch.float8_e4m3fn],
                                       flags=12345), True),
    }
    rows = {}
    for name, (make, lanes) in kinds.items():
        row = profile(cs, kseq, libs, name, make(), lanes, args.rounds,
                      args.windows)
        rows[name] = row
        sp = row["split_ms"]
        print(f"{name}: split (ms, median of windows 1..{args.windows - 1}) "
              + " ".join(f"{k}={v:.4f}" for k, v in sp.items())
              + f"; fetched ahead {row['ahead_share']:.2f}; grid "
              f"{row['grid']} blocks", flush=True)
        print(f"{name}: device a window of a preposted run "
              f"{row['run_device_ms']:.4f} (stamped build "
              f"{row['run_device_ms_stamped']:.4f}); wall a window "
              f"{row['wall_ms']:.4f} (from the launch "
              f"{row['wall_from_launch_ms']:.4f}), post {row['post_ms']:.4f} "
              f"(timed {row['post_timed_ms']:.4f}: "
              + " ".join(f"{k}={v:.4f}"
                         for k, v in row["post_parts_ms"].items())
              + f"); one-shot {row['oneshot_ms']:.4f} wall, device "
              f"{row['oneshot_device_ms']:.4f}, cooperative "
              + " ".join(f"{k}={v:.4f}"
                         for k, v in row["oneshot_coop_device_ms"].items()),
              flush=True)
        torch.cuda.synchronize()
    result = {"run_profile": {"card": card, "windows": args.windows,
                              "rounds": args.rounds, "kinds": rows}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
