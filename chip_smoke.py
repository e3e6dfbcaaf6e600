#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``accl_tpu_torch``) once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --launch-path   # phase 4's launch path alone

Phases (any failure exits non-zero):

0. print the card's name and power limit (nvidia-smi), then row 19's
   kernel-load probe (``accl_tpu_torch.compat.has_kernels``): build
   ``csrc/probe.cu``, copy an (8, 128) float32 block on the card and hold
   the copy against its input; a false probe fails the run with its
   reason, before anything else is built or run;
1. build every kernel from ``accl_tpu_torch/csrc`` (one nvcc per source,
   in parallel) and report the attention kernels at bf16 D 128 (ptxas's
   registers and spills, and the wgmma kernels' dynamic shared memory);
   fail if a wgmma kernel (rows 15-18) spills, if ptxas serialised its
   wgmmas (C7513, C7512), or if ``cuobjdump -sass`` finds no HGMMA in
   ``attention``, ``ring_attention`` or ``attention_bwd``; then report the
   streaming tile core's kernels (K3's allgather and root-only gather,
   K4's combine, row 11's scatter, row 13's put) and rows 14 and 7 (the
   sequencer, the quantize's LANES and CLUSTER paths): ptxas's
   registers, spill bytes and stack frame, and fail
   if one spills or keeps a stack frame (the pointer tables are indexed
   in place, ``__grid_constant__``);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes — float results must match EXACTLY (same operation
   order, same round-to-nearest-even; NaN positions must agree), except
   flash attention (rows 16-18 and the backward's delta pass), whose
   fold order differs from its plain versions' and which is held within
   stated tolerances (``check_flash``, ``check_flash_bwd``: every 16-bit
   dQ and dK/dV through their wgmma kernels, a bfloat16 backward repeated
   bit for bit).  The
   rooted relays (bcast in place and out of place, reduce with every
   rank's partial and with the root's output alone, scatter) and K3's
   root-only gather (its own kernel, with the result allocated and into
   the facade's root-only ``out`` table) run at P in {2, 4, 8} x root in
   {0, P-1} x f32/bf16/f16/i32, SUM and MAX with NaNs, 16M per rank, plus
   a ragged 1,000,003 and views misaligned by one element (the scalar
   path), the scatter also into outputs of which every other one is
   misaligned (each row decides its own alignment).  K4 (``combine``) runs f32/bf16/f16/i32, SUM and MAX with NaNs,
   in place and not, at 64M elements, and every operand dtype (f16, f32,
   f64, i32, i64, bf16) into every ``out_dtype`` at n = 1, 255, 257 and
   1,000,003, aligned and misaligned by one element, SUM and MAX, in
   place where the dtypes allow it.  The
   command-ring sequencer (row 14) is held against ``sequencer_plain``,
   results and status words, over P in {2, 3, 4, 8, 12, 16}, windows of
   depth 1, 8 and 64 (512 rank-slots at P = 8) mixing every opcode class
   (bcast at roots 0 and P-1, send / recv, the attention hop at offsets 1
   and P-1, an opcode outside the enum), f32/bf16/f16/i32 each under no
   wire and the bf16 and f16 wire lanes, SUM and MAX with NaNs, 1M
   elements per rank, ragged counts (1,000,003; columns past the last
   whole tile), misaligned views (every rank, or one rank's operands and
   results), the aliasing hazards (in-place allreduce, reduce-scatter,
   allgather, alltoall and bcast; write after read and write after write
   across slots: the cooperative launch) and every in-place form
   (``inplace_window``).  K1 also runs its fp8 lanes and its raw int8 cast.  Rows 5-8
   (the compression kernels) are held BIT FOR BIT (NaN bits included,
   but for the NaN of an int8 segment's scale): the cast over every
   pair of float32 / bfloat16 / float16 / fp8 e4m3 / e5m2, the
   stochastic cast from float32 and bfloat16 to each lane, seeds 0 and
   nonzero, and row 6 proper (float32 -> bfloat16, always stochastic),
   quantize in the wire's 256-element segments and the Pallas tier's
   tiles, seeds 0 and nonzero (and each of its three paths over 3 rows,
   ``check_quantize_paths``), and dequantize to float32 / bfloat16 /
   float16, at n = 1, 255, 257, 1,000,003 and 32 Mi, on operands with
   NaN, infinities, signed zeros, subnormals, fp8 overflow and an
   all-zero segment; the cast also over R = 4 rows in one launch at n =
   257 and 1,000,003 for every pair, aligned and with the input, the
   output or both one element past 16-byte alignment, and on the
   compressed facade's 4 x 16 Mi float32 rows to every lane; then the
   device wire codec on the card against the host codec (numpy) per lane
   and seed.  Row 13 (``fused_shift``, the
   fused compute-and-put) over float32 / bfloat16 / float16 / int32,
   counts 1, 700, 16Mi + 3 and 16Mi per rank, distances 1, -1, 3 and 5
   at P = 4 and P = 1, identity / + 1.0 / * 2.0, and + 0.1 / * 1.3 on the
   float operands (the constant rounded to a 16-bit operand as JAX
   rounds it), with +-0, +-inf and NaN among the float operands, and a
   misaligned view (identity bit for
   bit, the computed forms exactly, NaN where NaN); row 19's copy
   against ``clone``, and on a side stream inside its context (the
   wrappers' ``stream_of`` is PyTorch's current stream).  Row 12 (``alltoall``) bit for bit over P in
   {2, 3, 4, 8} x float32 / bfloat16 / float16 / int32 / int8 / fp8
   e4m3 / e5m2, blocks of 16-byte multiples and not, and a misaligned
   view; row 15 (``ring_attention``) over contiguous and striped shards,
   causal and full, bf16 / f16 / f32, D 24, 64 and 128, T_local 200, 64
   and 136 over P 4, 3 and 1, and the main path's 4 x (2, 32, 1024, 128)
   bf16, within 2e-5 (float32) or 1e-2 (16-bit) of its plain version;
   each of these calls launches its kernel exactly once, every 16-bit one
   through the wgmma kernel (``wgmma_launches``) and every float32 one
   through the FFMA kernel; row 16 also reads the transformer's
   transposed head views in place (no copy) and copies a misaligned and a
   head-dim-20 operand first (``attention.tma_copies``, 3 each);
3. the main paths, each with every kernel's launch counter zeroed just
   before and read just after (rows 15-18: every launch of the serving,
   training and sequence-parallel paths through the wgmma kernels,
   ``all_wgmma``):
   a. the allreduce path: ``cuda_group(4)``, one thread per rank, 16M
      float32 (64 MiB) per rank — three ``pallas_ring`` allreduces
      (4 segments), one with a bfloat16 wire, one ``pallas_ring_bidir``,
      one ``xla``, a facade ``combine``, and the kernel tier's ring
      reduce-scatter and allgather on the ranks' buffers — each result
      checked against a float64 numpy reference; K1-K4 must have launched;
   b. the rooted path: the same group and size, roots 0 and 3, ``reduce``
      (SUM, and MAX under the ring), ``bcast``, ``scatter`` and ``gather``
      under ``pallas_ring`` and under ``xla``, and ``alltoall`` — each
      result checked exactly against numpy (the ``xla`` SUM reduce within
      1e-5 of float64), non-root result buffers shown untouched; each
      rooted kernel's launches must equal its ``pallas_ring`` calls;
   c. the batch path: ``with a.batch():`` windows at 256 KiB and 4 MiB per
      rank — eight slots (allreduce SUM and MAX, bcast root 2,
      reduce_scatter, allgather, alltoall, barrier, fused_apply), then
      fused_matmul_reduce_scatter and fused_attn_hop — each checked
      exactly against numpy and each one refill, no fallback, one
      sequencer launch and no other kernel launch; then windows the ring
      refuses (oversized, a reduce inside, ``pallas_ring`` registered),
      correct with their reason counted;
   d. the serving path: the transformer at bench.py's serving width
      (vocab 32768, d_model 2048, 16 heads, 8 layers, d_ff 8192, bfloat16,
      random weights from a seeded generator) — run A, ``generate`` of
      128 steps from an (8, 128) prompt under ``attention="flash"``, and
      run B, ``prefill`` of (8, 1024) under ``"auto"``, each launching
      ``flash_attention`` once a layer and no other kernel; run B's
      logits under flash against naive (float32 within 1e-4 relative,
      bfloat16 within ``BF16_LOGIT_ATOL``) and 32 float32 greedy steps of
      2 layers under flash against naive, tie-aware;
   e. the training path: the transformer at bench.py's training width
      (vocab 32768, d_model 4096, 32 heads, 6 layers, d_ff 16384,
      bfloat16, 1,346M parameters, random weights and an (8, 1024) token
      batch from a seeded generator, targets the tokens rolled by one) —
      3 steps of ``make_sharded_train_step`` (lr 0.01) under ``"auto"``,
      each launching the flash forward, the delta, dQ and dK/dV kernels
      once a layer and no other kernel, with finite losses and weights;
      ``loss_fn``
      and its gradients under flash against naive, in bfloat16 at full
      width (within ``BF16_LOSS_RTOL`` and ``BF16_GRAD_RTOL``) and in
      float32 with 2 layers and batch 2 (loss within 1e-5, every gradient
      within 1e-4 relative), and the float32 step's updated weights
      against p - lr g;
   f. the compressed path: ``cuda_group(4)``, 64 MiB float32 per rank,
      the facade allreduce on every wire lane under ``xla``,
      ``pallas_ring`` and ``pallas_ring_bidir`` (and bfloat16 operands on
      the fp8 and int8 lanes under ``xla``), each held exactly against
      the plain computation on the card (each contribution's wire
      roundtrip, then the rank-order fold; or the ring's plain hop
      schedule), then ``int8_allreduce`` on the ranks' buffers; rows 5-8
      and K1 must have launched; then bench.py's convergence leg on
      ``cuda_group(2)`` (f32 wire, fp8 raw, fp8 with error feedback;
      ``delta_pct`` at most 10 %), which must launch the wire casts;
   g. the point-to-point path: ``cuda_group(4)``, 64 MiB of float32 a
      message — send/recv 0 -> 1, the bidirectional exchange, a ring
      shift through the facade, sends on the bf16 / f16 / fp8 e4m3 /
      e5m2 wire lanes (equal to ``wire.astype``'s roundtrip), facade
      ``copy`` from float32 into a buffer of each lane and a stream
      result in bfloat16 (RES_COMPRESSED), each equal to
      ``wire.astype``, ``stream_put``, send from a stream port and recv
      into one,
      ``reduce`` from and to stream ports under ``xla`` and
      ``pallas_ring`` (equal to the buffer reduce), and the three
      ``vadd_put`` forms around the ring (equal to ``roll(x + 1.0)``),
      all bit for bit; the run must launch row 5 13 times, row 10
      three times and row 13 once, and no other kernel;
   h. the sequence-parallel path: bench.py's long-context training
      record's attention (d_model 4096, 32 heads, D 128, seq 4096, batch
      2, bfloat16), q, k, v (2, 32, 4096, 128) from the seed, sharded
      over 4 virtual ranks (T_local 1024), contiguous and striped —
      ``ulysses_attention`` with the tiled ``_a2a`` and with row 12,
      ``ring_attention_pallas`` (row 15) over both layouts, and the
      ppermute ``ring_attention`` / ``striped_attention``; Ulysses with
      row 12 equal to the ``_a2a`` form bit for bit, row 15 within 1e-2
      of the ppermute forms, every form within 1e-2 of
      ``reference_attention`` on the full sequence (chunked over batch
      and 8 heads); the run must launch row 12 four times and row 15
      twice, and no other kernel;
4. time each kernel at those shapes beside its bound, its plain version
   and one PyTorch library call computing the same function (K3's
   allgather and root-only gather, K4, row 11 and row 13 also by device
   time alone, their library calls too; the sequencer on 8
   allreduces of 1M float32 per rank, by device time too, beside its
   library call's, with 8 x 64K and the facade's mix at 4 MiB per rank as
   extra keys of its entry; flash attention at run A's
   (8, 16, 128, 128) bf16 causal, with run B's T = 1024 as extra keys,
   beside ``scaled_dot_product_attention``, bounded by the tensor cores'
   bf16 rate, and with its LSE at the training shape (8, 32, 1024, 128));
   the delta pass, dQ and dK/dV (rows 17-18) at that shape beside their
   plain versions and the backward of ``scaled_dot_product_attention``,
   which computes dQ, dK and dV in one call (beside the sum of rows 17 +
   18 and the delta pass), each also by device time alone; rows 5-8 at 32 Mi float32 elements (cast and stochastic
   cast to bfloat16, the cast beside ``Tensor.to``, also by device time
   alone, on the compressed facade's 4 x 16 Mi rows to bfloat16 and fp8
   e4m3 and widening bfloat16 -> float32, with its cast kernels'
   registers and spills from ptxas; quantize and
   dequantize in the Pallas tier's tiles, the wire's 256-element
   segments as extra keys, quantize also by device time, at seeds 0 and
   9 on the wire's segments); row 13 at 4 x 64 MiB float32 with + 1.0
   beside 4 x ``torch.add(x, 1.0, out=)``; row 19 on its block beside
   ``Tensor.clone``, both also by device time alone, and its launch path
   (``launch_path``: ``probe_copy`` and ``cast_rows`` on 4 KiB beside
   ``clone`` and ``Tensor.to``, then each host step of the path alone,
   the dropped ones beside them); row 12 on Ulysses' q re-shard (4 x 16
   MiB bf16)
   beside P x ``torch.cat``; row 15 at the main path's contiguous causal
   shards (striped and full as extra keys) beside
   ``scaled_dot_product_attention(is_causal=True)`` on the full sequence,
   bounded by the tensor cores' bf16 rate; rows 16 and 15 at each of those
   shapes also by device time alone (``device_ms``), with their rate over
   the pairs the run needs, the share of the bound they reach and SDPA's
   time on the same work (non-causal SDPA beside row 15's full layout);
   K3's library figure writes every rank's gathered output (P x
   ``torch.cat(blocks, out=)``), as the kernel does;
5. time the facade end to end (host clock around each synchronous call
   on rank 0's thread, rendezvous included) at 256 KiB, 4 MiB and 64 MiB
   per rank: the allreduce under ``xla``, ``pallas_ring`` and
   ``pallas_ring_bidir`` (p50 and bus bandwidth, bytes per rank x
   2(P-1)/P over the p50), then reduce / bcast / scatter / gather under
   ``xla`` and ``pallas_ring`` and alltoall (p50 and p90), and one
   batched window of 8 allreduces beside the same 8 calls unbatched at
   256 KiB, 1 MiB and 4 MiB per rank, each set as a JSON line of its own;
   then the serving path (``serve_generate``): run A's prefill ms, the
   decode step p50, decode tokens/s over ``generate``'s wall time, and
   run B's prefill ms; then the training path (``train_step``): the step
   time (bench.py's mean over 10 steps, p50 and p90 beside it),
   tokens/s, bench.py's 6 N B T count over the step as ``train_tflops``
   and over 989 TFLOP/s as ``train_mfu``, peak memory, and the three
   kernels' launches per step; then ``facade_compressed`` (p50 and p90
   per wire lane and register at 4 MiB and 64 MiB per rank, beside the
   uncompressed call), ``facade_p2p`` (p50 and p90 of send -> recv
   completed, the P = 4 ring shift and ``stream_put`` -> ``stream_pop``
   at 256 KiB, 4 MiB and 64 MiB, and the three ``vadd_put`` forms at
   64 MiB) and ``compression_convergence`` (the leg's losses and
   ``delta_pct``); then ``seq_parallel_attention``: host-clock p50 /
   p90 of one call at the main path's width (20 calls after 2 warm-ups)
   for Ulysses (``_a2a``), Ulysses with row 12, the ppermute
   ``ring_attention`` and row 15 over contiguous and striped shards,
   with each form's peak memory and phase 3h's gaps.

The second-to-last line is the ``{"kernels": [...]}`` JSON object, the last
``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and float32 operations/s
# outside the tensor cores (the kernels' folds are scalar float32 adds)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# and bf16/f16 operations/s on the tensor cores, dense (the flash kernel's
# products)
TC16_OPS_PER_S = 989e12
N_RANK = 16 * 1024 * 1024  # elements per rank on the main path (64 MiB f32)
N_COMBINE = 64 * 1024 * 1024  # combine operand elements (256 MB f32)
P_MAIN = 4
SEED = 1234
ROOTED_REGISTERS = ("reduce_algorithm", "bcast_algorithm",
                    "scatter_algorithm", "gather_algorithm")
SLICE1_KERNELS = ("ring_allreduce", "ring_reduce_scatter", "ring_allgather",
                  "combine")
# the kernels on the streaming tile core (common.cuh), by KERNELS name
TILE_KERNELS = ("ring_allgather", "ring_gather", "combine", "ring_scatter",
                "fused_shift")


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


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time alone: a sleep kernel holds the stream while the host
    enqueues the launches, so the events bracket the kernels and not the
    host's launch path (``time_ms`` includes it when the host is the
    slower side)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run_ranks(group, rank_main, what: str) -> None:
    """``rank_main(accl, rank)`` on one thread per rank; fails on any
    rank's exception or a hung thread."""
    errors = []

    def runner(a, r):
        try:
            rank_main(a, r)
        except BaseException as e:  # reported by the main thread
            errors.append(f"rank {r}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=runner, args=(group[r], r))
               for r in range(len(group))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        fail(f"{what} failed: {errors or 'a rank thread hung'}")


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

    def rank_main(a, r):
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

    group = at.cuda_group(P_MAIN)
    try:
        run_ranks(group, rank_main, "facade timing")
    finally:
        for a in group:
            a.deinit()
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


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> dict:
    """The least time for moving ``nbytes`` and doing ``ops`` operations
    at ``ops_per_s`` (float32 outside the tensor cores unless told
    otherwise) on the card, and which of the two bounds it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_rooted(xs, rand) -> dict:
    """Phase 4 for rows 9-11 and K3's root-only gather, on the main
    path's forms: ``xs`` are the P ranks' 16M float32 operands, root 0."""
    import torch

    from accl_tpu_torch.ops import cuda as kc

    P, n, f4 = len(xs), xs[0].numel(), 4
    bc = [x.clone() for x in xs]  # the facade's in-place bcast
    red = [None] * P
    red[0] = torch.empty_like(xs[0])  # the facade's root-only reduce
    big = rand(P * n, torch.float32)
    sc_in = [big] * P  # only the root's operand is read
    sc_out = [torch.empty_like(x) for x in xs]
    gat = [None] * P
    gat[0] = torch.empty(P * n, device=xs[0].device)

    def copies(dst, srcs):
        for d, s in zip(dst, srcs):
            d.copy_(s)

    return {
        "ring_bcast": dict(
            ms=time_ms(lambda: kc.ring_bcast(bc, 0, out=bc)),
            plain_ms=time_ms(lambda: kc.ring_bcast_plain(xs, 0)),
            library_ms=time_ms(lambda: copies(bc[1:], [bc[0]] * (P - 1))),
            bytes=P * n * f4, ops=0,  # read the root once, write P-1
        ),
        "ring_reduce": dict(
            ms=time_ms(lambda: kc.ring_reduce(xs, 0, 0, out=red)),
            plain_ms=time_ms(lambda: kc.ring_reduce_plain(xs, 0, 0)),
            library_ms=time_ms(lambda: torch.stack(xs).sum(0)),
            bytes=(P + 1) * n * f4, ops=(P - 1) * n,
        ),
        "ring_scatter": dict(
            ms=time_ms(lambda: kc.ring_scatter(sc_in, 0, out=sc_out)),
            device_ms=device_ms(lambda: kc.ring_scatter(sc_in, 0,
                                                        out=sc_out)),
            plain_ms=time_ms(lambda: kc.ring_scatter_plain(sc_in, 0)),
            library_ms=time_ms(lambda: copies(sc_out, big.chunk(P))),
            library_device_ms=device_ms(lambda: copies(sc_out,
                                                       big.chunk(P))),
            bytes=2 * P * n * f4, ops=0,
        ),
        "ring_gather": dict(
            ms=time_ms(lambda: kc.ring_gather(xs, 0, out=gat)),
            device_ms=device_ms(lambda: kc.ring_gather(xs, 0, out=gat)),
            plain_ms=time_ms(lambda: kc.ring_gather_plain(xs, 0)),
            library_ms=time_ms(lambda: torch.cat(xs, out=gat[0])),
            library_device_ms=device_ms(lambda: torch.cat(xs, out=gat[0])),
            bytes=2 * P * n * f4, ops=0,
        ),
    }


def check_rooted_kernels(rand, err) -> None:
    """Rows 9-11 and K3's root-only gather against their plain versions
    (phase 2); the scatter also into outputs of which every other one is
    misaligned."""
    import torch

    from accl_tpu_torch.ops import cuda as kc

    F32, BF16, F16, I32 = (torch.float32, torch.bfloat16, torch.float16,
                           torch.int32)
    SUM, MAX = 0, 1
    cases = [(P, root, dtype, N_RANK, 0) for P in (2, 4, 8)
             for root in (0, P - 1) for dtype in (F32, BF16, F16, I32)]
    cases += [(4, 3, F32, 1_000_003, 0), (4, 0, BF16, 1_000_003, 0),
              (4, 3, F32, N_RANK, 1), (3, 1, F16, N_RANK, 1)]
    for P, root, dtype, n, offset in cases:
        tag = f"P={P} root={root} {dtype} n={n} offset={offset}"

        def operand(numel):
            x = rand(numel + offset, dtype)[offset:]  # offset: misaligned
            if dtype.is_floating_point:
                x[::997] = float("nan")
            return x

        def held(name, got, want, ranks):
            for r in ranks:
                err[name] = max(err[name], compare(
                    f"{name} {tag} rank {r}", got[r], want[r]))

        xs = [operand(n) for _ in range(P)]
        for fn in (SUM, MAX):
            want = kc.ring_reduce_plain(xs, root, fn)
            held("ring_reduce", kc.ring_reduce(xs, root, fn), want,
                 range(P))
            out = [None] * P
            out[root] = torch.empty(n, dtype=dtype, device=xs[0].device)
            kc.ring_reduce(xs, root, fn, out=out)
            held("ring_reduce", out, want, [root])
        want = kc.ring_bcast_plain(xs, root)
        held("ring_bcast", kc.ring_bcast(xs, root), want, range(P))
        ys = [x.clone() for x in xs]
        kc.ring_bcast(ys, root, out=ys)
        held("ring_bcast", ys, want, range(P))
        want = kc.ring_gather_plain(xs, root)
        held("ring_gather", kc.ring_gather(xs, root), want, [root])
        out = [None] * P  # the facade's form: the root's output alone
        out[root] = torch.full((P * n,), 7, dtype=dtype, device=xs[0].device)
        kc.ring_gather(xs, root, out=out)
        held("ring_gather", out, want, [root])
        big = [operand(P * n)] * P  # only the root's operand is read
        want = kc.ring_scatter_plain(big, root)
        held("ring_scatter", kc.ring_scatter(big, root), want, range(P))
        # every other rank's output a view one element in: each row
        # decides its own alignment
        out = [torch.full((n + q % 2,), 7, dtype=dtype,
                          device=xs[0].device)[q % 2:] for q in range(P)]
        kc.ring_scatter(big, root, out=out)
        held("ring_scatter", out, want, range(P))
        del xs, ys, big, want, out
        torch.cuda.synchronize()


def rooted_main_path(kc) -> dict:
    """Phase 3b: the facade's rooted calls and alltoall, 4 ranks x 64 MiB,
    roots 0 and 3, under ``pallas_ring`` and ``xla``.  Returns the kernel
    launch counts of the run."""
    import numpy as np

    import accl_tpu_torch as at

    P, n = P_MAIN, N_RANK
    rng = np.random.default_rng(SEED + 1)
    data = rng.standard_normal((P, n), dtype=np.float32)
    big = data.reshape(-1)  # the scatter operand: rank r's block is data[r]
    exact = data.astype(np.float64).sum(0)
    roots = (0, 3)

    def relay_sum(root):  # the ring relay's fold order, in float32
        acc = data[(root + P - 1) % P].copy()
        for rel in range(P - 2, -1, -1):
            acc = data[(root + rel) % P] + acc
        return acc

    relayed = {root: relay_sum(root) for root in roots}
    maxed = np.maximum.reduce(data)
    m = n // P  # alltoall block: rank r's operand is data[r]
    calls = {"ring_reduce": 0, "ring_bcast": 0, "ring_scatter": 0,
             "ring_gather": 0}
    wrong = []  # a rank records what it got wrong and goes on calling

    def rank_main(a, r):
        F32 = np.float32
        s = a.create_buffer_from(data[r])
        recv = a.create_buffer(n, F32)
        bc = a.create_buffer(n, F32)
        sc = a.create_buffer_from(big) if r in roots else None
        gat = a.create_buffer(P * n, F32)
        a2r = a.create_buffer(n, F32)

        def host(buf):
            buf.sync_from_device()
            return buf.data

        def sentinel(buf):
            buf.host_view()[:] = 7.0
            buf.sync_to_device()
            return buf

        def check(ok, what):
            if not ok:
                wrong.append(f"rank {r}: {what}")

        for algo in ("pallas_ring", "xla"):
            for key in ROOTED_REGISTERS:
                a.set_tuning(key, algo)
            a.set_tuning("ring_segments", 4)
            ring = algo == "pallas_ring"
            for root in roots:
                tag = f"{algo} root {root}"
                is_root = r == root
                # a non-root passes None at root 0, a buffer at root 3
                other = None if root == 0 else sentinel(recv)
                for fn in ((0, 1) if ring else (0,)):
                    a.reduce(s, recv if is_root else other, root=root,
                             function=fn)
                    if r == 0 and ring:
                        calls["ring_reduce"] += 1
                    got = host(recv)
                    if not is_root:
                        check(other is None or (got == 7.0).all(),
                              f"reduce {tag}: non-root result written")
                    elif fn == 1:
                        check(np.array_equal(got, maxed), f"reduce MAX {tag}")
                    elif ring:
                        check(np.array_equal(got, relayed[root]),
                              f"reduce SUM {tag}")
                    else:
                        check(np.allclose(got, exact, rtol=1e-5, atol=1e-5),
                              f"reduce SUM {tag}")
                bc.host_view()[:] = s.host_view()
                bc.sync_to_device()
                a.bcast(bc, root=root)
                check(np.array_equal(host(bc), data[root]), f"bcast {tag}")
                a.scatter(sc if is_root else None, recv, n, root=root)
                check(np.array_equal(host(recv), data[r]), f"scatter {tag}")
                gother = None if root == 0 else sentinel(gat)
                a.gather(s, gat if is_root else gother, root=root)
                got = host(gat)
                if is_root:
                    check(np.array_equal(got, big), f"gather {tag}")
                else:
                    check(gother is None or (got == 7.0).all(),
                          f"gather {tag}: non-root result written")
                if r == 0 and ring:
                    for k in ("ring_bcast", "ring_scatter", "ring_gather"):
                        calls[k] += 1
        a.alltoall(s, a2r)
        want = np.concatenate([data[p][r * m:(r + 1) * m] for p in range(P)])
        check(np.array_equal(host(a2r), want), "alltoall")

    for k in kc.KERNELS.values():
        k.launches.reset()
    group = at.cuda_group(P)
    try:
        run_ranks(group, rank_main, "rooted main path")
    finally:
        for a in group:
            a.deinit()
    launches = {k: f.launches.count for k, f in kc.KERNELS.items()}
    if wrong:
        fail(f"rooted path: {wrong}")
    for k, want in calls.items():
        if launches[k] != want:
            fail(f"rooted path: {k} launched {launches[k]} times for "
                 f"{want} pallas_ring calls")
    return launches


def facade_rooted_latency(sizes, iters: int = 20) -> list:
    """p50 and p90 of the facade's rooted calls (root 0) and alltoall per
    (op, register, elements per rank), and the p50 of the gang's launch
    time; every pair runs twice over and only the second pass is kept."""
    import numpy as np

    import accl_tpu_torch as at

    P = P_MAIN
    samples = {}
    plan = [(op, algo) for op in ("reduce", "bcast", "scatter", "gather")
            for algo in ("xla", "pallas_ring")] + [("alltoall", "xla")]

    def rank_main(a, r):
        a.set_tuning("ring_segments", 4)
        root = r == 0
        bufs = {}
        for n in sizes:
            bufs[n] = dict(
                s=a.create_buffer(n, np.float32),
                recv=a.create_buffer(n, np.float32),
                big=a.create_buffer(P * n, np.float32) if root else None,
            )
        calls = {
            "reduce": lambda b: a.reduce(b["s"], b["recv"] if root else None,
                                         root=0),
            "bcast": lambda b: a.bcast(b["recv"], root=0),
            "scatter": lambda b: a.scatter(b["big"], b["recv"], root=0),
            "gather": lambda b: a.gather(b["s"], b["big"], root=0),
            "alltoall": lambda b: a.alltoall(b["s"], b["recv"]),
        }
        for _pass in range(2):
            for n in sizes:
                for op, algo in plan:
                    for key in ROOTED_REGISTERS:
                        a.set_tuning(key, algo)
                    times, launch = [], []
                    for _ in range(iters):
                        t = time.perf_counter()
                        req = calls[op](bufs[n])
                        times.append(time.perf_counter() - t)
                        launch.append(req.get_duration_ns() * 1e-9)
                    if root:
                        samples[(op, algo, n)] = (times, launch)

    group = at.cuda_group(P)
    try:
        run_ranks(group, rank_main, "rooted facade timing")
    finally:
        for a in group:
            a.deinit()
    return [{
        "op": op, "algo": algo, "bytes_per_rank": 4 * n,
        "p50_ms": float(np.median(times)) * 1e3,
        "p90_ms": float(np.percentile(times, 90)) * 1e3,
        "launch_p50_ms": float(np.median(launch)) * 1e3,
    } for (op, algo, n), (times, launch) in samples.items()]


# -- the command-ring sequencer (row 14) -----------------------------------

SEQ_N = 1 << 20  # elements per rank of the sequencer checks (4 MiB f32)


def seq_counts(op: int, N: int, P: int):
    """(count, fuse) of a slot whose operand per rank stays within N."""
    from accl_tpu_torch.constants import CmdOpcode as Op

    if op in (Op.REDUCE_SCATTER, Op.FUSED_MATMUL_RS, Op.ALLTOALL,
              Op.ALLGATHER):
        return max(N // P, 1), 1 if op == Op.FUSED_MATMUL_RS else 0
    if op == Op.FUSED_APPLY:
        return max(N // (P + 1), 1), 2
    if op == Op.FUSED_ATTN_HOP:
        return max(N // 2, 1), 3
    return N, 0


def seq_window(P, dtype, ops, N, seed, wires=None, offset=0,
               skew_rank=None):
    """A window of ``ops`` ((opcode, root, peer) per slot), every slot with
    its own operands and results, made from ``seed`` (the same seed makes
    the same window).  SUM and MAX alternate by slot; floats carry NaNs.
    ``offset`` misaligns every operand by that many elements; with
    ``skew_rank`` only that rank's operands and results, by one element
    (each rank decides its own alignment in the kernel)."""
    import torch

    from accl_tpu_torch.cmdring import (WindowShape, encode_fparam,
                                        encode_slot, ring_widths)
    from accl_tpu_torch.constants import (CmdOpcode as Op, Operation,
                                          torch_to_dtype)
    from accl_tpu_torch.ops.cuda.cmdring import result_width

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rand(n, off=offset):
        if dtype == torch.int32:
            x = torch.randint(-2**31, 2**31 - 1, (n + off,),
                              generator=gen, device=dev, dtype=dtype)
        else:
            x = torch.randn(n + off, generator=gen, device=dev).to(dtype)
            x[::997] = float("nan")
        return x[off:]

    def skew(r):
        return 1 if r == skew_rank else 0

    base = {Op.ALLGATHER: Operation.ALLGATHER,
            Op.REDUCE_SCATTER: Operation.REDUCE_SCATTER,
            Op.FUSED_MATMUL_RS: Operation.REDUCE_SCATTER,
            Op.ALLTOALL: Operation.ALLTOALL, Op.BARRIER: Operation.BARRIER}
    slots, xs, outs, in_ws, out_ws, wl = [], [], [], [], [], []
    for i, (op, root, peer) in enumerate(ops):
        n, fuse = seq_counts(op, N, P)
        if op == Op.BARRIER:
            n = 1
        in_w, out_w = ring_widths(base.get(op, Operation.ALLREDUCE), n, P,
                                  fuse)
        wire = wires[i % len(wires)] if wires else None
        slots.append(encode_slot(
            100 + i, op, n, dtype=int(torch_to_dtype(dtype)),
            function=i % 2, root=root, peer=peer,
            wire=0 if wire is None else int(torch_to_dtype(wire)),
            fparam=encode_fparam(0.375) if fuse else 0))
        if op == Op.BARRIER:
            xs.append([None] * P)
            outs.append([None] * P)
        else:
            xs.append([rand(in_w, offset + skew(r)) for r in range(P)])
            outs.append([torch.zeros(result_width(in_w, out_w, P) + skew(r),
                                     dtype=dtype, device=dev)[skew(r):]
                         for r in range(P)])
        in_ws.append(in_w)
        out_ws.append(out_w)
        wl.append(wire)
    import numpy as np

    return (np.stack(slots), xs, outs,
            WindowShape(len(ops), in_ws, out_ws, wl, dtype))


def hazard_window(P, dtype, N, seed):
    """In-place allreduce, reduce-scatter, MPI allgather, alltoall and
    bcast, then a slot writing what an earlier one reads (WAR) and two
    slots writing one buffer (WAW).  Returns the window and every buffer
    it touches."""
    import numpy as np
    import torch

    from accl_tpu_torch.cmdring import WindowShape, encode_slot
    from accl_tpu_torch.constants import CmdOpcode as Op

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = N // P

    def rand(m):
        return torch.randn(m, generator=gen, device=dev).to(dtype)

    ar, rs, ag, a2a, bc, c, d, e, f, x = (
        [rand(m) for _ in range(P)]
        for m in (N, P * n, P * n, P * n, N, N, N, N, N, N))
    slots = [encode_slot(i, op, cnt, root=root) for i, (op, cnt, root) in
             enumerate([(Op.ALLREDUCE, N, 0), (Op.REDUCE_SCATTER, n, 0),
                        (Op.ALLGATHER, n, 0), (Op.ALLTOALL, n, 0),
                        (Op.BCAST, N, P - 1), (Op.ALLREDUCE, N, 0),
                        (Op.ALLREDUCE, N, 0), (Op.ALLREDUCE, N, 0),
                        (Op.BCAST, N, 1)])]
    xs = [ar, rs, [g[r * n:(r + 1) * n] for r, g in enumerate(ag)], a2a,
          bc, c, e, x, e]
    outs = [ar, [t[:n] for t in rs], ag, a2a, bc, d,
            c,   # WAR: slot 5 read c
            f, f]  # WAW: slots 7 and 8 both write f
    shape = WindowShape(9, (N, P * n, n, P * n, N, N, N, N, N),
                        (N, n, P * n, P * n, N, N, N, N, N), (None,) * 9,
                        dtype)
    return (np.stack(slots), xs, outs, shape,
            ar + rs + ag + a2a + bc + c + d + e + f + x)


def inplace_window(P, dtype, N, seed):
    """Every result in place over its rank's operand, in the forms the
    kernel keeps: reduce-scatter, fused apply, matmul-reduce-scatter and
    the attention hop at their chunk 0, send / recv, the MPI in-place
    allgather and alltoall (above 4 ranks the wrapper stages the hop's
    operands).  Returns the window and every buffer it touches."""
    import numpy as np
    import torch

    from accl_tpu_torch.cmdring import (WindowShape, encode_fparam,
                                        encode_slot)
    from accl_tpu_torch.constants import CmdOpcode as Op

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = N // (P + 1)

    def rand(m):
        x = torch.randn(m, generator=gen, device=dev).to(dtype)
        x[::991] = float("nan")
        return x

    fp = encode_fparam(0.375)
    rs, ap, mm, at_, sr, ag, a2a = ([rand(m) for _ in range(P)] for m in (
        P * n, (P + 1) * n, P * n, 2 * n, n, P * n, P * n))
    spec = [(Op.REDUCE_SCATTER, n, P * n, n, 0, 0),
            (Op.FUSED_APPLY, n, (P + 1) * n, n, fp, 0),
            (Op.FUSED_MATMUL_RS, n, P * n, n, fp, 0),
            (Op.FUSED_ATTN_HOP, n, 2 * n, n, fp, 1),
            (Op.SEND, n, n, n, 0, P - 1),
            (Op.ALLGATHER, n, n, P * n, 0, 0),
            (Op.ALLTOALL, n, P * n, P * n, 0, 0)]
    slots = [encode_slot(i, op, cnt, function=i % 2, root=1, peer=peer,
                         fparam=f)
             for i, (op, cnt, _, _, f, peer) in enumerate(spec)]
    xs = [rs, ap, mm, at_, sr,
          [g[r * n:(r + 1) * n] for r, g in enumerate(ag)], a2a]
    outs = [[t[:n] for t in rs], [t[:n] for t in ap], [t[:n] for t in mm],
            [t[:n] for t in at_], sr, ag, a2a]
    shape = WindowShape(len(spec), [s_[2] for s_ in spec],
                        [s_[3] for s_ in spec], (None,) * len(spec), dtype)
    return (np.stack(slots), xs, outs, shape,
            rs + ap + mm + at_ + sr + ag + a2a)


def check_sequencer(err) -> None:
    """Phase 2 for row 14: the sequencer kernel against sequencer_plain,
    exactly, results and status words, over P {2, 3, 4, 8, 12, 16},
    windows of depth 1, 8 and 64 (512 rank-slots) mixing every opcode
    class, four dtypes under each wire (none, bf16, f16), SUM and MAX
    with NaNs, ragged and misaligned operands (every rank, or one rank's
    operands and results), the aliasing hazards (a barrier: the
    cooperative launch) and every in-place form."""
    import torch

    from accl_tpu_torch.constants import CmdOpcode as Op
    from accl_tpu_torch.ops.cuda import cmdring as kseq

    F32, BF16, F16, I32 = (torch.float32, torch.bfloat16, torch.float16,
                           torch.int32)

    def mix(P, floats=True):
        ops = [(Op.ALLREDUCE, 0, 0), (Op.ALLREDUCE, 0, 0),
               (Op.BCAST, 0, 0), (Op.BCAST, P - 1, 0),
               (Op.REDUCE_SCATTER, 0, 0), (Op.ALLGATHER, 0, 0),
               (Op.ALLTOALL, 0, 0), (Op.BARRIER, 0, 0), (Op.NOP, 0, 0),
               (0x7F, 0, 0),  # an opcode outside the enum: BAD_OP
               (Op.SEND, 1, P - 1), (Op.RECV, 0, 1)]
        if floats:
            ops += [(Op.FUSED_APPLY, 0, 0), (Op.FUSED_MATMUL_RS, 0, 0),
                    (Op.FUSED_ATTN_HOP, 0, 1),
                    (Op.FUSED_ATTN_HOP, 0, P - 1)]
        return ops

    cases = []  # (tag, window maker)
    for P in (2, 4, 8):
        for dtype in (F32, BF16, F16, I32):
            ops = mix(P, dtype != I32)
            cases.append((f"P={P} {dtype} depth 8 x2",
                          lambda s, P=P, d=dtype, o=ops: seq_window(
                              P, d, o[:8], SEQ_N, s)))
            cases.append((f"P={P} {dtype} depth 8 tail",
                          lambda s, P=P, d=dtype, o=ops: seq_window(
                              P, d, o[8:] + o[:8 - len(o[8:])], SEQ_N, s)))
        for dtype in (F32, I32):
            ops = mix(P, dtype != I32)
            cases.append((f"P={P} {dtype} depth 64",
                          lambda s, P=P, d=dtype, o=ops: seq_window(
                              P, d, (o * 7)[:64], 4096, s)))
    for op in mix(4):
        cases.append((f"P=4 f32 depth 1 opcode {op[0]} peer {op[2]}",
                      lambda s, op=op: seq_window(4, F32, [op], SEQ_N, s)))
    for P, wires in ((4, [BF16]), (4, [F16]), (8, [BF16, F16])):
        cases.append((f"P={P} f32 wires {wires}",
                      lambda s, P=P, w=wires: seq_window(
                          P, F32, mix(P, False)[:8], SEQ_N, s, wires=w)))
    cases += [
        ("P=4 f32 ragged", lambda s: seq_window(4, F32, mix(4)[:8],
                                                 1_000_003, s)),
        ("P=4 bf16 ragged", lambda s: seq_window(4, BF16, mix(4)[6:],
                                                  1_000_003, s)),
        ("P=4 f32 misaligned", lambda s: seq_window(4, F32, mix(4)[4:12],
                                                     SEQ_N, s, offset=1)),
        ("P=2 f16 misaligned", lambda s: seq_window(2, F16, mix(2)[:8],
                                                     SEQ_N, s, offset=1)),
    ]
    for P, dtype in ((4, F32), (8, F32), (4, BF16), (2, F16)):
        cases.append((f"P={P} {dtype} hazards",
                      lambda s, P=P, d=dtype: hazard_window(P, d, SEQ_N, s)))
    # the tile redesign's paths: P = 3 and above 8 ranks (the folds take
    # ranks in groups of 8), every class under every wire and payload, one
    # rank's views off 16 bytes, columns past the last whole tile, every
    # in-place form
    for dtype in (F32, BF16, F16, I32):
        ops = mix(3, dtype != I32)
        cases.append((f"P=3 {dtype} every class",
                      lambda s, d=dtype, o=ops: seq_window(
                          3, d, o, SEQ_N + 5, s)))
        for wire in (BF16, F16):
            ops = mix(4, dtype != I32)
            cases.append((f"P=4 {dtype} wire {wire} every class",
                          lambda s, d=dtype, o=ops, w=wire: seq_window(
                              4, d, o, SEQ_N, s, wires=[w])))
    for P, dtype, skew in ((4, F32, 2), (3, BF16, 0), (8, F16, 7),
                           (2, I32, 1)):
        cases.append((f"P={P} {dtype} rank {skew} off 16 bytes",
                      lambda s, P=P, d=dtype, k=skew: seq_window(
                          P, d, mix(P, d != I32), 4099, s, skew_rank=k)))
    for P in (16, 12):
        cases.append((f"P={P} f32 every class",
                      lambda s, P=P: seq_window(P, F32, mix(P), 65_536 + 7,
                                                s, wires=[None, BF16])))
    for P, dtype, N in ((2, F32, SEQ_N // 4 + 3), (3, BF16, SEQ_N // 4 + 3),
                        (4, F32, 5 * 65_536), (4, F32, SEQ_N // 4 + 3),
                        (8, F16, SEQ_N // 4 + 3), (16, F32, 17 * 4096)):
        cases.append((f"P={P} {dtype} N={N} in place",
                      lambda s, P=P, d=dtype, N=N: inplace_window(P, d, N,
                                                                  s)))
    for k, (tag, build) in enumerate(cases):
        got = build(SEED + k)
        want = build(SEED + k)
        before = kseq.sequencer.launches.count
        st = kseq.sequencer(*got[:4], device=torch.device("cuda", 0))
        if kseq.sequencer.launches.count == before:
            fail(f"sequencer {tag}: the kernel did not launch")
        st_plain = kseq.sequencer_plain(*want[:4])
        torch.cuda.synchronize()
        if not torch.equal(st.cpu(), st_plain.cpu()):
            fail(f"sequencer {tag}: status words {st.tolist()} vs "
                 f"{st_plain.tolist()}")
        if len(got) > 4:  # the hazard windows: every buffer they touch
            pairs = zip(got[4], want[4])
        else:
            pairs = ((o, w) for rg, rw in zip(got[2], want[2])
                     for o, w in zip(rg, rw) if o is not None)
        for i, (o, w) in enumerate(pairs):
            err["sequencer"] = max(err["sequencer"], compare(
                f"sequencer {tag} tensor {i}", o, w))
        del got, want
        torch.cuda.synchronize()
    print(f"sequencer: {len(cases)} windows agree with sequencer_plain",
          flush=True)


def batch_main_path(kc) -> dict:
    """Phase 3c: ``with a.batch():`` windows on ``cuda_group(4)`` at 256 KiB
    and 4 MiB per rank.  Window A: allreduce SUM and MAX, bcast root 2,
    reduce_scatter, allgather, alltoall, barrier, fused_apply; window B:
    fused_matmul_reduce_scatter, fused_attn_hop.  Each is checked against
    numpy and must show one refill of all its slots, no fallback, one
    sequencer launch and no other kernel launch.  Returns the launch
    counts over the windows."""
    import numpy as np

    import accl_tpu_torch as at

    P = P_MAIN
    totals = {k: 0 for k in kc.KERNELS}
    group = at.cuda_group(P)
    ring = group[0].engine.gang.cmdring
    try:
        for nbytes in (256 * 1024, 4 * 1024 * 1024):
            N = nbytes // 4
            n_rs, n_ap, n_at = N // P, N // (P + 1), N // 2
            rng = np.random.default_rng(SEED + 2)
            data = rng.standard_normal((P, N), dtype=np.float32)
            grads = rng.standard_normal((P, P * n_ap), dtype=np.float32)
            params = rng.standard_normal((P, n_ap), dtype=np.float32)
            kvq = rng.standard_normal((P, 2 * n_at), dtype=np.float32)

            def fold(rows):
                acc = rows[0].copy()
                for row in rows[1:]:
                    acc = acc + row
                return acc

            total = fold(data)
            gsum = fold(grads)
            bufs = {}

            def window_a(a, r):
                b = bufs[r] = dict(
                    s=a.create_buffer_from(data[r]),
                    ar=a.create_buffer(N, np.float32),
                    mx=a.create_buffer(N, np.float32),
                    bc=a.create_buffer_from(data[r].copy()),
                    rs=a.create_buffer(n_rs, np.float32),
                    ag=a.create_buffer(P * n_rs, np.float32),
                    a2=a.create_buffer(N, np.float32),
                    fa=a.create_buffer_from(
                        np.concatenate([grads[r], params[r]])),
                    fo=a.create_buffer(n_ap, np.float32),
                )
                with a.batch():
                    reqs = [
                        a.allreduce(b["s"], b["ar"], run_async=True),
                        a.allreduce(b["s"], b["mx"], function=1,
                                    run_async=True),
                        a.bcast(b["bc"], root=2, run_async=True),
                        a.reduce_scatter(b["s"], b["rs"], n_rs,
                                         run_async=True),
                        a.allgather(b["s"], b["ag"], n_rs, run_async=True),
                        a.alltoall(b["s"], b["a2"], run_async=True),
                        a.barrier(run_async=True),
                        a.fused_apply(b["fa"], b["fo"], n_ap, lr=0.5,
                                      run_async=True),
                    ]
                for q in reqs:
                    if not q.wait(120) or not q.ring_resident:
                        raise RuntimeError(f"{q.op_name} off the ring")
                    q.check()

            def window_b(a, r):
                b = bufs[r]
                b["mm"] = a.create_buffer_from(data[r][:P * n_rs])
                b["mo"] = a.create_buffer(n_rs, np.float32)
                b["at"] = a.create_buffer_from(kvq[r])
                b["ao"] = a.create_buffer(n_at, np.float32)
                with a.batch():
                    reqs = [
                        a.fused_matmul_reduce_scatter(
                            b["mm"], b["mo"], n_rs, scale=0.25,
                            run_async=True),
                        a.fused_attn_hop(b["at"], b["ao"], hop=1,
                                         count=n_at, scale=2.0,
                                         run_async=True),
                    ]
                for q in reqs:
                    if not q.wait(120) or not q.ring_resident:
                        raise RuntimeError(f"{q.op_name} off the ring")
                    q.check()

            for name, work, nslots in (("A", window_a, 8),
                                       ("B", window_b, 2)):
                for k in kc.KERNELS.values():
                    k.launches.reset()
                st0 = ring.stats()
                run_ranks(group, work, f"batch window {name}")
                launches = {k: f.launches.count
                            for k, f in kc.KERNELS.items()}
                st1 = ring.stats()
                delta = {k: st1[k] - st0[k] for k in ("refills", "slots")}
                fb = {k: v - st0["fallbacks"].get(k, 0)
                      for k, v in st1["fallbacks"].items()
                      if v != st0["fallbacks"].get(k, 0)}
                print(f"batch window {name} at {nbytes} B/rank: {delta}, "
                      f"fallbacks {fb}, launches {launches}", flush=True)
                others = {k: v for k, v in launches.items()
                          if k != "sequencer" and v}
                if (delta != {"refills": 1, "slots": nslots} or fb
                        or launches["sequencer"] != 1 or others):
                    fail(f"batch window {name}: {delta} {fb} {launches}")
                for k, v in launches.items():
                    totals[k] += v

            def host(buf):
                buf.sync_from_device()
                return buf.data

            chunk = lambda x, r, m: x[r * m:(r + 1) * m]  # noqa: E731
            for r in range(P):
                b = bufs[r]
                checks = {
                    "allreduce": (host(b["ar"]), total),
                    "allreduce MAX": (host(b["mx"]),
                                      np.maximum.reduce(data)),
                    "bcast": (host(b["bc"]), data[2]),
                    "reduce_scatter": (host(b["rs"]), chunk(total, r, n_rs)),
                    "allgather": (host(b["ag"]),
                                  data[:, :n_rs].reshape(-1)),
                    "alltoall": (host(b["a2"]), np.concatenate(
                        [chunk(data[j], r, n_rs) for j in range(P)])),
                    "fused_apply": (host(b["fo"]), params[r] - np.float32(
                        0.5) * chunk(gsum, r, n_ap)),
                    "fused_matmul_reduce_scatter": (
                        host(b["mo"]),
                        np.float32(0.25) * chunk(fold(data[:, :P * n_rs]),
                                                 r, n_rs)),
                    "fused_attn_hop": (
                        host(b["ao"]), (kvq[r][n_at:] * kvq[(r - 1) % P][
                            :n_at]) * np.float32(2.0)),
                }
                for what, (got, want) in checks.items():
                    if not np.array_equal(got, want):
                        fail(f"batch {what} rank {r} at {nbytes} B/rank "
                             f"differs from numpy")
    finally:
        for a in group:
            a.deinit()
    return totals


def refused_windows() -> dict:
    """Phase 3d: windows the ring refuses (oversized at 8 MiB per rank, a
    reduce inside the batch, an allreduce_algorithm register of
    pallas_ring) give correct results with their reason counted."""
    import numpy as np

    import accl_tpu_torch as at

    P = P_MAIN
    group = at.cuda_group(P)
    ring = group[0].engine.gang.cmdring
    counted = {}
    try:
        for reason in ("oversized", "unsupported_op", "tuning_override"):
            N = 2 * 1024 * 1024 if reason == "oversized" else 64 * 1024
            rng = np.random.default_rng(SEED + 3)
            data = rng.standard_normal((P, N), dtype=np.float32)
            exact = data.astype(np.float64).sum(0)
            got = {}

            def work(a, r):
                if reason == "tuning_override":
                    a.set_tuning("allreduce_algorithm", "pallas_ring")
                s = a.create_buffer_from(data[r])
                d1 = a.create_buffer(N, np.float32)
                d2 = a.create_buffer(N, np.float32)
                with a.batch():
                    reqs = [a.allreduce(s, d1, run_async=True)]
                    if reason == "unsupported_op":
                        reqs.append(a.reduce(s, d2 if r == 0 else None,
                                             root=0, run_async=True))
                    else:
                        reqs.append(a.allreduce(s, d2, run_async=True))
                for q in reqs:
                    q.wait(120)
                    q.check()
                a.set_tuning("allreduce_algorithm", "xla")
                d1.sync_from_device()
                d2.sync_from_device()
                got[r] = (d1.data.copy(), d2.data.copy())

            before = dict(ring.stats()["fallbacks"])
            run_ranks(group, work, f"refused window {reason}")
            after = ring.stats()["fallbacks"]
            counted[reason] = after.get(reason, 0) - before.get(reason, 0)
            if counted[reason] != 1:
                fail(f"refused window {reason}: counted {after}")
            for r in range(P):
                outs = got[r] if (reason != "unsupported_op" or r == 0) \
                    else got[r][:1]
                for o in outs:
                    if not np.allclose(o, exact, rtol=1e-5, atol=1e-5):
                        fail(f"refused window {reason} rank {r}: wrong")
    finally:
        for a in group:
            a.deinit()
    print(f"refused windows counted: {counted}", flush=True)
    return counted


def time_sequencer(rand) -> dict:
    """Phase 4 for row 14: the windows of the bounds table at P = 4."""
    import numpy as np
    import torch

    from accl_tpu_torch.cmdring import WindowShape, encode_slot
    from accl_tpu_torch.constants import CmdOpcode as Op
    from accl_tpu_torch.ops.cuda import cmdring as kseq

    P, F32 = P_MAIN, torch.float32

    def allreduce_window(N):
        xs = [[rand(N, F32) for _ in range(P)] for _ in range(8)]
        outs = [[torch.empty(N, device=x[0].device) for x in xs[0]]
                for _ in range(8)]
        slots = np.stack([encode_slot(i, Op.ALLREDUCE, N) for i in range(8)])
        shape = WindowShape(8, (N,) * 8, (N,) * 8, (None,) * 8, F32)
        return slots, xs, outs, shape

    def window_bytes(slots, xs, outs, shape):
        """Each operand the slots read once, each result written once."""
        read = write = ops = 0
        for w, row_x, row_o, in_w in zip(slots, xs, outs, shape.in_ws):
            op = int(w[1])
            if op == Op.BARRIER:
                continue
            used = 1 if op == Op.BCAST else P
            read += used * in_w * 4
            write += sum(o.numel() for o in row_o if o is not None) * 4
            if op in (Op.ALLREDUCE, Op.REDUCE_SCATTER, Op.FUSED_APPLY,
                      Op.FUSED_MATMUL_RS):
                ops += (P - 1) * in_w
        return read + write, ops

    def library(xs, outs):
        for row_x, row_o in zip(xs, outs):
            acc = torch.stack(row_x).sum(0)
            for o in row_o:
                o.copy_(acc)

    out = {}
    for key, win in (("", allreduce_window(SEQ_N)),
                     ("window_64k_", allreduce_window(64 * 1024))):
        nbytes, ops = window_bytes(*win)
        out[key + "ms"] = time_ms(lambda: kseq.sequencer(*win))
        out[key + "device_ms"] = device_ms(lambda: kseq.sequencer(*win))
        out[key + "plain_ms"] = time_ms(lambda: kseq.sequencer_plain(*win))
        out[key + "library_ms"] = time_ms(lambda: library(win[1], win[2]))
        out[key + "library_device_ms"] = device_ms(
            lambda: library(win[1], win[2]))
        out[key + "bound"] = bound(nbytes, ops)
        del win
    mix_ops = [(Op.ALLREDUCE, 0, 0), (Op.ALLREDUCE, 0, 0), (Op.BCAST, 2, 0),
               (Op.REDUCE_SCATTER, 0, 0), (Op.ALLGATHER, 0, 0),
               (Op.ALLTOALL, 0, 0), (Op.BARRIER, 0, 0),
               (Op.FUSED_APPLY, 0, 0)]
    win = seq_window(P, F32, mix_ops, SEQ_N, SEED + 4)
    nbytes, ops = window_bytes(*win)
    out["mix_4mib_ms"] = time_ms(lambda: kseq.sequencer(*win))
    out["mix_4mib_device_ms"] = device_ms(lambda: kseq.sequencer(*win))
    out["mix_4mib_plain_ms"] = time_ms(lambda: kseq.sequencer_plain(*win))
    out["mix_4mib_bound"] = bound(nbytes, ops)
    return out


def facade_batch_latency(sizes, iters: int = 20) -> list:
    """p50 and p90 of one batched window of 8 allreduces per rank, and of
    the same 8 calls unbatched, on rank 0's host clock (rendezvous and
    device time included); every pair runs twice over, the second pass
    kept."""
    import numpy as np

    import accl_tpu_torch as at

    samples = {}

    def rank_main(a, r):
        bufs = {n: (a.create_buffer(n, np.float32),
                    [a.create_buffer(n, np.float32) for _ in range(8)])
                for n in sizes}
        for _pass in range(2):
            for n, (s, ds) in bufs.items():
                for mode in ("batched", "unbatched"):
                    times = []
                    for _ in range(iters):
                        t = time.perf_counter()
                        if mode == "batched":
                            with a.batch():
                                reqs = [a.allreduce(s, d, run_async=True)
                                        for d in ds]
                            for q in reqs:
                                q.wait(60)
                                q.check()
                        else:
                            for d in ds:
                                a.allreduce(s, d)
                        times.append(time.perf_counter() - t)
                    if r == 0:
                        samples[(mode, n)] = times

    group = at.cuda_group(P_MAIN)
    try:
        run_ranks(group, rank_main, "facade batch timing")
        if group[0].engine.gang.cmdring.stats()["fallbacks"]:
            fail("facade batch timing: a window fell back")
    finally:
        for a in group:
            a.deinit()
    return [{
        "mode": mode, "calls": 8, "bytes_per_rank": 4 * n,
        "p50_ms": float(np.median(t)) * 1e3,
        "p90_ms": float(np.percentile(t, 90)) * 1e3,
    } for (mode, n), t in samples.items()]


# -- the transformer's serving path (row 16) --------------------------------

#: bench.py's serving configuration (bench.py:681-685): tp = 1 on one card
SERVE = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8, d_ff=8192,
             max_seq=1024)
SERVE_B, SERVE_T, SERVE_STEPS, SERVE_LONG = 8, 128, 128, 1024
#: run B's bfloat16 logits, flash against naive: the two lowerings round
#: the attention output to bfloat16 after different fold orders, and 8
#: layers carry those one-ulp differences to the logits
BF16_LOGIT_ATOL = 0.1
#: (B, H, Hkv, T, D, dtype name, causal, with_lse): phase 2's flash cases
FLASH_CASES = [
    (8, 16, 16, 128, 128, "bfloat16", True, True),    # run A's prefill
    (8, 16, 16, 1024, 128, "bfloat16", True, False),  # run B
    (2, 16, 4, 1024, 128, "bfloat16", True, False),   # GQA
    (2, 4, 4, 1000, 128, "float32", True, True),      # ragged
    (2, 4, 4, 512, 64, "float32", False, False),      # full
    (1, 2, 2, 50, 24, "float16", True, False),        # ragged T and D
]


#: the kernels whose 16-bit launches take a wgmma kernel (rows 16, 15, 17
#: and 18), each counting those in ``wgmma_launches`` beside ``launches``
WGMMA_KERNELS = ("flash_attention", "ring_attention",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def reset_launches(kc) -> None:
    for k in kc.KERNELS.values():
        k.launches.reset()
    for name in WGMMA_KERNELS:
        kc.KERNELS[name].wgmma_launches.reset()


def all_wgmma(kc, what: str) -> dict:
    """Every launch of rows 15-18 since the counters were zeroed was
    16-bit and took the wgmma kernel; returns the wgmma launches."""
    got = {}
    for name in WGMMA_KERNELS:
        f = kc.KERNELS[name]
        got[name] = f.wgmma_launches.count
        if got[name] != f.launches.count:
            fail(f"{what}: {f.launches.count} {name} launches, "
                 f"{got[name]} of them through the wgmma kernel")
    return got


def read_launches(kc) -> dict:
    return {k: f.launches.count for k, f in kc.KERNELS.items()}


def flash_launched_alone(launches: dict, want: int, what: str) -> None:
    """``want`` flash launches in the run and no other kernel's."""
    others = {k: v for k, v in launches.items()
              if k != "flash_attention" and v}
    if launches["flash_attention"] != want or others:
        fail(f"{what}: launches {launches}, want {want} flash_attention "
             f"and no other kernel")


def check_flash(kc, err) -> None:
    """Phase 2 for row 16: the kernel against flash_attention_plain on the
    card.  Tolerances: float32 atol = rtol = 2e-5 (the JAX tests' own,
    tests/test_pallas.py:689-691: the two fold in other orders); bf16/f16
    atol = rtol = 1e-2 on o (the kernel folds 64-key tiles, the plain
    version the TPU kernel's 512-key tiles, so an output may round to the
    neighbouring 16-bit value); lse atol 1e-4."""
    import torch

    from accl_tpu_torch.ops.cuda import attention as ka

    dev = torch.device("cuda", 0)
    for i, (B, H, Hkv, T, D, dt, causal, lse) in enumerate(FLASH_CASES):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 10 + i)
        q, k, v = (torch.randn(B, h, T, D, generator=gen, device=dev)
                   .to(dtype) for h in (H, Hkv, Hkv))
        tag = f"flash (B,H,Hkv,T,D)={(B, H, Hkv, T, D)} {dt} causal={causal}"
        before = ka.flash_attention.launches.count
        wgmma = ka.flash_attention.wgmma_launches.count
        got = ka.flash_attention(q, k, v, causal, with_lse=lse)
        if ka.flash_attention.launches.count != before + 1:
            fail(f"{tag}: the kernel did not launch")
        if ka.flash_attention.wgmma_launches.count != wgmma + (
                dtype != torch.float32):
            fail(f"{tag}: 16-bit launches take the wgmma kernel, float32 "
                 f"ones the FFMA kernel")
        want = ka.flash_attention_plain(q, k, v, causal, with_lse=lse)
        torch.cuda.synchronize()
        if lse:
            (got, got_lse), (want, want_lse) = got, want
            d = float((got_lse - want_lse).abs().max())
            if not d <= 1e-4:
                fail(f"{tag}: lse differs by {d}")
        tol = 2e-5 if dtype == torch.float32 else 1e-2
        if got.shape != want.shape or not torch.isfinite(got).all() or \
                not torch.allclose(got.float(), want.float(), rtol=tol,
                                   atol=tol):
            fail(f"{tag}: max abs err "
                 f"{float((got.float() - want.float()).abs().max())}")
        err["flash_attention"] = max(
            err["flash_attention"],
            float((got.float() - want.float()).abs().max()))
        del q, k, v, got, want
    flash_views(ka, dev, err)
    # a call that needs a gradient runs the autograd Function: the
    # forward with its LSE, then the dQ and dK/dV kernels once each
    q = torch.randn(1, 2, 32, 16, device=dev, requires_grad=True)
    before = read_launches(kc)
    ka.flash_attention(q, q, q).sum().backward()
    moved = {k: n - before[k] for k, n in read_launches(kc).items()
             if n != before[k]}
    if moved != dict.fromkeys(TRAIN_KERNELS, 1) or \
            not torch.isfinite(q.grad).all():
        fail(f"flash_attention with a gradient launched {moved}")
    torch.cuda.synchronize()
    print(f"flash_attention: {len(FLASH_CASES)} cases agree with "
          f"flash_attention_plain (max abs err {err['flash_attention']})",
          flush=True)


def flash_views(ka, dev, err) -> None:
    """Phase 2 for row 16's operands: the wgmma kernel reads them through
    TMA where they lie.  The transformer's head tensors, (B, T, H D)
    projections viewed as (B, H, T, D) (``models/transformer.py``
    ``heads``), take no copy; a base misaligned by one element, and a head
    dim of 20 (40-byte rows), are copied first, one counted copy
    (``attention.tma_copies``) an operand.  Each within the 16-bit
    tolerances of ``check_flash`` of the plain version."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x = randn(2, 1024, 3 * 16 * 128)
    heads = [t.reshape(2, 1024, 16, 128).transpose(1, 2)
             for t in x.split(16 * 128, dim=2)]
    misaligned = [randn(2, 4, 200, 129)[..., 1:] for _ in range(3)]
    narrow = [randn(1, 4, 200, 20, dtype=torch.float16) for _ in range(3)]
    for tag, (q, k, v), copies in (("transposed view", heads, 0),
                                   ("misaligned view", misaligned, 3),
                                   ("head dim 20", narrow, 3)):
        counts = (ka.flash_attention.launches.count,
                  ka.flash_attention.wgmma_launches.count,
                  ka.tma_copies.count)
        got, got_lse = ka.flash_attention(q, k, v, True, with_lse=True)
        moved = (ka.flash_attention.launches.count - counts[0],
                 ka.flash_attention.wgmma_launches.count - counts[1],
                 ka.tma_copies.count - counts[2])
        if moved != (1, 1, copies):
            fail(f"flash {tag}: (launches, wgmma launches, copies) {moved}, "
                 f"want (1, 1, {copies})")
        want, want_lse = ka.flash_attention_plain(q, k, v, True,
                                                  with_lse=True)
        torch.cuda.synchronize()
        d = float((got_lse - want_lse).abs().max())
        if not d <= 1e-4:
            fail(f"flash {tag}: lse differs by {d}")
        e = float((got.float() - want.float()).abs().max())
        if got.shape != want.shape or not torch.isfinite(got).all() or \
                not torch.allclose(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2):
            fail(f"flash {tag}: max abs err {e}")
        err["flash_attention"] = max(err["flash_attention"], e)
    print("flash_attention: transposed views read in place, misaligned and "
          "narrow operands copied (3 copies each), all within tolerance",
          flush=True)


def serve_setup():
    """The serving configuration, its random weights from the seed, and
    the two prompts: ``(cfg, params, prompt (8, 128), long (8, 1024))``.
    Phase 3d frees them before the training path takes the card, and
    phase 5 makes them again, equal, from the same seed."""
    import torch

    from accl_tpu_torch.models import TransformerConfig, init_params

    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash", **SERVE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_T), generator=gen,
                           device=dev, dtype=torch.int32)
    long = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LONG), generator=gen,
                         device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    return cfg, params, prompt, long


def serve_main_path(kc) -> dict:
    """Phase 3d: the serving path at bench.py's width (472M parameters,
    bfloat16, random weights from a seeded generator).  Run A: ``generate``
    under ``attention="flash"``, prompt (8, 128), 128 steps; run B:
    ``prefill`` of (8, 1024) under ``"auto"``.  Each launches flash 8 times
    (once a layer) and no other kernel, counters zeroed before and read
    after.  Then the checks: run B's logits under flash against naive (the
    same weights in float32 within 1e-4 relative, and in bfloat16), and 32
    greedy float32 steps of the first 2 layers under flash against naive,
    tie-aware.  Returns the launches and what phase 5 needs."""
    import dataclasses

    import torch

    from accl_tpu_torch.models import forward, generate, prefill

    cfg, params, prompt, long = serve_setup()

    reset_launches(kc)
    tokens = generate(params, prompt, SERVE_STEPS, cfg)
    torch.cuda.synchronize()
    run_a = read_launches(kc)
    flash_launched_alone(run_a, cfg.n_layers, "run A (generate)")
    all_wgmma(kc, "run A (generate)")
    if tokens.shape != (SERVE_B, SERVE_STEPS) or tokens.dtype != torch.int32 \
            or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab:
        fail(f"run A: tokens {tokens.dtype}{tuple(tokens.shape)} in "
             f"[{int(tokens.min())}, {int(tokens.max())}]")

    auto = dataclasses.replace(cfg, attention="auto")
    reset_launches(kc)
    with torch.no_grad():
        logits_b, _ = prefill(params, long, auto)
    torch.cuda.synchronize()
    run_b = read_launches(kc)
    flash_launched_alone(run_b, cfg.n_layers, "run B (prefill, auto)")
    all_wgmma(kc, "run B (prefill, auto)")
    print(f"serving path ok: run A {run_a['flash_attention']} and run B "
          f"{run_b['flash_attention']} flash launches, every one through the "
          f"wgmma kernel, no other kernel", flush=True)

    # run B's logits, flash against naive: bfloat16 as run, then the same
    # weights in float32
    naive = dataclasses.replace(cfg, attention="naive")
    with torch.no_grad():
        ref_b, _ = prefill(params, long, naive)
        if not torch.isfinite(logits_b).all():
            fail("run B: non-finite logits")
        bf16_err = float((logits_b.float() - ref_b.float()).abs().max())
        bf16_scale = float(ref_b.float().abs().max())
        p32 = {k: ([{n: w.float() for n, w in lp.items()} for lp in v]
                   if k == "layers" else v.float())
               for k, v in params.items()}
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        l32, _ = prefill(p32, long, c32)
        r32, _ = prefill(p32, long, dataclasses.replace(c32,
                                                        attention="naive"))
        f32_rel = float((l32 - r32).abs().max() / r32.abs().max())
    print(f"run B logits, flash vs naive: bfloat16 max abs diff {bf16_err} "
          f"(max |logit| {bf16_scale}); float32 max rel diff {f32_rel}",
          flush=True)
    if not f32_rel <= 1e-4:
        fail(f"run B float32 logits: flash vs naive {f32_rel} > 1e-4 rel")
    if not bf16_err <= BF16_LOGIT_ATOL:
        fail(f"run B bfloat16 logits: flash vs naive {bf16_err} > "
             f"{BF16_LOGIT_ATOL}")
    del ref_b, l32, r32

    # greedy float32, 2 layers: tokens equal, or at the first step where a
    # row's tokens differ its two top naive logits lie within 1e-5
    c2 = dataclasses.replace(c32, n_layers=2)
    p2 = dict(p32, layers=p32["layers"][:2])
    steps = 32
    got = generate(p2, prompt, steps, c2)
    want = generate(p2, prompt, steps, dataclasses.replace(
        c2, attention="naive"))
    ties = 0
    for r in range(SERVE_B):
        diff = (got[r] != want[r]).nonzero()
        if not len(diff):
            continue
        i = int(diff[0])
        seq = torch.cat([prompt[r], want[r, :i]])[None]
        with torch.no_grad():
            top = forward(p2, seq, dataclasses.replace(
                c2, attention="naive"))[0, -1].topk(2).values
        gap = float(top[0] - top[1])
        if not gap <= 1e-5:
            fail(f"float32 greedy row {r}: step {i} differs, top-2 gap {gap}")
        ties += 1
    print(f"float32 greedy, 2 layers x {steps} steps: flash == naive on "
          f"{SERVE_B - ties} rows, {ties} rows part at a tie", flush=True)
    del p32, p2, params
    torch.cuda.synchronize()
    return dict(launches={k: run_a[k] + run_b[k] for k in run_a},
                run_a=run_a["flash_attention"],
                run_b=run_b["flash_attention"], bf16_logit_err=bf16_err,
                bf16_logit_scale=bf16_scale, f32_logit_rel=f32_rel,
                greedy_f32_ties=ties)


def time_flash() -> dict:
    """Phase 4 for row 16 at the serving shapes: (8, 16, T, 128) bf16
    causal at T = 128 (run A's prefill) and T = 1024 (run B)."""
    import torch
    import torch.nn.functional as F

    from accl_tpu_torch.ops.cuda import attention as ka

    dev = torch.device("cuda", 0)
    out = {}
    for T in (SERVE_T, SERVE_LONG):
        q, k, v = (torch.randn(8, 16, T, 128, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        pairs = T * (T + 1) // 2  # the causal (q, k) pairs this run needs
        out[T] = dict(
            ms=time_ms(lambda: ka.flash_attention(q, k, v), iters=20),
            device_ms=device_ms(lambda: ka.flash_attention(q, k, v),
                                iters=20),
            plain_ms=time_ms(lambda: ka.flash_attention_plain(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), iters=20),
            library_device_ms=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                iters=20),
            bytes=4 * q.numel() * q.element_size(),  # q, k, v read, o written
            ops=4 * 8 * 16 * 128 * pairs,  # QK^T and PV, 2 ops a product
        )
        del q, k, v
    return out


def print_attention_fwd(by_name, t1024, train, ring) -> None:
    """Phase 4's lines for rows 16 and 15 at the main paths' shapes: the
    wrapper's time (CUDA events around the calls, host path included), the
    kernel's device time (``device_ms``), its rate over the causal pairs
    the run needs, its bound and the share of the bound it reaches, and
    ``scaled_dot_product_attention`` on the same work in the same run."""
    f, r = by_name["flash_attention"], ring
    rows = [
        ("row 16 (8,32,1024,128) bf16 causal + LSE", train["ms"],
         train["device_ms"], train["ops"], f["train_bound_ms"],
         train["library_ms"], train["library_device_ms"]),
        ("row 16 (8,16,1024,128) bf16 causal", t1024["ms"],
         t1024["device_ms"], t1024["ops"], f["t1024_bound_ms"],
         t1024["library_ms"], t1024["library_device_ms"]),
        ("row 16 (8,16,128,128) bf16 causal", f["ms"], f["device_ms"],
         4 * SERVE_B * 16 * 128 * SERVE_T * (SERVE_T + 1) // 2,
         f["bound_ms"], f["library_ms"], f["library_device_ms"]),
        ("row 15 4 x (2,32,1024,128) bf16 contiguous causal", r["ms"],
         r["device_ms"], r["ops"], by_name["ring_attention"]["bound_ms"],
         r["library_ms"], r["library_device_ms"]),
        ("row 15 striped causal", r["striped_ms"], r["striped_device_ms"],
         r["ops"], by_name["ring_attention"]["bound_ms"], r["library_ms"],
         r["library_device_ms"]),
        ("row 15 contiguous full", r["full_ms"], r["full_device_ms"],
         r["full_ops"], by_name["ring_attention"]["full_bound_ms"],
         r["full_library_ms"], r["full_library_device_ms"]),
    ]
    for name, ms, dms, ops, bnd, lib, lib_d in rows:
        print(f"{name}: kernel_ms={ms:.4f} device_ms={dms:.4f} "
              f"tflops={ops / dms / 1e9:.1f} bound_ms={bnd:.4f} "
              f"of_bound={bnd / dms:.3f} sdpa_ms={lib:.4f} "
              f"sdpa_device_ms={lib_d:.4f}", flush=True)


def serve_timing(serve) -> dict:
    """Phase 5 for the serving path, on weights made again from the seed:
    run A's prefill ms and decode step
    p50 (host clock around each synchronised call), decode tokens/s (8 x
    128 over ``generate``'s wall time, 3 timed runs with distinct prompts
    after a warm-up), and run B's prefill ms."""
    import numpy as np
    import torch

    from accl_tpu_torch.models import generate, prefill
    from accl_tpu_torch.models.transformer import _decode_step

    cfg, params, prompt, long = serve_setup()

    def wall(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return times

    with torch.no_grad():
        prefill(params, prompt, cfg, cache_len=SERVE_T + SERVE_STEPS)
        pre_a = wall(lambda: prefill(params, prompt, cfg,
                                     cache_len=SERVE_T + SERVE_STEPS), 10)
        logits, caches = prefill(params, prompt, cfg,
                                 cache_len=SERVE_T + SERVE_STEPS)
        tok = logits.argmax(-1)
        steps = []
        for i in range(SERVE_STEPS - 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tok = _decode_step(params, caches, tok, SERVE_T + i,
                               cfg).argmax(-1)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t)
        prefill(params, long, cfg)
        pre_b = wall(lambda: prefill(params, long, cfg), 5)
    generate(params, prompt, SERVE_STEPS, cfg)  # warm-up
    prompts = [torch.full_like(prompt, i + 1) for i in range(3)]
    gen_s = []
    for p in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(params, p, SERVE_STEPS, cfg)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t)
    mean_s = float(np.mean(gen_s))
    return {
        "batch": SERVE_B, "prompt": SERVE_T, "steps": SERVE_STEPS,
        "params": sum(w.numel() for w in [params["embed"], params["pos"],
                                          params["ln_f"]]
                      + [w for lp in params["layers"] for w in lp.values()]),
        "dtype": "bfloat16", "attention": "flash",
        "prefill_ms": float(np.median(pre_a)) * 1e3,
        "decode_step_p50_ms": float(np.median(steps)) * 1e3,
        "decode_step_p90_ms": float(np.percentile(steps, 90)) * 1e3,
        "generate_s": gen_s,
        "decode_tokens_per_s": SERVE_B * SERVE_STEPS / mean_s,
        "prefill_1024_ms": float(np.median(pre_b)) * 1e3,
        "prefill_1024_tokens_per_s": SERVE_B * SERVE_LONG
        / float(np.median(pre_b)),
        "run_b_bf16_logit_max_abs_diff": serve["bf16_logit_err"],
        "run_b_max_abs_logit": serve["bf16_logit_scale"],
        "run_b_f32_logit_max_rel_diff": serve["f32_logit_rel"],
        "greedy_f32_rows_parted_at_a_tie": serve["greedy_f32_ties"],
    }


# -- the transformer's training path (rows 16-18) ---------------------------

#: bench.py's training configuration (bench.py:310-317): tp = 1 on one card
TRAIN = dict(vocab=32768, d_model=4096, n_heads=32, n_layers=6, d_ff=16384,
             max_seq=1024)
TRAIN_B, TRAIN_T, TRAIN_LR, TRAIN_STEPS = 8, 1024, 0.01, 3
#: the kernels a train step launches, each once a layer
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_delta",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
#: the kernels bounded by the tensor cores' bf16 rate (the rest by the
#: float32 rate outside them, or by their bytes)
TC_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "ring_attention")
#: bfloat16 at full width, flash against naive: the two lowerings round
#: the attention output and its gradients to bfloat16 after different
#: fold orders, and 6 layers carry those one-ulp differences through the
#: backward pass
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_RTOL = 5e-2  # relative Frobenius, per gradient tensor
#: phase 2's backward cases: FLASH_CASES and the training shape
FLASH_BWD_CASES = FLASH_CASES + [
    (8, 32, 32, 1024, 128, "bfloat16", True, True),
    (2, 4, 1, 200, 64, "bfloat16", False, True),   # MQA
]


def ptxas_report(kc) -> list:
    """Registers and spill-store bytes of the flash kernels that the
    training and sequence-parallel paths run (bf16, head dim 128), from
    ptxas's lines in the build logs, and, for the four wgmma kernels (rows
    16, 15, 17 and 18), their dynamic shared memory: ``[[kernel,
    registers, spill bytes(, shared bytes)], ...]``.  Fails when a wgmma
    kernel spills, or ptxas serialised its wgmmas (C7513, C7512), or its
    library's SASS holds no HGMMA (``cuobjdump -sass``)."""
    import os
    import re

    found, entry = {}, None
    for lib in ("attention", "attention_bwd", "ring_attention"):
        for line in kc._build.build_log(lib).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                found[entry] = [None, None]
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                found[entry][0] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and entry:
                found[entry][1] = int(m.group(1))
            if ("C7513" in line or "C7512" in line) and "wgmma" in line:
                fail(f"ptxas serialised the wgmmas of csrc/{lib}.cu: {line}")
    rows = [[re.search(r"\d((?:flash|ring_attention)_[a-z0-9_]+?)I",
                       e).group(1), *v]
            for e, v in found.items() if "13__nv_bfloat16Li128E" in e]
    if not rows:
        fail("no ptxas register counts in the flash kernels' build logs")
    cuobjdump = os.path.join(os.path.dirname(kc._build.nvcc()), "cuobjdump")
    for lib, kernels, smem_fn in (
            ("attention", ("flash_fwd_wgmma",), "accl_wgmma_smem"),
            ("ring_attention", ("ring_attention_wgmma",), "accl_wgmma_smem"),
            ("attention_bwd", ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"),
             "accl_flash_bwd_smem")):
        so = kc._build.library(lib, kc.attention.PROTOTYPES[lib])
        smem = getattr(so, smem_fn)(128)
        for kernel in kernels:
            for r in rows:
                if r[0] == kernel:
                    r.append(smem)
                    if r[2] != 0:
                        fail(f"{kernel} spills {r[2]} bytes")
            if not any(r[0] == kernel for r in rows):
                fail(f"no ptxas line for {kernel}")
        sass = subprocess.run([cuobjdump, "-sass",
                               str(kc._build._lib_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        n = sass.count("HGMMA")
        if not n:
            fail(f"csrc/{lib}.cu's SASS holds no HGMMA")
        rows.append([f"{lib}: HGMMA in SASS", n])
    return rows


def cast_ptxas(kc) -> dict:
    """Row 5's cast kernels (one per source/target pair) in ptxas's lines
    of ``csrc/compression.cu``'s build log: their count, the least and
    most registers, the most spill-store bytes, and float32 -> bfloat16's
    registers."""
    import re

    found, entry = {}, None
    for line in kc._build.build_log("compression").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if "11cast_kernel" in m.group(1) else None
            if entry:
                found[entry] = [0, 0]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            found[entry][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            found[entry][0] = int(m.group(1))
    if not found:
        fail("no ptxas lines for row 5's cast kernels")
    regs = [v[0] for v in found.values()]
    f32_bf16 = [v[0] for e, v in found.items()
                if "3F32E" in e and "4BF16E" in e
                and e.index("3F32E") < e.index("4BF16E")]
    return {"kernels": len(found), "registers_min": min(regs),
            "registers_max": max(regs),
            "spill_bytes_max": max(v[1] for v in found.values()),
            "f32_bf16_registers": f32_bf16[0] if f32_bf16 else None}


def tile_ptxas(kc) -> dict:
    """The streaming tile core's kernels in ptxas's lines of their build
    logs, by ``TILE_KERNELS`` name, and the sequencer's and the quantize's
    (its LANES and CLUSTER paths): the count of instantiations, the least
    and most registers, and the most spill-store bytes and stack frame
    bytes, which must both be 0 (phase 1)."""
    import re

    mangled = {"ring_allgather": ("ring", "21ring_allgather_kernel"),
               "ring_gather": ("ring", "23ring_gather_root_kernel"),
               "combine": ("combine", "14combine_kernel"),
               "ring_scatter": ("rooted", "19ring_scatter_kernel"),
               "fused_shift": ("put", "16fused_put_kernel"),
               # rows 14 and 7, redesigned on the same access shape
               "sequencer": ("cmdring", "16sequencer_kernel"),
               "quantize_lanes": ("compression", "21quantize_lanes_kernel"),
               "quantize_cluster": ("compression",
                                    "23quantize_cluster_kernel")}
    out = {}
    for name, (lib, tag) in mangled.items():
        found, entry = [], None
        for line in kc._build.build_log(lib).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = tag in m.group(1)
                if entry:
                    found.append([0, 0, 0])
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
            if m and entry:
                found[-1][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                found[-1][0] = int(m.group(1))
        if not found:
            fail(f"no ptxas lines for {name}'s kernels")
        regs = [f[0] for f in found]
        out[name] = {"kernels": len(found), "registers_min": min(regs),
                     "registers_max": max(regs),
                     "stack_bytes_max": max(f[1] for f in found),
                     "spill_bytes_max": max(f[2] for f in found)}
        if out[name]["stack_bytes_max"] or out[name]["spill_bytes_max"]:
            fail(f"{name}'s kernels keep a stack frame or spill: "
                 f"{out[name]}")
    return out


def check_combine(rand, err) -> None:
    """K4 against its plain version, exactly (phase 2): the main path's
    64M elements per dtype, SUM and MAX with NaNs, in place and not, and
    float32 into bfloat16 / float16; then every operand dtype into every
    ``out_dtype`` at odd and ragged lengths, aligned and misaligned by one
    element (the tile core's scalar path and its tail)."""
    import torch

    from accl_tpu_torch.ops import cuda as kc

    SUM, MAX = 0, 1
    F32, BF16, F16, I32 = (torch.float32, torch.bfloat16, torch.float16,
                           torch.int32)
    every = (F16, F32, torch.float64, I32, torch.int64, BF16)

    def operand(n, dtype, nans=slice(None, None, 997)):
        if dtype in (I32, torch.int64):
            return rand(n, I32).to(dtype)
        x = rand(n, F32).to(dtype)
        x[nans] = float("nan")
        return x

    b_nans = slice(5, None, 1009)  # NaNs where ``a`` has none, for MAX

    def held(tag, got, want):
        err["combine"] = max(err["combine"], compare(tag, got, want))

    for dtype in (F32, BF16, F16, I32):
        a, b = operand(N_COMBINE, dtype), operand(N_COMBINE, dtype, b_nans)
        for fn in (SUM, MAX):
            tag = f"combine {dtype} {fn}"
            want = kc.combine_plain(a, b, fn)
            held(tag, kc.combine(a, b, fn), want)
            acc = a.clone()
            kc.combine(acc, b, fn, accumulate=True)
            held(tag + " accumulate", acc, want)
        if dtype == F32:
            for out_dtype in (BF16, F16):
                held(f"combine f32->{out_dtype}",
                     kc.combine(a, b, SUM, out_dtype),
                     kc.combine_plain(a, b, SUM, out_dtype))
        del a, b, acc, want
        torch.cuda.synchronize()
    for dtype in every:
        for n in (1, 255, 257, 1_000_003):
            base_a = operand(n + 1, dtype)
            base_b = operand(n + 1, dtype, b_nans)
            for offset in (0, 1):
                a, b = base_a[offset:offset + n], base_b[offset:offset + n]
                for fn in (SUM, MAX):
                    for out_dtype in every:
                        held(f"combine {dtype}->{out_dtype} n={n} "
                             f"offset={offset} {fn}",
                             kc.combine(a, b, fn, out_dtype),
                             kc.combine_plain(a, b, fn, out_dtype))
                    acc = base_a.clone()[offset:offset + n]
                    kc.combine(acc, b, fn, accumulate=True)
                    held(f"combine {dtype} n={n} offset={offset} "
                         f"accumulate {fn}", acc, kc.combine_plain(a, b, fn))
    torch.cuda.synchronize()


def check_flash_bwd(err) -> None:
    """Phase 2 for rows 17-18 and the delta pass: the delta, dQ and dK/dV
    kernels against their plain versions on the card, on the kernel
    forward's o and lse, each launching once a call, the 16-bit dQ and
    dK/dV through their wgmma kernels (``wgmma_launches``); a bf16 case
    twice, the same bits both times (every output written by one block,
    no atomics).  Tolerances: delta within 1e-5 of each row's sum of
    magnitudes (float32 sums in another order); dQ, dK, dV float32 rtol
    2e-4, atol 2e-5 (the JAX gradient tests' own, tests/test_pallas.py:771:
    the kernels fold 64-row tiles in other orders than the plain versions'
    512); bf16/f16 max abs difference within 1e-2 of the plain gradient's
    largest entry and relative Frobenius difference within 1e-3 (a
    rounding of p or ds to the 16-bit dtype may land one ulp apart and
    carry into the product)."""
    import torch

    from accl_tpu_torch.ops.cuda import attention as ka

    dev = torch.device("cuda", 0)
    kernels = (ka.flash_attention_bwd_delta, ka.flash_attention_bwd_dq,
               ka.flash_attention_bwd_dkv)
    wgmma = (ka.flash_attention_bwd_dq, ka.flash_attention_bwd_dkv)
    repeated = False
    for i, (B, H, Hkv, T, D, dt, causal, _) in enumerate(FLASH_BWD_CASES):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 30 + i)
        q, k, v = (torch.randn(B, h, T, D, generator=gen, device=dev)
                   .to(dtype) for h in (H, Hkv, Hkv))
        do = torch.randn(B, H, T, D, generator=gen, device=dev).to(dtype)
        o, lse = ka.flash_attention(q, k, v, causal, with_lse=True)
        tag = (f"flash backward (B,H,Hkv,T,D)={(B, H, Hkv, T, D)} {dt} "
               f"causal={causal}")
        before = [f.launches.count for f in kernels]
        wbefore = [f.wgmma_launches.count for f in wgmma]
        delta = ka.flash_attention_bwd_delta(do, o)
        got = (ka.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
               *ka.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
        if [f.launches.count for f in kernels] != [n + 1 for n in before]:
            fail(f"{tag}: the kernels did not launch once each")
        if [f.wgmma_launches.count for f in wgmma] != [
                n + (dtype != torch.float32) for n in wbefore]:
            fail(f"{tag}: 16-bit launches take the wgmma kernels, float32 "
                 f"ones the FFMA kernels")
        plain = ka.flash_attention_bwd_delta_plain(do, o)
        mag = (do.float() * o.float()).abs().sum(-1)
        d = float((delta - plain).abs().max())
        if delta.shape != plain.shape or not bool(
                ((delta - plain).abs() <= 1e-5 * mag).all()):
            fail(f"{tag}: delta differs from its plain version by {d}")
        err["flash_attention_bwd_delta"] = max(
            err["flash_attention_bwd_delta"], d)
        if dtype == torch.bfloat16 and not repeated:
            again = (ka.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               causal),
                     *ka.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{tag}: a repeated backward gave other bits")
            repeated = True
            del again
        want = (ka.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                causal),
                *ka.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  causal))
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dkv", "dkv"), got, want):
            g, w = g.float(), w.float()
            d = float((g - w).abs().max())
            if g.shape != w.shape or not torch.isfinite(g).all():
                fail(f"{tag}: {name} {tuple(g.shape)} non-finite or "
                     f"misshapen")
            if dtype == torch.float32:
                ok = torch.allclose(g, w, rtol=2e-4, atol=2e-5)
            else:
                ok = (d <= 1e-2 * float(w.abs().max())
                      and float((g - w).norm() / w.norm()) <= 1e-3)
            if not ok:
                fail(f"{tag}: {name} max abs err {d}")
            key = f"flash_attention_bwd_{name}"
            err[key] = max(err[key], d)
        del q, k, v, do, o, lse, delta, plain, mag, got, want
    if not repeated:
        fail("flash backward: no bfloat16 case ran twice")
    torch.cuda.synchronize()
    print(f"flash backward: {len(FLASH_BWD_CASES)} cases agree with the "
          f"plain versions (max abs err delta "
          f"{err['flash_attention_bwd_delta']}, dq "
          f"{err['flash_attention_bwd_dq']}, dk/dv "
          f"{err['flash_attention_bwd_dkv']}); 16-bit cases through the "
          f"wgmma kernels; a bfloat16 backward repeated bit for bit",
          flush=True)


def loss_and_grads(params, tokens, targets, cfg):
    """``loss_fn`` and its gradient with respect to every parameter, in
    the tree's leaf order (the parameters are left untouched)."""
    import torch

    from accl_tpu_torch.models import loss_fn
    from accl_tpu_torch.models.transformer import _tree_leaves, _tree_map

    live = [p.detach().requires_grad_() for p in _tree_leaves(params)]
    it = iter(live)
    loss = loss_fn(_tree_map(lambda _: next(it), params), tokens, targets,
                   cfg)
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), grads


def leaf_names(tree, prefix="") -> list:
    """The dotted names of a parameter tree's leaves, in leaf order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def grad_gap(loss_a, grads_a, loss_b, grads_b, names) -> tuple:
    """(relative loss difference, the largest relative Frobenius
    difference over the gradient tensors, that tensor's name), b the
    reference."""
    rel = [float((a.float() - b.float()).norm() / b.float().norm())
           for a, b in zip(grads_a, grads_b)]
    i = max(range(len(rel)), key=rel.__getitem__)
    return abs(loss_a - loss_b) / abs(loss_b), rel[i], names[i]


def train_main_path(kc) -> dict:
    """Phase 3e: the training path at bench.py's training width (1,346M
    parameters, bfloat16, random weights and tokens from a seeded
    generator, targets the tokens rolled by one), ``TRAIN_STEPS`` steps of
    ``make_sharded_train_step`` under ``attention="auto"`` (flash on the
    card at T = 1024).  Each step launches the flash forward, dQ and dK/dV
    kernels once a layer and no other kernel, counters zeroed before and
    read after.  Then the checks: ``loss_fn`` and its gradients under
    flash against naive, in bfloat16 at full width and in float32 at
    bench's widths with 2 layers and batch 2 (TF32 off), and the float32
    step's update against p - lr g.  Returns what phases 4 and 5 need."""
    import dataclasses

    import torch

    from accl_tpu_torch.models import (TransformerConfig, init_params,
                                       make_sharded_train_step)
    from accl_tpu_torch.models.transformer import _tree_leaves, _tree_map

    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="auto", **TRAIN)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    step, shard = make_sharded_train_step(cfg, lr=TRAIN_LR)
    params = shard(init_params(cfg, gen))
    tokens = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_T), generator=gen,
                           device=dev, dtype=torch.int32)
    targets = tokens.roll(-1, dims=1)
    n_params = sum(p.numel() for p in _tree_leaves(params))
    torch.cuda.synchronize()

    reset_launches(kc)
    losses, per_step = [], []
    for _ in range(TRAIN_STEPS):
        before = read_launches(kc)
        params, loss = step(params, tokens, targets)
        losses.append(float(loss))
        per_step.append({k: n - before[k]
                         for k, n in read_launches(kc).items()})
    torch.cuda.synchronize()
    launches = read_launches(kc)
    wgmma = all_wgmma(kc, "train steps")
    want = {k: (cfg.n_layers if k in TRAIN_KERNELS else 0)
            for k in kc.KERNELS}
    for i, got in enumerate(per_step):
        if got != want:
            fail(f"train step {i}: launches {got}, want {want}")
    if not all(map(math.isfinite, losses)) or not all(
            bool(torch.isfinite(p).all()) for p in _tree_leaves(params)):
        fail(f"train steps: losses {losses} or parameters not finite")
    print(f"training path ok: {TRAIN_STEPS} steps, losses {losses}, "
          f"{cfg.n_layers} launches a step of each of {TRAIN_KERNELS}, "
          f"no other kernel", flush=True)

    # bfloat16 at full width: flash against naive on the trained weights
    naive = dataclasses.replace(cfg, attention="naive")
    lf, gf = loss_and_grads(params, tokens, targets, cfg)
    if not all(bool(torch.isfinite(g).all()) for g in gf):
        fail("bfloat16 flash gradients not finite")
    ln, gn = loss_and_grads(params, tokens, targets, naive)
    bf16_loss_rel, bf16_grad_rel, worst = grad_gap(lf, gf, ln, gn,
                                                   leaf_names(params))
    del gf, gn
    print(f"bfloat16 loss_fn, flash vs naive at full width: loss {lf} vs "
          f"{ln} ({bf16_loss_rel} rel), gradients max rel (Frobenius) "
          f"{bf16_grad_rel} ({worst})", flush=True)
    if not bf16_loss_rel <= BF16_LOSS_RTOL:
        fail(f"bfloat16 loss: flash vs naive {bf16_loss_rel} > "
             f"{BF16_LOSS_RTOL} rel")
    if not bf16_grad_rel <= BF16_GRAD_RTOL:
        fail(f"bfloat16 gradients: flash vs naive {bf16_grad_rel} > "
             f"{BF16_GRAD_RTOL} rel")

    # float32 at bench's widths, 2 layers, batch 2
    c32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=2)
    p32 = _tree_map(lambda p: p.float(),
                    dict(params, layers=params["layers"][:2]))
    t2, y2 = tokens[:2], targets[:2]
    lf, gf = loss_and_grads(p32, t2, y2, c32)
    ln, gn = loss_and_grads(p32, t2, y2,
                            dataclasses.replace(c32, attention="naive"))
    f32_loss_rel, f32_grad_rel, worst = grad_gap(lf, gf, ln, gn,
                                                 leaf_names(p32))
    del gn
    print(f"float32 loss_fn, flash vs naive, 2 layers x batch 2: loss "
          f"{lf} vs {ln} ({f32_loss_rel} rel), gradients max rel "
          f"(Frobenius) {f32_grad_rel} ({worst})", flush=True)
    if not f32_loss_rel <= 1e-5:
        fail(f"float32 loss: flash vs naive {f32_loss_rel} > 1e-5 rel")
    if not f32_grad_rel <= 1e-4:
        fail(f"float32 gradients: flash vs naive {f32_grad_rel} > 1e-4 rel")
    # the step's update is p - lr g of those gradients, computed the same
    # way: equal but for run-to-run sums (the embedding's gradient adds
    # rows with atomics, and a changed last bit of g may flip the rounding
    # of p - lr g by one ulp of p), so within 1e-3 of the update's norm
    step32, shard32 = make_sharded_train_step(c32, lr=TRAIN_LR)
    new32, _ = step32(shard32(p32), t2, y2)
    upd_rel = max(
        float((n - (p - TRAIN_LR * g)).norm() / (TRAIN_LR * g).norm())
        for n, p, g in zip(_tree_leaves(new32), _tree_leaves(p32), gf)
        if float(g.norm()) > 0)
    print(f"float32 step: updated params vs p - lr g, max rel {upd_rel}",
          flush=True)
    if not upd_rel <= 1e-3:
        fail(f"float32 step: updated params differ from p - lr g by "
             f"{upd_rel} of the update")
    del p32, gf, new32
    torch.cuda.synchronize()
    return dict(launches=launches, wgmma=wgmma, step=step, params=params,
                tokens=tokens, targets=targets, cfg=cfg, n_params=n_params,
                losses=losses,
                per_step={k: per_step[0][k] for k in TRAIN_KERNELS},
                bf16_loss_rel=bf16_loss_rel, bf16_grad_rel=bf16_grad_rel,
                f32_loss_rel=f32_loss_rel, f32_grad_rel=f32_grad_rel,
                f32_update_rel=upd_rel)


def time_flash_bwd() -> dict:
    """Phase 4 for rows 16-18 at the training shape (8, 32, 1024, 128)
    bf16 causal: the forward with LSE, the delta pass, dQ and dK/dV, each
    beside its plain version, by CUDA events around the wrapper and by
    device time alone (``device_ms``); and ``scaled_dot_product_attention``'s
    forward and its backward (dQ, dK and dV in one call)."""
    import torch
    import torch.nn.functional as F

    from accl_tpu_torch.ops.cuda import attention as ka

    dev = torch.device("cuda", 0)
    B, H, T, D = TRAIN_B, TRAIN["n_heads"], TRAIN_T, 128
    q, k, v, do = (torch.randn(B, H, T, D, device=dev, dtype=torch.bfloat16)
                   for _ in range(4))
    o, lse = ka.flash_attention(q, k, v, True, with_lse=True)
    delta = ka.flash_attention_bwd_delta(do, o)
    sq, sk, sv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    pairs = B * H * T * (T + 1) // 2  # the causal (q, k) pairs, all heads
    act = q.numel() * q.element_size()  # bytes of one (B, H, T, D) tensor
    stats = 4 * B * H * T  # bytes of lse or delta
    out = {
        "fwd": dict(
            ms=time_ms(lambda: ka.flash_attention(q, k, v, True,
                                                  with_lse=True), iters=20),
            device_ms=device_ms(lambda: ka.flash_attention(
                q, k, v, True, with_lse=True), iters=20),
            plain_ms=time_ms(lambda: ka.flash_attention_plain(
                q, k, v, True, with_lse=True)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), iters=20),
            library_device_ms=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                iters=20),
            bytes=4 * act + stats, ops=4 * D * pairs),
        "flash_attention_bwd_dq": dict(
            ms=time_ms(lambda: ka.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, True), iters=20),
            device_ms=device_ms(lambda: ka.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, True), iters=20),
            plain_ms=time_ms(lambda: ka.flash_attention_bwd_dq_plain(
                q, k, v, do, lse, delta, True)),
            bytes=5 * act + 2 * stats, ops=3 * 2 * D * pairs),
        "flash_attention_bwd_dkv": dict(
            ms=time_ms(lambda: ka.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, True), iters=20),
            device_ms=device_ms(lambda: ka.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, True), iters=20),
            plain_ms=time_ms(lambda: ka.flash_attention_bwd_dkv_plain(
                q, k, v, do, lse, delta, True)),
            bytes=6 * act + 2 * stats, ops=4 * 2 * D * pairs),
        # no one PyTorch call forms rowsum(dO O) in float32 from 16-bit
        # operands (its products would round to bfloat16 first)
        "flash_attention_bwd_delta": dict(
            ms=time_ms(lambda: ka.flash_attention_bwd_delta(do, o),
                       iters=20),
            device_ms=device_ms(lambda: ka.flash_attention_bwd_delta(do, o),
                                iters=20),
            plain_ms=time_ms(lambda: ka.flash_attention_bwd_delta_plain(
                do, o), iters=20),
            library_ms=None, bytes=2 * act + stats, ops=2 * B * H * T * D),
        "library_bwd_ms": time_ms(lambda: torch.autograd.grad(
            so, (sq, sk, sv), do, retain_graph=True), iters=20),
        "library_bwd_device_ms": device_ms(lambda: torch.autograd.grad(
            so, (sq, sk, sv), do, retain_graph=True), iters=20),
    }
    del q, k, v, do, o, lse, delta, sq, sk, sv, so
    return out


#: kernel-name fragments (lower case) -> the class a profiled step's
#: device time is counted under; the first match wins, "other" takes the
#: rest (layer norms, gelu, residual adds, casts, the embedding, the
#: delta pass)
KERNEL_CLASSES = (
    ("flash", ("flash_fwd", "flash_bwd")),
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass")),
    ("log_softmax", ("softmax",)),
    ("sgd_update", ("foreach", "multi_tensor")),
)


def train_profile(train) -> dict:
    """One train step under ``torch.profiler`` (CPU and CUDA activities):
    the device's kernel time summed by ``KERNEL_CLASSES``, the flash class
    by kernel (forward, delta, dQ, dK/dV), its busy time against the
    step's wall time (host clock, synchronised), the idle share, and the
    ten costliest kernels.  Device times are None when the profiler
    records no device event."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, params = train["step"], train["params"]
    tokens, targets = train["tokens"], train["targets"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, tokens, targets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    by_class["other"] = 0.0
    kernels, flash = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        kernels[e.name] = kernels.get(e.name, 0.0) + ms
        low = e.name.lower()
        cls = next((name for name, keys in KERNEL_CLASSES
                    if any(key in low for key in keys)), "other")
        by_class[cls] += ms
        if cls == "flash":
            m = re.search(r"(flash_\w+?)[<(]", e.name)
            key = m.group(1) if m else e.name[:40]
            flash[key] = flash.get(key, 0.0) + ms
    busy = sum(by_class.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms": wall_ms,
        "device_ms_by_class": by_class if busy else None,
        "flash_kernels_ms": flash if busy else None,
        "device_busy_ms": busy or None,
        "idle_share": 1.0 - busy / wall_ms if busy else None,
        "top_kernels_ms": [[name[:80], ms] for name, ms in top],
    }


def train_timing(train) -> dict:
    """Phase 5 for the training path: bench.py's measure
    (bench.py:343-350), one warm-up step, then the mean of 10 steps timed
    together with one synchronise at the end; then 10 steps each
    synchronised for p50 and p90, and one more under the profiler
    (:func:`train_profile`).  ``train_tflops`` counts bench.py's 6 N B T
    operations a step (bench.py:337-341) over the mean, ``train_mfu``
    that over 989 TFLOP/s."""
    import numpy as np
    import torch

    step, params = train["step"], train["params"]
    tokens, targets, cfg = train["tokens"], train["targets"], train["cfg"]
    params, loss = step(params, tokens, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(10):
        params, loss = step(params, tokens, targets)
    float(loss)
    mean_s = (time.perf_counter() - t) / 10
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, loss = step(params, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    flops = 6.0 * train["n_params"] * TRAIN_B * TRAIN_T
    profiled = train_profile(train)
    return {
        "batch": TRAIN_B, "seq": TRAIN_T, "params": train["n_params"],
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "dtype": "bfloat16", "attention": "auto", "lr": TRAIN_LR,
        "step_ms": mean_s * 1e3,
        "step_p50_ms": float(np.median(times)) * 1e3,
        "step_p90_ms": float(np.percentile(times, 90)) * 1e3,
        "tokens_per_s": TRAIN_B * TRAIN_T / mean_s,
        "train_tflops": flops / mean_s / 1e12,
        "train_mfu": flops / mean_s / TC16_OPS_PER_S,
        "peak_memory_gb": peak / 1e9,
        "launches_per_step": train["per_step"],
        "main_path_losses": train["losses"], "last_loss": float(loss),
        "bf16_flash_vs_naive_loss_rel": train["bf16_loss_rel"],
        "bf16_flash_vs_naive_grad_rel": train["bf16_grad_rel"],
        "f32_flash_vs_naive_loss_rel": train["f32_loss_rel"],
        "f32_flash_vs_naive_grad_rel": train["f32_grad_rel"],
        "f32_update_vs_lr_grad_rel": train["f32_update_rel"],
        "profiled_step": profiled,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }


# -- the compressed wire (rows 5-8) -----------------------------------------

N_COMP = 32 * 1024 * 1024  # the Pallas tier's timing size (bench.py:153)
WIRE_LANES = ("float16", "bfloat16", "float8_e4m3fn", "float8_e5m2", "int8")
COMP_KERNELS = ("cast", "stochastic_cast", "quantize_int8", "dequantize_int8")
_BITS = {1: "uint8", 2: "int16", 4: "int32"}


def compare_bits(name: str, got, want) -> float:
    """Bit-for-bit agreement (NaN bits included); returns the max abs
    difference, 0 when equal."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: {got.dtype}{tuple(got.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    bits = getattr(torch, _BITS[got.element_size()])
    same = got.contiguous().view(bits) == want.contiguous().view(bits)
    if not bool(same.all()):
        fail(f"{name}: {int((~same).sum())} elements differ in their bits "
             f"from the plain version")
    return 0.0


def compare_bits_nan(name: str, got, want) -> float:
    """Bit for bit where neither side is NaN (signed zeros included), NaN
    where NaN: a NaN's payload, rounded to 16 bits, differs between
    PyTorch's conversion and the _rn intrinsics.  Returns 0."""
    import torch

    if not got.is_floating_point():
        return compare_bits(name, got, want)
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: {got.dtype}{tuple(got.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    gn, wn = torch.isnan(got), torch.isnan(want)
    if not bool((gn == wn).all()):
        fail(f"{name}: {int((gn != wn).sum())} elements NaN on one side "
             f"only")
    keep = ~gn
    return compare_bits(name, got[keep], want[keep])


def special_values(dev):
    """NaN of both signs, infinities, signed zeros, float32 and target
    subnormals, the fp8 overflow edges and ties."""
    import torch

    return torch.tensor([
        float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0,
        1e-40, -1e-40, 2.0 ** -9, 2.0 ** -10, 2.0 ** -16, 2.0 ** -17,
        448.0, 464.0, 464.0001, 480.0, -1e6, 57344.0, 61439.0, 61440.0,
        65504.0, 65520.0, 1.0 + 2.0 ** -8, 3e38,
    ], device=dev)


def comp_operand(n, dtype, gen, dev, specials=True):
    """n elements of ``dtype``: normals at several scales, an all-zero
    segment (scale 1e-30) and, where there is room, the special values;
    fp8 operands are random bytes (every encoding, NaN included)."""
    import torch

    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return torch.randint(0, 256, (n,), generator=gen, device=dev,
                             dtype=torch.uint8).view(dtype)
    scale = torch.tensor([1e-6, 1e-3, 1.0, 40.0], device=dev)
    x = torch.randn(n, generator=gen, device=dev) * scale[
        torch.randint(0, 4, (n,), generator=gen, device=dev)]
    if n >= 1024:
        x[512:768] = 0.0
    if specials:
        sv = special_values(dev)
        x[:min(n, sv.numel())] = sv[:min(n, sv.numel())]
    return x.to(dtype)


def check_compression(kc, err, gen, dev) -> None:
    """Phase 2 for rows 5-8: each kernel against its plain version bit for
    bit at n = 1, 255, 257, 1,000,003 and 32Mi, every lane pair, seeds 0
    and nonzero; then the device wire codec on the card against the host
    codec (``accl_tpu_torch.wire``, numpy), byte for byte, per lane and
    seed."""
    import torch

    from accl_tpu_torch import wire as hw
    from accl_tpu_torch.ops import wire as dw

    kc_ = kc.compression
    F32, BF16 = torch.float32, torch.bfloat16
    lanes = kc_.CAST_DTYPES
    for n in (1, 255, 257, 1_000_003, N_COMP):
        big = n == N_COMP
        for src in lanes:
            x = comp_operand(n, src, gen, dev)
            for dst in lanes:
                if dst == src or (big and src != F32):
                    continue
                for un in ((False, True) if src == torch.float8_e5m2
                           else (False,)):
                    tag = f"cast {src}->{dst} n={n} e5m2_nan_unsigned={un}"
                    err["cast"] = max(err["cast"], compare_bits(
                        tag, kc_.cast_rows([x], dst, e5m2_nan_unsigned=un)[0],
                        kc_.cast_plain(x, dst, un)))
        for src in kc_.SR_SOURCES:
            x = comp_operand(n, src, gen, dev)
            for dst in kc_.SR_TARGETS:
                dt = at_dtype(dst)
                drop, tiny = hw.dropped_mantissa_bits(dt), hw.lane_tiny(dt)
                for seed in (0, 0x9E3779B9):
                    if big and (src != F32 or dst != BF16 and not seed):
                        continue
                    tag = f"stochastic_cast {src}->{dst} n={n} seed={seed}"
                    err["stochastic_cast"] = max(
                        err["stochastic_cast"], compare_bits(
                            tag, kc_.stochastic_cast_rows(
                                [x], dst, [seed], drop, tiny)[0],
                            kc_.stochastic_cast_plain(x, dst, seed, drop,
                                                      tiny)))
            if src == F32:  # row 6 proper: f32 -> bf16, 16 bits, always
                err["stochastic_cast"] = max(
                    err["stochastic_cast"], compare_bits(
                        f"stochastic_cast (row 6) n={n}",
                        kc_.cast(x, BF16, stochastic=True, seed=7),
                        kc_.stochastic_cast_plain(x, BF16, 7, 16, 0.0,
                                                  always=True)))
        if n > 1:  # NaN and infinities: their segments' scales are NaN
            # or infinite and every output there NaN or 0; NaN bits are
            # the arithmetic's, so those are held with NaN where NaN
            x = comp_operand(n, F32, gen, dev)
            for seed in (0, 12345):
                v, s = kc_.quantize_rows([x], [seed], 256)
                pv, ps = kc_.quantize_plain(x, seed, 256)
                compare_bits(f"quantize specials n={n} values", v[0], pv)
                compare(f"quantize specials n={n} scales", s[0], ps)
                compare(f"dequantize specials n={n}",
                        kc_.dequantize_rows(v, s, n, 256)[0],
                        kc_.dequantize_plain(pv, ps, n, 256))
        for src in kc_.QUANT_SOURCES:
            x = comp_operand(n, src, gen, dev, specials=False)
            rows, br, nblk = kc_.tiles(n)
            for seg, out_len in ((256, n), (br * 128, rows * 128)):
                for seed in (0, 12345):
                    if big and (src != F32 or seed and seg != 256):
                        continue
                    tag = f"quantize {src} n={n} seg={seg} seed={seed}"
                    v, s = kc_.quantize_rows([x], [seed], seg, out_len)
                    pv, ps = kc_.quantize_plain(x, seed, seg, out_len)
                    compare_bits(tag + " values", v[0], pv)
                    err["quantize_int8"] = max(err["quantize_int8"],
                                               compare_bits(tag + " scales",
                                                            s[0], ps))
                    for dst in kc_.DEQUANT_TARGETS:
                        if big and dst != F32:
                            continue
                        err["dequantize_int8"] = max(
                            err["dequantize_int8"], compare_bits(
                                f"dequantize {tag} -> {dst}",
                                kc_.dequantize_rows(v, s, n, seg, dst)[0],
                                kc_.dequantize_plain(pv, ps, n, seg, dst)))
        sync(dev)
    check_quantize_paths(kc_, err, gen, dev)
    check_cast_rows(kc_, err, gen, dev)
    # the codec on the card against the numpy codec, byte for byte
    x = comp_operand(1_000_003, F32, gen, dev)
    finite = comp_operand(1_000_003, F32, gen, dev, specials=False)
    host = x.cpu()
    for lane in WIRE_LANES:
        for seed in (0, 99, 2 ** 31 + 5):
            got = dw.wire_lane_roundtrip(x, lane, seed).cpu()
            want = hw.roundtrip(host, hw.DataType[_LANE_NAMES[lane]], seed)
            # a NaN operand makes its int8 segment's scale NaN, whose
            # payload bits are the arithmetic's, not the codec's: that
            # lane is held bit for bit with NaN where NaN
            (compare if lane == "int8" else compare_bits)(
                f"wire_lane_roundtrip {lane} seed={seed}", got, want)
            if lane == "int8":  # the frame: int8 payload, then scales
                q, s = dw.quantize_int8(finite, seed)
                raw = hw.encode_bytes(finite.cpu(), hw.DataType.INT8, seed)
                if (q.cpu().numpy().tobytes() + s.cpu().numpy().tobytes()
                        != raw):
                    fail(f"int8 wire frame seed={seed} differs from the "
                         f"host codec's bytes")
    sync(dev)


def check_quantize_paths(kc_, err, gen, dev) -> None:
    """Phase 2 for row 7's three paths (``quantize_geometry``): segments
    of L = 256 (a half-warp), 4096, 16,384 and 65,536 (a cluster of 1, 2
    and 8 CTAs) and 69,632 (above a cluster: two passes), each with n not a
    multiple of L, over R = 3 rows in one launch (rows of out_len int8
    off 16 bytes), an input view off 16 bytes, seeds 0 and 9, from
    float32, bfloat16 and float16, with NaN, infinities and a segment of
    zeros: values and scales bit for bit (NaN where NaN for a scale)
    against ``quantize_plain``."""
    import torch

    F32 = torch.float32
    # more segments than clusters fit at 4096, 16384 and 65,536: the
    # persistent clusters' second register set is used
    for L, k in ((256, 3), (4096, 2001), (16_384, 301), (65_536, 101),
                 (69_632, 2)):
        path = kc_.quantize_geometry(L)
        n = k * L + 1001
        for src in kc_.QUANT_SOURCES:
            x = comp_operand(n + 1, F32, gen, dev)
            x[L:2 * L] = 0.0  # a whole segment of zeros
            x = x.to(src)
            rows = [x[1:], x[:n], comp_operand(n, src, gen, dev,
                                               specials=False)]
            for seed in (0, 9):
                if src != F32 and seed:
                    continue
                tag = f"quantize L={L} {path} {src} n={n} seed={seed}"
                out_len = n + 3  # rows 1 and 2 off 16 bytes
                v, s = kc_.quantize_rows(rows, [seed, 9, 0], L, out_len)
                for r, (row, rs) in enumerate(zip(rows, (seed, 9, 0))):
                    pv, ps = kc_.quantize_plain(row, rs, L, out_len)
                    compare_bits(f"{tag} row {r} values", v[r], pv)
                    err["quantize_int8"] = max(err["quantize_int8"], compare(
                        f"{tag} row {r} scales", s[r], ps))
        sync(dev)
    print("quantize: every path agrees with quantize_plain", flush=True)


def check_cast_rows(kc_, err, gen, dev) -> None:
    """Phase 2 for row 5's paths beside the single rows above: R = 4 rows
    in one launch at n = 257 and 1,000,003 over every pair, aligned and
    with the input, the output or both one element past 16-byte alignment
    (a view ``t[1:]``: the scalar path); then the compressed facade's
    4 x 16 Mi float32 rows to every lane; each call one launch, every row
    bit for bit with ``cast_plain``."""
    import torch

    lanes = kc_.CAST_DTYPES
    for n in (257, 1_000_003):
        for src in lanes:
            xs = [comp_operand(n + 1, src, gen, dev) for _ in range(P_MAIN)]
            for dst in lanes:
                if dst == src:
                    continue
                for off_in, off_out in ((0, 0), (1, 1), (1, 0), (0, 1)):
                    rows = [x[off_in:off_in + n] for x in xs]
                    outs = [torch.empty(n + 1, dtype=dst, device=dev)[
                        off_out:off_out + n] for _ in rows]
                    tag = (f"cast R={P_MAIN} {src}->{dst} n={n} "
                           f"offsets {off_in}/{off_out}")
                    before = kc_.cast_rows.launches.count
                    got = kc_.cast_rows(rows, dst, out=outs)
                    if kc_.cast_rows.launches.count - before != 1:
                        fail(f"{tag}: not one launch")
                    for r, (g, x) in enumerate(zip(got, rows)):
                        err["cast"] = max(err["cast"], compare_bits(
                            f"{tag} row {r}", g, kc_.cast_plain(x, dst)))
        sync(dev)
    rows = [comp_operand(N_RANK, torch.float32, gen, dev)
            for _ in range(P_MAIN)]
    for dst in lanes[1:]:
        got = kc_.cast_rows(rows, dst)
        for r, (g, x) in enumerate(zip(got, rows)):
            err["cast"] = max(err["cast"], compare_bits(
                f"cast {P_MAIN} x {N_RANK} float32->{dst} row {r}", g,
                kc_.cast_plain(x, dst)))
        del got
        sync(dev)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_LANE_NAMES = {"float16": "FLOAT16", "bfloat16": "BFLOAT16",
               "float8_e4m3fn": "FLOAT8_E4M3", "float8_e5m2": "FLOAT8_E5M2",
               "int8": "INT8"}


def at_dtype(tdt):
    from accl_tpu_torch.constants import torch_to_dtype

    return torch_to_dtype(tdt)


def wire_expected(xs, lane: str, algo: str, nseg: int):
    """The plain computation of the facade's compressed allreduce on the
    card: the ring's plain hop schedule with the wire lane inside it, or,
    under ``xla``, each contribution's wire roundtrip (the fp8 and int8
    lanes) folded in rank order, or the narrow fold widened (f16 / bf16)."""
    import torch

    from accl_tpu_torch import wire as hw
    from accl_tpu_torch.ops.cuda import compression as kcp
    from accl_tpu_torch.ops.cuda import ring as kr

    dt = hw.DataType[_LANE_NAMES[lane]]
    wire = getattr(torch, lane)
    if algo != "xla":
        return kr.ring_allreduce_plain(
            xs, num_segments=nseg, bidirectional=algo.endswith("bidir"),
            wire_dtype=wire)[0]
    if lane == "int8":
        rounded = []
        for x in xs:
            q, s = kcp.quantize_plain(x, 0, 256)
            rounded.append(kcp.dequantize_plain(q, s, x.numel(), 256,
                                                x.dtype))
    elif hw.dropped_mantissa_bits(dt) >= 20:
        rounded = [kcp.cast_plain(kcp.stochastic_cast_plain(
            x, wire, 0, hw.dropped_mantissa_bits(dt), hw.lane_tiny(dt)),
            x.dtype) for x in xs]
    else:
        narrow = [kcp.cast_plain(x, wire) for x in xs]
        acc = narrow[0]
        for v in narrow[1:]:
            acc = acc + v
        return kcp.cast_plain(acc, xs[0].dtype)
    acc = rounded[0]
    for v in rounded[1:]:
        acc = acc + v
    return acc


def compressed_main_path(kc) -> dict:
    """Phase 3f: ``cuda_group(4)`` on the card, 64 MiB of float32 per rank:
    the facade allreduce on every wire lane under ``xla``,
    ``pallas_ring`` and ``pallas_ring_bidir`` (4 segments), and bfloat16
    operands on the fp8 and int8 lanes under ``xla``, each result held
    exactly against the plain computation on the card; then
    ``int8_allreduce`` on the ranks' buffers (exactly against its plain
    composition, and within JAX's analytic bound).  Returns the kernel
    launch counts of the run."""
    import numpy as np
    import torch

    import accl_tpu_torch as at
    from accl_tpu_torch.ops.cuda import compression as kcp

    P, n = P_MAIN, N_RANK
    rng = np.random.default_rng(SEED + 6)
    data = rng.standard_normal((P, n), dtype=np.float32)
    algos = ("xla", "pallas_ring", "pallas_ring_bidir")
    cases = [(algo, lane, "float32") for algo in algos for lane in WIRE_LANES]
    cases += [("xla", lane, "bfloat16")
              for lane in ("float8_e4m3fn", "float8_e5m2", "int8")]
    outs = {}

    def rank_main(a, r):
        a.set_tuning("ring_segments", 4)
        srcs = {"float32": a.create_buffer_from(data[r])}
        srcs["bfloat16"] = a.create_buffer(n, "bfloat16")
        srcs["bfloat16"].tensor.copy_(srcs["float32"].tensor)
        dsts = {k: a.create_buffer(n, k) for k in srcs}
        for algo, lane, dtype in cases:
            a.set_tuning("allreduce_algorithm", algo)
            a.allreduce(srcs[dtype], dsts[dtype], n, compress_dtype=lane)
            if r == 0:
                outs[(algo, lane, dtype)] = dsts[dtype].tensor.clone()
        results[r] = srcs

    results = {}
    reset_launches(kc)
    group = at.cuda_group(P)
    try:
        run_ranks(group, rank_main, "compressed path")
        xs = [results[r]["float32"].tensor for r in range(P)]
        ix = kc.int8_allreduce(xs)
        sync(xs[0].device)
        launches = read_launches(kc)
    finally:
        for a in group:
            a.deinit()
    for (algo, lane, dtype), got in outs.items():
        rows = [results[r][dtype].tensor for r in range(P)]
        compare(f"compressed allreduce {algo} {lane} {dtype}", got,
                wire_expected(rows, lane, algo, 4))
    # int8_allreduce: quantize, gather, dequantize, rank-order sum
    rows_, br, nblk = kcp.tiles(n)
    blocks = []
    for x in xs:
        q, s = kcp.quantize_plain(x, 0, br * 128, rows_ * 128)
        blocks.append(kcp.dequantize_plain(q, s, n, br * 128))
    want = blocks[0] + blocks[1]
    for b in blocks[2:]:
        want = want + b
    for r in range(P):
        compare(f"int8_allreduce rank {r}", ix[r], want)
    exact = torch.stack(xs).double().sum(0)
    scales = torch.stack([x.abs().reshape(nblk, -1).amax(1) for x in
                          [torch.nn.functional.pad(x, (0, rows_ * 128 - n))
                           for x in xs]]).double() / 127.0
    bound_ = scales.sum(0).repeat_interleave(br * 128)[:n] / 2 + 1e-4
    if bool(((ix[0].double() - exact).abs() > bound_).any()):
        fail("int8_allreduce exceeds its analytic error bound")
    missing = [k for k in COMP_KERNELS + ("ring_allreduce",)
               if launches[k] == 0]
    if missing:
        fail(f"compressed path never launched {missing}: {launches}")
    return launches


def convergence_leg() -> dict:
    """bench.py's convergence leg (``_compression_convergence``,
    bench.py:2072-2140) on ``cuda_group(2)``: 2-rank DP-SGD linear
    regression, dim 512, batch 64, 40 steps, the gradients allreduced
    through the facade on a float32 wire, a raw fp8-e4m3 wire and an
    fp8-e4m3 wire with error feedback.  Returns the losses, the launch
    counts of the run, and ``delta_pct`` (JAX documents <= 10 %)."""
    import numpy as np

    import accl_tpu_torch as at

    steps, dim, batch = 40, 512, 64
    rng = np.random.default_rng(42)
    w_true = rng.standard_normal(dim).astype(np.float32)
    X = [rng.standard_normal((batch, dim)).astype(np.float32)
         for _ in range(2)]
    y = [x @ w_true for x in X]

    def train(wire, ef: bool) -> float:
        g = at.cuda_group(2)
        losses = [None, None]
        try:
            if ef:
                for a in g:
                    a.set_error_feedback(True)

            def rank_main(a, r):
                w = np.zeros(dim, np.float32)
                gbuf = a.create_buffer(dim, np.float32)
                obuf = a.create_buffer(dim, np.float32)
                for _ in range(steps):
                    err = X[r] @ w - y[r]
                    gbuf.data[:] = (X[r].T @ err / batch).astype(np.float32)
                    gbuf.sync_to_device()
                    a.allreduce(gbuf, obuf, dim, compress_dtype=wire)
                    obuf.sync_from_device()
                    w -= 0.05 * obuf.data / 2.0
                losses[r] = float(np.mean((X[r] @ w - y[r]) ** 2))

            run_ranks(g, rank_main, "convergence leg")
        finally:
            for a in g:
                a.deinit()
        return max(losses)

    loss_f32 = train(None, False)
    loss_raw = train("float8_e4m3fn", False)
    loss_ef = train("float8_e4m3fn", True)
    base = max(loss_f32, 1e-12)
    out = {
        "wire": "float8_e4m3", "steps": steps, "dim": dim, "batch": batch,
        "loss_f32": loss_f32, "loss_raw_compressed": loss_raw,
        "loss_error_feedback": loss_ef,
        "delta_pct": (loss_ef - loss_f32) / base * 100.0,
        "raw_delta_pct": (loss_raw - loss_f32) / base * 100.0,
    }
    if not all(math.isfinite(v) for v in (loss_f32, loss_raw, loss_ef)):
        fail(f"convergence leg: a loss is not finite: {out}")
    if out["delta_pct"] > 10.0:
        fail(f"convergence leg: error feedback {out['delta_pct']:.3f} % "
             f"above the float32 wire (bound 10 %)")
    return out


def time_compression(kc, dev) -> dict:
    """Phase 4 for rows 5-8 at 32 Mi float32 elements (bench.py:153, :187):
    cast f32 -> bf16 (beside ``Tensor.to``), the stochastic cast f32 ->
    bf16, quantize in the Pallas tier's tiles (and the wire's 256-element
    segments as extra keys) and dequantize, each beside its plain version
    and its bound (bytes over the HBM rate)."""
    import torch

    kcp = kc.compression
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    n = N_COMP
    x = torch.randn(n, generator=gen, device=dev)
    bf = torch.empty(n, dtype=torch.bfloat16, device=dev)
    rows, br, nblk = kcp.tiles(n)
    seg = br * 128
    v, s = kcp.quantize_rows([x], [0], seg, rows * 128)
    wv, ws = kcp.quantize_rows([x], [0], 256)
    nseg = ws.shape[1]
    out = {
        "cast": dict(
            ms=time_ms(lambda: kcp.cast_rows([x], torch.bfloat16, out=[bf])),
            device_ms=device_ms(lambda: kcp.cast_rows([x], torch.bfloat16,
                                                      out=[bf])),
            plain_ms=time_ms(lambda: kcp.cast_plain(x, torch.bfloat16)),
            library_ms=time_ms(lambda: x.to(torch.bfloat16)),
            library_device_ms=device_ms(lambda: x.to(torch.bfloat16)),
            bytes=6 * n, ops=n, **time_cast_rows(kcp, x, bf, dev)),
        "stochastic_cast": dict(
            ms=time_ms(lambda: kcp.stochastic_cast_rows(
                [x], torch.bfloat16, [7], 16, 0.0, always=True, out=[bf])),
            plain_ms=time_ms(lambda: kcp.stochastic_cast_plain(
                x, torch.bfloat16, 7, 16, 0.0, always=True)),
            library_ms=None, bytes=6 * n, ops=12 * n),
        "quantize_int8": dict(
            ms=time_ms(lambda: kcp.quantize_rows([x], [0], seg, rows * 128)),
            device_ms=device_ms(lambda: kcp.quantize_rows([x], [0], seg,
                                                          rows * 128)),
            plain_ms=time_ms(lambda: kcp.quantize_plain(x, 0, seg,
                                                        rows * 128)),
            library_ms=None, bytes=4 * n + rows * 128 + 4 * nblk, ops=4 * n,
            geometry=list(kcp.quantize_geometry(seg)),
            wire_seg_ms=time_ms(lambda: kcp.quantize_rows([x], [0], 256)),
            wire_seg_device_ms=device_ms(
                lambda: kcp.quantize_rows([x], [0], 256)),
            wire_seg_plain_ms=time_ms(lambda: kcp.quantize_plain(x, 0, 256)),
            wire_seg_bound_ms=bound(5 * n + 4 * nseg, 4 * n)["bound_ms"],
            wire_seg_sr_ms=time_ms(lambda: kcp.quantize_rows([x], [9], 256)),
            wire_seg_sr_device_ms=device_ms(
                lambda: kcp.quantize_rows([x], [9], 256))),
        "dequantize_int8": dict(
            ms=time_ms(lambda: kcp.dequantize_rows(v, s, n, seg)),
            plain_ms=time_ms(lambda: kcp.dequantize_plain(v[0], s[0], n,
                                                          seg)),
            library_ms=None, bytes=rows * 128 + 4 * nblk + 4 * n, ops=n,
            wire_seg_ms=time_ms(lambda: kcp.dequantize_rows(wv, ws, n, 256)),
            wire_seg_bound_ms=bound(5 * n + 4 * nseg, n)["bound_ms"]),
    }
    sync(dev)
    return out


def time_cast_rows(kcp, x, bf, dev) -> dict:
    """Phase 4's other shapes of row 5 (extra keys of its entry): the
    compressed facade's 4 rows x 16 Mi float32 (64 MiB a rank) in one
    launch to bfloat16 and to fp8 e4m3, beside ``Tensor.to`` on each row
    (4 calls), and the widening bfloat16 -> float32 of the delivery path
    at 32 Mi; each by the wrapper and by device time alone, with its
    bound."""
    import torch

    out = {}
    rows = [x[:N_RANK].clone() for _ in range(P_MAIN)]
    m = N_RANK
    for name, dt in (("rows4_bf16", torch.bfloat16),
                     ("rows4_e4m3", torch.float8_e4m3fn)):
        outs = [torch.empty(m, dtype=dt, device=dev) for _ in rows]
        out.update({
            f"{name}_ms": time_ms(lambda: kcp.cast_rows(rows, dt, out=outs)),
            f"{name}_device_ms": device_ms(
                lambda: kcp.cast_rows(rows, dt, out=outs)),
            f"{name}_library_ms": time_ms(lambda: [r.to(dt) for r in rows]),
            f"{name}_library_device_ms": device_ms(
                lambda: [r.to(dt) for r in rows]),
            f"{name}_bound_ms": bound(P_MAIN * m * (4 + dt.itemsize),
                                      P_MAIN * m)["bound_ms"],
        })
        del outs
    del rows
    n = x.numel()
    wide = torch.empty(n, dtype=torch.float32, device=dev)
    out.update({
        "widen_ms": time_ms(lambda: kcp.cast_rows([bf], torch.float32,
                                                  out=[wide])),
        "widen_device_ms": device_ms(lambda: kcp.cast_rows(
            [bf], torch.float32, out=[wide])),
        "widen_library_ms": time_ms(lambda: bf.to(torch.float32)),
        "widen_library_device_ms": device_ms(lambda: bf.to(torch.float32)),
        "widen_bound_ms": bound(6 * n, n)["bound_ms"],
    })
    sync(dev)
    return out


def launch_path(kc) -> dict:
    """Row 19's launch path (phase 4; ``--launch-path`` runs it alone):
    the wrapper ms of ``probe_copy`` on its (8, 128) block and of
    ``cast_rows`` on 4 KiB of float32 (1,024 elements to bfloat16), beside
    ``Tensor.clone`` and ``Tensor.to`` on the same tensors (CUDA events
    over 1,000 calls); then, where the package declares its prototypes at
    load (``_build.PTR``), each step of ``probe_copy``'s path alone in
    host microseconds a call (``perf_counter`` over 5,000 calls), the
    steps the path dropped beside them (``argtypes`` and ``restype`` set
    on every call, ``torch.cuda.current_stream``'s stream object, a set of
    devices, the alignment test the C entry now makes), and the whole
    wrapper and ``clone`` the same way."""
    import ctypes

    import torch

    dev = torch.device("cuda", 0)
    block = torch.randn(8, 128, device=dev)
    small = torch.randn(1024, device=dev)
    sbf = torch.empty(1024, dtype=torch.bfloat16, device=dev)
    cast = kc.compression.cast_rows
    out = {
        "probe_copy_ms": time_ms(lambda: kc.probe_copy(block), iters=1000),
        "clone_ms": time_ms(lambda: block.clone(), iters=1000),
        "cast_4kib_ms": time_ms(lambda: cast([small], torch.bfloat16,
                                             out=[sbf]), iters=1000),
        "to_4kib_ms": time_ms(lambda: small.to(torch.bfloat16), iters=1000),
    }
    b = kc._build
    if not hasattr(b, "PTR"):  # a tree from before the prototype tables
        return out
    from accl_tpu_torch.ops.cuda import _common as cm
    from accl_tpu_torch.ops.cuda import probe as pr

    lib = b.library("probe", pr.PROTOTYPES["probe"])
    fn = lib.accl_probe_copy
    o = torch.empty_like(block)
    src, dst = block.data_ptr(), o.data_ptr()
    stream = cm.stream_of(dev)
    counter = cm.LaunchCounter()

    def host_us(f, iters: int = 5000) -> float:
        for _ in range(100):
            f()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            f()
        us = (time.perf_counter() - t) / iters * 1e6
        torch.cuda.synchronize()
        return us

    def redeclare():  # what the wrappers did on every launch before
        fn.restype = ctypes.c_int
        fn.argtypes = list(pr.PROTOTYPES["probe"]["accl_probe_copy"])

    steps = {
        "dtype_and_layout_checks": lambda: (
            block.dtype != torch.float32 or not block.is_contiguous()),
        "on_cuda": lambda: cm.on_cuda([block]),
        "empty_like": lambda: torch.empty_like(block),
        "library_lookup": lambda: b.library("probe", pr.PROTOTYPES["probe"]),
        "data_ptr": lambda: (block.data_ptr(), o.data_ptr()),
        "stream_of": lambda: cm.stream_of(block.device),
        "ctypes_call_and_launch": lambda: fn(src, dst, 1024, stream),
        "check_launch_and_count": lambda: (
            cm.check_launch(lib, 0, "probe_copy"), counter.bump()),
    }
    dropped = {
        "argtypes_every_call": redeclare,
        "cuda_current_stream_object": lambda: ctypes.c_void_p(
            torch.cuda.current_stream(block.device).cuda_stream),
        "set_of_devices": lambda: {t.device for t in [block]},
        "alignment_in_python": lambda: int(all(
            t.data_ptr() % 16 == 0 for t in (block, o))),
    }
    us = {k: host_us(f) for k, f in steps.items()}
    out.update({
        "steps_us": us,
        "steps_sum_us": sum(us.values()),
        "dropped_us": {k: host_us(f) for k, f in dropped.items()},
        "probe_copy_us": host_us(lambda: kc.probe_copy(block)),
        "clone_us": host_us(lambda: block.clone()),
    })
    return out


def facade_compressed_latency(sizes, iters: int = 20) -> list:
    """p50 and p90 of the facade allreduce per wire lane (and the
    uncompressed call, in the same run) and register, at ``sizes``
    float32 elements per rank; the second of two passes is kept."""
    import numpy as np

    import accl_tpu_torch as at

    algos = ("xla", "pallas_ring", "pallas_ring_bidir")
    samples = {}

    def rank_main(a, r):
        a.set_tuning("ring_segments", 4)
        bufs = {n: (a.create_buffer(n, np.float32),
                    a.create_buffer(n, np.float32)) for n in sizes}
        for _pass in range(2):
            for n, (s, d) in bufs.items():
                for algo in algos:
                    a.set_tuning("allreduce_algorithm", algo)
                    for lane in (None,) + WIRE_LANES:
                        times = []
                        for _ in range(iters):
                            t = time.perf_counter()
                            a.allreduce(s, d, compress_dtype=lane)
                            times.append(time.perf_counter() - t)
                        if r == 0:
                            samples[(algo, lane, n)] = times

    group = at.cuda_group(P_MAIN)
    try:
        run_ranks(group, rank_main, "compressed facade timing")
    finally:
        for a in group:
            a.deinit()
    return [{"algo": algo, "wire": lane or "none", "bytes_per_rank": 4 * n,
             "p50_ms": float(np.median(t)) * 1e3,
             "p90_ms": float(np.percentile(t, 90)) * 1e3}
            for (algo, lane, n), t in samples.items()]


# ---------------------------------------------------------------------------
# slice 7: point-to-point, the stream ports, rows 13 and 19
# ---------------------------------------------------------------------------

# the facade's point-to-point sizes: the rendezvous size of
# tests/test_sendrecv.py:47 (256 KiB), 4 MiB and the main path's 64 MiB
P2P_SIZES = (64 * 1024, 1024 * 1024, N_RANK)
P2P_LANES = ("bfloat16", "float16", "float8_e4m3fn", "float8_e5m2")
PUT_COUNTS = (1, 700, N_RANK + 3, N_RANK)
#: (ranks, distance) of row 13's checks: Python's modulus both ways, a
#: distance past P, and P = 1
PUT_SHIFTS = ((4, 1), (4, -1), (4, 3), (4, 5), (1, 3))


def probe_phase(kc) -> dict:
    """Phase 0: row 19's kernel-load probe, before anything else is built
    or run: build ``csrc/probe.cu``, copy an (8, 128) float32 block on the
    card, hold the copy against its input.  Fails with the probe's reason
    when it is false; returns the kernel launch counts of the phase (the
    probe's one)."""
    from accl_tpu_torch import compat

    reset_launches(kc)
    if not compat.has_kernels():
        fail(f"the kernel probe failed: {compat.kernels_reason()}")
    launches = read_launches(kc)
    if launches["probe_copy"] != 1 or sum(launches.values()) != 1:
        fail(f"the probe launched {launches}, want probe_copy once")
    return launches


def check_put(kc, err, dev) -> None:
    """Phase 2 for rows 13 and 19: ``fused_shift`` against
    ``fused_shift_plain`` over float32 / bfloat16 / float16 / int32, counts
    1, 700, 16Mi + 3 (rows past the first misaligned: the scalar path)
    and 16Mi per rank, ``PUT_SHIFTS``, identity / + 1.0 / * 2.0, and on
    the float operands + 0.1 / * 1.3 (constants a 16-bit operand cannot
    hold: the wrapper rounds them as JAX does; the float operands carry
    +-0, +-inf and NaN), plus a misaligned view; identity
    bit for bit, the computed forms bit for bit but for NaN payloads
    (``compare_bits_nan``: a lost sign of zero shows); any other callable
    (its own PyTorch pass, counted in ``fused_shift.compute_passes``, then
    an identity put) on every dtype; then the probe's copy against
    ``clone``."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    sv = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                       float("nan"), -float("nan")], device=dev)
    computes = (None, kc.Add(1.0), kc.Mul(2.0))
    rounded = (kc.Add(0.1), kc.Mul(1.3))
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        forms = computes if dtype == torch.int32 else computes + rounded
        for n in PUT_COUNTS:
            if dtype == torch.int32:
                x = torch.randint(-2**31, 2**31 - 1, (P_MAIN, n),
                                  generator=gen, device=dev, dtype=dtype)
            else:
                x = torch.randn(P_MAIN, n, generator=gen, device=dev)
                k = min(n, sv.numel())
                x[:, :k] = sv[:k]
                x = x.to(dtype)
            for P, d in PUT_SHIFTS:
                xs = list(x[:P].unbind(0))
                for comp in forms:
                    tag = f"fused_shift {dtype} n={n} P={P} d={d} {comp!r}"
                    got = kc.fused_shift(xs, d, comp)
                    want = kc.fused_shift_plain(xs, d, comp)
                    for r in range(P):
                        check = (compare_bits if comp is None
                                 else compare_bits_nan)
                        err["fused_shift"] = max(err["fused_shift"], check(
                            f"{tag} rank {r}", got[r], want[r]))
            del x, xs, got, want
            sync(dev)
    x = torch.randn(P_MAIN, 1_000_004, generator=gen, device=dev)
    views = [row[1:] for row in x.unbind(0)]
    for comp in computes + rounded:
        got = kc.fused_shift(views, 3, comp)
        want = kc.fused_shift_plain(views, 3, comp)
        for r in range(P_MAIN):
            err["fused_shift"] = max(err["fused_shift"], compare_bits_nan(
                f"fused_shift misaligned {comp!r} rank {r}", got[r], want[r]))

    def minus3(v):  # no fused form: a PyTorch pass before the put
        return v - 3

    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        x = (torch.randint(-2**31, 2**31 - 1, (P_MAIN, 700), generator=gen,
                           device=dev, dtype=dtype) if dtype == torch.int32
             else torch.randn(P_MAIN, 700, generator=gen,
                              device=dev).to(dtype))
        passes = kc.fused_shift.compute_passes.count
        launches = kc.fused_shift.launches.count
        got = kc.fused_shift(x, 1, minus3)
        if (kc.fused_shift.compute_passes.count - passes,
                kc.fused_shift.launches.count - launches) != (1, 1):
            fail(f"fused_shift {dtype} with a callable: not one pass and "
                 f"one launch")
        compare_bits(f"fused_shift {dtype} callable", got,
                     kc.fused_shift_plain(x, 1, minus3))
    for shape in ((8, 128), (1_000_003,)):
        x = torch.randn(*shape, generator=gen, device=dev)
        compare_bits(f"probe_copy {shape}", kc.probe_copy(x),
                     kc.probe_copy_plain(x))
    # the wrappers launch on PyTorch's current stream (``stream_of``), a
    # side stream's inside its context
    from accl_tpu_torch.ops.cuda._common import stream_of

    if stream_of(dev) != torch.cuda.current_stream(dev).cuda_stream:
        fail("stream_of is not the current stream's pointer")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        if stream_of(dev) != side.cuda_stream:
            fail("stream_of inside a stream context is not that stream")
        x = torch.randn(8, 128, generator=gen, device=dev)
        got = kc.probe_copy(x)
    side.synchronize()
    compare_bits("probe_copy on a side stream", got, x)
    sync(dev)


def p2p_main_path(kc) -> dict:
    """Phase 3g: the point-to-point and stream calls on ``cuda_group(4)``,
    64 MiB of float32 per message: send/recv 0 -> 1; the bidirectional
    exchange 0 <-> 1; a ring shift through the facade (rank r sends to
    r + 1, receives from r - 1); sends on each cast wire lane, equal to
    ``wire.astype``'s roundtrip (row 5 twice a send); facade ``copy``
    from float32 into a buffer of each lane and a bfloat16 stream result
    (RES_COMPRESSED), each one launch of row 5; ``stream_put``,
    send from a stream port and recv into one; ``reduce`` with
    ``from_stream`` and with ``to_stream`` under ``xla`` and
    ``pallas_ring``, equal to the buffer reduce of the same run; the
    three ``vadd_put`` forms around the ring, each equal to
    ``roll(x + 1.0)``.  Everything bit for bit.  Returns the kernel
    launch counts of the run: row 5 13 times, row 10 three times and
    row 13 once, no other kernel."""
    import numpy as np
    import torch

    import accl_tpu_torch as at
    from accl_tpu_torch import wire as twire
    from accl_tpu_torch.backends.base import CallOptions, bytes_tensor
    from accl_tpu_torch.buffer import DummyBuffer
    from accl_tpu_torch.constants import (CompressionFlags, DataType,
                                          Operation, StreamFlags)
    from accl_tpu_torch.examples import vadd_put as ex

    P, n = P_MAIN, N_RANK
    rng = np.random.default_rng(SEED + 70)
    data = rng.standard_normal((P, n), dtype=np.float32)
    plus1 = data + np.float32(1.0)
    got = {}

    def rank_main(a, r):
        F32 = np.float32
        nxt, prv = (r + 1) % P, (r - 1) % P
        s = a.create_buffer_from(data[r])
        d = a.create_buffer(n, F32)

        def host(buf):
            buf.sync_from_device()
            return buf.data.copy()

        if r == 0:  # send/recv 0 -> 1
            a.send(s, n, dst=1, tag=1)
        elif r == 1:
            a.recv(d, n, src=0, tag=1)
            got["send"] = host(d)
        if r < 2:  # the bidirectional exchange (test_sendrecv.py:100)
            sreq = a.send(s, n, dst=1 - r, tag=9, run_async=True)
            a.recv(d, n, src=1 - r, tag=9)
            if not sreq.wait(600):
                fail("bidirectional send never completed")
            sreq.check()
            got[("bidir", r)] = host(d)
        sreq = a.send(s, n, dst=nxt, tag=2, run_async=True)  # ring shift
        a.recv(d, n, src=prv, tag=2)
        if not sreq.wait(600):
            fail("ring shift send never completed")
        sreq.check()
        got[("ring", r)] = host(d)
        for lane in P2P_LANES:  # the cast wire lanes, 0 -> 1
            if r == 0:
                a.send(s, n, dst=1, tag=3, compress_dtype=lane)
            elif r == 1:
                a.recv(d, n, src=0, tag=3, compress_dtype=lane)
                got[("wire", lane)] = host(d)
        if r == 0:  # facade copies between dtypes: row 5 on the card
            for lane in P2P_LANES:
                c = a.create_buffer(n, getattr(torch, lane))
                a.copy(s, c, n)
                got[("copy", lane)] = c.tensor[:n].cpu()
            # a stream result in the compressed dtype (RES_COMPRESSED)
            cfg, _ = a._resolve_arithcfg(DataType.FLOAT32, "bfloat16")
            a._launch(CallOptions(
                op=Operation.COPY, comm=a.comm, count=n, arithcfg=cfg,
                compression=CompressionFlags.RES_COMPRESSED,
                stream=StreamFlags.RES_STREAM, stream_id=13, op0=s,
                res=DummyBuffer(n, DataType.FLOAT32)), False,
                "copy_to_stream")
            got["res_compressed"] = bytes_tensor(
                a.engine.stream_pop(13, timeout=60), torch.bfloat16)
        if r == 0:  # stream_put; send from a stream; recv into a stream
            a.stream_put(s, n, dst=1, stream_id=6)
            a.stream_push(data[0], stream_id=11)
            a.send(None, n, dst=1, tag=11, from_stream=True, stream_id=11)
            a.send(s, n, dst=1, tag=12)
        elif r == 1:
            got["stream_put"] = a.stream_pop(n, F32, stream_id=6)
            a.recv(d, n, src=0, tag=11)
            got["from_stream"] = host(d)
            a.recv(None, n, src=0, tag=12, to_stream=True, stream_id=7)
            got["to_stream"] = a.stream_pop(n, F32, stream_id=7)
        for algo in ("xla", "pallas_ring"):  # reduce with stream operands
            a.set_tuning("reduce_algorithm", algo)
            a.reduce(s, d if r == 1 else None, n, root=1)
            if r == 1:
                got[("reduce", algo)] = host(d)
            a.stream_push(data[r], stream_id=21)
            a.reduce(None, d if r == 1 else None, n, root=1,
                     from_stream=True, stream_id=21, dtype=F32)
            if r == 1:
                got[("reduce from_stream", algo)] = host(d)
            a.reduce(s, None, n, root=1, to_stream=True, stream_id=22)
            if r == 1:
                got[("reduce to_stream", algo)] = a.stream_pop(
                    n, F32, stream_id=22)
        a.set_tuning("reduce_algorithm", "xla")
        # vadd_put around the ring (the receive posted first: every
        # rank's send waits for its receiver)
        rreq = a.recv(d, n, src=prv, tag=3, run_async=True)
        ex.vadd_put(a, data[r], nxt, stream_id=3)
        if not rreq.wait(600):
            fail("vadd_put receive never completed")
        rreq.check()
        got[("vadd_put", r)] = host(d)
        # a port per sender: the local push and the delivery share the id
        ex.vadd_put_streamed(a, data[r], nxt, stream_id=30 + r)
        got[("vadd_put_streamed", r)] = a.stream_pop(n, F32,
                                                     stream_id=30 + prv)

    reset_launches(kc)
    group = at.cuda_group(P)
    try:
        run_ranks(group, rank_main, "p2p path")
        dev = group[0].engine.device
        xs = [torch.from_numpy(row).to(dev) for row in data]
        fused = ex.vadd_put_kernel(xs, 1.0, 1)
        sync(dev)
        launches = read_launches(kc)
    finally:
        for a in group:
            a.deinit()

    def same(name, a_, b_):
        if not np.array_equal(np.asarray(a_).view(np.uint32),
                              np.asarray(b_).view(np.uint32)):
            fail(f"p2p path: {name} differs")

    same("send 0 -> 1", got["send"], data[0])
    same("bidirectional to 0", got[("bidir", 0)], data[1])
    same("bidirectional to 1", got[("bidir", 1)], data[0])
    for r in range(P):
        same(f"ring shift rank {r}", got[("ring", r)], data[(r - 1) % P])
    x0 = torch.from_numpy(data[0])
    for lane in P2P_LANES:
        wdt = getattr(torch, lane)
        want = twire.astype(twire.astype(x0, wdt), torch.float32).numpy()
        same(f"{lane} wire send", got[("wire", lane)], want)
        compare_bits(f"{lane} facade copy", got[("copy", lane)],
                     twire.astype(x0, wdt))
    compare_bits("RES_COMPRESSED stream result", got["res_compressed"],
                 twire.astype(x0, torch.bfloat16))
    for key in ("stream_put", "from_stream", "to_stream"):
        same(key, got[key], data[0])
    for algo in ("xla", "pallas_ring"):
        ref = got[("reduce", algo)]
        if not np.allclose(ref, data.astype(np.float64).sum(0), rtol=1e-5,
                           atol=1e-5):
            fail(f"reduce {algo} off the float64 sum")
        for form in ("from_stream", "to_stream"):
            same(f"reduce {form} {algo}", got[(f"reduce {form}", algo)], ref)
    for r in range(P):
        want = plus1[(r - 1) % P]
        same(f"vadd_put rank {r}", got[("vadd_put", r)], want)
        same(f"vadd_put_streamed rank {r}", got[("vadd_put_streamed", r)],
             want)
        same(f"vadd_put_kernel rank {r}", fused[r].cpu().numpy(), want)
    want = dict.fromkeys(kc.KERNELS, 0)
    # row 5: both casts of each compressed send, each copy between
    # dtypes, the compressed stream result
    want.update(cast=3 * len(P2P_LANES) + 1, ring_reduce=3, fused_shift=1)
    if launches != want:
        fail(f"p2p path launched {launches}, want {want}")
    return launches


def time_put(kc, dev) -> dict:
    """Phase 4 for rows 13 and 19: row 13 on 4 ranks x 64 MiB of float32
    with ``+ 1.0`` (``vadd_put_kernel``'s shape) beside 4 x
    ``torch.add(x, 1.0, out=)``; row 19 on its (8, 128) block beside
    ``Tensor.clone``; each also by device time alone (``device_ms``: the
    wrapper's host path, ctypes and ``empty_like``, hidden)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    xs = [torch.randn(N_RANK, generator=gen, device=dev)
          for _ in range(P_MAIN)]
    outs = [torch.empty_like(x) for x in xs]
    add = kc.Add(1.0)

    def library():
        for x, o in zip(xs, outs):
            torch.add(x, 1.0, out=o)

    block = torch.randn(8, 128, generator=gen, device=dev)
    out = {
        "fused_shift": dict(
            ms=time_ms(lambda: kc.fused_shift(xs, 1, add, out=outs)),
            device_ms=device_ms(lambda: kc.fused_shift(xs, 1, add,
                                                       out=outs)),
            plain_ms=time_ms(lambda: kc.fused_shift_plain(xs, 1, add)),
            library_ms=time_ms(library),
            library_device_ms=device_ms(library),
            bytes=2 * P_MAIN * N_RANK * 4, ops=P_MAIN * N_RANK),
        "probe_copy": dict(
            ms=time_ms(lambda: kc.probe_copy(block), iters=1000),
            device_ms=device_ms(lambda: kc.probe_copy(block), iters=200),
            plain_ms=time_ms(lambda: kc.probe_copy_plain(block), iters=1000),
            library_ms=time_ms(lambda: block.clone(), iters=1000),
            library_device_ms=device_ms(lambda: block.clone(), iters=200),
            bytes=2 * block.numel() * 4, ops=0),
    }
    del xs, outs
    sync(dev)
    return out


def facade_p2p_latency(sizes, iters: int = 20, host_iters: int = 5) -> list:
    """Phase 5 (``facade_p2p``): host-clock p50 / p90 on ``cuda_group(4)``
    per size (float32 elements a message): send -> recv completed, rank
    0 -> 1 (from rank 0's call to rank 1's return, the data on the card);
    the ring shift (every rank sends to r + 1 and receives from r - 1,
    from the first rank's start to the last rank's end); ``stream_put``
    -> ``stream_pop`` 0 -> 1; at the largest size the ``vadd_put`` and
    ``vadd_put_streamed`` forms 0 -> 1 (numpy operand in, received data
    out) and ``vadd_put_kernel`` over the 4 ranks' rows (to its
    synchronise).  A barrier starts every sample; a warm-up pass of two
    samples a form comes first.  The forms that copy 64 MiB through the
    host (``stream_put`` and both ``vadd_put`` forms at the largest size,
    100-200 ms a sample) keep ``host_iters`` samples, the others
    ``iters``."""
    import numpy as np
    import torch

    import accl_tpu_torch as at
    from accl_tpu_torch.examples import vadd_put as ex

    P = P_MAIN
    stamps = {}  # (what, n) -> {rank: [(start, end)]}
    big = max(sizes)
    host = np.random.default_rng(SEED + 71).standard_normal(big).astype(
        np.float32)

    def rank_main(a, r):
        F32 = np.float32
        bufs = {n: (a.create_buffer_from(np.full(n, r, F32)),
                    a.create_buffer(n, F32)) for n in sizes}
        for warm in (True, False):
            keep = {}
            for n, (s, d) in bufs.items():
                forms = ["send_recv", "ring_shift", "stream_put"]
                if n == big:
                    forms += ["vadd_put", "vadd_put_streamed"]
                for what in forms:
                    rows = []
                    through_host = n == big and what not in (
                        "send_recv", "ring_shift")
                    for _ in range(2 if warm else host_iters if through_host
                                   else iters):
                        a.barrier()
                        t0 = time.perf_counter()
                        if what == "ring_shift":
                            sreq = a.send(s, n, dst=(r + 1) % P, tag=2,
                                          run_async=True)
                            a.recv(d, n, src=(r - 1) % P, tag=2)
                            sreq.wait()
                            sreq.check()
                        elif r == 0 and what == "send_recv":
                            a.send(s, n, dst=1, tag=1)
                        elif r == 1 and what == "send_recv":
                            a.recv(d, n, src=0, tag=1)
                        elif r == 0 and what == "stream_put":
                            a.stream_put(s, n, dst=1, stream_id=6)
                        elif r == 1 and what == "stream_put":
                            a.stream_pop(n, F32, stream_id=6)
                        elif r == 0 and what == "vadd_put":
                            ex.vadd_put(a, host, 1, stream_id=3)
                        elif r == 1 and what == "vadd_put":
                            a.recv(d, n, src=0, tag=3)
                        elif r == 0 and what == "vadd_put_streamed":
                            ex.vadd_put_streamed(a, host, 1, stream_id=4)
                        elif r == 1 and what == "vadd_put_streamed":
                            a.stream_pop(n, F32, stream_id=4)
                        rows.append((t0, time.perf_counter()))
                    keep[(what, n)] = rows
            for key, rows in keep.items():
                stamps.setdefault(key, {})[r] = rows

    group = at.cuda_group(P)
    try:
        run_ranks(group, rank_main, "p2p facade timing")
        dev = group[0].engine.device
    finally:
        for a in group:
            a.deinit()
    rows = []
    for (what, n), by_rank in stamps.items():
        k = len(by_rank[0])
        if what == "ring_shift":
            lat = [max(by_rank[r][i][1] for r in range(P))
                   - min(by_rank[r][i][0] for r in range(P))
                   for i in range(k)]
        else:  # rank 0's start to rank 1's end
            lat = [by_rank[1][i][1] - by_rank[0][i][0] for i in range(k)]
        rows.append({"call": what, "bytes": 4 * n, "samples": k,
                     "p50_ms": float(np.median(lat)) * 1e3,
                     "p90_ms": float(np.percentile(lat, 90)) * 1e3})
    xs = [torch.from_numpy(host).to(dev) for _ in range(P)]
    lat = []
    for _ in range(2 * iters):
        t0 = time.perf_counter()
        ex.vadd_put_kernel(xs, 1.0, 1)
        sync(dev)
        lat.append(time.perf_counter() - t0)
    lat = lat[iters:]
    rows.append({"call": "vadd_put_kernel", "bytes": 4 * big,
                 "ranks": P, "p50_ms": float(np.median(lat)) * 1e3,
                 "p90_ms": float(np.percentile(lat, 90)) * 1e3})
    return rows


# ---------------------------------------------------------------------------
# slice 8: sequence-parallel attention over P virtual ranks, rows 12 and 15
# ---------------------------------------------------------------------------

#: bench.py's long-context training record: the training model's
#: attention (bench.py:310-313, d_model 4096 over 32 heads, D = 128,
#: bf16) at seq 4096 (train_mfu_t4096, bench.py:3046-3054), batch
#: 8 * 1024 // 4096 = 2 (bench.py:315); over P = 4 virtual ranks,
#: T_local 1024.  Nothing is cut.
SP_B, SP_H, SP_T, SP_D, SP_P = 2, 32, 4096, 128, 4
#: bf16 outputs of two fold orders (64-key tiles, whole hops, the
#: reference's normalised softmax) round to neighbouring bf16 values
SP_TOL = 1e-2
#: row 12's phase 2 cases: (P, per-rank shape); every dtype runs each
A2A_CASES = [(2, (2 * 4096, 256)), (3, (3 * 7, 5)), (4, (4 * 2048, 1024)),
             (8, (8 * 33, 3)), (4, (32, 2 * 1024 * 128))]
A2A_DTYPES = ("float32", "bfloat16", "float16", "int32", "int8",
              "float8_e4m3fn", "float8_e5m2")
#: row 15's phase 2 cases beside the full width: (P, B, H, T_local);
#: T_local 200 is a multiple of 8, not of 64
RING_SMALL = [(4, 1, 2, 200), (3, 2, 1, 64), (1, 1, 2, 136)]


def sp_layouts():
    """(striped, causal) of row 15's four forms."""
    return [(s, c) for s in (False, True) for c in (True, False)]


def launched_once(kern, before: int, what: str) -> None:
    if kern.launches.count != before + 1:
        fail(f"{what}: {kern.launches.count - before} launches, want 1")


def check_seq_parallel(kc, err, dev) -> None:
    """Phase 2 for rows 12 and 15.  Row 12 against ``alltoall_plain`` bit
    for bit over ``A2A_CASES`` x ``A2A_DTYPES`` (P 2, 3, 4, 8; blocks of
    16-byte multiples and not; the last case Ulysses' q at full width)
    and a misaligned view.  Row 15 against ``ring_attention_plain`` over
    contiguous and striped shards, causal and full, bf16 / f16 / f32, D
    24, 64 and 128, T_local 200 (ragged tiles), 64 and 136 over P 4, 3
    and 1, and the main path's 4 x (2, 32, 1024, 128) bf16: float32
    within 2e-5 (the kernel folds with FFMA in 64-key tiles, the plain
    version whole hops), 16-bit within 1e-2.  Every call must launch its
    kernel exactly once."""
    import torch

    from accl_tpu_torch.ops.cuda import attention as ka

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    a2a = kc.KERNELS["alltoall"]
    for P, shape in A2A_CASES:
        for name in A2A_DTYPES:
            dtype = getattr(torch, name)
            xs = [torch.randint(-120, 120, shape, generator=gen, device=dev,
                                dtype=torch.int32).to(dtype)
                  if name in ("int32", "int8") else
                  torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for _ in range(P)]
            before = a2a.launches.count
            got = kc.alltoall(xs)
            launched_once(a2a, before, f"alltoall P={P} {shape} {name}")
            for r, (g, w) in enumerate(zip(got, kc.alltoall_plain(xs))):
                compare_bits(f"alltoall P={P} {shape} {name} rank {r}", g, w)
        del xs, got
    x = torch.randn(4, 4 * 1000 + 1, generator=gen, device=dev)
    views = [row[1:] for row in x.unbind(0)]  # 4-byte aligned only
    for r, (g, w) in enumerate(zip(kc.alltoall(views),
                                   kc.alltoall_plain(views))):
        compare_bits(f"alltoall misaligned rank {r}", g, w)

    ring = kc.KERNELS["ring_attention"]
    cases = [(P, (B, H, T, D), dt)
             for dt in ("bfloat16", "float16", "float32")
             for D in (24, 64, 128) for P, B, H, T in RING_SMALL]
    cases.append((SP_P, (SP_B, SP_H, SP_T // SP_P, SP_D), "bfloat16"))
    worst = 0.0
    for P, shape, dt in cases:
        dtype = getattr(torch, dt)
        qs, ks, vs = ([torch.randn(shape, generator=gen, device=dev)
                       .to(dtype) for _ in range(P)] for _ in range(3))
        tol = 2e-5 if dtype == torch.float32 else 1e-2
        for striped, causal in sp_layouts():
            tag = (f"ring_attention P={P} {shape} {dt} striped={striped} "
                   f"causal={causal}")
            before = ring.launches.count
            wgmma = ring.wgmma_launches.count
            got = ka.ring_attention(qs, ks, vs, causal, striped=striped)
            launched_once(ring, before, tag)
            if ring.wgmma_launches.count != wgmma + (dtype != torch.float32):
                fail(f"{tag}: 16-bit launches take the wgmma kernel, float32 "
                     f"ones the FFMA kernel")
            want = ka.ring_attention_plain(qs, ks, vs, causal,
                                           striped=striped)
            for r, (g, w) in enumerate(zip(got, want)):
                d = float((g.float() - w.float()).abs().max())
                if g.shape != w.shape or not torch.isfinite(g).all() or \
                        not torch.allclose(g.float(), w.float(), rtol=tol,
                                           atol=tol):
                    fail(f"{tag} rank {r}: max abs err {d}")
                worst = max(worst, d)
        del qs, ks, vs, got, want
    big = [torch.zeros(1, 1, 8, ka.MAX_HEAD_DIM + 8, device=dev)]
    try:
        ka.ring_attention(big, big, big)
    except ValueError as e:
        if str(ka.MAX_HEAD_DIM) not in str(e):
            fail(f"ring_attention's head-dim refusal names no cap: {e}")
    else:
        fail("ring_attention took a head dim over MAX_HEAD_DIM")
    err["ring_attention"] = worst
    sync(dev)
    print(f"alltoall: {len(A2A_CASES) * len(A2A_DTYPES) + 1} cases bit for "
          f"bit; ring_attention: {len(cases) * 4} cases within tolerance "
          f"(max abs err {worst})", flush=True)


def sp_operands(dev):
    """The main path's global q, k, v (2, 32, 4096, 128) bf16 from the
    seed, and their per-rank shards: contiguous and striped, each shard
    its own allocation."""
    import torch

    from accl_tpu_torch.models import stripe_sequence

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    glob = [torch.randn(SP_B, SP_H, SP_T, SP_D, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(3)]

    def shards(x):
        return [c.contiguous() for c in torch.chunk(x, SP_P, dim=2)]

    contig = [shards(x) for x in glob]
    striped = [shards(stripe_sequence(x, SP_P)) for x in glob]
    return glob, contig, striped


def sp_close(name: str, got, want) -> float:
    import torch

    d = float((got.float() - want.float()).abs().max())
    if got.shape != want.shape or not torch.isfinite(got).all() or \
            not torch.allclose(got.float(), want.float(), rtol=SP_TOL,
                               atol=SP_TOL):
        fail(f"{name}: max abs err {d} (tolerance {SP_TOL})")
    return d


def seq_parallel_main_path(kc, dev) -> dict:
    """Phase 3h: the sequence-parallel path at full width, 4 ranks x
    (2, 32, 1024, 128) bf16 shards of one 4096-token sequence:
    ``ulysses_attention`` with the tiled ``_a2a`` and with row 12,
    ``ring_attention_pallas`` (row 15) over contiguous and striped shards,
    and the ppermute ``ring_attention`` / ``striped_attention``.  Ulysses
    with row 12 equals the ``_a2a`` form bit for bit; row 15's outputs
    (striped ones after ``unstripe_sequence``) agree with the ppermute
    forms and with ``reference_attention`` on the full sequence (chunked
    over batch and 8 heads) within ``SP_TOL``, as do Ulysses' and the
    ppermute forms'.  Returns the launches of the run (row 12 four times,
    row 15 twice, no other kernel) and the largest gaps."""
    import torch

    from accl_tpu_torch import models as tm

    glob, contig, striped = sp_operands(dev)
    reset_launches(kc)
    uly = tm.ulysses_attention(*contig)
    uly12 = tm.ulysses_attention(*contig, use_pallas_alltoall=True)
    ring15 = tm.ring_attention_pallas(*contig)
    ring15s = tm.ring_attention_pallas(*striped, striped=True)
    ring_pp = tm.ring_attention(*contig)
    striped_pp = tm.striped_attention(*striped)
    sync(dev)
    launches = read_launches(kc)
    want = dict.fromkeys(kc.KERNELS, 0)
    want.update(alltoall=4, ring_attention=2)
    if launches != want:
        fail(f"sequence-parallel path launched {launches}, want {want}")
    all_wgmma(kc, "sequence-parallel path")
    for r in range(SP_P):
        compare_bits(f"ulysses row 12 vs _a2a rank {r}", uly12[r], uly[r])
    full = {
        "ulysses": torch.cat(uly, 2),
        "ring_attention_pallas": torch.cat(ring15, 2),
        "ring_attention_pallas_striped": tm.unstripe_sequence(
            torch.cat(ring15s, 2), SP_P),
        "ring_attention": torch.cat(ring_pp, 2),
        "striped_attention": tm.unstripe_sequence(
            torch.cat(striped_pp, 2), SP_P),
    }
    gaps = {
        "row15_vs_ring_attention": sp_close(
            "ring_attention_pallas vs ring_attention",
            full["ring_attention_pallas"], full["ring_attention"]),
        "row15_striped_vs_striped_attention": sp_close(
            "ring_attention_pallas striped vs striped_attention",
            full["ring_attention_pallas_striped"], full["striped_attention"]),
    }
    q, k, v = glob
    for name, out in full.items():
        worst = 0.0
        for b in range(SP_B):
            for h in range(0, SP_H, 8):
                ref = tm.reference_attention(q[b:b + 1, h:h + 8],
                                             k[b:b + 1, h:h + 8],
                                             v[b:b + 1, h:h + 8])
                worst = max(worst, sp_close(
                    f"{name} vs reference_attention b={b} h={h}",
                    out[b:b + 1, h:h + 8], ref))
        gaps[f"{name}_vs_reference"] = worst
    del glob, contig, striped, uly, uly12, ring15, ring15s, ring_pp
    del striped_pp, full
    sync(dev)
    return {"launches": launches, "gaps": gaps}


def time_seq_parallel(kc, dev) -> dict:
    """Phase 4 for rows 12 and 15 at the main path's shapes.  Row 12 on
    Ulysses' q re-shard: 4 ranks x (32, 2 x 1024 x 128) bf16, 16 MiB a
    rank, beside P x ``torch.cat`` of the ranks' blocks; bound 2 x 64 MiB
    over the HBM rate.  Row 15 over contiguous causal shards (striped and
    full as extra keys), beside ``scaled_dot_product_attention(is_causal=
    True)`` on the full (2, 32, 4096, 128) sequence; bound 4 B H D
    T(T+1)/2 operations at 989 TFLOP/s (both layouts fold the same
    T(T+1)/2 causal pairs), against 4 x 64 MiB of bytes."""
    import torch
    import torch.nn.functional as F

    from accl_tpu_torch.ops.cuda import attention as ka

    glob, contig, striped = sp_operands(dev)
    flat = [x.transpose(0, 1).reshape(SP_H, -1) for x in contig[0]]
    P = SP_P

    def library_a2a():
        blocks = [x.view(P, -1) for x in flat]
        return [torch.cat([b[r] for b in blocks]) for r in range(P)]

    q, k, v = glob
    pairs = SP_T * (SP_T + 1) // 2
    out = {
        "alltoall": dict(
            ms=time_ms(lambda: kc.alltoall(flat), iters=20),
            plain_ms=time_ms(lambda: kc.alltoall_plain(flat), iters=20),
            library_ms=time_ms(library_a2a, iters=20),
            bytes=2 * sum(x.numel() * x.element_size() for x in flat),
            ops=0, shape=[P] + list(flat[0].shape)),
        "ring_attention": dict(
            ms=time_ms(lambda: ka.ring_attention(*contig), iters=20),
            device_ms=device_ms(lambda: ka.ring_attention(*contig),
                                iters=20),
            plain_ms=time_ms(lambda: ka.ring_attention_plain(*contig),
                             iters=3, warmup=1),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), iters=20),
            library_device_ms=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                iters=20),
            bytes=4 * q.numel() * q.element_size(),
            ops=4 * SP_B * SP_H * SP_D * pairs,
            shape=[P, SP_B, SP_H, SP_T // P, SP_D],
            striped_ms=time_ms(lambda: ka.ring_attention(
                *striped, striped=True), iters=20),
            striped_device_ms=device_ms(lambda: ka.ring_attention(
                *striped, striped=True), iters=20),
            striped_plain_ms=time_ms(lambda: ka.ring_attention_plain(
                *striped, striped=True), iters=3, warmup=1),
            full_ms=time_ms(lambda: ka.ring_attention(*contig, causal=False),
                            iters=20),
            full_device_ms=device_ms(lambda: ka.ring_attention(
                *contig, causal=False), iters=20),
            full_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v), iters=20),
            full_library_device_ms=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), iters=20),
            full_ops=4 * SP_B * SP_H * SP_D * SP_T * SP_T),
    }
    del glob, contig, striped, flat, q, k, v
    sync(dev)
    return out


def seq_parallel_latency(dev, iters: int = 20, warmup: int = 2) -> dict:
    """Phase 5 (``seq_parallel_attention``): host-clock p50 / p90 of one
    call, to its synchronise, over ``iters`` calls after ``warmup``, at
    the main path's width, for each form: Ulysses with the tiled
    ``_a2a``, Ulysses with row 12, the ppermute ``ring_attention``, and
    ``ring_attention_pallas`` over contiguous and striped shards (all
    causal); beside each, the peak memory its calls allocated over what
    the run held before them (``work_gib``)."""
    import numpy as np
    import torch

    from accl_tpu_torch import models as tm

    _, contig, striped = sp_operands(dev)
    forms = {
        "ulysses": lambda: tm.ulysses_attention(*contig),
        "ulysses_row12": lambda: tm.ulysses_attention(
            *contig, use_pallas_alltoall=True),
        "ring_attention": lambda: tm.ring_attention(*contig),
        "ring_attention_pallas": lambda: tm.ring_attention_pallas(*contig),
        "ring_attention_pallas_striped": lambda: tm.ring_attention_pallas(
            *striped, striped=True),
    }
    rows = []
    for name, fn in forms.items():
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        lat = []
        for i in range(warmup + iters):
            t0 = time.perf_counter()
            fn()
            sync(dev)
            if i >= warmup:
                lat.append(time.perf_counter() - t0)
        rows.append({"form": name, "p50_ms": float(np.median(lat)) * 1e3,
                     "p90_ms": float(np.percentile(lat, 90)) * 1e3,
                     "work_gib": (torch.cuda.max_memory_allocated(dev)
                                  - held) / 2**30})
    del contig, striped
    sync(dev)
    return {"shape": [SP_B, SP_H, SP_T, SP_D], "ranks": SP_P,
            "dtype": "bfloat16", "causal": True, "calls": iters,
            "tokens": SP_B * SP_T, "rows": rows}


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
    # float32 references must not drop to TF32: the port's float32 matmuls
    # (the plain versions, the naive lowering) run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--launch-path"]:  # the launch path alone
        if not kc.probe_copy(torch.ones(8, 128, device=dev)).eq(1).all():
            fail("the probe's copy differs from its input")
        print(json.dumps({"launch_path": {
            "card": smi.stdout.strip().splitlines()[0], **launch_path(kc)}}))
        return 0
    t0 = time.time()
    probed = probe_phase(kc)
    print(f"kernel probe ok ({time.time() - t0:.1f} s): row 19 built, "
          f"launched and copied its block", flush=True)
    t0 = time.time()
    built = kc.build_all()
    print(f"built {built} in {time.time() - t0:.1f} s", flush=True)
    print(f"ptxas, attention kernels at bf16 D 128 [kernel, registers, "
          f"spill bytes(, dynamic shared bytes)]: {ptxas_report(kc)}",
          flush=True)
    cast_regs = cast_ptxas(kc)
    print(f"ptxas, row 5's cast kernels: {cast_regs}", flush=True)
    tile_regs = tile_ptxas(kc)
    print(f"ptxas, the tile core's kernels, the sequencer's and the "
          f"quantize's: {tile_regs}", flush=True)

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
    check_combine(rand, err)

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
    # the ring's fp8 lanes and its raw int8 cast (JAX's astype per hop)
    E4M3, E5M2, I8 = torch.float8_e4m3fn, torch.float8_e5m2, torch.int8
    cases += [(4, 4, bidir, wire, SUM, F32, N_RANK)
              for wire in (E4M3, E5M2, I8) for bidir in (False, True)]
    cases += [(4, 2, False, E5M2, SUM, BF16, N_RANK),
              (4, 1, True, E4M3, MAX, F32, N_RANK),
              (3, 4, True, I8, SUM, F32, 1_000_003)]
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
    check_rooted_kernels(rand, err)
    check_sequencer(err)
    check_flash(kc, err)
    check_flash_bwd(err)
    check_compression(kc, err, gen, dev)
    check_put(kc, err, dev)
    check_seq_parallel(kc, err, dev)
    print(f"kernels agree with their plain versions ({time.time() - t0:.1f}"
          f" s; exactly, but flash_attention within its tolerances)",
          flush=True)

    # -- phase 3: the main path ----------------------------------------------
    t0 = time.time()
    rng = np.random.default_rng(SEED)
    data = rng.standard_normal((P_MAIN, N_RANK), dtype=np.float32)
    other = rng.standard_normal((P_MAIN, N_RANK), dtype=np.float32)
    exact = data.astype(np.float64).sum(0)
    results = {}

    def rank_main(a, r):
        s = a.create_buffer_from(data[r])
        d = a.create_buffer(N_RANK, np.float32)
        o = a.create_buffer_from(other[r])
        c = a.create_buffer(N_RANK, np.float32)
        outs = []

        def allreduce(**kw):
            a.allreduce(s, d, **kw)
            d.sync_from_device()
            outs.append(d.data.copy())

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
        outs.append(c.data.copy())
        results[r] = (outs, s, o)

    for k in kc.KERNELS.values():
        k.launches.reset()
    group = at.cuda_group(P_MAIN)
    run_ranks(group, rank_main, "main path")
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
    missing = [k for k in SLICE1_KERNELS if launches[k] == 0]
    if missing:
        fail(f"main path never launched {missing}: {launches}")
    print(f"allreduce path ok ({time.time() - t0:.1f} s): launches "
          f"{launches}", flush=True)
    t0 = time.time()
    rooted = rooted_main_path(kc)
    print(f"rooted path ok ({time.time() - t0:.1f} s): launches {rooted}",
          flush=True)
    t0 = time.time()
    batched = batch_main_path(kc)
    print(f"batch path ok ({time.time() - t0:.1f} s): launches {batched}",
          flush=True)
    refused_windows()
    t0 = time.time()
    serve = serve_main_path(kc)
    print(f"serving path checks done ({time.time() - t0:.1f} s)", flush=True)
    t0 = time.time()
    train = train_main_path(kc)
    print(f"training path checks done ({time.time() - t0:.1f} s)",
          flush=True)
    t0 = time.time()
    compressed = compressed_main_path(kc)
    print(f"compressed path ok ({time.time() - t0:.1f} s): launches "
          f"{compressed}", flush=True)
    t0 = time.time()
    reset_launches(kc)
    convergence = convergence_leg()
    converged = read_launches(kc)
    if not converged["stochastic_cast"] or not converged["cast"]:
        fail(f"convergence leg never launched the wire casts: {converged}")
    print(f"convergence leg ok ({time.time() - t0:.1f} s): launches "
          f"{converged}", flush=True)
    t0 = time.time()
    p2p = p2p_main_path(kc)
    print(f"p2p path ok ({time.time() - t0:.1f} s): launches {p2p}",
          flush=True)
    t0 = time.time()
    seqp = seq_parallel_main_path(kc, dev)
    print(f"sequence-parallel path ok ({time.time() - t0:.1f} s): launches "
          f"{seqp['launches']}; gaps {seqp['gaps']}", flush=True)
    # each kernel's launches over the probe's and the nine paths' runs
    launches = {k: launches[k] + rooted[k] + batched[k] + serve["launches"][k]
                + train["launches"][k] + compressed[k] + converged[k]
                + p2p[k] + seqp["launches"][k] + probed[k] for k in launches}

    # -- phase 4: timing at the main path's shapes ---------------------------
    t0 = time.time()
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
            device_ms=device_ms(
                lambda: kc.ring_allgather(blocks, out=gathered)),
            plain_ms=time_ms(lambda: kc.ring_allgather_plain(blocks)),
            # every rank's gathered output, as the kernel writes them
            library_ms=time_ms(lambda: [torch.cat(blocks, out=g)
                                        for g in gathered]),
            library_device_ms=device_ms(lambda: [torch.cat(blocks, out=g)
                                                 for g in gathered]),
            bytes=(P_MAIN + P_MAIN * P_MAIN) * (N_RANK // P_MAIN) * f4,
            ops=0,
        ),
        "combine": dict(
            ms=time_ms(lambda: kc.combine(a, b, SUM, out=c)),
            device_ms=device_ms(lambda: kc.combine(a, b, SUM, out=c)),
            plain_ms=time_ms(lambda: kc.combine_plain(a, b, SUM)),
            library_ms=time_ms(lambda: torch.add(a, b, out=c)),
            library_device_ms=device_ms(lambda: torch.add(a, b, out=c)),
            bytes=3 * N_COMBINE * f4,
            ops=N_COMBINE,
        ),
    }
    timing.update(time_rooted(xs, rand))
    del xs, outs, gathered, blocks
    torch.cuda.synchronize()
    seq = time_sequencer(rand)
    timing["sequencer"] = dict(ms=seq["ms"], plain_ms=seq["plain_ms"],
                               library_ms=seq["library_ms"])
    flash = time_flash()
    timing["flash_attention"] = flash[SERVE_T]
    flash_bounds = {T: bound(f["bytes"], f["ops"], TC16_OPS_PER_S)
                    for T, f in flash.items()}
    bwd = time_flash_bwd()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        timing[name] = dict(bwd[name], library_ms=bwd["library_bwd_ms"])
    timing["flash_attention_bwd_delta"] = bwd["flash_attention_bwd_delta"]
    timing.update(time_compression(kc, dev))
    timing.update(time_put(kc, dev))
    timing.update(time_seq_parallel(kc, dev))
    meta = {
        "ring_allreduce": ("accl_tpu_torch/csrc/ring.cu",
                           "accl_tpu/ops/pallas/ring.py:123"),
        "ring_reduce_scatter": ("accl_tpu_torch/csrc/ring.cu",
                                "accl_tpu/ops/pallas/ring.py:224"),
        "ring_allgather": ("accl_tpu_torch/csrc/ring.cu",
                           "accl_tpu/ops/pallas/ring.py:288"),
        # K3 as the rooted gather reaches it (rooted.py:280-297)
        "ring_gather": ("accl_tpu_torch/csrc/ring.cu",
                        "accl_tpu/ops/pallas/ring.py:288"),
        "combine": ("accl_tpu_torch/csrc/combine.cu",
                    "accl_tpu/ops/pallas/combine.py:40"),
        "ring_bcast": ("accl_tpu_torch/csrc/rooted.cu",
                       "accl_tpu/ops/pallas/rooted.py:59"),
        "ring_reduce": ("accl_tpu_torch/csrc/rooted.cu",
                        "accl_tpu/ops/pallas/rooted.py:95"),
        "ring_scatter": ("accl_tpu_torch/csrc/rooted.cu",
                         "accl_tpu/ops/pallas/rooted.py:133"),
        "sequencer": ("accl_tpu_torch/csrc/cmdring.cu",
                      "accl_tpu/ops/pallas/cmdring.py:534"),
        "flash_attention": ("accl_tpu_torch/csrc/attention.cu",
                            "accl_tpu/ops/pallas/attention.py:293"),
        "flash_attention_bwd_dq": ("accl_tpu_torch/csrc/attention_bwd.cu",
                                   "accl_tpu/ops/pallas/attention.py:451"),
        "flash_attention_bwd_dkv": ("accl_tpu_torch/csrc/attention_bwd.cu",
                                    "accl_tpu/ops/pallas/attention.py:503"),
        # not a TPU kernel: the XLA pass of _flash_bwd_impl :570-572
        "flash_attention_bwd_delta": ("accl_tpu_torch/csrc/attention_bwd.cu",
                                      "accl_tpu/ops/pallas/attention.py:570"),
        "cast": ("accl_tpu_torch/csrc/compression.cu",
                 "accl_tpu/ops/pallas/compression.py:35"),
        "stochastic_cast": ("accl_tpu_torch/csrc/compression.cu",
                            "accl_tpu/ops/pallas/compression.py:42"),
        "quantize_int8": ("accl_tpu_torch/csrc/compression.cu",
                          "accl_tpu/ops/pallas/compression.py:129"),
        "dequantize_int8": ("accl_tpu_torch/csrc/compression.cu",
                            "accl_tpu/ops/pallas/compression.py:141"),
        "fused_shift": ("accl_tpu_torch/csrc/put.cu",
                        "accl_tpu/ops/pallas/put.py:66"),
        "probe_copy": ("accl_tpu_torch/csrc/probe.cu",
                       "accl_tpu/compat.py:248"),
        "alltoall": ("accl_tpu_torch/csrc/alltoall.cu",
                     "accl_tpu/ops/pallas/alltoall.py:38"),
        "ring_attention": ("accl_tpu_torch/csrc/ring_attention.cu",
                           "accl_tpu/ops/pallas/attention.py:111"),
    }
    kernels = []
    for name in kc.KERNELS:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            **(seq["bound"] if name == "sequencer"
               else flash_bounds[SERVE_T] if name == "flash_attention"
               else bound(t["bytes"], t["ops"], TC16_OPS_PER_S)
               if name in TC_KERNELS else bound(t["bytes"], t["ops"])),
            "library_ms": t["library_ms"],
        })
        if name == "sequencer":  # the other windows of the bounds table
            kernels[-1].update({
                "device_ms": seq["device_ms"],
                "library_device_ms": seq["library_device_ms"],
                "ptxas": tile_regs["sequencer"],
                "window_64k_ms": seq["window_64k_ms"],
                "window_64k_device_ms": seq["window_64k_device_ms"],
                "window_64k_plain_ms": seq["window_64k_plain_ms"],
                "window_64k_bound_ms": seq["window_64k_bound"]["bound_ms"],
                "window_64k_library_ms": seq["window_64k_library_ms"],
                "window_64k_library_device_ms":
                    seq["window_64k_library_device_ms"],
                "mix_4mib_ms": seq["mix_4mib_ms"],
                "mix_4mib_device_ms": seq["mix_4mib_device_ms"],
                "mix_4mib_plain_ms": seq["mix_4mib_plain_ms"],
                "mix_4mib_bound_ms": seq["mix_4mib_bound"]["bound_ms"],
            })
        if name == "flash_attention":  # run B's shape, and where it ran
            f = flash[SERVE_LONG]
            kernels[-1].update({
                "shape": [SERVE_B, 16, SERVE_T, 128],
                "launches_generate": serve["run_a"],
                "launches_prefill_1024": serve["run_b"],
                "device_ms": flash[SERVE_T]["device_ms"],
                "library_device_ms": flash[SERVE_T]["library_device_ms"],
                "t1024_ms": f["ms"], "t1024_plain_ms": f["plain_ms"],
                "t1024_device_ms": f["device_ms"],
                "t1024_bound_ms": flash_bounds[SERVE_LONG]["bound_ms"],
                "t1024_bound_by": flash_bounds[SERVE_LONG]["bound_by"],
                "t1024_library_ms": f["library_ms"],
                "t1024_library_device_ms": f["library_device_ms"],
            })
            f = bwd["fwd"]  # the training shape, with LSE
            b = bound(f["bytes"], f["ops"], TC16_OPS_PER_S)
            kernels[-1].update({
                "launches_train": train["launches"][name],
                "train_shape": [TRAIN_B, TRAIN["n_heads"], TRAIN_T, 128],
                "train_ms": f["ms"], "train_plain_ms": f["plain_ms"],
                "train_device_ms": f["device_ms"],
                "train_bound_ms": b["bound_ms"],
                "train_bound_by": b["bound_by"],
                "train_library_ms": f["library_ms"],
                "train_library_device_ms": f["library_device_ms"],
            })
        if name in TRAIN_KERNELS[1:]:  # the backward at the training shape
            kernels[-1].update({
                "shape": [TRAIN_B, TRAIN["n_heads"], TRAIN_T, 128],
                "device_ms": t["device_ms"],
            })
        if name in TRAIN_KERNELS[2:]:  # the library call's whole backward
            dl = bwd["flash_attention_bwd_delta"]
            kernels[-1].update({
                "wgmma_launches_train": train["wgmma"][name],
                "library_computes": "dq, dk and dv (one backward call)",
                "library_device_ms": bwd["library_bwd_device_ms"],
                "delta_ms": dl["ms"], "delta_device_ms": dl["device_ms"],
                "bwd_sum_ms": bwd["flash_attention_bwd_dq"]["ms"]
                + bwd["flash_attention_bwd_dkv"]["ms"] + dl["ms"],
                "bwd_sum_device_ms": bwd["flash_attention_bwd_dq"]["device_ms"]
                + bwd["flash_attention_bwd_dkv"]["device_ms"]
                + dl["device_ms"],
            })
        if name in COMP_KERNELS:  # at 32 Mi float32 elements
            kernels[-1]["elements"] = N_COMP
            kernels[-1].update({k: v for k, v in t.items()
                                if k.startswith(("wire_seg", "rows4_",
                                                 "widen_", "device_ms",
                                                 "library_device_ms"))})
        if name == "cast":
            kernels[-1]["ptxas"] = cast_regs
        if name == "quantize_int8":
            kernels[-1].update({
                "geometry": t["geometry"],
                "ptxas": {k: tile_regs[k] for k in ("quantize_lanes",
                                                    "quantize_cluster")}})
        if name == "probe_copy":  # device time alone, beside clone's
            kernels[-1].update({
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"],
            })
        if name == "alltoall":  # Ulysses' q re-shard at full width
            kernels[-1]["shape"] = t["shape"]
        if name == "ring_attention":  # the other layouts at full width
            kernels[-1].update({
                "shape": t["shape"], "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"],
                "striped_ms": t["striped_ms"],
                "striped_device_ms": t["striped_device_ms"],
                "striped_plain_ms": t["striped_plain_ms"],
                "full_ms": t["full_ms"], "full_device_ms": t["full_device_ms"],
                "full_bound_ms": bound(t["bytes"], t["full_ops"],
                                       TC16_OPS_PER_S)["bound_ms"],
                "full_library_ms": t["full_library_ms"],
                "full_library_device_ms": t["full_library_device_ms"],
            })
        if name in TILE_KERNELS:  # the tile core's rows, by device time
            kernels[-1].update({
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"],
                "ptxas": tile_regs[name],
            })
    for k in kernels:
        lib = k["library_ms"]
        print(f"{k['name']}: kernel_ms={k['ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} plain_ms={k['plain_ms']:.4f} "
              f"library_ms={'-' if lib is None else f'{lib:.4f}'}")
    by_name = {k["name"]: k for k in kernels}
    for name in TILE_KERNELS:
        k = by_name[name]
        print(f"{name} (tile core): device_ms={k['device_ms']:.4f} "
              f"({k['bound_ms'] / k['device_ms']:.3f} of the bound) against "
              f"the library call's {k['library_device_ms']:.4f} "
              f"({k['bound_ms'] / k['library_device_ms']:.3f})")
    s_ = by_name["sequencer"]
    print(f"sequencer device_ms={s_['device_ms']:.4f} "
          f"({s_['bound_ms'] / s_['device_ms']:.3f} of the bound) against "
          f"the library call's {s_['library_device_ms']:.4f}; "
          f"8 x allreduce 64K: "
          f"kernel_ms={s_['window_64k_ms']:.4f} "
          f"device_ms={s_['window_64k_device_ms']:.4f} "
          f"bound_ms={s_['window_64k_bound_ms']:.4f}; facade mix at 4 MiB:"
          f" kernel_ms={s_['mix_4mib_ms']:.4f} "
          f"device_ms={s_['mix_4mib_device_ms']:.4f} "
          f"bound_ms={s_['mix_4mib_bound_ms']:.4f} "
          f"plain_ms={s_['mix_4mib_plain_ms']:.4f}")
    print_attention_fwd(by_name, flash[SERVE_LONG], bwd["fwd"],
                        timing["ring_attention"])
    d = by_name["flash_attention_bwd_dkv"]
    print(f"flash backward (8,32,1024,128) bf16 causal: dq + dk/dv + delta "
          f"= {d['bwd_sum_ms']:.4f} ms (device {d['bwd_sum_device_ms']:.4f})"
          f" against scaled_dot_product_attention's backward "
          f"{d['library_ms']:.4f} ms (device {d['library_device_ms']:.4f}); "
          f"device ms dq {by_name['flash_attention_bwd_dq']['device_ms']:.4f}"
          f" dk/dv {d['device_ms']:.4f} delta {d['delta_device_ms']:.4f}")
    p_ = by_name["probe_copy"]
    print(f"probe_copy device_ms={p_['device_ms']:.4f} against "
          f"Tensor.clone's {p_['library_device_ms']:.4f}")
    c_ = by_name["cast"]
    print(f"cast (row 5) f32->bf16 32Mi: device_ms={c_['device_ms']:.4f} "
          f"against Tensor.to's {c_['library_device_ms']:.4f}, "
          f"{c_['bound_ms'] / c_['device_ms']:.3f} of the bound; 4 x 16Mi "
          f"->bf16 device_ms={c_['rows4_bf16_device_ms']:.4f} (Tensor.to "
          f"{c_['rows4_bf16_library_device_ms']:.4f}), ->e4m3 "
          f"{c_['rows4_e4m3_device_ms']:.4f} (Tensor.to "
          f"{c_['rows4_e4m3_library_device_ms']:.4f}); bf16->f32 32Mi "
          f"{c_['widen_device_ms']:.4f} (Tensor.to "
          f"{c_['widen_library_device_ms']:.4f})")
    q_ = by_name["quantize_int8"]
    print(f"quantize (row 7) f32 32Mi: Pallas tiles {q_['geometry']} "
          f"device_ms={q_['device_ms']:.4f} "
          f"({q_['bound_ms'] / q_['device_ms']:.3f} of the bound), "
          f"kernel_ms={q_['ms']:.4f}; wire L=256 device_ms "
          f"{q_['wire_seg_device_ms']:.4f} (seed 9: "
          f"{q_['wire_seg_sr_device_ms']:.4f}; "
          f"{q_['wire_seg_bound_ms'] / q_['wire_seg_device_ms']:.3f} of the "
          f"bound)")
    lp = launch_path(kc)
    print(json.dumps({"launch_path": {
        "card": smi.stdout.strip().splitlines()[0], **lp}}))
    del a, b, c
    torch.cuda.synchronize()
    print(f"kernel timing done ({time.time() - t0:.1f} s)", flush=True)

    # -- phase 5: the facade allreduce end to end ----------------------------
    t0 = time.time()
    facade = facade_latency([64 * 1024, 1024 * 1024, N_RANK],
                            ["xla", "pallas_ring", "pallas_ring_bidir"])
    print(json.dumps({"facade_allreduce": facade}))
    facade = facade_rooted_latency([64 * 1024, 1024 * 1024, N_RANK])
    print(json.dumps({"facade_rooted": facade}))
    facade = facade_batch_latency([64 * 1024, 256 * 1024, 1024 * 1024])
    print(json.dumps({"facade_batch": facade}))
    facade = facade_compressed_latency([1024 * 1024, N_RANK])
    print(json.dumps({"facade_compressed": {
        "card": smi.stdout.strip().splitlines()[0], "rows": facade}}))
    print(f"facade timing before facade_p2p ({time.time() - t0:.1f} s)",
          flush=True)
    t0 = time.time()
    facade = facade_p2p_latency(P2P_SIZES)
    print(f"facade_p2p timing ({time.time() - t0:.1f} s)", flush=True)
    print(json.dumps({"facade_p2p": {
        "card": smi.stdout.strip().splitlines()[0], "rows": facade}}))
    print(json.dumps({"compression_convergence": {
        "card": smi.stdout.strip().splitlines()[0], **convergence}}))
    t0 = time.time()
    served = serve_timing(serve)
    del serve
    print(json.dumps({"serve_generate": {
        "card": smi.stdout.strip().splitlines()[0], **served}}))
    trained = train_timing(train)
    del train
    print(f"serving and training timing ({time.time() - t0:.1f} s)",
          flush=True)
    print(json.dumps({"train_step": {
        "card": smi.stdout.strip().splitlines()[0], **trained}}))
    t0 = time.time()
    seq_lat = seq_parallel_latency(dev)
    print(f"seq_parallel_attention timing ({time.time() - t0:.1f} s)",
          flush=True)
    print(json.dumps({"seq_parallel_attention": {
        "card": smi.stdout.strip().splitlines()[0], **seq_lat,
        "gaps": seqp["gaps"]}}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
