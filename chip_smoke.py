#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``accl_tpu_torch``) once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --launch-path   # phase 4's launch path alone
    python3 chip_smoke.py --dispatch      # phase 3i and facade_dispatch
    python3 chip_smoke.py --cp            # phase 3j, rows 16-18 at T = 4096
    python3 chip_smoke.py --topology      # phase 3k and facade_topology
    python3 chip_smoke.py --telemetry     # phase 3l (telemetry, monitor)
    python3 chip_smoke.py --faults        # phase 3m (faults, membership,
                                          # the contract)
    python3 chip_smoke.py --arbiter       # phase 3n (the in-flight
                                          # window, the QoS arbiter)
    python3 chip_smoke.py --models        # phase 3o (MoE, the encoder,
                                          # ZeRO-1 Adam) and its records
    python3 chip_smoke.py --pipeline      # phase 3p (the pipeline, the
                                          # composed trainer, the example)

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
   (``inplace_window``); the fp8 (e4m3, e5m2) and int8 lanes, seed 0 and
   seeded, at P 2, 3, 4, 8 over every class (a per-rank count off the
   256-element segments), bfloat16 and float16 operands, misaligned and
   ragged windows and a seeded 16-bit wire, through the fp8 / int8
   instantiation; the persistent form (``check_persistent``) over six
   streams of 4 windows, one launch each, against the same plain
   version with its mapped status words, and its budget and linger
   exits.  K1 also runs its fp8 lanes and its raw int8 cast.  Rows 5-8
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
      sequencer launch and no other kernel launch; then the rest of the
      ring (``ring_main_path``): an int8 and an fp8 window (one launch
      of the fp8 / int8 instantiation, equal to ``sequencer_plain`` on
      the slot words the ring encoded, seeds included), a sustained
      stream of 8 windows of 8 allreduces (warm: at most one dispatch,
      at least 7 mailbox posts, then parked), a pair-slot window on the
      sub-communicator [0, 1], and a kernel on another stream behind a
      lingering run (within the linger + 1 ms); then windows the ring
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
   i. the dispatch path (``dispatch_main_path``; ``--dispatch`` runs it
      and ``facade_dispatch`` alone): sub-communicators at P = 1, 2 and
      3 of ``cuda_group(4)`` at 64 MiB a rank under every allreduce
      register, a bcast and a reduce rooted at rank 1 of [2, 3], a
      gather rooted at rank 1 of [1, 3] (K3), a batched window of 8 on
      [0, 1], the warm call (1 device interaction, a plan hit), a
      register write (one re-plan), 8 x 16 MiB refused by the ring and
      run as one fused dispatch, and a host-only bfloat16 allreduce;
      each step's launches counted alone, each result held against its
      plain version (the host path against numpy's fold, bit for bit);
   j. the context-parallel path (``--cp`` runs it, rows 16-18 at T =
      4096 and ``train_cp`` alone): bench.py's long-context training
      record (the training width at T = 4096, batch 2, bfloat16, lr
      0.01) with ``context_parallel`` and ``remat`` on a ``("dp", "tp")``
      mesh of (1, 4), ``CP_STEPS`` steps of ``make_sharded_train_step``
      that launch no kernel (the striped ring is plain PyTorch, as JAX's
      is ``jnp``) and whose loss falls; one dense step on the same
      weights (``auto``: flash at T = 4096, 6 launches a step of each of
      rows 16-18's four kernels and no other); the cp and the dense
      ``loss_fn`` and gradients in bfloat16 at full width (within
      ``BF16_LOSS_RTOL`` and ``BF16_GRAD_RTOL``), and one cp step against
      one dense step in float32 with 2 layers (loss within 1e-5, updated
      weights within rtol 2e-4, atol 2e-5, JAX's cp test's bounds);
   k. the topology path (``topology_main_path``; ``--topology`` runs it
      and ``facade_topology`` alone): the four hierarchical collectives
      on ``cuda_group(8)`` at bench.py's 2 x 4 and ``cuda_group(4)`` at
      2 x 2, flat and hierarchical, the ragged leader layout and a count
      the slice does not divide, on integer-valued float32 at 64 MiB a
      rank (exact against numpy, hierarchical equal to flat bit for bit,
      each step launching exactly what its stages imply: K1, rows 9 and
      10); segmented pipelining (4 launches, 4 device interactions, equal
      to the unsplit call; async aggregates drained by ``flush()``); the
      eager register; ``autotune`` on the 4-rank group at 2 x 2 and its
      plan loaded (each bucket launches its winner's lowering);
   l. the telemetry plane and the monitor (``telemetry_main_path``;
      ``--telemetry`` runs it and its cost alone) on ``cuda_group(4)``,
      float32: warm ``pallas_ring`` allreduces at 256 KiB and 64 MiB a
      rank (one flight record a rank a call, a plan hit, 1 device
      interaction, K1's plain fold exactly); a batched window of 8
      allreduces inline and a stream of 3 such windows arming a
      persistent run (each window logged once, 8 slots, retcodes OK,
      slot trace ids equal to the records', ``mailbox_us`` on the run's
      windows); every rank's Chrome trace merged by ``python -m
      accl_tpu_torch.telemetry merge`` with its flows matched; the
      scrape routes answering 200 and a trace stream's files loadable;
   m. faults, membership and the contract (``faults_main_path``;
      ``--faults`` runs it and the verifier's cost alone), virtual ranks
      on the card: (a) a 2-rank gang with rank 1 absent fails
      RECEIVE_TIMEOUT at the 0.3 s watchdog naming it, suspect then
      dead, the third call at intake, and after ``soft_reset`` a
      ``pallas_ring`` allreduce is exact; (b) a seeded ``diverge`` on
      rank 2 of 4 fails every rank CONTRACT_VIOLATION naming it, and a
      uniform stream then passes; (c) world 4 under ``set_elastic``
      with rank 3 silent evicts it, serves at world 3 (K1 at P = 3 at 64
      MiB a rank, row 9's bcast) exactly, and ``soft_reset`` restores
      world 4; (d) windows of 8 allreduces: an open breaker takes the
      per-call path, the probe rides row 14 and closes it, a ``corrupt``
      plan poisons a window inline and one posted to a live run (row
      14's device status word reads 2), and ``soft_reset`` recovers;
   n. the in-flight window and the QoS arbiter (``arbiter_main_path``;
      ``--arbiter`` runs it and its cost alone) on ``cuda_group(4)``: (a)
      32 async ``pallas_ring`` allreduces of 4 MiB a rank, each behind a
      ~10 ms sleep kernel, never more than 4 in flight, every record but
      the last overlapped, then the records' ``duration_ns`` p50 beside
      the calls' device time; (b) a tenant's ring budget of 2 cuts a
      batch of 6 into 3 windows of row 14, inline and through one
      persistent run; (c) a GUARANTEED 256 KiB tenant alone and beside a
      BEST_EFFORT 64 MiB flooder (window share 1) from two threads a
      rank: p50 / p99, grant waits, every admission released, ``/tenants``
      serving the snapshot; (d) no breaker opens;
   o. MoE, the encoder and ZeRO-1 Adam (``models_main_path``;
      ``--models`` runs it and prints its records alone), bfloat16 on a
      ``("dp", "tp")`` mesh of (4, 1) virtual ranks, each leg's memory
      reckoned before it and its peak after, each train step launching
      rows 16-18 and the delta pass once a layer and no other kernel,
      losses finite and falling: (1) bench.py's serving model with 8
      experts, top 2 (2.4 B), ``make_sharded_generate`` of 128 steps from
      (8, 128) under flash and 8 from (8, 1024) under auto (row 16 once a
      layer each), and in float32 with 2 layers and no drops the KV
      decode against re-running the sharded forward, tie-aware; (2)
      bench.py's training model with 8 experts, top 2 (7.0 B), 3 SGD
      steps with the experts on dp (capacity 768), a profiled step
      (expert GEMMs, dense GEMMs, routing and dispatch, attention, the
      rest), one step on ("dp", "ep", "tp") = (2, 2, 1), and the MoE
      layer's backward twice, the same bits; (3) rows 16-18 and the delta
      pass with ``causal=False`` at (8, 32, 1024, 128) against their
      plain versions (phase 2's tolerances) and timed beside SDPA's
      non-causal forward and backward, then the encoder at the training
      widths, 3 MLM steps of ``make_sharded_encoder_step`` (a seeded 15 %
      mask; rows 16-18 counted non-causal), and its float32 ``mlm_loss``
      and gradients, flash against naive, 2 layers x batch 2; (4)
      ``make_zero_train_step`` (master weights, clipping at 1.0, a 2-step
      warmup) on the dense training model and on the MoE model of (2) cut
      to 2 layers, 3 steps each, the first step's loss and master weights
      against the plain Adam step on whole tensors;
   p. the pipeline, the composed trainer and the training example
      (``pipeline_main_path``; ``--pipeline`` runs it and prints its
      record alone): bench.py's training model (1,346M, bfloat16,
      ``attention="flash"``, 8 x 1024) through ``make_pp_train_step`` on
      (pp 2, dp 2, tp 1) virtual ranks, 4 microbatches, from one seeded
      set of weights: (a) GPipe, (b) 1F1B, (c) interleaved with 3 chunks
      a rank, (d) GPipe with ZeRO-1 Adam (``ZERO_ADAM``), 3 steps each,
      the third under ``torch.profiler``; each step launches rows 16-18
      and the delta pass once a layer a microbatch (24; row 16 48 under
      1F1B: its forward tick and its recompute) and no other kernel, by
      the wrappers' counters and by the profiler's kernel names; losses
      finite and falling, the first within ``PP_LOSS_RTOL`` of
      ``make_sharded_train_step``'s on (dp 2, tp 1) with the same batch;
      peak memory beside the leg's reckoning; (e) the training example
      (``examples/train.py``): a seeded token file through the native
      loader (built with g++ here), 4 pipeline steps saved every 2, a
      resume to 6 equal bit for bit to an uninterrupted 6-step run;
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
   18 and the delta pass), each also by device time alone, and rows
   16-18 and the delta pass again at phase 3j's dense (2, 32, 4096, 128)
   as ``t4096_*`` keys (no plain version there); rows 5-8 at 32 Mi
   float32 elements (cast and stochastic
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
   256 KiB, 1 MiB and 4 MiB per rank, and the stream form (8 such windows
   a sample posted into one persistent run: per window p50 / p90, launch
   p50, dispatches and posts), each set as a JSON line of its own;
   ``facade_ring``: a batched send -> recv pair on ``cuda_group(2)`` (one
   ring slot) at 256 KiB and 4 MiB, and phase 3c's stream and
   starvation figures;
   then the serving path (``serve_generate``): run A's prefill ms, the
   decode step p50, decode tokens/s over ``generate``'s wall time, and
   run B's prefill ms; then the training path (``train_step``): the step
   time (bench.py's mean over 10 steps, p50 and p90 beside it),
   tokens/s, bench.py's 6 N B T count over the step as ``train_tflops``
   and over 989 TFLOP/s as ``train_mfu``, peak memory, and the three
   kernels' launches per step; then ``train_cp``: the same figures for
   phase 3j's cp step and for the dense T = 4096 step beside it, each
   with a profiled step's device time by class (the float32 fold
   matmuls, the bf16 dense matmuls, the rest) and idle share, and phase
   3j's gaps; then ``facade_compressed`` (p50 and p90
   per wire lane and register at 4 MiB and 64 MiB per rank, beside the
   uncompressed call), ``facade_p2p`` (p50 and p90 of send -> recv
   completed, the P = 4 ring shift and ``stream_put`` -> ``stream_pop``
   at 256 KiB, 4 MiB and 64 MiB, and the three ``vadd_put`` forms at
   64 MiB) and ``compression_convergence`` (the leg's losses and
   ``delta_pct``); then ``seq_parallel_attention``: host-clock p50 /
   p90 of one call at the main path's width (20 calls after 2 warm-ups)
   for Ulysses (``_a2a``), Ulysses with row 12, the ppermute
   ``ring_attention`` and row 15 over contiguous and striped shards,
   with each form's peak memory and phase 3h's gaps; and
   ``facade_dispatch`` (after ``facade_batch``): the warm
   ``pallas_ring`` allreduce at 256 KiB and 4 MiB on the world and on a
   2-rank sub-communicator (p50, p90, launch p50, interactions a call,
   the plan hit rate) and 8 x 16 MiB fused against one by one; and
   ``facade_topology``: flat against hierarchical p50 / p90 of the four
   collectives on the 2 x 4 group at 4 and 64 MiB a rank, the pipelined
   against the unsplit allreduce on 4 ranks at 64 MiB, and the
   autotuner's wall time and winners; and ``telemetry``: phase 3l's
   figures and the plane's cost (``telemetry_cost``: the warm 256 KiB
   ``pallas_ring`` call and launch p50 / p90 with the plane on against a
   group built under ``ACCL_TELEMETRY=0``, 5 interleaved rounds of 30
   calls, and the records' ``duration_ns`` p50 beside the same calls'
   device time by CUDA events); and ``faults``: phase 3m's figures and
   the contract verifier's cost (``faults_cost``: the warm 256 KiB
   ``pallas_ring`` call and launch p50 with the verifier armed against
   disarmed, 5 interleaved rounds of 30 calls, each p50 with its
   rounds' range); and ``arbiter``: phase 3n's figures and the warm 256
   KiB call at window depth 1 against the default depth
   (``arbiter_cost``); and phase 3o's records (``print_models``), a line
   a leg: ``moe_serve`` (runs A and B: wall time, ms a step, tokens/s),
   ``moe_train``, ``encoder_train`` and ``zero_adam`` (step ms, tokens/s,
   peak against reckoned memory, launches by kernel a step, the losses;
   the MoE step's profiled device time by class and idle share), and
   ``flash_full_attention`` (rows 16-18 and the delta pass non-causal at
   (8, 32, 1024, 128): ms, device ms, plain ms, bound, SDPA's forward and
   backward); and phase 3p's ``pipeline_train`` (the flagship's loss and
   step ms on (dp 2, tp 1), then each leg's step ms, tokens/s, the
   profiled step's device busy ms and idle share, peak against reckoned
   memory, launches a step by the counters and the profiler, losses, the
   bubble fraction, and the example's losses and resume).

The second-to-last line is the ``{"kernels": [...]}`` JSON object, the last
``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import json
import math
import os
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
#: phase 3i's batch the ring refuses: 16 MiB float32 a rank, over the
#: ring's 4 MiB payload limit
FUSED_BATCH_N = 4 * 1024 * 1024
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


#: one record a stream hold: the full collections the run made before
#: it, what the one before the hold found, its time, and the objects
#: alive after it (printed as ``gc_holds``)
GC_HOLDS = []


def hold_stream(cycles: int) -> None:
    """Hold the current stream behind a sleep kernel of ``cycles`` clock
    cycles, so the host posts windows ahead of the device (the streams,
    runs and lingers the ring's checks need).  A full garbage collection
    comes first and is recorded in ``GC_HOLDS``: a collection of the
    script's heap takes longer than the sleep, and one landing inside the
    held window would let the device catch up."""
    import gc

    import torch

    full = gc.get_stats()[2]["collections"]
    t = time.perf_counter()
    found = gc.collect()
    GC_HOLDS.append({"collected": found, "full_before": full,
                     "ms": (time.perf_counter() - t) * 1e3,
                     "objects": len(gc.get_objects())})
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)


def check_circuit_opens(what: str, want: int) -> None:
    """Fail unless the command rings' breakers have refused exactly
    ``want`` batches in this process: only phase 3m (d) opens one, on
    purpose, and a breaker open anywhere else is a fault."""
    from accl_tpu_torch.backends.cuda.cmdring import circuit_open_total

    got = circuit_open_total()
    if got != want:
        fail(f"{what}: an open breaker refused {got} batches, want {want}")


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
#: clock cycles of the sleep kernel that holds the stream before a stream
#: of windows (~0.1 s): the host posts the second window while the first
#: is still in flight, as behind a busy card, and the stream arms a run
STREAM_SLEEP = 200_000_000


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
               skew_rank=None, flags=0):
    """A window of ``ops`` ((opcode, root, peer) per slot), every slot with
    its own operands and results, made from ``seed`` (the same seed makes
    the same window).  SUM and MAX alternate by slot; floats carry NaNs.
    ``offset`` misaligns every operand by that many elements; with
    ``skew_rank`` only that rank's operands and results, by one element
    (each rank decides its own alignment in the kernel).  A nonzero
    ``flags`` seeds the wire lanes, slot i with ``flags + 7 i``."""
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
            flags=flags + 7 * i if flags else 0,
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
    cooperative launch) and every in-place form; then the fp8 and int8
    lanes (the LANES instantiation), seeded and not."""
    import torch

    from accl_tpu_torch.constants import CmdOpcode as Op
    from accl_tpu_torch.ops.cuda import cmdring as kseq

    F32, BF16, F16, I32 = (torch.float32, torch.bfloat16, torch.float16,
                           torch.int32)

    mix = seq_mix

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
    # the fp8 and int8 lanes (the LANES instantiation), unseeded and
    # seeded, every width class; a per-rank count off the 256-element
    # segments (a reduce-scatter's or alltoall's chunk at a * n starts
    # inside one), ragged and misaligned, 16-bit operands
    E4M3, E5M2, I8 = torch.float8_e4m3fn, torch.float8_e5m2, torch.int8
    n_off = SEQ_N // 4 + 1003
    for wire in (E4M3, E5M2, I8):
        for seed in (0, 1234567):
            for P in (2, 3, 4, 8):
                cases.append((f"P={P} f32 wire {wire} seed {seed}",
                              lambda s, P=P, w=wire, f=seed: seq_window(
                                  P, F32, mix(P), n_off, s, wires=[w],
                                  flags=f)))
        for dtype in (BF16, F16):
            cases.append((f"P=4 {dtype} wire {wire} seed 99",
                          lambda s, d=dtype, w=wire: seq_window(
                              4, d, mix(4), 100_003, s, wires=[w],
                              flags=99)))
        cases.append((f"P=3 f32 wire {wire} misaligned, unwired slots",
                      lambda s, w=wire: seq_window(
                          3, F32, mix(3)[:8], 100_003, s,
                          wires=[w, None], flags=5, offset=1)))
    # a 16-bit wire under a nonzero seed rounds stochastically (LANES)
    cases.append(("P=4 f32 wire bf16 seed 3", lambda s: seq_window(
        4, F32, mix(4)[:8], n_off, s, wires=[BF16, F16], flags=3)))
    lanes_cases = 0
    for k, (tag, build) in enumerate(cases):
        got = build(SEED + k)
        want = build(SEED + k)
        lanes = kseq.takes_lanes(got[0], got[3].wires)
        lanes_cases += lanes
        counter = kseq.sequencer_lanes if lanes else kseq.sequencer
        before = counter.launches.count
        st = kseq.sequencer(*got[:4], device=torch.device("cuda", 0))
        if counter.launches.count == before:
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
        key = "sequencer_lanes" if lanes else "sequencer"
        for i, (o, w) in enumerate(pairs):
            err[key] = max(err[key], compare(
                f"sequencer {tag} tensor {i}", o, w))
        del got, want
        torch.cuda.synchronize()
    print(f"sequencer: {len(cases)} windows agree with sequencer_plain "
          f"({lanes_cases} through the fp8 / int8 instantiation)",
          flush=True)


def seq_mix(P, floats=True):
    """check_sequencer's mix of every opcode class at world size P."""
    from accl_tpu_torch.constants import CmdOpcode as Op

    ops = [(Op.ALLREDUCE, 0, 0), (Op.ALLREDUCE, 0, 0),
           (Op.BCAST, 0, 0), (Op.BCAST, P - 1, 0),
           (Op.REDUCE_SCATTER, 0, 0), (Op.ALLGATHER, 0, 0),
           (Op.ALLTOALL, 0, 0), (Op.BARRIER, 0, 0), (Op.NOP, 0, 0),
           (0x7F, 0, 0),  # an opcode outside the enum: BAD_OP
           (Op.SEND, 1, P - 1), (Op.RECV, 0, 1)]
    if floats:
        ops += [(Op.FUSED_APPLY, 0, 0), (Op.FUSED_MATMUL_RS, 0, 0),
                (Op.FUSED_ATTN_HOP, 0, 1), (Op.FUSED_ATTN_HOP, 0, P - 1)]
    return ops


def check_persistent(err) -> dict:
    """Phase 2 for row 14's persistent form: streams of 4 windows, each
    stream one ``PersistentRun`` (one launch) of its shape, launched after
    its first post and fed the rest while it runs, held exactly against
    ``sequencer_plain`` window by window, status words included (read from
    the run's mapped memory), over P 2, 3, 4 and 8, plain, fp8 and int8
    windows of every class; then the three ways a run returns: the HALT
    doorbell, its window budget and its linger."""
    import torch

    from accl_tpu_torch.ops.cmdring import status_words
    from accl_tpu_torch.ops.cuda import cmdring as kseq

    F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32
    E4M3, E5M2, I8 = torch.float8_e4m3fn, torch.float8_e5m2, torch.int8
    dev = torch.device("cuda", 0)
    n_off = SEQ_N // 4 + 1003
    streams = [
        ("P=4 f32 every class", lambda s: seq_window(
            4, F32, seq_mix(4), n_off, s)),
        ("P=4 f32 int8 seeded", lambda s: seq_window(
            4, F32, seq_mix(4), n_off, s, wires=[I8], flags=77)),
        ("P=2 bf16 e4m3 seeded", lambda s: seq_window(
            2, BF16, seq_mix(2)[:8], 100_003, s, wires=[E4M3], flags=9)),
        ("P=8 f32 e5m2 seed 0", lambda s: seq_window(
            8, F32, seq_mix(8)[:8], n_off, s, wires=[E5M2])),
        ("P=3 i32 plain", lambda s: seq_window(
            3, I32, seq_mix(3, False), 100_003, s)),
        ("P=4 f32 8 x allreduce", lambda s: seq_window(
            4, F32, [seq_mix(4)[0]] * 8, SEQ_N, s)),
    ]
    for j, (tag, build) in enumerate(streams):
        got = [build(SEED + 600 + 10 * j + k) for k in range(4)]
        want = [build(SEED + 600 + 10 * j + k) for k in range(4)]
        slots, xs, _, shape = got[0]
        P = len(xs[0])
        before = kseq.PersistentRun.launches.count
        run = kseq.PersistentRun(shape, P, dev, 8, 0.5,
                                 kseq.takes_lanes(slots, shape.wires))
        ks = []
        for i, win in enumerate(got):
            k = run.post(*win[:3])
            if k is None:
                fail(f"persistent {tag}: window {i} refused")
            ks.append(k)
            if i == 0:
                run.launch()
        for k in ks:
            if not run.wait_window(k, 60.0):
                fail(f"persistent {tag}: window {k}: {run.failed}")
        statuses = [run.status(k, got[0][0].shape[0]) for k in ks]
        if not run.join(10.0) or run.exited() != kseq.EXIT_HALT:
            fail(f"persistent {tag}: the run did not return on HALT "
                 f"(exited {run.exited()})")
        if kseq.PersistentRun.launches.count != before + 1:
            fail(f"persistent {tag}: not one launch for the stream")
        torch.cuda.synchronize()
        key = ("sequencer_lanes" if kseq.takes_lanes(slots, shape.wires)
               else "sequencer")
        for i, (g, w) in enumerate(zip(got, want)):
            kseq.sequencer_plain(*w[:4])
            if (statuses[i] != status_words(g[0])).any():
                fail(f"persistent {tag}: window {i} status words")
            for rg, rw in zip(g[2], w[2]):
                for o, ref in zip(rg, rw):
                    if o is not None:
                        err["sequencer_run"] = max(
                            err["sequencer_run"],
                            compare(f"persistent {tag} window {i}", o, ref))
        del got, want
        torch.cuda.synchronize()
    # the budget and the linger
    win = seq_window(4, F32, seq_mix(4)[:2], 4096, SEED + 700)
    run = kseq.PersistentRun(win[3], 4, dev, 2, 0.5, False)
    run.post(*win[:3])
    run.launch()
    run.post(*win[:3])
    run.wait_window(1, 60.0)
    t0 = time.time()
    while not run.ended() and time.time() - t0 < 10:
        time.sleep(1e-3)
    if run.exited() != kseq.EXIT_BUDGET or run.post(*win[:3]) is not None:
        fail(f"persistent: the window budget did not end the run "
             f"(exited {run.exited()})")
    run.join(1.0)
    run = kseq.PersistentRun(win[3], 4, dev, 8, 0.002, False)
    run.post(*win[:3])
    run.launch()
    run.wait_window(0, 60.0)
    t0 = time.time()
    while not run.ended() and time.time() - t0 < 10:
        time.sleep(1e-4)
    lingered = time.time() - t0
    if run.exited() != kseq.EXIT_LINGER:
        fail(f"persistent: the linger did not end the run "
             f"(exited {run.exited()})")
    run.join(1.0)
    closed = check_closing(kseq, dev, win, err)
    print(f"persistent sequencer: {len(streams)} streams of 4 windows agree "
          f"with sequencer_plain, one launch each; budget and linger "
          f"(2 ms: returned {lingered * 1e3:.2f} ms after its window) end "
          f"a run; closing handshake: {closed}", flush=True)
    return closed


def check_closing(kseq, dev, win, err) -> dict:
    """The closing handshake between a post and a run lingering out: (a) a
    post held up inside ``post`` (its descriptor step delayed 100 ms)
    past a 20 ms linger is refused with None, the run having closed
    without it (``closed_posts``), and the window then runs on a fresh
    run, equal to ``sequencer_plain``; (b) 96 posts at random intervals
    of 0-2 ms into runs of a 1 ms linger, each refused one re-posted to a
    fresh run: every window's status words right and every result equal
    to ``sequencer_plain``'s, no window lost."""
    import random

    import torch

    from accl_tpu_torch.ops.cmdring import status_words

    slots, xs, outs, shape = win
    want = [[None if o is None else torch.empty_like(o) for o in row]
            for row in outs]
    kseq.sequencer_plain(slots, xs, want, shape)
    n = slots.shape[0]

    def check(tag, run, k):
        if not run.wait_window(k, 60.0):
            fail(f"closing {tag}: window {k}: {run.failed}")
        if (run.status(k, n) != status_words(slots)).any():
            fail(f"closing {tag}: window {k}'s status words")

    def results(tag):
        torch.cuda.synchronize()
        for row, ref in zip(outs, want):
            for o, w in zip(row, ref):
                if o is not None:
                    err["sequencer_run"] = max(err["sequencer_run"],
                                               compare(tag, o, w))

    out = {}
    # (a) a post delayed past the linger inside post()
    run = kseq.PersistentRun(shape, len(xs[0]), dev, 8, 0.02, False)
    run.post(slots, xs, outs)
    run.launch()
    check("(a)", run, 0)
    closed0 = kseq.PersistentRun.closed_posts.count
    real = kseq._descriptor

    def slow(*a, **kw):
        time.sleep(0.1)
        return real(*a, **kw)

    kseq._descriptor = slow
    try:
        k = run.post(slots, xs, outs)
    finally:
        kseq._descriptor = real
    if (k is not None or run.exited() != kseq.EXIT_LINGER
            or kseq.PersistentRun.closed_posts.count != closed0 + 1):
        fail(f"closing (a): a post delayed past the linger gave {k}, "
             f"exited {run.exited()}, closed posts "
             f"{kseq.PersistentRun.closed_posts.count - closed0}")
    run.join(5.0)
    for o in (o for row in outs for o in row if o is not None):
        o.zero_()
    run = kseq.PersistentRun(shape, len(xs[0]), dev, 8, 0.02, False)
    run.post(slots, xs, outs)
    run.launch()
    check("(a) re-posted", run, 0)
    run.join(5.0)
    results("closing (a) re-posted window")
    # (b) posts at random intervals around a 1 ms linger
    rnd = random.Random(SEED)
    runs, closed0 = 0, kseq.PersistentRun.closed_posts.count
    run = None
    for i in range(96):
        time.sleep(rnd.uniform(0.0, 0.002))
        k = None if run is None else run.post(slots, xs, outs)
        if k is None:
            if run is not None:
                run.join(5.0)
            run = kseq.PersistentRun(shape, len(xs[0]), dev, 128, 0.001,
                                     False)
            runs += 1
            k = run.post(slots, xs, outs)
            run.launch()
        check(f"(b) post {i}", run, k)
    run.join(5.0)
    results("closing (b) stream")
    out.update(runs=runs, posts=96,
               closed_posts=kseq.PersistentRun.closed_posts.count - closed0)
    return out


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


def ring_main_path(kc) -> dict:
    """Phase 3c, the rest of the command ring (ROADMAP A5) on
    ``cuda_group(4)``: (a) a batched int8 and an fp8 (e4m3) window of an
    allreduce, a reduce_scatter and an alltoall at 256 KiB a rank, each
    one refill with the fallbacks unchanged, one launch of the LANES
    instantiation and no other kernel, its results equal to
    ``sequencer_plain`` on the same operands and the slot words the ring
    encoded (seeds included); (b) a sustained stream of K = 8 windows of 8
    allreduces at 1 MiB a rank, posted without a drain between them, a
    cold pass then a warm one: the warm pass at most one dispatch and at
    least K - 1 mailbox posts, the ring ``parked`` once the linger has
    passed, the sums exact; (c) a window of a matched send / recv pair
    and an allreduce on the 2-rank sub-communicator [0, 1]: one refill,
    the pair one slot; (d) the starvation bound: a kernel launched on
    another stream while a run lingers finishes within the linger plus
    1 ms; (e) a post held up past the linger (its descriptor step delayed
    300 ms inside ``PersistentRun.post``): the run closes without it, the
    window arms a fresh run, every request completes and the sums are
    exact.  The card's default lowering is ``pallas`` (every window
    inline); (b), (d) and (e) set ``xla``, which arms runs.  Returns the
    launch counts over (a) to (e)."""
    import numpy as np
    import torch

    import accl_tpu_torch as at
    from accl_tpu_torch.cmdring import WindowShape, ring_widths
    from accl_tpu_torch.constants import Operation
    from accl_tpu_torch.ops.cuda import cmdring as kseq
    from accl_tpu_torch.ops.cuda.cmdring import result_width

    P = P_MAIN
    for k in kc.KERNELS.values():
        k.launches.reset()
    group = at.cuda_group(P)
    ring = group[0].engine.gang.cmdring
    out = {}
    try:
        if ring.lowering != "pallas":
            fail(f"the card's default lowering is {ring.lowering}")
        # (a) the fp8 / int8 windows
        N = 256 * 1024 // 4
        n = N // P
        rng = np.random.default_rng(SEED + 31)
        data = rng.standard_normal((P, N), dtype=np.float32)
        for lane in ("int8", "float8_e4m3fn"):
            bufs = {}

            def window(a, r, lane=lane):
                b = bufs[r] = dict(
                    s=a.create_buffer_from(data[r]),
                    ar=a.create_buffer(n, np.float32),
                    rs=a.create_buffer(n, np.float32),
                    a2=a.create_buffer(N, np.float32))
                with a.batch():
                    reqs = [a.allreduce(b["s"], b["ar"], n,
                                        compress_dtype=lane, run_async=True),
                            a.reduce_scatter(b["s"], b["rs"], n,
                                             compress_dtype=lane,
                                             run_async=True),
                            a.alltoall(b["s"], b["a2"], n,
                                       compress_dtype=lane, run_async=True)]
                for q in reqs:
                    if not q.wait(120) or not q.ring_resident:
                        raise RuntimeError(f"{q.op_name} off the ring")
                    q.check()

            st0 = ring.stats()
            before = {k: f.launches.count for k, f in kc.KERNELS.items()}
            run_ranks(group, window, f"{lane} window")
            moved = {k: f.launches.count - before[k]
                     for k, f in kc.KERNELS.items()
                     if f.launches.count != before[k]}
            st1 = ring.stats()
            if (st1["refills"] - st0["refills"] != 1
                    or st1["fallbacks"] != st0["fallbacks"]
                    or moved != {"sequencer_lanes": 1}):
                fail(f"{lane} window: refills {st1['refills'] - st0['refills']}"
                     f", fallbacks {st1['fallbacks']}, launches {moved}")
            sess = ring._sessions[group[0].comm.id]
            slots = np.stack([sess.ring[(sess.head - 3 + k) % ring.depth]
                              for k in range(3)])
            ops = (Operation.ALLREDUCE, Operation.REDUCE_SCATTER,
                   Operation.ALLTOALL)
            widths = [ring_widths(op, n, P) for op in ops]
            wire = getattr(torch, lane)
            shape = WindowShape(3, [w[0] for w in widths],
                                [w[1] for w in widths], [wire] * 3,
                                torch.float32)
            xs = [[bufs[r]["s"].tensor[:w[0]] for r in range(P)]
                  for w in widths]
            want = [[torch.empty(result_width(w[0], w[1], P),
                                 device=xs[0][0].device) for _ in range(P)]
                    for w in widths]
            kseq.sequencer_plain(slots, xs, want, shape)
            for k, key in enumerate(("ar", "rs", "a2")):
                for r in range(P):
                    err_ = compare(f"facade {lane} {key} rank {r}",
                                   bufs[r][key].tensor, want[k][r])
                    out[f"{lane}_err"] = max(out.get(f"{lane}_err", 0.0),
                                             err_)
            if int(slots[0][6]) == 0:
                fail(f"{lane} window: the allreduce's slot carries no seed")
        print(f"fp8 / int8 windows ride the ring, equal to sequencer_plain "
              f"on the encoded slots", flush=True)

        # (b) the sustained stream
        K, N = 8, 1024 * 1024 // 4
        send = {}
        outs = {}

        def setup(a, r):  # before the sleep: a buffer's fill syncs
            send[r] = a.create_buffer_from(np.full(N, r + 1.0, np.float32))
            outs[r] = [a.create_buffer(N, np.float32) for _ in range(8)]

        def stream(a, r):
            reqs = []
            a.begin_batch()
            try:
                for _ in range(K):
                    reqs += [a.allreduce(send[r], d, run_async=True)
                             for d in outs[r]]
                    a._dispatch_pending()
            finally:
                a.end_batch()
            for q in reqs:
                if not q.wait(120):
                    raise RuntimeError("a stream window never completed")
                q.check()

        run_ranks(group, setup, "stream buffers")
        ring.lowering = "xla"
        saved = ring.linger_s
        ring.linger_s = 0.5
        try:
            # the card runs ahead of the host by nature; a sleep kernel
            # holds the stream so the cold pass's second window finds the
            # first still in flight, as a busy card would
            hold_stream(STREAM_SLEEP)
            run_ranks(group, stream, "cold stream")
            st0 = ring.stats()
            run_ranks(group, stream, "warm stream")
            st1 = ring.stats()
        finally:
            ring.linger_s = saved
        warm = {k: st1[k] - st0[k] for k in ("refills", "dispatches",
                                             "mailbox_posts")}
        out["stream"] = dict(warm, cold_dispatches=st0["dispatches"])
        if (warm["refills"] != K or warm["dispatches"] > 1
                or warm["mailbox_posts"] < K - 1):
            fail(f"sustained stream of {K} windows: {warm}")
        for r in range(P):
            for d in outs[r]:
                d.sync_from_device()
                if not np.array_equal(d.data, np.full(N, 10.0, np.float32)):
                    fail(f"stream result rank {r} differs from the sum")
        t0 = time.time()
        while not ring.parked and time.time() - t0 < 5:
            time.sleep(0.01)
        out["stream"]["parked_after_s"] = time.time() - t0
        if not ring.parked or ring.stats()["state"] != "parked":
            fail(f"the ring did not park after the linger: {ring.stats()}")
        print(f"sustained stream of {K} windows: warm pass {warm}, parked "
              f"{out['stream']['parked_after_s']:.3f} s after it", flush=True)

        # (e) a post held up past the linger inside PersistentRun.post
        held = []
        real = kseq._descriptor

        def slow(*a_, **kw):
            f = sys._getframe(1)
            if (not held and f.f_code.co_name == "post"
                    and f.f_locals["self"].launched):
                held.append(f.f_locals["self"])
                time.sleep(0.3)
            return real(*a_, **kw)

        for r in range(P):
            for d in outs[r]:
                d.tensor.zero_()
        closed0 = kseq.PersistentRun.closed_posts.count
        ring.linger_s = 0.02
        kseq._descriptor = slow
        try:
            hold_stream(STREAM_SLEEP)
            st0 = ring.stats()
            run_ranks(group, stream, "stream with a delayed post")
            st1 = ring.stats()
        finally:
            kseq._descriptor = real
            ring.linger_s = saved
        out["delayed_post"] = dict(
            {k: st1[k] - st0[k] for k in ("refills", "dispatches",
                                          "mailbox_posts")},
            closed_posts=kseq.PersistentRun.closed_posts.count - closed0,
            held_run_exited=held[0].exited() if held else None)
        if (not held or out["delayed_post"]["closed_posts"] != 1
                or held[0].exited() != kseq.EXIT_LINGER):
            fail(f"delayed post: {out['delayed_post']}")
        for r in range(P):
            for d in outs[r]:
                d.sync_from_device()
                if not np.array_equal(d.data, np.full(N, 10.0, np.float32)):
                    fail(f"delayed post: rank {r}'s sum differs")
        print(f"a post delayed past the linger: the run closed without it, "
              f"the window re-armed: {out['delayed_post']}", flush=True)

        # (c) a pair-slot window on the sub-communicator [0, 1]
        n2 = 64 * 1024
        sub = {}

        def pair(a, r):
            c = a.create_communicator([0, 1]) if r < 2 else None
            if c is None:
                return
            sub[r] = dict(c=c, s=a.create_buffer_from(
                np.arange(n2, dtype=np.float32) + 1000.0 * r),
                d=a.create_buffer(n2, np.float32),
                ar=a.create_buffer(n2, np.float32))
            b = sub[r]
            with a.batch():
                if r == 0:
                    q1 = a.send(b["s"], n2, dst=1, tag=4, comm=c,
                                run_async=True)
                else:
                    q1 = a.recv(b["d"], n2, src=0, tag=4, comm=c,
                                run_async=True)
                q2 = a.allreduce(b["s"], b["ar"], n2, comm=c,
                                 run_async=True)
            for q in (q1, q2):
                if not q.wait(120) or not q.ring_resident:
                    raise RuntimeError(f"{q.op_name} off the ring")
                q.check()

        st0 = ring.stats()
        run_ranks(group, pair, "pair-slot window")
        st1 = ring.stats()
        sent = st1["ops"].get("SEND", 0) - st0["ops"].get("SEND", 0)
        if st1["refills"] - st0["refills"] != 1 or sent != 1:
            fail(f"pair-slot window: {st1['refills'] - st0['refills']} "
                 f"refills, {sent} pair slots")
        sub[1]["d"].sync_from_device()
        if not np.array_equal(sub[1]["d"].data,
                              np.arange(n2, dtype=np.float32)):
            fail("pair-slot window: the receiver's data differ")

        # (d) the starvation bound: a kernel on another stream launched
        # while a run lingers (a 50 ms linger, so the run is surely still
        # there when the kernel comes)
        x = torch.ones(1024, device="cuda")
        other = torch.cuda.Stream()
        ring.linger_s = 0.05
        try:
            hold_stream(STREAM_SLEEP)
            run_ranks(group, stream, "stream before the starvation check")
        finally:
            ring.linger_s = saved
        runs = [s.run.device_run for s in ring._sessions.values()
                if s.run is not None]
        lingering = any(not r.ended() for r in runs)
        linger = max(r.linger_s for r in runs) if runs else 0.0
        t0 = time.perf_counter()
        with torch.cuda.stream(other):
            x.add_(1.0)
            ev = torch.cuda.Event()
            ev.record(other)
        ev.synchronize()
        waited = time.perf_counter() - t0
        out["starvation_ms"] = waited * 1e3
        out["starvation_linger_ms"] = linger * 1e3
        if not lingering:
            st = ring.stats()
            fail(f"starvation check: no run lingered when the kernel came "
                 f"(fallbacks {st['fallbacks']}, breakers {st['breakers']}, "
                 f"forms {[w['form'] for w in ring.window_log()[-8:]]})")
        if waited > linger + 1e-3:
            fail(f"a kernel on another stream waited {waited * 1e3:.3f} ms "
                 f"behind a lingering run (linger {linger * 1e3} ms)")
        print(f"starvation bound: a kernel on another stream finished "
              f"{waited * 1e3:.3f} ms after its launch behind a lingering "
              f"run (linger {linger * 1e3:.1f} ms)", flush=True)
    finally:
        for a in group:
            a.deinit()
    out["launches"] = {k: f.launches.count for k, f in kc.KERNELS.items()}
    missing = [k for k in ("sequencer", "sequencer_lanes", "sequencer_run")
               if not out["launches"][k]]
    if missing:
        fail(f"the ring's path never launched {missing}: {out['launches']}")
    return out


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


def bf16_fold_bits(rows) -> "np.ndarray":
    """The rank-order bfloat16 fold in numpy alone (no ``ml_dtypes``):
    each step adds in float32 and rounds to nearest even; ``rows`` and
    the result are uint16 bit patterns."""
    import numpy as np

    def widen(bits):
        return (bits.astype(np.uint32) << 16).view(np.float32)

    def narrow(f):
        u = f.view(np.uint32)
        return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)

    acc = rows[0]
    for row in rows[1:]:
        acc = narrow(widen(acc) + widen(row))
    return acc


def dispatch_main_path(kc) -> dict:
    """Phase 3i: the dispatch path on ``cuda_group(4)`` at the main path's
    width (64 MiB float32 a rank), each step's launches counted alone and
    every result held against its plain version:

    * a one-member communicator [3] (K1's P = 1 branch: a copy, no
      launch);
    * sub-communicators [0, 1] and [2, 3] at once: allreduce under
      ``xla``, ``pallas_ring`` and ``pallas_ring_bidir`` (K1 at P = 2),
      then [0, 1, 2] (P = 3, ``pallas_ring_bidir``), each three times
      (cold, prepared, warm: the third launches with the kept pointer
      tables);
    * on [2, 3] a bcast and a reduce rooted at its rank 1 (session 3)
      under ``pallas_ring`` (rows 9, 10; the reduce three times); on
      [1, 3] an allgather (the plain lowering, as JAX's is XLA's) and a
      gather rooted at its rank 1 under ``pallas_ring`` (K3's root-only
      form, three times);
    * a batched window of 8 allreduces at 256 KiB on [0, 1]: one refill,
      one sequencer launch, no fallback;
    * a warm allreduce: exactly 1 device interaction and a plan hit; a
      ``set_tuning`` write: exactly one re-plan;
    * 8 allreduces at 16 MiB a rank in one batch: the ring refuses them
      (``oversized``), ``_run_batch_fused`` runs them as 1 interaction
      with no sequencer launch, equal bit for bit to the calls one by one;
    * a bfloat16 allreduce on host-only buffers: the host path (no
      interaction, no launch), bit for bit with numpy's rank-order fold.

    Returns the launch counts over the phase."""
    import numpy as np
    import torch

    import accl_tpu_torch as at

    P, n = P_MAIN, N_RANK
    SUM = at.ReduceFunction.SUM
    totals = {k: 0 for k in kc.KERNELS}
    rng = np.random.default_rng(SEED + 9)
    data = rng.standard_normal((P, n), dtype=np.float32)
    group = at.cuda_group(P)
    gang = group[0].engine.gang

    def step(what, rank_main, ranks, want, reps=1):
        """Run ``rank_main`` on ``ranks``, ``reps`` times over (the third
        time on, a planned call takes its prepared handle with its kept
        pointer tables); the kernels it launched must be ``want`` (a
        dict) and nothing else."""
        for k in kc.KERNELS.values():
            k.launches.reset()
        sub = [group[r] for r in ranks]
        for _ in range(reps):
            run_ranks(sub, lambda a, i: rank_main(a, ranks[i]), what)
        torch.cuda.synchronize()
        got = {k: f.launches.count for k, f in kc.KERNELS.items()}
        if {k: v for k, v in got.items() if v} != want:
            fail(f"phase 3i {what}: launches {got}, want {want}")
        for k, v in got.items():
            totals[k] += v

    try:
        send = [a.create_buffer_from(data[r]) for r, a in enumerate(group)]
        recv = [a.create_buffer(n, np.float32) for a in group]
        xs = [b.tensor for b in send]
        halves = [[0, 1], [2, 3]]
        comms = {}
        for a in group:
            a.set_tuning("ring_segments", 4)
        for r, a in enumerate(group):
            comms[r] = a.create_communicator(halves[r // 2])
        for algo in ("xla", "pallas_ring", "pallas_ring_bidir"):
            for a in group:
                a.set_tuning("allreduce_algorithm", algo)

            def halves_main(a, r):
                a.allreduce(send[r], recv[r], comm=comms[r])

            step(f"allreduce on [0, 1] and [2, 3] under {algo}",
                 halves_main, [0, 1, 2, 3],
                 {} if algo == "xla" else {"ring_allreduce": 6}, reps=3)
            for pair in halves:
                rows = [xs[r] for r in pair]
                want = (rows[0] + rows[1] if algo == "xla"
                        else kc.ring_allreduce_plain(
                            rows, SUM, 4,
                            bidirectional=algo == "pallas_ring_bidir")[0])
                for r in pair:
                    compare(f"3i allreduce {pair} {algo} rank {r}",
                            recv[r].device_array(), want)
        solo = group[3].create_communicator([3])
        step("allreduce on [3] under pallas_ring_bidir",
             lambda a, r: a.allreduce(send[r], recv[r], comm=solo), [3], {})
        compare("3i allreduce P=1", recv[3].device_array(), xs[3])
        trio = {r: group[r].create_communicator([0, 1, 2]) for r in range(3)}
        step("allreduce on [0, 1, 2] under pallas_ring_bidir",
             lambda a, r: a.allreduce(send[r], recv[r], comm=trio[r]),
             [0, 1, 2], {"ring_allreduce": 3}, reps=3)
        want = kc.ring_allreduce_plain(xs[:3], SUM, 4, bidirectional=True)
        for r in range(3):
            compare(f"3i allreduce P=3 rank {r}", recv[r].device_array(),
                    want[r])
        for a in group:
            a.set_tuning("allreduce_algorithm", "xla")
            a.set_tuning("bcast_algorithm", "pallas_ring")
            a.set_tuning("reduce_algorithm", "pallas_ring")
        bc = {r: group[r].create_buffer_from(data[r]) for r in (2, 3)}
        step("bcast root 1 on [2, 3]",
             lambda a, r: a.bcast(bc[r], root=1, comm=comms[r]), [2, 3],
             {"ring_bcast": 1})
        for r in (2, 3):
            compare(f"3i bcast rank {r}", bc[r].device_array(), xs[3])
        step("reduce root 1 on [2, 3]",
             lambda a, r: a.reduce(send[r], recv[r] if r == 3 else None,
                                   root=1, comm=comms[r]), [2, 3],
             {"ring_reduce": 3}, reps=3)
        compare("3i reduce root", recv[3].device_array(),
                kc.ring_reduce_plain(xs[2:], 1, SUM, 4)[1])
        for a in group:
            a.set_tuning("bcast_algorithm", "xla")
            a.set_tuning("reduce_algorithm", "xla")
        # on [1, 3]: the allgather (its lowering is the plain one, as
        # JAX's is XLA's all_gather) and the gather rooted at its rank 1
        # under pallas_ring, K3's root-only form
        odd = {r: group[r].create_communicator([1, 3]) for r in (1, 3)}
        m = n // 2
        gathered = {r: group[r].create_buffer(n, np.float32) for r in (1, 3)}
        step("allgather on [1, 3]",
             lambda a, r: a.allgather(send[r], gathered[r], m, comm=odd[r]),
             [1, 3], {})
        for r in (1, 3):
            compare(f"3i allgather rank {r}", gathered[r].device_array(),
                    torch.cat([xs[1][:m], xs[3][:m]]))
        for a in group:
            a.set_tuning("gather_algorithm", "pallas_ring")
        rooted = group[3].create_buffer(n, np.float32)
        step("gather root 1 on [1, 3]",
             lambda a, r: a.gather(send[r], rooted if r == 3 else None, m,
                                   root=1, comm=odd[r]),
             [1, 3], {"ring_gather": 3}, reps=3)
        compare("3i gather root", rooted.device_array(),
                torch.cat([xs[1][:m], xs[3][:m]]))
        for a in group:
            a.set_tuning("gather_algorithm", "xla")

        # a batched window of 8 allreduces at 256 KiB on [0, 1]
        w = 64 * 1024
        outs = {r: [group[r].create_buffer(w, np.float32) for _ in range(8)]
                for r in (0, 1)}
        small = {r: send[r].slice(0, w) for r in (0, 1)}
        st0 = gang.cmdring.stats()
        ic0 = group[0].capabilities()["device_interactions"]

        def window(a, r):
            with a.batch():
                reqs = [a.allreduce(small[r], o, w, comm=comms[r],
                                    run_async=True) for o in outs[r]]
            for q in reqs:
                if not q.wait(120) or not q.ring_resident:
                    raise RuntimeError(f"{q.op_name} off the ring")
                q.check()

        step("window of 8 on [0, 1]", window, [0, 1], {"sequencer": 1})
        st1 = gang.cmdring.stats()
        ic1 = group[0].capabilities()["device_interactions"]
        if (st1["refills"] - st0["refills"] != 1 or ic1 - ic0 != 1
                or st1["fallbacks"] != st0["fallbacks"]):
            fail(f"phase 3i window: {st0} -> {st1}, interactions "
                 f"{ic1 - ic0}")
        for r in (0, 1):
            for o in outs[r]:
                compare(f"3i window rank {r}", o.device_array(),
                        xs[0][:w] + xs[1][:w])

        # the warm call and the register write
        for a in group:
            a.set_tuning("allreduce_algorithm", "pallas_ring")

        def world(a, r):
            a.allreduce(send[r], recv[r])

        for _ in range(2):
            run_ranks(group, world, "3i warm-up")
        ic0 = group[0].capabilities()["device_interactions"]
        pc0 = group[0].capabilities()["plan_cache"]
        step("warm allreduce", world, [0, 1, 2, 3], {"ring_allreduce": 1})
        ic1 = group[0].capabilities()["device_interactions"]
        pc1 = group[0].capabilities()["plan_cache"]
        if ic1 - ic0 != 1 or pc1["hits"] - pc0["hits"] != 1 or (
                pc1["misses"] != pc0["misses"]):
            fail(f"phase 3i warm call: interactions {ic1 - ic0}, plan "
                 f"cache {pc0} -> {pc1}")
        want = kc.ring_allreduce_plain(xs, SUM, 4)
        for r in range(P):
            compare(f"3i warm allreduce rank {r}", recv[r].device_array(),
                    want[r])
        for a in group:
            a.set_tuning("ring_segments", 4)
        pc0 = group[0].capabilities()["plan_cache"]
        step("allreduce after set_tuning", world, [0, 1, 2, 3],
             {"ring_allreduce": 1})
        pc1 = group[0].capabilities()["plan_cache"]
        if pc1["misses"] - pc0["misses"] != 1 or pc0["size"] != 0:
            fail(f"phase 3i set_tuning: plan cache {pc0} -> {pc1}")
        for a in group:
            a.set_tuning("allreduce_algorithm", "xla")

        # 8 allreduces at 16 MiB a rank: refused as oversized, fused
        big = FUSED_BATCH_N
        src = {r: send[r].slice(0, big) for r in range(P)}
        res = {mode: {r: [group[r].create_buffer(big, np.float32)
                          for _ in range(8)] for r in range(P)}
               for mode in ("fused", "single")}
        st0 = gang.cmdring.stats()["fallbacks"].get("oversized", 0)
        ic0 = group[0].capabilities()["device_interactions"]

        def fused(a, r):
            with a.batch():
                reqs = [a.allreduce(src[r], o, big, run_async=True)
                        for o in res["fused"][r]]
            for q in reqs:
                if not q.wait(120) or q.ring_resident:
                    raise RuntimeError(f"{q.op_name} rode the ring")
                q.check()

        step("fused batch of 8 at 16 MiB", fused, [0, 1, 2, 3], {})
        ic1 = group[0].capabilities()["device_interactions"]
        st1 = gang.cmdring.stats()["fallbacks"].get("oversized", 0)
        if ic1 - ic0 != 1 or st1 - st0 != 1:
            fail(f"phase 3i fused batch: {ic1 - ic0} interactions, "
                 f"{st1 - st0} oversized refusals")
        step("8 allreduces at 16 MiB one by one",
             lambda a, r: [a.allreduce(src[r], o, big)
                           for o in res["single"][r]], [0, 1, 2, 3], {})
        for r in range(P):
            for f, o in zip(res["fused"][r], res["single"][r]):
                compare(f"3i fused batch rank {r}", f.device_array(),
                        o.device_array())
        del res

        # a bfloat16 allreduce on host-only buffers
        hn = 1024 * 1024
        f = rng.standard_normal((P, hn), dtype=np.float32) * 8
        u = f.view(np.uint32)
        bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        hs = {r: group[r].create_buffer(hn, at.DataType.BFLOAT16,
                                        host_only=True) for r in range(P)}
        hd = {r: group[r].create_buffer(hn, at.DataType.BFLOAT16,
                                        host_only=True) for r in range(P)}
        for r in range(P):
            hs[r].tensor.view(torch.int16).copy_(
                torch.from_numpy(bits[r].view(np.int16)))
        ic0 = group[0].capabilities()["device_interactions"]
        step("host-only bfloat16 allreduce",
             lambda a, r: a.allreduce(hs[r], hd[r]), [0, 1, 2, 3], {})
        if group[0].capabilities()["device_interactions"] != ic0:
            fail("phase 3i host path counted a device interaction")
        fold = bf16_fold_bits(list(bits))
        for r in range(P):
            got = hd[r].tensor.view(torch.int16).numpy().view(np.uint16)
            if not np.array_equal(got, fold):
                fail(f"phase 3i host-only bfloat16 rank {r}: "
                     f"{int((got != fold).sum())} elements differ from the "
                     f"numpy fold")
    finally:
        for a in group:
            a.deinit()
    return totals


def facade_dispatch_latency(sizes, iters: int = 30) -> dict:
    """Phase 5's dispatch record: the warm allreduce under ``pallas_ring``
    at each size on the world and on the sub-communicator [0, 1] (its two
    ranks alone): p50 / p90 of rank 0's call, the p50 of the gang's launch
    time (``Request.get_duration_ns``), device interactions per warm call
    and the plan-cache hit rate over the timed calls; then 8 allreduces
    at 16 MiB a rank in one batch (the ring refuses them; one fused
    dispatch) against the same calls one by one.  Every measurement runs
    twice over, the second pass kept."""
    import numpy as np

    import accl_tpu_torch as at

    group = at.cuda_group(P_MAIN)
    rows, stats = [], {}
    try:
        subs = {r: group[r].create_communicator([0, 1]) for r in (0, 1)}
        for a in group:
            a.set_tuning("allreduce_algorithm", "pallas_ring")
            a.set_tuning("ring_segments", 4)
        for where, ranks in (("world", list(range(P_MAIN))),
                             ("subcomm [0, 1]", [0, 1])):
            for n in sizes:
                samples = {}

                def rank_main(a, i, n=n, where=where):
                    r = ranks[i]
                    s = a.create_buffer(n, np.float32)
                    d = a.create_buffer(n, np.float32)
                    comm = subs[r] if where != "world" else None
                    for _pass in range(2):
                        if r == 0 and _pass == 1:
                            stats["ic"] = a.capabilities()[
                                "device_interactions"]
                            stats["pc"] = a.capabilities()["plan_cache"]
                        times, launch = [], []
                        for _ in range(iters):
                            t = time.perf_counter()
                            req = a.allreduce(s, d, comm=comm)
                            times.append(time.perf_counter() - t)
                            launch.append(req.get_duration_ns() * 1e-9)
                        if r == 0:
                            samples["t"], samples["l"] = times, launch

                run_ranks([group[r] for r in ranks], rank_main,
                          f"facade dispatch {where} {n}")
                a0 = group[0]
                ic = a0.capabilities()["device_interactions"] - stats["ic"]
                pc = a0.capabilities()["plan_cache"]
                hits = pc["hits"] - stats["pc"]["hits"]
                misses = pc["misses"] - stats["pc"]["misses"]
                rows.append({
                    "comm": where, "ranks": len(ranks), "algo": "pallas_ring",
                    "bytes_per_rank": 4 * n,
                    "p50_ms": float(np.median(samples["t"])) * 1e3,
                    "p90_ms": float(np.percentile(samples["t"], 90)) * 1e3,
                    "launch_p50_ms": float(np.median(samples["l"])) * 1e3,
                    "interactions_per_call": ic / iters,
                    "plan_hit_rate": hits / max(1, hits + misses),
                })
        for a in group:
            a.set_tuning("allreduce_algorithm", "xla")
        big = FUSED_BATCH_N
        batch = {}

        def batch_main(a, r):
            s = a.create_buffer(big, np.float32)
            ds = [a.create_buffer(big, np.float32) for _ in range(8)]
            for _pass in range(2):
                for mode in ("fused", "one_by_one"):
                    times = []
                    for _ in range(5):
                        t = time.perf_counter()
                        if mode == "fused":
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
                        batch[mode] = float(np.median(times)) * 1e3

        run_ranks(group, batch_main, "facade dispatch 16 MiB batch")
    finally:
        for a in group:
            a.deinit()
    return {"rows": rows, "batch_16mib_x8_p50_ms": batch}


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
    # the fp8 / int8 instantiation on the main path's window (8 x
    # allreduce 1 Mi, seeded), by device time; its bound counts each
    # operand read once, each result written once and the int8 scales
    # written and read once
    for lane in ("int8", "float8_e4m3fn"):
        wire = getattr(torch, lane)
        win = seq_window(P, F32, [(Op.ALLREDUCE, 0, 0)] * 8, SEQ_N,
                         SEED + 5, wires=[wire], flags=12345)
        nbytes, ops = window_bytes(*win)
        if lane == "int8":
            nbytes += 8 * P * (-(-SEQ_N // 256)) * 4 * 2
        key = f"{lane}_"
        out[key + "ms"] = time_ms(lambda: kseq.sequencer(*win))
        out[key + "device_ms"] = device_ms(lambda: kseq.sequencer(*win))
        out[key + "plain_ms"] = time_ms(lambda: kseq.sequencer_plain(*win))
        out[key + "bound"] = bound(nbytes, ops)
        del win
    # the persistent form: 16 windows of 8 x allreduce 1 Mi posted into one
    # run, from the first post to the last window's completion, a window
    out.update(time_persistent(P, kseq, Op))
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


def time_persistent(P, kseq, Op, windows: int = 16) -> dict:
    """Row 14's persistent form on the main path's window: ``windows``
    windows of 8 x allreduce 1 Mi posted into one run (launched after the
    first post), timed from the first post to the last window's
    completion on the host clock, per window; twice over, the second
    kept.  Beside it the one-shot kernel launched once a window over the
    same windows, the same way."""
    import torch

    dev = torch.device("cuda", 0)
    win = seq_window(P, torch.float32, [(Op.ALLREDUCE, 0, 0)] * 8, SEQ_N,
                     SEED + 6)
    out = {}
    for _pass in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = kseq.PersistentRun(win[3], P, dev, windows, 0.002, False)
        for i in range(windows):
            if run.post(*win[:3]) is None:
                fail("time_persistent: a post was refused")
            if i == 0:
                run.launch()
        if not run.wait_window(windows - 1, 60.0):
            fail(f"time_persistent: {run.failed}")
        out["run_ms"] = (time.perf_counter() - t0) * 1e3 / windows
        run.join(5.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(windows):
            kseq.sequencer(*win)
        torch.cuda.synchronize()
        out["oneshot_ms"] = (time.perf_counter() - t0) * 1e3 / windows
    return out


#: the stream form's postures: (name, lowering, cmdring_run_windows,
#: cmdring_linger_us (0: the env default), a sleep kernel before the
#: warm-up); "default" is the card's default, "run_default" the ``xla``
#: lowering at the defaults (16 windows, 2 ms), "run_tuned" a run armed
#: behind a busy card that the timed samples post into
STREAM_POSTURES = (("default", "pallas", 0, 0, False),
                   ("run_default", "xla", 0, 0, False),
                   ("run_tuned", "xla", 128, 200_000, True))


def facade_stream_latency(sizes, K: int = 8, iters: int = 10) -> list:
    """The stream form of ``facade_batch``: K windows of 8 allreduces a
    rank posted without a drain between them (``_dispatch_pending``), one
    ``end_batch``, every request waited; per window on rank 0's host
    clock (the K windows' time over K) p50 and p90, the launch p50 (a
    window's requests' longest duration: at post time for a run's
    windows) and the dispatches and mailbox posts of the timed samples,
    under each of ``STREAM_POSTURES``.  Per size a warm-up sample first
    (for "run_tuned" begun behind a sleep kernel on the stream, so that
    its second window finds the first in flight and arms the run the
    timed samples post into)."""
    import numpy as np
    import torch

    import accl_tpu_torch as at

    samples = {}
    bufs = {}

    def setup(a, r):
        bufs[r] = {n: (a.create_buffer(n, np.float32),
                       [a.create_buffer(n, np.float32) for _ in range(8)])
                   for n in sizes}

    def posture(a, r, run_windows, linger_us):
        a.set_tuning("cmdring_run_windows", run_windows)
        a.set_tuning("cmdring_linger_us", linger_us)

    def sample(a, r, n, count):
        s, ds = bufs[r][n]
        times, launch = [], []
        for _ in range(count):
            t = time.perf_counter()
            reqs = []
            a.begin_batch()
            for _ in range(K):
                reqs.append([a.allreduce(s, d, run_async=True) for d in ds])
                a._dispatch_pending()
            a.end_batch()
            for window in reqs:
                for q in window:
                    q.wait(60)
                    q.check()
            times.append((time.perf_counter() - t) / K)
            launch += [1e-9 * max(q.get_duration_ns() for q in w)
                       for w in reqs]
        if r == 0:
            samples[n] = (times, launch)

    group = at.cuda_group(P_MAIN)
    ring = group[0].engine.gang.cmdring
    rows = []
    try:
        if ring.lowering != "pallas":
            fail(f"the card's default lowering is {ring.lowering}")
        run_ranks(group, setup, "facade stream buffers")
        for name, lowering, rw, lus, sleep in STREAM_POSTURES:
            ring.lowering = lowering
            run_ranks(group, lambda a, r: posture(a, r, rw, lus),
                      f"facade stream posture {name}")
            run_windows, linger_s = ring._window_posture()
            for n in sizes:
                torch.cuda.synchronize()
                if sleep:
                    torch.cuda._sleep(STREAM_SLEEP)
                run_ranks(group, lambda a, r: sample(a, r, n, 1),
                          "facade stream warm-up")
                st0 = ring.stats()
                run_ranks(group, lambda a, r: sample(a, r, n, iters),
                          "facade stream timing")
                st1 = ring.stats()
                t, lt = samples[n]
                rows.append({
                    "mode": "stream", "posture": name, "lowering": lowering,
                    "run_windows": run_windows, "linger_us": linger_s * 1e6,
                    "sleep_kernel": sleep, "windows": K, "calls": 8,
                    "bytes_per_rank": 4 * n,
                    "p50_ms": float(np.median(t)) * 1e3,
                    "p90_ms": float(np.percentile(t, 90)) * 1e3,
                    "launch_p50_ms": float(np.median(lt)) * 1e3,
                    "dispatches": st1["dispatches"] - st0["dispatches"],
                    "mailbox_posts": (st1["mailbox_posts"]
                                      - st0["mailbox_posts"]),
                    "refills": st1["refills"] - st0["refills"],
                })
            ring.halt_sessions()
        if ring.stats()["fallbacks"]:
            fail("facade stream timing: a window fell back")
    finally:
        for a in group:
            a.deinit()
    return rows


def facade_pair_latency(sizes, iters: int = 20) -> list:
    """A batched send -> recv pair on ``cuda_group(2)`` (one ring slot):
    p50 and p90 from rank 0's batch to rank 1's wait returning, the data
    on the card, a barrier before each sample; beside ``facade_p2p``'s
    unbatched send -> recv."""
    import numpy as np

    import accl_tpu_torch as at

    stamps = {}

    def rank_main(a, r):
        bufs = {n: (a.create_buffer_from(np.full(n, r, np.float32)),
                    a.create_buffer(n, np.float32)) for n in sizes}
        for n, (s, d) in bufs.items():
            rows = []
            for it in range(iters + 2):
                a.barrier()
                t0 = time.perf_counter()
                with a.batch():
                    q = (a.send(s, n, dst=1, tag=8, run_async=True) if r == 0
                         else a.recv(d, n, src=0, tag=8, run_async=True))
                q.wait(60)
                q.check()
                if not q.ring_resident:
                    raise RuntimeError("the batched pair left the ring")
                if it >= 2:
                    rows.append((t0, time.perf_counter()))
            stamps.setdefault(n, {})[r] = rows

    group = at.cuda_group(2)
    try:
        run_ranks(group, rank_main, "batched pair timing")
        sent = group[0].engine.gang.cmdring.stats()["ops"].get("SEND", 0)
    finally:
        for a in group:
            a.deinit()
    if sent != len(sizes) * (iters + 2):
        fail(f"batched pair timing: {sent} pair slots")
    out = []
    for n, by_rank in stamps.items():
        lat = [e1 - s0 for (s0, _), (_, e1) in zip(by_rank[0], by_rank[1])]
        out.append({"call": "batched_send_recv", "bytes": 4 * n,
                    "p50_ms": float(np.median(lat)) * 1e3,
                    "p90_ms": float(np.percentile(lat, 90)) * 1e3})
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
                    times, launch = [], []
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
                            reqs = [a.allreduce(s, d) for d in ds]
                        times.append(time.perf_counter() - t)
                        # the window's launch (its requests share it), or
                        # the eight calls' launches
                        launch.append(1e-9 * (
                            max(q.get_duration_ns() for q in reqs)
                            if mode == "batched" else
                            sum(q.get_duration_ns() for q in reqs)))
                    if r == 0:
                        samples[(mode, n)] = (times, launch)

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
        "launch_p50_ms": float(np.median(lt)) * 1e3,
    } for (mode, n), (t, lt) in samples.items()]


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
               # rows 14 and 7, redesigned on the same access shape; row
               # 14's fp8 / int8 instantiation (LANES true) and persistent
               # form apart
               "sequencer": ("cmdring", "16sequencer_kernel"),
               "sequencer_lanes": ("cmdring", "22sequencer_lanes_kernel"),
               "sequencer_run": ("cmdring", "17persistent_kernel"),
               "sequencer_run_lanes": ("cmdring",
                                       "23persistent_lanes_kernel"),
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
        # row 14's fp8 / int8 kernels run two blocks an SM at 128
        # registers, with a spill measured cheaper than one block an SM
        # (csrc/cmdring.cu): reported, not refused
        if name in ("sequencer_lanes", "sequencer_run_lanes"):
            continue
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


def time_flash_bwd(B: int = TRAIN_B, T: int = TRAIN_T,
                   plain: bool = True, causal: bool = True) -> dict:
    """Phase 4 for rows 16-18 at (B, 32, T, 128) bf16, causal or full (the
    training shape, causal, by default): the forward with LSE, the delta
    pass, dQ and dK/dV, each beside its plain version (None unless
    ``plain``), by CUDA events around the wrapper and by device time alone
    (``device_ms``); and ``scaled_dot_product_attention``'s forward and
    its backward (dQ, dK and dV in one call).  The operations count the
    (q, k) pairs the mask keeps."""
    import torch
    import torch.nn.functional as F

    from accl_tpu_torch.ops.cuda import attention as ka

    dev = torch.device("cuda", 0)
    H, D = TRAIN["n_heads"], 128
    time_plain = time_ms if plain else (lambda fn, **kw: None)
    q, k, v, do = (torch.randn(B, H, T, D, device=dev, dtype=torch.bfloat16)
                   for _ in range(4))
    o, lse = ka.flash_attention(q, k, v, causal, with_lse=True)
    delta = ka.flash_attention_bwd_delta(do, o)
    sq, sk, sv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
    # the (q, k) pairs the mask keeps, all heads
    pairs = B * H * T * (T + 1) // 2 if causal else B * H * T * T
    act = q.numel() * q.element_size()  # bytes of one (B, H, T, D) tensor
    stats = 4 * B * H * T  # bytes of lse or delta
    out = {
        "fwd": dict(
            ms=time_ms(lambda: ka.flash_attention(q, k, v, causal,
                                                  with_lse=True), iters=20),
            device_ms=device_ms(lambda: ka.flash_attention(
                q, k, v, causal, with_lse=True), iters=20),
            plain_ms=time_plain(lambda: ka.flash_attention_plain(
                q, k, v, causal, with_lse=True)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), iters=20),
            library_device_ms=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                iters=20),
            bytes=4 * act + stats, ops=4 * D * pairs),
        "flash_attention_bwd_dq": dict(
            ms=time_ms(lambda: ka.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, causal), iters=20),
            device_ms=device_ms(lambda: ka.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, causal), iters=20),
            plain_ms=time_plain(lambda: ka.flash_attention_bwd_dq_plain(
                q, k, v, do, lse, delta, causal)),
            bytes=5 * act + 2 * stats, ops=3 * 2 * D * pairs),
        "flash_attention_bwd_dkv": dict(
            ms=time_ms(lambda: ka.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal), iters=20),
            device_ms=device_ms(lambda: ka.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal), iters=20),
            plain_ms=time_plain(lambda: ka.flash_attention_bwd_dkv_plain(
                q, k, v, do, lse, delta, causal)),
            bytes=6 * act + 2 * stats, ops=4 * 2 * D * pairs),
        # no one PyTorch call forms rowsum(dO O) in float32 from 16-bit
        # operands (its products would round to bfloat16 first)
        "flash_attention_bwd_delta": dict(
            ms=time_ms(lambda: ka.flash_attention_bwd_delta(do, o),
                       iters=20),
            device_ms=device_ms(lambda: ka.flash_attention_bwd_delta(do, o),
                                iters=20),
            plain_ms=time_plain(lambda: ka.flash_attention_bwd_delta_plain(
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


def train_profile(train, classes=KERNEL_CLASSES) -> dict:
    """One train step under ``torch.profiler`` (CPU and CUDA activities):
    the device's kernel time summed by ``classes``, the flash class by
    kernel (forward, delta, dQ, dK/dV), its busy time against the step's
    wall time (host clock, synchronised), the idle share, and the ten
    costliest kernels.  Device times are None when the profiler records
    no device event."""
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
    by_class = {name: 0.0 for name, _ in classes}
    by_class["other"] = 0.0
    kernels, flash = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        kernels[e.name] = kernels.get(e.name, 0.0) + ms
        low = e.name.lower()
        cls = next((name for name, keys in classes
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

    cfg = train["cfg"]
    measured = step_timing(train, TRAIN_B, TRAIN_T)
    return {
        "batch": TRAIN_B, "seq": TRAIN_T, "params": train["n_params"],
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "dtype": "bfloat16", "attention": "auto", "lr": TRAIN_LR,
        **measured,
        "launches_per_step": train["per_step"],
        "main_path_losses": train["losses"],
        "bf16_flash_vs_naive_loss_rel": train["bf16_loss_rel"],
        "bf16_flash_vs_naive_grad_rel": train["bf16_grad_rel"],
        "f32_flash_vs_naive_loss_rel": train["f32_loss_rel"],
        "f32_flash_vs_naive_grad_rel": train["f32_grad_rel"],
        "f32_update_vs_lr_grad_rel": train["f32_update_rel"],
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }


def step_timing(train, B: int, T: int, classes=KERNEL_CLASSES) -> dict:
    """bench.py's measure of a train step (bench.py:343-350) on
    ``train``'s step, parameters and batch: one warm-up step, then the
    mean of 10 steps timed together with one synchronise at the end; then
    10 steps each synchronised for p50 and p90, and one more under the
    profiler (:func:`train_profile`).  ``train_tflops`` counts bench.py's
    6 N B T operations a step (bench.py:337-341) over the mean,
    ``train_mfu`` that over 989 TFLOP/s; peak memory over the 10."""
    import numpy as np
    import torch

    step, params = train["step"], train["params"]
    tokens, targets = train["tokens"], train["targets"]
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
    flops = 6.0 * train["n_params"] * B * T
    return {
        "step_ms": mean_s * 1e3,
        "step_p50_ms": float(np.median(times)) * 1e3,
        "step_p90_ms": float(np.percentile(times, 90)) * 1e3,
        "tokens_per_s": B * T / mean_s,
        "train_tflops": flops / mean_s / 1e12,
        "train_mfu": flops / mean_s / TC16_OPS_PER_S,
        "peak_memory_gb": peak / 1e9,
        "last_loss": float(loss),
        "profiled_step": train_profile(train, classes),
    }


# -- the context-parallel training path (no kernel; rows 16-18 beside it) --

#: bench.py's long-context training record, ``train_mfu_t4096``
#: (bench.py:310-317, :3046-3050): the training model at T = 4096 (its
#: position table 4096 rows, as bench.py's max_seq = seq), batch 8 x 1024
#: / 4096, striped over a cp ring of 4 (T / cp = 1024, block_k 512)
CP = dict(TRAIN, max_seq=4096)
CP_B, CP_T, CP_RING, CP_STEPS = 2, 4096, 4, 3
#: a profiled cp step's device time by class: the float32 GEMMs are the
#: ring fold's (TF32 off, so not on the tensor cores), the rest of the
#: GEMMs the bfloat16 projections, MLP and LM head
CP_KERNEL_CLASSES = (
    ("fold_matmul_f32", ("sgemm", "f32f32", "simt")),
) + KERNEL_CLASSES
#: float32, 2 layers: one cp step against one dense step, JAX's cp test's
#: bounds (tests/test_models.py:1077-1083)
CP_F32_LOSS_RTOL, CP_F32_RTOL, CP_F32_ATOL = 1e-5, 2e-4, 2e-5


def cp_setup():
    """Phase 3j's configuration, weights from the seed, the batch, and
    the cp and dense steps over them (the dense one on one rank)."""
    import dataclasses

    import torch

    from accl_tpu_torch.models import (TransformerConfig, init_params,
                                       make_sharded_train_step)
    from accl_tpu_torch.models.transformer import _tree_leaves
    from accl_tpu_torch.ops.driver import make_mesh

    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="auto",
                            context_parallel=True, remat=True, **CP)
    dense = dataclasses.replace(cfg, context_parallel=False, remat=False)
    mesh = make_mesh((1, CP_RING), axes=("dp", "tp"))
    step, shard = make_sharded_train_step(cfg, lr=TRAIN_LR, mesh=mesh)
    dense_step, _ = make_sharded_train_step(dense, lr=TRAIN_LR)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    params = shard(init_params(cfg, gen))
    tokens = torch.randint(0, cfg.vocab, (CP_B, CP_T), generator=gen,
                           device=dev, dtype=torch.int32)
    return dict(cfg=cfg, dense=dense, mesh=mesh, step=step,
                dense_step=dense_step, params=params, tokens=tokens,
                targets=tokens.roll(-1, dims=1),
                n_params=sum(p.numel() for p in _tree_leaves(params)))


def cp_main_path(kc) -> dict:
    """Phase 3j: ``CP_STEPS`` cp steps at the full width, then one dense
    step on the same weights, each with the launch counters zeroed
    before and read after: a cp step launches no kernel, a dense one 6
    of each of ``TRAIN_KERNELS`` and no other.  Then the cp and the
    dense ``loss_fn`` and gradients on those weights in bfloat16, and a
    cp step against a dense step in float32 with 2 layers.  Frees what
    it built; returns the launches, losses and gaps."""
    import dataclasses

    import torch

    from accl_tpu_torch.models import make_sharded_train_step, stripe_sequence
    from accl_tpu_torch.models.transformer import (_cp_block_k,
                                                   _tree_leaves, _tree_map)

    cp = cp_setup()
    cfg, params = cp["cfg"], cp["params"]
    tokens, targets = cp["tokens"], cp["targets"]
    torch.cuda.synchronize()
    reset_launches(kc)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(CP_STEPS):
        params, loss = cp["step"](params, tokens, targets)
        losses.append(float(loss))
        if any(read_launches(kc).values()):
            fail(f"cp step launched a kernel: "
                 f"{ {k: v for k, v in read_launches(kc).items() if v} }")
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses)) or not all(
            bool(torch.isfinite(p).all()) for p in _tree_leaves(params)):
        fail(f"cp steps: losses {losses} or parameters not finite")
    if not losses[-1] < losses[0]:
        fail(f"cp steps: the loss did not fall, {losses}")
    params, dense_loss = cp["dense_step"](params, tokens, targets)
    torch.cuda.synchronize()
    dense_launches = read_launches(kc)
    want = {k: (cfg.n_layers if k in TRAIN_KERNELS else 0)
            for k in kc.KERNELS}
    if dense_launches != want:
        fail(f"dense T = {CP_T} step: launches {dense_launches}, want {want}")
    wgmma = all_wgmma(kc, f"dense T = {CP_T} step")
    print(f"context-parallel path ok: {CP_STEPS} cp steps (cp {CP_RING}, "
          f"remat, block_k {_cp_block_k(CP_T // CP_RING, cfg.attention)}), "
          f"losses {losses}, no kernel launched, peak "
          f"{peak / 1e9:.2f} GB; a dense T = {CP_T} step: loss "
          f"{float(dense_loss)}, {cfg.n_layers} launches of each of "
          f"{TRAIN_KERNELS}, no other kernel", flush=True)

    # bfloat16 at full width: the cp loss and gradients against the dense
    def shards(t):
        return list(stripe_sequence(t, CP_RING, axis=1).split(
            CP_T // CP_RING, dim=1))

    names = leaf_names(params)
    lc, gc = loss_and_grads(params, shards(tokens), shards(targets), cfg)
    ld, gd = loss_and_grads(params, tokens, targets, cp["dense"])
    bf16_loss_rel, bf16_grad_rel, worst = grad_gap(lc, gc, ld, gd, names)
    del gc, gd
    print(f"bfloat16 loss_fn, cp vs dense (flash) at full width: loss {lc} "
          f"vs {ld} ({bf16_loss_rel} rel), gradients max rel (Frobenius) "
          f"{bf16_grad_rel} ({worst})", flush=True)
    if not bf16_loss_rel <= BF16_LOSS_RTOL:
        fail(f"bfloat16 loss: cp vs dense {bf16_loss_rel} > {BF16_LOSS_RTOL}"
             f" rel")
    if not bf16_grad_rel <= BF16_GRAD_RTOL:
        fail(f"bfloat16 gradients: cp vs dense {bf16_grad_rel} > "
             f"{BF16_GRAD_RTOL} rel")

    # float32 at bench's widths, 2 layers: one cp step against one dense
    c32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=2)
    d32 = dataclasses.replace(cp["dense"], dtype=torch.float32, n_layers=2)
    p32 = _tree_map(lambda p: p.float(),
                    dict(params, layers=params["layers"][:2]))
    step_c, shard_c = make_sharded_train_step(c32, lr=TRAIN_LR,
                                              mesh=cp["mesh"])
    step_d, _ = make_sharded_train_step(d32, lr=TRAIN_LR)
    del params, cp
    new_c, loss_c = step_c(shard_c(p32), tokens, targets)
    new_d, loss_d = step_d(p32, tokens, targets)
    f32_loss_rel = abs(float(loss_c) - float(loss_d)) / abs(float(loss_d))
    # the worst |a - b| over atol + rtol |b| of any weight (<= 1: within)
    f32_param_gap = max(
        float(((a - b).abs() / (CP_F32_ATOL + CP_F32_RTOL * b.abs())).max())
        for a, b in zip(_tree_leaves(new_c), _tree_leaves(new_d)))
    del new_c, new_d
    print(f"float32 step, cp vs dense, 2 layers x batch {CP_B}: loss "
          f"{float(loss_c)} vs {float(loss_d)} ({f32_loss_rel} rel), "
          f"weights at {f32_param_gap} of rtol {CP_F32_RTOL}, atol "
          f"{CP_F32_ATOL}", flush=True)
    if not f32_loss_rel <= CP_F32_LOSS_RTOL:
        fail(f"float32 cp loss {f32_loss_rel} > {CP_F32_LOSS_RTOL} rel")
    if not f32_param_gap <= 1.0:
        fail(f"float32 cp step: weights beyond rtol {CP_F32_RTOL}, atol "
             f"{CP_F32_ATOL} of the dense step's ({f32_param_gap})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(launches=dense_launches, wgmma=wgmma, losses=losses,
                main_path_peak_gb=peak / 1e9,
                block_k=_cp_block_k(CP_T // CP_RING, cfg.attention),
                gaps=dict(bf16_loss_rel=bf16_loss_rel,
                          bf16_grad_rel=bf16_grad_rel, bf16_grad_worst=worst,
                          f32_loss_rel=f32_loss_rel,
                          f32_param_gap=f32_param_gap))


def cp_timing(cp_run) -> dict:
    """Phase 5's ``train_cp``: phase 3j's weights and batch built again
    from the seed, then :func:`step_timing` of the cp step and of the
    dense T = 4096 step beside it (each with its launches a step), and
    phase 3j's gaps."""
    import torch

    cp = cp_setup()
    cfg = cp["cfg"]
    common = dict(batch=CP_B, seq=CP_T, params=cp["n_params"],
                  layers=cfg.n_layers, d_model=cfg.d_model,
                  n_heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
                  dtype="bfloat16", attention="auto", lr=TRAIN_LR)
    ring = step_timing(cp, CP_B, CP_T, CP_KERNEL_CLASSES)
    dense = step_timing(dict(cp, step=cp["dense_step"]), CP_B, CP_T,
                        CP_KERNEL_CLASSES)
    del cp
    torch.cuda.empty_cache()
    return {
        **common,
        "cp": dict(ring, cp=CP_RING, mesh={"dp": 1, "tp": CP_RING},
                   remat=True, block_k=cp_run["block_k"],
                   launches_per_step={}),
        "dense": dict(dense, cp=1, remat=False, block_k=None,
                      launches_per_step={k: v for k, v in
                                         cp_run["launches"].items() if v}),
        "main_path_losses": cp_run["losses"],
        "main_path_peak_memory_gb": cp_run["main_path_peak_gb"],
        "gaps": cp_run["gaps"],
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


# ---------------------------------------------------------------------------
# phase 3k: the topology path (hierarchical collectives, segmented
# pipelining, the eager register, the autotuner)
# ---------------------------------------------------------------------------

#: bench.py's _bench_topology layout: world 8 in 2 slices of 4
TOPO_WORLD, TOPO_SLICE = 8, 4
#: the ragged layout of leader mode
TOPO_RAGGED = ((0, 1, 2), (3, 4, 5, 6, 7))
#: the autotuner's race on the 4-rank group (bounded to stay under 60 s)
TUNE_SIZES = (1 << 16, 1 << 22)
TUNE_THRESHOLD = 1 << 20
#: segmented pipelining's threshold: 64 MiB a rank splits into 4
PIPE_THRESHOLD = 16 * 1024 * 1024


def topo_registers(group, **extra) -> None:
    """Every algorithm register at ``pallas_ring`` (K1, rows 9-11, K3's
    root-only gather), plus ``extra``, on every rank."""
    for a in group:
        for key in ("allreduce_algorithm",) + ROOTED_REGISTERS:
            a.set_tuning(key, "pallas_ring")
        for key, value in extra.items():
            a.set_tuning(key, value)


def hier_want(op: str, topo, n: int, hier: bool) -> dict:
    """The kernels one call launches under ``pallas_ring``: flat, K1 or
    row 9 once (the data-movement ops run their plain lowerings, as
    JAX's are XLA's); decomposed, what its stages imply."""
    from accl_tpu_torch import hierarchical as rules

    if not hier or not rules.eligible(op, topo, n):
        return ({"ring_allreduce": 1} if op == "allreduce"
                else {"ring_bcast": 1} if op == "bcast" else {})
    multi = sum(1 for s in topo.slices if len(s) > 1)
    if op == "allreduce":
        if rules.allreduce_mode(topo, n) == "rail":
            # intra reduce-scatters (plain), K1 over each rail, intra
            # allgathers (plain)
            return {"ring_allreduce": len(topo.slices[0])}
        # row 10 into each slice's leader, K1 over the leaders, row 9
        return {"ring_reduce": multi, "ring_allreduce": 1,
                "ring_bcast": multi}
    if op == "bcast":  # over the representatives, then in each slice
        return {"ring_bcast": 1 + multi}
    return {}


def hier_case(kc, group, op: str, fn, root: int, data, n: int,
              totals: dict) -> dict:
    """One of the four HIER_OPS, flat then hierarchical, on integer-valued
    float32: both results held against numpy exactly and against each
    other bit for bit, each run's launches counted alone against
    ``hier_want``.  Returns the two runs' launches."""
    import numpy as np
    import torch

    world = len(group)
    topo = group[0].topology
    seg = n // world
    dev = group[0].engine.device
    if op == "allreduce":
        red = data[:, :n].sum(0) if fn.name == "SUM" else data[:, :n].max(0)
        want = [red] * world
    elif op == "allgather":
        want = [data[:, :seg].reshape(-1)] * world
    elif op == "reduce_scatter":
        full = (data[:, :seg * world].sum(0) if fn.name == "SUM"
                else data[:, :seg * world].max(0))
        want = [full[r * seg:(r + 1) * seg] for r in range(world)]
    else:
        want = [data[root, :n]] * world
    want_t = {}
    for r in range(world):
        key = id(want[r])
        if key not in want_t:
            want_t[key] = torch.from_numpy(
                np.ascontiguousarray(want[r])).to(dev)
    outs, launches = {}, {}
    count = seg if op in ("allgather", "reduce_scatter") else n
    for hier in (0, 1):
        for a in group:
            a.set_tuning("hierarchical", hier)
        results = {}

        def rank_main(a, r):
            if op == "allreduce":
                s = a.create_buffer_from(data[r, :n])
                d = a.create_buffer(n, np.float32)
                a.allreduce(s, d, n, function=fn)
            elif op == "allgather":
                s = a.create_buffer_from(data[r, :seg])
                d = a.create_buffer(seg * world, np.float32)
                a.allgather(s, d, seg)
            elif op == "reduce_scatter":
                s = a.create_buffer_from(data[r, :seg * world])
                d = a.create_buffer(seg, np.float32)
                a.reduce_scatter(s, d, seg, function=fn)
            else:
                d = a.create_buffer_from(data[r, :n])
                a.bcast(d, n, root=root)
            results[r] = d

        torch.cuda.synchronize()
        reset_launches(kc)
        run_ranks(group, rank_main, f"3k {op} hierarchical={hier}")
        torch.cuda.synchronize()
        got = {k: v for k, v in read_launches(kc).items() if v}
        want_l = hier_want(op, topo, count, bool(hier))
        what = (f"3k {topo.signature()} {op} {fn.name} root {root} n {n} "
                f"hierarchical={hier}")
        if got != want_l:
            fail(f"{what}: launches {got}, want {want_l}")
        for k, v in got.items():
            totals[k] += v
        launches[hier] = got
        outs[hier] = [results[r].device_array() for r in range(world)]
        for r in range(world):
            if not torch.equal(outs[hier][r], want_t[id(want[r])]):
                fail(f"{what} rank {r} differs from numpy")
    for r in range(world):
        if not torch.equal(outs[0][r], outs[1][r]):
            fail(f"3k {op} rank {r}: hierarchical differs from flat")
    for a in group:
        a.set_tuning("hierarchical", 0)
    return launches


def tuned_want(op: str, regs: dict, n: int) -> dict:
    """The kernels a call under a loaded plan's winner launches (every
    register else at its default, so ``xla``): K1 or row 9 once under a
    ``pallas_ring*`` winner; a pipelined, hierarchical or plain winner
    launches none."""
    algo = regs.get(f"{op}_algorithm", "xla")
    if algo.startswith("pallas_ring"):
        return {"ring_allreduce" if op == "allreduce" else "ring_bcast": 1}
    return {}


def topology_main_path(kc) -> dict:
    """Phase 3k: the topology path, each step's launches counted alone.

    * ``cuda_group(8)`` at bench.py's 2 x 4 (``Topology.from_slice_size(8,
      4)``) and ``cuda_group(4)`` at 2 x 2, every algorithm register at
      ``pallas_ring``: the four HIER_OPS, flat and with ``hierarchical``
      = 1, on integer-valued float32 from the seed, 16M elements (64 MiB)
      a rank (allgather's result and reduce_scatter's operand hold the 64
      MiB) — allreduce and reduce_scatter under SUM and MAX, bcast at
      roots 0 and W - 3 — each held exactly against numpy and
      hierarchical against flat bit for bit; flat launches K1 (or row 9)
      once, rail mode K1 once a rail, a hierarchical bcast row 9 once
      over the representatives and once a slice;
    * the ragged ``((0, 1, 2), (3, 4, 5, 6, 7))`` (``set_topology``):
      leader mode, row 10 once a slice, K1 once, row 9 once a slice; and
      16M + 1 elements on 2 x 4 (the slice does not divide it): leader
      mode too;
    * segmented pipelining on ``cuda_group(4)``: ``ring_segments`` 4,
      ``pipeline_threshold`` 16 MiB, the allreduce and the bcast at 64
      MiB equal to the unsplit call, 4 launches of K1 (row 9) and 4
      device interactions; async aggregates drained by ``flush()``;
    * the eager register: each write re-plans once and the plan's
      ``eager`` verdict flips at the written size;
    * ``autotune`` on ``cuda_group(4)`` at 2 x 2 (allreduce and bcast at
      2^16 and 2^22 elements, ``runs`` 3, ``include_pallas``, segments
      (1, 4), a 1 MiB pipeline threshold, hierarchical raced), its plan
      loaded: every candidate of the tier scored, each bucket's call
      launches its winner's lowering and gives the exact sum; then
      unloaded.

    Returns ``{"launches", "tune", "steps"}``; ``launches`` leaves out
    the tuned calls', which follow the race's winners (``steps`` holds
    them)."""
    import numpy as np
    import torch

    import accl_tpu_torch as at
    from accl_tpu_torch import tuning
    from accl_tpu_torch.constants import DataType, Operation
    from accl_tpu_torch.plans import size_bucket
    from accl_tpu_torch.topology import Topology

    SUM, MAX = at.ReduceFunction.SUM, at.ReduceFunction.MAX
    totals = {k: 0 for k in kc.KERNELS}
    rng = np.random.default_rng(SEED + 18)
    data = rng.integers(-64, 64, (TOPO_WORLD, N_RANK + 1),
                        dtype=np.int8).astype(np.float32)
    cases = [("allreduce", SUM, 0), ("allreduce", MAX, 0),
             ("allgather", SUM, 0), ("reduce_scatter", SUM, 0),
             ("reduce_scatter", MAX, 0), ("bcast", SUM, 0),
             ("bcast", SUM, -3)]
    steps = {}
    g8 = at.cuda_group(TOPO_WORLD, topology=Topology.from_slice_size(
        TOPO_WORLD, TOPO_SLICE))
    try:
        topo_registers(g8)
        for op, fn, root in cases:
            steps[f"2x4 {op} {fn.name} {root % TOPO_WORLD}"] = hier_case(
                kc, g8, op, fn, root % TOPO_WORLD, data, N_RANK, totals)
        steps["2x4 allreduce n+1 (leader)"] = hier_case(
            kc, g8, "allreduce", SUM, 0, data, N_RANK + 1, totals)
        for a in g8:
            a.set_topology(Topology(TOPO_RAGGED))
        for op, fn, root in (("allreduce", SUM, 0), ("allreduce", MAX, 0),
                             ("bcast", SUM, 0), ("bcast", SUM, 5)):
            steps[f"ragged {op} {fn.name} {root}"] = hier_case(
                kc, g8, op, fn, root, data, N_RANK, totals)
    finally:
        for a in g8:
            a.deinit()
    torch.cuda.empty_cache()

    g4 = at.cuda_group(P_MAIN, topology=Topology.from_slice_size(P_MAIN, 2))
    d4 = data[:P_MAIN]
    tune = {}
    try:
        topo_registers(g4)
        for op, fn, root in cases:
            steps[f"2x2 {op} {fn.name} {root % P_MAIN}"] = hier_case(
                kc, g4, op, fn, root % P_MAIN, d4, N_RANK, totals)
        gang = g4[0].engine.gang

        # -- segmented pipelining ------------------------------------------
        def pipelined(op, threshold):
            for a in g4:
                a.set_tuning("ring_segments", 4)
                a.set_tuning("pipeline_threshold", threshold)
            res = {}

            def rank_main(a, r):
                if op == "allreduce":
                    s = a.create_buffer_from(d4[r, :N_RANK])
                    res[r] = a.create_buffer(N_RANK, np.float32)
                    torch.cuda.synchronize()
                    a.allreduce(s, res[r], N_RANK)
                else:
                    res[r] = a.create_buffer_from(d4[r, :N_RANK])
                    torch.cuda.synchronize()
                    a.bcast(res[r], N_RANK, root=2)

            torch.cuda.synchronize()
            reset_launches(kc)
            ic0 = gang.interactions.read()
            run_ranks(g4, rank_main, f"3k pipelined {op}")
            torch.cuda.synchronize()
            got = {k: v for k, v in read_launches(kc).items() if v}
            for k, v in got.items():
                totals[k] += v
            return ([res[r].device_array() for r in range(P_MAIN)], got,
                    gang.interactions.read() - ic0)

        for op, kern in (("allreduce", "ring_allreduce"),
                         ("bcast", "ring_bcast")):
            whole, got1, ic1 = pipelined(op, 0)
            split, got4, ic4 = pipelined(op, PIPE_THRESHOLD)
            if got1 != {kern: 1} or got4 != {kern: 4} or ic4 != 4:
                fail(f"3k pipelined {op}: unsplit {got1}, split {got4} with "
                     f"{ic4} interactions, want 1 and 4 {kern}, 4")
            for r in range(P_MAIN):
                if not torch.equal(whole[r], split[r]):
                    fail(f"3k pipelined {op} rank {r} differs from unsplit")
            steps[f"pipelined {op}"] = {"unsplit": got1, "split": got4,
                                        "interactions": ic4}
        # an async aggregate drains at flush()
        sends = [a.create_buffer_from(d4[r, :N_RANK])
                 for r, a in enumerate(g4)]
        recvs = [a.create_buffer(N_RANK, np.float32) for a in g4]
        reqs = [None] * P_MAIN

        def post(a, r):
            reqs[r] = a.allreduce(sends[r], recvs[r], run_async=True)

        reset_launches(kc)
        run_ranks(g4, post, "3k async pipelined allreduce")
        for a in g4:
            a.flush()
        if (not all(q.done() for q in reqs)
                or g4[0].engine.gang.window.in_flight()):
            fail("3k: flush() left a pipelined aggregate undrained")
        for q in reqs:
            q.check("async pipelined allreduce")
        for r in range(P_MAIN):
            if not torch.equal(recvs[r].device_array(),
                               whole_ar(d4, recvs[r].tensor.device)):
                fail(f"3k async pipelined allreduce rank {r} off numpy")
        got = read_launches(kc)
        if got["ring_allreduce"] != 4:
            fail(f"3k async pipelined allreduce launched {got}")
        totals["ring_allreduce"] += 4
        for a in g4:
            a.set_tuning("pipeline_threshold", 0)
            a.set_tuning("ring_segments", 1)

        # -- the eager register --------------------------------------------
        a0 = g4[0]
        n_e = 1 << 20  # bucket 20: 4 MiB to 8 MiB - 4 of float32
        lo, hi = 4 * n_e, 4 * (2 * n_e - 1)
        verdicts = []
        for limit, want in ((hi, True), (lo, None), (lo - 1, False)):
            pc0 = a0.capabilities()["plan_cache"]
            for a in g4:
                a.set_max_eager_size(limit)
            plan = a0._plan_for(Operation.ALLREDUCE, a0.comm,
                                DataType.FLOAT32, n_e, None, 0, (0,))
            pc1 = a0.capabilities()["plan_cache"]
            if (plan.eager is not want
                    or pc1["invalidations"] != pc0["invalidations"] + 1
                    or pc1["misses"] != pc0["misses"] + 1):
                fail(f"3k eager limit {limit}: verdict {plan.eager} (want "
                     f"{want}), plan pool {pc0} -> {pc1}")
            verdicts.append([limit, plan.eager])
        for a in g4:
            a.set_max_eager_size(tuning.REGISTER_DEFAULTS["max_eager_size"])
        steps["eager verdicts"] = verdicts

        # -- the autotuner, and its plan loaded ---------------------------
        for a in g4:
            a.set_tuning("hierarchical", 0)
        t0 = time.time()
        plan = tuning.autotune(
            g4, collectives=["allreduce", "bcast"], sizes=list(TUNE_SIZES),
            runs=3, include_pallas=True, segments=(1, 4),
            pipeline_thresholds=(TUNE_THRESHOLD,))
        tune["wall_s"] = time.time() - t0
        if tune["wall_s"] > 60:
            fail(f"3k autotune took {tune['wall_s']:.1f} s (limit 60)")
        # every candidate of the card's tier was raced and scored: none
        # dropped out of the race (a failing one raises in autotune)
        tier = tuning.detect_tier(g4)
        for op in ("allreduce", "bcast"):
            labels = sorted(tuning._cand_label(regs) for regs in
                            tuning._candidates(
                                tier, op, P_MAIN, True, (), (1, 4),
                                (TUNE_THRESHOLD,), race_hierarchical=True))
            for n in TUNE_SIZES:
                scored = sorted(plan.entries.get(op, {}).get(
                    size_bucket(n), {}).get("candidates", {}))
                if scored != labels:
                    fail(f"3k autotune {op} n={n} scored {scored}, "
                         f"want {labels}")
        print(json.dumps({"tuning_plan": json.loads(plan.to_json())}),
              flush=True)
        tune["winners"] = {
            f"{op} 2^{b}": e["registers"] or "defaults"
            for op, per in plan.entries.items() for b, e in per.items()}
        for a in g4:
            a.load_tuning_plan(plan)
        for op, per in plan.entries.items():
            for b, e in per.items():
                n = int(e["size"])
                regs = e["registers"]
                res = {}

                def rank_main(a, r, op=op, n=n):
                    if op == "allreduce":
                        s = a.create_buffer_from(d4[r, :n])
                        res[r] = a.create_buffer(n, np.float32)
                        torch.cuda.synchronize()
                        a.allreduce(s, res[r], n)
                    else:
                        res[r] = a.create_buffer_from(d4[r, :n])
                        torch.cuda.synchronize()
                        a.bcast(res[r], n, root=0)

                torch.cuda.synchronize()
                reset_launches(kc)
                run_ranks(g4, rank_main, f"3k tuned {op} 2^{b}")
                torch.cuda.synchronize()
                got = {k: v for k, v in read_launches(kc).items() if v}
                want = tuned_want(op, regs, n)
                if got != want:
                    fail(f"3k tuned {op} 2^{b} ({regs}): launches {got}, "
                         f"want {want}")
                # kept out of ``totals``: they follow the race's winners
                p = a0._plan_for(Operation[op.upper()], a0.comm,
                                 DataType.FLOAT32, n, None, 0, (0,))
                if (p.tuning or {}) != regs:
                    fail(f"3k tuned {op} 2^{b}: plan overlay {p.tuning}, "
                         f"want {regs}")
                ref = (data[:P_MAIN, :n].sum(0) if op == "allreduce"
                       else data[0, :n])
                ref_t = torch.from_numpy(np.ascontiguousarray(ref)).to(
                    res[0].tensor.device)
                for r in range(P_MAIN):
                    if not torch.equal(res[r].device_array(), ref_t):
                        fail(f"3k tuned {op} 2^{b} rank {r} off numpy")
                steps[f"tuned {op} 2^{b}"] = got
        for a in g4:
            a.unload_tuning_plan()
        if gang.tuning != dict(at.constants.TUNING_DEFAULTS):
            fail(f"3k: unload_tuning_plan left {gang.tuning}")
    finally:
        for a in g4:
            a.deinit()
    torch.cuda.empty_cache()
    return {"launches": totals, "tune": tune, "steps": steps}


# ---------------------------------------------------------------------------
# phase 3l: the telemetry plane and the monitor (ROADMAP A11b)
# ---------------------------------------------------------------------------

#: phase 3l's two sizes a rank (float32): the collectives cell's 256 KiB
#: and 64 MiB
TELEM_SIZES = (64 * 1024, N_RANK)
#: (e)'s rounds and calls a round, each group in turn
TELEM_ROUNDS, TELEM_CALLS = 5, 30
#: the cuda sleep holding the stream while the host posts (e)'s async
#: calls (the device-time pass) or (b)'s stream of windows
TELEM_SLEEP = 100_000_000


def telem_records(a, since: int) -> list:
    """Rank handle ``a``'s flight records appended after total ``since``."""
    recs, _ = a._telemetry.recorder.since(since)
    return recs


def telemetry_main_path(kc) -> dict:
    """Phase 3l: the telemetry plane and the monitor on ``cuda_group(4)``,
    float32, each step's launches counted:

    (a) warm ``pallas_ring`` allreduces (4 segments) at 256 KiB and 64 MiB
        a rank: one flight record a rank a call (``plan_hit`` true,
        ``algorithm`` ``pallas_ring``, retcode 0, one K1 launch), exactly
        1 device interaction a warm call, results equal to K1's plain
        fold;
    (b) a batched window of 8 allreduces at 256 KiB (row 14), inline (the
        card's ``pallas`` lowering), then a stream of 3 windows under
        ``xla`` held behind a sleep kernel (the first inline, the next
        arming a persistent run, the last a mailbox post): every window
        logged once with 8 slots, retcodes OK, each slot's trace id the
        flight record's of its call, ``mailbox_us`` on the run's windows;
    (c) every rank's ``export_chrome_trace``, merged by ``python -m
        accl_tpu_torch.telemetry merge`` (its flow check on): the merged
        flows validate;
    (d) ``start_monitor(port=0)``: ``/metrics``, ``/snapshot``, ``/trace``
        and ``/cmdring`` answer 200; a group under ``ACCL_TRACE_STREAM``
        writes a loadable trace file; no monitor or stream thread is
        left after ``deinit``.

    Returns the launch counts and the checks' figures."""
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    import accl_tpu_torch as at
    from accl_tpu_torch.constants import CMDRING_ST_OK
    from accl_tpu_torch.telemetry import validate_flows

    P = P_MAIN
    SUM = at.ReduceFunction.SUM
    out = {"launches": {k: 0 for k in kc.KERNELS}}
    rng = np.random.default_rng(SEED + 41)

    def step(what, rank_main, want):
        """``rank_main`` on every rank; the kernels it launched must be
        ``want`` and nothing else."""
        before = {k: f.launches.count for k, f in kc.KERNELS.items()}
        run_ranks(group, rank_main, f"3l {what}")
        moved = {k: f.launches.count - before[k] for k, f in
                 kc.KERNELS.items() if f.launches.count != before[k]}
        if moved != want:
            fail(f"3l {what}: launched {moved}, want {want}")
        for k, v in moved.items():
            out["launches"][k] += v

    group = at.cuda_group(P)
    ring = group[0].engine.gang.cmdring
    try:
        if not all(a.capabilities()["telemetry"] for a in group):
            fail("3l: the telemetry plane is off")
        # (a) warm pallas_ring allreduces
        for a in group:
            a.set_tuning("allreduce_algorithm", "pallas_ring")
            a.set_tuning("ring_segments", 4)
        warm = {}
        for n in TELEM_SIZES:
            data = rng.standard_normal((P, n), dtype=np.float32)
            send = [a.create_buffer_from(data[r])
                    for r, a in enumerate(group)]
            recv = [a.create_buffer(n, np.float32) for a in group]

            def call(a, r):
                a.allreduce(send[r], recv[r], n)

            step(f"cold {4 * n} B", call, {"ring_allreduce": 1})
            step(f"prepared {4 * n} B", call, {"ring_allreduce": 1})
            totals = [a._telemetry.recorder.total for a in group]
            ic0 = group[0].capabilities()["device_interactions"]
            step(f"warm {4 * n} B", call, {"ring_allreduce": 1})
            ic = group[0].capabilities()["device_interactions"] - ic0
            if ic != 1:
                fail(f"3l warm {4 * n} B: {ic} device interactions")
            for r, a in enumerate(group):
                recs = telem_records(a, totals[r])
                if len(recs) != 1:
                    fail(f"3l warm {4 * n} B rank {r}: {len(recs)} records")
                rec = recs[0]
                if (rec.op, rec.plan_hit, rec.algorithm, rec.retcode,
                        rec.count) != ("allreduce", True, "pallas_ring", 0,
                                       n):
                    fail(f"3l warm {4 * n} B rank {r}: {rec.as_dict()}")
            xs = [b.tensor[:n] for b in send]
            want = kc.ring_allreduce_plain(xs, SUM, 4)
            for r in range(P):
                compare(f"3l warm {4 * n} B rank {r}",
                        recv[r].device_array(), want[r])
            ids = {telem_records(a, totals[r])[0].trace_id
                   for r, a in enumerate(group)}
            if len(ids) != 1:
                fail(f"3l warm {4 * n} B: ranks disagree on the trace id")
            warm[4 * n] = {"interactions_per_call": ic,
                           "records_per_rank": 1}
            del send, recv, xs, want
        out["warm"] = warm
        for a in group:
            a.set_tuning("allreduce_algorithm", "xla")

        # (b) batched windows of 8 allreduces on the command ring
        n = TELEM_SIZES[0]
        send = [a.create_buffer_from(np.full(n, r + 1.0, np.float32))
                for r, a in enumerate(group)]
        outs = [[a.create_buffer(n, np.float32) for _ in range(8)]
                for a in group]
        exact = float(sum(range(1, P + 1)))

        def window(a, r):
            with a.batch():
                reqs = [a.allreduce(send[r], d, run_async=True)
                        for d in outs[r]]
            for q in reqs:
                if not q.wait(120) or not q.ring_resident:
                    raise RuntimeError(f"{q.op_name} off the ring")
                q.check()

        def stream(a, r):
            reqs = []
            a.begin_batch()
            try:
                for _ in range(3):
                    reqs += [a.allreduce(send[r], d, run_async=True)
                             for d in outs[r]]
                    a._dispatch_pending()
            finally:
                a.end_batch()
            for q in reqs:
                if not q.wait(120):
                    raise RuntimeError("a stream window never completed")
                q.check()

        def logged(since_w, since_r, want_forms):
            new = ring.stats()["windows_logged"] - since_w
            log = ring.window_log()[-new:] if new > 0 else []
            if [w["form"] for w in log] != want_forms:
                fail(f"3l windows: forms {[w['form'] for w in log]}, "
                     f"want {want_forms}")
            ids = [rec.trace_id for rec in telem_records(group[0], since_r)]
            for k, w in enumerate(log):
                slots = w["slots"]
                if len(slots) != 8 or any(
                        s["retcode"] != CMDRING_ST_OK for s in slots):
                    fail(f"3l window {w['window_id']}: {slots}")
                if [s["trace_id"] for s in slots] != ids[8 * k:8 * k + 8]:
                    fail(f"3l window {w['window_id']}: slot trace ids "
                         f"{[s['trace_id'] for s in slots]}, records "
                         f"{ids[8 * k:8 * k + 8]}")
                if w["basis"] != "host":
                    fail(f"3l window {w['window_id']}: basis {w['basis']}")
            for r in range(P):
                for d in outs[r]:
                    if not bool((d.device_array() == exact).all()):
                        fail(f"3l window rank {r}: a sum differs from "
                             f"{exact}")
            return log

        w0 = ring.stats()["windows_logged"]
        r0 = group[0]._telemetry.recorder.total
        step("inline window", window, {"sequencer": 1})
        inline = logged(w0, r0, ["inline"])
        # the stream's buffers exist before the sleep (a fill syncs)
        ring.lowering = "xla"
        saved = ring.linger_s
        ring.linger_s = 0.5
        try:
            w0 = ring.stats()["windows_logged"]
            r0 = group[0]._telemetry.recorder.total
            hold_stream(TELEM_SLEEP)
            step("stream of 3 windows", stream,
                 {"sequencer": 1, "sequencer_run": 1})
            streamed = logged(w0, r0, ["inline", "mailbox", "mailbox"])
        finally:
            ring.linger_s = saved
            ring.lowering = "pallas"
        for w in streamed[1:]:
            if "posted_us" not in w.get("mailbox_us", {}):
                fail(f"3l run window {w['window_id']}: no mailbox_us")
        out["windows"] = {
            "inline_dur_us": inline[0]["dur_us"],
            "stream_dur_us": [w["dur_us"] for w in streamed],
            "stream_forms": [w["form"] for w in streamed],
            "mailbox_us": [w.get("mailbox_us") for w in streamed],
            "windows_logged": ring.stats()["windows_logged"],
        }

        # (c) per-rank traces through the merge CLI
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for r, a in enumerate(group):
                path = os.path.join(tmp, f"rank{r}.json")
                a.export_chrome_trace(path)
                paths.append(path)
            merged_path = os.path.join(tmp, "merged.json")
            proc = subprocess.run(
                [sys.executable, "-m", "accl_tpu_torch.telemetry", "merge",
                 "--out", merged_path] + paths,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                fail(f"3l merge CLI: {proc.stderr.strip()[-500:]}")
            with open(merged_path) as f:
                merged = json.load(f)["traceEvents"]
        problems = validate_flows(merged)
        if problems:
            fail(f"3l merged flows: {problems[:4]}")
        out["trace"] = {
            "events": len(merged),
            "flows": sum(e.get("cat") == "accl.flow" for e in merged),
            "ring_spans": sum(e.get("cat") == "cmdring"
                              and e.get("ph") == "X" for e in merged)}

        # (d) the scrape service and the trace stream
        port = group[0].start_monitor(port=0)
        scraped = {}
        for route in ("/metrics", "/snapshot", "/trace", "/cmdring"):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                        timeout=30) as resp:
                body = resp.read()
                scraped[route] = [resp.status, len(body)]
            if resp.status != 200:
                fail(f"3l {route}: status {resp.status}")
        if not group[0].stop_monitor():
            fail("3l: the monitor thread did not stop")
        out["scrapes"] = scraped
    finally:
        for a in group:
            a.deinit()
    with tempfile.TemporaryDirectory() as tmp:
        saved_env = {k: os.environ.get(k) for k in (
            "ACCL_TRACE_STREAM", "ACCL_TRACE_STREAM_INTERVAL_S")}
        os.environ["ACCL_TRACE_STREAM"] = tmp
        os.environ["ACCL_TRACE_STREAM_INTERVAL_S"] = "0.05"
        try:
            sg = at.cuda_group(2)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        try:
            bufs = [(a.create_buffer(1024, np.float32),
                     a.create_buffer(1024, np.float32)) for a in sg]
            for _ in range(3):
                run_ranks(sg, lambda a, r: a.allreduce(*bufs[r]),
                          "3l trace stream")
            deadline = time.monotonic() + 30
            streamed = 0
            while time.monotonic() < deadline and streamed < 6:
                streamed = 0
                for name in os.listdir(tmp):
                    if name.startswith("accl_trace_rank"):
                        with open(os.path.join(tmp, name)) as f:
                            streamed += sum(
                                e.get("name") == "accl::allreduce"
                                for e in json.load(f)["traceEvents"])
                time.sleep(0.05)
            if streamed != 6:
                fail(f"3l trace stream: {streamed} allreduce events on "
                     f"disk, want 6")
        finally:
            for a in sg:
                a.deinit()
        out["trace_stream_events"] = streamed
    left = [t.name for t in threading.enumerate() if t.is_alive()
            and t.name.startswith(("accl-monitor", "accl-trace-stream"))]
    if left:
        fail(f"3l: threads left after deinit: {left}")
    return out


def telemetry_cost(kc) -> dict:
    """Phase 3l (e), the plane's cost: two ``cuda_group(4)``, one with the
    plane on and one built under ``ACCL_TELEMETRY=0``, warm
    ``pallas_ring`` allreduces at 256 KiB a rank, ``TELEM_ROUNDS`` rounds
    of ``TELEM_CALLS`` synchronous calls each, the groups in turn
    (alternating which goes first): rank 0's call p50 / p90 (host clock)
    and the gang's launch p50 / p90 (``Request.get_duration_ns``); then
    the records' ``duration_ns`` p50 (the on group's calls) beside the
    calls' device time (CUDA events around ``TELEM_CALLS`` async calls
    posted behind a sleep kernel, so the events bracket the launches'
    device work and not the host's posting)."""
    import numpy as np
    import torch

    import accl_tpu_torch as at

    P, n = P_MAIN, TELEM_SIZES[0]
    saved = os.environ.get("ACCL_TELEMETRY")
    groups = {"on": at.cuda_group(P)}
    os.environ["ACCL_TELEMETRY"] = "0"
    try:
        groups["off"] = at.cuda_group(P)
    finally:
        if saved is None:
            os.environ.pop("ACCL_TELEMETRY", None)
        else:
            os.environ["ACCL_TELEMETRY"] = saved
    if groups["off"][0].capabilities()["telemetry"]:
        fail("3l (e): the off group records")
    samples = {k: {"call": [], "launch": [], "device_ms": []}
               for k in groups}
    records = []
    launches = {k: 0 for k in kc.KERNELS}
    try:
        bufs = {}
        for k, g in groups.items():
            for a in g:
                a.set_tuning("allreduce_algorithm", "pallas_ring")
                a.set_tuning("ring_segments", 4)
                # the device pass posts every call behind a sleep kernel:
                # a window that holds them all keeps the host from
                # waiting on the card there
                a.set_inflight_window(TELEM_CALLS + 2)
            bufs[k] = [(a.create_buffer_from(np.full(n, r + 1.0,
                                                     np.float32)),
                        a.create_buffer(n, np.float32))
                       for r, a in enumerate(g)]
            for _ in range(3):  # cold, prepared, warm
                run_ranks(g, lambda a, r, b=bufs[k]: a.allreduce(*b[r]),
                          f"3l (e) warm-up {k}")
        before = {k: f.launches.count for k, f in kc.KERNELS.items()}

        def sync_pass(k):
            g, b = groups[k], bufs[k]
            totals = ([a._telemetry.recorder.total for a in g]
                      if k == "on" else None)

            def rank_main(a, r):
                for _ in range(TELEM_CALLS):
                    t = time.perf_counter()
                    req = a.allreduce(*b[r])
                    if r == 0:
                        samples[k]["call"].append(time.perf_counter() - t)
                        samples[k]["launch"].append(
                            req.get_duration_ns() * 1e-9)

            run_ranks(g, rank_main, f"3l (e) {k}")
            if k == "on":
                for r, a in enumerate(g):
                    recs = telem_records(a, totals[r])
                    if len(recs) != TELEM_CALLS:
                        fail(f"3l (e) rank {r}: {len(recs)} records for "
                             f"{TELEM_CALLS} calls")
                    if r == 0:
                        records.extend(rec.duration_ns * 1e-9
                                       for rec in recs)

        def device_pass(k):
            g, b = groups[k], bufs[k]
            gate = threading.Barrier(P)
            ev = {}

            def rank_main(a, r):
                if r == 0:
                    torch.cuda.synchronize()
                    torch.cuda._sleep(TELEM_SLEEP)
                    ev["start"] = torch.cuda.Event(enable_timing=True)
                    ev["start"].record()
                gate.wait(60)
                reqs = [a.allreduce(*b[r], run_async=True)
                        for _ in range(TELEM_CALLS)]
                gate.wait(60)  # every launch is on the stream
                if r == 0:
                    ev["end"] = torch.cuda.Event(enable_timing=True)
                    ev["end"].record()
                for q in reqs:
                    q.wait(60)
                    q.check()

            run_ranks(g, rank_main, f"3l (e) device {k}")
            ev["end"].synchronize()
            samples[k]["device_ms"].append(
                ev["start"].elapsed_time(ev["end"]) / TELEM_CALLS)

        for i in range(TELEM_ROUNDS):
            order = ("on", "off") if i % 2 == 0 else ("off", "on")
            for k in order:
                sync_pass(k)
            for k in order:
                device_pass(k)
        for name, f in kc.KERNELS.items():
            launches[name] = f.launches.count - before[name]
        host_us = telemetry_host_us(groups["on"][0], n)
        want = 2 * TELEM_ROUNDS * 2 * TELEM_CALLS
        if launches != {**{k: 0 for k in kc.KERNELS},
                        "ring_allreduce": want}:
            moved = {k: v for k, v in launches.items() if v}
            fail(f"3l (e): launched {moved}, want ring_allreduce {want}")
    finally:
        for g in groups.values():
            for a in g:
                a.deinit()

    def pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3

    res = {"bytes_per_rank": 4 * n, "rounds": TELEM_ROUNDS,
           "calls_per_round": TELEM_CALLS}
    for k, s in samples.items():
        res[k] = {"call_p50_ms": pct(s["call"], 50),
                  "call_p90_ms": pct(s["call"], 90),
                  "launch_p50_ms": pct(s["launch"], 50),
                  "launch_p90_ms": pct(s["launch"], 90),
                  "device_ms_per_call": float(np.median(s["device_ms"]))}
    res["record_duration_p50_ms"] = pct(records, 50)
    res["host_us"] = host_us
    res["launches"] = launches
    return res


def telemetry_host_us(a, n: int, iters: int = 2000) -> dict:
    """The plane's pieces on the host, each timed alone over ``iters``
    runs on this thread (host clock, microseconds a run): ``call_meta``,
    a warm allreduce's intake facts (its trace id included), run on
    every rank's thread; ``record``, one completion's record with the
    monitor's observers (the skew tracker, the watchdog), and
    ``record_bare`` without them, both run P times a call on the gang's
    executing thread.  Run last on ``a``: the intake advances its trace
    counters."""
    from accl_tpu_torch.backends.base import CallOptions
    from accl_tpu_torch.constants import (
        DataType, ErrorCode, HostFlags, Operation)
    from accl_tpu_torch.telemetry import Telemetry

    import accl_tpu_torch as at

    fn = int(at.ReduceFunction.SUM)
    plan = a._plan_for(Operation.ALLREDUCE, a.comm, DataType.FLOAT32, n,
                       None, HostFlags.NO_HOST, (fn,))
    opts = CallOptions(op=Operation.ALLREDUCE, comm=a.comm, count=n,
                       arithcfg=plan.arithcfg, plan=plan)
    meta = a._call_meta(opts)
    bare = Telemetry(a.rank, "CudaEngine")
    out = {}
    for name, fn_ in (
            ("call_meta", lambda: a._call_meta(opts)),
            ("record", lambda: a._telemetry.record(meta, 150_000,
                                                   ErrorCode.OK)),
            ("record_bare", lambda: bare.record(meta, 150_000,
                                                ErrorCode.OK))):
        t = time.perf_counter()
        for _ in range(iters):
            fn_()
        out[name] = (time.perf_counter() - t) / iters * 1e6
    return out


def whole_ar(d4, device):
    """The exact allreduce of ``d4``'s rows at N_RANK, on ``device``."""
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(
        d4[:, :N_RANK].sum(0))).to(device)


# ---------------------------------------------------------------------------
# phase 3m: faults, membership and the contract (ROADMAP A11c)
# ---------------------------------------------------------------------------

#: (a)'s watchdog timeout and (c)'s, as JAX's own gang tests set them
FAULT_TIMEOUT_S, ELASTIC_TIMEOUT_S = 0.3, 1.0
#: (b)'s and (d)'s calls: 256 KiB float32 a rank; (c) serves at N_RANK
FAULT_N = 64 * 1024
#: (d)'s breaker cool-down: long enough that both open-breaker steps
#: fall inside it
FAULT_COOLDOWN_S = 1.0


def faults_main_path(kc) -> dict:
    """Phase 3m: the fault, membership and contract planes on the card,
    virtual ranks, integer-valued float32 (every sum exact), each step's
    launches counted:

    (a) ``cuda_group(2)`` with rank 1 absent and ``set_timeout(0.3)``: the
        call fails RECEIVE_TIMEOUT naming peer 1 in under 1 s, the peer
        is suspect, dead after the second strike, the third call fails
        at intake (under 0.1 s, ``elapsed_s`` 0.0); both ranks
        ``soft_reset`` and a ``pallas_ring`` allreduce is exact (one K1);
    (b) ``cuda_group(4)`` with ``set_contract_verify(True, interval=2)``:
        a seeded ``diverge`` on rank 2 fails every rank CONTRACT_VIOLATION
        naming rank 2 in under 15 s; after ``soft_reset`` a uniform
        stream of ``pallas_ring`` calls passes, exact;
    (c) ``cuda_group(4)`` under ``set_elastic`` with timeout 1.0 and rank
        3 silent: the survivors get RANK_EVICTED in under 20 s; at world 3
        a ``pallas_ring`` allreduce at 64 MiB a rank (K1 at P = 3) and a
        ``pallas_ring`` bcast (row 9) are exact; after every rank's
        ``soft_reset`` world 4 is back and the allreduce exact;
    (d) windows of 8 allreduces at 256 KiB on ``cuda_group(4)``: with the
        breaker open the plain lowering never stands in for the ring:
        under the ``xla`` registers the batch fails at once (under 2 s,
        INVALID_OPERATION naming ``circuit_open``, no launch), under
        ``pallas_ring`` it runs call by call on K1 (8 launches, no row-14
        launch, exact), each refusal counted; after the cool-down the
        probe window rides row 14 (one launch) and closes it; a
        ``corrupt`` plan poisons a window inline and one posted to a
        live persistent run (the lowering ``xla``): slot 0 fails
        INVALID_OPERATION in under 2 s and row 14's device status word
        reads 2 (BAD_OP), the other slots 1 (OK); ``soft_reset``
        recovers an exact window.

    Returns the launch counts and the checks' figures."""
    import numpy as np
    import torch

    import accl_tpu_torch as at
    from accl_tpu_torch import contract as tcontract
    from accl_tpu_torch.faults import FaultPlan, FaultRule

    EC = at.ErrorCode
    out = {"launches": {k: 0 for k in kc.KERNELS}}
    rng = np.random.default_rng(SEED + 43)

    def counts():
        return {k: f.launches.count for k, f in kc.KERNELS.items()}

    def moved_since(before, what, want):
        moved = {k: f.launches.count - before[k]
                 for k, f in kc.KERNELS.items()
                 if f.launches.count != before[k]}
        if want is not None and moved != want:
            fail(f"3m {what}: launched {moved}, want {want}")
        for k, v in moved.items():
            out["launches"][k] += v
        return moved

    def ints(n):
        return rng.integers(-8, 8, size=n).astype(np.float32)

    check_circuit_opens("before phase 3m", 0)
    # (a) the slot watchdog, the health map, fail-fast and soft_reset
    g = at.cuda_group(2)
    try:
        a = g[0]
        for x in g:
            x.set_tuning("allreduce_algorithm", "pallas_ring")
        a.set_timeout(FAULT_TIMEOUT_S)
        s = a.create_buffer_from(ints(FAULT_N))
        d = a.create_buffer(FAULT_N, np.float32)
        before = counts()
        strikes = []
        for _ in range(2):
            t = time.perf_counter()
            try:
                a.allreduce(s, d, FAULT_N)
                fail("3m (a): a call with an absent peer completed")
            except at.ACCLError as e:
                strikes.append((time.perf_counter() - t, e))
        e = strikes[0][1]
        if (e.code != EC.RECEIVE_TIMEOUT or e.details.get("peer") != 1
                or strikes[0][0] >= 1.0):
            fail(f"3m (a): first strike {e.code} {e.details.get('peer')} "
                 f"in {strikes[0][0]:.3f} s")
        health = a.capabilities()["health"][1]
        if health["state"] != "dead" or health["timeouts"] != 2:
            fail(f"3m (a): after two strikes {health}")
        a.set_timeout(10)
        t = time.perf_counter()
        try:
            a.allreduce(s, d, FAULT_N)
            fail("3m (a): a call to a dead peer completed")
        except at.ACCLError as e:
            intake_s = time.perf_counter() - t
            if (e.code != EC.RECEIVE_TIMEOUT or intake_s >= 0.1
                    or e.details.get("elapsed_s") != 0.0):
                fail(f"3m (a): intake {e.code} in {intake_s:.4f} s, "
                     f"{e.details}")
        moved_since(before, "(a) strikes", {})
        run_ranks(g, lambda x, r: x.soft_reset(), "3m (a) soft_reset")
        if g[0].capabilities()["health"][1]["state"] != "ok":
            fail("3m (a): soft_reset left the health map")
        data = np.stack([ints(FAULT_N) for _ in range(2)])
        bufs = [(x.create_buffer_from(data[r]),
                 x.create_buffer(FAULT_N, np.float32))
                for r, x in enumerate(g)]
        before = counts()
        run_ranks(g, lambda x, r: x.allreduce(*bufs[r]), "3m (a) recovery")
        moved_since(before, "(a) recovery", {"ring_allreduce": 1})
        for r in range(2):
            if not np.array_equal(bufs[r][1].device_array().cpu().numpy(),
                                  data.sum(0)):
                fail(f"3m (a): the recovered allreduce differs, rank {r}")
        out["watchdog"] = {"timeout_s": FAULT_TIMEOUT_S,
                           "strike_s": [st[0] for st in strikes],
                           "intake_s": intake_s}
    finally:
        for x in g:
            x.deinit()

    # (b) the contract verifier: a seeded divergence, then a uniform stream
    g = at.cuda_group(P_MAIN)
    try:
        for x in g:
            x.set_tuning("allreduce_algorithm", "pallas_ring")
            x.set_contract_verify(True, interval=2)
        data = np.stack([ints(FAULT_N) for _ in range(P_MAIN)])
        bufs = [(x.create_buffer_from(data[r]),
                 x.create_buffer(FAULT_N, np.float32))
                for r, x in enumerate(g)]
        errs = {}

        def diverging(x, r):
            try:
                for _ in range(10):
                    x.allreduce(*bufs[r])
            except at.ACCLError as e:
                errs[r] = e

        tcontract.install_fault_plan(FaultPlan(
            [FaultRule(action="diverge", rank=2, nth=3)], seed=9))
        before = counts()
        t = time.perf_counter()
        try:
            run_ranks(g, diverging, "3m (b) divergence")
        finally:
            tcontract.install_fault_plan(None)
        verdict_s = time.perf_counter() - t
        if sorted(errs) != list(range(P_MAIN)) or verdict_s >= 15 or any(
                e.code != EC.CONTRACT_VIOLATION
                or e.details.get("diverging_rank") != 2
                for e in errs.values()):
            fail(f"3m (b): {verdict_s:.2f} s, "
                 f"{ {r: (e.code, e.details.get('diverging_rank')) for r, e in errs.items()} }")
        moved = moved_since(before, "(b) divergence", None)
        if set(moved) - {"ring_allreduce"}:
            fail(f"3m (b): the divergence launched {moved}")
        run_ranks(g, lambda x, r: x.soft_reset(), "3m (b) soft_reset")
        before = counts()
        run_ranks(g, lambda x, r: [x.allreduce(*bufs[r]) for _ in range(8)],
                  "3m (b) uniform stream")
        moved_since(before, "(b) uniform stream", {"ring_allreduce": 8})
        snap = g[0].telemetry_snapshot()["contract"]
        if snap["verdicts"] or snap["comms"]["0"]["calls"] != 8:
            fail(f"3m (b): the uniform stream's verifier {snap}")
        for r in range(P_MAIN):
            if not np.array_equal(bufs[r][1].device_array().cpu().numpy(),
                                  data.sum(0)):
                fail(f"3m (b): the uniform stream differs, rank {r}")
        out["contract"] = {"verdict_s": verdict_s,
                           "first_mismatch": errs[0].details["contract"][
                               "first_mismatch"]["got"]["seqn"]}
    finally:
        for x in g:
            x.deinit()

    # (c) elastic membership: kill -> shrink -> serve -> restore
    g = at.cuda_group(P_MAIN)
    try:
        for x in g:
            x.set_elastic(True)
            x.set_timeout(ELASTIC_TIMEOUT_S)
            x.set_tuning("allreduce_algorithm", "pallas_ring")
            x.set_tuning("bcast_algorithm", "pallas_ring")
        survivors = g[:3]
        small = np.stack([ints(FAULT_N) for _ in range(3)])
        sb = [(x.create_buffer_from(small[r]),
               x.create_buffer(FAULT_N, np.float32))
              for r, x in enumerate(survivors)]
        codes = {}

        def doomed(x, r):
            codes[r] = []
            for _ in range(4):
                try:
                    x.allreduce(*sb[r])
                    return
                except at.ACCLError as e:
                    codes[r].append(e.code)
                    if e.code & EC.RANK_EVICTED:
                        return

        before = counts()
        t = time.perf_counter()
        run_ranks(survivors, doomed, "3m (c) eviction")
        evict_s = time.perf_counter() - t
        moved_since(before, "(c) eviction", {})
        if evict_s >= 20 or any(not c or not c[-1] & EC.RANK_EVICTED
                                for c in codes.values()):
            fail(f"3m (c): {evict_s:.2f} s, codes {codes}")
        if [x.size for x in survivors] != [3, 3, 3]:
            fail(f"3m (c): sizes {[x.size for x in survivors]}")
        big = np.stack([ints(N_RANK) for _ in range(3)])
        bb = [(x.create_buffer_from(big[r]),
               x.create_buffer(N_RANK, np.float32),
               x.create_buffer_from(big[1] if r == 1 else
                                    np.zeros(N_RANK, np.float32)))
              for r, x in enumerate(survivors)]

        def serve(x, r):
            x.allreduce(bb[r][0], bb[r][1], N_RANK)
            x.bcast(bb[r][2], N_RANK, root=1)

        before = counts()
        run_ranks(survivors, serve, "3m (c) serving at world 3")
        moved_since(before, "(c) serving at world 3",
                    {"ring_allreduce": 1, "ring_bcast": 1})
        want = big.sum(0)
        for r in range(3):
            if not np.array_equal(bb[r][1].device_array().cpu().numpy(),
                                  want):
                fail(f"3m (c): the allreduce at world 3 differs, rank {r}")
            if not np.array_equal(bb[r][2].device_array().cpu().numpy(),
                                  big[1]):
                fail(f"3m (c): the bcast at world 3 differs, rank {r}")
        del bb
        for x in g:
            x.set_timeout(10.0)
        run_ranks(g, lambda x, r: x.soft_reset(), "3m (c) restore")
        if [x.size for x in g] != [P_MAIN] * P_MAIN:
            fail(f"3m (c): restore left sizes {[x.size for x in g]}")
        full = np.stack([ints(FAULT_N) for _ in range(P_MAIN)])
        fb = [(x.create_buffer_from(full[r]),
               x.create_buffer(FAULT_N, np.float32))
              for r, x in enumerate(g)]
        before = counts()
        run_ranks(g, lambda x, r: x.allreduce(*fb[r]), "3m (c) world 4")
        moved_since(before, "(c) world 4", {"ring_allreduce": 1})
        for r in range(P_MAIN):
            if not np.array_equal(fb[r][1].device_array().cpu().numpy(),
                                  full.sum(0)):
                fail(f"3m (c): the restored allreduce differs, rank {r}")
        m = g[0].telemetry_snapshot()["membership"]
        out["membership"] = {"evict_s": evict_s,
                             "evictions_total": m["evictions_total"],
                             "restores_total": m["restores_total"]}
    finally:
        for x in g:
            x.deinit()
    torch.cuda.empty_cache()

    # (d) the ring's breaker and chaos hook
    saved = os.environ.get("ACCL_CMDRING_COOLDOWN_S")
    os.environ["ACCL_CMDRING_COOLDOWN_S"] = str(FAULT_COOLDOWN_S)
    try:
        g = at.cuda_group(P_MAIN)
    finally:
        if saved is None:
            os.environ.pop("ACCL_CMDRING_COOLDOWN_S", None)
        else:
            os.environ["ACCL_CMDRING_COOLDOWN_S"] = saved
    ring = g[0].engine.gang.cmdring
    cid = g[0].comm.id
    try:
        data = np.stack([ints(FAULT_N) for _ in range(P_MAIN)])
        send = [x.create_buffer_from(data[r]) for r, x in enumerate(g)]
        outs = [[x.create_buffer(FAULT_N, np.float32) for _ in range(8)]
                for x in g]
        want = data.sum(0)
        failed = {}

        def batch(x, r, reqs=None):
            with x.batch():
                qs = [x.allreduce(send[r], d, run_async=True)
                      for d in outs[r]]
            if reqs is not None:
                reqs[r] = qs
                return
            for q in qs:
                if not q.wait(60):
                    raise RuntimeError("a window never completed")
                q.check()

        def exact(what):
            for r in range(P_MAIN):
                for d in outs[r]:
                    if not np.array_equal(d.device_array().cpu().numpy(),
                                          want):
                        fail(f"3m (d) {what}: a sum differs, rank {r}")
                    d.device_array().zero_()

        before = counts()
        run_ranks(g, batch, "3m (d) warm window")
        moved_since(before, "(d) warm window", {"sequencer": 1})
        exact("warm window")
        brk = ring.breaker_for(cid)
        brk.record_failure("TimeoutError")
        brk.record_failure("TimeoutError")
        if brk.allow() != "open":
            fail("3m (d): two strikes left the breaker closed")
        check_circuit_opens("3m (d) before the open breaker", 0)
        refused = {}

        def refused_batch(x, r):
            with x.batch():
                qs = [x.allreduce(send[r], d, run_async=True)
                      for d in outs[r]]
            refused[r] = []
            for q in qs:
                if not q.wait(2.0):
                    raise RuntimeError("a refused window still waits")
                try:
                    q.check()
                    refused[r].append((int(EC.OK), None))
                except at.ACCLError as e:
                    refused[r].append((int(e.code), e.details.get("error")))

        before = counts()
        t = time.perf_counter()
        run_ranks(g, refused_batch, "3m (d) open breaker, xla")
        refuse_s = time.perf_counter() - t
        moved_since(before, "(d) open breaker, xla", {})
        if refused != {r: [(int(EC.INVALID_OPERATION), "circuit_open")] * 8
                       for r in range(P_MAIN)} or refuse_s >= 2.0:
            fail(f"3m (d): the open breaker under xla gave {refused} in "
                 f"{refuse_s:.3f} s")
        check_circuit_opens("3m (d) open breaker, xla", 1)
        for x in g:
            x.set_tuning("allreduce_algorithm", "pallas_ring")
        before = counts()
        run_ranks(g, batch, "3m (d) open breaker, pallas_ring")
        moved_since(before, "(d) open breaker, pallas_ring",
                    {"ring_allreduce": 8})
        check_circuit_opens("3m (d) open breaker, pallas_ring", 2)
        exact("open breaker, pallas_ring")
        for x in g:
            x.set_tuning("allreduce_algorithm", "xla")
        time.sleep(FAULT_COOLDOWN_S + 0.05)
        before = counts()
        run_ranks(g, batch, "3m (d) probe window")
        moved_since(before, "(d) probe window", {"sequencer": 1})
        if ring.stats()["breakers"][str(cid)]["state"] != "closed":
            fail(f"3m (d): the probe left {ring.stats()['breakers']}")
        exact("probe window")

        def check_poisoned(what, reqs, t, form):
            """Slot 0 of the poisoned window fails, the rest pass, within
            2 s; row 14's device status words read BAD_OP (2) for slot 0
            and OK (1) for the others."""
            for r in range(P_MAIN):
                for k, q in enumerate(reqs[r]):
                    if not q.wait(2.0):
                        fail(f"3m (d) {what}: slot {k} still waits")
                    code = q.get_retcode()
                    if code != (EC.INVALID_OPERATION if k == 0 else EC.OK):
                        fail(f"3m (d) {what}: rank {r} slot {k} {code}")
            took = time.perf_counter() - t
            st = ring.last_status(cid)
            if st is None or st[:, 1].tolist() != [2] + [1] * 7:
                fail(f"3m (d) {what}: device status {st}")
            if took >= 2.0 or ring.window_log()[-1]["form"] != form:
                fail(f"3m (d) {what}: {took:.3f} s, form "
                     f"{ring.window_log()[-1]['form']}")
            return took

        def corrupt_nth(nth):
            tcontract.install_fault_plan(FaultPlan([FaultRule(
                action="corrupt", msg_type="RING", nth=nth, count=1)],
                seed=11))

        chaos = {}
        reqs = {}
        corrupt_nth(1)
        before = counts()
        t = time.perf_counter()
        try:
            run_ranks(g, lambda x, r: batch(x, r, reqs),
                      "3m (d) poisoned inline window")
        finally:
            tcontract.install_fault_plan(None)
        chaos["inline_s"] = check_poisoned("poisoned inline window", reqs,
                                           t, "inline")
        moved_since(before, "(d) poisoned inline window", {"sequencer": 1})

        # a live card run: of a stream of 3 windows held behind a sleep
        # kernel (the host runs ahead of the device), the first runs
        # inline, the second arms the run and the third, poisoned, is a
        # mailbox post into it
        def stream(x, r):
            qs = []
            x.begin_batch()
            try:
                for _ in range(3):
                    qs.append([x.allreduce(send[r], d, run_async=True)
                               for d in outs[r]])
                    x._dispatch_pending()
                reqs[r] = qs[2]
            finally:
                x.end_batch()
            for q in qs[0] + qs[1]:
                q.wait(60)
                q.check()

        ring.lowering = "xla"
        saved_linger = ring.linger_s
        ring.linger_s = 2.0
        try:
            corrupt_nth(3)
            before = counts()
            hold_stream(TELEM_SLEEP)
            t = time.perf_counter()
            try:
                run_ranks(g, stream, "3m (d) stream")
            finally:
                tcontract.install_fault_plan(None)
            chaos["run_s"] = check_poisoned("poisoned run window", reqs, t,
                                            "mailbox")
            moved_since(before, "(d) stream",
                        {"sequencer": 1, "sequencer_run": 1})
        finally:
            ring.linger_s = saved_linger
            ring.lowering = "pallas"
        chaos["faults"] = ring.stats()["chaos_faults"]
        if chaos["faults"] != {"corrupt": 2}:
            fail(f"3m (d): chaos counts {chaos['faults']}")
        run_ranks(g, lambda x, r: x.soft_reset(), "3m (d) soft_reset")
        before = counts()
        run_ranks(g, batch, "3m (d) recovered window")
        moved_since(before, "(d) recovered window", {"sequencer": 1})
        exact("recovered window")
        check_circuit_opens("3m (d)", 2)
        out["ring"] = {"cooldown_s": FAULT_COOLDOWN_S, "refuse_s": refuse_s,
                       "circuit_open": ring.stats()["fallbacks"].get(
                           "circuit_open", 0), **chaos}
    finally:
        for x in g:
            x.deinit()
    return out


def faults_cost(kc) -> dict:
    """Phase 3m (b), the verifier's cost: one ``cuda_group(4)``, warm
    ``pallas_ring`` allreduces at 256 KiB a rank, ``TELEM_ROUNDS`` rounds
    of ``TELEM_CALLS`` synchronous calls with the verifier armed
    (``set_contract_verify(True)``, interval 8) and disarmed in turn
    (alternating which goes first): rank 0's call p50 (host clock) and
    the gang's launch p50 (``Request.get_duration_ns``), each as the
    median of the rounds' p50s with the rounds' range as its spread."""
    import numpy as np

    import accl_tpu_torch as at

    P, n = P_MAIN, FAULT_N
    g = at.cuda_group(P)
    samples = {k: {"call": [], "launch": []} for k in ("on", "off")}
    try:
        for a in g:
            a.set_tuning("allreduce_algorithm", "pallas_ring")
        bufs = [(a.create_buffer_from(np.full(n, r + 1.0, np.float32)),
                 a.create_buffer(n, np.float32)) for r, a in enumerate(g)]
        for _ in range(3):  # cold, prepared, warm
            run_ranks(g, lambda a, r: a.allreduce(*bufs[r]),
                      "3m cost warm-up")
        before = {k: f.launches.count for k, f in kc.KERNELS.items()}

        def one_pass(k):
            call, launch = [], []

            def rank_main(a, r):
                a.set_contract_verify(k == "on")
                for _ in range(TELEM_CALLS):
                    t = time.perf_counter()
                    req = a.allreduce(*bufs[r])
                    if r == 0:
                        call.append(time.perf_counter() - t)
                        launch.append(req.get_duration_ns() * 1e-9)

            run_ranks(g, rank_main, f"3m cost {k}")
            samples[k]["call"].append(float(np.median(call)) * 1e3)
            samples[k]["launch"].append(float(np.median(launch)) * 1e3)

        for i in range(TELEM_ROUNDS):
            for k in (("on", "off") if i % 2 == 0 else ("off", "on")):
                one_pass(k)
        launches = {k: f.launches.count - before[k]
                    for k, f in kc.KERNELS.items()
                    if f.launches.count != before[k]}
        want = 2 * TELEM_ROUNDS * TELEM_CALLS
        if launches != {"ring_allreduce": want}:
            fail(f"3m cost: launched {launches}, want ring_allreduce {want}")
    finally:
        for a in g:
            a.deinit()
    res = {"bytes_per_rank": 4 * n, "rounds": TELEM_ROUNDS,
           "calls_per_round": TELEM_CALLS, "interval": 8}
    for k, s in samples.items():
        res[k] = {f"{m}_p50_ms": float(np.median(v)) for m, v in s.items()}
        res[k].update({f"{m}_p50_range_ms": [min(v), max(v)]
                       for m, v in s.items()})
    res["call_p50_delta_ms"] = res["on"]["call_p50_ms"] - res["off"][
        "call_p50_ms"]
    res["launch_p50_delta_ms"] = res["on"]["launch_p50_ms"] - res["off"][
        "launch_p50_ms"]
    res["launches"] = launches
    res["record_host_us"] = verify_host_us()
    return res


def verify_host_us(iters: int = 2000) -> dict:
    """The verifier's intake on the host, timed alone on this thread
    over ``iters`` calls (host clock, microseconds a call):
    ``ContractVerifier.record`` with no board (a crc32 and a ring
    append) and with a shared board at interval 8 (a post every 8th
    call, one poster)."""
    from accl_tpu_torch.contract import ContractBoard, ContractVerifier

    out = {}
    for name, board in (("no_board", None), ("board", ContractBoard())):
        v = ContractVerifier(rank=0, world=1, interval=8, board=board)
        v.begin_comm(0, 0, (0,))
        t = time.perf_counter()
        for _ in range(iters):
            v.record("allreduce", 0, "FLOAT32", FAULT_N, "0/0", 0)
        out[name] = (time.perf_counter() - t) / iters * 1e6
    return out


# ---------------------------------------------------------------------------
# phase 3n: the in-flight window and the QoS arbiter (ROADMAP A11d)
# ---------------------------------------------------------------------------

#: (a)'s burst: async allreduces of 4 MiB float32 a rank under
#: ``pallas_ring`` at the default depth, each behind a sleep kernel of
#: ``ARB_BUSY`` cycles (~10 ms) standing in for the compute a collective
#: overlaps, so the card runs behind the host and the window fills
ARB_N, ARB_CALLS, ARB_BUSY = 1024 * 1024, 32, 20_000_000
#: the card's lead at the burst's start (~50 ms, after a full collection):
#: call 0 overlapped only if call 1 parks before it ends, and with no more
#: than its own ~10 ms sleep ahead of it a host stall (the rank threads'
#: start, a collection of the script's heap) let it end first; later
#: calls have the 3 sleeps of the calls the window holds ahead of them
ARB_LEAD = 5 * ARB_BUSY
#: (a)'s duration-to-device calls, and the warm call's size and rounds
ARB_SYNC_CALLS = 30
ARB_WARM_N, ARB_ROUNDS = 64 * 1024, 3
#: (b)'s batch and budget; (c)'s tenants: the GUARANTEED 256 KiB calls on
#: the world and the BEST_EFFORT 64 MiB flooder on a sub-communicator
ARB_BATCH, ARB_SLOTS = 6, 2
ARB_SERVE_CALLS, ARB_FLOOD_CALLS, ARB_FLOOD_DEPTH = 60, 48, 8


def _pcts(xs) -> dict:
    import numpy as np

    return {"p50_ms": float(np.percentile(xs, 50)) * 1e3,
            "p99_ms": float(np.percentile(xs, 99)) * 1e3}


def arbiter_main_path(kc) -> dict:
    """Phase 3n: the in-flight window and the QoS arbiter on
    ``cuda_group(4)`` on the card, integer-valued float32 (every sum
    exact, held against numpy's), each step's launches counted:

    (a) the window: ``ARB_CALLS`` async ``pallas_ring`` allreduces of 4 MiB
        a rank at the default depth (4), the card kept behind the host by
        a ~10 ms sleep kernel before each (the ranks meet after each
        post, so a call's own sleep comes right before its launch and
        the sleeps do not all queue ahead; a ~50 ms lead before the
        first): the window never holds more than 4 (a sampler thread
        and ``max_depth_seen``) and reaches 4; every record but the
        burst's last has ``overlap_ns`` (a later
        launch parked while it was in flight; the last has none to
        witness it); then ``ARB_SYNC_CALLS`` synchronous calls: the
        records' ``duration_ns`` p50 beside the calls' device time by
        CUDA events (the same calls posted behind a sleep kernel at a
        depth that holds them all);
    (b) the ring's budgets: a tenant's ``ring_slots = 2``, a batch of 6
        allreduces at 256 KiB rides row 14 in 3 windows of 2 slots (3
        ``sequencer`` launches, ``budgeted_windows`` +3), then the same
        batch with the lowering ``xla`` behind a sleep kernel: one inline
        window, one arming a persistent run, one mailbox post (1
        ``sequencer``, 1 ``sequencer_run``);
    (c) two tenants, the arbiter armed: a GUARANTEED tenant's 256 KiB
        synchronous calls on the world, alone and then beside a
        BEST_EFFORT flooder's 64 MiB async calls (window share 1, up to 8
        posted) on a sub-communicator of the four ranks, each rank
        driving both from two threads; rank 0's call p50 / p99 (host
        clock) alone and with the flooder, both tenants' grant waits;
        fails if an admission is never released (``outstanding`` 0) or
        ``/tenants`` does not serve the arbiter's snapshot;
    (d) no breaker opens (``circuit_open_total`` unchanged).

    Returns the launch counts and the checks' figures."""
    import json
    import urllib.request

    import numpy as np
    import torch

    import accl_tpu_torch as at
    from accl_tpu_torch.backends.cuda.cmdring import circuit_open_total
    from accl_tpu_torch.constants import DEFAULT_INFLIGHT_WINDOW

    P = P_MAIN
    out = {"launches": {k: 0 for k in kc.KERNELS}}
    rng = np.random.default_rng(SEED + 47)
    opens0 = circuit_open_total()

    def counts():
        return {k: f.launches.count for k, f in kc.KERNELS.items()}

    def moved_since(before, what, want):
        moved = {k: f.launches.count - before[k]
                 for k, f in kc.KERNELS.items()
                 if f.launches.count != before[k]}
        if want is not None and moved != want:
            fail(f"3n {what}: launched {moved}, want {want}")
        for k, v in moved.items():
            out["launches"][k] += v
        return moved

    def ints(shape):
        return rng.integers(-8, 8, size=shape).astype(np.float32)

    def exact(bufs, want, what):
        for r, b in enumerate(bufs):
            if not np.array_equal(b.device_array().cpu().numpy(), want):
                fail(f"3n {what}: rank {r}'s result differs from the sum")

    g = at.cuda_group(P)
    window = g[0].engine.gang.window
    ring = g[0].engine.gang.cmdring
    try:
        if window.depth != DEFAULT_INFLIGHT_WINDOW:
            fail(f"3n: the window's depth is {window.depth}")
        # (a) the burst
        for a in g:
            a.set_tuning("allreduce_algorithm", "pallas_ring")
        data = ints((P, ARB_N))
        send = [a.create_buffer_from(data[r]) for r, a in enumerate(g)]
        outs = [[a.create_buffer(ARB_N, np.float32)
                 for _ in range(ARB_CALLS)] for a in g]
        before = counts()
        for _ in range(3):  # cold, prepared, warm
            run_ranks(g, lambda a, r: a.allreduce(send[r], outs[r][0]),
                      "3n (a) warm-up")
        moved_since(before, "(a) warm-up", {"ring_allreduce": 3})
        peak, stop = [0], threading.Event()

        def sample():
            while not stop.is_set():
                peak[0] = max(peak[0], window.in_flight())
                time.sleep(1e-3)

        sampler = threading.Thread(target=sample, name="3n-sampler")
        totals = [a._telemetry.recorder.total for a in g]
        depth0 = window.stats()["max_depth_seen"]

        step = threading.Barrier(P)

        def burst(a, r):
            reqs = []
            for k in range(ARB_CALLS):
                if r == 0:  # the compute the collectives overlap
                    torch.cuda._sleep(ARB_BUSY)
                reqs.append(a.allreduce(send[r], outs[r][k],
                                        run_async=True))
                # call k launched (its last poster ran it) before rank 0
                # puts the next sleep on the stream: each call's own sleep
                # comes right before it
                step.wait(120)
            for q in reqs:
                if not q.wait(120):
                    raise RuntimeError("a burst call never completed")
                q.check()

        before = counts()
        hold_stream(ARB_LEAD)
        sampler.start()
        try:
            run_ranks(g, burst, "3n (a) burst")
        finally:
            stop.set()
            sampler.join(10)
        moved_since(before, "(a) burst", {"ring_allreduce": ARB_CALLS})
        st = window.stats()
        if peak[0] > 4 or st["max_depth_seen"] != 4 or depth0 > 1:
            fail(f"3n (a): in flight peaked at {peak[0]}, max_depth_seen "
                 f"{st['max_depth_seen']} (warm-up {depth0}), want 4")
        overlapped = []
        for r, a in enumerate(g):
            recs = telem_records(a, totals[r])
            if len(recs) != ARB_CALLS:
                fail(f"3n (a) rank {r}: {len(recs)} records")
            flags = [rec.overlap_ns is not None for rec in recs]
            if flags != [True] * (ARB_CALLS - 1) + [False]:
                fail(f"3n (a) rank {r}: overlap_ns set on {flags}")
            if max(rec.inflight_depth for rec in recs) != 4:
                fail(f"3n (a) rank {r}: depths "
                     f"{[rec.inflight_depth for rec in recs]}")
            overlapped += [rec.overlap_ns * 1e-6 for rec in recs[:-1]
                           if rec.overlap_ns is not None]
        for k in range(ARB_CALLS):
            exact([outs[r][k] for r in range(P)], data.sum(0),
                  f"(a) burst call {k}")
        out["window"] = {
            "calls": ARB_CALLS, "bytes_per_rank": 4 * ARB_N,
            "peak_in_flight": peak[0], "max_depth_seen":
            st["max_depth_seen"], "overlap_ms_p50":
            float(np.median(overlapped)), "overlap_ns_total":
            st["overlap_ns_total"], "launched": st["launched"],
            "completed": st["completed"]}

        # (a) the records' duration against the calls' device time
        totals = [a._telemetry.recorder.total for a in g]
        before = counts()
        run_ranks(g, lambda a, r: [a.allreduce(send[r], outs[r][1])
                                   for _ in range(ARB_SYNC_CALLS)],
                  "3n (a) sync calls")
        durations = [rec.duration_ns * 1e-6
                     for rec in telem_records(g[0], totals[0])]
        for a in g:
            a.set_inflight_window(ARB_SYNC_CALLS + 2)
        gate = threading.Barrier(P)
        ev = {}

        def device_pass(a, r):
            if r == 0:
                hold_stream(TELEM_SLEEP)
                ev["start"] = torch.cuda.Event(enable_timing=True)
                ev["start"].record()
            gate.wait(60)
            reqs = [a.allreduce(send[r], outs[r][1], run_async=True)
                    for _ in range(ARB_SYNC_CALLS)]
            gate.wait(60)  # every launch is on the stream
            if r == 0:
                ev["end"] = torch.cuda.Event(enable_timing=True)
                ev["end"].record()
            for q in reqs:
                q.wait(120)
                q.check()

        run_ranks(g, device_pass, "3n (a) device pass")
        ev["end"].synchronize()
        device_ms = ev["start"].elapsed_time(ev["end"]) / ARB_SYNC_CALLS
        for a in g:
            a.set_inflight_window(DEFAULT_INFLIGHT_WINDOW)
        moved_since(before, "(a) duration", {
            "ring_allreduce": 2 * ARB_SYNC_CALLS})
        exact([outs[r][1] for r in range(P)], data.sum(0), "(a) sync")
        dur_p50 = float(np.median(durations))
        out["duration"] = {"record_duration_p50_ms": dur_p50,
                           "device_ms_per_call": device_ms,
                           "ratio": dur_p50 / device_ms}
        print(f"3n (a): window peak {peak[0]}, every record but the last "
              f"overlapped (p50 {out['window']['overlap_ms_p50']:.3f} ms); "
              f"records' duration p50 {dur_p50:.4f} ms against "
              f"{device_ms:.4f} ms of device time a call "
              f"({dur_p50 / device_ms:.2f}x)", flush=True)

        # (b) the ring's slot budgets
        for a in g:
            a.set_tuning("allreduce_algorithm", "xla")
        run_ranks(g, lambda a, r: a.set_tenant_class("best_effort",
                                                     name="batch"),
                  "3n (b) register")
        run_ranks(g, lambda a, r: a.set_tenant_quota(ring_slots=ARB_SLOTS),
                  "3n (b) budget")
        if ring.slot_budget_of(g[0].comm.id) != ARB_SLOTS:
            fail(f"3n (b): budget {ring.slot_budget_of(g[0].comm.id)}")
        nb = ARB_WARM_N
        bdata = ints((P, nb))
        bsend = [a.create_buffer_from(bdata[r]) for r, a in enumerate(g)]
        bouts = [[a.create_buffer(nb, np.float32) for _ in range(ARB_BATCH)]
                 for a in g]

        def batch(a, r):
            with a.batch():
                qs = [a.allreduce(bsend[r], d, run_async=True)
                      for d in bouts[r]]
            for q in qs:
                if not q.wait(120) or not q.ring_resident:
                    raise RuntimeError(f"{q.op_name} off the ring")
                q.check()

        def budgeted(what, want, lowering):
            for r in range(P):
                for d in bouts[r]:
                    d.tensor.zero_()
            st0 = ring.stats()
            before = counts()
            if lowering == "xla":
                hold_stream(TELEM_SLEEP)
            run_ranks(g, batch, f"3n (b) {what}")
            moved_since(before, f"(b) {what}", want)
            st1 = ring.stats()
            sizes = [len(w["slots"]) for w in ring.window_log()[-3:]]
            res = {k: st1[k] - st0[k] for k in (
                "refills", "dispatches", "mailbox_posts",
                "budgeted_windows")}
            res["window_slots"] = sizes
            res["comm_slots"] = (st1["comm_slots"][str(g[0].comm.id)]
                                 - st0["comm_slots"].get(
                                     str(g[0].comm.id), 0))
            if (res["budgeted_windows"] < 2 or res["refills"] != 3
                    or max(sizes) > ARB_SLOTS
                    or res["comm_slots"] != ARB_BATCH):
                fail(f"3n (b) {what}: {res}")
            for k in range(ARB_BATCH):
                exact([bouts[r][k] for r in range(P)], bdata.sum(0),
                      f"(b) {what} slot {k}")
            return res

        out["ring"] = {"inline": budgeted("inline", {"sequencer": 3},
                                          "pallas")}
        ring.lowering = "xla"
        saved = ring.linger_s
        ring.linger_s = 0.5
        try:
            out["ring"]["run"] = budgeted(
                "persistent run", {"sequencer": 1, "sequencer_run": 1},
                "xla")
        finally:
            ring.linger_s = saved
            ring.lowering = "pallas"
            ring.halt_sessions()
        if out["ring"]["run"]["mailbox_posts"] != 1:
            fail(f"3n (b) persistent run: {out['ring']['run']}")
        print(f"3n (b): budget {ARB_SLOTS}, windows {out['ring']}",
              flush=True)
    finally:
        for a in g:
            a.deinit()

    # (c) two tenants
    g = at.cuda_group(P)
    try:
        for a in g:
            a.set_tuning("allreduce_algorithm", "pallas_ring")
        subs = {}

        def split(a, r):
            subs[r] = a.create_communicator(list(range(P)))

        run_ranks(g, split, "3n (c) sub-communicator")
        for a in g:
            a.set_arbiter(True)

        def register(a, r):
            a.set_tenant_class("guaranteed", name="serve")
            a.set_tenant_class("best_effort", comm=subs[r], name="bulk")
            a.set_tenant_quota(comm=subs[r], window_share=1)

        run_ranks(g, register, "3n (c) register")
        sdata, fdata = ints((P, ARB_WARM_N)), ints((P, N_RANK))
        ss = [a.create_buffer_from(sdata[r]) for r, a in enumerate(g)]
        sr = [a.create_buffer(ARB_WARM_N, np.float32) for a in g]
        fs = [a.create_buffer_from(fdata[r]) for r, a in enumerate(g)]
        fr = [a.create_buffer(N_RANK, np.float32) for a in g]

        def warm(a, r):
            for _ in range(3):
                a.allreduce(ss[r], sr[r])
                a.allreduce(fs[r], fr[r], comm=subs[r])

        before = counts()
        run_ranks(g, warm, "3n (c) warm-up")
        times = {"alone": [], "flooded": []}

        def serve(a, r, key):
            for _ in range(ARB_SERVE_CALLS):
                t = time.perf_counter()
                a.allreduce(ss[r], sr[r])
                if r == 0:
                    times[key].append(time.perf_counter() - t)

        run_ranks(g, lambda a, r: serve(a, r, "alone"), "3n (c) alone")

        def flood(a, r):
            reqs = []
            for _ in range(ARB_FLOOD_CALLS):
                reqs.append(a.allreduce(fs[r], fr[r], comm=subs[r],
                                        run_async=True))
                if len(reqs) > ARB_FLOOD_DEPTH:
                    q = reqs.pop(0)
                    if not q.wait(120):
                        raise RuntimeError("a flood call never completed")
                    q.check()
            for q in reqs:
                if not q.wait(120):
                    raise RuntimeError("a flood call never completed")
                q.check()

        def drive(a, r):
            errs = []

            def flooder():
                try:
                    flood(a, r)
                except BaseException as e:  # reported below
                    errs.append(e)

            f = threading.Thread(target=flooder, name=f"3n-flood-{r}")
            f.start()
            time.sleep(0.02)  # the flood first
            serve(a, r, "flooded")
            f.join(300)
            if errs or f.is_alive():
                raise RuntimeError(f"flooder: {errs or 'hung'}")

        run_ranks(g, drive, "3n (c) two tenants")
        for a in g:
            a.flush()
        want_k1 = (2 * 3 + 2 * ARB_SERVE_CALLS + ARB_FLOOD_CALLS)
        moved_since(before, "(c) two tenants", {"ring_allreduce": want_k1})
        exact(sr, sdata.sum(0), "(c) serve")
        exact(fr, fdata.sum(0), "(c) flood")
        snap = g[0]._arbiter.snapshot()
        serve_t = snap["tenants"][str(g[0].comm.id)]
        bulk_t = snap["tenants"][str(subs[0].id)]
        for name, t in (("serve", serve_t), ("bulk", bulk_t)):
            if t["outstanding"] != 0 or t["admitted"] != t["completed"]:
                fail(f"3n (c) {name}: an admission never released: {t}")
        if bulk_t["admitted"] != P * (3 + ARB_FLOOD_CALLS):
            fail(f"3n (c): the flooder admitted {bulk_t['admitted']}")
        port = g[0].start_monitor(0)
        try:
            doc = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/tenants", timeout=10).read())
        finally:
            g[0].stop_monitor()
        if doc != json.loads(json.dumps(g[0]._arbiter.snapshot(),
                                        default=str)):
            fail("3n (c): /tenants does not serve the arbiter's snapshot")

        def waits(t):
            return t["grant_wait_ns_total"] / max(t["admitted"], 1) * 1e-6

        out["tenants"] = {
            "serve_bytes_per_rank": 4 * ARB_WARM_N,
            "flood_bytes_per_rank": 4 * N_RANK,
            "serve_alone": _pcts(times["alone"]),
            "serve_flooded": _pcts(times["flooded"]),
            "serve_grant_wait_ms_mean": waits(serve_t),
            "flood_grant_wait_ms_mean": waits(bulk_t),
            "flood_queued_peak": bulk_t["queued_peak"],
            "serve_p99_us_hist": serve_t["latency"]["p99_us"],
            "flood_p99_us_hist": bulk_t["latency"]["p99_us"],
            "over_admissions": [serve_t["over_admissions"],
                                bulk_t["over_admissions"]],
            "rounds": snap["rounds"], "grant_timeouts":
            snap["grant_timeouts"]}
        print(f"3n (c): {json.dumps(out['tenants'])}", flush=True)
    finally:
        for a in g:
            a.deinit()
    # (d) no breaker opened here
    out["circuit_open"] = circuit_open_total() - opens0
    if out["circuit_open"]:
        fail(f"3n: {out['circuit_open']} batches refused by an open breaker")
    return out


def arbiter_cost(kc) -> dict:
    """Phase 3n's cost figures: the warm 256 KiB ``pallas_ring`` call on
    ``cuda_group(4)``, ``ARB_ROUNDS`` rounds of ``TELEM_CALLS``
    synchronous calls at window depth 1 and at the default depth in turn
    (alternating which goes first): rank 0's call p50 / p90 (host clock)
    and the gang's p50 / p90 (``Request.get_duration_ns``, the gang's
    start to the window's completion).  The window's cost against no
    window is a two-tree comparison (``scripts/window_cost.py``)."""
    import numpy as np

    import accl_tpu_torch as at
    from accl_tpu_torch.constants import DEFAULT_INFLIGHT_WINDOW

    P, n = P_MAIN, ARB_WARM_N
    g = at.cuda_group(P)
    samples = {d: {"call": [], "gang": []}
               for d in (1, DEFAULT_INFLIGHT_WINDOW)}
    try:
        for a in g:
            a.set_tuning("allreduce_algorithm", "pallas_ring")
            a.set_tuning("ring_segments", 4)
        bufs = [(a.create_buffer_from(np.full(n, r + 1.0, np.float32)),
                 a.create_buffer(n, np.float32)) for r, a in enumerate(g)]
        for _ in range(3):
            run_ranks(g, lambda a, r: a.allreduce(*bufs[r]), "3n warm-up")

        def rounds(depth):
            for a in g:
                a.set_inflight_window(depth)

            def rank_main(a, r):
                for _ in range(TELEM_CALLS):
                    t = time.perf_counter()
                    req = a.allreduce(*bufs[r])
                    if r == 0:
                        samples[depth]["call"].append(
                            time.perf_counter() - t)
                        samples[depth]["gang"].append(
                            req.get_duration_ns() * 1e-9)

            run_ranks(g, rank_main, f"3n depth {depth}")

        for i in range(ARB_ROUNDS):
            order = ((1, DEFAULT_INFLIGHT_WINDOW) if i % 2 == 0
                     else (DEFAULT_INFLIGHT_WINDOW, 1))
            for d in order:
                rounds(d)
    finally:
        for a in g:
            a.deinit()

    def pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3

    return {"bytes_per_rank": 4 * n, "rounds": ARB_ROUNDS,
            "calls_per_round": TELEM_CALLS,
            **{f"depth_{d}": {"call_p50_ms": pct(s["call"], 50),
                              "call_p90_ms": pct(s["call"], 90),
                              "gang_p50_ms": pct(s["gang"], 50),
                              "gang_p90_ms": pct(s["gang"], 90)}
               for d, s in samples.items()}}


def topology_latency(iters: int = 15) -> dict:
    """``facade_topology``: host-clock p50 / p90 of one synchronous call on
    rank 0's thread (as ``facade_latency``), every algorithm register at
    ``pallas_ring``: the flat and the hierarchical allreduce, allgather,
    reduce_scatter and bcast on the 2 x 4 group at 4 and 64 MiB a rank
    (allgather's result, reduce_scatter's operand), and on the 4-rank
    group the pipelined allreduce (4 segments, 16 MiB threshold) against
    the unsplit one at 64 MiB."""
    import numpy as np

    import accl_tpu_torch as at
    from accl_tpu_torch.topology import Topology

    rows = []
    sizes = (1024 * 1024, N_RANK)

    def timed(group, label, call, setup):
        samples = {}

        def rank_main(a, r):
            bufs = setup(a, r)
            for i in range(2 + iters):
                t = time.perf_counter()
                call(a, bufs)
                if i >= 2 and r == 0:
                    samples.setdefault("t", []).append(
                        time.perf_counter() - t)

        run_ranks(group, rank_main, f"facade_topology {label}")
        ts = samples["t"]
        return {"p50_ms": float(np.median(ts)) * 1e3,
                "p90_ms": float(np.percentile(ts, 90)) * 1e3}

    W = TOPO_WORLD
    g8 = at.cuda_group(W, topology=Topology.from_slice_size(W, TOPO_SLICE))
    try:
        topo_registers(g8)
        for n in sizes:
            seg = n // W
            ops = {
                "allreduce": (lambda a, r, n=n: (
                    a.create_buffer(n, np.float32),
                    a.create_buffer(n, np.float32)),
                    lambda a, b, n=n: a.allreduce(b[0], b[1], n)),
                "allgather": (lambda a, r, seg=seg: (
                    a.create_buffer(seg, np.float32),
                    a.create_buffer(seg * W, np.float32)),
                    lambda a, b, seg=seg: a.allgather(b[0], b[1], seg)),
                "reduce_scatter": (lambda a, r, seg=seg: (
                    a.create_buffer(seg * W, np.float32),
                    a.create_buffer(seg, np.float32)),
                    lambda a, b, seg=seg: a.reduce_scatter(b[0], b[1], seg)),
                "bcast": (lambda a, r, n=n: (a.create_buffer(n, np.float32),),
                          lambda a, b, n=n: a.bcast(b[0], n, root=0)),
            }
            for op, (setup, call) in ops.items():
                row = {"op": op, "bytes_per_rank": 4 * n}
                for hier in (0, 1):
                    for a in g8:
                        a.set_tuning("hierarchical", hier)
                    row["hier" if hier else "flat"] = timed(
                        g8, f"{op} {n} {hier}", call, setup)
                row["hier_over_flat_p50"] = (row["hier"]["p50_ms"]
                                             / row["flat"]["p50_ms"])
                rows.append(row)
    finally:
        for a in g8:
            a.deinit()
    g4 = at.cuda_group(P_MAIN)
    pipelined = {}
    try:
        topo_registers(g4, ring_segments=4)
        for label, threshold in (("unsplit", 0),
                                 ("pipelined", PIPE_THRESHOLD)):
            for a in g4:
                a.set_tuning("pipeline_threshold", threshold)
            pipelined[label] = timed(
                g4, f"allreduce {label}",
                lambda a, b: a.allreduce(b[0], b[1], N_RANK),
                lambda a, r: (a.create_buffer(N_RANK, np.float32),
                              a.create_buffer(N_RANK, np.float32)))
    finally:
        for a in g4:
            a.deinit()
    return {"layout": f"2x{TOPO_SLICE}", "world": W, "rows": rows,
            "pipelined_allreduce_4_ranks_64mib": pipelined}


# -- phase 3o: MoE, the encoder and ZeRO-1 Adam (ROADMAP A9d) ---------------

#: the expert configuration of every MoE leg: Mixtral 8x7B's expert count
#: and routing (8 experts, top 2), JAX's default capacity factor 1.5
MOE = dict(n_experts=8, moe_top_k=2)
#: leg 1: bench.py's serving model with experts, its position table 8
#: rows longer so run B's 1024-token prompt decodes 8 steps
MOE_LONG_STEPS = 8
MOE_SERVE = dict(SERVE, max_seq=SERVE_LONG + MOE_LONG_STEPS, **MOE)
#: leg 2: bench.py's training model with experts (about 7.0 B parameters)
MOE_TRAIN = dict(TRAIN, **MOE)
#: every leg's mesh: dp 4 x tp 1 virtual ranks (experts on dp), and leg
#: 2's one step on a dedicated expert axis
MODEL_MESH, EP_MESH = (4, 1), (2, 2, 1)
MODEL_STEPS = 3
#: leg 3: the MLM mask's rate (BERT's 15 %)
MLM_RATE = 0.15
#: leg 4: ZeRO-1 Adam (peak lr 1e-3 after a 2-step warmup, clipped at
#: 1.0, float32 master weights); its MoE model cut to 2 layers so that
#: its moments and master copy (12 bytes a parameter) fit in 80 GB
ZERO_ADAM = dict(lr=1e-3, warmup_steps=2, clip_grad_norm=1.0,
                 master_weights=True)
ZERO_MOE_LAYERS = 2
#: a ZeRO step's master weights against the plain Adam step on whole
#: tensors from a second backward pass: the two passes' gradients may
#: part in the last bits (the embedding's backward adds rows with
#: atomics), and Adam's first step g / (|g| + eps) turns that into the
#: odd element's sign, so the difference is held within 1e-2 of the
#: update's norm per tensor (relative Frobenius); the losses within 1e-6
ZERO_UPDATE_RTOL, ZERO_LOSS_RTOL = 1e-2, 1e-6
#: the profiled MoE step's device time by op (the self device time of the
#: innermost op that launched each kernel)
MOE_OP_CLASSES = (
    ("expert_gemm", ("aten::bmm",)),
    ("dense_gemm", ("aten::mm", "aten::addmm")),
    ("routing_dispatch", ("aten::sort", "aten::cumsum", "aten::one_hot",
                          "aten::index_put_", "aten::_index_put_impl_",
                          "aten::index", "aten::gather", "aten::scatter",
                          "aten::scatter_add_", "aten::index_select",
                          "aten::repeat_interleave", "aten::index_add_")),
)
#: and the flash kernels' share: their device time by kernel name (they
#: launch through ctypes inside the ``_Flash`` autograd Function)
MOE_FLASH_KEY = "flash"


def param_count(params) -> int:
    from accl_tpu_torch.models.transformer import _tree_leaves

    return sum(p.numel() for p in _tree_leaves(params))


def reckon(what: str, **parts) -> dict:
    """A leg's memory reckoned from its shapes before it runs, GB by part
    and in all; printed beside the peak the leg then measures."""
    gb = {k: v / 1e9 for k, v in parts.items()}
    gb["total"] = sum(gb.values())
    print(f"{what}: reckoned {gb['total']:.2f} GB ("
          + ", ".join(f"{k} {v:.2f}" for k, v in gb.items()
                      if k != "total") + ")", flush=True)
    return gb


def leg_peak(what: str, reckoned: dict) -> float:
    import torch

    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{what}: peak {peak:.2f} GB against {reckoned['total']:.2f} GB "
          f"reckoned (80 GB on the card)", flush=True)
    if not peak < 80.0:
        fail(f"{what}: peak memory {peak} GB")
    return peak


def falling(what: str, losses) -> None:
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"{what}: losses {losses} not finite and falling")


def steps_launched(kc, what: str, per_step, n_layers: int,
                   full: bool = False) -> None:
    """Each step launched each of ``TRAIN_KERNELS`` once a layer and no
    other kernel (rows 16-18 non-causal under ``full``)."""
    want = {k: (n_layers if k in TRAIN_KERNELS else 0) for k in kc.KERNELS}
    for i, (got, fl) in enumerate(per_step):
        if got != want:
            fail(f"{what} step {i}: launches {got}, want {want}")
        if fl != (dict.fromkeys(FULL_KERNELS, n_layers if full else 0)):
            fail(f"{what} step {i}: non-causal launches {fl}")


#: rows 16-18: their launches with causal=False are counted apart
FULL_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")


def read_full(kc) -> dict:
    return {k: kc.KERNELS[k].full_launches.count for k in FULL_KERNELS}


def reset_full(kc) -> None:
    for k in FULL_KERNELS:
        kc.KERNELS[k].full_launches.reset()


def timed_steps(kc, step, args, n: int):
    """``n`` calls of ``step(*args)`` (each returning its loss last, and
    its new first arguments first), each synchronised, with the launches
    of each; returns (losses, seconds, per-step launches, args)."""
    import torch

    losses, secs, per_step = [], [], []
    for _ in range(n):
        before, full = read_launches(kc), read_full(kc)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(*args)
        loss = float(out[-1])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss)
        per_step.append(({k: c - before[k]
                          for k, c in read_launches(kc).items()},
                         {k: c - full[k] for k, c in read_full(kc).items()}))
        args = (*out[:-1], *args[len(out) - 1:])
    return losses, secs, per_step, args


def step_record(secs, tokens: int, peak: float, reckoned: dict,
                per_step, losses) -> dict:
    """A leg's phase 5 record: step ms (each step, and the mean of the
    steps after the first), tokens/s over that mean, peak and reckoned
    memory, launches by kernel a step, the losses."""
    import numpy as np

    warm = secs[1:] or secs
    mean = float(np.mean(warm))
    return {"step_ms": [s * 1e3 for s in secs], "warm_step_ms": mean * 1e3,
            "tokens_per_s": tokens / mean, "peak_memory_gb": peak,
            "reckoned_memory_gb": reckoned,
            "launches_per_step": {k: v for k, v in per_step[0][0].items()
                                  if v},
            "full_launches_per_step": per_step[0][1], "losses": losses}


def moe_profile(step, args) -> dict:
    """One MoE train step under ``torch.profiler``: device time by
    ``MOE_OP_CLASSES``, the flash kernels as "attention" (the rest
    "other": layer norms, softmax, gelu, copies such as the all-to-all's
    transposes, the loss, SGD), the
    device's busy time against the step's wall time, and the idle
    share.  None where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_class = {name: 0.0 for name, _ in MOE_OP_CLASSES}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue
        ms = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        for name, keys in MOE_OP_CLASSES:
            if e.key in keys:
                by_class[name] += ms
                break
    by_class["attention"] = sum(
        e.time_range.elapsed_us() for e in kernels
        if MOE_FLASH_KEY in e.name.lower()) / 1e3
    if not busy:
        return {"wall_ms": wall_ms, "device_ms_by_class": None,
                "device_busy_ms": None, "idle_share": None}
    by_class["other"] = busy - sum(by_class.values())
    return {"wall_ms": wall_ms, "device_ms_by_class": by_class,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms}


def moe_serve_leg(kc, mesh) -> dict:
    """Leg 1: bench.py's serving model with 8 experts, top 2 (about 2.4 B
    parameters, bfloat16, random weights from the seed), through
    ``make_sharded_generate`` on (dp 4, tp 1), each rank's experts
    routing its own 2 rows.  Run A: 128 steps from an (8, 128) prompt
    under ``attention="flash"``; run B: 8 steps from an (8, 1024) prompt
    under ``"auto"``.  Each launches row 16 once a layer (the prefill)
    and no other kernel.  Check: float32, 2 layers, the no-drop capacity
    8: 16 greedy steps from an (8, 32) prompt equal re-running the
    sharded forward under ``"naive"`` each step, tie-aware."""
    import dataclasses

    import torch

    from accl_tpu_torch.models import (TransformerConfig, init_params,
                                       make_sharded_forward,
                                       make_sharded_generate)
    from accl_tpu_torch.models.transformer import _tree_map

    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash",
                            **MOE_SERVE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 60)
    torch.cuda.reset_peak_memory_stats()
    fn_a, shard = make_sharded_generate(cfg, mesh, SERVE_STEPS)
    params = init_params(cfg, gen)
    n = param_count(params)
    hd = cfg.d_model // cfg.n_heads
    rk = reckon("moe_serve", weights=2 * n, kv_cache_run_b=(
        2 * cfg.n_layers * SERVE_B * cfg.n_heads * (SERVE_LONG
                                                    + MOE_LONG_STEPS)
        * hd * 2), logits=4 * SERVE_B * cfg.vocab * 2)
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_T), generator=gen,
                           device=dev, dtype=torch.int32)
    long = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_LONG), generator=gen,
                         device=dev, dtype=torch.int32)
    out = {"params": n}
    auto = dataclasses.replace(cfg, attention="auto")
    fn_b, _ = make_sharded_generate(auto, mesh, MOE_LONG_STEPS)
    launches = {k: 0 for k in kc.KERNELS}
    for run, fn, p, steps in (("run_a", fn_a, prompt, SERVE_STEPS),
                              ("run_b", fn_b, long, MOE_LONG_STEPS)):
        reset_launches(kc)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tokens = fn(params, p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = read_launches(kc)
        flash_launched_alone(got, cfg.n_layers, f"moe_serve {run}")
        all_wgmma(kc, f"moe_serve {run}")
        launches = {k: launches[k] + got[k] for k in launches}
        if tokens.shape != (SERVE_B, steps) or tokens.dtype != torch.int32 \
                or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab:
            fail(f"moe_serve {run}: tokens {tokens.dtype}"
                 f"{tuple(tokens.shape)}")
        out[run] = {"prompt": p.shape[1], "steps": steps, "wall_s": wall,
                    "ms_per_step": wall * 1e3 / steps,
                    "tokens_per_s": SERVE_B * steps / wall}
    # run A again, warm: its tokens/s is the leg's figure
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn_a(params, prompt)
    torch.cuda.synchronize()
    out["run_a"]["warm_wall_s"] = time.perf_counter() - t
    out["run_a"]["warm_tokens_per_s"] = (SERVE_B * SERVE_STEPS
                                         / out["run_a"]["warm_wall_s"])
    out["peak_memory_gb"] = leg_peak("moe_serve", rk)
    out["reckoned_memory_gb"] = rk

    # float32, 2 layers, no drops: KV-cache decode == re-running the
    # sharded forward, tie-aware
    c32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=2,
                              moe_capacity_factor=float(cfg.n_experts))
    p32 = _tree_map(lambda p: p.float(),
                    dict(params, layers=params["layers"][:2]))
    del params
    short, steps = prompt[:, :32], 16
    got = make_sharded_generate(c32, mesh, steps)[0](p32, short)
    fwd, _ = make_sharded_forward(dataclasses.replace(c32,
                                                      attention="naive"),
                                  mesh)
    seq, ties = short, 0
    with torch.no_grad():
        want = []
        for _ in range(steps):
            logits = fwd(p32, seq)[:, -1]
            nxt = logits.argmax(-1).to(seq.dtype)
            want.append((nxt, logits))
            seq = torch.cat([seq, nxt[:, None]], 1)
    for r in range(SERVE_B):
        for i in range(steps):
            if got[r, i] == want[i][0][r]:
                continue
            top = want[i][1][r].topk(2).values
            gap = float(top[0] - top[1])
            if not gap <= 1e-5:
                fail(f"moe_serve float32 greedy row {r}: step {i} differs, "
                     f"top-2 gap {gap}")
            ties += 1
            break
    print(f"moe_serve: run A {out['run_a']['tokens_per_s']:.1f} tokens/s "
          f"({out['run_a']['warm_tokens_per_s']:.1f} warm), run B "
          f"{out['run_b']['wall_s']:.3f} s; float32 greedy, 2 layers x "
          f"{steps} steps: KV decode == re-run forward on "
          f"{SERVE_B - ties} rows, {ties} part at a tie", flush=True)
    out["greedy_f32_rows_parted_at_a_tie"] = ties
    del p32
    torch.cuda.synchronize()
    return out, launches


def moe_backward_bits(layer) -> None:
    """The MoE layer's backward at leg 2's shapes (4 ranks of 2 x 1024
    tokens, d_model 4096, capacity 1.5, top 2), twice: the same bits."""
    import torch

    from accl_tpu_torch.models import moe_ffn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 61)
    x = torch.randn(4, 2, TRAIN_T, TRAIN["d_model"], generator=gen,
                    device=dev).to(torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [t.detach().requires_grad_() for t in (x, *layer.values())]
        y = moe_ffn(leaves[0], dict(zip(layer, leaves[1:])), ep=4,
                    capacity_factor=1.5, k=2)
        runs.append(torch.autograd.grad(y.float().square().sum(), leaves))
        del y
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail("a repeated MoE backward gave other bits")
    print("moe_train: the MoE layer's backward repeated bit for bit "
          "(x, gate, w1, w2)", flush=True)


def moe_train_leg(kc, mesh) -> dict:
    """Leg 2: bench.py's training model with 8 experts, top 2 (about 7.0 B
    parameters, bfloat16, random weights and an (8, 1024) batch from the
    seed): ``MODEL_STEPS`` SGD steps of ``make_sharded_train_step`` on
    (dp 4, tp 1), experts on dp (2 a rank, capacity 768), each launching
    rows 16-18 (causal) and the delta pass once a layer and no other
    kernel, losses finite and falling; a profiled step (where the time
    goes); one step on ("dp", "ep", "tp") = (2, 2, 1); then the MoE
    layer's backward twice, the same bits."""
    import dataclasses

    import torch

    from accl_tpu_torch.models import (TransformerConfig, init_params,
                                       make_sharded_train_step)
    from accl_tpu_torch.ops.driver import make_mesh

    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="auto",
                            **MOE_TRAIN)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 62)
    torch.cuda.reset_peak_memory_stats()
    step, shard = make_sharded_train_step(cfg, lr=TRAIN_LR, mesh=mesh)
    params = init_params(cfg, gen)
    n = param_count(params)
    cap = int(1.5 * (TRAIN_B // MODEL_MESH[0]) * TRAIN_T * 2 / 8)
    D, F_ = cfg.d_model, cfg.d_ff
    rk = reckon("moe_train", weights=2 * n, gradients=2 * n,
                sgd_scaled_gradients=2 * n,
                expert_activations=cfg.n_layers * 3 * 8 * 4 * cap * F_ * 2,
                other_activations=cfg.n_layers * 12 * TRAIN_B * TRAIN_T * D
                * 2, logits=3 * TRAIN_B * TRAIN_T * cfg.vocab * 4)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_T), generator=gen,
                           device=dev, dtype=torch.int32)
    targets = tokens.roll(-1, dims=1)
    reset_launches(kc)
    reset_full(kc)
    losses, secs, per_step, (params, *_) = timed_steps(
        kc, step, (params, tokens, targets), MODEL_STEPS)
    launches = read_launches(kc)
    all_wgmma(kc, "moe_train steps")
    steps_launched(kc, "moe_train", per_step, cfg.n_layers)
    falling("moe_train", losses)
    rec = step_record(secs, TRAIN_B * TRAIN_T, leg_peak("moe_train", rk), rk,
                      per_step, losses)
    rec.update(params=n, capacity_per_expert=cap)
    print(f"moe_train: {MODEL_STEPS} steps on (dp 4, tp 1), losses "
          f"{losses}, step ms {rec['step_ms']}, "
          f"{rec['tokens_per_s']:.0f} tokens/s", flush=True)
    before = read_launches(kc)
    rec["profiled_step"] = moe_profile(step, (params, tokens, targets))
    launches = {k: launches[k] + c - before[k]
                for k, c in read_launches(kc).items()}
    print(f"moe_train profiled step: {json.dumps(rec['profiled_step'])}",
          flush=True)
    ep_cfg = dataclasses.replace(cfg, moe_mesh_axis="ep")
    ep_step, _ = make_sharded_train_step(
        ep_cfg, lr=TRAIN_LR,
        mesh=make_mesh(EP_MESH, axes=("dp", "ep", "tp")))
    ep_losses, ep_secs, ep_per, (params, *_) = timed_steps(
        kc, ep_step, (params, tokens, targets), 1)
    steps_launched(kc, "moe_train ep", ep_per, cfg.n_layers)
    launches = {k: launches[k] + ep_per[0][0][k] for k in launches}
    if not math.isfinite(ep_losses[0]) or not ep_losses[0] < losses[0]:
        fail(f"moe_train: the ep step's loss {ep_losses[0]} after {losses}")
    rec["ep_step"] = {"mesh": list(EP_MESH), "loss": ep_losses[0],
                      "step_ms": ep_secs[0] * 1e3}
    print(f"moe_train: one step on (dp 2, ep 2, tp 1): loss {ep_losses[0]}, "
          f"{ep_secs[0] * 1e3:.1f} ms", flush=True)
    moe_backward_bits(params["layers"][0]["moe"])
    del params, step, ep_step
    torch.cuda.synchronize()
    return rec, launches


def check_full_attention(kc, err) -> dict:
    """Leg 3's kernel checks: rows 16 (with LSE), 17 and 18 and the delta
    pass with ``causal=False`` at (8, 32, 1024, 128) bf16 against their
    plain versions, with phase 3e's tolerances (``check_flash``,
    ``check_flash_bwd``), each launching once through its wgmma kernel
    and counted non-causal; then their times (phase 4's, full) beside
    SDPA's non-causal forward and backward."""
    import torch

    from accl_tpu_torch.ops.cuda import attention as ka

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 63)
    B, H, T, D = TRAIN_B, TRAIN["n_heads"], TRAIN_T, 128
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    reset_launches(kc)
    reset_full(kc)
    o, lse = ka.flash_attention(q, k, v, False, with_lse=True)
    delta = ka.flash_attention_bwd_delta(do, o)
    got = (ka.flash_attention_bwd_dq(q, k, v, do, lse, delta, False),
           *ka.flash_attention_bwd_dkv(q, k, v, do, lse, delta, False))
    moved, full = read_launches(kc), read_full(kc)
    if {k_: c for k_, c in moved.items() if c} != dict.fromkeys(
            TRAIN_KERNELS, 1) or full != dict.fromkeys(FULL_KERNELS, 1):
        fail(f"non-causal checks launched {moved}, non-causal {full}")
    all_wgmma(kc, "non-causal checks")
    want_o, want_lse = ka.flash_attention_plain(q, k, v, False,
                                                with_lse=True)
    plain = ka.flash_attention_bwd_delta_plain(do, o)
    want = (ka.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, False),
            *ka.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                              False))
    torch.cuda.synchronize()
    errs = {}
    d = float((lse - want_lse).abs().max())
    e = float((o.float() - want_o.float()).abs().max())
    if not d <= 1e-4 or not torch.isfinite(o).all() or not torch.allclose(
            o.float(), want_o.float(), rtol=1e-2, atol=1e-2):
        fail(f"non-causal flash: lse off by {d}, o max abs err {e}")
    errs["flash_attention"] = e
    mag = (do.float() * o.float()).abs().sum(-1)
    d = float((delta - plain).abs().max())
    if not bool(((delta - plain).abs() <= 1e-5 * mag).all()):
        fail(f"non-causal delta differs from its plain version by {d}")
    errs["flash_attention_bwd_delta"] = d
    for name, g, w in zip(("dq", "dkv", "dkv"), got, want):
        g, w = g.float(), w.float()
        d = float((g - w).abs().max())
        if not torch.isfinite(g).all() or not (
                d <= 1e-2 * float(w.abs().max())
                and float((g - w).norm() / w.norm()) <= 1e-3):
            fail(f"non-causal {name}: max abs err {d}")
        key = f"flash_attention_bwd_{name}"
        errs[key] = max(errs.get(key, 0.0), d)
    for key, e in errs.items():
        err[key] = max(err[key], e)
    print(f"rows 16-18 and the delta pass at ({B}, {H}, {T}, {D}) bf16, "
          f"causal=False: one launch each through the wgmma kernels, "
          f"within tolerance of the plain versions (max abs err "
          f"{errs})", flush=True)
    del q, k, v, do, o, lse, delta, got, want, want_o, want_lse, plain, mag
    torch.cuda.synchronize()
    timing = time_flash_bwd(B, T, plain=True, causal=False)
    for name in ("fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_delta"):
        t = timing[name]
        t.update(bound(t["bytes"], t["ops"], TC16_OPS_PER_S
                       if name != "flash_attention_bwd_delta"
                       else F32_OPS_PER_S))
    print(f"non-causal timing ({B}, {H}, {T}, {D}) bf16: fwd with LSE "
          f"{timing['fwd']['ms']:.4f} ms (device "
          f"{timing['fwd']['device_ms']:.4f}, bound "
          f"{timing['fwd']['bound_ms']:.4f}, SDPA "
          f"{timing['fwd']['library_ms']:.4f}); dq "
          f"{timing['flash_attention_bwd_dq']['ms']:.4f}, dk/dv "
          f"{timing['flash_attention_bwd_dkv']['ms']:.4f}, delta "
          f"{timing['flash_attention_bwd_delta']['ms']:.4f} against SDPA's "
          f"backward {timing['library_bwd_ms']:.4f}", flush=True)
    return timing


def encoder_leg(kc, mesh, err) -> dict:
    """Leg 3: the encoder at bench.py's training widths (1,346M
    parameters, bfloat16, non-causal), ``MODEL_STEPS`` MLM steps of
    ``make_sharded_encoder_step`` on (dp 4, tp 1) over an (8, 1024)
    batch with a seeded 15 % mask (masked positions carry token 0), each
    launching rows 16-18 non-causal and the delta pass once a layer and
    no other kernel, losses finite and falling; before them the kernels'
    non-causal checks and times (:func:`check_full_attention`); after
    them ``mlm_loss`` and its gradients under flash against naive in
    float32 with 2 layers and batch 2 (loss within 1e-5, every gradient
    within 1e-4 relative, phase 3e's bounds)."""
    import dataclasses

    import torch

    from accl_tpu_torch.models import (TransformerConfig, init_params,
                                       make_sharded_encoder_step, mlm_loss)
    from accl_tpu_torch.models.transformer import _tree_leaves, _tree_map

    timing = check_full_attention(kc, err)
    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="auto", **TRAIN)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 64)
    torch.cuda.reset_peak_memory_stats()
    step, shard = make_sharded_encoder_step(cfg, lr=TRAIN_LR, mesh=mesh)
    params = init_params(cfg, gen)
    n = param_count(params)
    rk = reckon("encoder", weights=2 * n, gradients=2 * n,
                sgd_scaled_gradients=2 * n,
                activations=cfg.n_layers * 16 * TRAIN_B * TRAIN_T
                * cfg.d_model * 2,
                logits=3 * TRAIN_B * TRAIN_T * cfg.vocab * 4)
    targets = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_T), generator=gen,
                            device=dev, dtype=torch.int32)
    mask = (torch.rand(TRAIN_B, TRAIN_T, generator=gen, device=dev)
            < MLM_RATE).float()
    tokens = torch.where(mask.bool(), 0, targets).to(torch.int32)
    reset_launches(kc)
    reset_full(kc)
    losses, secs, per_step, (params, *_) = timed_steps(
        kc, step, (params, tokens, targets, mask), MODEL_STEPS)
    launches, full = read_launches(kc), read_full(kc)
    all_wgmma(kc, "encoder steps")
    steps_launched(kc, "encoder", per_step, cfg.n_layers, full=True)
    falling("encoder", losses)
    rec = step_record(secs, TRAIN_B * TRAIN_T, leg_peak("encoder", rk), rk,
                      per_step, losses)
    rec.update(params=n, masked=int(mask.sum()))
    print(f"encoder: {MODEL_STEPS} MLM steps on (dp 4, tp 1), {rec['masked']} "
          f"masked positions, losses {losses}, step ms {rec['step_ms']}, "
          f"non-causal launches {full}", flush=True)

    # float32, 2 layers, batch 2: flash against naive
    c32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=2)
    p32 = _tree_map(lambda p: p.float(),
                    dict(params, layers=params["layers"][:2]))
    del params
    t2, y2, m2 = tokens[:2], targets[:2], mask[:2]
    res = []
    for c in (c32, dataclasses.replace(c32, attention="naive")):
        live = [p.detach().requires_grad_() for p in _tree_leaves(p32)]
        it = iter(live)
        loss = mlm_loss(_tree_map(lambda _: next(it), p32), t2, y2, m2, c)
        res.append((float(loss.detach()), torch.autograd.grad(loss, live)))
    loss_rel, grad_rel, worst = grad_gap(res[0][0], res[0][1], res[1][0],
                                         res[1][1], leaf_names(p32))
    print(f"encoder float32, 2 layers x batch 2: mlm_loss flash vs naive "
          f"{loss_rel} rel, gradients max rel (Frobenius) {grad_rel} "
          f"({worst})", flush=True)
    if not loss_rel <= 1e-5 or not grad_rel <= 1e-4:
        fail(f"encoder float32: flash vs naive loss {loss_rel}, gradients "
             f"{grad_rel}")
    rec.update(f32_flash_vs_naive_loss_rel=loss_rel,
               f32_flash_vs_naive_grad_rel=grad_rel,
               full_launches=full)
    del p32, res
    torch.cuda.synchronize()
    return rec, launches, full, timing


def zero_reference(params, tokens, targets, cfg, mesh, adam):
    """The plain Adam step on whole tensors (``zero_adam_update``'s
    formulas with step 1, ``tests/test_zero.py:91``'s form): the global
    loss over the mesh's ranks, its gradients clipped by their global
    norm, m = (1 - b1) g, v = (1 - b2) g g, p - lr_1 (m / bc1) /
    (sqrt(v / bc2) + eps).  Returns (loss, a copy of the parameters, the
    clipped gradients, lr_1)."""
    import torch

    from accl_tpu_torch.models.transformer import (_global_loss,
                                                   _mesh_dp_tp, _mesh_ranks,
                                                   _nll, _tree_leaves,
                                                   _tree_map)
    from accl_tpu_torch.parallel import schedule_lr

    _, data, tp, ep = _mesh_dp_tp(cfg, mesh)
    ranks = _mesh_ranks(cfg, data, None, ep)
    leaves = _tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    nll, aux = _nll(_tree_map(lambda _: next(it), params), tokens, targets,
                    cfg, None, ranks)
    loss = _global_loss(nll, aux, cfg, data)
    grads = list(torch.autograd.grad(loss, live))
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = adam.clip_grad_norm / torch.clamp(norm, min=adam.clip_grad_norm)
    for i, g in enumerate(grads):
        grads[i] = (g.float() * scale).to(g.dtype)
    lr = float(schedule_lr(adam, 1))
    return float(loss.detach()), [p.detach().clone() for p in leaves], \
        grads, lr


def zero_update_gap(p0, grads, lr, state_w, adam) -> float:
    """The largest relative Frobenius difference, over the tensors,
    between the ZeRO step's master weights and the plain step's
    ``p0 - lr (m / bc1) / (sqrt(v / bc2) + eps)``, over the plain
    update's norm."""
    import torch

    from accl_tpu_torch.models.transformer import _tree_leaves

    bc1, bc2 = 1.0 - adam.b1, 1.0 - adam.b2
    worst = 0.0
    for p, g, w in zip(p0, grads, _tree_leaves(state_w)):
        gs = g.float().reshape(-1)
        m = (1.0 - adam.b1) * gs
        v = (1.0 - adam.b2) * gs * gs
        upd = lr * ((m / bc1) / (torch.sqrt(v / bc2) + adam.eps))
        want = p.float().reshape(-1) - upd
        got = w[:want.numel()]
        norm = float(upd.norm())
        if norm:
            worst = max(worst, float((got - want).norm()) / norm)
    return worst


def zero_leg(kc, mesh, moe: bool) -> dict:
    """Leg 4: ``make_zero_train_step`` on (dp 4, tp 1) with
    ``ZERO_ADAM`` (float32 master weights, clipping at 1.0, a 2-step
    warmup): the dense training model (1,346M), or the MoE model of leg 2
    cut to ``ZERO_MOE_LAYERS`` layers.  The first step's loss and master
    weights against the plain Adam step on whole tensors
    (:func:`zero_reference`); ``MODEL_STEPS`` steps launching rows 16-18
    causal once a layer and no other kernel, losses finite and
    falling."""
    import torch

    from accl_tpu_torch.models import TransformerConfig, init_params
    from accl_tpu_torch.parallel import AdamConfig, make_zero_train_step

    what = "zero_moe" if moe else "zero_dense"
    dev = torch.device("cuda", 0)
    fields = dict(MOE_TRAIN, n_layers=ZERO_MOE_LAYERS) if moe else TRAIN
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="auto", **fields)
    adam = AdamConfig(**ZERO_ADAM)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + (66 if moe else 65))
    torch.cuda.reset_peak_memory_stats()
    step, shard, init_state = make_zero_train_step(cfg, mesh, adam)
    params = init_params(cfg, gen)
    n = param_count(params)
    rk = reckon(what, weights=2 * n, gradients=2 * n,
                clipped_gradients=2 * n, moments_and_master=12 * n,
                check_copies=4 * n,
                activations=cfg.n_layers * 16 * TRAIN_B * TRAIN_T
                * cfg.d_model * 2 * (3 if moe else 1),
                logits=3 * TRAIN_B * TRAIN_T * cfg.vocab * 4)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_T), generator=gen,
                           device=dev, dtype=torch.int32)
    targets = tokens.roll(-1, dims=1)
    state = init_state(params)
    loss0, p0, g0, lr1 = zero_reference(params, tokens, targets, cfg, mesh,
                                        adam)
    reset_launches(kc)
    reset_full(kc)
    losses, secs, per_step, (params, state, *_) = timed_steps(
        kc, step, (params, state, tokens, targets), 1)
    loss_rel = abs(losses[0] - loss0) / abs(loss0)
    gap = zero_update_gap(p0, g0, lr1, state["w"], adam)
    del p0, g0
    more = timed_steps(kc, step, (params, state, tokens, targets),
                       MODEL_STEPS - 1)
    losses, secs, per_step = (losses + more[0], secs + more[1],
                              per_step + more[2])
    params, state = more[3][:2]
    launches = read_launches(kc)
    all_wgmma(kc, f"{what} steps")
    steps_launched(kc, what, per_step, cfg.n_layers)
    falling(what, losses)
    rec = step_record(secs, TRAIN_B * TRAIN_T, leg_peak(what, rk), rk,
                      per_step, losses)
    print(f"{what}: {MODEL_STEPS} steps on (dp 4, tp 1), {n} parameters, "
          f"losses {losses}, step ms {rec['step_ms']}; the first step "
          f"against plain Adam on whole tensors: loss {losses[0]} vs "
          f"{loss0} ({loss_rel} rel), master weights max rel (Frobenius, "
          f"of the update) {gap}", flush=True)
    if not loss_rel <= ZERO_LOSS_RTOL or not gap <= ZERO_UPDATE_RTOL:
        fail(f"{what}: the first step's loss {loss_rel} rel or master "
             f"weights {gap} off the plain Adam step")
    rec.update(params=n, layers=cfg.n_layers, adam=dict(ZERO_ADAM),
               first_step_loss_rel=loss_rel, first_step_update_rel=gap)
    del params, state, step
    torch.cuda.synchronize()
    return rec, launches


def models_main_path(kc, err) -> dict:
    """Phase 3o: the four legs of ROADMAP A9d's first half (MoE serving,
    MoE training, the encoder, ZeRO-1 Adam), bfloat16 on one card, each
    with the launch counters zeroed before its main path and read after.
    Returns each leg's phase 5 record, the launches by kernel, rows
    16-18's non-causal launches and their non-causal times."""
    import torch

    from accl_tpu_torch.ops.driver import make_mesh

    mesh = make_mesh(MODEL_MESH, axes=("dp", "tp"))
    launches = {k: 0 for k in kc.KERNELS}
    out = {}
    # each leg starts from the allocator's cache returned: the earlier
    # phases' blocks would otherwise fragment the 62 GB leg 4 needs
    torch.cuda.empty_cache()
    t0 = time.time()
    out["moe_serve"], got = moe_serve_leg(kc, mesh)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"phase 3o leg 1 (moe_serve) ok ({time.time() - t0:.1f} s)",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.time()
    out["moe_train"], got = moe_train_leg(kc, mesh)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"phase 3o leg 2 (moe_train) ok ({time.time() - t0:.1f} s)",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.time()
    out["encoder_train"], got, full, timing = encoder_leg(kc, mesh, err)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"phase 3o leg 3 (encoder) ok ({time.time() - t0:.1f} s)",
          flush=True)
    out["zero_adam"] = {}
    for moe in (False, True):
        torch.cuda.empty_cache()
        t0 = time.time()
        key = "moe_2_layers" if moe else "dense"
        out["zero_adam"][key], got = zero_leg(kc, mesh, moe)
        launches = {k: launches[k] + got[k] for k in launches}
        print(f"phase 3o leg 4 (zero_adam {key}) ok "
              f"({time.time() - t0:.1f} s)", flush=True)
    torch.cuda.synchronize()
    return dict(records=out, launches=launches, full=full, timing=timing)


def print_models(models, card: str) -> None:
    """Phase 5's records of phase 3o, one JSON line a leg."""
    for name, rec in models["records"].items():
        print(json.dumps({name: {"card": card, **rec}}))
    t = models["timing"]
    print(json.dumps({"flash_full_attention": {
        "card": card, "shape": [TRAIN_B, TRAIN["n_heads"], TRAIN_T, 128],
        "causal": False, "full_launches_encoder": models["full"],
        **{k: ({kk: vv for kk, vv in v.items()}
               if isinstance(v, dict) else v) for k, v in t.items()}}}))


# -- phase 3p: the pipeline, the composed trainer, the loader, the example --

#: the composed mesh: (pp 2, dp 2, tp 1) virtual ranks, 4 microbatches
PP_MESH, PP_MICROBATCHES = (2, 2, 1), 4
#: leg (c): the interleaved schedule, 3 chunks a rank (one layer each)
PP_V_STAGES = 3
#: the first step's loss against ``make_sharded_train_step`` on (dp 2,
#: tp 1) with the same weights and batch: both take float32 softmax
#: statistics, but the pipeline's GEMMs run on microbatches of 2,048 rows
#: where the flagship's run on 8,192, and their bfloat16 outputs may round
#: apart (a ulp is 2^-8 relative); the mean of about 8 M token losses
#: averages that down, so 2e-3 relative is a loose bound
PP_LOSS_RTOL = 2e-3
#: the device kernels of rows 16-18 and the delta pass, by the profiler's
#: kernel name (``csrc/attention.cu``, ``csrc/attention_bwd.cu``)
PP_PROFILED = (("flash_attention", "flash_fwd_wgmma"),
               ("flash_attention_bwd_dq", "flash_bwd_dq_wgmma"),
               ("flash_attention_bwd_dkv", "flash_bwd_dkv_wgmma"),
               ("flash_attention_bwd_delta", "flash_bwd_delta"))
#: leg (e): the training example's run (bench-free: its own small model)
PP_EXAMPLE_STEPS, PP_EXAMPLE_RESUME = 4, 6


def profiled_launches(step, args) -> tuple:
    """One step under ``torch.profiler``: the launches of each of
    ``PP_PROFILED`` by the device kernel's name, the step's wall ms, the
    device's busy ms and idle share (None when the profiler records no
    device time), the ten kernels of most device time (ms, launches),
    and the step's output."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    counts = {name: sum(key in e.name for e in kernels)
              for name, key in PP_PROFILED}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e.name[:80], (0.0, 0))
        by_name[e.name[:80]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return counts, dict(
        wall_ms=wall_ms, device_busy_ms=busy or None,
        idle_share=(1.0 - busy / wall_ms) if busy else None,
        top_kernels_ms_launches=[[k, ms, n] for k, (ms, n) in top]), out


def pp_leg(kc, name: str, cfg, p0, tokens, targets, ref_loss: float,
           schedule: str = "gpipe", v_stages: int = 1, adam=None) -> tuple:
    """One composed leg: ``make_pp_train_step`` on ``PP_MESH`` from the
    weights ``p0``, 3 steps (the third profiled), each launching rows
    16-18 and the delta pass as the schedule implies (once a layer a
    microbatch; row 16 twice under 1F1B, its forward tick and its
    recompute) and no other kernel, by the wrappers' counters and by the
    profiler; the losses finite and falling, the first against the
    flagship's ``ref_loss``; step ms, tokens/s, peak memory against the
    leg's reckoning."""
    import torch

    from accl_tpu_torch.models import make_pp_train_step
    from accl_tpu_torch.ops.driver import make_mesh
    from accl_tpu_torch.parallel import AdamConfig

    pp, dp, _ = PP_MESH
    M = PP_MICROBATCHES
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(PP_MESH, axes=("pp", "dp", "tp"))
    made = make_pp_train_step(
        cfg, mesh, M, lr=TRAIN_LR, v_stages=v_stages, schedule=schedule,
        adam=None if adam is None else AdamConfig(**adam))
    n = param_count(p0)
    B, T, D = TRAIN_B, TRAIN_T, cfg.d_model
    act = cfg.n_layers * 16 * B * T * D * 2
    parts = dict(weights=2 * n, gradients=2 * n, update_temporary=2 * n,
                 activations=act if schedule == "gpipe" else act // (M * pp),
                 logits=3 * B * T * cfg.vocab * 2 // (1 if schedule ==
                                                      "gpipe" else M),
                 replica_gradients=2 * pp * dp * cfg.vocab * D * (
                     2 if schedule == "1f1b" else 1))
    if adam is not None:
        parts.update(moments_and_master=12 * n, clipped_gradients=2 * n)
    rk = reckon(f"pipeline {name}", **parts)
    params = made[1](p0)
    args = ((params, made[2](p0), tokens, targets) if adam is not None
            else (params, tokens, targets))
    step = made[0]
    reset_launches(kc)
    reset_full(kc)
    losses, secs, per_step, args = timed_steps(kc, step, args, 2)
    before, full = read_launches(kc), read_full(kc)
    counts, prof, out = profiled_launches(step, args)
    losses.append(float(out[-1]))
    per_step.append(({k: c - before[k] for k, c in read_launches(kc).items()},
                     {k: c - full[k] for k, c in read_full(kc).items()}))
    launches = read_launches(kc)
    all_wgmma(kc, f"pipeline {name} steps")
    per_layer = {k: cfg.n_layers * M for k in TRAIN_KERNELS}
    if schedule == "1f1b":
        per_layer["flash_attention"] *= 2
    want = {k: per_layer.get(k, 0) for k in kc.KERNELS}
    for i, (got, full) in enumerate(per_step):
        if got != want or any(full.values()):
            fail(f"pipeline {name} step {i}: launches {got} (non-causal "
                 f"{full}), want {want}")
    if counts != {k: want[k] for k, _ in PP_PROFILED}:
        fail(f"pipeline {name}: the profiler counted {counts}, want "
             f"{ {k: want[k] for k, _ in PP_PROFILED} }")
    falling(f"pipeline {name}", losses)
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if not rel <= PP_LOSS_RTOL:
        fail(f"pipeline {name}: first loss {losses[0]} against the "
             f"flagship's {ref_loss}: {rel} rel > {PP_LOSS_RTOL}")
    peak = leg_peak(f"pipeline {name}", rk)
    warm = secs[1]
    bubble = pipeline_bubble(schedule, v_stages)
    rec = {"schedule": schedule, "v_stages": v_stages,
           "adam": adam, "mesh": list(PP_MESH), "microbatches": M,
           "step_ms": [s * 1e3 for s in secs] + [prof["wall_ms"]],
           "warm_step_ms": warm * 1e3, "tokens_per_s": B * T / warm,
           "profiled_step": prof, "peak_memory_gb": peak,
           "reckoned_memory_gb": rk, "launches_per_step": {
               k: v for k, v in want.items() if v},
           "profiler_launches": counts, "losses": losses,
           "first_loss_rel_to_flagship": rel, "bubble_fraction": bubble}
    print(f"pipeline {name}: losses {losses} (first {rel:.2e} rel to the "
          f"flagship's {ref_loss}); step ms {rec['step_ms']}; launches a "
          f"step {rec['launches_per_step']} (profiler {counts}); bubble "
          f"fraction {bubble:.4f}; peak {peak:.2f} GB", flush=True)
    del args, params, out, made, step
    torch.cuda.synchronize()
    return rec, launches


def pipeline_bubble(schedule: str, v_stages: int) -> float:
    from accl_tpu_torch.models import pipeline_bubble_fraction

    return pipeline_bubble_fraction(
        "interleaved" if v_stages > 1 else schedule, PP_MESH[0],
        PP_MICROBATCHES, v_stages)


def example_leg() -> dict:
    """Leg (e): the training example on the card: a token file written
    by ``write_token_file`` from seeded ids into a temporary directory,
    ``train(parallelism="pipeline", data=..., steps=4, save_every=2)``
    with a checkpoint directory, then a resume to 6 steps, against an
    uninterrupted 6-step run: the same final loss and the same saved
    tree, bit for bit (the loader's library built with g++ first)."""
    import tempfile

    import numpy as np
    import torch

    from accl_tpu_torch import data
    from accl_tpu_torch.examples.train import train

    t0 = time.perf_counter()
    lib = data.build()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.bin")
        data.write_token_file(path, np.random.default_rng(SEED).integers(
            0, 128, 30_000))
        kw = dict(parallelism="pipeline", data=path, log_every=0,
                  device="cuda")
        t0 = time.perf_counter()
        done, first = train(steps=PP_EXAMPLE_STEPS, save_every=2,
                            ckpt_dir=os.path.join(tmp, "a"), **kw)
        _, resumed = train(steps=PP_EXAMPLE_RESUME, save_every=2,
                           ckpt_dir=os.path.join(tmp, "a"), **kw)
        _, whole = train(steps=PP_EXAMPLE_RESUME,
                         save_every=PP_EXAMPLE_RESUME,
                         ckpt_dir=os.path.join(tmp, "b"), **kw)
        wall = time.perf_counter() - t0
        last = f"ckpt_{PP_EXAMPLE_RESUME - 1}.pt"
        trees = [torch.load(os.path.join(tmp, d, last), map_location="cpu",
                            weights_only=True)["tree"] for d in ("a", "b")]
        kept = sorted(os.listdir(os.path.join(tmp, "a")))

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return torch.equal(a, b)

    if done != PP_EXAMPLE_STEPS or not math.isfinite(first):
        fail(f"example: {done} steps, loss {first}")
    if resumed != whole or not same(*trees):
        fail(f"example: the resumed run's loss {resumed} or tree differs "
             f"from the uninterrupted run's ({whole})")
    if kept != ["ckpt_3.pt", "ckpt_5.pt"]:
        fail(f"example: checkpoints kept {kept}")
    print(f"pipeline example: loader built in {build_s:.2f} s ({lib.name}); "
          f"loss {first} after {done} steps, resumed to "
          f"{PP_EXAMPLE_RESUME}: {resumed} == uninterrupted {whole}, the "
          f"saved trees equal bit for bit; {wall:.1f} s for the three runs",
          flush=True)
    return {"steps": done, "loss_at_4": first, "loss_resumed": resumed,
            "loss_uninterrupted": whole, "bit_exact": True,
            "checkpoints_kept": kept, "loader_build_s": build_s,
            "wall_s": wall}


def pipeline_main_path(kc) -> dict:
    """Phase 3p: the pipeline, the composed ``("pp", "dp", "tp")`` step
    and the training example at bench.py's training width (1,346M
    parameters, bfloat16, ``attention="flash"``, batch 8 x 1024) on
    (pp 2, dp 2, tp 1) virtual ranks, 4 microbatches: (a) GPipe, (b)
    1F1B, (c) interleaved with 3 chunks a rank, (d) GPipe with ZeRO-1
    Adam (``ZERO_ADAM``), each from the same seeded weights, each with
    the counters zeroed before its steps and read after; the first loss
    of each against ``make_sharded_train_step`` on (dp 2, tp 1) with the
    same batch (its step also timed, the leg's step beside it); then (e)
    the training example's checkpoint resume.  Returns the records and
    the launches by kernel."""
    import torch

    from accl_tpu_torch.models import (TransformerConfig, init_params,
                                       make_sharded_train_step)
    from accl_tpu_torch.models.transformer import _tree_map
    from accl_tpu_torch.ops.driver import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash", **TRAIN)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 70)
    p0 = init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_T), generator=gen,
                           device=dev, dtype=torch.int32)
    targets = tokens.roll(-1, dims=1)
    # the flagship on (dp 2, tp 1), the same weights and batch
    fstep, fshard = make_sharded_train_step(
        cfg, lr=TRAIN_LR, mesh=make_mesh((PP_MESH[1], 1), axes=("dp", "tp")))
    fp = fshard(p0)
    flagship = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fp, loss = fstep(fp, tokens, targets)
        flagship.append((float(loss), (time.perf_counter() - t) * 1e3))
    del fp
    ref_loss = flagship[0][0]
    print(f"phase 3p: the flagship on (dp 2, tp 1): loss {ref_loss}, step "
          f"ms {[s for _, s in flagship]}", flush=True)
    launches = {k: 0 for k in kc.KERNELS}
    out = {"flagship": {"loss": ref_loss,
                        "step_ms": [s for _, s in flagship]}}
    for name, kw in (("gpipe", {}), ("1f1b", dict(schedule="1f1b")),
                     ("interleaved", dict(v_stages=PP_V_STAGES)),
                     ("gpipe_zero_adam", dict(adam=ZERO_ADAM))):
        t0 = time.time()
        out[name], got = pp_leg(kc, name, cfg, p0, tokens, targets,
                                ref_loss, **kw)
        launches = {k: launches[k] + got[k] for k in launches}
        print(f"phase 3p leg {name} ok ({time.time() - t0:.1f} s)",
              flush=True)
    print(f"phase 3p: peak GB 1F1B {out['1f1b']['peak_memory_gb']:.2f} "
          f"beside GPipe {out['gpipe']['peak_memory_gb']:.2f}; warm step ms "
          f"GPipe {out['gpipe']['warm_step_ms']:.1f}, 1F1B "
          f"{out['1f1b']['warm_step_ms']:.1f}, interleaved "
          f"{out['interleaved']['warm_step_ms']:.1f} beside the flagship's "
          f"{flagship[1][1]:.1f} (bubble fractions "
          f"{pipeline_bubble('gpipe', 1):.4f} / "
          f"{pipeline_bubble('gpipe', PP_V_STAGES):.4f})", flush=True)
    del p0, tokens, targets
    torch.cuda.empty_cache()
    reset_launches(kc)
    t0 = time.time()
    out["example"] = example_leg()
    got = read_launches(kc)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"phase 3p leg example ok ({time.time() - t0:.1f} s)", flush=True)
    return dict(records=out, launches=launches)


def print_pipeline(pipe, card: str) -> None:
    """Phase 5's record of phase 3p: one JSON line."""
    print(json.dumps({"pipeline_train": {"card": card,
                                         **pipe["records"]}}))


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
    if sys.argv[1:] == ["--dispatch"]:  # phase 3i and facade_dispatch alone
        probe_phase(kc)
        print(f"built {kc.build_all()}", flush=True)
        t0 = time.time()
        dispatched = dispatch_main_path(kc)
        print(f"dispatch path ok ({time.time() - t0:.1f} s): launches "
              f"{ {k: v for k, v in dispatched.items() if v} }", flush=True)
        print(json.dumps({"facade_dispatch": {
            "card": smi.stdout.strip().splitlines()[0],
            **facade_dispatch_latency([64 * 1024, 1024 * 1024])}}))
        return 0
    if sys.argv[1:] == ["--cp"]:  # phase 3j, rows 16-18 at T = 4096, train_cp
        probe_phase(kc)
        t0 = time.time()
        cp = cp_main_path(kc)
        print(f"context-parallel path checks done ({time.time() - t0:.1f} s)",
              flush=True)
        print(json.dumps({"flash_t4096": time_flash_bwd(CP_B, CP_T,
                                                        plain=False)}))
        print(json.dumps({"train_cp": {
            "card": smi.stdout.strip().splitlines()[0], **cp_timing(cp)}}))
        return 0
    if sys.argv[1:] == ["--topology"]:  # phase 3k and facade_topology alone
        probe_phase(kc)
        print(f"built {kc.build_all(['ring', 'rooted'])}", flush=True)
        t0 = time.time()
        topo = topology_main_path(kc)
        print(f"topology path ok ({time.time() - t0:.1f} s): launches "
              f"{ {k: v for k, v in topo['launches'].items() if v} }; "
              f"steps {json.dumps(topo['steps'])}", flush=True)
        t0 = time.time()
        print(json.dumps({"facade_topology": {
            "card": smi.stdout.strip().splitlines()[0],
            "autotune": topo["tune"], **topology_latency()}}))
        print(f"facade_topology timing ({time.time() - t0:.1f} s)",
              flush=True)
        return 0
    if sys.argv[1:] == ["--telemetry"]:  # phase 3l and its cost alone
        probe_phase(kc)
        print(f"built {kc.build_all(['ring', 'cmdring'])}", flush=True)
        t0 = time.time()
        telem = telemetry_main_path(kc)
        print(f"telemetry path ok ({time.time() - t0:.1f} s): launches "
              f"{ {k: v for k, v in telem['launches'].items() if v} }",
              flush=True)
        t0 = time.time()
        print(json.dumps({"telemetry": {
            "card": smi.stdout.strip().splitlines()[0],
            **{k: v for k, v in telem.items() if k != "launches"},
            "cost": telemetry_cost(kc)}}))
        print(f"telemetry timing ({time.time() - t0:.1f} s)", flush=True)
        return 0
    if sys.argv[1:] == ["--faults"]:  # phase 3m and the verifier's cost
        probe_phase(kc)
        print(f"built {kc.build_all(['ring', 'rooted', 'cmdring'])}",
              flush=True)
        t0 = time.time()
        faults = faults_main_path(kc)
        print(f"faults path ok ({time.time() - t0:.1f} s): launches "
              f"{ {k: v for k, v in faults['launches'].items() if v} }",
              flush=True)
        t0 = time.time()
        print(json.dumps({"faults": {
            "card": smi.stdout.strip().splitlines()[0],
            **{k: v for k, v in faults.items() if k != "launches"},
            "cost": faults_cost(kc)}}))
        print(f"faults timing ({time.time() - t0:.1f} s)", flush=True)
        check_circuit_opens("after phase 3m", faults["ring"]["circuit_open"])
        return 0
    if sys.argv[1:] == ["--arbiter"]:  # phase 3n and its cost alone
        probe_phase(kc)
        print(f"built {kc.build_all(['ring', 'cmdring'])}", flush=True)
        t0 = time.time()
        arb = arbiter_main_path(kc)
        print(f"arbiter path ok ({time.time() - t0:.1f} s): launches "
              f"{ {k: v for k, v in arb['launches'].items() if v} }",
              flush=True)
        t0 = time.time()
        print(json.dumps({"arbiter": {
            "card": smi.stdout.strip().splitlines()[0],
            **{k: v for k, v in arb.items() if k != "launches"},
            "cost": arbiter_cost(kc)}}))
        print(f"arbiter timing ({time.time() - t0:.1f} s)", flush=True)
        check_circuit_opens("after phase 3n", 0)
        return 0
    if sys.argv[1:] == ["--models"]:  # phase 3o alone, with its records
        probe_phase(kc)
        print(f"built {kc.build_all(['attention', 'attention_bwd'])}",
              flush=True)
        t0 = time.time()
        err = {k: 0.0 for k in kc.KERNELS}
        models = models_main_path(kc, err)
        print(f"models path ok ({time.time() - t0:.1f} s): launches "
              f"{ {k: v for k, v in models['launches'].items() if v} }",
              flush=True)
        print_models(models, smi.stdout.strip().splitlines()[0])
        return 0
    if sys.argv[1:] == ["--pipeline"]:  # phase 3p alone, with its record
        probe_phase(kc)
        print(f"built {kc.build_all(['attention', 'attention_bwd'])}",
              flush=True)
        t0 = time.time()
        pipe = pipeline_main_path(kc)
        print(f"pipeline path ok ({time.time() - t0:.1f} s): launches "
              f"{ {k: v for k, v in pipe['launches'].items() if v} }",
              flush=True)
        print_pipeline(pipe, smi.stdout.strip().splitlines()[0])
        return 0
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
    closing = check_persistent(err)
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
    t0 = time.time()
    ringed = ring_main_path(kc)
    print(f"ring path ok ({time.time() - t0:.1f} s): launches "
          f"{ {k: v for k, v in ringed['launches'].items() if v} }",
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
    cp = cp_main_path(kc)
    print(f"context-parallel path checks done ({time.time() - t0:.1f} s)",
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
    t0 = time.time()
    dispatched = dispatch_main_path(kc)
    print(f"dispatch path ok ({time.time() - t0:.1f} s): launches "
          f"{ {k: v for k, v in dispatched.items() if v} }", flush=True)
    t0 = time.time()
    topo = topology_main_path(kc)
    print(f"topology path ok ({time.time() - t0:.1f} s): launches "
          f"{ {k: v for k, v in topo['launches'].items() if v} }; steps "
          f"{json.dumps(topo['steps'])}", flush=True)
    t0 = time.time()
    telem = telemetry_main_path(kc)
    print(f"telemetry path ok ({time.time() - t0:.1f} s): launches "
          f"{ {k: v for k, v in telem['launches'].items() if v} }",
          flush=True)
    t0 = time.time()
    faults = faults_main_path(kc)
    print(f"faults path ok ({time.time() - t0:.1f} s): launches "
          f"{ {k: v for k, v in faults['launches'].items() if v} }",
          flush=True)
    t0 = time.time()
    arb = arbiter_main_path(kc)
    print(f"arbiter path ok ({time.time() - t0:.1f} s): launches "
          f"{ {k: v for k, v in arb['launches'].items() if v} }",
          flush=True)
    t0 = time.time()
    models = models_main_path(kc, err)
    print(f"models path ok ({time.time() - t0:.1f} s): launches "
          f"{ {k: v for k, v in models['launches'].items() if v} }",
          flush=True)
    t0 = time.time()
    pipe = pipeline_main_path(kc)
    print(f"pipeline path ok ({time.time() - t0:.1f} s): launches "
          f"{ {k: v for k, v in pipe['launches'].items() if v} }",
          flush=True)
    # each kernel's launches over the probe's and the seventeen paths' runs
    launches = {k: launches[k] + rooted[k] + batched[k]
                + ringed["launches"][k] + serve["launches"][k]
                + train["launches"][k] + cp["launches"][k] + compressed[k]
                + converged[k]
                + p2p[k] + seqp["launches"][k] + dispatched[k]
                + topo["launches"][k] + telem["launches"][k]
                + faults["launches"][k] + arb["launches"][k]
                + models["launches"][k] + pipe["launches"][k] + probed[k]
                for k in launches}

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
    # the stochastic and scaled lanes: no PyTorch call rounds so
    timing["sequencer_lanes"] = dict(ms=seq["int8_ms"],
                                     plain_ms=seq["int8_plain_ms"],
                                     library_ms=None)
    timing["sequencer_run"] = dict(ms=seq["run_ms"], plain_ms=seq["plain_ms"],
                                   library_ms=seq["library_ms"])
    flash = time_flash()
    timing["flash_attention"] = flash[SERVE_T]
    flash_bounds = {T: bound(f["bytes"], f["ops"], TC16_OPS_PER_S)
                    for T, f in flash.items()}
    bwd = time_flash_bwd()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        timing[name] = dict(bwd[name], library_ms=bwd["library_bwd_ms"])
    timing["flash_attention_bwd_delta"] = bwd["flash_attention_bwd_delta"]
    bwd4k = time_flash_bwd(CP_B, CP_T, plain=False)  # phase 3j's dense step
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
        # its fp8 / int8 lanes (_pallas_windows :706-725, _decode_slot_xla
        # :320-375) and its persistent session (run_session :541-565)
        "sequencer_lanes": ("accl_tpu_torch/csrc/cmdring.cu",
                            "accl_tpu/ops/pallas/cmdring.py:534"),
        "sequencer_run": ("accl_tpu_torch/csrc/cmdring.cu",
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
            **(seq["bound"] if name in ("sequencer", "sequencer_run")
               else seq["int8_bound"] if name == "sequencer_lanes"
               else flash_bounds[SERVE_T] if name == "flash_attention"
               else bound(t["bytes"], t["ops"], TC16_OPS_PER_S)
               if name in TC_KERNELS else bound(t["bytes"], t["ops"])),
            "library_ms": t["library_ms"],
        })
        if topo["launches"][name]:  # phase 3k's share
            kernels[-1]["launches_topology"] = topo["launches"][name]
        if telem["launches"][name]:  # phase 3l's share
            kernels[-1]["launches_telemetry"] = telem["launches"][name]
        if faults["launches"][name]:  # phase 3m's share
            kernels[-1]["launches_faults"] = faults["launches"][name]
        if arb["launches"][name]:  # phase 3n's share
            kernels[-1]["launches_arbiter"] = arb["launches"][name]
        if models["launches"][name]:  # phase 3o's share
            kernels[-1]["launches_models"] = models["launches"][name]
        if name in TRAIN_KERNELS:  # non-causal, (8, 32, 1024, 128): 3o
            f = models["timing"]["fwd" if name == "flash_attention"
                                 else name]
            kernels[-1].update({
                "full_launches_encoder": models["full"].get(name, 0),
                "full_ms": f["ms"], "full_device_ms": f["device_ms"],
                "full_plain_ms": f["plain_ms"],
                "full_bound_ms": f["bound_ms"],
                "full_bound_by": f["bound_by"],
                "full_library_ms": (
                    f["library_ms"] if name == "flash_attention"
                    else None if name == "flash_attention_bwd_delta"
                    else models["timing"]["library_bwd_ms"]),
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
        if name == "sequencer_lanes":  # int8 above; e4m3 beside it
            kernels[-1].update({
                "window": "8 x allreduce 1 Mi f32, P = 4, seeded",
                "device_ms": seq["int8_device_ms"],
                "plain_device_window_ms": seq["device_ms"],
                "ptxas": tile_regs["sequencer_lanes"],
                "e4m3_ms": seq["float8_e4m3fn_ms"],
                "e4m3_device_ms": seq["float8_e4m3fn_device_ms"],
                "e4m3_plain_ms": seq["float8_e4m3fn_plain_ms"],
                "e4m3_bound_ms": seq["float8_e4m3fn_bound"]["bound_ms"],
            })
        if name == "sequencer_run":  # a window of a stream of 16, one run
            kernels[-1].update({
                "window": "8 x allreduce 1 Mi f32, P = 4, 16 a run",
                "oneshot_ms": seq["oneshot_ms"],
                "ptxas": tile_regs["sequencer_run"],
                "ptxas_lanes": tile_regs["sequencer_run_lanes"],
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
        if name in TRAIN_KERNELS:  # phase 3j's dense step at T = 4096
            f = bwd4k["fwd" if name == "flash_attention" else name]
            b = bound(f["bytes"], f["ops"], TC16_OPS_PER_S
                      if name in TC_KERNELS else F32_OPS_PER_S)
            lib = ("library_ms", "library_device_ms")
            lib = ([f[k] for k in lib] if name == "flash_attention"
                   else [None, None] if name == "flash_attention_bwd_delta"
                   else [bwd4k[k.replace("library", "library_bwd")]
                         for k in lib])
            kernels[-1].update({
                "t4096_shape": [CP_B, TRAIN["n_heads"], CP_T, 128],
                "t4096_launches": cp["launches"][name],
                "t4096_ms": f["ms"], "t4096_device_ms": f["device_ms"],
                "t4096_bound_ms": b["bound_ms"],
                "t4096_bound_by": b["bound_by"],
                "t4096_library_ms": lib[0], "t4096_library_device_ms": lib[1],
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
    for name in ("sequencer_lanes", "sequencer_run"):
        k = by_name[name]
        extra = (f"e4m3 device_ms={k['e4m3_device_ms']:.4f} "
                 f"bound_ms={k['e4m3_bound_ms']:.4f}"
                 if name == "sequencer_lanes" else
                 f"one-shot launches {k['oneshot_ms']:.4f} a window")
        print(f"{name}: ms={k['ms']:.4f} "
              f"{'device_ms=%.4f ' % k['device_ms'] if 'device_ms' in k else ''}"
              f"bound_ms={k['bound_ms']:.4f}; {extra}")
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
    facade += facade_stream_latency([64 * 1024, 256 * 1024, 1024 * 1024])
    print(json.dumps({"facade_batch": facade}))
    print(json.dumps({"facade_ring": {
        "card": smi.stdout.strip().splitlines()[0],
        "batched_pair": facade_pair_latency([64 * 1024, 1024 * 1024]),
        "stream_check": ringed["stream"],
        "delayed_post": ringed["delayed_post"],
        "closing_handshake": closing,
        "starvation_ms": ringed["starvation_ms"],
        "starvation_linger_ms": ringed["starvation_linger_ms"]}}))
    t1 = time.time()
    facade = facade_dispatch_latency([64 * 1024, 1024 * 1024])
    print(json.dumps({"facade_dispatch": {
        "card": smi.stdout.strip().splitlines()[0], **facade}}))
    print(f"facade_dispatch timing ({time.time() - t1:.1f} s)", flush=True)
    t1 = time.time()
    print(json.dumps({"facade_topology": {
        "card": smi.stdout.strip().splitlines()[0],
        "autotune": topo["tune"], **topology_latency()}}))
    print(f"facade_topology timing ({time.time() - t1:.1f} s)", flush=True)
    t1 = time.time()
    print(json.dumps({"telemetry": {
        "card": smi.stdout.strip().splitlines()[0],
        **{k: v for k, v in telem.items() if k != "launches"},
        "cost": telemetry_cost(kc)}}))
    print(f"telemetry timing ({time.time() - t1:.1f} s)", flush=True)
    t1 = time.time()
    print(json.dumps({"faults": {
        "card": smi.stdout.strip().splitlines()[0],
        **{k: v for k, v in faults.items() if k != "launches"},
        "cost": faults_cost(kc)}}))
    print(f"faults timing ({time.time() - t1:.1f} s)", flush=True)
    t1 = time.time()
    print(json.dumps({"arbiter": {
        "card": smi.stdout.strip().splitlines()[0],
        **{k: v for k, v in arb.items() if k != "launches"},
        "cost": arbiter_cost(kc)}}))
    print(f"arbiter timing ({time.time() - t1:.1f} s)", flush=True)
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
    trained = cp_timing(cp)
    print(f"context-parallel training timing ({time.time() - t0:.1f} s)",
          flush=True)
    print(json.dumps({"train_cp": {
        "card": smi.stdout.strip().splitlines()[0], **trained}}))
    t0 = time.time()
    seq_lat = seq_parallel_latency(dev)
    print(f"seq_parallel_attention timing ({time.time() - t0:.1f} s)",
          flush=True)
    print(json.dumps({"seq_parallel_attention": {
        "card": smi.stdout.strip().splitlines()[0], **seq_lat,
        "gaps": seqp["gaps"]}}))
    print_models(models, smi.stdout.strip().splitlines()[0])
    print_pipeline(pipe, smi.stdout.strip().splitlines()[0])
    check_circuit_opens("after phase 3m", faults["ring"]["circuit_open"])
    print(json.dumps({"gc_holds": GC_HOLDS}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
