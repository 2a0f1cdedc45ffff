#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
   ``nvcc`` for ``sm_90a``; print ptxas's registers, shared memory and
   spill bytes of each tensor-core kernel (the attention forward, the
   flash backward's dK/dV and dQ kernels, the GEMM tile in the grouped,
   tile and ring matmuls), of the paged decode and RMSNorm backward
   kernels and of the SSD forward and backward and RMSNorm forward
   kernels, and fail on a spill;
   print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in f32 (TF32 off) and bf16, and time kernel,
   plain version, the one PyTorch call that computes the same function
   (a yardstick only; the port never calls it) and the card's bound.
   The paged decode runs at mixed positions (``main`` and its variants),
   with every slot at the last position (``full``), at the serve
   phase's profiled positions (``serve``) and with K/V pools off 16-byte
   alignment (``unaligned``); each row runs twice and the bits must
   agree.
3. Whole-slice consistency: ``gpt-serve-h4096`` at full width and 2
   layers in f32 through the port's ``ServingEngine`` on the card (kernels)
   and on the CPU (plain versions) from the same weights: tokens must be
   identical and KV pools (page 0 aside) agree within 1e-4.
4. Serve ``gpt-serve-h4096`` at full width and 8 of its 64 layers in
   bf16 (8 slots, max_seq 2048, page 16, prefix cache on, 16 requests);
   each kernel's launches over this phase must be steps x 8 (paged
   decode) and steps x 17 (RMSNorm).  After step 470 (8 active slots at positions
   up to ~470), 4 of its steps are timed plainly and 4 under ``torch.profiler``:
   device time against host wall per step.  The engine records into a
   JSONL ``Recorder`` (``repro_torch.obs``): every line validates, the
   ``serving.decoded_tokens`` sum is the decoded tokens,
   ``serving.decode_step_s`` holds the engine's step times one for one
   and ``serving.ttft_s`` one sample a request.
5. Training kernels against their plain versions on the card, in f32
   (TF32 off) and bf16: flash attention forward (out, lse) and backward
   (dq, dk, dv; run twice, the bits must agree) at the training shapes (b 4, s 1024, 32 heads of 64;
   GQA 16/8 heads of 128; softcap 30 with window 256; ragged s 1000;
   granite's 24/8 heads of 64, a group of 3; 16/4 heads of 32; ragged
   s 1000 at hd 32 and at hd 128 with window 300; s 40 at hd 128 with
   window 16 and softcap 30; in bf16 also b 1, s 8192, 4 heads of 128,
   the long rows that one tensor-core accumulator sums) and the RMSNorm
   forward at 4096 x 2048, 1536 and 768 and
   backward at 4096 x 2048, 1536 and 4096, a ragged 1000 x 1001 and a
   1024 x 8192 wider than a warp group holds (run twice, the bits must
   agree), each timed with its bound, its
   plain version and, where one PyTorch call computes the same function,
   that call (a yardstick only).
6. Training consistency: ``gpt-h2048`` at full width and 2 layers in f32,
   batch 2, seq 256, from the same weights on the card (kernels) and on
   the CPU (plain versions): loss within 1e-5 relative and every gradient
   leaf within ``grads_err`` 1e-4.
7. Train ``gpt-h2048`` at full width and depth in bf16 through the port's
   ``Trainer`` (batch 8, seq 1024, 2 microbatches, 8 AdamW steps): finite
   losses, every leaf's gradient present and finite after the first step,
   launches of steps x 2 x 24 (flash forward and backward) and
   steps x 2 x 49 (RMSNorm forward and backward); step time, tokens/s,
   MFU, peak memory and a ``torch.profiler`` window of one step.
   Phases 6 and 7 run the ``megatron`` schedule without recomputation,
   the one-device configuration of the second slice.
8. Tensor-parallel kernels against their plain versions on the card:
   the tile matmul at the ``gpt-h2048`` tp=2 ring-step shapes (``wo``
   [2048, 1024] @ [1024, 2048], ``wd`` [2048, 4096] @ [4096, 2048], the
   only shapes at which training runs its code: as the ring kernel's
   per-step product, never launched alone) and a ragged one, f32 and
   bf16, timed beside its bound, its plain version and ``torch.matmul``
   (cuBLAS), with the tile each row took (``path``: bf16 ``wgmma`` or, for
   the ragged shape, ``mma_sync``) and, in bf16, a second run that must
   give the same bits; then, with 2 and 4 rank processes sharing the
   card over ``PeerComm``, the fused matmul -> reduce-scatter ring at both
   exits and the peer all-reduce, all-gather and reduce-scatter (the
   collective kernel's scatter mode, timed beside the all-reduce and
   slice it replaces), every rank's result held against the plain
   version computed from all ranks' inputs (the ring's bf16 rows also
   run twice and must give the same bits).
9. Tensor-parallel consistency: ``gpt-h2048`` at full width, 2 layers,
   f32, batch 2 x 256, tp=2 on the card under ``megatron``, ``oases`` and
   ``fused`` with fine recomputation and ``oases`` without and with
   coarse recomputation, against phase 6's tp=1 card run on the same
   weights: loss within 1e-5 relative, gathered gradients within
   ``grads_err`` 1e-4; the memory each forward keeps for its backward.
10. Tensor-parallel training: ``gpt-h2048`` at full width and 6 of its
   24 layers in bf16, tp=2 (two rank processes on the card), batch 8 x
   1024 in 2 microbatches, fine recomputation, 4 AdamW steps under each
   of ``megatron``, ``oases`` and ``fused``: finite losses, first losses
   across schedules within the bf16 tolerance, every leaf's gradient
   present and finite after step 1 on every rank, launches per step
   (``fused``: 24 ring launches a rank, none replayed), step times, peak
   memory per rank and a one-step profile per schedule, with the device
   ms inside each ``tmp.<schedule>.*`` range, forward and backward, and
   the share outside every range.  The card is calibrated once here
   (a fresh ``REPRO_CAL_CACHE``) before the ranks start; rank 0 records
   into a JSONL sink per schedule, and its end-of-run overlap probe must
   give one ``overlap.group`` event per plan group (the schedule's tag,
   ``measured_exposed_frac`` in [0, 1]) and both ``overlap.*`` gauges;
   the readings are recorded, not gated.  When phase 9 runs too, its
   rank processes run this phase's ranks after their own (one spawn and
   warm-up for both; the calibration and the sink's directory made in
   the parent first), and this phase reads their results.
11. Ring attention against its plain version on the card, with 2 and 4
   rank processes sharing the card over ``PeerComm``: the kernel's out and
   lse on every rank against the plain version computed from all ranks'
   inputs, in f32 (TF32 off) and bf16, at the slice's shape
   (``internlm2-1.8b``, b 2, s 4096, 16 q / 8 kv heads of 128, causal),
   at ``gpt-h2048``'s MHA heads (hd 64), with GQA, window 256 and
   softcap 30, and with ragged shards (s 2000: sq 1000 and 500) and
   window 700; each timed beside its bound, the plain version and SDPA of
   the local q against the gathered K/V with the offset causal mask (a
   yardstick only; the port never calls it).  First, in this process, the
   bf16 flash forward is timed at the slice's whole shape: the tile with
   no peers and no time slices.
12. Sequence-parallel consistency: ``internlm2-1.8b`` at full width, 2
   layers, f32, batch 2 x 512, tp=2 on the card: SP under ``megatron`` and
   ``fused``, ring attention (``seq_shard`` 2) under ``oases`` and
   ``fused`` with fine recomputation and under ``oases`` with coarse,
   against a tp=1 card run of the same weights: loss within 1e-5
   relative, gathered gradients within ``grads_err`` 1e-4; the ring kernel
   launches once per layer and sub-batch (none in the fine replay), the
   ring matmul only under ``fused``; the memory each forward keeps for its
   backward.  When phase 13 runs too, its ranks run in these processes
   after this phase's.
13. Ring-attention training: ``internlm2-1.8b`` at full width and 6 of
   its 24 layers in bf16, tp=2, ``seq_shard`` 2, batch 4 x 4096 in 2
   microbatches, fine recomputation, 3 AdamW steps under ``oases`` and
   ``fused``: finite losses equal on both ranks, first losses across the
   schedules within the bf16 tolerance, every leaf's gradient present and
   finite after step 1, launches a step (ring attention 6 x
   microbatches x sub-batches, the ring matmul 12 under ``fused``), step
   time, tokens/s, peak memory per
   rank and a one-step profile per schedule.

14. Family kernels against their plain versions on the card, f32 (TF32
   off) and bf16: the SSD forward and backward kernels at
   ``mamba2-130m``'s mixer (24 heads of 64, state 128) at b 1 x s 4096
   (the slice's shape), at s 96 (one chunk shorter than 128) and at b 4
   x s 1024, every result (y; dx, d(dt), dA_log, dB, dC, dD) against the
   plain versions and bit-identical on a second run, each row with its
   f32 CUDA-core and its tensor-core bound; the grouped matmul's
   forward and both backward products as training launches them
   (``moe_gmm`` and ``moe_gmm_bwd``: dx and dw read w and x where they
   lie) at ``granite-moe-3b-a800m``'s expert shapes (40 experts, capacity
   1,024: [1024, 1536] @ [1536, 512] and [1024, 512] @ [512, 1536]) and
   at a capacity of 250 (no tile multiple), each row with its tile
   (``path``) and, in bf16, a second run that must give the same bits;
   granite's flash forward and backward (group 3; phase 5's
   rows when phase 5 ran).  Each timed
   beside its bound, its plain version and, for the grouped matmul,
   ``torch.bmm`` of the same product (a yardstick only; the port never
   calls it; no PyTorch call computes the SSD or its gradient).
15. Family consistency: ``mamba2-130m`` and ``granite-moe-3b-a800m`` at
   full width and 2 layers in f32, batch 2 x 256, under ``megatron``
   without recomputation and under the training default, ``oases`` (split
   2: each sub-batch routes alone) with fine recomputation, on the card
   (kernels) and on the CPU (plain versions) from the same weights:
   granite's routing (experts and kept mask of every token, every MoE
   call, the replays included) identical, with any token that differs
   reported beside its gap between the k-th and (k+1)-th probability;
   loss within 1e-5 relative, aux within 1e-6, every gradient leaf
   present, finite and within ``grads_err`` 1e-4; launches exactly the
   count of the code's path.
16. Family training through the port's ``Trainer`` in bf16, ``megatron``
   without recomputation, 8 AdamW steps: ``mamba2-130m`` at full size
   (batch 4 x 4096 in 4 microbatches) and ``granite-moe-3b-a800m`` at
   full width and 8 of its 32 layers (batch 8 x 1024 in 2
   microbatches): finite losses, every leaf's gradient present and
   finite after step 1, launches a step exactly as worked out from the
   code (SSD forward and backward 24 x 4 each, grouped matmul 9 x 8 x
   2), step time, tokens/s,
   peak memory and a one-step profile; then each family through the
   launcher (``launch/train.py``) with its defaults (``oases``, split 2,
   fine recomputation) at full depth for 2 steps: ``mamba2-130m`` at
   batch 4 x 4096 in 2 microbatches, all 32 layers of
   ``granite-moe-3b-a800m`` at batch 2 x 1024; finite losses, exact
   launches, peak memory.
17. Hybrid kernels against their plain versions on the card, f32 (TF32
   off) and bf16: the RG-LRU forward (y and the f32 states) and backward
   (dx and the five gate gradients, from the same states) at
   ``recurrentgemma-9b``'s b 2 x s 4096 x w 4096 and at a ragged b 1 x
   s 1000 x w 1000; flash forward and backward at head dim 256, 16 q
   heads and 1 kv head, b 2 x s 4096, with the window 2048 and without,
   and at the ragged edge (s 1000, window 300; s 40); each timed beside its bound, its plain version and, for flash, SDPA
   (the window as a mask; a yardstick only, the port never calls it).
18. Hybrid consistency: ``recurrentgemma-9b`` at full width and depth 5
   (one block and a two-layer RG-LRU tail) in f32, batch 1 x 2304
   (longer than the window), under ``megatron`` without recomputation and
   ``oases`` with fine recomputation, on the card (kernels) against an
   f64 pass on the card from the same weights (the witness: the plain
   versions, which the wrappers take for that pass alone, and cuBLAS's
   f64 products, independent of the f32 path's; it replaced an f32 CPU
   pass of 65-91 s): loss within 1e-6 relative, every gradient leaf
   within ``grads_err`` 2e-5 (the five worst leaves reported), launches
   exactly the count of the code's path; a card pass with TF32 products
   (the control) must exceed that gate.
19. Hybrid training through the port's ``Trainer`` in bf16:
   ``recurrentgemma-9b`` at full width and depth 8 (2.63 B parameters),
   batch 2 x 4096 (microbatch auto: 1), 3 AdamW steps under ``oases``
   with fine recomputation (the launcher's default) and under
   ``megatron`` without recomputation: finite, decreasing losses, every
   leaf's gradient present and finite after step 1, launches a step
   exactly as worked out from the code (``megatron``: RG-LRU 6 forward
   and 6 backward, flash 2 and 2; ``oases``: two sub-batches, each
   forward replayed: 24 and 12, 8 and 4), step time, tokens/s, MFU, peak
   memory and a one-step profile.
20. The planner's path (``repro_torch.core.planner``): calibrate the card
   with a fresh cache (a bf16 product for ``peak_flops``, a 1 GiB f32
   stream for ``hbm_bw``, gated at 0.3x-1.05x of the data sheet's 989
   TFLOP/s and 3.35 TB/s; ``hbm_cap`` the device's memory), then
   ``launch/train.py --planner --save-plan`` for ``gpt-h2048`` in phase
   7's configuration (tp=1, batch 8 x 1024, microbatch 2, ``megatron``
   without recomputation), 3 steps, and ``--plan`` of that file, 3 steps:
   the plan ``[1/megatron] * 24``, its JSON read back equal, both runs'
   losses bit-identical, each run's launches exactly phase 7's count;
   the ILP's prediction beside the measured median step (CUDA events,
   the last 2 steps) and their ratio, recorded, not gated.  The planned
   run writes ``--telemetry``: ``python -m repro_torch.obs.report DIR
   --validate`` exits 0, the ``planner.plan`` event carries the run's
   ``predicted_ms``, ``trainer.step_time_s`` one sample a step, and the
   probe says ``overlap.skip`` (tp=1).
21. Per-layer plans and the 2-D layout, consistency: ``gpt-h2048`` at
   full width, 4 layers, f32, batch 4 x 256, 4 rank processes on the card
   (sub-group communicators, each a ``PeerComm`` with its own workspace),
   fine recomputation, on the factored mesh ``(1, 2, 2)`` (one spawn):
   ``[4, 4, 2, 2]`` x ``[oases, oases, megatron, megatron]``, the 2-D
   ``(2, 2)`` degree on every layer under ``fused``, and ``[(2, 2), (2,
   2), 4, 4]`` x ``[fused, fused, wang, wang]``,
   each against a tp=1 card run of the same weights: loss within 1e-5
   relative, each leaf's gradient (summed over its extra data-parallel
   ranks) within ``grads_err`` 1e-4 of its block of the tp=1 gradient,
   every replica's weights bit-identical after one AdamW step, launches
   exactly as worked out from the plan groups (flash and RMSNorm forward
   and backward, the ring kernel under ``fused``); the comm counts of the
   forward and the backward reported.
22. Per-layer plans and the 2-D layout, training: ``gpt-h2048`` at full
   width and depth in bf16, 4 rank processes, batch 8 x 1024 in one
   microbatch (two microbatches' f32 sums do not fit beside four ranks'
   optimizer state on one card), fine recomputation, 2 AdamW steps a
   run, each run
   resolved by ``launch/train.py``'s own path (its flags, ``_resolve``)
   and trained by its Trainer on every rank, the two runs on the
   factored mesh in one spawn (one warm-up; phase 21's rank processes
   when it runs, after its cases), one after the other: a plan file with layers
   0-11 at degree 4 under ``oases`` and 12-23 at degree 2 under
   ``megatron`` (``--tp 4 --mesh factored --plan``), the 2-D layout
   (``--tmp-layout 2d --mesh 1x2x2 --schedule fused``) and the ILP's plan
   (``--tp 4 --mesh factored --planner``, calibrated on the card), its
   prediction beside the measured median step, recorded, not gated:
   finite losses equal on every rank, first losses across the runs
   within the bf16 tolerance, every leaf's gradient present and finite
   after step 1 on every rank, launches a step exactly as worked out
   from the plan groups, step times, peak memory per rank and a one-step
   profile of rank 0 (device ms inside each ``tmp.<schedule>.*`` range,
   ``proj`` among them, and the share outside every range); rank 0
   records into a JSONL sink, whose probe gives one ``overlap.group``
   event per plan group.
23. The dry run (``launch/dryrun.run_cell``, ``launch/hlo_cost.py``) of
   each training cell phases 7, 16, 19 and 22 measured in this run, at
   its exact configuration (rank 0 of phase 22's four), traced on fake
   tensors in worker processes side by side: dot flops, HBM bytes, link
   bytes, the three roofline terms, the bound (the largest) against the
   measured step, the planner's prediction (phase 20) and the estimated
   against the measured peak.  Gates: bound / measured in (0, 1.05] and
   the record's argument bytes equal to the bytes the phase's params,
   AdamW state and batch held.
24. The other families' kernel rows against their plain versions, f32
   (TF32 off) and bf16, each bf16 backward run twice for the same bits:
   flash forward and backward at whisper's cross attention (b 8, 448
   queries against 1,500 keys, 12 heads of 64, not causal) and encoder
   (b 8, s 1,500, not causal), llama-3.2-vision's cross attention (b 2,
   2,048 queries against 6,404 keys, 32 q / 8 kv heads of 128), more
   queries than keys under the causal mask (1,000 against 300) and
   gemma2's local layer (b 1, s 8,192, 16 q / 8 kv heads of 256, window
   4,096, softcap 50), each timed beside its bound, its plain version and
   SDPA where SDPA takes the mask (no softcap; a yardstick only); the
   RMSNorm forward and backward at 4,096 x 3,584 and 4,096 x 6,144; the
   grouped matmul at moonshot's expert products (64 experts, top 6,
   capacity 480: [480, 2048] @ [2048, 1408] and back).
25. The other families' consistency: whisper-small (2 encoder and 2
   decoder layers, batch 2 x 448, context 1,500), llama-3.2-vision-11b (5
   layers, one cross; batch 1 x 512, context 6,404) and gemma2-9b (2
   layers, batch 1 x 512: the window of 4,096 is not reached here; the
   kernel rows and the CPU tests hold it) at full width in f32, every
   zero-initialised leaf (norm scales, ``c_gate``) drawn, the context
   N(0, 1): the card under ``megatron`` without recomputation and
   ``oases`` with fine recomputation against one CPU pass (plain
   versions): loss within 1e-5 relative, every gradient leaf within
   ``grads_err`` 1e-4, launches exactly the count of the code's path, the
   cross and encoder gradients non-zero.
26. The other families' training through the port's ``Trainer`` in bf16:
   whisper-small at full size (12 + 12 layers, batch 16 x 448, context
   1,500) 4 steps under ``megatron`` without recomputation and 4 under
   ``oases`` with fine recomputation; gemma2-9b at full width and 4
   layers (batch 1 x 8,192, longer than the window), llama-3.2-vision-11b
   at full width and 5 layers (batch 2 x 2,048, context 6,404) and
   moonshot-v1-16b-a3b at full width and 2 layers (batch 4 x 1,024), 3
   steps each under ``megatron``: finite losses, every leaf's gradient
   present and finite after step 1, launches a step exactly as worked out
   from the code, step time, tokens/s, peak memory and a one-step profile
   with the share of cuBLAS's f32 products (the head's).
27. The families' serving kernels against their plain versions in f32
   (TF32 off) and bf16: the paged decode's new instances reading a dense
   cache through its block-table view (``dense_flash_decode``) at
   gemma2's layers (hd 256, a group of 2, softcap 50, 8 slots of 2,048),
   recurrentgemma's wrapped local ring (hd 256, 16/1 heads), granite-moe's
   global layers (24/8 heads of 64) and whisper's (1,500 rows, page 15)
   and llama's (6,404 rows, page 4) context reads, each run twice for the
   same bits and timed beside its bound, its plain version and SDPA on
   the same cache (no softcap only); the SSD's final state (mamba2-130m's
   width, 4 x 4096) and the RG-LRU's f32 last state (recurrentgemma-9b's,
   1 x 4096) against ``ssd_chunked`` and the plain recurrence.
28. The families' serving, card (kernels) against CPU (plain versions) in
   f32 at full width from the same perturbed weights: ``lm.prefill``
   then 8 dense decode steps of gemma2-9b (2 layers) and
   recurrentgemma-9b (3), both with the window cut to 96 so the rings
   wrap, mamba2-130m (2), whisper-small (2 + 2, context 1,500),
   llama-3.2-vision-11b (5, context 6,404) and granite-moe-3b-a800m (2):
   every token equal, every state leaf within 1e-4 relative, the card's
   launches exact.
29. The families' serving at full width in bf16: gemma2-9b at full size
   (42 layers) on the dense engine (8 slots, max_seq 2,048, 16 requests
   of 32 new tokens): paged decode launches of steps x 42, a profiled
   window; then ``lm.prefill`` and 16 decode steps of each family arch
   (gemma2-9b 1 x 6,000, past its window; recurrentgemma-9b 1 x 4,096;
   mamba2-130m 4 x 4,096; whisper-small 8 x 448 with its encoder over a
   1,500-row context; llama-3.2-vision-11b 2 x 2,048 with a 6,404-row
   context; granite-moe-3b-a800m 8 x 1,024), all at full depth: exact
   launches of the prefill and of the steps, prefill ms, step ms,
   tokens/s, peak memory and the idle share of 2 profiled steps.

30. Speculative decoding's and TMP decode's kernel rows: the verify's
   read (the paged decode kernel with the 4 queries of each of 8 slots
   folded into its batch, a query at ``pos + j`` seeing the positions up
   to it) at gpt-serve-h4096's shapes (32 heads of 128, 2,048 positions)
   over the dense cache's block-table view and a paged pool (page 16),
   f32 and bf16, twice for the same bits, timed beside its bound (each
   slot's K/V read once; beside it the bound of the folded kernel's
   stream, K/V read once a query row), its plain
   version and SDPA with the offset causal mask on the gathered cache;
   then on 2 rank processes the ``wd`` exit at decode shapes, [8, 1,
   8,192] @ [8,192, 4,096]: the ring kernel over the slot batch (chunks
   of 4 rows in its 128 x 128 tile) against the plain ring, the fused
   exit (the ring and the peer all-gather) and megatron's (torch.matmul
   and the peer all-reduce) against the plain all-reduce, both timed, and
   the peer all-reduce of the exit's output.  When phase 31 runs, its
   1-D TMP decode follows in the same rank processes.
31. Speculative and TMP decode, f32 at full width: gpt-serve-h4096 at 4
   layers on the dense engine (8 slots, 9 requests of 4-11 prompt and 8
   new tokens) undrafted on the card, with the draft gpt-draft-h2048 at 2
   layers (``spec_k`` 3), with the target itself as its draft, and
   undrafted on the CPU (plain versions): every run's tokens the
   undrafted card run's, launches exact (a round: the verify's layers and
   k + 1 draft steps); then at 8 layers the tp=1 card engine against the
   engine on 2 rank processes under ``megatron``, ``oases`` and
   ``fused``, dense and paged, and on 4 in 2-D (1, 2, 2) under ``oases``
   and ``fused``: every rank's tokens tp=1's in as many steps, launches
   exact (``fused``: a ring a layer's exit, in 2-D also one an entry
   product over y), the greedy token's gather every step.
32. Speculative serving at full size in bf16: gpt-serve-h4096 (64
   layers) on the dense engine, 8 slots of 2,048, 16 requests of 16-64
   prompt and 32 new tokens, without and with the draft gpt-draft-h2048
   (12 layers, ``spec_k`` 3): exact launches, rounds, the accept rate,
   tokens a round, decoded tokens/s, step ms, the device ms and idle
   share of 2 profiled steps, peak memory; the two runs' tokens
   compared, any divergence reported with the target's top-2 logit gap
   there (above 0.05: a fault, not a near tie).

``python3 chip_smoke.py --phases 1,8`` runs a subset (development only;
the kernels line then lists what ran).

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

ARCH = "gpt-serve-h4096"
# phase 4's depth: 8 of the 64 layers (full width), cut to make room for
# phases 21-26 in the smoke's time (32 in PRs 25-26; the host-bound step
# takes ~1 ms a layer: 72.74 ms at 64 layers, 33.23 at 32)
SERVE_LAYERS = 8
PAGED_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}
RMS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2 ** -7)}
POOL_TOL = 1e-4          # f32 KV pools, card vs CPU, through 2 layers
# flash attention, kernel vs plain version, (atol, rtol): f32 sums in
# another order (out, lse; gradients sum up to g * s terms); bf16 results
# are cast from f32 in both, so one bf16 ulp (rtol 2**-7)
FLASH_TOL = {"float32": {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-5),
                         "grad": (1e-4, 1e-4)},
             "bfloat16": {"out": (1e-5, 2 ** -7), "lse": (1e-5, 1e-5),
                          "grad": (1e-4, 2 ** -7)}}
# RMSNorm backward: dx as the forward; dscale sums 4096 rows of O(1)
# terms in another order (f32 in both dtypes)
RMS_BWD_TOL = {"float32": {"dx": (1e-5, 1e-5), "dscale": (1e-3, 1e-5)},
               "bfloat16": {"dx": (1e-5, 2 ** -7), "dscale": (1e-3, 1e-5)}}
# kernels that serving (no autograd, tp=1) must never launch
SERVE_ONLY = {"rmsnorm_bwd": 0, "flash_attention": 0,
              "flash_attention_bwd": 0, "tile_matmul": 0,
              "ring_matmul_rs": 0, "peer_all_reduce": 0,
              "peer_all_gather": 0, "peer_reduce_scatter": 0,
              "ring_attention": 0, "ssd": 0, "ssd_bwd": 0, "moe_gmm": 0,
              "rglru": 0, "rglru_bwd": 0}
# the one-device training configuration of phases 6 and 7 (slice 2)
TP1_SCHEDULE = dict(schedule="megatron", remat=False)
TRAIN_ARCH = "gpt-h2048"
LOSS_RTOL = 1e-5         # f32 loss, card vs CPU, 2 layers
GRADS_TOL = 1e-4         # grads_err, card vs CPU
H100_BF16_FLOPS = 989e12  # MFU denominator (dense bf16 peak)
# the serve phase is profiled after this many steps: all 8 slots are then
# active, at positions up to ~470 (mean ~330; the run's longest is 528)
PROFILE_AT = 470
# phase 6's tp=1 card loss and gradients, for phase 9
TP1_REF = ROOT / "build" / "chip_smoke" / "tp1_train_consistency.pt"


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one call over ``iters`` calls, each between two
    CUDA events.  Each call is queued behind a ~1 ms device sleep, so the
    host has enqueued the whole call before the start event runs: the time
    excludes the Python and launch cost of issuing it (which the decode
    step pays on the host; phase 4's profile measures that share)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want, atol: float, rtol: float):
    """(max |got - want|, whether every element is within atol + rtol|want|)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * w.abs()).all())
    return float(diff.max()), ok


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[build] {_build.LIB_NAME} from {sorted(p.name for p in _build.CSRC.glob('*.cu'))} "
          f"in {build_s:.1f} s (nvcc {_build.ARCH_FLAGS[1]})")
    log = (_build.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    tc = _kernel_report(log, _TC_NAMES)
    cc = _kernel_report(log, _CC_NAMES)
    sn = _kernel_report(log, _SSD_NORM_NAMES)
    rg = _kernel_report(log, _RGLRU_NAMES)
    for name, rep in sorted({**tc, **cc, **sn, **rg}.items()):
        print(f"[build] {name}: {rep['spills']}; {rep['usage']}")
    for what, got, want in (("tensor-core", tc, TC_KERNELS),
                            ("paged decode and RMSNorm backward", cc,
                             CC_KERNELS),
                            ("SSD and RMSNorm forward", sn,
                             SSD_NORM_KERNELS),
                            ("RG-LRU", rg, RGLRU_KERNELS)):
        require(sorted(got) == sorted(want),
                f"ptxas reported {what} kernels {sorted(got)}, expected "
                f"{sorted(want)}")
        spilled = [n for n, rep in got.items()
                   if rep["spill_stores"] or rep["spill_loads"]]
        require(not spilled, f"{what} kernels spill: {spilled}")
    card = _card()
    print(card)
    return {"build_s": build_s, "card": card, "tc_kernels": tc,
            "cuda_core_kernels": cc, "ssd_norm_kernels": sn,
            "rglru_kernels": rg}


# the tensor-core kernels by instance: the flash forward (flash_fwd_tc.cuh)
# and the flash backward's dK/dV and dQ kernels (flash_bwd_tc.cuh) at every
# head dim, the ring at the ring's; the GEMM tile (gemm_tc.cuh) at both
# widths in the grouped matmul at its three operand layouts (<BN, A
# MN-major, B K-major>: forward, dw, dx) and in the tile matmul, and at
# 128 in the ring
TC_KERNELS = ([f"{k}<{hd}>" for k in ("flash_fwd_tc_kernel",
                                      "flash_bwd_dkdv_tc_kernel",
                                      "flash_bwd_dq_tc_kernel")
               for hd in (32, 64, 128, 256)]
              + [f"ring_attn_tc_kernel<{hd}>" for hd in (32, 64, 128)]
              + [f"moe_gmm_tc_kernel<{bn},{ta},{tb}>" for bn in (128, 256)
                 for ta, tb in ((0, 0), (1, 0), (0, 1))]
              + [f"tile_matmul_tc_kernel<{bn}>" for bn in (128, 256)]
              + ["ring_mm_rs_tc_kernel<128>"])
_TC_NAMES = ("flash_fwd_tc_kernel|flash_bwd_dkdv_tc_kernel|"
             "flash_bwd_dq_tc_kernel|ring_attn_tc_kernel|moe_gmm_tc_kernel|"
             "tile_matmul_tc_kernel|ring_mm_rs_tc_kernel")
# the CUDA-core kernels redesigned in the tenth slice, by instance: the
# paged decode <dtype, hd, group> (hd 256 and groups 3 and 16 since the
# eighteenth slice) and the RMSNorm backward <dtype, 16-byte loads> and
# its wide-row form <dtype>
CC_KERNELS = ([f"paged_decode_kernel<{t},{hd},{g}>" for t in ("f32", "bf16")
               for hd in (32, 64, 128, 256) for g in (1, 2, 3, 4, 8, 16)]
              + [f"rmsnorm_bwd_kernel<{t},{v}>" for t in ("f32", "bf16")
                 for v in (0, 1)]
              + [f"rmsnorm_bwd_wide_kernel<{t}>" for t in ("f32", "bf16")])
_CC_NAMES = "paged_decode_kernel|rmsnorm_bwd_kernel|rmsnorm_bwd_wide_kernel"
# the kernels redesigned in the eleventh slice, by instance: the SSD's
# chunk-tile kernels <dtype> (ssd_tile.cuh: mma.sync in bf16, CUDA cores in
# f32; the state kernel <dtype, backward>) and the RMSNorm forward <dtype,
# 16-byte loads> and its wide-row form <dtype>
SSD_NORM_KERNELS = (
    [f"{k}<{t}>" for k in ("ssd_cb_kernel", "ssd_out_kernel",
                           "ssd_bwd_chunk_kernel", "ssd_bwd_reduce_kernel",
                           "rmsnorm_wide_kernel")
     for t in ("f32", "bf16")]
    + [f"{k}<{t},{v}>" for k in ("ssd_state_kernel", "rmsnorm_kernel")
       for t in ("f32", "bf16") for v in (0, 1)])
_SSD_NORM_NAMES = ("ssd_cb_kernel|ssd_state_kernel|ssd_out_kernel|"
                   "ssd_bwd_chunk_kernel|ssd_bwd_reduce_kernel|"
                   "rmsnorm_kernel|rmsnorm_wide_kernel")
# the RG-LRU kernels redesigned in the twelfth slice, by instance: the
# forward and backward <dtype> (a block owns 32 channels of a batch row
# for the whole sequence) and the backward's batch-row sum <gate vectors>
RGLRU_KERNELS = ([f"rglru_{k}_kernel<{t}>" for k in ("fwd", "bwd")
                  for t in ("f32", "bf16")] + ["rglru_sum_kernel<5>"])
_RGLRU_NAMES = "rglru_fwd_kernel|rglru_bwd_kernel|rglru_sum_kernel"
_MANGLED_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16"}


def _instance(mangled: str, names: str):
    """``name<args>`` of a mangled kernel template instance whose name is
    one of ``names`` (a regex alternation), else None."""
    k = re.search(rf"\d({names})I(f|13__nv_bfloat16)?((?:L[ib]\d+E)*)E",
                  mangled)
    if not k:
        return None
    args = [_MANGLED_TYPES[k.group(2)]] if k.group(2) else []
    args += re.findall(r"L[ib](\d+)E", k.group(3))
    return f"{k.group(1)}<{','.join(args)}>"


def _kernel_report(log: str, names: str) -> dict:
    """ptxas's lines (``-Xptxas -v``) for each instance of the kernels
    ``names`` (a regex alternation): stack and spill bytes, registers and
    static shared memory."""
    rep, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _instance(m.group(1), names)
            if cur:
                rep[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rep[cur].update(spills=line.strip(), spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        if "Used" in line and "registers" in line:
            rep[cur]["usage"] = line.split(":", 1)[1].strip()
            cur = None
    return rep


def _paged_inputs(*, b, h, kvh, hd, page, nb, dtype, pos, inactive, seed,
                  offset=0):
    """``offset``: the K/V pools start that many elements into their
    storage (contiguous, but not 16-byte aligned for offset 1)."""
    import torch
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    npages = b * nb + 1
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn(npages, page, kvh, hd, generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    if offset:
        kp, vp = (torch.empty(t.numel() + offset, dtype=dtype, device=dev)
                  [offset:].view(t.shape).copy_(t) for t in (kp, vp))
    perm = torch.randperm(npages - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(b, nb).to(torch.int32)
    if inactive is not None:
        tables[inactive] = 0
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, kp, vp, tables.contiguous(), pos_t


def _paged_bound_ms(q, kp, tables, pos, page, dtype_name):
    """Bytes: each distinct K/V row (page, offset) that a slot maps at a
    position <= pos, read once (an inactive slot's all-zero table maps
    only rows of null page 0), plus q, out, tables and pos.  Operations:
    q.k and p.v over every position <= pos of every slot."""
    import torch
    b, _, h, hd = q.shape
    kvh = kp.shape[2]
    nb = tables.shape[1]
    elt = q.element_size()
    rows, positions = [], 0
    for s, p in enumerate(pos.tolist()):
        n = min(int(p), nb * page - 1) + 1
        t = torch.arange(n, device=tables.device)
        rows.append(tables[s, t // page].long() * page + t % page)
        positions += n
    distinct = int(torch.unique(torch.cat(rows)).numel())
    nbytes = (2 * distinct * kvh * hd * elt + 2 * q.numel() * elt
              + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * positions * h * hd
    return (*_bound(nbytes, flops, dtype_name), distinct)


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (paged_flash_decode,
                                                     paged_splits)

    results = {"paged_decode": [], "rmsnorm": []}
    page, nb, b = 16, 128, 8
    mixed = dict(pos=[0, 15, 16, 1023, 1024, 2047, 777, 1500], inactive=6)
    cases = [
        dict(name="main", h=32, kvh=32, hd=128, softcap=0.0, **mixed),
        dict(name="gqa", h=32, kvh=8, hd=64, softcap=0.0, **mixed),
        dict(name="softcap", h=32, kvh=32, hd=128, softcap=30.0, **mixed),
        dict(name="gqa_g2_hd32", h=32, kvh=16, hd=32, softcap=0.0, **mixed),
        dict(name="gqa_g8", h=64, kvh=8, hd=128, softcap=0.0, **mixed),
        # every slot at the last position: the most work a call can hold
        dict(name="full", h=32, kvh=32, hd=128, softcap=0.0,
             pos=[nb * page - 1] * b, inactive=None),
        # the serve phase's profiled step (PROFILE_AT): 8 active slots,
        # positions up to 470, mean 334
        dict(name="serve", h=32, kvh=32, hd=128, softcap=0.0,
             pos=[470, 436, 402, 368, 300, 266, 232, 198], inactive=None),
        # K/V pools one element off 16-byte alignment: element copies in
        # place of cp.async
        dict(name="unaligned", h=32, kvh=8, hd=64, softcap=0.0, offset=1,
             **mixed),
    ]
    for case in cases:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, kp, vp, tables, pos_t = _paged_inputs(
                b=b, h=case["h"], kvh=case["kvh"], hd=case["hd"],
                page=page, nb=nb, dtype=dtype, pos=case["pos"],
                inactive=case["inactive"], seed=1,
                offset=case.get("offset", 0))
            sc = case["softcap"]
            out = paged_flash_decode(q, kp, vp, tables, pos_t, softcap=sc)
            again = paged_flash_decode(q, kp, vp, tables, pos_t, softcap=sc)
            want = ref.paged_decode_attention_ref(q, kp, vp, tables, pos_t,
                                                  softcap=sc)
            torch.cuda.synchronize()
            # the splits merge in a fixed order: a second run gives the
            # same bits
            require(torch.equal(out, again),
                    f"paged_decode {case['name']} {dname}: two runs differ")
            atol, rtol = PAGED_TOL[dname]
            err, ok = max_err(out, want, atol, rtol)
            row = dict(case=case["name"], dtype=dname, b=b, h=case["h"],
                       kvh=case["kvh"], hd=case["hd"], page=page, nb=nb,
                       pos=case["pos"], splits=paged_splits(
                           b, case["kvh"], page, nb)[1],
                       softcap=sc, max_abs_err=err, atol=atol, rtol=rtol)
            row["ms"] = time_ms(lambda: paged_flash_decode(
                q, kp, vp, tables, pos_t, softcap=sc))
            row["plain_ms"] = time_ms(lambda: ref.paged_decode_attention_ref(
                q, kp, vp, tables, pos_t, softcap=sc), iters=20)
            row["bound_ms"], row["bound_by"], row["kv_rows"] = (
                _paged_bound_ms(q, kp, tables, pos_t, page, dname))
            row["library_ms"] = None
            if sc == 0.0:
                # yardstick: one SDPA call on the KV already gathered
                # (gather untimed); the g query heads of a kv head are its
                # g query rows, so GQA needs no repeated KV
                kvh, g, hd = case["kvh"], case["h"] // case["kvh"], case["hd"]
                kg = ref.gather_pages(kp, tables).transpose(1, 2)
                vg = ref.gather_pages(vp, tables).transpose(1, 2)
                qh = q.reshape(b, kvh, g, hd)
                mask = (torch.arange(kg.shape[2], device="cuda")[None, :]
                        <= pos_t.long()[:, None])[:, None, None, :]
                lib_out = F.scaled_dot_product_attention(qh, kg, vg,
                                                         attn_mask=mask)
                row["library_err"] = float(
                    (lib_out.reshape(want.shape).float() - want.float())
                    .abs().max())
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qh, kg, vg, attn_mask=mask))
                del kg, vg
            print(f"[paged_decode] {json.dumps(row)}")
            require(ok, f"paged_decode {case['name']} {dname}: max abs err "
                        f"{err} beyond atol {atol} + rtol {rtol}")
            results["paged_decode"].append(row)
            del q, kp, vp, out, again, want

    for rows in (8, 8192):
        for dname in ("float32", "bfloat16"):
            results["rmsnorm"].append(_rmsnorm_row(rows, 4096, dname))
    return results


def _rmsnorm_row(rows: int, d: int, dname: str) -> dict:
    """The RMSNorm forward kernel on [rows, d] against its plain version,
    timed beside its bound, the plain version and ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import fwd_geometry, rmsnorm

    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3).to(dtype)
    s = torch.randn(d, generator=gen, device="cuda") * 0.1
    out = rmsnorm(x, s, eps=1e-5)
    want = ref.rmsnorm_ref(x, s, 1e-5)
    torch.cuda.synchronize()
    atol, rtol = RMS_TOL[dname]
    err, ok = max_err(out, want, atol, rtol)
    w = (1.0 + s).to(dtype)
    from repro_torch.kernels.bounds import rmsnorm_work
    bound = _bound(*rmsnorm_work(rows, d, x.element_size()), dname)
    row = dict(rows=rows, d=d, dtype=dname,
               geometry=fwd_geometry(rows, d, x.element_size()),
               max_abs_err=err, atol=atol,
               rtol=rtol, ms=time_ms(lambda: rmsnorm(x, s, eps=1e-5)),
               plain_ms=time_ms(lambda: ref.rmsnorm_ref(x, s, 1e-5)),
               bound_ms=bound[0], bound_by=bound[1],
               library_ms=time_ms(lambda: F.rms_norm(x, (d,), weight=w,
                                                     eps=1e-5)))
    print(f"[rmsnorm] {json.dumps(row)}")
    require(ok, f"rmsnorm rows={rows} d={d} {dname}: max abs err {err} "
                f"beyond atol {atol} + rtol {rtol}")
    return row


def _consistency_requests(np, vocab):
    """8 requests over 4 slots; even ones share a 20-token prefix (it ends
    mid-block with page 16), so the second wave hits and copies on write."""
    rng = np.random.default_rng(11)
    shared = rng.integers(3, vocab, 20).astype(np.int32)
    out = []
    for i in range(8):
        tail = rng.integers(3, vocab, int(rng.integers(3, 12))).astype(np.int32)
        out.append(np.concatenate([shared, tail]) if i % 2 == 0 else tail)
    return out


def phase_consistency():
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(ARCH).replace(num_layers=2, dtype="float32")
    params_cpu = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    params_gpu = {"blocks": [{k: v.to("cuda") for k, v in
                              params_cpu["blocks"][0].items()}],
                  **{k: params_cpu[k].to("cuda")
                     for k in ("embed", "final_ln", "lm_head")}}
    prompts = _consistency_requests(np, cfg.vocab_size)
    runs = {}
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(cfg, slots=4, max_seq=128, paged=True,
                            page_size=16, prefix_cache=True, device=dev)
        eng.load(params=params)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        _build.reset_launches()
        t0 = time.perf_counter()
        stats = eng.run_until_drained()
        runs[dev] = dict(eng=eng, reqs=reqs, stats=stats,
                         launches=dict(_build.LAUNCHES),
                         s=time.perf_counter() - t0)
    g, c = runs["cuda"], runs["cpu"]
    steps = g["stats"]["steps"]
    require(g["launches"] == {**SERVE_ONLY, "paged_decode": steps * 2,
                              "rmsnorm": steps * 5},
            f"card run launched {g['launches']} in {steps} steps")
    require(not any(c["launches"].values()),
            f"CPU run launched kernels: {c['launches']}")
    for rg, rc in zip(g["reqs"], c["reqs"]):
        require(rg.done and rc.done and rg.out_tokens == rc.out_tokens,
                f"request {rg.rid}: card tokens {rg.out_tokens} != CPU "
                f"tokens {rc.out_tokens}")
    require(g["eng"].stats == c["eng"].stats,
            f"stats differ: {g['eng'].stats} vs {c['eng'].stats}")
    require(g["stats"]["prefix_hits"] >= 1 and g["stats"]["paged"]["cow"] >= 1,
            f"consistency run did not exercise prefix reuse and COW: "
            f"{g['stats']}")
    pool_err = 0.0
    for key in ("k", "v"):
        a = g["eng"].state["blocks"][0][key][:, 1:].cpu()
        b = c["eng"].state["blocks"][0][key][:, 1:]
        pool_err = max(pool_err, float((a - b).abs().max()))
    require(pool_err <= POOL_TOL,
            f"KV pools differ by {pool_err} (tolerance {POOL_TOL})")
    out = dict(layers=cfg.num_layers, d_model=cfg.d_model, dtype="float32",
               steps=g["stats"]["steps"], prefix_hits=g["stats"]["prefix_hits"],
               cow=g["stats"]["paged"]["cow"], pool_max_abs_err=pool_err,
               pool_tol=POOL_TOL, tokens=[r.out_tokens for r in g["reqs"]],
               card_s=g["s"], cpu_s=c["s"])
    print(f"[consistency] {json.dumps(out)}")
    return out


def _serve_requests(np, vocab, n=16):
    """Prompts of 64-512 tokens; even requests share a 256-token prefix."""
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab, 256).astype(np.int32)
    out = []
    for i in range(n):
        if i % 2 == 0:
            tail = rng.integers(3, vocab, int(rng.integers(16, 257)))
            out.append(np.concatenate([shared, tail.astype(np.int32)]))
        else:
            out.append(rng.integers(3, vocab, int(rng.integers(64, 513)))
                       .astype(np.int32))
    return out


def phase_serve():
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.obs import Recorder
    from repro_torch.serving import Request, ServingEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ARCH).replace(num_layers=SERVE_LAYERS)
    tel = tempfile.TemporaryDirectory()
    rec = Recorder(tel.name)
    eng = ServingEngine(cfg, slots=8, max_seq=2048, paged=True,
                        page_size=16, prefix_cache=True, telemetry=rec)
    require(eng.device.type == "cuda", f"engine chose {eng.device}")
    t0 = time.perf_counter()
    eng.load(seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(_serve_requests(np, cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run_until_drained(max_steps=PROFILE_AT)
    profile, profiled = _profile_steps(eng)
    stats = eng.run_until_drained()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = stats["steps"]
    rec.close()
    telemetry = _check_serve_telemetry(tel.name, eng, stats, len(reqs))
    tel.cleanup()
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg.num_layers
    require(launches["paged_decode"] == steps * n_layers,
            f"paged_decode launched {launches['paged_decode']} times in "
            f"{steps} steps (expected {steps * n_layers})")
    require(launches["rmsnorm"] == steps * (2 * n_layers + 1),
            f"rmsnorm launched {launches['rmsnorm']} times in {steps} steps "
            f"(expected {steps * (2 * n_layers + 1)})")
    require(all(launches[k] == 0 for k in SERVE_ONLY),
            f"serving launched training kernels: {launches}")
    vp = cfg.padded_vocab()
    for r in reqs:
        require(r.done and 1 <= len(r.out_tokens) <= 32
                and all(0 <= t < vp for t in r.out_tokens),
                f"request {r.rid}: done={r.done} tokens={r.out_tokens}")
    for key in ("k", "v"):
        pool = eng.state["blocks"][0][key]
        for i in range(n_layers):
            require(bool(torch.isfinite(pool[i]).all()),
                    f"non-finite {key} pool in layer {i}")
    # the profiled steps are slowed by the profiler: left out of the
    # per-step times (they stay in the wall)
    step_ms = [1e3 * s for i, s in enumerate(eng.step_s)
               if i not in range(*profiled)]
    out = dict(arch=ARCH, dtype=cfg.dtype, layers=n_layers,
               d_model=cfg.d_model, slots=8, max_seq=2048, page_size=16,
               pages=eng.paged.pages, requests=len(reqs),
               prompt_tokens=stats["prompt_tokens"],
               decoded_tokens=stats["decoded_tokens"], steps=steps,
               prefix_hits=stats["prefix_hits"],
               prefix_hit_tokens=stats["prefix_hit_tokens"],
               cow=stats["paged"]["cow"], wall_s=wall_s,
               decoded_tok_per_s=stats["decoded_tokens"] / wall_s,
               step_ms_median=statistics.median(step_ms),
               step_ms_p10=float(np.percentile(step_ms, 10)),
               step_ms_p90=float(np.percentile(step_ms, 90)),
               load_s=load_s, peak_mem_gb=peak / 1e9, launches=launches,
               sample_output=reqs[0].out_tokens[:8], telemetry=telemetry)
    print(f"[serve] {json.dumps(out)}")
    print(f"[profile] {json.dumps(profile)}")
    out["profile"] = profile
    return out


def _check_serve_telemetry(path, eng, stats, n_requests) -> dict:
    """The engine's JSONL (``serving.*``, JAX's names) against the phase's
    own numbers: every line validates, the ``serving.decoded_tokens`` sum
    is the decoded tokens, ``serving.decode_step_s`` holds the engine's
    step times one for one, ``serving.ttft_s`` one sample a request."""
    from repro_torch.obs import report, schema
    with open(Path(path) / "telemetry.jsonl") as f:
        records = schema.validate_lines(f)
    by = {}
    for r in records:
        by.setdefault(r["name"], []).append(r)
    decoded = sum(r["value"] for r in by.get("serving.decoded_tokens", ()))
    steps = [r["value"] for r in by.get("serving.decode_step_s", ())]
    ttft = [r["value"] for r in by.get("serving.ttft_s", ())]
    require(decoded == stats["decoded_tokens"],
            f"serving.decoded_tokens sums to {decoded}, the engine decoded "
            f"{stats['decoded_tokens']}")
    require(steps == eng.step_s, f"serving.decode_step_s holds "
            f"{len(steps)} samples, the engine timed {len(eng.step_s)} "
            f"steps (or their values differ)")
    require(len(ttft) == n_requests and sorted(
        r["tags"]["rid"] for r in by["serving.ttft_s"]) == list(
            range(n_requests)),
            f"serving.ttft_s: {len(ttft)} samples for {n_requests} requests")
    return dict(records=len(records),
                names=sorted(by), decode_step_samples=len(steps),
                ttft_s_median=statistics.median(ttft),
                ttft_s_max=max(ttft),
                admission_deferred=sum(r["value"] for r in by.get(
                    "serving.admission_deferred", ())),
                report_lines=len(report.render(records).splitlines()))


def _profile_steps(eng, steps: int = 4):
    """Where a decode step's time goes, at the serve phase's own positions:
    host wall per step over ``steps`` steps run plainly, then the device
    time of the kernels launched by the next ``steps`` steps under
    ``torch.profiler``.  ``idle_share`` = 1 - device / wall, with the wall
    of the plain steps.  Returns the summary and the range of
    ``eng.step_s`` the profiler slowed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    at_step = eng.stats["steps"]
    act = [int(eng.pos[s]) for s in range(eng.slots)
           if eng.active[s] is not None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    n0 = len(eng.step_s)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_prof_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = _device_kernels(prof)
    device_ms = sum(k[0] for k in kernels) / 1e3 / steps
    return dict(
        at_step=at_step, steps=steps, active_slots=len(act),
        positions_mean=sum(act) / max(len(act), 1),
        positions_max=max(act, default=0),
        wall_ms_per_step=wall_ms,
        wall_ms_per_step_profiled=wall_prof_ms,
        device_ms_per_step=device_ms if kernels else "not measured",
        idle_share=(1 - device_ms / wall_ms) if kernels
        else "not measured",
        launches_per_step=sum(k[1] for k in kernels) / steps,
        by_kernel_ms_per_step={k: v / steps for k, v in
                               _named_ms(kernels).items()},
        top=[dict(name=k[2][:90], ms_per_step=k[0] / 1e3 / steps,
                  calls_per_step=k[1] / steps) for k in kernels[:14]]
    ), (n0, n0 + steps)


# the profiler ranges the port opens (obs.phase_scope, obs.trace_annotation):
# on the device timeline they are spans, not kernels
_RANGE_RE = re.compile(
    r"^(tmp\.|train_step$|engine_tick$|spec_draft$|spec_verify$)")


def _device_kernels(prof) -> list:
    """(device us, calls, name) of each kernel in a profile, most time
    first; the ranges' own device spans (user annotations) left out."""
    from torch.autograd import DeviceType
    kernels = []
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or _RANGE_RE.match(evt.key)):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us, evt.count, evt.key))
    kernels.sort(reverse=True)
    return kernels


def _range_ms(prof, device_ms) -> dict:
    """Device ms of the kernels launched inside each ``tmp.<schedule>.*``
    range (the innermost range holding a launch takes it), forward (the
    thread of the ``train_step`` range) and backward (the autograd
    engine's thread, which also replays the forward under recomputation),
    and the share of ``device_ms`` inside none.  ``linked_ms``: the
    device ms the profiler tied to any host event (a kernel it did not
    tie counts as outside every range)."""
    from torch.autograd import DeviceType
    evts = prof.events()
    main = {e.thread for e in evts if e.name == "train_step"}
    ranges, inside, linked = {}, 0.0, 0.0
    for e in evts:
        if e.device_type != DeviceType.CPU:
            continue
        us = sum(k.duration for k in getattr(e, "kernels", ())
                 if not _RANGE_RE.match(k.name))
        if not us:
            continue
        linked += us / 1e3
        a = e
        while a is not None and not a.name.startswith("tmp."):
            a = a.cpu_parent
        if a is None:
            continue
        key = f"{a.name} {'fwd' if e.thread in main else 'bwd'}"
        ranges[key] = ranges.get(key, 0.0) + us / 1e3
        inside += us / 1e3
    return dict(by_range_ms=dict(sorted(ranges.items())), inside_ms=inside,
                linked_ms=linked,
                outside_share=(1 - inside / device_ms) if device_ms
                else "not measured")


# the port's kernels a profile sums by name (the CUDA kernels' own names)
PROFILED_KERNELS = ("paged_decode_kernel", "rmsnorm_kernel",
                    "rmsnorm_bwd_kernel", "rmsnorm_bwd_reduce_kernel",
                    "ssd_cb_kernel", "ssd_state_kernel", "ssd_scan_kernel",
                    "ssd_out_kernel", "ssd_bwd_chunk_kernel",
                    "ssd_bwd_reduce_kernel", "ssd_bwd_head_kernel")


def _named_ms(kernels) -> dict:
    """Device ms of each of ``PROFILED_KERNELS`` in a profile's (us, count,
    name) list."""
    return {n: sum(k[0] for k in kernels
                   if re.search(rf"\b{n}\b", k[2])) / 1e3
            for n in PROFILED_KERNELS}


def _bound(nbytes, flops, dname):
    """(ms, "bytes" or "operations"): the H100's least time for the work
    (``repro_torch.kernels.bounds``, the data sheet's peaks)."""
    from repro_torch.kernels.bounds import bound
    return bound(nbytes, flops, dname)


def _check_all(name, pairs, tol):
    """pairs: {label: (got, want)}; tol: {label: (atol, rtol)} -> errors."""
    errs = {}
    for label, (got, want) in pairs.items():
        atol, rtol = tol[label]
        errs[label], ok = max_err(got, want, atol, rtol)
        require(ok, f"{name} {label}: max abs err {errs[label]} beyond "
                    f"atol {atol} + rtol {rtol}")
    return errs


FLASH_CASES = [
    dict(name="main", b=4, s=1024, h=32, kvh=32, hd=64),
    dict(name="gqa", b=4, s=1024, h=16, kvh=8, hd=128),
    dict(name="softcap_window", b=4, s=1024, h=32, kvh=32, hd=64,
         softcap=30.0, window=256),
    dict(name="ragged", b=4, s=1000, h=32, kvh=32, hd=64),
    # granite-moe-3b-a800m's heads: 24 q / 8 kv of 64, a group of 3
    dict(name="gqa3", b=4, s=1024, h=24, kvh=8, hd=64),
    # head dim 32 (the tensor-core tile's 64-byte swizzle), a group of 4
    dict(name="hd32", b=4, s=1024, h=16, kvh=4, hd=32),
    # the ragged edge (s not a multiple of the 64-row tile) at the other
    # head dims, and s under one tile with a window and a softcap
    dict(name="ragged32", b=4, s=1000, h=16, kvh=4, hd=32),
    dict(name="ragged128", b=4, s=1000, h=16, kvh=8, hd=128, window=300),
    dict(name="short", b=4, s=40, h=16, kvh=8, hd=128, softcap=30.0,
         window=16),
]
# bf16 only: rows of 8192 keys, 128 key tiles, that the forward and the dQ
# block each sum in one tensor-core accumulator (dK/dV fold each q tile
# into an IEEE f32 sum), held to the f32 plain version under FLASH_TOL
FLASH_LONG_CASES = [dict(name="long", b=1, s=8192, h=4, kvh=4, hd=128)]


# (case name, dtype) -> the rows of _flash_rows, so a case that two phases
# report (granite's group 3: phases 5 and 14) is checked and timed once
_FLASH_ROWS = {}


def _flash_rows(case, dname):
    """The flash forward and backward kernels at one case and dtype against
    their plain versions, timed beside their bounds, the plain versions
    and (without softcap; a window or an offset causal band as a mask)
    SDPA: -> (forward row, backward row).  A case gives b, s (the keys), h,
    kvh, hd and optionally sq (the queries, default s), causal (default
    True), window, softcap, iters (timed calls, default 30) and
    plain_iters (the plain versions', default 10).  A case already run in
    this process returns its rows."""
    if (case["name"], dname) in _FLASH_ROWS:
        return _FLASH_ROWS[case["name"], dname]
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.bounds import flash_work, visible_pairs
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)

    b, s_, h, kvh, hd = (case[k] for k in ("b", "s", "h", "kvh", "hd"))
    sq = case.get("sq", s_)
    iters, plain_iters = case.get("iters", 30), case.get("plain_iters", 10)
    kw = dict(causal=case.get("causal", True), window=case.get("window"),
              softcap=case.get("softcap", 0.0))
    plain_lib = not kw["softcap"]
    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, dout = (torch.randn(b, sq, h, hd, generator=gen,
                           device="cuda").to(dtype)
               for _ in range(2))
    k, v = (torch.randn(b, s_, kvh, hd, generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want_grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                             **kw)
    torch.cuda.synchronize()
    # no atomics: a second run gives the same bits
    require(all(torch.equal(a, b) for a, b in zip(grads, again)),
            f"flash_bwd {case['name']} {dname}: two runs differ")
    tol = FLASH_TOL[dname]
    ferr = _check_all(f"flash {case['name']} {dname}",
                      {"out": (out, want_out),
                       "lse": (lse, want_lse)},
                      {"out": tol["out"], "lse": tol["lse"]})
    berr = _check_all(f"flash_bwd {case['name']} {dname}",
                      dict(zip(("dq", "dk", "dv"),
                               zip(grads, want_grads))),
                      {g: tol["grad"] for g in ("dq", "dk", "dv")})
    head_pairs = visible_pairs(sq, kw["window"], sk=s_, causal=kw["causal"])
    pairs = head_pairs * b * h
    fwd_work, bwd_work = flash_work(b, sq, h, kvh, hd, head_pairs,
                                    q.element_size(), sk=s_)
    fwd_bound = _bound(*fwd_work, dname)
    bwd_bound = _bound(*bwd_work, dname)
    common = dict(case=case["name"], dtype=dname, b=b, s=s_, h=h,
                  kvh=kvh, hd=hd, window=kw["window"],
                  softcap=kw["softcap"], visible_pairs=pairs)
    if sq != s_ or not kw["causal"]:
        common.update(sq=sq, causal=kw["causal"])
    frow = dict(common, max_abs_err=max(ferr.values()), errs=ferr,
                tol=tol["out"],
                ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                           iters=iters),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(
                    q, k, v, **kw), iters=plain_iters),
                bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                library_ms=None)
    brow = dict(common, max_abs_err=max(berr.values()), errs=berr,
                tol=tol["grad"],
                ms=time_ms(lambda: flash_attention_bwd(
                    q, k, v, out, lse, dout, **kw), iters=iters),
                plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, out, lse, dout, **kw), iters=plain_iters),
                bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                library_ms=None)
    if plain_lib:
        # yardstick: SDPA in its own [b, h, s, hd] layout
        # (transposes untimed); backward alone via retain_graph
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, dout))
        sdpa = dict(is_causal=kw["causal"], enable_gqa=kvh != h)
        if kw["causal"] and (kw["window"] is not None or sq != s_):
            # the causal band (queries at arange(sq), keys at
            # arange(sk)) as a mask
            i = torch.arange(sq, device="cuda")[:, None]
            j = torch.arange(s_, device="cuda")[None, :]
            band = j <= i
            if kw["window"] is not None:
                band &= j > i - kw["window"]
            sdpa = dict(attn_mask=band, enable_gqa=kvh != h)
        frow["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   **sdpa), iters=iters)
        qg, kg, vg = (t.detach().requires_grad_()
                      for t in (qt, kt, vt))
        lo = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
        frow["library_err"] = float(
            (lo.detach().transpose(1, 2).float()
             - want_out.float()).abs().max())
        brow["library_ms"] = time_ms(lambda: torch.autograd.grad(
            lo, (qg, kg, vg), dot, retain_graph=True), iters=iters)
        del qt, kt, vt, dot, qg, kg, vg, lo
    print(f"[flash_attention] {json.dumps(frow)}")
    print(f"[flash_attention_bwd] {json.dumps(brow)}")
    del q, k, v, dout, out, lse, want_out, want_lse, grads, again, want_grads
    torch.cuda.empty_cache()
    _FLASH_ROWS[case["name"], dname] = frow, brow
    return frow, brow


def phase_train_kernels():
    results = {"flash_attention": [], "flash_attention_bwd": [],
               "rmsnorm": [], "rmsnorm_bwd": []}
    for case in FLASH_CASES:
        for dname in ("float32", "bfloat16"):
            frow, brow = _flash_rows(case, dname)
            results["flash_attention"].append(frow)
            results["flash_attention_bwd"].append(brow)
    for case in FLASH_LONG_CASES:
        frow, brow = _flash_rows(case, "bfloat16")
        results["flash_attention"].append(frow)
        results["flash_attention_bwd"].append(brow)

    # the training path's norms: x [b*s, d] = [4096, 2048], forward and
    # backward; the forward also at mamba2's widths (its ln 768 and
    # norm_g 1536: several rows a block), the backward at the other
    # models' widths (granite's and mamba2's inner 1536, recurrentgemma's
    # 4096) and at RMS_BWD_SHAPES' other two
    for dname in ("float32", "bfloat16"):
        for d in RMS_FWD_WIDTHS:
            results["rmsnorm"].append(_rmsnorm_row(4096, d, dname))
        for rows, d in RMS_BWD_SHAPES:
            results["rmsnorm_bwd"].append(_rmsnorm_bwd_row(rows, d, dname))
    return results


# the forward's training widths at 4096 rows: gpt-h2048's d, then mamba2's
RMS_FWD_WIDTHS = (2048, 1536, 768)
# the training widths, a ragged d (scalar loads, masked columns) and a
# row wider than a group's registers hold (a block a row)
RMS_BWD_SHAPES = [(4096, 2048), (4096, 1536), (4096, 4096), (1000, 1001),
                  (1024, 8192)]


def _rmsnorm_bwd_row(rows: int, d: int, dname: str) -> dict:
    """The RMSNorm backward kernel on [rows, d] against its plain version,
    run twice (the bits must agree), timed beside its bound, the plain
    version and autograd of ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import bwd_geometry, rmsnorm_bwd

    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3).to(dtype)
    dy = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    sc = torch.randn(d, generator=gen, device="cuda") * 0.1
    dx, dsc = rmsnorm_bwd(x, sc, dy, eps=1e-5)
    dx2, dsc2 = rmsnorm_bwd(x, sc, dy, eps=1e-5)
    want_dx, want_dsc = ref.rmsnorm_bwd_ref(x, sc, dy, 1e-5)
    torch.cuda.synchronize()
    # no atomics: a second run gives the same bits
    require(torch.equal(dx, dx2) and torch.equal(dsc, dsc2),
            f"rmsnorm_bwd {rows} x {d} {dname}: two runs differ")
    errs = _check_all(f"rmsnorm_bwd {rows} x {d} {dname}",
                      {"dx": (dx, want_dx), "dscale": (dsc, want_dsc)},
                      RMS_BWD_TOL[dname])
    elt = x.element_size()
    from repro_torch.kernels.bounds import rmsnorm_bwd_work
    bound = _bound(*rmsnorm_bwd_work(rows, d, elt), dname)
    xr = x.detach().requires_grad_()
    sr = sc.detach().requires_grad_()
    ly = F.rms_norm(xr, (d,), weight=(1.0 + sr).to(dtype), eps=1e-5)
    row = dict(rows=rows, d=d, dtype=dname, geometry=bwd_geometry(rows, d),
               max_abs_err=max(errs.values()), errs=errs,
               tol=RMS_BWD_TOL[dname],
               ms=time_ms(lambda: rmsnorm_bwd(x, sc, dy, eps=1e-5)),
               plain_ms=time_ms(lambda: ref.rmsnorm_bwd_ref(
                   x, sc, dy, 1e-5)),
               bound_ms=bound[0], bound_by=bound[1],
               library_ms=time_ms(lambda: torch.autograd.grad(
                   ly, (xr, sr), dy, retain_graph=True)))
    print(f"[rmsnorm_bwd] {json.dumps(row)}")
    return row


def grads_err(g1: dict, g2: dict) -> float:
    """``tests/_scripts/runner.py:174``: per leaf, max abs difference over
    the max abs value of ``g1``; the worst leaf."""
    return max(float((g1[k] - g2[k]).abs().max())
               / (float(g1[k].abs().max()) + 1e-8) for k in g1)


def phase_train_consistency():
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.models import params as prm

    cfg = get_config(TRAIN_ARCH).replace(num_layers=2, dtype="float32")
    base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    batch = make_batch(DataConfig(global_batch=2, seq_len=256,
                                  vocab_size=cfg.vocab_size), 0)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = prm.unflatten({k: t.to(dev).requires_grad_() for k, t in
                                 prm.flatten(base).items()})
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _build.reset_launches()
        t0 = time.perf_counter()
        loss, _ = lm.train_loss(cfg, params, tb,
                                TrainHParams(**TP1_SCHEDULE))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = dict(loss=loss.item(), s=time.perf_counter() - t0,
                         launches=dict(_build.LAUNCHES),
                         grads={k: t.grad.detach().cpu() for k, t in
                                prm.flatten(params).items()})
    g, c = runs["cuda"], runs["cpu"]
    n = cfg.num_layers
    want = {**SERVE_ONLY, "paged_decode": 0, "rmsnorm": 2 * n + 1,
            "rmsnorm_bwd": 2 * n + 1, "flash_attention": n,
            "flash_attention_bwd": n}
    require(g["launches"] == want,
            f"card pass launched {g['launches']}, expected {want}")
    require(not any(c["launches"].values()),
            f"CPU pass launched kernels: {c['launches']}")
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    gerr = grads_err(c["grads"], g["grads"])
    out = dict(arch=TRAIN_ARCH, layers=n, d_model=cfg.d_model,
               dtype="float32", batch=2, seq=256, loss_card=g["loss"],
               loss_cpu=c["loss"], loss_rel_err=loss_rel,
               loss_rtol=LOSS_RTOL, grads_err=gerr, grads_tol=GRADS_TOL,
               worst_leaf=max(c["grads"], key=lambda k: grads_err(
                   {k: c["grads"][k]}, {k: g["grads"][k]})),
               card_s=g["s"], cpu_s=c["s"])
    print(f"[train_consistency] {json.dumps(out)}")
    require(loss_rel <= LOSS_RTOL,
            f"loss card {g['loss']} vs CPU {c['loss']}: rel {loss_rel}")
    require(gerr <= GRADS_TOL, f"grads_err {gerr} > {GRADS_TOL}")
    # phase 9 holds the tp=2 runs against this card run
    TP1_REF.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"loss": g["loss"], "grads": g["grads"]}, TP1_REF)
    return out


def _train_model_flops(cfg, batch, seq):
    """6 x matmul weights (embedding table excluded, head included) x
    tokens, plus causal attention's 3 x 2 b s^2 d per layer."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    per_layer = (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
                 + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
    weights = cfg.num_layers * per_layer + d * cfg.padded_vocab()
    return (6 * weights * batch * seq
            + cfg.num_layers * 3 * 2 * batch * seq * seq * d)


def phase_train():
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.runtime import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    steps, batch, seq, micro = 8, 8, 1024, 2
    hp = TrainHParams(learning_rate=3e-4, total_steps=steps,
                      warmup_steps=max(steps // 20, 1), microbatch=micro,
                      **TP1_SCHEDULE)
    tr = Trainer(cfg, hp, global_batch=batch, seq_len=seq, log_fn=None)
    require(tr.device.type == "cuda", f"trainer chose {tr.device}")
    _build.reset_launches()
    first = tr.train(1, seed=0)
    leaves = prm.flatten(tr.params)
    bad = [k for k, t in leaves.items()
           if t.grad is None or not bool(torch.isfinite(t.grad).all())]
    require(not bad, f"missing or non-finite gradients after step 1: {bad}")
    rest = tr.train(steps, seed=0)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = first["losses"] + rest["losses"]
    times = first["step_times"] + rest["step_times"]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"losses {losses}")
    n, passes = cfg.num_layers, steps * micro
    want = {**SERVE_ONLY, "paged_decode": 0, "rmsnorm": passes * (2 * n + 1),
            "rmsnorm_bwd": passes * (2 * n + 1),
            "flash_attention": passes * n, "flash_attention_bwd": passes * n}
    require(launches == want, f"train launched {launches}, expected {want}")
    step_ms = [1e3 * t for t in times[2:]]
    med = statistics.median(step_ms)
    flops = _train_model_flops(cfg, batch, seq)
    out = dict(arch=TRAIN_ARCH, dtype=cfg.dtype, layers=n,
               d_model=cfg.d_model, params=sum(t.numel() for t in
                                               leaves.values()),
               batch=batch, seq=seq, microbatch=micro, steps=steps,
               losses=losses, step_ms=[1e3 * t for t in times],
               step_ms_median=med, tokens_per_s=batch * seq / (med / 1e3),
               model_tflop_per_step=flops / 1e12,
               mfu=flops / (med / 1e3) / H100_BF16_FLOPS,
               peak_mem_gb=peak / 1e9, launches=launches,
               arg_bytes=_state_bytes(tr))
    print(f"[train] {json.dumps(out)}")
    out["profile"] = _profile_train_step(tr)
    print(f"[train_profile] {json.dumps(out['profile'])}")
    return out


def _state_bytes(tr) -> int:
    """Bytes a Trainer's params, AdamW state and one step's batch hold on
    the card: what phase 23's dry run must count as its argument bytes."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import params as prm
    st = tr.opt_state
    batch = tr.batch(DataConfig(global_batch=tr.global_batch,
                                seq_len=tr.seq_len,
                                vocab_size=tr.cfg.vocab_size,
                                microbatch=tr.hp.microbatch), 0)
    return sum(t.numel() * t.element_size() for t in (
        *prm.flat_leaves(tr.params), *st["master"], *st["m"], *st["v"],
        *batch.values()))


def _profile_train_step(tr):
    """One more step (not counted above) under ``torch.profiler``: device
    busy time against the host wall of the step, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig
    dcfg = DataConfig(global_batch=tr.global_batch, seq_len=tr.seq_len,
                      vocab_size=tr.cfg.vocab_size,
                      microbatch=tr.hp.microbatch)
    batch = tr.batch(dcfg, tr.opt_state["step"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = _device_kernels(prof)
    device_ms = sum(k[0] for k in kernels) / 1e3
    return dict(
        wall_ms_profiled=wall_ms,
        device_ms=device_ms if kernels else "not measured",
        idle_share=(1 - device_ms / wall_ms) if kernels else "not measured",
        kernel_launches=sum(k[1] for k in kernels),
        f32_gemm_ms=_f32_gemm_ms(kernels) if kernels else "not measured",
        by_kernel_ms=_named_ms(kernels),
        top=[dict(name=k[2][:90], ms=k[0] / 1e3, calls=k[1])
             for k in kernels[:16]])


# ---------------------------------------------------------------------------
# tensor model parallelism (phases 8-10): rank processes share the card
# ---------------------------------------------------------------------------
TILE_SHAPES = [("wo", 2048, 1024, 2048), ("wd", 2048, 4096, 2048),
               ("ragged", 999, 1001, 997)]
# ring exits of gpt-h2048 at microbatch 4 x 1024: rows, whole K, d
RING_EXITS = [("wo", 4096, 2048, 2048), ("wd", 4096, 8192, 2048)]
COLL_SHAPE = (4, 1024, 2048)      # an exit's all-reduce at microbatch 4
TP_SCHEDULES = ("megatron", "oases", "fused")
# phase 9: (schedule, remat, fine_remat); fine under the three schedules,
# then oases without recomputation and with coarse recomputation
TP_VARIANTS = [(s, True, True) for s in TP_SCHEDULES] + [
    ("oases", False, True), ("oases", True, False)]
TP_STEPS = 4
# phase 10's depth: 6 of gpt-h2048's 24 layers (full width), cut to make
# room for phases 21-22 in the smoke's time (phase 22 trains all 24)
TP_TRAIN_LAYERS = 6
# first losses of the three schedules, bf16, 24 layers (absolute, on a
# loss of ~10.9): each of the 48 exits of a pass may round its residual
# delta differently (one bf16 ulp, 2**-8 relative: fused keeps f32
# partials, megatron rounds each rank's product to bf16 before the f32
# sum), and the per-row products may take other cuBLAS algorithms at
# oases's half batch; such perturbations move the mean loss by far less
# than 2e-2
TP_LOSS_ATOL = 2e-2


def _mm_tol(k: int, dname: str):
    """(atol, rtol) of a length-k f32-accumulated product of O(1) values
    against the same in another order: ~sqrt(k) rounding steps of 2**-24
    of partial sums up to ~sqrt(k), bounded by 1e-4 sqrt(k); bf16 results
    are cast once from f32 in both, so one bf16 ulp on top."""
    return 1e-4 * k ** 0.5, (0.0 if dname == "float32" else 2 ** -7)


def _mm_bound(m, k, n, elt, dname):
    from repro_torch.kernels.bounds import gemm_work
    return _bound(*gemm_work(m, k, n, elt), dname)


def phase_tmp_kernels():
    import torch
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels.collective_matmul import tile_matmul
    from repro_torch.launch.ranks import run_ranks

    results = {"tile_matmul": [], "ring_matmul_rs": [], "peer_all_reduce": [],
               "peer_all_gather": [], "peer_reduce_scatter": []}
    for case, m, k, n in TILE_SHAPES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            gen = torch.Generator(device="cuda").manual_seed(6)
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(k, n, generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            out = tile_matmul(x, w)
            want = ref.tile_matmul_ref(x, w)
            # bf16: a second run gives the same bits (no atomics, no
            # split of k)
            same = dname == "float32" or torch.equal(out, tile_matmul(x, w))
            torch.cuda.synchronize()
            atol, rtol = _mm_tol(k, dname)
            err, ok = max_err(out, want, atol, rtol)
            bound = _mm_bound(m, k, n, x.element_size(), dname)
            path = autotune.gemm_path(x, w)
            row = dict(case=case, m=m, k=k, n=n, dtype=dname, path=path,
                       blocks=autotune.tuned_blocks(m, k, n, dtype, x.device,
                                                    path=path),
                       same_bits=same, max_abs_err=err, atol=atol, rtol=rtol,
                       ms=time_ms(lambda: tile_matmul(x, w)),
                       plain_ms=time_ms(lambda: ref.tile_matmul_ref(x, w)),
                       bound_ms=bound[0], bound_by=bound[1],
                       library_ms=time_ms(lambda: torch.matmul(x, w)))
            print(f"[tile_matmul] {json.dumps(row)}")
            require(ok, f"tile_matmul {case} {dname}: max abs err {err} "
                        f"beyond atol {atol} + rtol {rtol}")
            require(same, f"tile_matmul {case} {dname}: two runs differ")
            results["tile_matmul"].append(row)
    torch.cuda.empty_cache()
    for tp in (2, 4):
        t0 = time.perf_counter()
        per_rank = run_ranks(_tmp_kernels_rank, tp, timeout=600)
        wall = time.perf_counter() - t0
        for kind in ("ring_matmul_rs", "peer_all_reduce", "peer_all_gather",
                     "peer_reduce_scatter"):
            for i, row in enumerate(per_rank[0][kind]):
                errs = [r[kind][i]["max_abs_err"] for r in per_rank]
                oks = [r[kind][i]["ok"] for r in per_rank]
                same = [r[kind][i].get("same_bits", True) for r in per_rank]
                row = dict(row, tp=tp, max_abs_err=max(errs),
                           rank_errs=errs, rank_ms=[r[kind][i]["ms"]
                                                    for r in per_rank])
                row.pop("ok")
                print(f"[{kind}] {json.dumps(row)}")
                require(all(oks), f"{kind} tp={tp} {row['case']} "
                                  f"{row['dtype']}: rank errors {errs} "
                                  f"beyond atol {row['atol']} + rtol "
                                  f"{row['rtol']}")
                differ = [j for j, ok in enumerate(same) if not ok]
                require(not differ, f"{kind} tp={tp} {row['case']} "
                                    f"{row['dtype']}: two runs differ on "
                                    f"ranks {differ}")
                results[kind].append(row)
        print(f"[tmp_kernels] tp={tp} ranks done in {wall:.1f} s")
    return results


def _tmp_kernels_rank(comm, device):
    """One rank of phase 8: the ring kernel at both exits and the peer
    collectives, f32 and bf16, against the plain versions computed from
    every rank's inputs (every rank draws all ranks' inputs from one
    seed)."""
    import torch
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels.collective_matmul import matmul_reducescatter

    n, rank = comm.size, comm.rank
    out = {"ring_matmul_rs": [], "peer_all_reduce": [], "peer_all_gather": [],
           "peer_reduce_scatter": []}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for case, rows, kfull, d in RING_EXITS:
            k = kfull // n
            gen = torch.Generator(device=device).manual_seed(5)
            xs = [torch.randn(rows, k, generator=gen, device=device)
                  .to(dtype) for _ in range(n)]
            ws = [(torch.randn(k, d, generator=gen, device=device)
                   / kfull ** 0.5).to(dtype) for _ in range(n)]
            got = matmul_reducescatter(xs[rank], ws[rank], comm, 0)
            want = ref.matmul_reducescatter_all_ranks_ref(xs, ws, n, rank)
            same = dname == "float32" or torch.equal(
                got, matmul_reducescatter(xs[rank], ws[rank], comm, 0))
            torch.cuda.synchronize(device)
            atol, rtol = _mm_tol(kfull, dname)
            err, ok = max_err(got, want, atol, rtol)
            bound = _bound((rows * k + k * d + rows // n * d)
                           * xs[0].element_size(), 2 * rows * k * d, dname)
            out["ring_matmul_rs"].append(dict(
                case=case, dtype=dname, rows=rows, k_local=k, d=d,
                chunk=rows // n, path=autotune.shape_path(k, d, dtype),
                same_bits=same, max_abs_err=err, ok=ok, atol=atol,
                rtol=rtol,
                ms=time_ms(lambda: matmul_reducescatter(xs[rank], ws[rank],
                                                        comm, 0)),
                plain_ms=time_ms(
                    lambda: ref.matmul_reducescatter_all_ranks_ref(
                        xs, ws, n, rank), iters=10),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                cublas_same_product_ms=time_ms(
                    lambda: torch.matmul(xs[rank], ws[rank]))))
            del xs, ws, got, want
        gen = torch.Generator(device=device).manual_seed(8)
        xs = [torch.randn(*COLL_SHAPE, generator=gen, device=device)
              .to(dtype) for _ in range(n)]
        elt, numel = xs[0].element_size(), xs[0].numel()
        for kind, run, plain, nbytes in (
                ("peer_all_reduce", lambda: comm.all_reduce(xs[rank]),
                 lambda: ref.all_reduce_ref(xs), (n + 1) * numel * elt),
                ("peer_all_gather", lambda: comm.all_gather(xs[rank], 0),
                 lambda: ref.all_gather_ref(xs, 0), 2 * n * numel * elt),
                # the SP exit's reduce-scatter along the sequence: reads
                # every rank's chunk, writes this rank's
                ("peer_reduce_scatter", lambda: comm.reduce_scatter(
                    xs[rank], 1),
                 lambda: ref.all_reduce_ref(xs).chunk(n, 1)[rank],
                 (n + 1) * numel // n * elt)):
            got, want = run(), plain()
            torch.cuda.synchronize(device)
            # the same f32 sum in the same rank order, cast once: exact
            err, ok = max_err(got, want, 0.0, 0.0)
            flops = {"peer_all_reduce": (n - 1) * numel,
                     "peer_reduce_scatter": (n - 1) * numel // n}
            bound = _bound(nbytes, flops.get(kind, 0), dname)
            row = dict(
                case="exit", dtype=dname, shape=list(COLL_SHAPE),
                max_abs_err=err, ok=ok, atol=0.0, rtol=0.0,
                ms=time_ms(run), plain_ms=time_ms(plain),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)
            if kind == "peer_reduce_scatter":
                # the former reduce-scatter: the all-reduce, then a slice
                row["all_reduce_slice_ms"] = time_ms(
                    lambda: comm.all_reduce(xs[rank]).chunk(n, 1)[rank]
                    .contiguous())
            out[kind].append(row)
        del xs
    comm.check()
    return out


def _pair_rank(comm, device, first, first_args, second, second_args):
    """Two phases' rank functions in one spawn (one warm-up of the rank
    processes): -> (``first``'s result, ``second``'s, its seconds)."""
    import torch
    a = first(comm, device, *first_args)
    gc.collect()
    torch.cuda.empty_cache()
    comm.barrier()
    t0 = time.perf_counter()
    b = second(comm, device, *second_args)
    return a, b, time.perf_counter() - t0


def _spawn_with_next(first, first_args, next_phase: int, setup, second,
                     timeout: float, mesh=None):
    """run_ranks of ``first`` on 2 ranks (or on ``mesh``); when phase
    ``next_phase`` runs too, its rank function ``second`` (arguments from
    ``setup()``, run in the parent before the spawn) follows in the same
    processes and its per-rank results wait in ``_RUN`` for that phase.
    -> per-rank results of ``first``."""
    from repro_torch.launch.ranks import run_ranks
    tp = 0 if mesh is not None else 2
    if next_phase not in _RUN.get("phases", ()):
        return run_ranks(first, tp, mesh=mesh, args=first_args,
                         timeout=timeout)
    ctx, second_args = setup()
    per = run_ranks(_pair_rank, tp, mesh=mesh, timeout=timeout + 900,
                    args=(first, first_args, second, second_args))
    _RUN[next_phase] = dict(ctx=ctx, per_rank=[b for _, b, _ in per],
                            wall=per[0][2])
    return [a for a, _, _ in per]


def phase_tp_consistency():
    import torch

    ref = torch.load(TP1_REF)
    t0 = time.perf_counter()
    per_rank = _spawn_with_next(_tp_consistency_rank, (TP_VARIANTS,), 10,
                                _tp_train_setup, _tp_train_rank, 600)
    wall = time.perf_counter() - t0
    out = {"tp": 2, "layers": 2, "dtype": "float32", "batch": 2, "seq": 256,
           "loss_tp1": ref["loss"], "wall_s": wall, "schedules": {}}
    for sched, remat, fine in TP_VARIANTS:
        name = _variant_name(sched, remat, fine)
        rs = [r[name] for r in per_rank]
        leaf_err = {k: max(r["leaf"][k][0] for r in rs)
                    / (max(r["leaf"][k][1] for r in rs) + 1e-8)
                    for k in rs[0]["leaf"]}
        gerr = max(leaf_err.values())
        loss_rel = max(abs(r["loss"] - ref["loss"]) for r in rs) \
            / abs(ref["loss"])
        row = dict(losses=[r["loss"] for r in rs], loss_rel_err=loss_rel,
                   grads_err=gerr, worst_leaf=max(leaf_err,
                                                  key=leaf_err.get),
                   fwd_kept_mb=[r["fwd_kept_mb"] for r in rs],
                   launches=rs[0]["launches"], counts=rs[0]["counts"],
                   rank_s=[r["s"] for r in rs])
        out["schedules"][name] = row
        print(f"[tp_consistency] {name} {json.dumps(row)}")
        require(loss_rel <= LOSS_RTOL,
                f"tp=2 {name} loss {row['losses']} vs tp=1 {ref['loss']}: "
                f"rel {loss_rel}")
        require(gerr <= GRADS_TOL, f"tp=2 {name} grads_err {gerr} > "
                                   f"{GRADS_TOL}")
        rings = rs[0]["launches"]["ring_matmul_rs"]
        want = 2 * 2 if sched == "fused" else 0
        require(rings == want, f"tp=2 {name}: {rings} ring launches, "
                               f"expected {want}")
    return out


def _variant_name(sched, remat, fine):
    from repro_torch.core.remat import policy
    pol = policy(sched, remat=remat, fine=fine)
    return sched if pol == "fine" else f"{sched}/{pol}"


def _settled_allocated(device) -> int:
    """Bytes allocated once the card is idle and the allocator has
    released the blocks whose last use was on the communicator's stream
    (``record_stream`` defers their free to the next allocation)."""
    import torch
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(device)


def _tp_consistency_rank(comm, device, variants):
    """One rank of phase 9: this rank's shard of phase 6's weights, loss
    and gradients per (schedule, remat, fine_remat) variant, each leaf's
    max difference from phase 6's tp=1 card gradient (the same shard of
    it) beside that shard's max, and the memory the forward leaves
    allocated for the backward (the loss's graph: saved activations)."""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.schedule import TmpCtx
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.models import params as prm

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rank = comm.size, comm.rank
    cfg = get_config(TRAIN_ARCH).replace(num_layers=2, dtype="float32")
    base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    batch = make_batch(DataConfig(global_batch=2, seq_len=256,
                                  vocab_size=cfg.vocab_size), 0)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    ref = torch.load(TP1_REF)["grads"]
    want = prm.layout_1d(cfg, n).shard_flat(ref, rank)
    # the process's first product allocates cuBLAS's workspace (32 MiB)
    # from the caching allocator: before the first reading, not inside it
    torch.matmul(torch.ones(8, 8, device=device),
                 torch.ones(8, 8, device=device))
    out = {}
    for sched, remat, fine in variants:
        shard = prm.shard_params(cfg, base, rank, n)
        params = prm.unflatten({k: t.to(device).requires_grad_()
                                for k, t in prm.flatten(shard).items()})
        _build.reset_launches()
        comm.reset_counts()
        before = _settled_allocated(device)
        t0 = time.perf_counter()
        loss, _ = lm.train_loss(
            cfg, params, tb,
            TrainHParams(schedule=sched, remat=remat, fine_remat=fine),
            TmpCtx(comm, schedule=sched))
        kept = _settled_allocated(device) - before
        loss.backward()
        torch.cuda.synchronize(device)
        leaf = {}
        for k, t in prm.flatten(params).items():
            g = t.grad.detach().cpu()
            leaf[k] = (float((g - want[k]).abs().max()),
                       float(want[k].abs().max()))
        out[_variant_name(sched, remat, fine)] = dict(
            loss=loss.item(), leaf=leaf, fwd_kept_mb=kept / 1e6,
            s=time.perf_counter() - t0, launches=dict(_build.LAUNCHES),
            counts=dict(comm.counts))
        del params, shard, loss
    return out


def _tp_train_setup():
    """Phase 10's rank arguments: the probe's hardware, calibrated here
    before the ranks share the card (rank 0 must not time the card under
    the other rank), and the telemetry directory -> ((hw, tel), args)."""
    import tempfile

    from repro_torch.core.planner import calibrate
    tel = tempfile.TemporaryDirectory()
    with _cal_cache():
        hw = calibrate.calibrated_hw(n_chips=2)
    return (hw, tel), (TP_SCHEDULES, TP_STEPS, 8, 1024, 2, hw, tel.name)


def phase_tp_train():
    """Phase 10 (its ranks spawned by phase 9 when both run)."""
    import torch
    from repro_torch.launch.ranks import run_ranks

    torch.cuda.empty_cache()
    steps, batch, seq, micro = TP_STEPS, 8, 1024, 2
    done = _RUN.pop(10, None)
    if done is None:
        (hw, tel), args = _tp_train_setup()
        t0 = time.perf_counter()
        per_rank = run_ranks(_tp_train_rank, 2, timeout=900, args=args)
        wall = time.perf_counter() - t0
    else:
        (hw, tel), per_rank, wall = done["ctx"], done["per_rank"], \
            done["wall"]
    out = {"arch": TRAIN_ARCH, "tp": 2, "dtype": "bfloat16",
           "layers": TP_TRAIN_LAYERS,
           "batch": batch, "seq": seq, "microbatch": micro, "steps": steps,
           "wall_s": wall, "probe_hw": {"peak_flops": hw.peak_flops,
                                        "hbm_bw": hw.hbm_bw,
                                        "link_bw": hw.link_bw},
           "schedules": {}}
    firsts = {}
    for sched in TP_SCHEDULES:
        rs = [r[sched] for r in per_rank]
        r0 = rs[0]
        row = dict(r0, peak_mem_gb=[r["peak_mem_gb"] for r in rs],
                   step_ms_median=[r["step_ms_median"] for r in rs],
                   probe=_check_tp_telemetry(Path(tel.name) / sched, sched,
                                             steps))
        out["schedules"][sched] = row
        brief = {k: v for k, v in row.items() if k != "profile"}
        print(f"[tp_train] {sched} {json.dumps(brief)}")
        print(f"[tp_train_profile] {sched} {json.dumps(r0['profile'])}")
        for r in rs:
            require(len(r["losses"]) == steps
                    and all(math.isfinite(v) for v in r["losses"]),
                    f"tp=2 {sched}: losses {r['losses']}")
            require(not r["bad_grads"], f"tp=2 {sched}: missing or "
                                        f"non-finite gradients after step 1: "
                                        f"{r['bad_grads']}")
            require(r["losses"] == r0["losses"],
                    f"tp=2 {sched}: ranks report different losses "
                    f"{[x['losses'] for x in rs]}")
        rings = r0["launches_per_step"]["ring_matmul_rs"]
        want = 2 * TP_TRAIN_LAYERS * micro if sched == "fused" else 0
        require(rings == want, f"tp=2 {sched}: {rings} ring launches a "
                               f"step, expected {want}")
        firsts[sched] = r0["losses"][0]
    tel.cleanup()
    spread = max(firsts.values()) - min(firsts.values())
    out["first_loss_spread"] = spread
    out["first_loss_atol"] = TP_LOSS_ATOL
    require(spread <= TP_LOSS_ATOL, f"tp=2 first losses {firsts}: spread "
                                    f"{spread} > {TP_LOSS_ATOL}")
    return out


def _check_tp_telemetry(path, sched, steps) -> dict:
    """Rank 0's JSONL of one schedule: every line validates, one
    ``trainer.step_time_s`` a step (no other rank wrote), one
    ``overlap.group`` event per plan group with the schedule's tag and a
    measured exposed fraction in [0, 1], and both ``overlap.*`` gauges.
    -> the probe's readings."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import plan_groups
    from repro_torch.obs import schema
    require(sorted(p.name for p in path.iterdir()) == ["telemetry.jsonl"],
            f"{path}: {sorted(p.name for p in path.iterdir())}")
    with open(path / "telemetry.jsonl") as f:
        records = schema.validate_lines(f)
    names = [r["name"] for r in records]
    require(names.count("trainer.step_time_s") == steps,
            f"tp=2 {sched}: {names.count('trainer.step_time_s')} step "
            f"records for {steps} steps of rank 0")
    n = get_config(TRAIN_ARCH).num_layers
    want = len(plan_groups(get_config(TRAIN_ARCH), [2] * n, [sched] * n))
    groups = [r["tags"] for r in records if r["name"] == "overlap.group"]
    require(len(groups) == want and all(
        g["schedule"] == sched and 0.0 <= g["measured_exposed_frac"] <= 1.0
        for g in groups), f"tp=2 {sched}: overlap.group events {groups}")
    gauges = {r["name"]: r["value"] for r in records
              if r["name"].startswith("overlap.") and r["kind"] == "gauge"}
    require(set(gauges) == {"overlap.measured_exposed_frac",
                            "overlap.model_residual"},
            f"tp=2 {sched}: overlap gauges {gauges}")
    stale = [r for r in records if r["name"] == "calibration_stale"]
    return dict(groups=groups, gauges=gauges,
                calibration_stale=[r["tags"] for r in stale],
                errors=[r.get("msg") for r in records
                        if r["name"] == "overlap.error"])


def _tp_train_rank(comm, device, schedules, steps, batch, seq, micro, hw,
                   tel_dir):
    """One rank of phase 10: the port's Trainer on this rank's shard, per
    schedule, rank 0 recording into ``tel_dir/<schedule>`` with the
    overlap probe on ``hw``; a one-step profile on rank 0 (rank 1 runs the
    same step)."""
    import gc
    import os

    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.obs import Recorder
    from repro_torch.runtime import Trainer

    cfg = get_config(TRAIN_ARCH).replace(num_layers=TP_TRAIN_LAYERS)
    out = {}
    for sched in schedules:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        hp = TrainHParams(schedule=sched, learning_rate=3e-4,
                          total_steps=steps, warmup_steps=1,
                          microbatch=micro)
        rec = (Recorder(os.path.join(tel_dir, sched)) if comm.rank == 0
               else None)
        tr = Trainer(cfg, hp, global_batch=batch, seq_len=seq, log_fn=None,
                     device=device, comm=comm, telemetry=rec, probe_hw=hw)
        _build.reset_launches()
        first = tr.train(1, seed=0)
        bad = [k for k, t in prm.flatten(tr.params).items()
               if t.grad is None or not bool(torch.isfinite(t.grad).all())]
        rest = tr.train(steps, seed=0)
        torch.cuda.synchronize(device)
        launches = dict(_build.LAUNCHES)
        times = first["step_times"] + rest["step_times"]
        if rec is not None:
            rec.close()
        prof = _profile_tp_step(tr, comm)
        out[sched] = dict(
            losses=first["losses"] + rest["losses"], bad_grads=bad,
            step_ms=[1e3 * t for t in times],
            step_ms_median=statistics.median(1e3 * t for t in times[1:]),
            launches_per_step={k: v / steps for k, v in launches.items()},
            peak_mem_gb=_peak_gb(comm, device),
            profile=prof)
        del tr, first, rest
    return out


def _profile_tp_step(tr, comm):
    """One more step (not counted above): rank 0 under ``torch.profiler``
    (its own process's kernels), the other ranks plainly; they meet at a
    host barrier once rank 0 has read its trace.  Device busy time, idle
    share against the step's wall, the time in the collective kernels
    (the peer collectives and the ring matmul) and in the ring-attention
    kernels, and the device ms inside each ``tmp.<schedule>.*`` range,
    forward and backward, with the share outside every range
    (:func:`_range_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.data.pipeline import DataConfig
    dcfg = DataConfig(global_batch=tr.global_batch, seq_len=tr.seq_len,
                      vocab_size=tr.cfg.vocab_size,
                      microbatch=tr.hp.microbatch)
    batch = tr.batch(dcfg, tr.opt_state["step"])
    torch.cuda.synchronize()
    if comm.rank != 0:
        tr.step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        comm.barrier()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with obs.trace_annotation("train_step"):
            tr.step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = _device_kernels(prof)
    device_ms = sum(k[0] for k in kernels) / 1e3
    ranges = _range_ms(prof, device_ms) if kernels else "not measured"
    # reading the trace kept this rank off the card for long: the other
    # ranks waited at the barrier, not inside a peer kernel
    comm.barrier()
    coll = [k for k in kernels
            if "collective_kernel" in k[2] or "ring_mm_rs" in k[2]]
    ring = [k for k in kernels if any(
        name in k[2] for name in ("ring_attn_kernel", "ring_attn_tc_kernel",
                                  "publish_kernel", "done_kernel"))]
    return dict(
        wall_ms_profiled=wall_ms,
        device_ms=device_ms if kernels else "not measured",
        idle_share=(1 - device_ms / wall_ms) if kernels else "not measured",
        collective_ms=sum(k[0] for k in coll) / 1e3 if kernels
        else "not measured",
        collective_calls=sum(k[1] for k in coll),
        ring_attention_ms=sum(k[0] for k in ring) / 1e3 if kernels
        else "not measured",
        ring_attention_calls=sum(k[1] for k in ring),
        kernel_launches=sum(k[1] for k in kernels),
        ranges=ranges,
        by_kernel_ms=_named_ms(kernels),
        top=[dict(name=k[2][:90], ms=k[0] / 1e3, calls=k[1])
             for k in kernels[:16]])




def _peak_gb(comm, device) -> float:
    """Peak device memory of a rank: PyTorch's allocator's peak plus the
    peer workspaces of its communicators (allocated outside it)."""
    import torch
    from repro_torch.kernels.peer_comm import SLOTS
    return (torch.cuda.max_memory_allocated(device)
            + sum(SLOTS * c.ws.slot_bytes for c in comm.comms()
                  if hasattr(c, "ws"))) / 1e9


# ---------------------------------------------------------------------------
# sequence parallelism and ring attention (phases 11-13)
# ---------------------------------------------------------------------------
SP_ARCH = "internlm2-1.8b"
# phase 11: ring attention over the whole sequence s, split over the ranks
RING_CASES = [
    # the slice's shape: internlm2-1.8b, b 2, s 4096 (16 q / 8 kv heads)
    dict(case="slice", b=2, s=4096, h=16, kvh=8, hd=128),
    # gpt-h2048's heads (MHA, hd 64) at phase 5's batch
    dict(case="mha", b=4, s=1024, h=32, kvh=32, hd=64),
    dict(case="gqa_window_softcap", b=2, s=2048, h=16, kvh=8, hd=128,
         window=256, softcap=30.0),
    # ragged shards: sq 1000 at tp 2, 500 at tp 4 (not multiples of the
    # 64-row tile), a window reaching over one shard
    dict(case="ragged", b=2, s=2000, h=16, kvh=8, hd=128, window=700),
]
# phase 12: (schedule, remat, fine_remat, seq_parallel, ring); SP under
# megatron and fused, ring attention (seq_shard = tp) under oases and
# fused, and oases's ring with coarse recomputation
SP_VARIANTS = [("megatron", True, True, True, False),
               ("fused", True, True, True, False),
               ("oases", True, True, True, True),
               ("fused", True, True, True, True),
               ("oases", True, False, True, True)]
SP_SCHEDULES = ("oases", "fused")
SP_STEPS = 3
# phase 13's depth: 6 of internlm2-1.8b's 24 layers (full width), cut to
# make room for phases 21-22 in the smoke's time
SP_TRAIN_LAYERS = 6
# phase 12's tp=1 card loss and gradients
SP_REF = ROOT / "build" / "chip_smoke" / "sp_tp1_consistency.pt"


def _ring_pairs(rank: int, sq: int, window) -> int:
    """(query, key) pairs a rank's q shard sees over the whole sequence:
    queries at rank * sq + i, keys at every earlier position (within the
    window)."""
    import numpy as np
    qpos = rank * sq + np.arange(sq)
    lo = np.zeros(sq, np.int64) if window is None else np.maximum(
        qpos - window + 1, 0)
    return int((qpos + 1 - lo).sum())


def _flash_at_ring_shape() -> dict:
    """The bf16 flash forward at the ring's whole shape (the slice case, b 2,
    s 4096, 16 q / 8 kv heads of 128, causal) in this one process: what the
    tile takes with no peers and no time slices, beside its bound and SDPA
    (a yardstick only).  Timed, not checked (phase 5 checks the kernel)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.bounds import flash_work, visible_pairs
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    case = RING_CASES[0]
    b, s_, h, kvh, hd = (case[k] for k in ("b", "s", "h", "kvh", "hd"))
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn(b, s_, h, hd, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, s_, kvh, hd, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    (nbytes, flops), _ = flash_work(b, s_, h, kvh, hd, visible_pairs(s_), 2)
    bound = _bound(nbytes, flops, "bfloat16")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row = dict(case=case["case"], dtype="bfloat16", b=b, s=s_, h=h, kvh=kvh,
               hd=hd, ms=time_ms(lambda: flash_attention_fwd(q, k, v)),
               bound_ms=bound[0], bound_by=bound[1],
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True)))
    print(f"[flash_at_ring_shape] {json.dumps(row)}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def phase_ring_kernels():
    from repro_torch.launch.ranks import run_ranks

    results = {"ring_attention": [],
               "flash_at_ring_shape": _flash_at_ring_shape()}
    for tp in (2, 4):
        t0 = time.perf_counter()
        per_rank = run_ranks(_ring_kernels_rank, tp, timeout=600)
        wall = time.perf_counter() - t0
        for i, first in enumerate(per_rank[0]):
            rows = [r[i] for r in per_rank]
            # the last rank sees every shard: its numbers are the case's
            row = dict(rows[-1], tp=tp, rank=tp - 1,
                       max_abs_err=max(r["max_abs_err"] for r in rows),
                       rank_errs=[r["errs"] for r in rows],
                       rank_ms=[r["ms"] for r in rows],
                       rank_bound_ms=[r["bound_ms"] for r in rows])
            row.pop("ok")
            print(f"[ring_attention] {json.dumps(row)}")
            require(all(r["ok"] for r in rows),
                    f"ring_attention tp={tp} {row['case']} {row['dtype']}: "
                    f"rank errors {row['rank_errs']} beyond {row['tol']}")
            results["ring_attention"].append(row)
        print(f"[ring_kernels] tp={tp} ranks done in {wall:.1f} s")
    return results


def _ring_kernels_rank(comm, device):
    """One rank of phase 11: the ring-attention kernel on this rank's
    shard of each case, against the plain version computed from every
    rank's inputs (every rank draws all ranks' inputs from one seed),
    timed beside its bound, the plain version and SDPA of the local q
    against the gathered K/V with the offset causal mask (a yardstick;
    none under a softcap, which SDPA does not take)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_attention import ring_forward_kernel

    n, rank = comm.size, comm.rank
    out = []
    for case in RING_CASES:
        b, s_, h, kvh, hd = (case[k] for k in ("b", "s", "h", "kvh", "hd"))
        window, softcap = case.get("window"), case.get("softcap", 0.0)
        sq = s_ // n
        kw = dict(causal=True, window=window, softcap=softcap,
                  scale=hd ** -0.5)
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            gen = torch.Generator(device=device).manual_seed(12)
            qs = [torch.randn(b, sq, h, hd, generator=gen, device=device)
                  .to(dtype) for _ in range(n)]
            ks, vs = ([torch.randn(b, sq, kvh, hd, generator=gen,
                                   device=device).to(dtype)
                       for _ in range(n)] for _ in range(2))

            def kernel():
                return ring_forward_kernel(qs[rank], ks[rank], vs[rank],
                                           comm, **kw)

            def plain():
                return ref.ring_attention_all_ranks_ref(qs, ks, vs, rank,
                                                        **kw)
            got, want = kernel(), plain()
            torch.cuda.synchronize(device)
            tol = FLASH_TOL[dname]
            e_out, ok_out = max_err(got[0], want[0], *tol["out"])
            e_lse, ok_lse = max_err(got[1], want[1], *tol["lse"])
            elt = qs[0].element_size()
            pairs = _ring_pairs(rank, sq, window) * b * h
            # reads q and every rank's K/V shard; writes out and lse
            bound = _bound(2 * b * sq * h * hd * elt + b * h * sq * 4
                           + n * 2 * b * sq * kvh * hd * elt,
                           4 * hd * pairs, dname)
            row = dict(case=case["case"], dtype=dname, b=b, s=s_, sq=sq,
                       h=h, kvh=kvh, hd=hd, window=window, softcap=softcap,
                       visible_pairs=pairs,
                       errs={"out": e_out, "lse": e_lse},
                       max_abs_err=max(e_out, e_lse), ok=ok_out and ok_lse,
                       tol={"out": tol["out"], "lse": tol["lse"]},
                       ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
                       bound_ms=bound[0], bound_by=bound[1],
                       library_ms=None)
            del got, want
            if not softcap:
                qt = qs[rank].transpose(1, 2)
                kt = torch.cat(ks, 1).transpose(1, 2)
                vt = torch.cat(vs, 1).transpose(1, 2)
                qi = rank * sq + torch.arange(sq, device=device)[:, None]
                kj = torch.arange(s_, device=device)[None, :]
                mask = kj <= qi
                if window is not None:
                    mask &= kj > qi - window
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                        enable_gqa=kvh != h))
                del qt, kt, vt, mask
            out.append(row)
            del qs, ks, vs
            torch.cuda.empty_cache()
    comm.check()
    return out


def _sp_name(sched, remat, fine, ring):
    from repro_torch.core.remat import policy
    pol = policy(sched, remat=remat, fine=fine)
    name = f"{sched}/{'ring' if ring else 'sp'}"
    return name if pol == "fine" else f"{name}/{pol}"


def phase_sp_consistency():
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import lm
    from repro_torch.models import params as prm

    cfg = get_config(SP_ARCH).replace(num_layers=2, dtype="float32")
    base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    batch = make_batch(DataConfig(global_batch=2, seq_len=512,
                                  vocab_size=cfg.vocab_size), 0)
    params = prm.unflatten({k: t.to("cuda").requires_grad_()
                            for k, t in prm.flatten(base).items()})
    tb = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
    t0 = time.perf_counter()
    loss, _ = lm.train_loss(cfg, params, tb, TrainHParams(**TP1_SCHEDULE))
    loss.backward()
    torch.cuda.synchronize()
    tp1_s = time.perf_counter() - t0
    SP_REF.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"loss": loss.item(),
                "grads": {k: t.grad.detach().cpu()
                          for k, t in prm.flatten(params).items()}}, SP_REF)
    ref_loss = loss.item()
    del params, loss, base
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = _spawn_with_next(
        _sp_consistency_rank, (SP_VARIANTS,), 13,
        lambda: (None, (SP_SCHEDULES, SP_STEPS, 4, 4096, 2)), _sp_train_rank,
        600)
    wall = time.perf_counter() - t0
    out = {"arch": SP_ARCH, "tp": 2, "layers": 2, "dtype": "float32",
           "batch": 2, "seq": 512, "loss_tp1": ref_loss, "tp1_s": tp1_s,
           "wall_s": wall, "variants": {}}
    for sched, remat, fine, sp, ring in SP_VARIANTS:
        name = _sp_name(sched, remat, fine, ring)
        rs = [r[name] for r in per_rank]
        leaf_err = {k: max(r["leaf"][k][0] for r in rs)
                    / (max(r["leaf"][k][1] for r in rs) + 1e-8)
                    for k in rs[0]["leaf"]}
        gerr = max(leaf_err.values())
        loss_rel = max(abs(r["loss"] - ref_loss) for r in rs) / abs(ref_loss)
        row = dict(losses=[r["loss"] for r in rs], loss_rel_err=loss_rel,
                   grads_err=gerr,
                   worst_leaf=max(leaf_err, key=leaf_err.get),
                   fwd_kept_mb=[r["fwd_kept_mb"] for r in rs],
                   launches=[r["launches"] for r in rs],
                   counts=rs[0]["counts"], rank_s=[r["s"] for r in rs])
        out["variants"][name] = row
        print(f"[sp_consistency] {name} {json.dumps(row)}")
        require(loss_rel <= LOSS_RTOL,
                f"tp=2 {name} loss {row['losses']} vs tp=1 {ref_loss}: "
                f"rel {loss_rel}")
        require(gerr <= GRADS_TOL, f"tp=2 {name} grads_err {gerr} > "
                                   f"{GRADS_TOL}")
        split = 2 if sched == "oases" else 1
        want_ring = (cfg.num_layers * split * (1 if fine else 2)
                     if ring else 0)
        want_rs = (cfg.num_layers * (1 if ring else 2)
                   if sched == "fused" else 0)
        for r in rs:
            got = (r["launches"]["ring_attention"],
                   r["launches"]["ring_matmul_rs"])
            require(got == (want_ring, want_rs),
                    f"tp=2 {name}: (ring_attention, ring_matmul_rs) "
                    f"launches {got}, expected {(want_ring, want_rs)}")
    return out


def _sp_consistency_rank(comm, device, variants):
    """One rank of phase 12: this rank's shard of the weights, loss and
    gradients per variant (the partial leaves summed over the ranks by the
    training step's own all-reduce), each leaf's max difference from the
    tp=1 card gradient (the same shard of it) beside that shard's max, and
    the memory the forward leaves allocated for the backward."""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import reduce_grads
    from repro_torch.models import lm
    from repro_torch.models import params as prm

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rank = comm.size, comm.rank
    cfg = get_config(SP_ARCH).replace(num_layers=2, dtype="float32")
    base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    batch = make_batch(DataConfig(global_batch=2, seq_len=512,
                                  vocab_size=cfg.vocab_size), 0)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    ref = torch.load(SP_REF)["grads"]
    # cuBLAS's workspace comes with the process's first product
    torch.matmul(torch.ones(8, 8, device=device),
                 torch.ones(8, 8, device=device))
    out = {}
    for sched, remat, fine, sp, ring in variants:
        shard = n if ring else 1
        hp = TrainHParams(schedule=sched, remat=remat, fine_remat=fine,
                          seq_parallel=sp, seq_shard=shard)
        want_flat = prm.layout_1d(cfg, n, shard).shard_flat(ref, rank)
        params = prm.unflatten({
            k: t.to(device).requires_grad_() for k, t in prm.flatten(
                prm.shard_params(cfg, base, rank, n, seq_shard=shard))
            .items()})
        ctx = lm.train_ctx(cfg, hp, comm, 512)
        _build.reset_launches()
        comm.reset_counts()
        before = _settled_allocated(device)
        t0 = time.perf_counter()
        loss, _ = lm.train_loss(cfg, params, tb, hp, ctx)
        kept = _settled_allocated(device) - before
        loss.backward()
        torch.cuda.synchronize(device)
        launches, counts = dict(_build.LAUNCHES), dict(comm.counts)
        flat = prm.flatten(params)
        grads = [t.grad for t in flat.values()]
        partial = prm.partial_grad_leaves(cfg, seq_parallel=ctx.sp,
                                          seq_shard=ctx.seq_shard)
        reduce_grads(grads, [i for i, k in enumerate(flat) if k in partial],
                     comm)
        leaf = {}
        for k, g in zip(flat, grads):
            want = want_flat[k]
            g = g.detach().cpu()
            leaf[k] = (float((g - want).abs().max()),
                       float(want.abs().max()))
        out[_sp_name(sched, remat, fine, ring)] = dict(
            loss=loss.item(), leaf=leaf, s=time.perf_counter() - t0,
            fwd_kept_mb=kept / 1e6, launches=launches, counts=counts)
        del params, loss, grads, flat
    return out


def phase_sp_train():
    """Phase 13 (its ranks spawned by phase 12 when both run)."""
    import torch
    from repro_torch.launch.ranks import run_ranks

    torch.cuda.empty_cache()
    steps, batch, seq, micro = SP_STEPS, 4, 4096, 2
    done = _RUN.pop(13, None)
    if done is None:
        t0 = time.perf_counter()
        per_rank = run_ranks(_sp_train_rank, 2, timeout=900,
                             args=(SP_SCHEDULES, steps, batch, seq, micro))
        wall = time.perf_counter() - t0
    else:
        per_rank, wall = done["per_rank"], done["wall"]
    out = {"arch": SP_ARCH, "tp": 2, "seq_shard": 2, "dtype": "bfloat16",
           "layers": SP_TRAIN_LAYERS, "batch": batch, "seq": seq,
           "microbatch": micro,
           "steps": steps, "wall_s": wall, "schedules": {}}
    firsts = {}
    for sched in SP_SCHEDULES:
        rs = [r[sched] for r in per_rank]
        r0 = rs[0]
        row = dict(r0, peak_mem_gb=[r["peak_mem_gb"] for r in rs],
                   step_ms_median=[r["step_ms_median"] for r in rs],
                   launches_per_step_by_rank=[r["launches_per_step"]
                                              for r in rs])
        row["tokens_per_s"] = batch * seq / (max(row["step_ms_median"])
                                             / 1e3)
        out["schedules"][sched] = row
        brief = {k: v for k, v in row.items() if k != "profile"}
        print(f"[sp_train] {sched} {json.dumps(brief)}")
        print(f"[sp_train_profile] {sched} {json.dumps(r0['profile'])}")
        split = 2 if sched == "oases" else 1
        n = SP_TRAIN_LAYERS
        want = {"ring_attention": n * micro * split,
                "ring_matmul_rs": n * micro if sched == "fused" else 0}
        for r in rs:
            require(len(r["losses"]) == steps
                    and all(math.isfinite(v) for v in r["losses"]),
                    f"sp {sched}: losses {r['losses']}")
            require(not r["bad_grads"], f"sp {sched}: missing or non-finite "
                                        f"gradients after step 1: "
                                        f"{r['bad_grads']}")
            require(r["losses"] == r0["losses"],
                    f"sp {sched}: ranks report different losses "
                    f"{[x['losses'] for x in rs]}")
            got = {k: r["launches_per_step"][k] for k in want}
            require(got == want, f"sp {sched}: launches a step {got}, "
                                 f"expected {want}")
        firsts[sched] = r0["losses"][0]
    spread = max(firsts.values()) - min(firsts.values())
    out["first_loss_spread"] = spread
    out["first_loss_atol"] = TP_LOSS_ATOL
    require(spread <= TP_LOSS_ATOL, f"sp first losses {firsts}: spread "
                                    f"{spread} > {TP_LOSS_ATOL}")
    return out


def _sp_train_rank(comm, device, schedules, steps, batch, seq, micro):
    """One rank of phase 13: the port's Trainer with ring attention
    (seq_shard = 2) on this rank's shard, per schedule; a one-step profile
    on rank 0 (rank 1 runs the same step)."""
    import gc

    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.runtime import Trainer

    cfg = get_config(SP_ARCH).replace(num_layers=SP_TRAIN_LAYERS)
    out = {}
    for sched in schedules:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        hp = TrainHParams(schedule=sched, learning_rate=3e-4,
                          total_steps=steps, warmup_steps=1,
                          microbatch=micro, seq_shard=comm.size)
        tr = Trainer(cfg, hp, global_batch=batch, seq_len=seq, log_fn=None,
                     device=device, comm=comm)
        _build.reset_launches()
        first = tr.train(1, seed=0)
        bad = [k for k, t in prm.flatten(tr.params).items()
               if t.grad is None or not bool(torch.isfinite(t.grad).all())]
        rest = tr.train(steps, seed=0)
        torch.cuda.synchronize(device)
        launches = dict(_build.LAUNCHES)
        times = first["step_times"] + rest["step_times"]
        peak = _peak_gb(comm, device)
        prof = _profile_tp_step(tr, comm)
        out[sched] = dict(
            losses=first["losses"] + rest["losses"], bad_grads=bad,
            step_ms=[1e3 * t for t in times],
            step_ms_median=statistics.median(1e3 * t for t in times[1:]),
            launches_per_step={k: v / steps for k, v in launches.items()},
            params_per_rank=sum(t.numel() for t in
                                prm.flat_leaves(tr.params)),
            peak_mem_gb=peak, profile=prof)
        del tr, first, rest
    return out


# ---------------------------------------------------------------------------
# the MoE and SSD families at tp=1 (phases 14-16)
# ---------------------------------------------------------------------------
SSD_ARCH = "mamba2-130m"
MOE_ARCH = "granite-moe-3b-a800m"
# phase 14: SSD kernel cases: mamba2-130m's mixer (24 heads of 64, state
# 128) at the slice's batch 1 x seq 4096, at a sequence shorter than a
# chunk (the model's chunk is min(128, s)) and at batch 4
SSD_CASES = [dict(name="slice", b=1, s=4096, h=24, p=64, n=128),
             dict(name="short", b=2, s=96, h=24, p=64, n=128),
             dict(name="batch", b=4, s=1024, h=24, p=64, n=128)]
# phase 14: granite's expert products (tokens, D, F): w1/w3 and w2 at
# 4,096 tokens (capacity 1,024), and w1 at 1,000 tokens (capacity 250, no
# tile multiple)
GMM_CASES = [("w1", 4096, 1536, 512), ("w2", 4096, 512, 1536),
             ("ragged", 1000, 1536, 512)]
# kernel vs plain version of both kernels: the plain version repeats the
# f32 arithmetic in another order, so f32 agrees within 1e-5 of the
# largest |value| (atol = FAMILY_TOL x max |want|); bf16 results are cast
# once from f32 in both, so one bf16 ulp on top (rtol 2**-7)
FAMILY_TOL = 1e-5
FAMILY_RTOL = {"float32": 0.0, "bfloat16": 2 ** -7}
# the SSD backward's results, each held under FAMILY_TOL of its own
# largest |value|
SSD_GRADS = ("dx", "ddt", "dA_log", "dB", "dC", "dD")
# phase 15: the schedules each family is held to, card vs CPU: the
# families' megatron without recomputation (phase 16's Trainer) and the
# training default, oases (split 2: each sub-batch routes alone) with fine
# recomputation (the MoE FFN and the SSD mixer replayed in the backward)
FAMILY_SCHEDULES = {"megatron": dict(schedule="megatron", remat=False),
                    "oases_fine": dict(schedule="oases", remat=True,
                                       fine_remat=True)}
# phase 16: the Trainer at each family's shape: (layers or None for all,
# global batch, seq, microbatches); granite keeps 8 of its 32 layers (all
# 32 are 3.37 B parameters at 20 bytes each, ~67 GB: bf16 weights and
# gradients, the step's f32 gradients, f32 master weights and AdamW
# moments; too much beside this batch's activations without
# recomputation)
FAMILY_TRAIN = {SSD_ARCH: (None, 4, 4096, 4), MOE_ARCH: (8, 8, 1024, 2)}
FAMILY_STEPS = 8
# phase 16: ``launch/train.py`` at each family's full depth with its
# default schedule (oases, split 2, fine recomputation): (global batch,
# seq, microbatches), each microbatch 2 sequences so both sub-batches run;
# granite's 32 layers at a batch small enough beside its ~67 GB of state
FAMILY_LAUNCH = {SSD_ARCH: (4, 4096, 2), MOE_ARCH: (2, 1024, 1)}
FAMILY_LAUNCH_STEPS = 2


def _family_check(name, got, want, dname):
    """max |got - want| and its check against the family tolerance."""
    atol = FAMILY_TOL * float(want.float().abs().max())
    rtol = FAMILY_RTOL[dname]
    err, ok = max_err(got, want, atol, rtol)
    require(ok, f"{name}: max abs err {err} beyond atol {atol} + rtol "
                f"{rtol}")
    return err, atol


def _ssd_inputs(b, s, h, p, n, dtype, seed=5):
    """Inputs at the mixer's scales: x ~ 0.5 N(0, 1), dt = softplus(N(0, 1)
    - 2) (~0.13, so a chunk of 128 decays by ~e^-6 and the carried state
    matters), A_log ~ -1, B and C ~ 0.3 N(0, 1), D ~ 1."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = (0.5 * rnd(b, s, h, p)).to(dtype)
    dt = F.softplus(rnd(b, s, h) - 2.0)
    A_log = -1.0 + 0.1 * rnd(h)
    B, C = ((0.3 * rnd(b, s, n)).to(dtype) for _ in range(2))
    D = 1.0 + 0.1 * rnd(h)
    return x, dt, A_log, B, C, D


def phase_family_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bounds import ssd_bounds, ssd_bwd_work, ssd_work
    from repro_torch.kernels.ssd import ssd_bwd, ssd_fwd

    results = {"ssd": [], "ssd_bwd": [], "moe_gmm": [],
               "flash_attention": [], "flash_attention_bwd": []}
    for case in SSD_CASES:
        b, s_, h, p, n = (case[k] for k in ("b", "s", "h", "p", "n"))
        q = min(128, s_)
        for dname in ("float32", "bfloat16"):
            ins = _ssd_inputs(b, s_, h, p, n, getattr(torch, dname))
            dy = torch.randn(ins[0].shape, device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(7)).to(ins[0].dtype)
            common = dict(case=case["name"], dtype=dname, b=b, s=s_, h=h,
                          p=p, n=n, chunk=q)
            elt = ins[0].element_size()
            # the forward; no atomics, so a second run gives the same bits
            got = ssd_fwd(*ins, chunk=q)
            same = torch.equal(got, ssd_fwd(*ins, chunk=q))
            want = ref.ssd_ref(*ins, chunk=q)
            torch.cuda.synchronize()
            err, atol = _family_check(f"ssd {case['name']} {dname}", got,
                                      want, dname)
            require(same, f"ssd {case['name']} {dname}: two runs differ")
            nbytes, flops = ssd_work(b, s_, h, p, n, q, elt)
            row = dict(common, same_bits=same, max_abs_err=err, atol=atol,
                       rtol=FAMILY_RTOL[dname],
                       ms=time_ms(lambda: ssd_fwd(*ins, chunk=q)),
                       plain_ms=time_ms(lambda: ref.ssd_ref(*ins, chunk=q),
                                        iters=10),
                       **ssd_bounds(nbytes, flops, dname),
                       bytes=nbytes, flops=flops, library_ms=None)
            print(f"[ssd] {json.dumps(row)}")
            results["ssd"].append(row)
            del got, want
            # the backward: six gradients against the plain backward
            grads = ssd_bwd(*ins, dy, chunk=q)
            again = ssd_bwd(*ins, dy, chunk=q)
            same = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
            wants = ref.ssd_bwd_ref(*ins, dy, chunk=q)
            torch.cuda.synchronize()
            errs = {}
            for gname, g, w in zip(SSD_GRADS, grads, wants):
                errs[gname] = _family_check(
                    f"ssd_bwd {case['name']} {dname} {gname}", g, w,
                    dname)[0]
            require(same, f"ssd_bwd {case['name']} {dname}: two runs differ")
            nbytes, flops = ssd_bwd_work(b, s_, h, p, n, q, elt)
            row = dict(common, same_bits=same, max_abs_err=max(errs.values()),
                       errs=errs, rtol=FAMILY_RTOL[dname],
                       ms=time_ms(lambda: ssd_bwd(*ins, dy, chunk=q)),
                       plain_ms=time_ms(lambda: ref.ssd_bwd_ref(
                           *ins, dy, chunk=q), iters=10),
                       **ssd_bounds(nbytes, flops, dname),
                       bytes=nbytes, flops=flops, library_ms=None)
            print(f"[ssd_bwd] {json.dumps(row)}")
            results["ssd_bwd"].append(row)
            del ins, dy, grads, again, wants
            torch.cuda.empty_cache()
    results["moe_gmm"] = _gmm_rows(40, 8, GMM_CASES)
    # granite's attention: 24 q / 8 kv heads of 64 (a group of 3) at its
    # training call's shape, b 4 x 1024: phase 5's case (its rows when
    # phase 5 ran)
    case = next(c for c in FLASH_CASES if c["name"] == "gqa3")
    for dname in ("float32", "bfloat16"):
        frow, brow = _flash_rows(case, dname)
        results["flash_attention"].append(frow)
        results["flash_attention_bwd"].append(brow)
    return results


def _gmm_rows(e: int, k: int, cases) -> list:
    """The grouped matmul's forward and both backward products, as
    training launches them, at ``e`` experts, top ``k``, each case's
    (name, tokens, D, F) at capacity factor 1.25: against the plain
    version (bf16 twice for the same bits), timed beside the bound, the
    plain version and ``torch.bmm`` (a yardstick only)."""
    import torch
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels.bounds import moe_gmm_work
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_bwd
    from repro_torch.models.moe import capacity

    rows = []
    for name, tokens, d, f in cases:
        c = capacity(tokens, k, e, 1.25)
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            gen = torch.Generator(device="cuda").manual_seed(6)
            x = torch.randn(e, c, d, generator=gen, device="cuda").to(dtype)
            w = (0.05 * torch.randn(e, d, f, generator=gen, device="cuda")
                 ).to(dtype)
            dy = torch.randn(e, c, f, generator=gen, device="cuda").to(dtype)
            wt, xt = w.transpose(1, 2), x.transpose(1, 2)
            # the forward and the backward's two products (dx = dy w^T,
            # dw = x^T dy) as training launches them: moe_gmm and
            # moe_gmm_bwd, one launch each; op(a) @ op(b) is the product
            # (the plain version and torch.bmm take the transposed views)
            for prod, run, (a, bmat), layout in (
                    ("fwd", lambda: moe_gmm(x, w), (x, w), (x, w)),
                    ("dx", lambda: moe_gmm_bwd(x, w, dy, need_dw=False)[0],
                     (dy, wt), (dy, w)),
                    ("dw", lambda: moe_gmm_bwd(x, w, dy, need_dx=False)[1],
                     (xt, dy), (x, dy))):
                got = run()
                want = ref.moe_gmm_ref(a, bmat)
                same = dname == "float32" or torch.equal(got, run())
                torch.cuda.synchronize()
                err, atol = _family_check(
                    f"moe_gmm {name} {prod} {dname}", got, want, dname)
                require(same, f"moe_gmm {name} {prod} {dname}: two runs "
                              f"differ")
                ee, cc, dd = a.shape
                ff = bmat.shape[2]
                nbytes, flops = moe_gmm_work(ee, cc, dd, ff,
                                             x.element_size())
                bound = _bound(nbytes, flops, dname)
                row = dict(case=name, product=prod, dtype=dname, e=ee, c=cc,
                           d=dd, f=ff, tokens=tokens,
                           path=autotune.gemm_path(*layout), same_bits=same,
                           max_abs_err=err, atol=atol,
                           rtol=FAMILY_RTOL[dname], ms=time_ms(run),
                           plain_ms=time_ms(
                               lambda: ref.moe_gmm_ref(a, bmat)),
                           bound_ms=bound[0], bound_by=bound[1],
                           library_ms=time_ms(lambda: torch.bmm(a, bmat)))
                print(f"[moe_gmm] {json.dumps(row)}")
                rows.append(row)
                del got, want
            del x, w, dy, wt, xt
            torch.cuda.empty_cache()
    return rows


def _record_routing(moe_mod, log):
    """Wrap ``moe.route`` and ``moe.dispatch_positions`` so that each MoE
    call appends its experts, kept mask and the gap between the k-th and
    (k+1)-th routing probability of every token to ``log``; returns the
    function that restores them."""
    import torch
    route, dispatch = moe_mod.route, moe_mod.dispatch_positions

    def rec_route(x2d, router_w, top_k):
        w, e, aux = route(x2d, router_w, top_k)
        with torch.no_grad():
            probs = torch.softmax(torch.matmul(x2d.float(),
                                               router_w.float()), dim=-1)
            top = probs.topk(top_k + 1, dim=-1).values
        log.append(dict(experts=e.detach().cpu(),
                        gap=(top[:, top_k - 1] - top[:, top_k]).cpu()))
        return w, e, aux

    def rec_dispatch(experts_flat, num_experts, cap):
        posf, keep = dispatch(experts_flat, num_experts, cap)
        log[-1]["keep"] = keep.detach().cpu()
        return posf, keep

    moe_mod.route, moe_mod.dispatch_positions = rec_route, rec_dispatch

    def restore():
        moe_mod.route, moe_mod.dispatch_positions = route, dispatch
    return restore


def _family_launches(cfg, passes: int, *, split: int = 1,
                     remat: bool = False, fine: bool = True) -> dict:
    """Kernel launches of ``passes`` forward + backward passes over
    ``split`` sub-batches: per layer and sub-batch the norms (``ln`` and,
    in attention and RG-LRU layers, ``ln2``; in SSD layers the gated
    ``norm_g``; in cross layers also ``c_ln``; with post-norms ``pn1``
    after an attention part and ``pn2`` after a SwiGLU part) forward and
    backward, SSD layers the SSD forward and backward, RG-LRU layers the
    RG-LRU forward and backward, attention layers (global or local) the
    flash forward and backward, cross layers those twice (self and
    cross), MoE FFNs 3 expert products forward and 2 each backward;
    ``final_ln`` once a pass on the merged batch; an encoder, once a pass
    on the whole batch, its layers' two norms and flash attention and its
    final norm.  Recomputation (fine or coarse: both replay every forward
    kernel of the layer's parts, since each one's output is saved by the
    op after it) runs each layer's forward kernels twice; the post-norms
    run after the exit, outside a fine replay (``fine``), inside a coarse
    one."""
    from repro_torch.configs.base import CROSS_ATTN, RGLRU, SSD
    from repro_torch.models.params import stack_layout
    n_rep, pat, tail = stack_layout(cfg)
    kinds = list(pat) * n_rep + list(tail)
    fwd = 2 if remat else 1
    per = passes * split               # runs of each layer
    norms = sum(3 if k == CROSS_ATTN else 2 for k in kinds)
    post = sum((k not in (SSD, RGLRU)) + (k != SSD and cfg.moe is None)
               for k in kinds) if cfg.post_norms else 0
    enc = cfg.encoder_layers
    once = 1 + (2 * enc + 1 if enc else 0)   # final norms, encoder norms
    want = {**SERVE_ONLY, "paged_decode": 0,
            "rmsnorm": passes * ((norms * fwd
                                  + post * (1 if fine else fwd)) * split
                                 + once),
            "rmsnorm_bwd": passes * ((norms + post) * split + once)}
    want["flash_attention"] += passes * enc
    want["flash_attention_bwd"] += passes * enc
    for kind in kinds:
        if kind == SSD:
            want["ssd"] += per * fwd
            want["ssd_bwd"] += per
        elif kind == RGLRU:
            want["rglru"] += per * fwd
            want["rglru_bwd"] += per
        else:
            n = 2 if kind == CROSS_ATTN else 1
            want["flash_attention"] += n * per * fwd
            want["flash_attention_bwd"] += n * per
        if kind != SSD and cfg.moe is not None:
            want["moe_gmm"] += per * (3 * fwd + 6)
    return want


def phase_family_consistency():
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.schedule import effective_split
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import params as prm

    out = {}
    batch_size, seq = 2, 256
    for arch in (SSD_ARCH, MOE_ARCH):
        cfg = get_config(arch).replace(num_layers=2, dtype="float32")
        base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
        batch = make_batch(DataConfig(global_batch=batch_size, seq_len=seq,
                                      vocab_size=cfg.vocab_size), 0)
        for sched, hkw in FAMILY_SCHEDULES.items():
            hp = TrainHParams(**hkw)
            split = effective_split(hp.schedule, hp.split, batch_size)
            out[f"{arch}/{sched}"] = _family_pair(
                cfg, base, batch, hp, split, arch, sched)
        del base
    return out


def _loss_pass(cfg, base, batch, hp, dev, dtype="float32",
               grads_on="cpu"):
    """One forward + backward of ``lm.train_loss`` on ``dev`` from the
    weights ``base`` (a CPU tree) cast to ``dtype`` -> loss, aux, seconds,
    launches, the MoE routing of every call, and the gradients on
    ``grads_on``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import params as prm

    # a new leaf on each device (``to`` returns base's own tensor on the
    # CPU, whose grad the next schedule would add to)
    params = prm.unflatten({
        k: t.detach().to(dev, getattr(torch, dtype)).requires_grad_()
        for k, t in prm.flatten(base).items()})
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    log = []
    restore = _record_routing(moe_mod, log)
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        loss, aux = lm.train_loss(cfg, params, tb, hp)
        loss.backward()
    finally:
        restore()
    if dev == "cuda":
        torch.cuda.synchronize()
    return dict(
        loss=loss.item(), aux=aux.item(), s=time.perf_counter() - t0,
        launches=dict(_build.LAUNCHES), routing=log,
        grads={k: None if t.grad is None else t.grad.detach().to(grads_on)
               for k, t in prm.flatten(params).items()})


def _worst(errs, n=5):
    """The ``n`` largest of a {leaf: error} dict, as (error, leaf)."""
    return sorted(((e, k) for k, e in errs.items()), reverse=True)[:n]


def _family_pair(cfg, base, batch, hp, split, arch, sched, *,
                 loss_rtol=LOSS_RTOL, grads_tol=GRADS_TOL, cpu=None,
                 witness=None, grads_on="cpu"):
    """One f32 forward + backward of ``lm.train_loss`` on the card and on
    the CPU from the same weights and batch: routing token by token (every
    MoE call, recomputations included), loss, aux, gradients and the card's
    exact launches, within ``loss_rtol`` and ``grads_tol`` (GRADS_TOL
    unless the phase sets its own).  ``cpu``: a reference pass
    (``_loss_pass``) the phase already holds, in place of a new CPU pass:
    a CPU pass, or phase 18's f64 witness of the plain versions on the
    card.  ``witness``: the
    gradients of an f64 pass, against which both passes are measured
    too.  ``grads_on``: where the card pass leaves its gradients and the
    comparisons run (the other gradients must lie there too)."""
    import torch

    name = f"{arch} {sched}"
    g = _loss_pass(cfg, base, batch, hp, "cuda", grads_on=grads_on)
    c = cpu if cpu is not None else _loss_pass(cfg, base, batch, hp, "cpu")
    bad = [k for k, t in g["grads"].items()
           if t is None or not bool(torch.isfinite(t).all())]
    require(not bad, f"{name}: missing or non-finite card gradients {bad}")
    want = _family_launches(cfg, 1, split=split, remat=hp.remat)
    require(g["launches"] == want,
            f"{name}: card pass launched {g['launches']}, expected {want}")
    require(not any(c["launches"].values()),
            f"{name}: CPU pass launched kernels: {c['launches']}")
    routing = None
    if cfg.moe is not None:
        # each layer routes once a sub-batch, and again in its replay
        calls = cfg.num_layers * split * (2 if hp.remat else 1)
        diffs = []
        for call, (rg, rc) in enumerate(zip(g["routing"], c["routing"])):
            tok = ((rg["experts"] != rc["experts"]).any(dim=1)
                   | (rg["keep"] != rc["keep"]).reshape(
                       rg["experts"].shape).any(dim=1))
            for t in tok.nonzero()[:, 0].tolist():
                diffs.append(dict(call=call, token=t,
                                  card=rg["experts"][t].tolist(),
                                  cpu=rc["experts"][t].tolist(),
                                  gap_cpu=float(rc["gap"][t])))
        routing = dict(calls=len(g["routing"]),
                       tokens=int(g["routing"][0]["experts"].shape[0]),
                       differing=diffs[:20], n_differing=len(diffs),
                       min_gap=min(float(r["gap"].min())
                                   for r in c["routing"]))
        print(f"[family_routing] {name} {json.dumps(routing)}")
        require(len(g["routing"]) == len(c["routing"]) == calls,
                f"{name}: routed {len(g['routing'])} / "
                f"{len(c['routing'])} times, expected {calls}")
        require(not diffs, f"{name}: routing differs card vs CPU at "
                           f"{len(diffs)} tokens (see above)")
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    leaf_errs = {k: grads_err({k: c["grads"][k]}, {k: g["grads"][k]})
                 for k in c["grads"]}
    gerr = max(leaf_errs.values())
    wit = None
    if witness is not None:
        wit = {}
        for dev, run in (("card", g), ("cpu", c)):
            errs = {k: grads_err({k: w}, {k: run["grads"][k]})
                    for k, w in witness.items()}
            wit[dev] = dict(grads_err=max(errs.values()),
                            worst_leaves=_worst(errs, 3))
    res = dict(arch=arch, schedule=hp.schedule, remat=hp.remat,
               fine_remat=hp.fine_remat, split=split, layers=cfg.num_layers,
               d_model=cfg.d_model, dtype="float32",
               batch=int(batch["tokens"].shape[0]),
               seq=int(batch["tokens"].shape[1]), loss_card=g["loss"],
               loss_cpu=c["loss"], aux_card=g["aux"], aux_cpu=c["aux"],
               loss_rel_err=loss_rel, loss_rtol=loss_rtol,
               grads_err=gerr, grads_tol=grads_tol,
               worst_leaves=_worst(leaf_errs), witness=wit,
               launches=g["launches"], routing=routing,
               card_s=g["s"], cpu_s=c["s"])
    print(f"[family_consistency] {json.dumps(res)}")
    require(loss_rel <= loss_rtol,
            f"{name}: loss card {g['loss']} vs CPU {c['loss']}: rel "
            f"{loss_rel}")
    require(abs(g["aux"] - c["aux"]) <= 1e-6,
            f"{name}: aux card {g['aux']} vs CPU {c['aux']}")
    require(gerr <= grads_tol, f"{name}: grads_err {gerr} > {grads_tol}")
    return res


def phase_family_train():
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.runtime import Trainer

    out = {}
    for arch, (layers, batch, seq, micro) in FAMILY_TRAIN.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        steps = FAMILY_STEPS
        hp = TrainHParams(learning_rate=3e-4, total_steps=steps,
                          warmup_steps=max(steps // 20, 1),
                          microbatch=micro, **TP1_SCHEDULE)
        tr = Trainer(cfg, hp, global_batch=batch, seq_len=seq, log_fn=None)
        require(tr.device.type == "cuda", f"trainer chose {tr.device}")
        _build.reset_launches()
        first = tr.train(1, seed=0)
        leaves = prm.flatten(tr.params)
        bad = [k for k, t in leaves.items()
               if t.grad is None or not bool(torch.isfinite(t.grad).all())]
        require(not bad, f"{arch}: missing or non-finite gradients after "
                         f"step 1: {bad}")
        rest = tr.train(steps, seed=0)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses = first["losses"] + rest["losses"]
        times = first["step_times"] + rest["step_times"]
        require(len(losses) == steps and all(np.isfinite(losses)),
                f"{arch}: losses {losses}")
        want = _family_launches(cfg, steps * micro)
        require(launches == want,
                f"{arch}: train launched {launches}, expected {want}")
        med = statistics.median(1e3 * t for t in times[2:])
        res = dict(arch=arch, dtype=cfg.dtype, layers=cfg.num_layers,
                   d_model=cfg.d_model,
                   params=sum(t.numel() for t in leaves.values()),
                   batch=batch, seq=seq, microbatch=micro, steps=steps,
                   losses=losses, step_ms=[1e3 * t for t in times],
                   step_ms_median=med,
                   tokens_per_s=batch * seq / (med / 1e3),
                   peak_mem_gb=peak / 1e9, launches=launches,
                   launches_per_step={k: v / steps for k, v in
                                      launches.items() if v},
                   arg_bytes=_state_bytes(tr))
        print(f"[family_train] {json.dumps(res)}")
        res["profile"] = _profile_train_step(tr)
        print(f"[family_train_profile] {arch} {json.dumps(res['profile'])}")
        del tr, first, rest, leaves
        torch.cuda.empty_cache()
        res["launcher"] = _family_launcher(arch)
        out[arch] = res
    return out


def _family_launcher(arch) -> dict:
    """``launch/train.py --arch <arch>`` with its defaults (oases, split
    2, fine recomputation) at the family's full depth and FAMILY_LAUNCH's
    batch: finite losses and the exact launches of its steps."""
    import contextlib
    import io

    import numpy as np
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.schedule import effective_split
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launcher

    batch, seq, micro = FAMILY_LAUNCH[arch]
    steps = FAMILY_LAUNCH_STEPS
    cfg = get_config(arch)
    hp = TrainHParams()
    split = effective_split(hp.schedule, hp.split, batch // max(micro, 1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        launcher.main(["--arch", arch, "--steps", str(steps), "--batch",
                       str(batch), "--seq", str(seq), "--microbatch",
                       str(micro)])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    text = buf.getvalue()                   # the trainer's log, then JSON
    res = dict(json.loads(text[text.index("{"):]), arch=arch,
               layers=cfg.num_layers, batch=batch, seq=seq,
               microbatch=micro, steps=steps, schedule=hp.schedule,
               split=split, fine_remat=hp.remat and hp.fine_remat,
               s=time.perf_counter() - t0,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches)
    print(f"[family_launcher] {json.dumps(res)}")
    require(np.isfinite([res["first_loss"], res["last_loss"]]).all(),
            f"{arch}: launcher losses {res}")
    want = _family_launches(cfg, steps * max(micro, 1), split=split,
                            remat=hp.remat)
    require(launches == want,
            f"{arch}: launcher launched {launches}, expected {want}")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the RG-LRU hybrid at tp=1 (phases 17-19)
# ---------------------------------------------------------------------------
HYBRID_ARCH = "recurrentgemma-9b"
# phase 17: RG-LRU cases: recurrentgemma-9b's width 4096 at the slice's
# b 2 x s 4096; a ragged one (s not a multiple of the kernels' 64-step
# tile, w not a multiple of a block's 32 channels); and `odd`, whose row
# pitch (1001 values) 16-byte copies cannot take, so every block loads
# with plain loads
RGLRU_CASES = [dict(name="slice", b=2, s=4096, w=4096),
               dict(name="ragged", b=1, s=1000, w=1000),
               dict(name="odd", b=3, s=77, w=1001)]
# phase 17: flash at recurrentgemma-9b's local attention, 16 q heads and
# 1 kv head of 256 (16:1 MQA), b 2 x s 4096, with its window 2048 and
# without a window (timed over 10 calls, the plain versions over 5: the
# f32 rows take 12-63 ms a call)
HD256_CASES = [dict(name="mqa256_window", b=2, s=4096, h=16, kvh=1, hd=256,
                    window=2048, iters=10, plain_iters=5),
               dict(name="mqa256", b=2, s=4096, h=16, kvh=1, hd=256,
                    iters=10, plain_iters=5),
               # the ragged edge at hd 256, and s under one tile
               dict(name="mqa256_ragged", b=2, s=1000, h=16, kvh=1, hd=256,
                    window=300),
               dict(name="mqa256_short", b=2, s=40, h=16, kvh=1, hd=256)]
# phase 18: the card in f32 at full width and depth 5 (one (rglru,
# rglru, local) block and a tail of two RG-LRU layers), b 1 x 2304 (longer
# than the window 2048), under FAMILY_SCHEDULES, against an f64 pass of
# the plain versions on the card from the same weights (the witness);
# loss within 1e-6 relative.  Gradients: f32 arithmetic whose rounding
# over five full-width layers reaches sums that cancel (the last RG-LRU
# layer's w_a); a card pass with TF32 products (the control) is a less
# exact pass.  HYBRID_GRADS_TOL sits between the largest sound reading
# (card vs CPU 1.031e-5; card vs witness 5.8e-6) and the fault readings:
# rope's frequencies computed on each device (3.93e-5 card vs CPU) and
# the control, which must exceed it.
HYBRID_CONSISTENCY = (5, 1, 2304)
HYBRID_LOSS_RTOL = 1e-6
HYBRID_GRADS_TOL = 2e-5
# phase 19: the Trainer in bf16 at full width and depth 8 (two blocks and
# a tail of two, 2.63 B parameters), batch 2 x 4096, microbatch auto (1):
# the launcher's default (oases, split 2, fine recomputation) and megatron
# without recomputation
HYBRID_TRAIN = (8, 2, 4096)
HYBRID_SCHEDULES = {"oases_fine": dict(schedule="oases", remat=True,
                                       fine_remat=True),
                    "megatron": dict(schedule="megatron", remat=False)}
HYBRID_STEPS = 3


def _rglru_inputs(b, s, w, dtype, seed=9):
    """x ~ N(0, 1) in ``dtype``, gate vectors spreading the decay a over
    (0, 1) (w_a, w_x ~ N(0, 1), b_a, b_x ~ 0.5 N(0, 1), a_param ~ N(0, 1)),
    dy ~ N(0, 1) in ``dtype``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = rnd(b, s, w).to(dtype)
    gates = (rnd(w), 0.5 * rnd(w), rnd(w), 0.5 * rnd(w), rnd(w))
    return x, gates, rnd(b, s, w).to(dtype)


def _sass_counts(sass: str, names: str) -> dict:
    """Static instruction counts of the kernels ``names`` (a regex
    alternation) in ``cuobjdump -sass`` output: per instance, every
    instruction but NOPs, and the special-function ones (MUFU)."""
    rep, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _instance(m.group(1), names)
            if cur:
                rep[cur] = {"instructions": 0, "mufu": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if cur and m and m.group(1) != "NOP":
            rep[cur]["instructions"] += 1
            rep[cur]["mufu"] += m.group(1).startswith("MUFU")
    return rep


def _rglru_sass() -> dict:
    """:func:`_sass_counts` of the RG-LRU kernels as built (``cuobjdump``
    beside nvcc); {} where the toolkit has none."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass",
                          str(_build.BUILD_DIR / "rglru.o")],
                         capture_output=True, text=True, check=True,
                         timeout=120)
    return _sass_counts(out.stdout, _RGLRU_NAMES)


def _max_sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi``), for the MUFU floor."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return 1e6 * float(smi.stdout.strip().splitlines()[0])


def phase_hybrid_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bounds import (RGLRU_MUFU, mufu_ms,
                                            rglru_bwd_work,
                                            rglru_states_bytes, rglru_work)
    from repro_torch.kernels.rglru import rglru_bwd, rglru_fwd, tile_states

    clock = _max_sm_clock_hz()
    sass = _rglru_sass()
    print(f"[rglru] SASS (static counts) {json.dumps(sass)}; "
          f"max SM clock {clock / 1e9:.3f} GHz")
    results = {"rglru": [], "rglru_bwd": [], "flash_attention": [],
               "flash_attention_bwd": [], "rglru_sass": sass,
               "sm_clock_max_hz": clock}
    for case in RGLRU_CASES:
        b, s_, w = case["b"], case["s"], case["w"]
        for dname in ("float32", "bfloat16"):
            x, gates, dy = _rglru_inputs(b, s_, w, getattr(torch, dname))
            gd = dict(zip(ref.RGLRU_GATES, gates))
            y, h0 = rglru_fwd(x, gates, states=True)
            y_plain, none = rglru_fwd(x, gates)
            grads = rglru_bwd(x, gates, h0, dy)
            # each kernel again, for the same bits
            y2, h02 = rglru_fwd(x, gates, states=True)
            grads2 = rglru_bwd(x, gates, h0, dy)
            want_h = ref.rglru_states_ref(x, gd)
            want_grads = ref.rglru_bwd_ref(x, gd, want_h, dy)
            torch.cuda.synchronize()
            name = f"{case['name']} {dname}"
            require(none is None and torch.equal(y, y_plain),
                    f"rglru {name}: y with states differs from y without")
            require(torch.equal(y, y2) and torch.equal(h0, h02)
                    and all(torch.equal(a, c) for a, c in zip(grads, grads2)),
                    f"rglru {name}: a second run gave other bits")
            ferr = dict(zip(("y", "h0"), (
                _family_check(f"rglru {name} y", y, want_h.to(x.dtype),
                              dname)[0],
                _family_check(f"rglru {name} h0", h0, tile_states(want_h),
                              "float32")[0])))
            berr = {g: _family_check(f"rglru_bwd {name} d{g}", got, want,
                                     dname if g == "x" else "float32")[0]
                    for g, got, want in zip(("x",) + ref.RGLRU_GATES, grads,
                                            want_grads)}
            elt = x.element_size()
            n = b * s_ * w
            common = dict(case=case["name"], dtype=dname, b=b, s=s_, w=w,
                          library_ms=None, same_bits_twice=True)
            nbytes, flops = rglru_work(b, s_, w, elt)
            bound = _bound(nbytes, flops, "float32")
            frow = dict(common, max_abs_err=max(ferr.values()), errs=ferr,
                        ms=time_ms(lambda: rglru_fwd(x, gates, states=True)),
                        ms_stateless=time_ms(lambda: rglru_fwd(x, gates)),
                        plain_ms=time_ms(lambda: ref.rglru_ref(x, gd),
                                         iters=5, warmup=1),
                        bound_ms=bound[0], bound_by=bound[1], bytes=nbytes,
                        flops=flops,
                        states_bytes=rglru_states_bytes(b, s_, w),
                        mufu_floor_ms=mufu_ms(RGLRU_MUFU["forward"] * n,
                                              clock),
                        y_states_equal_y=True)
            nbytes, flops = rglru_bwd_work(b, s_, w, elt)
            bound = _bound(nbytes, flops, "float32")
            brow = dict(common, max_abs_err=max(berr.values()), errs=berr,
                        states_bytes=rglru_states_bytes(b, s_, w),
                        ms=time_ms(lambda: rglru_bwd(x, gates, h0, dy)),
                        plain_ms=time_ms(lambda: ref.rglru_bwd_ref(
                            x, gd, want_h, dy), iters=5, warmup=1),
                        bound_ms=bound[0], bound_by=bound[1], bytes=nbytes,
                        flops=flops,
                        mufu_floor_ms=mufu_ms(RGLRU_MUFU["backward"] * n,
                                              clock))
            print(f"[rglru] {json.dumps(frow)}")
            print(f"[rglru_bwd] {json.dumps(brow)}")
            results["rglru"].append(frow)
            results["rglru_bwd"].append(brow)
            del x, gates, dy, y, h0, y_plain, y2, h02, want_h, grads, \
                grads2, want_grads
            torch.cuda.empty_cache()
    for case in HD256_CASES:
        for dname in ("float32", "bfloat16"):
            frow, brow = _flash_rows(case, dname)
            results["flash_attention"].append(frow)
            results["flash_attention_bwd"].append(brow)
    return results


@contextlib.contextmanager
def _plain_on_card():
    """For the block, every kernel wrapper takes its plain version, on the
    card's tensors too (``_build.on_cpu`` answers True): phase 18's f64
    witness, which no kernel computes."""
    from repro_torch.kernels import _build
    on_cpu = _build.on_cpu
    _build.on_cpu = lambda what, *tensors: True
    try:
        yield
    finally:
        _build.on_cpu = on_cpu


def phase_hybrid_consistency():
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.schedule import effective_split
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import params as prm

    layers, batch_size, seq = HYBRID_CONSISTENCY
    cfg = get_config(HYBRID_ARCH).replace(num_layers=layers,
                                          dtype="float32")
    marks = [("start", time.perf_counter())]
    # drawn on the card (fast), held on the CPU
    base = prm.unflatten({k: t.cpu() for k, t in prm.flatten(
        prm.init_params(cfg, seed=0, device=torch.device("cuda"))).items()})
    torch.cuda.empty_cache()
    batch = make_batch(DataConfig(global_batch=batch_size, seq_len=seq,
                                  vocab_size=cfg.vocab_size), 0)
    megatron = TrainHParams(**FAMILY_SCHEDULES["megatron"])
    marks.append(("weights", time.perf_counter()))
    # the witness on the card in f64: the plain versions (no kernel takes
    # f64) and cuBLAS's f64 products, independent of the f32 path's.
    # Every gradient is compared on the card (the same f32 subtraction
    # and maximum as on the host, without copying 8 GB sets across and
    # first-touching them in host memory)
    with _plain_on_card():
        wit = _loss_pass(cfg, base, batch, megatron, "cuda", "float64",
                         grads_on="cuda")
    # rounded once to f32 (6e-8 of each value) to hold less memory
    witness = {k: t.float() for k, t in wit["grads"].items()}
    wit["grads"] = witness
    out = {"witness": dict(loss=wit["loss"], s=wit["s"])}
    torch.cuda.empty_cache()
    marks.append(("witness", time.perf_counter()))
    # the witness is both card schedules' reference (in the place of the
    # f32 CPU pass, 65-91 s, which the witness held within 2.4e-6 on
    # every run it stood beside): at batch 1 (split 1) they compute the
    # same sums in the same order
    for sched, hkw in FAMILY_SCHEDULES.items():
        hp = TrainHParams(**hkw)
        split = effective_split(hp.schedule, hp.split, batch_size)
        out[sched] = _family_pair(
            cfg, base, batch, hp, split, HYBRID_ARCH, sched,
            loss_rtol=HYBRID_LOSS_RTOL, grads_tol=HYBRID_GRADS_TOL, cpu=wit,
            grads_on="cuda")
        torch.cuda.empty_cache()
        marks.append((sched, time.perf_counter()))
    del wit
    # the control: the card pass with TF32 products
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = _loss_pass(cfg, base, batch, megatron, "cuda",
                         grads_on="cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    errs = {k: grads_err({k: w}, {k: ctl["grads"][k]})
            for k, w in witness.items()}
    out["tf32_control"] = dict(grads_err=max(errs.values()),
                               worst_leaves=_worst(errs, 3),
                               loss=ctl["loss"])
    marks.append(("tf32_control", time.perf_counter()))
    # where the phase's wall time goes (host seconds a step)
    out["wall_s"] = {name: b - a for (_, a), (name, b)
                     in zip(marks, marks[1:])}
    out["cpu_threads"] = torch.get_num_threads()
    print(f"[hybrid_witness] {json.dumps(out['witness'])} "
          f"{json.dumps(out['tf32_control'])} wall_s "
          f"{json.dumps(out['wall_s'])} threads {out['cpu_threads']}")
    require(out["tf32_control"]["grads_err"] > HYBRID_GRADS_TOL,
            f"the TF32 control's grads_err "
            f"{out['tf32_control']['grads_err']} does not exceed "
            f"{HYBRID_GRADS_TOL}: the gate would not see it")
    return out


def phase_hybrid_train():
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.schedule import effective_split
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.runtime import Trainer

    layers, batch, seq = HYBRID_TRAIN
    cfg = get_config(HYBRID_ARCH).replace(num_layers=layers)
    steps = HYBRID_STEPS
    out = {}
    for sched, hkw in HYBRID_SCHEDULES.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        hp = TrainHParams(learning_rate=3e-4, total_steps=steps,
                          warmup_steps=max(steps // 20, 1), **hkw)
        tr = Trainer(cfg, hp, global_batch=batch, seq_len=seq, log_fn=None)
        require(tr.device.type == "cuda", f"trainer chose {tr.device}")
        micro = max(tr.hp.microbatch, 1)
        require(micro == 1, f"{sched}: auto microbatch {micro}, expected 1")
        _build.reset_launches()
        first = tr.train(1, seed=0)
        leaves = prm.flatten(tr.params)
        bad = [k for k, t in leaves.items()
               if t.grad is None or not bool(torch.isfinite(t.grad).all())]
        require(not bad, f"{sched}: missing or non-finite gradients after "
                         f"step 1: {bad}")
        rest = tr.train(steps, seed=0)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses = first["losses"] + rest["losses"]
        times = first["step_times"] + rest["step_times"]
        require(len(losses) == steps and all(np.isfinite(losses))
                and losses[-1] < losses[0], f"{sched}: losses {losses}")
        split = effective_split(hp.schedule, hp.split, batch)
        want = _family_launches(cfg, steps, split=split, remat=hp.remat)
        require(launches == want,
                f"{sched}: train launched {launches}, expected {want}")
        med = statistics.median(1e3 * t for t in times[1:])
        flops = _hybrid_model_flops(cfg, batch, seq)
        res = dict(arch=HYBRID_ARCH, schedule=hp.schedule, remat=hp.remat,
                   fine_remat=hp.fine_remat, split=split, dtype=cfg.dtype,
                   layers=cfg.num_layers, d_model=cfg.d_model,
                   params=sum(t.numel() for t in leaves.values()),
                   batch=batch, seq=seq, microbatch=micro, steps=steps,
                   losses=losses, step_ms=[1e3 * t for t in times],
                   step_ms_median=med,
                   tokens_per_s=batch * seq / (med / 1e3),
                   model_tflop_per_step=flops / 1e12,
                   mfu=flops / (med / 1e3) / H100_BF16_FLOPS,
                   peak_mem_gb=peak / 1e9, launches=launches,
                   launches_per_step={k: v / steps for k, v in
                                      launches.items() if v},
                   arg_bytes=_state_bytes(tr))
        print(f"[hybrid_train] {json.dumps(res)}")
        res["profile"] = _profile_train_step(tr)
        print(f"[hybrid_train_profile] {sched} "
              f"{json.dumps(res['profile'])}")
        out[sched] = res
        del tr, first, rest, leaves
    torch.cuda.empty_cache()
    return out


def _hybrid_model_flops(cfg, batch, seq):
    """6 x matmul weights (embedding table excluded, the tied head
    included) x tokens, plus windowed attention's 3 x 4 b hd h pairs per
    local layer (q.k and p.v forward, twice that backward)."""
    from repro_torch.configs.base import RGLRU
    from repro_torch.kernels.bounds import visible_pairs
    from repro_torch.models.params import stack_layout
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    w = cfg.rglru_width or d
    n_rep, pat, tail = stack_layout(cfg)
    weights, attn = d * cfg.padded_vocab(), 0
    for kind in list(pat) * n_rep + list(tail):
        weights += 3 * d * f
        if kind == RGLRU:
            weights += 3 * d * w
        else:
            weights += 2 * d * cfg.num_heads * hd \
                + 2 * d * cfg.num_kv_heads * hd
            attn += 3 * 4 * hd * cfg.num_heads * batch \
                * visible_pairs(seq, cfg.window)
    return 6 * weights * batch * seq + attn


# ---------------------------------------------------------------------------
# the planner (phase 20)
# ---------------------------------------------------------------------------
PLAN_STEPS = 3
# a calibrated rate against the data sheet's: above 1.05x no card reads, so
# the probe is wrong; below 0.3x it timed launches or L2
CAL_GATE = (0.3, 1.05)


@contextlib.contextmanager
def _cal_cache():
    """A fresh calibration cache for the block: ``REPRO_CAL_CACHE`` a new
    temporary directory (yielded), ``REPRO_NO_CALIBRATE`` unset, the
    in-process memo empty; the environment restored after."""
    import os
    import tempfile

    from repro_torch.core.planner import calibrate
    saved = {k: os.environ.pop(k, None)
             for k in ("REPRO_CAL_CACHE", "REPRO_NO_CALIBRATE")}
    try:
        with tempfile.TemporaryDirectory() as cache:
            os.environ["REPRO_CAL_CACHE"] = cache
            calibrate._MEM_CACHE.clear()
            yield cache
    finally:
        calibrate._MEM_CACHE.clear()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _planned_run(argv, want) -> dict:
    """``launch/train.py`` with ``argv``, its launches counted from 0 over
    the run (exactly ``want``)."""
    import contextlib
    import io

    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launcher

    torch.cuda.empty_cache()
    buf = io.StringIO()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = launcher.main(argv)
    torch.cuda.synchronize()
    out = dict(out, launches=dict(_build.LAUNCHES),
               s=time.perf_counter() - t0,
               log=[ln for ln in buf.getvalue().splitlines()
                    if ln.startswith(("planner:", "[plan]"))])
    require(out["launches"] == want,
            f"{argv}: launched {out['launches']}, expected {want}")
    return out


def phase_planner():
    import os

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.plan import LayerStrategy, ParallelPlan
    from repro_torch.core.planner import calibrate
    from repro_torch.kernels import bounds

    card = _card()
    cfg = get_config(TRAIN_ARCH)
    batch, seq, micro = 8, 1024, 2
    n, passes = cfg.num_layers, PLAN_STEPS * micro
    want = {**SERVE_ONLY, "paged_decode": 0, "rmsnorm": passes * (2 * n + 1),
            "rmsnorm_bwd": passes * (2 * n + 1),
            "flash_attention": passes * n, "flash_attention_bwd": passes * n}
    base = ["--arch", TRAIN_ARCH, "--steps", str(PLAN_STEPS), "--batch",
            str(batch), "--seq", str(seq), "--seed", "0"]
    with _cal_cache() as cache:
        t0 = time.perf_counter()
        hw = calibrate.calibrated_hw(n_chips=1)
        cal_s = time.perf_counter() - t0
        files = sorted(os.listdir(cache))
        require(len(files) == 1 and files[0].startswith("torchcal-"),
                f"calibration cache holds {files}")
        total = torch.cuda.get_device_properties(0).total_memory
        cal = dict(card=card, peak_flops=hw.peak_flops,
                   hbm_bw=hw.hbm_bw, hbm_cap=hw.hbm_cap,
                   device_total_memory=total, s=cal_s,
                   flops_share=hw.peak_flops
                   / bounds.PEAK_FLOPS["bfloat16"],
                   bw_share=hw.hbm_bw / bounds.PEAK_BYTES,
                   link_bw=hw.link_bw, cache_file=files[0])
        print(f"[planner_calibration] {json.dumps(cal)}")
        for what in ("flops_share", "bw_share"):
            require(CAL_GATE[0] <= cal[what] <= CAL_GATE[1],
                    f"calibrated {what} {cal[what]:.3f} outside "
                    f"{CAL_GATE}: {cal}")
        require(hw.hbm_cap == total, f"hbm_cap {hw.hbm_cap} is not the "
                f"device's {total} bytes")

        path = os.path.join(cache, "plan.json")
        tel = os.path.join(cache, "telemetry")
        planned = _planned_run(
            base + ["--microbatch", str(micro), "--schedule",
                    "megatron", "--no-remat", "--planner",
                    "--save-plan", path, "--telemetry", tel], want)
        telemetry = _check_plan_telemetry(tel, planned["predicted_ms"])
        plan = ParallelPlan.load(path)
        with open(path) as f:
            require(json.load(f) == plan.to_dict()
                    and ParallelPlan.from_dict(plan.to_dict()) == plan,
                    f"{path} does not read back equal")
        require(plan.layers == (LayerStrategy(1, "megatron"),) * n,
                f"planned {plan.summary()}")
        replay = _planned_run(base + ["--no-remat", "--plan", path],
                              want)
    losses = [(r["first_loss"], r["last_loss"]) for r in (planned, replay)]
    require(losses[0] == losses[1], f"--plan replay losses {losses[1]} "
            f"differ from the planned run's {losses[0]}")
    measured = statistics.median(planned["device_step_ms"][1:])
    out = dict(calibration=cal, plan=plan.to_dict(),
               summary=plan.summary(), predicted_ms=planned["predicted_ms"],
               measured_step_ms=measured,
               ratio=measured / planned["predicted_ms"],
               replay_step_ms=statistics.median(
                   replay["device_step_ms"][1:]),
               telemetry=telemetry, planned=planned, replay=replay,
               launches={k: planned["launches"].get(k, 0)
                         + replay["launches"].get(k, 0) for k in want})
    brief = {k: v for k, v in out.items()
             if k not in ("planned", "replay", "plan")}
    print(f"[planner] {json.dumps(brief)}")
    return out


def _check_plan_telemetry(path, predicted_ms) -> dict:
    """The planned run's ``--telemetry`` directory: ``python -m
    repro_torch.obs.report DIR --validate`` exits 0, the ``planner.plan``
    event carries the launcher's ``predicted_ms`` (rounded as the event
    rounds it), ``trainer.step_time_s`` one sample a step, and the probe
    says ``overlap.skip`` (tp=1: no collective)."""
    import os

    from repro_torch.obs import report
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", path, "--validate"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    require(res.returncode == 0, f"report --validate {path}: rc "
            f"{res.returncode} {res.stdout} {res.stderr}")
    records = report.load(path)
    names = [r["name"] for r in records]
    plans = [r["tags"] for r in records if r["name"] == "planner.plan"]
    require(len(plans) == 1
            and plans[0]["predicted_ms"] == round(predicted_ms, 3),
            f"planner.plan {plans} against predicted {predicted_ms} ms")
    require(names.count("trainer.step_time_s") == PLAN_STEPS,
            f"{names.count('trainer.step_time_s')} step records for "
            f"{PLAN_STEPS} steps")
    require("overlap.skip" in names, f"no overlap.skip at tp=1: {names}")
    return dict(validate=res.stdout.strip(), records=len(records),
                planner_plan=plans[0],
                step_time_s=[r["value"] for r in records
                             if r["name"] == "trainer.step_time_s"])


# ---------------------------------------------------------------------------
# per-layer plans and the 2-D layout (phases 21-22)
# ---------------------------------------------------------------------------
PLAN_FACTORED = ((1, 2, 2), ("data", "t1", "t2"))
# phase 21: gpt-h2048 at full width, 4 layers, f32, batch 4 x 256
PLAN_CONSISTENCY = (4, 4, 256)
# each (degrees, schedules) on the factored mesh, in one spawn
PLAN_CASES = {
    "mixed": ([4, 4, 2, 2], ["oases", "oases", "megatron", "megatron"]),
    "2d_fused": ([(2, 2)] * 4, ["fused"] * 4),
    "mixed_2d": ([(2, 2), (2, 2), 4, 4], ["fused", "fused", "wang", "wang"])}
PLAN_REF = ROOT / "build" / "chip_smoke" / "plan_tp1_consistency.pt"
# phase 22: gpt-h2048 at full width and depth, bf16, 4 ranks, one
# microbatch: two microbatches' f32 gradient sums (+3.4 GB a rank under the
# ILP's [2/oases]*24) do not fit beside four ranks' f32 master and moments
# on one card (out of memory at 16-17.5 GB allocated a rank)
PLAN_TRAIN = (8, 1024, 1)          # batch, seq, microbatches
# steps a run: the first (the spawn's warm-up) and one timed step (3 in
# PRs 25-26; the 2-D run's step is ~8 s of time-sliced collectives)
PLAN_TRAIN_STEPS = 2


def _group_launches(groups, micro_batch: int, passes: int,
                    remat: bool, fine: bool) -> dict:
    """The launches of ``passes`` forward + backward passes of a microbatch
    of ``micro_batch`` rows, worked out from the plan groups (each
    ``(count, schedule, dx, dy, extra)``: layers, schedule, width and
    contraction degrees, extra data-parallel ranks): every layer's
    attention and both norms per sub-batch (the effective split of the
    group's share of the batch), forward once more where recomputation
    replays the part; the final norm once; the ring kernel at every fused
    exit over x (dx > 1) and, in 2-D, at every entry product over y (5 a
    layer), replayed only under coarse recomputation."""
    from repro_torch.core.remat import policy
    from repro_torch.core.schedule import effective_split
    fwd = bwd = ring = 0
    for count, sched, dx, dy, extra in groups:
        split = effective_split(sched, 2, micro_batch // extra)
        pol = policy(sched, remat=remat, fine=fine)
        runs = 1 if pol == "none" else 2
        fwd += count * split * runs
        bwd += count * split
        if sched == "fused":
            per = (2 if dx > 1 else 0) + (5 if dy > 1 else 0)
            ring += count * split * per * (2 if pol == "coarse" else 1)
    never = {k: 0 for k in SERVE_ONLY if not k.startswith("peer_")}
    return {**never, "paged_decode": 0,
            "flash_attention": passes * fwd,
            "flash_attention_bwd": passes * bwd,
            "rmsnorm": passes * (2 * fwd + 1),
            "rmsnorm_bwd": passes * (2 * bwd + 1),
            "ring_matmul_rs": passes * ring}


def _groups_of(step_fn, cfg):
    """(count, schedule, dx, dy, extra) of each plan group of a built step
    (one group for the stacked layout)."""
    ctx = step_fn.ctx
    if step_fn.groups is None:
        return [(cfg.num_layers, ctx.schedule, ctx.tp, ctx.tp_y, 1)]
    info = step_fn.layout.info
    return [(g.count, c.schedule, c.tp, c.tp_y,
             info._size(info.extra_dp_axes(g.degree)))
            for g, c in step_fn.groups]


def phase_plan_consistency():
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import lm
    from repro_torch.models import params as prm

    layers, b, s = PLAN_CONSISTENCY
    cfg = get_config(TRAIN_ARCH).replace(num_layers=layers, dtype="float32")
    base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    batch = make_batch(DataConfig(global_batch=b, seq_len=s,
                                  vocab_size=cfg.vocab_size), 0)
    # the tp=1 card run of the same weights (kernels, f32 products)
    params = prm.unflatten({k: t.to("cuda").requires_grad_()
                            for k, t in prm.flatten(base).items()})
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    t0 = time.perf_counter()
    loss, _ = lm.train_loss(cfg, params, tb, TrainHParams())
    loss.backward()
    ref = dict(loss=loss.item(), s=time.perf_counter() - t0,
               grads={k: t.grad.cpu() for k, t in
                      prm.flatten(params).items()})
    PLAN_REF.parent.mkdir(parents=True, exist_ok=True)
    torch.save(ref, PLAN_REF)
    del params, loss, base
    torch.cuda.empty_cache()
    out = {"arch": TRAIN_ARCH, "layers": layers, "dtype": "float32",
           "batch": b, "seq": s, "ranks": 4, "loss_tp1": ref["loss"],
           "cases": {}}
    t0 = time.perf_counter()
    # phase 22's runs on the factored mesh follow in the same processes
    per_rank = _spawn_with_next(_plan_consistency_rank, (PLAN_CASES,), 22,
                                _plan_train_setup, _plan_train_runs, 600,
                                mesh=PLAN_FACTORED)
    wall = time.perf_counter() - t0
    for name in PLAN_CASES:
        _check_plan_case(name, [r[name] for r in per_rank], ref, out, wall)
    return out


def _check_plan_case(name, rs, ref, out, wall):
    """Phase 21's gates for one plan: loss and gradients against the tp=1
    run, replicas' bits after the AdamW step, exact launches."""
    leaf_err = {k: max(r["leaf"][k][0] for r in rs)
                / (max(r["leaf"][k][1] for r in rs) + 1e-8)
                for k in rs[0]["leaf"]}
    gerr = max(leaf_err.values())
    loss_rel = max(abs(r["loss"] - ref["loss"]) for r in rs) \
        / abs(ref["loss"])
    # every rank holding the same block of a leaf holds the same bits
    mismatched = []
    for k in rs[0]["digest"]:
        seen = {}
        for r in rs:
            block, digest = r["digest"][k]
            if seen.setdefault(tuple(block), digest) != digest:
                mismatched.append(k)
    row = dict(summary=rs[0]["summary"], losses=[r["loss"] for r in rs],
               loss_rel_err=loss_rel, grads_err=gerr,
               worst_leaf=max(leaf_err, key=leaf_err.get),
               replicas_bit_identical=not mismatched,
               launches=rs[0]["launches"], want=rs[0]["want"],
               counts_fwd=rs[0]["fwd"], counts_bwd=rs[0]["bwd"],
               rank_s=[r["s"] for r in rs], spawn_wall_s=wall)
    out["cases"][name] = row
    print(f"[plan_consistency] {name} {json.dumps(row)}")
    require(loss_rel <= LOSS_RTOL, f"{name}: loss {row['losses']} vs tp=1 "
                                   f"{ref['loss']}: rel {loss_rel}")
    require(gerr <= GRADS_TOL, f"{name}: grads_err {gerr} > {GRADS_TOL}")
    require(not mismatched, f"{name}: replicas differ after the AdamW step "
                            f"in {mismatched[:5]}")
    for r in rs:
        got = {k: r["launches"].get(k, 0) for k in r["want"]}
        require(got == r["want"], f"{name}: rank launched {got}, expected "
                                  f"{r['want']}")


def _plan_consistency_rank(comm, device, cases):
    """One rank of phase 21: per plan, this rank's shard of the phase's
    weights in the plan's layout, its loss, and each leaf's gradient
    (summed over the leaf's extra data-parallel ranks, as the step sums
    it) against the same block of the tp=1 card gradient; the comm counts
    and launches of the forward and backward; then one AdamW step
    (``build_train_step``) and each leaf's block and a digest of its
    bits."""
    import hashlib

    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models import params as prm
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    layers, b, s = PLAN_CONSISTENCY
    cfg = get_config(TRAIN_ARCH).replace(num_layers=layers, dtype="float32")
    base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    batch = make_batch(DataConfig(global_batch=b, seq_len=s,
                                  vocab_size=cfg.vocab_size), 0)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    ref = torch.load(PLAN_REF)["grads"]
    out = {}
    for name, (degrees, scheds) in cases.items():
        hp = TrainHParams(learning_rate=1e-3, warmup_steps=1, microbatch=1)
        setup = steps.train_setup(cfg, hp, seq_len=s, comm=comm,
                                  degrees=degrees, schedules=scheds)
        lay = setup.layout
        want_flat = lay.shard_flat(
            prm.relayout_flat(cfg, ref, {}, {"degrees": lay.degrees,
                                             "schedules": lay.schedules})
            if lay.grouped else ref, comm.rank)
        params = prm.unflatten({k: t.to(device).requires_grad_() for k, t
                                in prm.flatten(lay.shard(base,
                                                         comm.rank)).items()})
        _build.reset_launches()
        comm.reset_counts()
        t0 = time.perf_counter()
        loss, _ = lm.train_loss(cfg, params, tb, setup.hp, setup.ctx,
                                setup.groups)
        fwd = dict(comm.counts)
        comm.reset_counts()
        loss.backward()
        bwd = dict(comm.counts)
        torch.cuda.synchronize(device)
        launches = dict(_build.LAUNCHES)
        leaf = {}
        for k, t in prm.flatten(params).items():
            g = comm.sub(lay.grad_replicas(k)).all_reduce(t.grad).cpu()
            leaf[k] = (float((g - want_flat[k]).abs().max()),
                       float(want_flat[k].abs().max()))
        elapsed = time.perf_counter() - t0
        step = steps.build_train_step(
            cfg, hp, global_batch=b, seq_len=s, comm=comm, degrees=degrees,
            schedules=scheds)
        step(params, adamw.init_opt_state(params), tb)
        digest = {}
        for k, t in prm.flatten(params).items():
            block = [comm.info.axes_index(comm.rank, axes)
                     for axes in lay.specs[k].dims()]
            digest[k] = (block, hashlib.sha1(
                t.detach().cpu().contiguous().view(torch.int32).numpy()
                .tobytes()).hexdigest())
        out[name] = dict(
            loss=loss.item(), leaf=leaf, fwd=fwd, bwd=bwd, s=elapsed,
            launches=launches, digest=digest,
            summary=(lay.degrees, lay.schedules, lay.layout),
            want=_group_launches(_groups_of(step, cfg), b, 1, True, True))
        del params, loss, step
        torch.cuda.empty_cache()
    return out


def _plan_train_setup():
    """Phase 22's runs, resolved in this process by the launcher's own path
    (the planner calibrated once, before the ranks share the card) ->
    ((the plan file's directory, each run's resolution, the runs grouped
    by mesh, the hardware), the factored mesh's rank arguments)."""
    import tempfile

    import torch
    from repro_torch.core.planner import calibrate
    from repro_torch.launch import train as launcher

    torch.cuda.empty_cache()
    batch, seq, micro = PLAN_TRAIN
    tmp = tempfile.TemporaryDirectory()
    plan_path = Path(tmp.name) / "plan.json"
    n = 24
    plan_path.write_text(json.dumps({
        "layers": [[4, "oases"]] * (n // 2) + [[2, "megatron"]] * (n // 2),
        "microbatch": micro}))
    base = ["--arch", TRAIN_ARCH, "--steps", str(PLAN_TRAIN_STEPS),
            "--batch", str(batch), "--seq", str(seq), "--microbatch",
            str(micro), "--seed", "0"]
    flags = {"mixed_plan": ["--tp", "4", "--mesh", "factored", "--plan",
                            str(plan_path)],
             "2d_fused": ["--tmp-layout", "2d", "--mesh", "1x2x2",
                          "--schedule", "fused"],
             "planner": ["--tp", "4", "--mesh", "factored", "--planner"]}
    runs, resolved = {}, {}
    with _cal_cache():
        for name, extra in flags.items():
            args = launcher.parse_args(base + extra)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cfg, hp, mesh, plan, predicted = launcher._resolve(args)
                hw = calibrate.calibrated_hw(n_chips=mesh.size)
            tel = str(Path(tmp.name) / name)
            resolved[name] = (plan, predicted, tel, [
                ln for ln in buf.getvalue().splitlines()
                if ln.startswith(("planner:", "[plan]"))])
            print(f"[plan_train] {name} resolved {plan.summary()} "
                  f"{json.dumps(resolved[name][3])}", flush=True)
            runs[name] = ((mesh.shape, mesh.axis_names), cfg, hp, plan, tel)
    # the calibration's buffers go back to the card before four ranks
    # share it, and so does whatever an earlier phase's objects still
    # hold in reference cycles that the collector has not yet freed
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[plan_train] parent allocated {held / 1e9:.2f} GB, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after collecting",
          flush=True)
    by_mesh = {}
    for name, (mesh, *run) in runs.items():
        by_mesh.setdefault(mesh, []).append((name, tuple(run)))
    return ((tmp, resolved, by_mesh, hw),
            ([r for _, r in by_mesh[PLAN_FACTORED]], PLAN_TRAIN_STEPS,
             batch, seq, hw))


def phase_plan_train():
    """Phase 22: the plan file's and the ILP's runs on the factored mesh
    (in phase 21's rank processes when both run: one warm-up, each rank
    freeing a run's objects before the next), then the 2-D run on its
    own mesh, never beside an earlier spawn: four ranks' optimizer state
    leaves no room for what an earlier spawn's processes still hold."""
    import torch
    from repro_torch.launch.ranks import run_ranks

    batch, seq, micro = PLAN_TRAIN
    steps = PLAN_TRAIN_STEPS
    done = _RUN.pop(22, None)
    if done is None:
        (tmp, resolved, by_mesh, hw), _ = _plan_train_setup()
    else:
        tmp, resolved, by_mesh, hw = done["ctx"]
    torch.cuda.empty_cache()
    out = {"arch": TRAIN_ARCH, "dtype": "bfloat16", "layers": 24,
           "batch": batch, "seq": seq, "microbatch": micro, "steps": steps,
           "ranks": 4, "card": _card(), "runs": {},
           "shared_spawn_with_phase_21": done is not None}
    firsts = {}
    for mesh, group in by_mesh.items():
        if done is not None and mesh == PLAN_FACTORED:
            per_rank, wall = done["per_rank"], done["wall"]
        else:
            t0 = time.perf_counter()
            per_rank = run_ranks(_plan_train_runs, mesh=mesh, timeout=900,
                                 args=([r for _, r in group], steps, batch,
                                       seq, hw))
            wall = time.perf_counter() - t0
        for i, (name, _) in enumerate(group):
            firsts[name] = _check_plan_run(name, [r[i] for r in per_rank],
                                           resolved[name], steps, wall, out)
    tmp.cleanup()
    spread = max(firsts.values()) - min(firsts.values())
    out["first_loss_spread"] = spread
    out["first_loss_atol"] = TP_LOSS_ATOL
    require(spread <= TP_LOSS_ATOL, f"first losses {firsts}: spread "
                                    f"{spread} > {TP_LOSS_ATOL}")
    out["launches"] = {}
    for row in out["runs"].values():
        for k, v in row["launches_per_step"].items():
            out["launches"][k] = out["launches"].get(k, 0) + int(
                round(v * steps))
    return out


def _check_plan_run(name, rs, resolved, steps, wall, out) -> float:
    """Phase 22's gates for one run; -> its first loss."""
    plan, predicted, tel, log = resolved
    r0 = rs[0]
    med = statistics.median(r0["device_step_ms"][1:])
    row = dict(
        plan=plan.summary(), groups=r0["groups"], losses=r0["losses"],
        step_ms_median=[r["step_ms_median"] for r in rs],
        device_step_ms=r0["device_step_ms"], device_step_ms_median=med,
        arg_bytes=r0["arg_bytes"],
        predicted_ms=predicted,
        predicted_over_measured=predicted / med if predicted else None,
        peak_mem_gb=[r["peak_mem_gb"] for r in rs],
        launches_per_step=r0["launches_per_step"],
        want_per_step=r0["want"], spawn_wall_s=wall, planner_log=log,
        probe=_check_plan_telemetry_groups(Path(tel), steps,
                                           len(r0["groups"])))
    print(f"[plan_train] {name} {json.dumps(row)}")
    print(f"[plan_train_profile] {name} {json.dumps(r0['profile'])}")
    row["profile"] = r0["profile"]
    out["runs"][name] = row
    for r in rs:
        require(len(r["losses"]) == steps
                and all(math.isfinite(v) for v in r["losses"]),
                f"{name}: losses {r['losses']}")
        require(not r["bad_grads"], f"{name}: missing or non-finite "
                f"gradients after step 1: {r['bad_grads']}")
        require(r["losses"] == r0["losses"], f"{name}: ranks report "
                f"different losses {[x['losses'] for x in rs]}")
        got = {k: r["launches_per_step"].get(k, 0) for k in r["want"]}
        require(got == r["want"], f"{name}: launched {got} a step, "
                                  f"expected {r['want']}")
    return r0["losses"][0]


def _check_plan_telemetry_groups(path, steps, groups) -> dict:
    """Rank 0's JSONL of one phase 22 run: every line validates, one
    ``trainer.step_time_s`` a step and one ``overlap.group`` event per
    plan group.  -> the probe's readings."""
    from repro_torch.obs import schema
    files = sorted(p.name for p in path.iterdir())
    require(files == ["telemetry.jsonl"], f"{path}: {files}")
    with open(path / "telemetry.jsonl") as f:
        records = schema.validate_lines(f)
    names = [r["name"] for r in records]
    require(names.count("trainer.step_time_s") == steps,
            f"{path}: {names.count('trainer.step_time_s')} step records")
    got = [r["tags"] for r in records if r["name"] == "overlap.group"]
    require(len(got) == groups, f"{path}: {len(got)} overlap.group events "
                                f"for {groups} plan groups: {got}")
    return dict(groups=got, gauges={
        r["name"]: r["value"] for r in records
        if r["name"].startswith("overlap.") and r["kind"] == "gauge"},
        errors=[r.get("msg") for r in records
                if r["name"] == "overlap.error"])


def _plan_train_runs(comm, device, runs, steps, batch, seq, hw):
    """One rank's phase 22 runs on one mesh, in turn (``_plan_train_rank``
    each), a run's trainer freed and the ranks met before the next."""
    import torch
    out = []
    for run in runs:
        out.append(_plan_train_rank(comm, device, *run, steps, batch, seq,
                                    hw))
        gc.collect()
        torch.cuda.empty_cache()
        comm.barrier()
    return out


def _plan_train_rank(comm, device, cfg, hp, plan, tel, steps, batch, seq,
                     hw):
    """One rank of a phase 22 run: the launcher's Trainer
    (``launch/train.py``'s ``_train``: the resolved plan over the mesh's
    communicators, rank 0 recording into ``tel`` with the overlap probe
    on ``hw``), its first step's gradients checked, launches a step
    against the plan groups' count, step times, peak memory and a
    one-step profile of rank 0."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.obs import Recorder
    from repro_torch.runtime import Trainer

    torch.cuda.reset_peak_memory_stats(device)
    rec = Recorder(tel) if comm.rank == 0 else None
    tr = Trainer(cfg, hp, global_batch=batch, seq_len=seq, log_fn=None,
                 device=device, comm=comm, plan=plan, telemetry=rec,
                 probe_hw=hw)
    _build.reset_launches()
    first = tr.train(1, seed=0)
    bad = [k for k, t in prm.flatten(tr.params).items()
           if t.grad is None or not bool(torch.isfinite(t.grad).all())]
    rest = tr.train(steps, seed=0)
    torch.cuda.synchronize(device)
    launches = dict(_build.LAUNCHES)
    if rec is not None:
        rec.close()
    times = first["step_times"] + rest["step_times"]
    micro = max(tr.hp.microbatch, 1)
    groups = _groups_of(tr.step_fn, cfg)
    return dict(
        losses=first["losses"] + rest["losses"], bad_grads=bad,
        device_step_ms=first["device_step_ms"] + rest["device_step_ms"],
        step_ms_median=statistics.median(1e3 * t for t in times[1:]),
        launches_per_step={k: v / steps for k, v in launches.items()},
        want=_group_launches(groups, batch // micro, micro, tr.hp.remat,
                             tr.hp.fine_remat),
        groups=groups, microbatch=micro,
        peak_mem_gb=_peak_gb(comm, device), arg_bytes=_state_bytes(tr),
        profile=_profile_tp_step(tr, comm))


def _path_launches(report) -> dict:
    """Each main path's launches per kernel, counted from 0 over the path's
    run: serve (phase 4), one-device training (phase 7), tensor-parallel
    training (phase 10), ring-attention training (phase 13), rank 0
    over all schedules and steps for the last two, the families'
    training (phase 16, both families' Trainer and launcher runs), the
    RG-LRU hybrid's training (phase 19, both schedules), the planned
    training (phase 20, the planned run and its replay), the per-layer
    plans (phase 22), the other families' training (phase 26, every
    run), every family's serving (phase 29: gemma2-9b's dense engine,
    each arch's prefill and decode steps), TMP decode (phase 31: rank 0
    of every 1-D and 2-D run) and speculative serving at full size (phase
    32: the undrafted and the drafted run)."""
    paths = {}
    if "serve" in report:
        paths["serve"] = report["serve"]["launches"]
    if "train" in report:
        paths["train"] = report["train"]["launches"]
    for path, key, steps in (("tp_train", "tp_train", TP_STEPS),
                             ("sp_train", "sp_train", SP_STEPS)):
        if key in report:
            tot = {}
            for r in report[key]["schedules"].values():
                for k, v in r["launches_per_step"].items():
                    tot[k] = tot.get(k, 0) + int(round(v * steps))
            paths[path] = tot
    if "family_train" in report:
        tot = {}
        for r in report["family_train"].values():
            for run in (r, r["launcher"]):
                for k, v in run["launches"].items():
                    tot[k] = tot.get(k, 0) + v
        paths["families"] = tot
    if "hybrid_train" in report:
        tot = {}
        for r in report["hybrid_train"].values():
            for k, v in r["launches"].items():
                tot[k] = tot.get(k, 0) + v
        paths["hybrid"] = tot
    if "planner" in report:
        paths["planner"] = report["planner"]["launches"]
    if "plan_train" in report:
        paths["plans"] = report["plan_train"]["launches"]
    if "families2_train" in report:
        tot = {}
        for r in report["families2_train"].values():
            for k, v in r["launches"].items():
                tot[k] = tot.get(k, 0) + v
        paths["families2"] = tot
    if "serve_families" in report:
        paths["serve_families"] = report["serve_families"]["launches"]
    if "spec_consistency" in report:
        paths["serve_tmp"] = report["spec_consistency"]["launches"]
    if "spec_serve" in report:
        paths["serve_spec"] = report["spec_serve"]["launches"]
    return paths


def _kernels_line(report) -> dict:
    """The kernels JSON: every kernel of the paths that ran, with its
    launches on the main paths (``launches_by_path``, see
    :func:`_path_launches`) and its main case's numbers.  The tile matmul
    runs on the main path only inside the ring kernel (as
    ``_mm_tile_kernel`` does in JAX), so its own launches there are 0;
    ``ring_step_products`` counts the per-step products the ring launches
    ran (tp per launch)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    paths = _path_launches(report)
    rows = []

    def pick(rows_, **want):
        return next(r for r in rows_
                    if all(r[k] == v for k, v in want.items()))

    def add(name, src, replaces, row, **extra):
        by_path = {p: c.get(name, 0) for p, c in paths.items()
                   if c.get(name, 0)}
        rows.append(dict(name=name, route="cuda",
                         source=f"src/repro_torch/kernels/csrc/{src}",
                         replaces=replaces, launches=sum(by_path.values()),
                         launches_by_path=by_path,
                         **{k: row[k] for k in keys}, **extra))

    if "kernels" in report:
        extra = {}
        if "serve_kernels" in report:
            extra["at_families"] = [
                {k: r[k] for k in ("case", "hd", "group", "S", "page",
                                   "ring", "softcap") + keys}
                for r in report["serve_kernels"]["paged_decode"]
                if r["dtype"] == "bfloat16"]
        if "spec_kernels" in report:
            extra["at_verify"] = [
                {k: r[k] for k in ("case", "b", "qn", "S", "folded_rows",
                                   "bound_per_query_row_ms") + keys}
                for r in report["spec_kernels"]["paged_decode"]
                if r["dtype"] == "bfloat16"]
        add("paged_decode", "paged_decode.cu",
            "src/repro/kernels/flash_attention.py:146",
            pick(report["kernels"]["paged_decode"], case="main",
                 dtype="bfloat16"), **extra)
    if "train_kernels" in report:
        tk = report["train_kernels"]
        train_rms = pick(tk["rmsnorm"], dtype="bfloat16", d=2048)
        rms = (pick(report["kernels"]["rmsnorm"], rows=8, dtype="bfloat16")
               if "kernels" in report else train_rms)
        add("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:16", rms,
            at_train_shape={k: train_rms[k] for k in ("rows", "d") + keys})
        for name, src, replaces, case in (
                ("rmsnorm_bwd", "rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:16", {"d": 2048}),
                ("flash_attention", "flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:30", {"case": "main"}),
                ("flash_attention_bwd", "flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:30",
                 {"case": "main"})):
            extra = {}
            if name != "rmsnorm_bwd" and "hybrid_kernels" in report:
                row = pick(report["hybrid_kernels"][name],
                           case="mqa256_window", dtype="bfloat16")
                extra = {"at_hd256": {k: row[k] for k in
                                      ("case", "b", "s", "h", "kvh", "hd",
                                       "window") + keys}}
            if name != "rmsnorm_bwd" and "families2_kernels" in report:
                row = pick(report["families2_kernels"][name],
                           case="llama_cross", dtype="bfloat16")
                extra["at_cross"] = {k: row[k] for k in
                                     ("case", "b", "sq", "s", "h", "kvh",
                                      "hd", "causal") + keys}
            add(name, src, replaces, pick(tk[name], dtype="bfloat16", **case),
                **extra)
    if "tmp_kernels" in report:
        tmpk = report["tmp_kernels"]
        rings = sum(c.get("ring_matmul_rs", 0) for c in paths.values())
        for name, src, replaces, case in (
                ("tile_matmul", "tile_matmul.cu",
                 "src/repro/kernels/collective_matmul.py:230",
                 {"case": "wd"}),
                ("ring_matmul_rs", "ring_matmul_rs.cu",
                 "src/repro/kernels/collective_matmul.py:297",
                 {"case": "wd", "tp": 2}),
                ("peer_all_reduce", "peer_comm.cu",
                 "none (XLA's psum, src/repro/core/tmp.py:72)", {"tp": 2}),
                ("peer_all_gather", "peer_comm.cu",
                 "none (XLA's all_gather, src/repro/kernels/"
                 "collective_matmul.py:206)", {"tp": 2}),
                ("peer_reduce_scatter", "peer_comm.cu",
                 "none (XLA's psum_scatter, src/repro/core/tmp.py:96)",
                 {"tp": 2})):
            row = pick(tmpk[name], dtype="bfloat16", **case)
            extra = ({"cublas_same_product_ms":
                      row["cublas_same_product_ms"]}
                     if name == "ring_matmul_rs" else {})
            if name == "ring_matmul_rs" and "spec_kernels" in report:
                r = pick(report["spec_kernels"]["ring_matmul_rs"],
                         dtype="bfloat16")
                extra["at_decode"] = {k: r[k] for k in (
                    "case", "rows", "k_local", "d", "chunk", "path",
                    "fused_exit_ms", "matmul_allreduce_ms",
                    "cublas_same_product_ms") + keys}
            if name == "peer_all_reduce" and "spec_kernels" in report:
                r = pick(report["spec_kernels"]["peer_all_reduce"],
                         dtype="bfloat16")
                extra["at_decode"] = {k: r[k] for k in ("case", "shape")
                                      + keys}
            if name == "peer_reduce_scatter":
                extra = {"all_reduce_slice_ms": row["all_reduce_slice_ms"]}
            if name == "tile_matmul":
                extra = {"runs_inside": "ring_matmul_rs",
                         "ring_step_products": 2 * rings,
                         "shape": [row["m"], row["k"], row["n"]]}
            if "path" in row:
                extra["path"] = row["path"]
            add(name, src, replaces, row, **extra)
    if "ring_kernels" in report:
        row = pick(report["ring_kernels"]["ring_attention"], case="slice",
                   dtype="bfloat16", tp=2)
        add("ring_attention", "ring_attention.cu",
            "src/repro/kernels/ring_attention.py:218", row,
            shape={k: row[k] for k in ("b", "s", "sq", "h", "kvh", "hd")},
            rank=row["rank"])
    if "family_kernels" in report:
        fk = report["family_kernels"]
        for name, replaces in (
                ("ssd", "src/repro/kernels/ssd.py:25"),
                ("ssd_bwd", "none (XLA's autodiff of src/repro/models/"
                 "ssd.py:13 ssd_chunked)")):
            row = pick(fk[name], case="slice", dtype="bfloat16")
            extra = {}
            if name == "ssd" and "serve_kernels" in report:
                r = pick(report["serve_kernels"]["ssd"], dtype="bfloat16")
                extra["with_final_state"] = {k: r[k] for k in (
                    "b", "s", "h", "p", "n", "errs") + keys}
            add(name, "ssd.cu", replaces, row,
                shape={k: row[k] for k in ("b", "s", "h", "p", "n",
                                           "chunk")},
                bound_f32_ms=row["bound_f32_ms"], **extra)
        row = pick(fk["moe_gmm"], case="w1", product="fwd",
                   dtype="bfloat16")
        add("moe_gmm", "moe_gmm.cu", "src/repro/kernels/moe_gmm.py:19", row,
            shape=[row["e"], row["c"], row["d"], row["f"]], path=row["path"])
    if "hybrid_kernels" in report:
        hk = report["hybrid_kernels"]
        for name, side in (("rglru", "ms_stateless"),
                           ("rglru_bwd", "states_bytes")):
            row = pick(hk[name], case="slice", dtype="bfloat16")
            extra = {}
            if name == "rglru" and "serve_kernels" in report:
                r = pick(report["serve_kernels"]["rglru"], dtype="bfloat16")
                extra["with_last_state"] = {k: r[k] for k in (
                    "b", "s", "w", "errs", "rounded_h_last_err") + keys}
            add(name, "rglru.cu", "src/repro/kernels/rglru.py:23", row,
                shape={k: row[k] for k in ("b", "s", "w")},
                **{side: row[side]}, **extra)
    return {"kernels": rows}


# ---------------------------------------------------------------------------
# the dry run (phase 23)
# ---------------------------------------------------------------------------
# the gate on a traced step's roofline bound against the measured step: a
# bound above the measured time (beyond noise) means the count is wrong
DRY_RATIO = (0.0, 1.05)
# the report of the running smoke, for phase 23 to read the earlier phases
_RUN: dict = {}


def _dry_cell(spec):
    """One cell's ``launch/dryrun.run_cell`` (a worker process: the trace
    is CPU work on fake tensors and touches no card)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rec = dryrun.run_cell(spec["cfg"], ShapeConfig("cell", spec["seq"],
                                                   spec["batch"], "train"),
                          **spec["kw"])
    rec["trace_s"] = time.perf_counter() - t0
    return rec


def _dry_specs(report, tmp):
    """(phase, name, spec, measured row) of each training cell phases 7,
    16, 19 and 22 measured in this run, at its exact configuration."""
    from repro_torch.configs.registry import get_config
    out = []
    if "train" in report:
        r = report["train"]
        out.append((7, TRAIN_ARCH, dict(
            cfg=get_config(TRAIN_ARCH), batch=r["batch"], seq=r["seq"],
            kw=dict(microbatch=r["microbatch"], mesh_shape="1x1",
                    **TP1_SCHEDULE)), r))
    for arch, r in report.get("family_train", {}).items():
        layers = FAMILY_TRAIN[arch][0]
        cfg = get_config(arch)
        out.append((16, arch, dict(
            cfg=cfg.replace(num_layers=layers) if layers else cfg,
            batch=r["batch"], seq=r["seq"],
            kw=dict(microbatch=r["microbatch"], mesh_shape="1x1",
                    **TP1_SCHEDULE)), r))
    for sched, r in report.get("hybrid_train", {}).items():
        layers, batch, seq = HYBRID_TRAIN
        out.append((19, f"{HYBRID_ARCH}/{sched}", dict(
            cfg=get_config(HYBRID_ARCH).replace(num_layers=layers),
            batch=batch, seq=seq,
            kw=dict(mesh_shape="1x1", **HYBRID_SCHEDULES[sched])), r))
    runs = report.get("plan_train", {}).get("runs", {})
    if "mixed_plan" in runs:
        from repro_torch.launch import train as launcher
        batch, seq, micro = PLAN_TRAIN
        n = get_config(TRAIN_ARCH).num_layers
        first = Path(tmp) / "plan_flags.json"
        first.write_text(json.dumps({
            "layers": [[4, "oases"]] * (n // 2) + [[2, "megatron"]] * (n // 2),
            "microbatch": micro}))
        # phase 22's launcher resolution, saved with the mesh it resolved
        args = launcher.parse_args(
            ["--arch", TRAIN_ARCH, "--batch", str(batch), "--seq", str(seq),
             "--microbatch", str(micro), "--tp", "4", "--mesh", "factored",
             "--plan", str(first), "--no-calibrate"])
        with contextlib.redirect_stdout(io.StringIO()):
            cfg, hp, mesh, plan, _ = launcher._resolve(args)
        path = Path(tmp) / "plan_mesh.json"
        dataclasses.replace(plan, mesh_shape=tuple(mesh.shape),
                            mesh_axes=tuple(mesh.axis_names)).save(str(path))
        out.append((22, f"{TRAIN_ARCH}/mixed_plan", dict(
            cfg=cfg, batch=batch, seq=seq,
            kw=dict(plan_file=str(path), microbatch=micro, rank=0,
                    schedule=hp.schedule, remat=hp.remat,
                    fine_remat=hp.fine_remat)), runs["mixed_plan"]))
    return out


def phase_dryrun():
    """The dry run (``launch/dryrun.run_cell``) of each training cell
    measured earlier in this run, traced in worker processes side by side:
    each cell's dot flops, HBM bytes, link bytes and terms, the bound (the
    largest term) against the measured step, the planner's prediction
    where phase 20 made one, and the estimated peak against the measured
    one.  Gates: bound / measured in ``DRY_RATIO`` and the record's
    argument bytes equal to the bytes the phase's params, AdamW state and
    batch held."""
    import multiprocessing as mp
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    report = _RUN.get("report", {})
    card = _card()
    tmp = tempfile.TemporaryDirectory()
    specs = _dry_specs(report, tmp.name)
    require(specs, "phase 23 needs phases 7, 16, 19 or 22 in the same run")
    predicted = report.get("planner", {}).get("predicted_ms")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(specs),
                             mp_context=mp.get_context("spawn")) as ex:
        recs = list(ex.map(_dry_cell, [s for _, _, s, _ in specs]))
    wall = time.perf_counter() - t0
    tmp.cleanup()
    out = {"card": card, "trace_wall_s": wall, "cells": {}}
    for (phase, name, _, row), rec in zip(specs, recs):
        require(rec["status"] == "OK", f"{name}: {rec}")
        measured = row.get("device_step_ms_median", row.get("step_ms_median"))
        bound_ms = 1e3 * max(rec["terms_s"].values())
        peak = row["peak_mem_gb"]
        cell = dict(
            phase=phase, card=card, microbatch=rec["microbatch"],
            plan=rec["plan"], dot_flops=rec["hlo"]["dot_flops"],
            hbm_bytes=rec["hlo"]["hbm_bytes"],
            collective_link_bytes=rec["hlo"]["collective_link_bytes"],
            terms_s=rec["terms_s"], dominant=rec["dominant"],
            bound_ms=bound_ms, measured_step_ms=measured,
            bound_over_measured=bound_ms / measured,
            predicted_ms=(predicted if phase == 7 else None),
            peak_est_gb=rec["mem"]["peak_est_bytes"] / 1e9,
            peak_measured_gb=peak[0] if isinstance(peak, list) else peak,
            argument_bytes=rec["mem"]["argument_bytes"],
            held_bytes=row["arg_bytes"], trace_s=rec["trace_s"],
            roofline_fraction=rec["roofline_fraction"],
            useful_flops_ratio=rec["useful_flops_ratio"])
        print(f"[dryrun] {name} {json.dumps(cell)}", flush=True)
        out["cells"][name] = cell
    for name, c in out["cells"].items():
        require(DRY_RATIO[0] < c["bound_over_measured"] <= DRY_RATIO[1],
                f"{name}: bound {c['bound_ms']:.3f} ms over the measured "
                f"{c['measured_step_ms']:.3f} ms is "
                f"{c['bound_over_measured']:.3f}, outside {DRY_RATIO}")
        require(c["argument_bytes"] == c["held_bytes"],
                f"{name}: the dry run counts {c['argument_bytes']} argument "
                f"bytes, the phase held {c['held_bytes']}")
    return out


# ---------------------------------------------------------------------------
# the other families at tp=1 (phases 24-26)
# ---------------------------------------------------------------------------
# phase 24: flash at the new families' calls: whisper's cross attention (448
# decoder positions against 1,500 frames) and encoder (1,500 frames, not
# causal), llama-3.2-vision's cross attention (2,048 positions against
# 6,404 patches, 32 q / 8 kv heads of 128), more queries than keys under
# the causal mask, and gemma2's local layer (16 q / 8 kv heads of 256,
# window 4096, softcap 50, s 8192); ``s`` is the key length, ``sq`` the
# query length (default s); each timed over 10 calls, the plain versions
# over 5
F2_FLASH_CASES = [
    dict(name="whisper_cross", b=8, sq=448, s=1500, h=12, kvh=12, hd=64,
         causal=False, iters=10, plain_iters=5),
    dict(name="whisper_enc", b=8, s=1500, h=12, kvh=12, hd=64,
         causal=False, iters=10, plain_iters=5),
    dict(name="llama_cross", b=2, sq=2048, s=6404, h=32, kvh=8, hd=128,
         causal=False, iters=10, plain_iters=5),
    dict(name="sq_gt_sk", b=2, sq=1000, s=300, h=16, kvh=4, hd=64,
         iters=10, plain_iters=5),
    dict(name="gemma2_local", b=1, s=8192, h=16, kvh=8, hd=256, window=4096,
         softcap=50.0, iters=10, plain_iters=5)]
# phase 24: the norms at gemma2's and internlm2-20b's widths (4,096 rows),
# and moonshot's expert products (64 experts, top 6, d 2048, f 1408) at
# phase 26's 4,096 tokens (capacity 480)
F2_RMS_WIDTHS = (3584, 6144)
F2_GMM_CASES = [("w1", 4096, 2048, 1408), ("w2", 4096, 1408, 2048)]
# phase 25: card vs CPU in f32 at full width: (replaced fields, batch, seq)
F2_CONSISTENCY = {
    "whisper-small": (dict(num_layers=2, encoder_layers=2), 2, 448),
    "llama-3.2-vision-11b": (dict(num_layers=5), 1, 512),
    "gemma2-9b": (dict(num_layers=2), 1, 512)}
# phase 26: the Trainer in bf16: (replaced fields, batch, seq, schedules of
# FAMILY_SCHEDULES, steps)
F2_TRAIN = {
    "whisper-small": ({}, 16, 448, ("megatron", "oases_fine"), 4),
    "gemma2-9b": (dict(num_layers=4), 1, 8192, ("megatron",), 3),
    "llama-3.2-vision-11b": (dict(num_layers=5), 2, 2048, ("megatron",), 3),
    "moonshot-v1-16b-a3b": (dict(num_layers=2), 4, 1024, ("megatron",), 3)}


def phase_families2_kernels():
    """Flash forward and backward at the new families' shapes, the norms
    at their widths and moonshot's grouped matmul, each against its plain
    version."""
    results = {"flash_attention": [], "flash_attention_bwd": [],
               "rmsnorm": [], "rmsnorm_bwd": []}
    for case in F2_FLASH_CASES:
        for dname in ("float32", "bfloat16"):
            frow, brow = _flash_rows(case, dname)
            results["flash_attention"].append(frow)
            results["flash_attention_bwd"].append(brow)
    for dname in ("float32", "bfloat16"):
        for d in F2_RMS_WIDTHS:
            results["rmsnorm"].append(_rmsnorm_row(4096, d, dname))
            results["rmsnorm_bwd"].append(_rmsnorm_bwd_row(4096, d, dname))
    results["moe_gmm"] = _gmm_rows(64, 6, F2_GMM_CASES)
    return results


def _perturbed_base(cfg, seq):
    """Whole f32 weights of ``cfg`` drawn on the card, every leaf that
    initialises to zero (the norm scales, ``c_gate``) drawn too: 0.1
    N(0, 1), ``c_gate`` 0.5 + 0.1 N(0, 1) (at 0 ``tanh(c_gate)`` hides the
    cross path); held on the CPU."""
    import torch
    from repro_torch.models import params as prm
    gen = torch.Generator(device="cuda").manual_seed(11)
    flat = prm.flatten(prm.init_params(cfg, seed=0, max_pos=seq,
                                       device=torch.device("cuda")))
    for key, spec in prm.model_specs(cfg, max_pos=seq).items():
        if spec.scale == 0.0:
            t = flat[key]
            t.normal_(0.0, 0.1, generator=gen)
            if key.endswith("['c_gate']"):
                t.add_(0.5)
    out = prm.unflatten({k: t.cpu() for k, t in flat.items()})
    del flat
    torch.cuda.empty_cache()
    return out


def _cross_batch(cfg, batch_size, seq):
    """Step 0's tokens and labels of ``make_batch`` and, for a
    cross-attention config, a context [batch, context_len, context_dim
    or d_model] drawn N(0, 1) from numpy seed 7 (the trainer's stub is
    0.02 N(0, 1): its keys would be nearly equal)."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, make_batch
    batch = make_batch(DataConfig(global_batch=batch_size, seq_len=seq,
                                  vocab_size=cfg.vocab_size), 0)
    if cfg.context_len:
        batch["ctx"] = np.random.default_rng(7).standard_normal(
            (batch_size, cfg.context_len, cfg.context_dim or cfg.d_model)
        ).astype(np.float32)
    return batch


def phase_families2_consistency():
    """Card (kernels) against CPU (plain versions) in f32 from the same
    perturbed weights: one CPU pass (megatron, no recomputation) is the
    reference of both card schedules (at batch 1 they compute the same
    sums; whisper's two sub-batches the same sums a row), loss within 1e-5
    relative, every gradient leaf within ``grads_err`` 1e-4, exact
    launches; the cross and encoder gradients must be non-zero."""
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.schedule import effective_split

    out = {}
    megatron = TrainHParams(**FAMILY_SCHEDULES["megatron"])
    for arch, (replace, batch_size, seq) in F2_CONSISTENCY.items():
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(dtype="float32", **replace)
        base = _perturbed_base(cfg, seq)
        batch = _cross_batch(cfg, batch_size, seq)
        # compared on the card (one copy of the CPU's gradients there, not
        # two of the card's to the host)
        cpu = _loss_pass(cfg, base, batch, megatron, "cpu", grads_on="cuda")
        cross = [k for k in cpu["grads"] if "['c_" in k or "encoder" in k]
        require(all(bool(cpu["grads"][k].abs().max() > 0) for k in cross),
                f"{arch}: a cross or encoder gradient is zero")
        t_cpu = time.perf_counter() - t0
        for sched, hkw in FAMILY_SCHEDULES.items():
            hp = TrainHParams(**hkw)
            split = effective_split(hp.schedule, hp.split, batch_size)
            out[f"{arch}/{sched}"] = _family_pair(
                cfg, base, batch, hp, split, arch, sched, cpu=cpu,
                grads_on="cuda")
            torch.cuda.empty_cache()
        out[f"{arch}/wall_s"] = dict(cpu_side=t_cpu,
                                     total=time.perf_counter() - t0)
        print(f"[families2_consistency] {arch} wall_s "
              f"{json.dumps(out[f'{arch}/wall_s'])}", flush=True)
        del base, cpu
        torch.cuda.empty_cache()
    return out


def _f32_gemm_ms(kernels) -> float:
    """Device ms of cuBLAS's f32 products in a profile's (us, count, name)
    list: in a bf16 step the head's (the cross entropy's f32 logits and
    their two gradient products) and an MoE router's."""
    return sum(k[0] for k in kernels
               if re.search("gemm", k[2], re.I) and not re.search(
                   "bf16|f16|moe_gmm|gemm_tc|tile_mm|ring_matmul", k[2])
               ) / 1e3


def phase_families2_train():
    """The port's ``Trainer`` in bf16 at full width: finite losses, every
    leaf's gradient present and finite after step 1, launches a step
    exactly as worked out from the code, step time, tokens/s, peak memory
    and a one-step profile with the f32 products' share."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.schedule import effective_split
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.runtime import Trainer

    out = {}
    for arch, (replace, batch, seq, scheds, steps) in F2_TRAIN.items():
        cfg = get_config(arch).replace(**replace)
        for sched in scheds:
            t0 = time.perf_counter()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            hp = TrainHParams(learning_rate=3e-4, total_steps=steps,
                              warmup_steps=1, **FAMILY_SCHEDULES[sched])
            tr = Trainer(cfg, hp, global_batch=batch, seq_len=seq,
                         log_fn=None)
            require(tr.device.type == "cuda", f"trainer chose {tr.device}")
            micro = max(tr.hp.microbatch, 1)
            _build.reset_launches()
            first = tr.train(1, seed=0)
            leaves = prm.flatten(tr.params)
            bad = [k for k, t in leaves.items() if t.grad is None
                   or not bool(torch.isfinite(t.grad).all())]
            require(not bad, f"{arch} {sched}: missing or non-finite "
                             f"gradients after step 1: {bad}")
            rest = tr.train(steps, seed=0)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            losses = first["losses"] + rest["losses"]
            times = first["step_times"] + rest["step_times"]
            require(len(losses) == steps and all(np.isfinite(losses)),
                    f"{arch} {sched}: losses {losses}")
            split = effective_split(hp.schedule, hp.split, batch // micro)
            want = _family_launches(cfg, steps * micro, split=split,
                                    remat=hp.remat)
            require(launches == want, f"{arch} {sched}: train launched "
                                      f"{launches}, expected {want}")
            med = statistics.median(1e3 * t for t in times[1:])
            dev = statistics.median(first["device_step_ms"][1:]
                                    + rest["device_step_ms"])
            res = dict(arch=arch, schedule=hp.schedule, remat=hp.remat,
                       fine_remat=hp.fine_remat, split=split,
                       dtype=cfg.dtype, layers=cfg.num_layers,
                       encoder_layers=cfg.encoder_layers,
                       d_model=cfg.d_model,
                       params=sum(t.numel() for t in leaves.values()),
                       batch=batch, seq=seq, context_len=cfg.context_len,
                       microbatch=micro, steps=steps, losses=losses,
                       step_ms=[1e3 * t for t in times],
                       step_ms_median=med, device_step_ms_median=dev,
                       tokens_per_s=batch * seq / (med / 1e3),
                       peak_mem_gb=peak / 1e9, launches=launches,
                       launches_per_step={k: v / steps for k, v in
                                          launches.items() if v},
                       card=_card())
            prof = _profile_train_step(tr)
            if isinstance(prof["device_ms"], float):
                f32 = prof["f32_gemm_ms"]
                prof["f32_gemm_share"] = f32 / prof["device_ms"]
            res["profile"] = prof
            res["wall_s"] = time.perf_counter() - t0
            print(f"[families2_train] {json.dumps(res)}", flush=True)
            out[f"{arch}/{sched}"] = res
            del tr, first, rest, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serving every assigned family (phases 27-29)
# ---------------------------------------------------------------------------
# the paged decode's new instances at the families' decode reads, each a
# dense cache [b, S, kvh, hd] read through its block-table view
# (``dense_flash_decode``): gemma2's layers (hd 256, a group of 2, softcap
# 50) at phase 29's engine, recurrentgemma's local ring (hd 256, 16/1
# heads) wrapped at phase 29's 4,096 + 16 positions, granite-moe's global
# layers (24/8 heads of 64: a group of 3) at 1,024 + 16, and the cross
# reads of whisper's (1,500 rows, page 15) and llama's (6,404, page 4)
# contexts
FAMILY_DECODE_CASES = [
    dict(name="gemma2", b=8, S=2048, h=16, kvh=8, hd=256, softcap=50.0,
         pos=[0, 15, 16, 1023, 1024, 2047, 777, 1500], ring=False),
    dict(name="rgemma_ring", b=1, S=2048, h=16, kvh=1, hd=256, softcap=0.0,
         pos=[4111], ring=True),
    dict(name="granite_moe", b=8, S=1040, h=24, kvh=8, hd=64, softcap=0.0,
         pos=[1024, 1030, 1039, 1024, 1031, 1035, 1027, 1039], ring=False),
    dict(name="whisper_ctx", b=8, S=1500, h=12, kvh=12, hd=64, softcap=0.0,
         pos=[1499] * 8, ring=False),
    dict(name="llama_ctx", b=2, S=6404, h=32, kvh=8, hd=128, softcap=0.0,
         pos=[6403] * 2, ring=False),
]
# the prefill kernels' new outputs at the full widths of phase 29's runs:
# mamba2-130m's SSD final state (b 4, s 4096, 24 heads of 64, state 128)
# and recurrentgemma-9b's RG-LRU f32 last state (1 x 4096, w 4096)
SSD_FINAL_CASE = dict(name="mamba2", b=4, s=4096, h=24, p=64, n=128)
RGLRU_LAST_CASE = dict(name="recurrentgemma", b=1, s=4096, w=4096)


def _dense_decode_row(case, dname) -> dict:
    """One dense-view paged decode row: the kernel against the plain
    masked softmax, twice for the same bits, timed beside its bound and
    SDPA on the same cache (no softcap only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.bounds import paged_decode_work
    from repro_torch.kernels.flash_attention import (dense_flash_decode,
                                                     dense_page)

    b, S, h, kvh, hd = (case[k] for k in ("b", "S", "h", "kvh", "hd"))
    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(b, 1, h, hd, generator=gen, device="cuda").to(dtype)
    kc, vc = (torch.randn(b, S, kvh, hd, generator=gen,
                          device="cuda").to(dtype) for _ in range(2))
    pos = torch.tensor(case["pos"], dtype=torch.int32, device="cuda")
    kw = dict(softcap=case["softcap"], ring=case["ring"])
    out = dense_flash_decode(q, kc, vc, pos, **kw)
    again = dense_flash_decode(q, kc, vc, pos, **kw)
    want = ref.decode_attention_ref(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    require(torch.equal(out, again),
            f"paged_decode {case['name']} {dname}: two runs differ")
    atol, rtol = PAGED_TOL[dname]
    err, ok = max_err(out, want, atol, rtol)
    require(ok, f"paged_decode {case['name']} {dname}: max abs err {err} "
                f"beyond atol {atol} + rtol {rtol}")
    n = [min(p, S - 1) + 1 for p in case["pos"]]
    page = dense_page(S)
    nbytes, flops = paged_decode_work(b, h, kvh, hd, sum(n), sum(n),
                                      b * (S // page), q.element_size())
    bound = _bound(nbytes, flops, dname)
    row = dict(case=case["name"], dtype=dname, b=b, S=S, h=h, kvh=kvh,
               hd=hd, group=h // kvh, page=page, pos=case["pos"],
               ring=case["ring"], softcap=case["softcap"],
               max_abs_err=err, atol=atol, rtol=rtol, same_bits=True,
               ms=time_ms(lambda: dense_flash_decode(q, kc, vc, pos, **kw)),
               plain_ms=time_ms(lambda: ref.decode_attention_ref(
                   q, kc, vc, pos, **kw), iters=10),
               bound_ms=bound[0], bound_by=bound[1], bytes=nbytes,
               flops=flops, library_ms=None)
    if not case["softcap"]:
        # yardstick: SDPA on the same cache (the g query heads of a kv
        # head as its g query rows), the kernel's mask as a boolean mask
        g = h // kvh
        qh = q.reshape(b, kvh, g, hd)
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        last = torch.clamp(pos.long(), max=S - 1)
        mask = (torch.arange(S, device="cuda")[None, :]
                <= last[:, None])[:, None, None, :]
        lib = F.scaled_dot_product_attention(qh, kt, vt, attn_mask=mask)
        row["library_err"] = float((lib.reshape(want.shape).float()
                                    - want.float()).abs().max())
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kt, vt, attn_mask=mask))
    print(f"[paged_decode] {json.dumps(row)}")
    del q, kc, vc, out, again, want
    torch.cuda.empty_cache()
    return row


def phase_serve_kernels():
    """Phase 27: the paged decode's new instances (groups 3 and 16, hd
    256) at the families' decode reads, and the prefill kernels' new
    outputs (the SSD's final state, the RG-LRU's f32 last state) at full
    width, against their plain versions in f32 and bf16."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bounds import rglru_work, ssd_bounds, ssd_work
    from repro_torch.kernels.rglru import rglru_prefill
    from repro_torch.kernels.ssd import ssd_prefill

    results = {"paged_decode": [], "ssd": [], "rglru": []}
    for case in FAMILY_DECODE_CASES:
        for dname in ("float32", "bfloat16"):
            results["paged_decode"].append(_dense_decode_row(case, dname))
    c = SSD_FINAL_CASE
    b, s_, h, p, n = (c[k] for k in ("b", "s", "h", "p", "n"))
    for dname in ("float32", "bfloat16"):
        ins = _ssd_inputs(b, s_, h, p, n, getattr(torch, dname))
        y, S = ssd_prefill(*ins, chunk=128)
        y2, S2 = ssd_prefill(*ins, chunk=128)
        want_y, want_S = ref.ssd_chunked(*ins, chunk=128)
        torch.cuda.synchronize()
        require(torch.equal(y, y2) and torch.equal(S, S2),
                f"ssd final {dname}: two runs differ")
        yerr, _ = _family_check(f"ssd final {dname} y", y, want_y, dname)
        serr, satol = _family_check(f"ssd final {dname} S", S, want_S,
                                    "float32")
        nbytes, flops = ssd_work(b, s_, h, p, n, 128, ins[0].element_size())
        nbytes += b * h * p * n * 4
        row = dict(c, dtype=dname, chunk=128, max_abs_err=max(yerr, serr),
                   errs={"y": yerr, "final": serr}, final_atol=satol,
                   same_bits=True,
                   ms=time_ms(lambda: ssd_prefill(*ins, chunk=128)),
                   plain_ms=time_ms(lambda: ref.ssd_chunked(*ins, chunk=128),
                                    iters=5),
                   **ssd_bounds(nbytes, flops, dname), bytes=nbytes,
                   flops=flops, library_ms=None)
        print(f"[ssd_final] {json.dumps(row)}")
        results["ssd"].append(row)
        del ins, y, S, y2, S2, want_y, want_S
        torch.cuda.empty_cache()
    c = RGLRU_LAST_CASE
    b, s_, w = c["b"], c["s"], c["w"]
    for dname in ("float32", "bfloat16"):
        x, gates, _ = _rglru_inputs(b, s_, w, getattr(torch, dname))
        y, hl = rglru_prefill(x, gates)
        y2, hl2 = rglru_prefill(x, gates)
        want_h = ref.rglru_states_ref(x, dict(zip(ref.RGLRU_GATES, gates)))
        torch.cuda.synchronize()
        require(torch.equal(y, y2) and torch.equal(hl, hl2),
                f"rglru last {dname}: two runs differ")
        yerr, _ = _family_check(f"rglru last {dname} y", y,
                                want_h.to(x.dtype), dname)
        herr, hatol = _family_check(f"rglru last {dname} h", hl,
                                    want_h[:, -1], "float32")
        # the rounded B7 value is not the state in bf16
        rounded = float((y[:, -1].float() - want_h[:, -1]).abs().max())
        nbytes, flops = rglru_work(b, s_, w, x.element_size())
        nbytes += b * w * 4
        bound = _bound(nbytes, flops, "float32")
        row = dict(c, dtype=dname, max_abs_err=max(yerr, herr),
                   errs={"y": yerr, "h_last": herr}, h_atol=hatol,
                   rounded_h_last_err=rounded, same_bits=True,
                   ms=time_ms(lambda: rglru_prefill(x, gates)),
                   plain_ms=time_ms(lambda: ref.rglru_states_ref(
                       x, dict(zip(ref.RGLRU_GATES, gates))), iters=3,
                       warmup=1),
                   bound_ms=bound[0], bound_by=bound[1], bytes=nbytes,
                   flops=flops, library_ms=None)
        print(f"[rglru_last] {json.dumps(row)}")
        results["rglru"].append(row)
        del x, gates, y, hl, y2, hl2, want_h
        torch.cuda.empty_cache()
    return results


# phase 28: card (kernels) against CPU (plain versions) in f32 at full
# width: arch -> (replace, batch, prompt).  gemma2's and recurrentgemma's
# windows are cut to 96 so that their rings wrap inside the 128 + 8
# positions (the prefill's roll and the decode's writes); llama keeps 5
# layers (its first cross layer), whisper 2 + 2 (the encoder)
SERVE_CONSISTENCY = {
    "gemma2-9b": (dict(num_layers=2, window=96), 2, 128),
    "recurrentgemma-9b": (dict(num_layers=3, window=96), 2, 128),
    "mamba2-130m": (dict(num_layers=2), 2, 128),
    "whisper-small": (dict(num_layers=2, encoder_layers=2), 2, 64),
    "llama-3.2-vision-11b": (dict(num_layers=5), 2, 64),
    "granite-moe-3b-a800m": (dict(num_layers=2), 4, 64),
}
SERVE_CONSISTENCY_STEPS = 8
SERVE_STATE_TOL = 1e-4   # f32 decode states, card vs CPU, relative to max
# phase 29: prefill plus decode steps at full width and depth, bf16:
# arch -> (batch, prompt); gemma2-9b also serves on the dense engine
FAMILY_SERVE = {
    "gemma2-9b": (1, 6000),
    "recurrentgemma-9b": (1, 4096),
    "mamba2-130m": (4, 4096),
    "whisper-small": (8, 448),
    "llama-3.2-vision-11b": (2, 2048),
    "granite-moe-3b-a800m": (8, 1024),
}
FAMILY_SERVE_STEPS = 16
GEMMA2_ENGINE = dict(slots=8, max_seq=2048, requests=16, new_tokens=32)


def _serve_launch_counts(cfg, *, prefill: bool) -> dict:
    """Each kernel's launches in one :func:`lm.prefill` (``prefill``) or
    one :func:`lm.decode_step` of ``cfg``: the norms of every layer
    (``ln``; ``pn1`` after attention and ``pn2`` after a SwiGLU with
    post-norms; ``c_ln``; ``ln2`` before an FFN; the SSD's gated
    ``norm_g``) and the final one; an attention read a self- or cross
    attention (flash in the prefill, the paged decode in a step); the
    RG-LRU and SSD scans in the prefill; three grouped products an MoE
    FFN; whisper's encoder in the prefill."""
    from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN,
                                          LOCAL_ATTN, RGLRU, SSD)
    from repro_torch.kernels import _build
    c = {k: 0 for k in _build.LAUNCHES}
    c["rmsnorm"] = 1
    post = int(cfg.post_norms)
    moe = cfg.moe is not None
    for i in range(cfg.num_layers):
        k = cfg.layer_pattern[i % len(cfg.layer_pattern)]
        attn = int(k in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN))
        cross = int(k == CROSS_ATTN)
        mlp = k != SSD and bool(cfg.d_ff)
        c["rmsnorm"] += (1 + attn * post + cross + int(k == SSD)
                         + (1 + (0 if moe else post) if mlp else 0))
        c["flash_attention" if prefill else "paged_decode"] += attn + cross
        if prefill:
            c["rglru"] += int(k == RGLRU)
            c["ssd"] += int(k == SSD)
        if moe and mlp:
            c["moe_gmm"] += 3
    if prefill and cfg.is_encdec:
        c["flash_attention"] += cfg.encoder_layers
        c["rmsnorm"] += cfg.encoder_layers * (2 + post) + 1
    return c


def _grown_state(cfg, st, b: int, seq: int):
    """The prefill's state in the tree of a decode state of ``seq``
    positions: each k/v leaf copied into the first rows of its position
    axis (a full ring, the context's K/V and the recurrent states keep
    their shapes)."""
    from repro_torch.models import params as prm
    flat = prm.flatten(st)
    dev = next(iter(flat.values())).device
    grown = prm.zeros_state(cfg, prm.cache_specs(cfg, batch=b, seq=seq),
                            device=dev)
    for key, t in prm.flatten(grown).items():
        src = flat[key]
        (t if t.shape == src.shape else t[:, :, :src.shape[2]]).copy_(src)
    return grown


def _serve_inputs(cfg, b, s, device, seed=5):
    """Prompt tokens [b, s] and, for a cross-attention config, the stub
    context [b, context_len, d] N(0, 1), from numpy ``seed``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, s))
                              .astype(np.int32)).to(device)
    ctx = None
    if cfg.context_len:
        ctx = torch.from_numpy(rng.standard_normal(
            (b, cfg.context_len, cfg.d_model)).astype(np.float32)).to(device)
    return tokens, ctx


def _prefill_decode(cfg, params, tokens, ctx, steps):
    """lm.prefill, then ``steps`` greedy decode steps on the grown state
    -> (the tokens of every step [steps + 1, b] on the CPU, the state)."""
    import torch
    from repro_torch.models import lm
    b, s = tokens.shape
    tok, st = lm.prefill(cfg, params, tokens, ctx)
    state = _grown_state(cfg, st, b, s + steps)
    del st
    pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    toks = [tok.cpu()]
    for _ in range(steps):
        tok = lm.decode_step(cfg, params, state, tok, pos)
        toks.append(tok.cpu())
        pos += 1
    return torch.stack(toks), state


def phase_serve_consistency():
    """Phase 28: prefill plus 8 dense decode steps of each family arch in
    f32 at full width, card (kernels) against CPU (plain versions) from
    the same perturbed weights: every token equal, every state leaf
    within ``SERVE_STATE_TOL`` of the CPU's relative to its largest
    magnitude, the card's launches exact."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm

    out = {}
    steps = SERVE_CONSISTENCY_STEPS
    for arch, (replace, b, s) in SERVE_CONSISTENCY.items():
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(dtype="float32", **replace)
        base = _perturbed_base(cfg, s + steps + 8)
        tokens, ctx = _serve_inputs(cfg, b, s, "cpu")
        cpu_tok, cpu_st = _prefill_decode(cfg, base, tokens, ctx, steps)
        t_cpu = time.perf_counter() - t0
        gpu = {k: v.cuda() for k, v in prm.flatten(base).items()}
        _build.reset_launches()
        tok, st = _prefill_decode(
            cfg, prm.unflatten(gpu), tokens.cuda(),
            None if ctx is None else ctx.cuda(), steps)
        launches = dict(_build.LAUNCHES)
        pre = _serve_launch_counts(cfg, prefill=True)
        dec = _serve_launch_counts(cfg, prefill=False)
        want = {k: pre[k] + steps * dec[k] for k in pre}
        require(launches == want, f"{arch}: card launches {launches}, "
                                  f"expected {want}")
        require(torch.equal(tok, cpu_tok),
                f"{arch}: card tokens {tok.tolist()} != CPU tokens "
                f"{cpu_tok.tolist()}")
        errs = {}
        cflat = prm.flatten(cpu_st)
        for key, t in prm.flatten(st).items():
            w = cflat[key]
            errs[key] = float((t.cpu() - w).abs().max()) / (
                float(w.abs().max()) + 1e-8)
        worst = max(errs, key=errs.get)
        require(errs[worst] <= SERVE_STATE_TOL,
                f"{arch}: state {worst} differs by {errs[worst]} "
                f"(relative; tolerance {SERVE_STATE_TOL})")
        row = dict(arch=arch, layers=cfg.num_layers, window=cfg.window,
                   b=b, s=s, steps=steps, tokens=tok.tolist(),
                   state_max_rel_err=errs[worst], worst_leaf=worst,
                   launches={k: v for k, v in launches.items() if v},
                   cpu_s=t_cpu, total_s=time.perf_counter() - t0)
        print(f"[serve_consistency] {json.dumps(row)}", flush=True)
        out[arch] = row
        del base, gpu, st, cpu_st
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _profile_decode(cfg, params, state, tok, pos, steps=2):
    """Device time and idle share of ``steps`` decode steps under
    ``torch.profiler`` (host wall of the same steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = lm.decode_step(cfg, params, state, tok, pos)
            pos = pos + 1
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = _device_kernels(prof)
    device_ms = sum(k[0] for k in kernels) / 1e3 / steps
    return dict(steps=steps, wall_ms_per_step_profiled=wall_ms,
                device_ms_per_step=device_ms if kernels else "not measured",
                idle_share=(1 - device_ms / wall_ms) if kernels
                else "not measured",
                top=[dict(name=k[2][:80], ms_per_step=k[0] / 1e3 / steps)
                     for k in kernels[:6]])


def _family_serve_run(cfg, params, b, s, steps) -> dict:
    """lm.prefill of b x s and ``steps`` decode steps in bf16 at full
    width: exact launches of each, times, tokens/s, peak memory; the last
    2 steps profiled (device ms, idle share)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    torch.cuda.reset_peak_memory_stats()
    tokens, ctx = _serve_inputs(cfg, b, s, "cuda")
    ctx = None if ctx is None else ctx.to(torch.bfloat16)
    _build.reset_launches()
    t0 = time.perf_counter()
    tok, st = lm.prefill(cfg, params, tokens, ctx)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = dict(_build.LAUNCHES)
    want = _serve_launch_counts(cfg, prefill=True)
    require(pre == want, f"{cfg.name} prefill launched {pre}, expected "
                         f"{want}")
    state = _grown_state(cfg, st, b, s + steps)
    del st
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
    plain = steps - 2
    _build.reset_launches()
    step_s, toks = [], [tok.cpu()]
    for _ in range(plain):
        t0 = time.perf_counter()
        tok = lm.decode_step(cfg, params, state, tok, pos)
        toks.append(tok.cpu())
        step_s.append(time.perf_counter() - t0)
        pos += 1
    profile = _profile_decode(cfg, params, state, tok, pos, steps - plain)
    dec = dict(_build.LAUNCHES)
    per = _serve_launch_counts(cfg, prefill=False)
    want = {k: steps * v for k, v in per.items()}
    require(dec == want, f"{cfg.name} decode launched {dec} in {steps} "
                         f"steps, expected {want}")
    vp = cfg.padded_vocab()
    require(all(0 <= int(t) < vp for t in torch.cat(toks).tolist()),
            f"{cfg.name}: tokens outside the vocab")
    from repro_torch.models import params as prm
    for key, t in prm.flatten(state).items():
        require(bool(torch.isfinite(t).all()), f"{cfg.name}: {key} is not "
                                               f"finite")
    med = statistics.median(step_s[1:])
    row = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               dtype=cfg.dtype, b=b, s=s, steps=steps,
               prefill_ms=1e3 * prefill_s,
               prefill_tok_per_s=b * s / prefill_s,
               step_ms_median=1e3 * med, decode_tok_per_s=b / med,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches_prefill={k: v for k, v in pre.items() if v},
               launches_decode={k: v for k, v in dec.items() if v},
               profile=profile)
    del state
    return row, pre, dec


def _gemma2_engine(cfg) -> tuple:
    """gemma2-9b at full size on the dense engine (``GEMMA2_ENGINE``):
    exact launches per step (42 paged decode reads, 4 norms a layer and
    the final one), step times, tokens/s, peak memory, a profiled window
    -> (row, engine)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving import Request, ServingEngine
    g = GEMMA2_ENGINE
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, slots=g["slots"], max_seq=g["max_seq"])
    require(eng.paged is None and eng.device.type == "cuda",
            f"gemma2 engine: paged={eng.paged}, device {eng.device}")
    t0 = time.perf_counter()
    eng.load(seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        3, cfg.vocab_size, int(rng.integers(32, 129))).astype(np.int32),
        max_new_tokens=g["new_tokens"]) for i in range(g["requests"])]
    for r in reqs:
        eng.submit(r)
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run_until_drained(max_steps=60)
    profile, profiled = _profile_steps(eng, steps=2)
    stats = eng.run_until_drained()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = stats["steps"]
    per = _serve_launch_counts(cfg, prefill=False)
    want = {k: steps * v for k, v in per.items()}
    require(launches == want and want["paged_decode"] == steps * 42,
            f"gemma2 engine launched {launches} in {steps} steps, "
            f"expected {want}")
    vp = cfg.padded_vocab()
    for r in reqs:
        require(r.done and 1 <= len(r.out_tokens) <= g["new_tokens"]
                and all(0 <= t < vp for t in r.out_tokens),
                f"request {r.rid}: done={r.done} tokens={r.out_tokens}")
    step_ms = [1e3 * t for i, t in enumerate(eng.step_s)
               if i not in range(*profiled)]
    row = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
               **{k: g[k] for k in ("slots", "max_seq", "requests")},
               prompt_tokens=stats["prompt_tokens"],
               decoded_tokens=stats["decoded_tokens"], steps=steps,
               wall_s=wall_s, decoded_tok_per_s=stats["decoded_tokens"]
               / wall_s, step_ms_median=statistics.median(step_ms),
               step_ms_p90=float(np.percentile(step_ms, 90)),
               load_s=load_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches={k: v for k, v in launches.items() if v},
               sample_output=reqs[0].out_tokens[:8], profile=profile)
    print(f"[serve_families] {json.dumps(row)}", flush=True)
    return row, eng, launches


def phase_serve_families():
    """Phase 29: gemma2-9b at full size on the dense engine, then each
    family arch's prefill and 16 decode steps at full width and depth in
    bf16 (``FAMILY_SERVE``), exact launches, times, peak memory and idle
    share; the launches of every run are the path's."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import params as prm

    out, total = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    steps = FAMILY_SERVE_STEPS
    for arch, (b, s) in FAMILY_SERVE.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if arch == "gemma2-9b":
            row, eng, launches = _gemma2_engine(cfg)
            add(launches)
            out["gemma2_engine"] = row
            params = eng.params
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        else:
            params = prm.init_params(cfg, seed=0, device=torch.device("cuda"),
                                     max_pos=s + steps + 8)
        row, pre, dec = _family_serve_run(cfg, params, b, s, steps)
        add(pre)
        add(dec)
        row["wall_s"] = time.perf_counter() - t0
        print(f"[serve_families] {json.dumps(row)}", flush=True)
        out[arch] = row
        del params
        gc.collect()
        torch.cuda.empty_cache()
    never = [k for k in ("paged_decode", "rmsnorm", "flash_attention",
                         "rglru", "ssd", "moe_gmm") if not total.get(k)]
    require(not never, f"the families' serving path never launched {never}")
    out["launches"] = total
    return out


# ---------------------------------------------------------------------------
# serving on a TMP mesh and speculative decoding (phases 30-32)
# ---------------------------------------------------------------------------
DRAFT_ARCH = "gpt-draft-h2048"
SPEC_K = 3
# phase 30: the verify's read at gpt-serve-h4096's shapes, 8 slots x
# (spec_k + 1) queries of 32 heads of 128 over 2,048 positions (page 16),
# the last slot's block running past the last position
VERIFY_CASE = dict(b=8, qn=SPEC_K + 1, h=32, kvh=32, hd=128, S=2048,
                   page=16, pos=[0, 15, 16, 1023, 1024, 777, 1500, 2046])
# the decode exit of gpt-serve-h4096's wd at tp=2: [8, 1, 16,384 / tp] @
# [16,384 / tp, 4,096], the ring over the slot batch (chunks of 4 rows)
DECODE_EXIT = ("wd_decode", 8, 16384, 4096)
# phase 31: f32 gates at full width; the spec run's target and draft
# depths, the TMP runs' depth, the engine's shape
SPEC_LAYERS, SPEC_DRAFT_LAYERS = 4, 2
TMP_SERVE_LAYERS = 8
GATE_ENGINE = dict(slots=8, max_seq=256, requests=9, new=8)
TMP_SERVE_CASES = [(s, paged) for s in TP_SCHEDULES for paged in (False,
                                                                 True)]
TMP_2D_CASES = [("oases", False), ("fused", False)]
SERVE_2D = ((1, 2, 2), ("data", "model_x", "model_y"))
# phase 32: gpt-serve-h4096 at full size in bf16 with and without the
# draft (gpt-draft-h2048, all 12 layers): 8 slots of 2,048, 16 requests
# of 16-64 prompt and 32 new tokens
SPEC_SERVE = dict(slots=8, max_seq=2048, requests=16, new=32)
# a divergence of the drafted run's tokens from the undrafted run's is a
# near tie only below this gap between the target's top two logits there
SPEC_GAP_TOL = 0.05


def _verify_row(dname: str, paged: bool) -> dict:
    """The verify's read (row 1, the queries folded into the paged decode
    kernel's batch) against its plain version, twice for the same bits;
    timed beside its bound (each slot's K/V rows read once for its qn
    queries; beside it the bound of what the folded kernel streams, K/V
    read once a query row), the plain
    version and SDPA with the offset causal mask on the gathered cache."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.bounds import paged_decode_work
    from repro_torch.kernels.flash_attention import (dense_flash_decode_multi,
                                                     paged_flash_decode_multi)

    c = VERIFY_CASE
    b, qn, h, kvh, hd, S, page = (c[k] for k in ("b", "qn", "h", "kvh",
                                                 "hd", "S", "page"))
    nb = S // page
    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(b, qn, h, hd, generator=gen, device="cuda").to(dtype)
    pos = torch.tensor(c["pos"], dtype=torch.int32, device="cuda")
    if paged:
        kc, vc = (torch.randn(b * nb + 1, page, kvh, hd, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        tables = (torch.randperm(b * nb, generator=gen, device="cuda")
                  + 1).reshape(b, nb).to(torch.int32)

        def run():
            return paged_flash_decode_multi(q, kc, vc, tables, pos)

        def plain():
            return ref.paged_decode_attention_multi_ref(q, kc, vc, tables,
                                                        pos)
        kg, vg = ref.gather_pages(kc, tables), ref.gather_pages(vc, tables)
    else:
        kc, vc = (torch.randn(b, S, kvh, hd, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))

        def run():
            return dense_flash_decode_multi(q, kc, vc, pos)

        def plain():
            return ref.decode_attention_multi_ref(q, kc, vc, pos)
        kg, vg = kc, vc
    out, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    name = f"verify_{'paged' if paged else 'dense'}"
    require(torch.equal(out, again), f"paged_decode {name} {dname}: two "
                                     f"runs differ")
    atol, rtol = PAGED_TOL[dname]
    err, ok = max_err(out, want, atol, rtol)
    require(ok, f"paged_decode {name} {dname}: max abs err {err} beyond "
                f"atol {atol} + rtol {rtol}")
    elt = q.element_size()
    seen = sum(min(p + j, S - 1) + 1 for p in c["pos"] for j in range(qn))
    distinct = sum(min(p + qn - 1, S - 1) + 1 for p in c["pos"])
    # the function's work: each slot's K/V rows and table row read once
    # for its qn queries; q.k and p.v over every query row's positions
    nbytes, flops = paged_decode_work(b * qn, h, kvh, hd, distinct, seen,
                                      b * nb, elt)
    bound = _bound(nbytes, flops, dname)
    # what the folded kernel streams: a slot's K/V and table once a row
    per_row = _bound(paged_decode_work(b * qn, h, kvh, hd, seen, seen,
                                       b * qn * nb, elt)[0], flops, dname)
    # yardstick: one SDPA call on the cache already gathered, the query j
    # of a slot masked past pos + j (MHA: kvh = h)
    qh, kh, vh = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
    qpos = pos.long()[:, None] + torch.arange(qn, device="cuda")[None]
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    row = dict(case=name, dtype=dname, b=b, qn=qn, h=h, kvh=kvh, hd=hd,
               S=S, page=page, pos=c["pos"], folded_rows=b * qn,
               max_abs_err=err, atol=atol, rtol=rtol, same_bits=True,
               ms=time_ms(run), plain_ms=time_ms(plain, iters=10),
               bound_ms=bound[0], bound_by=bound[1], bytes=nbytes,
               flops=flops, bound_per_query_row_ms=per_row[0],
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, attn_mask=mask)),
               library_err=float((lib.transpose(1, 2).float()
                                  - want.float()).abs().max()))
    print(f"[paged_decode] {json.dumps(row)}", flush=True)
    return row


def phase_spec_kernels():
    """Phase 30: the verify's folded read (row 1), then the decode-shape
    ring (row 5) and peer all-reduce (5a) on 2 ranks; phase 31's 1-D TMP
    decode follows in the same rank processes when it runs."""
    out = {"paged_decode": [], "ring_matmul_rs": [], "peer_all_reduce": []}
    for paged in (False, True):
        for dname in ("float32", "bfloat16"):
            out["paged_decode"].append(_verify_row(dname, paged))
    t0 = time.perf_counter()
    per_rank = _spawn_with_next(_decode_exit_rank, (), 31, _tmp_serve_setup,
                                _tmp_serve_rank, 600)
    out["spawn_wall_s"] = time.perf_counter() - t0
    for kind in ("ring_matmul_rs", "peer_all_reduce"):
        for i, row in enumerate(per_rank[0][kind]):
            rs = [r[kind][i] for r in per_rank]
            row = dict(row, tp=2, max_abs_err=max(r["max_abs_err"]
                                                  for r in rs),
                       rank_errs=[r["max_abs_err"] for r in rs],
                       rank_ms=[r["ms"] for r in rs])
            row.pop("ok")
            print(f"[{kind}] {json.dumps(row)}", flush=True)
            require(all(r["ok"] for r in rs),
                    f"{kind} {row['case']} {row['dtype']}: rank errors "
                    f"{row['rank_errs']} beyond atol {row['atol']} + rtol "
                    f"{row['rtol']}")
            require(all(r.get("same_bits", True) for r in rs),
                    f"{kind} {row['case']} {row['dtype']}: two runs differ")
            out[kind].append(row)
    return out


def _decode_exit_rank(comm, device):
    """One rank of phase 30: gpt-serve-h4096's wd exit at decode shapes,
    f32 and bf16, every rank drawing all ranks' inputs from one seed: the
    ring kernel over the slot batch against the plain ring; the fused
    exit (ring and peer all-gather) and megatron's (torch.matmul and the
    peer all-reduce) against the plain all-reduce of every rank's product;
    the peer all-reduce of the exit's output."""
    import torch
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels.collective_matmul import (matmul_allreduce,
                                                       matmul_reducescatter)

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rank = comm.size, comm.rank
    case, rows, kfull, d = DECODE_EXIT
    k = kfull // n
    out = {"ring_matmul_rs": [], "peer_all_reduce": []}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=device).manual_seed(5)
        xs = [torch.randn(rows, 1, k, generator=gen, device=device)
              .to(dtype) for _ in range(n)]
        ws = [(torch.randn(k, d, generator=gen, device=device)
               / kfull ** 0.5).to(dtype) for _ in range(n)]
        x, w = xs[rank], ws[rank]
        got = matmul_reducescatter(x, w, comm, 0)
        same = dname == "float32" or torch.equal(
            got, matmul_reducescatter(x, w, comm, 0))
        want = ref.matmul_reducescatter_all_ranks_ref(
            [t[:, 0] for t in xs], ws, n, rank)[:, None]
        full = matmul_allreduce(x, w, comm, 0)
        mega = comm.all_reduce(torch.matmul(x, w))
        whole = ref.all_reduce_ref([torch.matmul(a, b)
                                    for a, b in zip(xs, ws)])
        torch.cuda.synchronize(device)
        atol, rtol = _mm_tol(kfull, dname)
        err, ok = max_err(got, want, atol, rtol)
        err_full, ok_full = max_err(full, whole, atol, rtol)
        err_mega, ok_mega = max_err(mega, whole, atol, rtol)
        elt = x.element_size()
        bound = _bound((rows * k + k * d + rows // n * d) * elt,
                       2 * rows * k * d, dname)
        out["ring_matmul_rs"].append(dict(
            case=case, dtype=dname, rows=rows, k_local=k, d=d,
            chunk=rows // n, path=autotune.shape_path(k, d, dtype),
            same_bits=same, max_abs_err=err, ok=ok and ok_full and ok_mega,
            fused_exit_err=err_full, megatron_exit_err=err_mega, atol=atol,
            rtol=rtol, ms=time_ms(lambda: matmul_reducescatter(x, w, comm,
                                                                0)),
            plain_ms=time_ms(lambda: ref.matmul_reducescatter_all_ranks_ref(
                [t[:, 0] for t in xs], ws, n, rank), iters=10),
            bound_ms=bound[0], bound_by=bound[1], library_ms=None,
            cublas_same_product_ms=time_ms(lambda: torch.matmul(x, w)),
            fused_exit_ms=time_ms(lambda: matmul_allreduce(x, w, comm, 0)),
            matmul_allreduce_ms=time_ms(
                lambda: comm.all_reduce(torch.matmul(x, w)))))
        ys = [torch.matmul(a, b) for a, b in zip(xs, ws)]
        y = ys[rank]
        got = comm.all_reduce(y)
        want = ref.all_reduce_ref(ys)
        torch.cuda.synchronize(device)
        err, ok = max_err(got, want, 0.0, 0.0)
        numel = y.numel()
        bound = _bound((n + 1) * numel * elt, (n - 1) * numel, dname)
        out["peer_all_reduce"].append(dict(
            case="decode_exit", dtype=dname, shape=list(y.shape),
            max_abs_err=err, ok=ok, atol=0.0, rtol=0.0,
            ms=time_ms(lambda: comm.all_reduce(y)),
            plain_ms=time_ms(lambda: ref.all_reduce_ref(ys)),
            bound_ms=bound[0], bound_by=bound[1], library_ms=None))
        del xs, ws, ys
    comm.check()
    return out


def _gate_prompts(np, vocab, n):
    """``n`` prompts of 4-11 tokens from numpy seed 12."""
    rng = np.random.default_rng(12)
    return [rng.integers(3, vocab, int(rng.integers(4, 12)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng, prompts, new):
    """Submit the prompts and drain ``eng`` -> (the requests, its stats,
    the launches of the drain, its seconds)."""
    from repro_torch.kernels import _build
    from repro_torch.serving import Request
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    _build.reset_launches()
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    _sync(eng.device)
    return reqs, stats, dict(_build.LAUNCHES), time.perf_counter() - t0


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_launches(layers: int, steps: int, draft_layers: int = 0,
                    k: int = 0) -> dict:
    """The launches of ``steps`` engine steps of a ``layers``-layer dense
    model, each a decode step or (``draft_layers``) a speculative round:
    the verify and k + 1 draft steps.  A layer reads its cache once
    (``paged_decode``) and norms twice, the model once more."""
    pd = steps * (layers + (k + 1) * draft_layers)
    rms = steps * (2 * layers + 1 + ((k + 1) * (2 * draft_layers + 1)
                                     if draft_layers else 0))
    return {"paged_decode": pd, "rmsnorm": rms}


def _tmp_serve_setup():
    """Phase 31's TMP reference: the tp=1 card engine at 8 layers of
    gpt-serve-h4096 in f32 (weights from seed 0, as every rank draws
    them), dense -> (its tokens and steps, the 1-D rank arguments)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.serving import ServingEngine

    cfg = get_config(ARCH).replace(num_layers=TMP_SERVE_LAYERS,
                                   dtype="float32")
    g = GATE_ENGINE
    eng = ServingEngine(cfg, slots=g["slots"], max_seq=g["max_seq"])
    eng.load(seed=0)
    reqs, stats, launches, s = _drain(
        eng, _gate_prompts(np, cfg.vocab_size, g["requests"]), g["new"])
    ref = dict(tokens=[r.out_tokens for r in reqs], steps=stats["steps"],
               launches=launches, s=s)
    want = _serve_launches(TMP_SERVE_LAYERS, stats["steps"])
    require({k: launches[k] for k in want} == want,
            f"tp=1 reference launched {launches} in {stats['steps']} steps")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ref, (TMP_SERVE_CASES,)


def _tmp_serve_rank(comm, device, cases):
    """One rank of phase 31's TMP decode: gpt-serve-h4096 at full width and
    8 layers in f32, this rank's shard of the seed-0 weights, one engine
    per (schedule, paged) case on the rank's mesh -> each case's tokens,
    steps, launches, comm counts and seconds."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH).replace(num_layers=TMP_SERVE_LAYERS,
                                   dtype="float32")
    g = GATE_ENGINE
    prompts = _gate_prompts(np, cfg.vocab_size, g["requests"])
    params, out = None, {}
    for sched, paged in cases:
        eng = ServingEngine(cfg, comm, slots=g["slots"],
                            max_seq=g["max_seq"], schedule=sched,
                            paged=paged, device=device)
        if params is None:
            eng.load(seed=0)
            params = eng.params
        else:
            eng.load(params=params)
        comm.reset_counts()
        comm.barrier()
        reqs, stats, launches, s = _drain(eng, prompts, g["new"])
        out[f"{sched}/{'paged' if paged else 'dense'}"] = dict(
            tokens=[r.out_tokens for r in reqs], steps=stats["steps"],
            launches=launches, counts=dict(comm.counts), s=s,
            twod=eng.ctx.is_2d)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    comm.check()
    return out


def _check_tmp_serve(ref, per_rank, wall, ranks) -> dict:
    """Phase 31's TMP gates: every rank's tokens are tp=1's, in as many
    steps, with the launches of the code's path (a ring a fused exit; in
    2-D also one a fused entry product over y)."""
    out = {}
    for name in per_rank[0]:
        rs = [r[name] for r in per_rank]
        r0 = rs[0]
        steps = r0["steps"]
        rings = 0
        if name.startswith("fused/"):
            rings = steps * TMP_SERVE_LAYERS * (7 if r0["twod"] else 2)
        want = {**_serve_launches(TMP_SERVE_LAYERS, steps),
                "ring_matmul_rs": rings}
        row = dict(ranks=ranks, steps=steps, launches=r0["launches"],
                   want=want, counts=r0["counts"],
                   rank_s=[r["s"] for r in rs], spawn_wall_s=wall,
                   tokens_equal=all(r["tokens"] == ref["tokens"]
                                    for r in rs))
        print(f"[tmp_serve] {name} {json.dumps(row)}", flush=True)
        require(row["tokens_equal"], f"TMP decode {name} on {ranks} ranks: "
                f"tokens differ from tp=1's")
        require(steps == ref["steps"], f"TMP decode {name}: {steps} steps, "
                                       f"tp=1 took {ref['steps']}")
        for r in rs:
            got = {k: r["launches"].get(k, 0) for k in want}
            require(got == want, f"TMP decode {name}: launched {got}, "
                                 f"expected {want}")
            require(r["launches"]["peer_all_gather"] >= steps,
                    f"TMP decode {name}: {r['launches']['peer_all_gather']}"
                    f" peer all-gathers in {steps} steps (the greedy "
                    f"token's gather is one a step)")
        out[name] = row
    return out


def phase_spec_consistency():
    """Phase 31: f32 at full width.  gpt-serve-h4096 at 4 layers with the
    draft gpt-draft-h2048 at 2 (and the target itself as a draft): the
    drafted card runs' tokens are the undrafted card run's and the CPU
    run's, launches exact.  TMP decode at 8 layers on 2 ranks (three
    schedules, dense and paged; in phase 30's spawn when it ran) and on
    4 ranks in 2-D (oases, fused): tp=1's tokens on every rank."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import params as prm
    from repro_torch.serving import ServingEngine

    g = GATE_ENGINE
    cfg = get_config(ARCH).replace(num_layers=SPEC_LAYERS, dtype="float32")
    dcfg = get_config(DRAFT_ARCH).replace(num_layers=SPEC_DRAFT_LAYERS,
                                          dtype="float32")
    cuda = torch.device("cuda")
    params = prm.init_params(cfg, seed=0, device=cuda)
    dparams = prm.init_params(dcfg, seed=1, device=cuda)
    prompts = _gate_prompts(np, cfg.vocab_size, g["requests"])
    runs = {"card": ({}, params, cuda),
            "spec": (dict(draft=dcfg, spec_k=SPEC_K), params, cuda),
            "self_draft": (dict(draft=cfg, spec_k=SPEC_K), params, cuda),
            "cpu": ({}, prm.unflatten({k: t.cpu() for k, t in
                                       prm.flatten(params).items()}),
                    torch.device("cpu"))}
    res = {}
    for name, (kw, p, dev) in runs.items():
        eng = ServingEngine(cfg, slots=g["slots"], max_seq=g["max_seq"],
                            device=dev, **kw)
        draft = (dparams if kw.get("draft") is dcfg else p) if kw else None
        eng.load(params=p, draft_params=draft)
        reqs, stats, launches, s = _drain(eng, prompts, g["new"])
        dl = {"spec": SPEC_DRAFT_LAYERS, "self_draft": SPEC_LAYERS}.get(
            name, 0)
        want = ({k: 0 for k in launches} if dev.type == "cpu" else
                {**{k: 0 for k in launches}, **_serve_launches(
                    SPEC_LAYERS, stats["steps"], dl, SPEC_K if dl else 0)})
        row = dict(steps=stats["steps"], decoded=stats["decoded_tokens"],
                   spec_proposed=stats["spec_proposed"],
                   spec_accepted=stats["spec_accepted"],
                   accept_rate=stats.get("spec_accept_rate"),
                   launches=launches, want=want, s=s,
                   tokens=[r.out_tokens for r in reqs])
        print(f"[spec_consistency] {name} {json.dumps(row)}", flush=True)
        require(launches == want, f"{name}: launched {launches}, "
                                  f"expected {want}")
        res[name] = row
        del eng
    for name in ("spec", "self_draft", "cpu"):
        require(res[name]["tokens"] == res["card"]["tokens"],
                f"{name} tokens differ from the undrafted card run's")
    require(res["self_draft"]["spec_accepted"] > 0,
            f"the self draft's proposals were never accepted: "
            f"{res['self_draft']}")
    del params, dparams, runs
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": ARCH, "draft": DRAFT_ARCH, "layers": SPEC_LAYERS,
           "draft_layers": SPEC_DRAFT_LAYERS, "dtype": "float32",
           "spec_k": SPEC_K, **g, "runs": res}
    done = _RUN.pop(31, None)
    if done is None:
        ref, args = _tmp_serve_setup()
        t0 = time.perf_counter()
        per_rank = run_ranks(_tmp_serve_rank, 2, args=args, timeout=600)
        wall = time.perf_counter() - t0
    else:
        ref, per_rank, wall = done["ctx"], done["per_rank"], done["wall"]
    out["tmp_ref"] = {k: v for k, v in ref.items() if k != "tokens"}
    out["tmp"] = _check_tmp_serve(ref, per_rank, wall, 2)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = run_ranks(_tmp_serve_rank, mesh=SERVE_2D,
                         args=(TMP_2D_CASES,), timeout=600)
    out["tmp_2d"] = _check_tmp_serve(ref, per_rank,
                                     time.perf_counter() - t0, 4)
    out["launches"] = {}
    for rows in (out["tmp"], out["tmp_2d"]):
        for row in rows.values():
            for k, v in row["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
    never = [k for k in ("paged_decode", "rmsnorm", "ring_matmul_rs",
                         "peer_all_reduce", "peer_all_gather")
             if not out["launches"].get(k)]
    require(not never, f"TMP decode never launched {never}")
    return out


def _spec_prompts(np, vocab, n):
    """``n`` prompts of 16-64 tokens from numpy seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(3, vocab, int(rng.integers(16, 65)))
            .astype(np.int32) for _ in range(n)]


def _record_gaps(eng, gaps):
    """Wrap ``eng``'s undrafted step: the target's top-2 logit gap of each
    token a request emits, kept on the card until the drain ends, by
    (request, token index)."""
    import torch
    from repro_torch.models import lm

    step = eng._plain_step
    seen = []

    def last_logits(*a, **kw):
        logits = orig(*a, **kw)
        top = torch.topk(logits, 2, dim=-1).values
        seen.append(top[:, 0] - top[:, 1])
        return logits

    def plain_step(rec):
        before = [(r, len(r.out_tokens)) if r is not None else None
                  for r in eng.active]
        seen.clear()
        step(rec)
        for s, b in enumerate(before):
            if b is not None and len(b[0].out_tokens) > b[1]:
                gaps[(b[0].rid, b[1])] = seen[0][s]

    orig = lm.last_logits
    lm.last_logits = last_logits
    eng._plain_step = plain_step
    return lambda: setattr(lm, "last_logits", orig)


def phase_spec_serve():
    """Phase 32: gpt-serve-h4096 at full size in bf16 on the dense engine,
    once without and once with the draft (gpt-draft-h2048, all 12
    layers, spec_k 3): exact launches, rounds, accept rate, tokens a
    round, tokens/s, step ms, device ms and idle share of a profiled
    window, peak memory; the drafted run's tokens against the undrafted
    run's, any divergence reported with the target's top-2 logit gap
    there (above ``SPEC_GAP_TOL``: a fault)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.serving import Request, ServingEngine

    c = SPEC_SERVE
    cfg = get_config(ARCH)
    dcfg = get_config(DRAFT_ARCH)
    cuda = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = prm.init_params(cfg, seed=0, device=cuda,
                             max_pos=c["max_seq"] + 8)
    dparams = prm.init_params(dcfg, seed=1, device=cuda,
                              max_pos=c["max_seq"] + 8)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompts = _spec_prompts(np, cfg.vocab_size, c["requests"])
    out = {"arch": ARCH, "draft": DRAFT_ARCH, "layers": cfg.num_layers,
           "draft_layers": dcfg.num_layers, "dtype": cfg.dtype,
           "spec_k": SPEC_K, **c, "card": _card(), "load_s": load_s,
           "runs": {}}
    tokens, gaps = {}, {}
    for name, kw in (("plain", {}), ("spec", dict(draft=dcfg,
                                                  spec_k=SPEC_K))):
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(cfg, slots=c["slots"], max_seq=c["max_seq"],
                            **kw)
        eng.load(params=params, draft_params=dparams if kw else None)
        undo = _record_gaps(eng, gaps) if not kw else (lambda: None)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=c["new"])
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        _build.reset_launches()
        t0 = time.perf_counter()
        eng.run_until_drained(max_steps=24 if kw else 60)
        profile, profiled = _profile_steps(eng, 2)
        stats = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        undo()
        steps = stats["steps"]
        want = {**{k: 0 for k in launches}, **_serve_launches(
            cfg.num_layers, steps, dcfg.num_layers if kw else 0,
            SPEC_K if kw else 0)}
        step_ms = [1e3 * s for i, s in enumerate(eng.step_s)
                   if i not in range(*profiled)]
        row = dict(rounds=steps, decoded_tokens=stats["decoded_tokens"],
                   prompt_tokens=stats["prompt_tokens"],
                   spec_proposed=stats["spec_proposed"],
                   spec_accepted=stats["spec_accepted"],
                   accept_rate=stats.get("spec_accept_rate"),
                   tokens_per_round=(stats["decoded_tokens"]
                                     + stats["prompt_tokens"]) / steps,
                   decoded_per_round=stats["decoded_tokens"] / steps,
                   wall_s=wall,
                   decoded_tok_per_s=stats["decoded_tokens"] / wall,
                   step_ms_median=statistics.median(step_ms),
                   step_ms_p90=float(np.percentile(step_ms, 90)),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=launches, want=want, profile=profile)
        print(f"[spec_serve] {name} {json.dumps(row)}", flush=True)
        require(launches == want, f"{name}: launched {launches}, expected "
                                  f"{want}")
        vp = cfg.padded_vocab()
        for r in reqs:
            require(r.done and 1 <= len(r.out_tokens) <= c["new"]
                    and all(0 <= t < vp for t in r.out_tokens),
                    f"{name} request {r.rid}: done={r.done} tokens="
                    f"{r.out_tokens}")
        tokens[name] = [r.out_tokens for r in reqs]
        out["runs"][name] = row
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    diverged = []
    for rid, (a, b) in enumerate(zip(tokens["plain"], tokens["spec"])):
        if a != b:
            i = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                     min(len(a), len(b)))
            gap = gaps.get((rid, i))
            diverged.append(dict(request=rid, index=i,
                                 plain=a[i] if i < len(a) else None,
                                 spec=b[i] if i < len(b) else None,
                                 top2_gap=None if gap is None
                                 else float(gap)))
    out["tokens_equal"] = not diverged
    out["divergences"] = diverged
    # how near to a tie the undrafted run's tokens came
    out["min_top2_gap"] = min(float(v) for v in gaps.values())
    print(f"[spec_serve] tokens_equal={not diverged} "
          f"{json.dumps(diverged)}", flush=True)
    for d in diverged:
        require(d["top2_gap"] is not None and d["top2_gap"] <= SPEC_GAP_TOL,
                f"the drafted run diverges at request {d['request']} token "
                f"{d['index']} where the target's top-2 gap is "
                f"{d['top2_gap']} > {SPEC_GAP_TOL}: a fault, not a near "
                f"tie")
    out["launches"] = {}
    for row in out["runs"].values():
        for k, v in row["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


PHASES = {1: ("build", phase_build), 2: ("kernels", phase_kernels),
          3: ("consistency", phase_consistency), 4: ("serve", phase_serve),
          5: ("train_kernels", phase_train_kernels),
          6: ("train_consistency", phase_train_consistency),
          7: ("train", phase_train), 8: ("tmp_kernels", phase_tmp_kernels),
          9: ("tp_consistency", phase_tp_consistency),
          10: ("tp_train", phase_tp_train),
          11: ("ring_kernels", phase_ring_kernels),
          12: ("sp_consistency", phase_sp_consistency),
          13: ("sp_train", phase_sp_train),
          14: ("family_kernels", phase_family_kernels),
          15: ("family_consistency", phase_family_consistency),
          16: ("family_train", phase_family_train),
          17: ("hybrid_kernels", phase_hybrid_kernels),
          18: ("hybrid_consistency", phase_hybrid_consistency),
          19: ("hybrid_train", phase_hybrid_train),
          20: ("planner", phase_planner),
          21: ("plan_consistency", phase_plan_consistency),
          22: ("plan_train", phase_plan_train),
          23: ("dryrun", phase_dryrun),
          24: ("families2_kernels", phase_families2_kernels),
          25: ("families2_consistency", phase_families2_consistency),
          26: ("families2_train", phase_families2_train),
          27: ("serve_kernels", phase_serve_kernels),
          28: ("serve_consistency", phase_serve_consistency),
          29: ("serve_families", phase_serve_families),
          30: ("spec_kernels", phase_spec_kernels),
          31: ("spec_consistency", phase_spec_consistency),
          32: ("spec_serve", phase_spec_serve)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phase numbers (default: all)")
    args = ap.parse_args(argv)
    phases = sorted({int(p) for p in args.phases.split(",")} | {1})
    if 9 in phases and 6 not in phases:
        phases = sorted(set(phases) | {6})
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # f32 phases compare full-f32 products: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device_name": torch.cuda.get_device_name(0), "phases": {}}
    _RUN["report"] = report
    _RUN["phases"] = phases
    for p in phases:
        name, fn = PHASES[p]
        tp = time.perf_counter()
        report[name] = fn()
        report["phases"][name] = time.perf_counter() - tp
        print(f"[phase {p}] {name} done in {report['phases'][name]:.1f} s",
              flush=True)
    report["total_s"] = time.perf_counter() - t0
    print(f"[wall_s] {json.dumps(report['phases'])}")

    line = _kernels_line(report)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"[total] {report['total_s']:.1f} s")
    print(report["build"]["card"])
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
