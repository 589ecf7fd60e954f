"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and the rest of the
repository beside this file; it exits non-zero without them. In order it:

1. prints the card's name and power limit (``nvidia-smi``) and the torch
   and CUDA versions;
2. builds the hand-written kernels from ``src/repro_torch/kernels/*/csrc``
   for ``sm_90a`` (one ``nvcc`` per source, all at once);
3. holds the flash-attention forward kernels against their plain PyTorch
   version at the towers' serving shapes, in f32 (the split 3×TF32
   tensor-core kernel) and bf16 (the tensor-core kernel, held against the
   plain version that rounds p to bf16 as the kernel does; its distance
   from the unrounded fp32 forward is printed, not gated), and in bf16 at
   one training microbatch (image bh 3072, s 196; text bh 4096, s 16,
   padded), printing each launch plan, and times kernel (between events,
   and its device time from the profiler), plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls;
   events and device time);
4. holds the similarity→top-k kernel against its plain version over a
   grid of batch, class-count and k, with planted exact ties, and times
   kernel (between events, and its device time from the profiler, where
   it must be one device kernel per call), plain version and
   ``torch.topk(x @ c.T)`` (events and device time), and the kernel at
   each row block size it is built for;
5. holds the flash-attention backward kernels against their plain version
   at the training shapes of one microbatch (image bh 3072, s 196; text
   bh 4096, s 16 with the padding bias; causal, windowed and d 128 cases,
   and f32 and bf16 cases whose keys split over CTAs), in f32 (the split
   3×TF32 tensor-core kernel) and bf16 (the tensor-core kernel, held
   against the plain version that rounds p and ds to bf16 as the kernel
   does; its distance from the unrounded fp32 backward is printed, not
   gated), printing each launch plan, and times kernel (events and device
   time), plain version and SDPA's backward;
6. holds the fused contrastive forward and backward kernels against their
   plain versions at B = 2048 and a ragged B = 1000 (D = 512, f32 and
   bf16, and the backward with ``with_diag=False`` and ``b_norm != B``),
   the forward also against ``row_col_lse`` bit for bit (one launch
   sequence serves both), and times kernel (the forward also by its
   device time), plain version and the materialising PyTorch calls (f32
   at both batches, bf16 at B = 2048), printing the forward's launch plan
   (``lse_plan``) and the backward's (grid, slices, scratch bytes);
7. holds the legacy 4-pass pair, ``row_col_lse`` and ``grads``, against
   their plain versions at ``benchmarks/kernel_bench.py``'s six shapes
   (B 512, 2048, 8192 × D 256, 1024; f32, timed), in bf16 at B = 2048 and
   at a ragged B = 1000 (f32 and bf16), ``grads`` also without diag at
   ``b_norm`` = 3B, printing ``row_col_lse``'s launch plan (tile edge,
   grid, scratch) per shape; then drives ``fused_loss_and_lse_4pass`` and
   ``fused_contrastive_loss_4pass`` at the six shapes (counts set to 0
   before), holds them against ``fused_contrastive_loss`` and its
   autograd, prints the bench's ``old4`` / ``fused2`` times under its keys
   and profiles one 4-pass call;
8. serves zero-shot classification with BASIC-S at full width on the card
   (``repro_torch.launch.serve_zeroshot``: 512 classes × 4 prompt
   templates, 8 requests of 16 raw 224×224×3 images), checks the answers
   against the plain PyTorch path on the same weights and images, and
   checks that both serving kernels were launched on that path; then
   profiles 4 warm requests: device time by kernel, and the device kernels
   that each wrapper call launched; then serves twice more with a registry
   directory, the second time from a fresh service that must read the
   class matrix from disk and give the same top-5 ids;
9. training parity: one GradAccum step of BASIC-S at full width and depth
   in f32 (B = 256, 2 microbatches) on the kernel path (flash attention,
   fused loss) and on the plain path (materialised attention and loss)
   from the same weights and batch: loss, every gradient leaf and the
   parameters after AdaFactorW; the kernel path must launch both f32
   flash kernels (counted) and the plain path neither;
10. timed training: ``repro_torch.launch.train`` (``main``) at full width
    and depth, bf16, fused loss, flash attention, remat ``basic``, B = 2048
    pairs in 8 microbatches, 6 steps: step time, pairs per second, peak
    memory, losses, and the launches per step of the four training kernels;
    then profiles one warm step;
11. the BASIC recipe through ``repro_torch.launch.train`` at full width
    and depth (bf16, flash attention, remat ``basic``, 64 classes): phase
    1 ``--mode pretrain`` (4 steps of B = 1024, saved with
    ``--ckpt-dir``), phase 2 contrastive with the pretrained image tower
    restored from that checkpoint (bit for bit) and frozen (3 steps of B =
    2048 in 8 microbatches; the tower must equal phase 1's times
    Π(1 − lr_t·0.0025)),
    phase 3 finetune (2 steps at lr 5e-4); then ``evaluate_benchmark`` and
    ``evaluate_with_service`` of the final model on the same 1024 fresh
    images (the same top-1 on every row whose top-2 cosine gap exceeds
    1e-5), and the zero-shot table (seen / unseen / shifted) on the card;
    checks the launches of each part (flash in phase 1, the contrastive
    kernels in phases 2 and 3, ``topk_fused`` in ``evaluate_with_service``
    only) and prints step medians, images/s and pairs/s, peak memory and
    the accuracy rows;
12. the paper's §4.2 moment accumulation: one f32 step of BASIC-S (B =
    256 in 2 microbatches, the kernel path) from ``microbatch_grads`` +
    ``AdaFactorW.update_from_microbatches`` against ``contrastive_step`` +
    ``update``: mean_K(c) against the gradient, the first moment, and the
    peak memory of both;
13. holds the split-K decode-attention kernel against its plain version at
    the decode path's shapes (8 slots × 8 kv heads × group 4, d 64, a
    cache of 8192; one lockstep request; d 128 with group 8; group 1),
    f32 and bf16, with per-slot lengths 0, 1, 255, 256, 257, ragged and
    full, a shared mask (bit for bit equal to equal per-slot rows) and
    stale entries past each length (no change at all), and times kernel
    (events and profiler device time), plain version and SDPA at the
    serving state (~7% of the cache valid) and at a full cache; holds the
    flash forward against its plain version at the prefill shape (out and,
    within 5e-5, lse) and times it;
14. decode parity: Llama-3.2-1B at full width and depth in f32 through
    ``transformer.prefill`` and ``decode_step`` on the kernel path (flash
    prefill, decode kernel) and the plain path (chunked prefill, einsum
    decode), teacher-forced with the same tokens, on a linear cache (4 ×
    512 tokens, cache 1024) and a ring that has wrapped (8704 tokens,
    cache 8192); then the continuous engine against the lockstep engine,
    request by request, on the kernel path;
15. timed decode serving: ``repro_torch.launch.serve`` (``main``) with the
    continuous engine at full width and depth, bf16, 8 slots, 16 requests
    of ~512-token prompts and 64 new tokens, a ring cache of 8192: tokens
    per second, decode-step median and p90, prefill ms, peak memory, and
    flash_fwd launches per prefill and decode_attention launches per step
    (16 each, one per layer); then profiles 4 warm decode steps;
16. holds the SSD chunked-scan kernel against its plain version at
    Mamba-2-130M's shapes (24 heads of 64, state 128; one chunk of 256, a
    ragged 244, four chunks of b 1 × 1024, b 8 × 256, the training shape
    b 2 × 4096; a rank's heads under ``tp``: 12 at b 2 × 1024, 6 at b 2 ×
    4096, Jamba's 64 at b 1 × 4096; with and without an
    initial state; the decay extremes dt 3, A -5 with no NaN), inputs laid
    out as the mixer's split views, f32 and bf16, y and the final state,
    printing each launch plan (``ssd_plan``), and times kernel (events,
    and its device time from the profiler) and plain version (no single
    PyTorch call computes the scan);
17. SSM parity: Mamba-2-130M at full width and depth in f32 through
    ``transformer.prefill`` (2 × 1024 tokens) on the kernel path and on
    the plain path (the scan's plain version on the card), logits and the
    SSM and conv caches, then 16 teacher-forced decode steps; then the
    continuous engine against the lockstep engine, request by request;
18. timed SSM serving: ``repro_torch.launch.serve`` (``main``) with the
    continuous engine, Mamba-2-130M bf16, 8 slots, 16 requests of 244–256
    prompt tokens and 64 new tokens: tokens per second, decode-step median
    and p90, prefill ms, peak memory, ssd_scan launches per prefill (24,
    one per layer); then profiles one warm prefill and 4 warm decode
    steps;
19. holds the flash forward and backward kernels against their plain
    versions at Llama-3.2-1B's training shape (b 4, 32 query heads over 8
    kv heads, s 1024, d 64, causal, window 8192; f32 and bf16) and times
    kernel, plain version and SDPA with ``enable_gqa`` (the bound counts
    the causal lower triangle);
20. LM parity: one f32 step of Llama-3.2-1B at full width and depth (b 2
    × s 512, ``lm_loss`` with no remat, then ``run_lm``'s AdaFactorW) on
    the kernel path and the plain path (chunked attention) from one set of
    weights and one batch: loss, every gradient leaf, the params after the
    update; 16 + 16 flash launches on the kernel path, none on the plain;
21. timed ``--mode lm`` through ``repro_torch.launch.train`` (``main``,
    Llama-3.2-1B f32, b 4 × s 1024, 4 steps, ``--ckpt-dir``): step median,
    tokens/s, peak memory, losses, launches per step; the checkpoint
    verifies and restores onto the card bit for bit (timed); one
    ``AsyncCheckpointManager.save_async`` of the same tree: its stall and
    its background write; then profiles one more warm step;
22. ``make_train_step`` (bf16, remat ``basic``) at the same shape, 3
    steps: step median, tokens/s, peak memory;
23. holds the SSD scan's backward kernel (``csrc/ssd_bwd.cu``, the
    forward kernel saving the state entering each 64-token sub-chunk)
    against the plain backward ``ssd_chunked_bwd`` (in 64-token chunks
    where they divide l) and against autograd through ``ssd_chunked``, f32
    and bf16, at Mamba-2-130M's shapes (b 2 × l 4096; b 1 × l 244 with an
    initial state and a final-state gradient), Jamba's (256 heads, b 1
    × l 4096) and a rank's under ``tp`` (phase 16's three): each gradient
    within 2e-5 of its max (dA, dD 1e-4, with
    the plain f32 version's distance from an fp64 evaluation printed
    beside), all finite, two runs bit for bit; prints each plan and times
    kernel (events, and device time over a profiler window that sees all
    four device kernels of a call) and plain version against the bound;
31. SSM training parity: one f32 step of Mamba-2-130M at full width and
    depth (b 2 × s 1024) on the kernel path (24 + 24 scan launches) and
    the plain path (none) by phase 9's limits; then one full-width Jamba
    Mamba-2 mixer layer (d 8192, 256 heads) forward and backward at b 1 ×
    l 4096: every leaf's gradient within 1e-3 of its max; both held, leaf
    by leaf, against a float64 plain path too (printed);
32. timed SSM training: ``--mode lm --arch mamba2-130m`` through the
    trainer's ``main`` (f32, b 2 × s 4096, 4 steps): step median,
    tokens/s, peak memory, 24 + 24 scan launches a step; a profile of one
    warm step (the scan's forward and backward share, busy share); then
    ``make_train_step`` (bf16, remat ``basic``) for 3 steps and a profile
    of one more;
24. holds the flash forward and the decode kernel against their plain
    versions at Mixtral-8x22B's shapes (48 query heads over 8 kv heads, d
    128, window 4096; f32 and bf16): flash over 512 tokens and over 4608,
    where the window masks; decode over 8 slots of the serving path's
    linear cache of 8192 and of a ring of 4096, ragged lengths and the
    serving state (~520-580 valid) and a full ring, the GQA group of 6 in
    the kernel's 8-head CTA group; times kernel, plain version and SDPA
    with ``enable_gqa`` (a bool window mask where the window is shorter
    than the sequence);
25. MoE parity: Mixtral-8x22B at full width, 2 layers, f32, capacity
    dispatch, prefill of 8 × 512 tokens and 8 decode steps over 8 slots on
    the kernel path and the plain path: logits within 1e-3, a row outside
    it only at a router near-tie on the plain path (gap under 1e-5 between
    the k-th and (k+1)-th probability) where the paths routed differently;
26. timed MoE serving: Mixtral-8x22B at full width, 4 of its 56 layers,
    bf16, the kernels, capacity dispatch, through the launcher's
    ``run_continuous`` (8 slots, 16 requests of 508-520 prompt tokens, 64
    new, cache 8192) and ``run_legacy`` (one request), the weights built
    once: tokens per second, step median and p90, prefill ms, peak memory,
    4 flash_fwd launches per prefill and 4 decode_attention launches per
    step; then profiles 4 warm decode steps (by kernel group, by aten op:
    expert GEMMs, casts, dispatch and combine; busy share);
33. holds the flash forward and backward against their plain versions at
    Mixtral's training shapes (b 1, 48 query heads over 8 kv, d 128,
    causal, window 4096; s 4096, and s 4608 where the window masks; f32
    and bf16), timed against SDPA with ``enable_gqa``, printing the
    backward's dq-partial bytes;
34. MoE training at full width: Mixtral-8x22B, 1 of its 56 layers (2.907G
    parameters): one f32 step (b 1 × s 1024, capacity dispatch) on the
    kernel path and the plain path by phase 9's limits, one path's
    gradients on the card at a time; then ``run_lm``'s f32 ``lm_step``
    (4 steps) and ``make_train_step`` bf16 (3 steps) at b 1 × s 4096:
    step median, tokens/s, peak memory, flash launches a step;
28. holds the three kernels of the hybrid serving path against their
    plain versions at Jamba-1.5-Large's shapes (f32 and bf16): the flash
    forward at 64 query heads over 8 kv heads, d 128, causal, over 256
    and 512 tokens; the decode kernel over 8 slots of a linear cache of
    1024, ragged lengths and the serving state (~270 valid), the GQA
    group of 8 in the kernel's 8-head CTA group; the SSD scan at 256 heads
    of 64, state 128 (b 1 × l 244 with an initial state and 256, b 8 × l
    512 without and with one); times kernel, plain version and SDPA with
    ``enable_gqa`` (none for the scan), printing each launch plan;
29. hybrid parity: Jamba-1.5-Large at full width, one period (8 layers:
    7 Mamba-2, 1 attention, MoE on the odd ones), experts 0-3 of each MoE
    layer's 16 (this card's share when four cards divide each MoE layer),
    f32, capacity dispatch: prefill of 8 × 512 tokens and 8 decode steps
    on the kernel path and the plain path (chunked attention, the scan's
    plain version, einsum decode): logits within 1e-3 (phase 25's
    near-tie rule), the SSM, conv and KV caches within 1e-3 of each
    leaf's max; then the continuous engine against the lockstep engine
    under dense dispatch;
30. timed hybrid serving on the same weights (built once, 64.6 GB fp32):
    bf16, the kernels, capacity dispatch over the share, through the
    launcher's ``run_continuous`` (8 slots, 16 requests of 244-256 prompt
    tokens, 64 new, cache 1024) and ``run_legacy`` (one request): tokens
    per second, step median and p90, prefill ms, peak memory, 1 flash_fwd
    and 7 ssd_scan launches per prefill and 1 decode_attention launch per
    step; then profiles 4 warm decode steps (by kernel group, by aten op,
    and the device time of the MoE FFNs' and the Mamba-2 decode's
    kernels; busy share);
35. hybrid training: one f32 step of the smoke Jamba on the kernel path
    (flash forward and backward, the scan's forward and backward, all
    launched) against the plain path, each also against a float64 plain
    path (printed), then ``--mode lm --smoke`` through the trainer's
    ``main``;
36. holds the cross-shard loss's chunk kernels against their plain
    versions at BASIC-S's width (D 512), B_local 1024 and 2048, f32 and
    bf16: ``chunk_row_col_lse`` (one ``fwd_fused`` launch) and
    ``chunk_grads`` (one ``bwd_fused`` launch) from global LSEs, ``b_norm``
    R·B_local for R 2 and 4, with and without the diagonal; times each
    against its plain version, the library call (logsumexp of one matmul;
    autograd of the materialised loss) and the bound;
37. the cross-shard loss (``allgather`` and ``chunked``) on 2 and 4 gloo
    ranks sharing the card, B_local 2048 (global 4096, 8192), f32 and
    bf16, against the single-device fused loss on the same global
    embeddings (loss, dX, dY, dlog_tau), every rank launching both
    contrastive kernels; not timed;
38. the distributed trainer (``repro_torch.launch.train_distributed``'s
    ``main``) at one rank: BASIC-S full width, bf16, B 2048 in 8
    microbatches, the chunked loss (the fused loss at one rank), flash
    attention, 4 steps; then 4 steps cut at 2 (checkpoints every 2) and
    resumed with ``--resume auto``, equal to the uninterrupted run within
    rtol 1e-4: step median, pairs/s, peak memory, the last checkpoint's
    stall and the runlog's data-wait / device-step / ckpt-stall split;
39. the trainer on 2 gloo ranks sharing the card (BASIC-S f32, global B
    256, 3 steps), each rank's losses against the one-rank step on the
    same global batch (rtol 1e-4); not timed;
40. ``train_lm`` through the trainer's ``main``: Llama-3.2-1B full width,
    f32, b 4 × s 1024, 3 steps, a checkpoint of params and optimizer state,
    1 resumed step, against 4 uninterrupted: step, tokens/s, peak memory;
41. the paper's §5.1 weight sharding on gloo ranks sharing the card
    (two spawned worlds, of 2 and 4 ranks): BASIC-S at full width on 1
    layer a tower, f32, global B 256, 1 step at (data 1, model 2) and
    (2, 2) under ``basic_ws`` and (1, 2) under ``replicated``: each rank's
    losses against the one-rank run on the same global batch (rtol 1e-4),
    its params' and optimizer state's bytes, the final checkpoint's whole
    leaves within 1e-3 of their move; not timed;
42. ``train_lm`` at (1, 2) under ``basic_ws`` in the world of 2:
    Llama-3.2-1B at full width on 1 of its 16 layers, f32, b 2 × s 1024,
    2 steps (the first at the warmup's lr 0);
43. Megatron execution (``--sharding tp``) in the same two worlds: BASIC-S
    on 1 layer a tower for 1 step at (1, 2) and (2, 2), and
    Llama-3.2-1B on 1 of 16 layers at (1, 2), with the same checks (each
    rank's params 1/M of the rule's split leaves plus the whole ones);
    every rank launches the flash kernels, and at (1, 2) the fused loss's
    pair; then, in the world of 2, the Mamba-2 mixer split by heads:
    Mamba-2-130M at full width on 2 of 24 layers (b 2 × s 1024, f32, 2
    steps) and the smoke Jamba (mixer, attention and expert-parallel MoE)
    under ``tp`` at (1, 2), each rank's losses within 1e-5 of one rank's,
    params' bytes, checkpoint leaves within 1e-3 of their move, and the
    SSD scan and its backward launched on every rank at H/M heads only (12
    for Mamba-2-130M), read from the shapes the wrapper saw;
44. right after phase 8's registry check, on its BASIC-S weights: the
    top-k kernel with ``n_valid`` against its plain version (f32 and bf16,
    b 64 × n 21841, k 5, n_valid 0, 3, 20841, 21841; one shard of the
    gallery below, b 64 × 250,000, k 10, n_valid 249,999): ids, values
    within 1e-4, sentinels exact; times kernel, plain version and
    ``torch.topk`` over the valid rows;
45. zero-shot retrieval at scale: a 999,999 × 512 fp32 gallery of 1000
    clusters made on the card, 64 text queries through the full-width
    text tower, k 10, through ``ZeroShotService`` in each mode (fused;
    sharded over [cuda:0] × 4; two-stage over 1000 blocks at nprobe "all"
    and 8): sharded and two-stage "all" equal fused bit for bit, p50 / p90
    of 20 calls per mode, the kernel's launches per call, recall@10, prune
    ratio and stage seconds at nprobe 8, the index build, one upload per
    gallery;
46. the live endpoint of phase 45's fused service (10 s SLO): /metrics
    with the serve/slo_* and serve/retrieval_* series, /healthz 200 and
    /snapshot.json mid-run; a service whose target is half the fused p50
    turns /healthz to 503; phase 15's continuous server runs with a 60 s
    request SLO and reports its decode/slo_* series;
47. after phase 38: ``train_distributed.main --health --metrics-port 0``
    at one rank, BASIC-S full width f32, B 256, 3 steps, a NaN image
    batch at step 1 (``set_step_fault_hook``): exactly that step skipped,
    params and optimizer state unchanged through it, the nonfinite
    detector critical, a flight dump, /healthz 200 mid-run;
48. after phase 35: both flash kernels at head dim 80, HuBERT-XLarge's
    training shape (b 2, 16 heads = kv, s 4096, bidirectional), f32 and
    bf16, against their plain versions, timed against SDPA; then a causal
    case with a window of 70 and one with GQA 4 at s 520, forward and
    backward, untimed;
49. Arctic-480B's GQA 7 (56 query heads over 8 kv, d 128) in the flash
    forward and backward (b 1 × s 1024 and the training shape b 1 × s
    4096, causal; timed against SDPA with ``enable_gqa``) and in
    ``decode_attention`` (8 slots, a linear cache of 4096, ragged lengths,
    then timed at the serving state), f32 and bf16, each against its
    plain version;
50. HuBERT-XLarge at full width and depth (48 layers, d 1280, 16 heads of
    80): one f32 masked-frame step (``lm_loss`` and AdaFactorW) on the
    kernel path against the plain path (chunked attention) from one set
    of weights and one batch (b 2 × s 1024): loss, every gradient leaf,
    the updated params, 48 + 48 flash launches on the kernel path and
    none on the plain path; then ``train.main(["--mode", "lm", "--arch",
    "hubert-xlarge", ...])`` at b 2 × s 4096 f32, 4 steps: step median,
    frames/s, peak memory, 48 + 48 launches a step;
51. InternVL2-76B at full width on 1 of its 80 layers (a depth cut;
    11.8 GB f32; 2 layers ran out of memory in the f32 update), 256×256
    images and text: the f32 parity step at b 1 × s 512, then ``run_lm``'s
    f32 ``lm_step``, 3 steps at b 1 × s 4096 (256 patches, 3840 tokens):
    step median, tokens/s, peak memory, 1 + 1 flash launches a step;
52. InternVL2-76B at full width on 8 of its 80 layers (a depth cut; 35.8
    GB f32) served on token prompts: f32 decode parity of the kernel path
    against the plain path (4 × 512, a linear cache of 1024, 8 steps),
    then bf16 through ``serve.run_continuous`` (8 slots, 16 requests of
    508–520 tokens, 64 new) and ``run_legacy``: tok/s, step median and
    p90, prefill ms, peak memory, one flash_fwd launch a layer a prefill
    and one decode_attention launch a layer a step;
53. after phase 52: Arctic-480B (56 query heads over 8 kv heads, GQA 7,
    d 128, 128 experts top-2 beside a dense residual FFN) at full width on
    2 of its 35 layers with experts 0-15 of each layer's 128 (one card's
    share when eight cards split them), f32, capacity dispatch: prefill
    of 8 × 512 tokens into a linear cache of 4096 and 8 decode steps on
    the kernel path and the plain path: logits within 1e-3 (phase 25's
    near-tie rule), the caches within 1e-3 of each leaf's max; phase 25
    checks the caches so too;
54. timed Arctic serving on 4 of its 35 layers with the same share (8.0G
    params, ~32 GB f32): bf16, the kernels, capacity dispatch over the
    share, ``run_continuous`` (8 slots, 16 requests of 508-520 prompt
    tokens, 64 new, a linear cache of 4096) and ``run_legacy``: tokens per
    second, step median and p90, prefill ms, peak memory, 4 flash_fwd
    launches a prefill and 4 decode_attention launches a step at GQA 7;
    then a 4-step decode profile;
55. last, the tooling (``launch/{roofline,memstats,dryrun}.py``):
    (a) ``train_distributed --memstats`` at one rank, phase 38's run for
    1 step: the printed row's peak equals ``max_memory_allocated``; (b)
    the dry runs (traced on ``meta`` in a process that runs beside the
    untimed gloo worlds of phases 41-43, after every timed phase)
    of phase 38's contrastive step at mesh (1, 1) and of Llama-3.2-1B's
    ``make_train_step`` (bf16, remat ``basic``, the flash kernels) at b 4
    × s 1024, each held to the same step function run once on the card
    under ``memstats.step_stats``: FLOPs equal, the predicted peak within
    15% of the card's, printed beside the roofline's terms and the
    measured step time; (c) BASIC-L's contrastive step at
    ``contrastive_64k`` on the pod mesh (16, 16), meta only: params,
    optimizer state and peak a rank, and the roofline's bottleneck;
56. in the world of 2 of phases 41-43, the sharded serving steps
    (``steps.make_prefill_step`` / ``make_serve_step`` on a rank's parts)
    at (1, 2): Llama-3.2-1B on 2 of 16 layers at full width under ``tp``
    and ``basic_ws``, Mamba-2-130M on 2 of 24 and smoke Jamba under
    ``tp``, f32, b 4 × 512 prompts into a linear cache of 1024, greedy
    steps, each held to the one-rank steps on the plain path (1e-4 of the
    largest |logit|, no greedy flip past the error, both ranks' tokens
    alike) and every rank's kernels launched at its local heads; the
    kernels at a rank's shapes there against their plain versions, timed;
57. in the same world, a KV cache's sequence split over the ranks
    (context-parallel decode, ``steps.cache_seq_axis``), f32, b 1:
    Llama-3.2-1B on 2 of 16 layers at full width at (2, 1) on its ring of
    8192 after an 8704-token prompt and on a linear cache of 16384 after
    1000 tokens (rank 1 sweeps no valid key), smoke Jamba under
    ``basic_ws`` at (1, 2) on 256 slots, each held to the one-rank steps
    on the plain path as phase 56's, every rank holding half the KV bytes
    and launching the decode kernel at its slice's length; before the
    untimed worlds, the decode kernel's lse output at the slices' shapes
    (Llama's, and Jamba-1.5-Large's rank shape at (1, 4): t 131072, 4160
    and 0 valid keys) against its plain version, timed beside its plain
    version, SDPA over the valid keys and the bound;
58. after phase 54: Arctic-480B trained at full width on 1 of its 35
    layers with experts 0-15 of each layer's 128 (phases 53-54's share;
    ~2.36G params, 9.4 GB f32), drawn once: one f32 step (``lm_loss`` and
    AdaFactorW) on the kernel path against the plain path (chunked
    attention) by phase 9's limits at b 1 × s 1024 under capacity
    dispatch and at b 1 × s 512 under dense dispatch (a factored leaf's
    elements past the update limit allowed up to 2·lr where its gradient's
    row or column RMS is near zero, one in a million at most); then
    ``make_train_step`` bf16 with remat ``basic``, 3 steps at b 1 × s
    4096: step median, tokens/s, peak memory, 2 flash_fwd and 1 flash_bwd
    launch a step, every flash_bwd at 56 query rows over 8 kv rows, d 128;
27. last, after phase 43, prints the script's seconds, a ``{"kernels":
    [...]}`` line and the ``{"ok": true, "device": {...}}`` line.

Any failure raises; no phase is caught.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# checkpoints the phases write, inside the checkout (git ignores build/);
# each phase removes its own
CKPT_ROOT = os.path.join(HERE, "build", "chip_smoke_ckpt")

FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:97"
TOPK_SOURCE = "src/repro_torch/kernels/similarity_topk/csrc/topk.cu"
TOPK_REPLACES = "src/repro/kernels/similarity_topk/kernel.py:85"
FLASH_BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu"
FLASH_BWD_REPLACES = "src/repro/kernels/flash_attention/kernel.py:230"
CL_SOURCE = "src/repro_torch/kernels/contrastive_loss/csrc/contrastive.cu"
CL_FWD_REPLACES = "src/repro/kernels/contrastive_loss/kernel.py:107"
CL_BWD_REPLACES = "src/repro/kernels/contrastive_loss/kernel.py:185"
CL_LSE_REPLACES = "src/repro/kernels/contrastive_loss/kernel.py:295"
CL_GRADS_REPLACES = "src/repro/kernels/contrastive_loss/kernel.py:337"
DEC_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/decode.cu"
DEC_REPLACES = "src/repro/kernels/decode_attention/kernel.py:72"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:69"

# the H100 SXM's published peaks (HBM bytes/s; operation rates by input
# type, fp32 outside the tensor cores, split 3×TF32 for fp32-accurate
# tensor-core work), ``bound`` and the kernels' least work live in one
# place, the port's roofline module
from repro_torch.launch.roofline import (  # noqa: E402
    PEAK_3XTF32, PEAK_FLOPS, bound, contrastive_bwd_work,
    contrastive_fwd_work, decode_work, flash_bwd_work, flash_fwd_work,
    ssd_bwd_work, ssd_scan_work, topk_work)
from repro_torch.launch.roofline import \
    tensor_core_peak as flash_peak  # noqa: E402

# tolerances, each with its reason:
# flash f32 — both sides accumulate fp32 over <= 196 keys in another order,
# and the kernel's products are split 3×TF32 (about 2^-21 of each product,
# a few 1e-6 on a score at d 64; tests/test_torch_tf32_split.py)
FLASH_TOL = {"float32": 5e-5,
             # bf16 — the same fp32 result rounds to bf16 on both sides: a
             # crossing of a rounding boundary moves |out| < 2 by one ulp
             # (2^-7); lse stays fp32 (FLASH_TOL["float32"])
             "bfloat16": 1.6e-2}
# top-k logits: fp32 dot products of unit vectors (d = 512, summed in
# another order) times inv_tau = 1/0.07
TOPK_TOL = 1e-4
# main path against the plain path: embeddings through 8 (6) layers with
# the flash kernel vs materialised softmax, then logits times 1/0.07
E2E_LOGIT_TOL = 1e-3
E2E_CLASS_TOL = 1e-4
# flash backward f32: 2e-4 abs, the reference's own gradient tolerance
# (tests/test_attention_backends.py); fp32 sums in another order, products
# split 3×TF32 as in the forward
FLASH_BWD_TOL = 2e-4
# flash backward bf16, per element: 2 bf16 ulps of |ref| (2^-7 relative
# each) plus 1e-3 of the tensor's max |ref|. Both sides accumulate in fp32
# and round the same value to bf16, so an element differs by at most the
# ulp of a rounding-boundary crossing; the 1e-3·max term covers elements
# near zero, where fp32 sums in another order cancel. At N(0, 1) inputs
# |dq|, |dk|, |dv| are ~0.1 rms, so the reference's 1e-1 abs (kept in the
# CPU tests against JAX) would pass a dropped delta or a lost d^-1/2.
# Plus 1e-5 abs for gradients that are zero by cancellation (one key:
# ds = dout·v − delta = 0), where both sides keep fp32 rounding residue
# (~1e-7) in another order
FLASH_BWD_BF16_ULPS = 2
FLASH_BWD_BF16_REL_MAX = 1e-3
FLASH_BWD_BF16_ABS = 1e-5
BF16_ULP = 2.0 ** -7
# contrastive kernels: LSE 5e-5 (fp32 sums of B exponentials of values up
# to ~15 in another order); dX/dY 1e-6 and dlog_tau 1e-4 relative, the
# reference's f32 tolerances (tests/test_kernels.py). bf16 gradients:
# 2^-6 of the tensor's max |ref| (|dX| ~ 3e-4 at unit rows, so an absolute
# 2e-2 would pass any fault); dA rounds to bf16 on both sides, and a
# rounding-boundary crossing moves one term of a row's sum by one ulp
CL_LSE_TOL = 5e-5
CL_GRAD_TOL_F32 = 1e-6
CL_GRAD_REL_MAX_BF16 = 2.0 ** -6
CL_DTAU_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# training parity, kernel path vs plain path in f32:
# loss — embeddings through 8 (6) layers of flash vs materialised softmax
# differ by ~1e-6, the loss is ~log B
TRAIN_LOSS_TOL = 1e-4
# gradients — largest over leaves of max|g_kernel - g_plain| / max|g_plain|:
# fp32 sums in another order through the backward of every layer
TRAIN_GRAD_RTOL = 1e-3
# parameters after AdaFactorW — factored leaves within 2% of the lr: a
# gradient error of TRAIN_GRAD_RTOL moves an update by about that share of
# lr. An unfactored leaf's update is ~±lr per element whatever the
# gradient's size, so an element may differ by up to 2·lr only where its
# gradient is zero to within TRAIN_GRAD_RTOL of its leaf's largest
TRAIN_UPDATE_TOL_LR = 0.02
# A factored leaf's update divides each element by its row's and column's
# gradient RMS. Under an expert share (phase 58) an expert that few tokens
# reach has rows and columns whose RMS is ~1e-6 of the leaf's largest, and
# there the paths' rounding (the f32 flash kernels' split 3xTF32 against
# fp32 FMA) moves an update by a few hundredths of lr. Phase 58 lets such
# elements differ by up to 2·lr, at most this share of a leaf's elements
TRAIN_AMPLIFIED_SHARE = 1e-6
# §4.2 first moment: the K-step sum (1-β1)/K·c_i against (1-β1)·mean_K(c),
# the same sum in fp32 in another grouping, a few ulps of each leaf's max
MOMENT_M_RTOL = 1e-6
# decode kernel f32: 2e-5 abs, the reference's (tests/test_decode_kernel.py);
# fp32 sums over the keys in another order
DEC_TOL_F32 = 2e-5
# decode kernel bf16, per element: 2 bf16 ulps of |ref| plus 1e-3 of the
# tensor's max |ref| (the rule of the flash_bwd check above: both sides
# round the same fp32 value to bf16); the reference's 5e-2 abs is as large
# as the outputs
DEC_BF16_ULPS = 2
DEC_BF16_REL_MAX = 1e-3
# decode parity, kernel path vs plain path in f32, on logits of ~unit
# scale: 16 layers of flash vs materialised prefill attention and kernel vs
# einsum decode, fp32 sums in another order over up to 8192 keys, move a
# logit by ~1e-5; 1e-3 leaves two orders of margin and still catches a
# wrong mask, position or cache slot (those move logits by ~1e-1)
DEC_PARITY_TOL = 1e-3
# SSD scan kernel, f32 and bf16 inputs alike (both sides read the same
# values and accumulate in fp32): 2e-5 of max |y| and of max |state|, the
# reference's own kernel-vs-ssd_chunked tolerance (tests/test_kernels.py);
# fp32 sums in another order and in 64-token sub-chunks, not 256
SSD_TOL_REL = 2e-5
# SSM parity, kernel path vs plain path in f32: logits of ~unit scale
# through 24 layers that differ only in the scan's summation order (~1e-5);
# 1e-3 still catches a wrong state, chunk or D (those move logits by
# ~1e-1). The caches: 1e-3 of each leaf's max |value|
SSM_PARITY_TOL = 1e-3


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches after
    ``warmup``, between CUDA events."""
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
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def profile_window(cpu: bool = True, settle: float = 0.0):
    """A torch.profiler window whose tracing starts one step early, on a
    small device op (the profiler's warm-up step), so that nothing the
    window measures falls in the tracer's start-up, which can miss the
    first records; yields the profiler, whose events are those of the
    measured step alone. Each step ends ``settle`` seconds after the
    device is idle (``scripts/profile_window_probe.py`` measures whether
    such a pause keeps a window's records: it does not)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities, acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(settle)
        prof.step()
        yield prof
        torch.cuda.synchronize()
        time.sleep(settle)
        prof.step()


def retaken_window(fn, complete, cpu: bool = True, tries: int = 8):
    """(profiler, ``fn()``'s result) of the first of up to ``tries``
    ``profile_window``s over one call of ``fn`` that ``complete(prof,
    result)`` accepts: the tracer now and then loses some or all of a
    window's device records, at times in several windows in a row. The
    last window is returned whatever it holds, and its caller fails on
    what is missing there."""
    for attempt in range(tries):
        with profile_window(cpu) as prof:
            out = fn()
        if complete(prof, out):
            break
        if attempt + 1 < tries:
            print("profile: the tracer lost device records of the window; "
                  "it is taken again", flush=True)
    return prof, out


def counted_window(fn, counters, cpu: bool = True):
    """(profiler, host microseconds of one ``fn()``, wrapper -> its
    launches in that call) of the first ``retaken_window`` over one
    ``fn()`` in which the profiler saw at least one device kernel per
    launch of each wrapper in ``counters``: the tracer now and then drops
    one record of a window (once, one of a training step's 336 flash_fwd
    kernels). The last window is returned whatever it holds, and
    ``device_breakdown`` fails on what it misses."""
    import torch

    def run():
        before = {c.name: c.count for c in counters}
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        return wall_us, {c.name: c.count - before[c.name] for c in counters}

    def complete(prof, out):
        seen = wrapper_kernels_seen(prof, out[1])
        return all(seen[w] >= n for w, n in out[1].items())

    prof, (wall_us, calls) = retaken_window(run, complete, cpu)
    return prof, wall_us, calls


def on_device(e) -> bool:
    """Whether a profiler event lies on the device's timeline."""
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def device_events(prof):
    """The device-side events of a ``profile_window``: its kernels and
    copies, without the step annotation (``ProfilerStep#n``) and the
    ``spans`` labels, which cover ranges of the device's timeline."""
    return [e for e in prof.events()
            if on_device(e) and not e.name.startswith("ProfilerStep")
            and not getattr(e, "is_user_annotation", False)]


def span_device_ms(prof, labels, units):
    """(label -> device milliseconds per unit of the kernels inside the
    label's ``spans`` ranges on the device's timeline, or None where the
    profiler recorded no such range)."""
    kernels = [e.time_range for e in device_events(prof)]
    out = {}
    for label in labels:
        ranges = [e.time_range for e in prof.events()
                  if on_device(e) and e.name == label]
        out[label] = (sum(k.elapsed_us() for k in kernels if any(
            r.start <= k.start and k.end <= r.end for r in ranges))
            / 1e3 / units if ranges else None)
    return out


def device_ms(fn, names=None, iters: int = 20, expect=None):
    """(device milliseconds per call of ``fn``, device kernels per call):
    a torch.profiler window over ``iters`` calls after one warm call, over
    the device kernels whose names hold one of ``names`` (every device
    kernel and copy when ``names`` is None). Per kernel name, its mean
    duration times its launches per call, rounded: the profiler now and
    then drops one event of a window, which would otherwise read as a
    call without that kernel. A window with no record at all, or, given
    ``expect``, one that does not show ``expect`` device kernels a call
    (the tracer lost every record of one of them), is retaken
    (``retaken_window``) over twice the calls, up to 8 × ``iters`` (the
    probe never saw a window of 0.5 s lose all its records); if the last
    window still falls short, it raises."""
    import torch
    fn()
    torch.cuda.synchronize()
    windows = (iters * min(8, 2 ** k) for k in itertools.count())

    def calls():
        n = next(windows)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return n

    def timed(prof):
        by_name = {}
        for e in device_events(prof):
            if names is None or any(n in e.name for n in names):
                us, count = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
        return by_name

    def kernels_per_call(by_name, n_calls):
        return sum(max(1, round(count / n_calls))
                   for _, count in by_name.values())

    prof, n_calls = retaken_window(
        calls, lambda prof, n: bool(timed(prof)) and (
            expect is None or kernels_per_call(timed(prof), n) == expect),
        cpu=False)
    by_name = timed(prof)
    if not by_name:
        raise AssertionError("device_ms: the profiler saw no device time")
    ms = per_call = 0
    for us, count in by_name.values():
        n = max(1, round(count / n_calls))
        ms += us / count * n / 1e3
        per_call += n
    if expect is not None and per_call != expect:
        raise AssertionError(f"device_ms: {per_call} device kernels a call "
                             f"seen ({sorted(by_name)}), want {expect}")
    return ms, per_call


def dtype_name(dt) -> str:
    """'float32' / 'bfloat16'."""
    return str(dt).removeprefix("torch.")


# ---------------------------------------------------------------------------
# phase 3: flash-attention forward
# ---------------------------------------------------------------------------


def sdpa_call(q, k, v, bias, b, h, kv, causal, window, grad=False):
    """The library's attention on the flash kernels' inputs: (a callable
    of ``scaled_dot_product_attention`` over (b, heads, s, d) views,
    grouped-query through ``enable_gqa``; those q, k, v views, which
    require grad when ``grad`` is set)."""
    import torch
    import torch.nn.functional as F
    s, d = q.shape[1], q.shape[2]
    q4 = q.view(b, h, s, d)
    k4, v4 = (x.view(b, kv, s, d) for x in (k, v))
    if grad:
        q4, k4, v4 = (x.detach().requires_grad_() for x in (q4, k4, v4))
    mask4 = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    if causal and window is not None and window < s:
        # SDPA has no sliding window: the causal window as a bool mask
        if bias is not None:
            raise ValueError("a window shorter than the sequence and a "
                             "padding bias together are not timed")
        i = torch.arange(s, device=q.device)
        mask4 = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                               < window)
        causal = False

    def call():
        return F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, is_causal=causal,
            enable_gqa=kv != h)
    return call, (q4, k4, v4)


def flash_case(label, b, h, s, d, dtype, padded, seed, kv=None,
               causal=False, window=None, timed=True):
    """Kernel vs plain version at one shape (``kv`` kv heads, default
    ``h``; ``causal`` with ``window``); returns the case's record (times
    when ``timed``)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                         flash_fwd_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bh, kv = b * h, h if kv is None else kv
    q = torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b * kv, s, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    mask = dict(causal=causal, window=window)
    bias = None
    if padded:   # text-style key padding: 1..s valid keys per example
        lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
        keep = torch.arange(s, device=dev)[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, NEG_INF).float()
    out, lse = fa_ops.flash_fwd(q, k, v, bias, **mask)
    ref_out, ref_lse = flash_fwd_ref(q, k, v, bias, **mask)
    torch.cuda.synchronize()
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    dt = dtype_name(dtype)
    tol = FLASH_TOL[dt]
    if not (err_out <= tol and err_lse <= FLASH_TOL["float32"]):
        raise AssertionError(f"flash_fwd {label} {dt}: max |out err| "
                             f"{err_out:.3g} (tol {tol}), max |lse err| "
                             f"{err_lse:.3g}")
    plan = fa_ops.fwd_plan(bh, s, s, d, dtype)
    unrounded = None
    if dtype == torch.bfloat16:
        # not gated: the distance from the fp32 forward of the same bf16
        # values with p left unrounded
        f32_out, _ = flash_fwd_ref(q.float(), k.float(), v.float(), bias,
                                   **mask)
        unrounded = (out.float() - f32_out).abs().max().item()
    if not timed:
        print(f"flash_fwd {label} bh={bh} s={s} d={d} {dt} kv={b * kv} "
              f"{mask}: plan {tuple(plan)}; err out {err_out:.3g} lse "
              f"{err_lse:.3g} (tol {tol})", flush=True)
        return {"max_abs_err": max(err_out, err_lse), "plan": tuple(plan)}

    def call():
        fa_ops.flash_fwd(q, k, v, bias, **mask)
    ms = time_ms(call)
    dev_ms, _ = device_ms(call, WRAPPER_KERNELS["flash_fwd"])
    plain_ms = time_ms(lambda: flash_fwd_ref(q, k, v, bias, **mask),
                       iters=5 if s > 512 else 20)
    sdpa, _ = sdpa_call(q, k, v, bias, b, h, kv, causal, window)
    lib_ms = time_ms(sdpa)
    lib_dev_ms, _ = device_ms(sdpa)
    item = torch.finfo(dtype).bits // 8
    nbytes, flops = flash_fwd_work(bh, b * kv, s, s, d, item, causal=causal,
                                   window=window,
                                   bias_rows=b if padded else 0)
    bound_ms, bound_by = bound(nbytes, flops, dt, flash_peak(dt))
    rec = {"shape": f"{label} bh={bh} s={s} d={d} {dt}"
                    + (f" kv={b * kv}" if kv != h else "")
                    + (" padded" if padded else "")
                    + (" causal" if causal else "")
                    + (f" window={window}" if window else ""),
           "max_abs_err": max(err_out, err_lse), "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_device_ms": lib_dev_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "plan": tuple(plan), "unrounded_err": unrounded}
    print(f"flash_fwd {rec['shape']}: plan {tuple(plan)}; err out "
          f"{err_out:.3g} lse {err_lse:.3g} (tol {tol}; lse "
          f"{FLASH_TOL['float32']})"
          + ("" if unrounded is None else
             f", distance from the unrounded fp32 forward (not gated) "
             f"{unrounded:.3g}")
          + f"; kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return rec


def phase_flash():
    """Flash kernels at the towers' serving shapes, f32 and bf16, and at
    one training microbatch in bf16."""
    import torch
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        # image tower: 16 images x 12 heads, 196 patches, no bias
        recs[("image", dtype)] = flash_case("image", 16, 12, 196, 64, dtype,
                                            False, 1)
        # text tower: 64 prompts x 16 heads, 16 tokens, padding bias
        recs[("text", dtype)] = flash_case("text", 64, 16, 16, 64, dtype,
                                           True, 2)
    # one microbatch of the timed training run (M = 256), bf16
    recs[("image-train", torch.bfloat16)] = flash_case(
        "image-train", 256, 12, 196, 64, torch.bfloat16, False, 5)
    recs[("text-train", torch.bfloat16)] = flash_case(
        "text-train", 256, 16, 16, 64, torch.bfloat16, True, 6)
    # head dim 128 and a causal / windowed mask, checked once each
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    g = torch.Generator(device="cuda").manual_seed(3)
    for d, causal, window in ((128, False, None), (64, True, None),
                              (64, True, 48)):
        q, k, v = (torch.randn((24, 200, d), generator=g, device="cuda")
                   for _ in range(3))
        out, lse = fa_ops.flash_fwd(q, k, v, causal=causal, window=window)
        ref_out, ref_lse = flash_fwd_ref(q, k, v, causal=causal,
                                         window=window)
        err = max((out - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        if not err <= FLASH_TOL["float32"]:
            raise AssertionError(f"flash_fwd d={d} causal={causal} "
                                 f"window={window}: max err {err:.3g}")
        print(f"flash_fwd d={d} causal={causal} window={window}: err "
              f"{err:.3g}", flush=True)
    return recs


# ---------------------------------------------------------------------------
# phase 4: similarity -> top-k
# ---------------------------------------------------------------------------


def check_topk(label, vals, idx, ref_v, ref_i, k, tol):
    """Values within ``tol`` of the plain version's, descending, and the
    indices equal wherever the plain version's neighbouring values differ
    by more than ``tol``. Returns the max abs value error."""
    import torch
    err = (vals - ref_v[:, :k]).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{label}: max |value err| {err:.3g} > {tol}")
    if bool((vals[:, 1:] > vals[:, :-1]).any()):
        raise AssertionError(f"{label}: values not descending")
    m = ref_v.shape[1]
    gap = torch.full_like(ref_v, float("inf"))
    gap[:, 1:] = ref_v[:, :-1] - ref_v[:, 1:]
    sep = gap[:, :k] > tol                       # apart from the one above
    below = torch.full_like(gap[:, :k], float("inf"))
    below[:, :min(k, m - 1)] = gap[:, 1:min(k, m - 1) + 1]
    sep &= below > tol                           # and from the one below
    bad = sep & (idx != ref_i[:, :k])
    if bool(bad.any()):
        r, c = (int(x) for x in bad.nonzero()[0])
        raise AssertionError(f"{label}: index mismatch at row {r} slot {c}:"
                             f" kernel {int(idx[r, c])} vs plain "
                             f"{int(ref_i[r, c])}")
    return err


def unit_rows(n, d, g, dtype):
    """(n, d) random unit rows in ``dtype``."""
    import torch
    x = torch.randn((n, d), generator=g, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def phase_topk():
    """Top-k kernels over b x n x k x dtype, planted ties, and the timing
    at the main path's shape."""
    import torch
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref
    inv_tau = 1.0 / 0.07
    d = 512
    g = torch.Generator(device="cuda").manual_seed(4)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (16, 64):
            for n in (512, 21841):
                x, c = unit_rows(b, d, g, dtype), unit_rows(n, d, g, dtype)
                ref_v, ref_i = similarity_topk_ref(x, c, 65, inv_tau)
                for k in (1, 5, 64):
                    vals, idx = topk_ops.similarity_topk(x, c, k,
                                                         inv_tau=inv_tau)
                    e = check_topk(f"topk b={b} n={n} k={k} "
                                   f"{dtype_name(dtype)}", vals, idx,
                                   ref_v, ref_i, k, TOPK_TOL)
                    errs[dtype_name(dtype)] = max(errs[dtype_name(dtype)], e)
        print(f"similarity_topk {dtype_name(dtype)}: b in (16, 64) x n in "
              f"(512, 21841) x k in (1, 5, 64) match; max |value err| "
              f"{errs[dtype_name(dtype)]:.3g} (tol {TOPK_TOL})", flush=True)

    # planted exact ties: duplicated class rows across chunks; the lower
    # class id must come first
    dup = [7, 4000, 13000, 21840]
    for b in (16, 64):
        x = unit_rows(b, d, g, torch.float32)
        c = unit_rows(21841, d, g, torch.float32)
        c[dup] = c[dup[0]].clone()
        x[0] = c[dup[0]]
        for k in (5, 64):
            vals, idx = topk_ops.similarity_topk(x, c, k, inv_tau=inv_tau)
            ref_v, ref_i = similarity_topk_ref(x, c, k + 1, inv_tau)
            check_topk(f"topk ties b={b} k={k}", vals, idx, ref_v, ref_i, k,
                       TOPK_TOL)
            if idx[0, :4].tolist() != dup or len(set(
                    vals[0, :4].tolist())) != 1:
                raise AssertionError(f"tie rule broken: ids "
                                     f"{idx[0, :4].tolist()} vals "
                                     f"{vals[0, :4].tolist()}")
    print(f"similarity_topk planted ties {dup}: lower id first", flush=True)

    recs = {}
    block_ms = {}
    for b, n in ((16, 512), (16, 21841)):
        x = unit_rows(b, d, g, torch.float32)
        c = unit_rows(n, d, g, torch.float32)
        ref_v, ref_i = similarity_topk_ref(x, c, 6, inv_tau)
        for rows in topk_ops.BLOCK_ROWS:
            vals, idx = topk_ops.similarity_topk(x, c, 5, inv_tau=inv_tau,
                                                 block_rows=rows)
            check_topk(f"topk b={b} n={n} block_rows={rows}", vals, idx,
                       ref_v, ref_i, 5, TOPK_TOL)
        ms = {rows: [] for rows in topk_ops.BLOCK_ROWS}
        for _ in range(3):              # in turns: 16, 64, 16, 64, ...
            for rows in topk_ops.BLOCK_ROWS:
                ms[rows].append(time_ms(lambda: topk_ops.similarity_topk(
                    x, c, 5, inv_tau=inv_tau, block_rows=rows)))
        block_ms[f"b={b} n={n}"] = {str(r): min(t) for r, t in ms.items()}
        print(f"similarity_topk b={b} n={n} k=5 f32 by image rows per CTA "
              f"(default {topk_ops.row_block(b)}): " + ", ".join(
                  f"{r}: {t:.4f} ms"
                  for r, t in block_ms[f"b={b} n={n}"].items()), flush=True)
    recs["block_rows_ms"] = block_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, n, k in ((16, 512, 5), (64, 21841, 5)):
        x = unit_rows(b, d, g, torch.float32)
        c = unit_rows(n, d, g, torch.float32)
        plan = topk_ops.topk_plan(b, n, d, k, 4, sms)
        call = lambda: topk_ops.similarity_topk(x, c, k, inv_tau=inv_tau)
        library = lambda: torch.topk(x @ c.T * inv_tau, k, dim=1)
        ms = time_ms(call)
        dev_ms, per_call = device_ms(call, WRAPPER_KERNELS["similarity_topk"])
        if per_call != 1:
            raise AssertionError(f"similarity_topk b={b} n={n}: {per_call} "
                                 f"device kernels per call, want 1")
        plain_ms = time_ms(lambda: similarity_topk_ref(x, c, k, inv_tau))
        lib_ms = time_ms(library)
        lib_dev_ms, _ = device_ms(library)
        bound_ms, bound_by = bound(*topk_work(b, n, d, k), "float32")
        recs[(b, n, k)] = {
            "shape": f"b={b} n={n} d={d} k={k} float32",
            "plan": plan._asdict(), "max_abs_err": errs["float32"],
            "ms": ms, "device_ms": dev_ms, "device_kernels_per_call":
            per_call, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
        print(f"similarity_topk b={b} n={n} k={k}: plan {plan._asdict()}; "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms, {per_call:g} "
              f"device kernel per call), plain {plain_ms:.4f} ms, "
              f"matmul+topk {lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms), "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return recs, errs


# ---------------------------------------------------------------------------
# phase 8: the main path
# ---------------------------------------------------------------------------


def phase_main_path():
    """BASIC-S zero-shot classify on the card; returns (launches, cfg,
    params, tok)."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.data import load_tokenizer
    from repro_torch.eval.zero_shot import class_embeddings
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref
    from repro_torch.launch import serve_zeroshot
    from repro_torch.models import dual_encoder as de

    t0 = time.perf_counter()
    cfg, params = serve_zeroshot.build("basic-s", seed=0, device="cuda")
    tok = load_tokenizer()
    n_params = sum(p.numel() for _, p in interop.leaves(params))
    print(f"main path: basic-s, {n_params / 1e6:.1f}M params, init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    counters = (fa_ops.COUNTER, topk_ops.COUNTER)
    for ctr in counters:
        ctr.reset()
    rep = serve_zeroshot.run(cfg, params, tok, classes=512, batch=16,
                             requests=8, k=5, seed=0, device="cuda")
    launches = {ctr.name: ctr.count for ctr in counters}

    print(f"main path: class matrix (512 classes x 4 templates = 2048 "
          f"prompts) {rep['class_matrix_s']:.3f}s, first classify "
          f"{rep['first_classify_s']:.3f}s", flush=True)
    print(f"main path: warm p50 {rep['p50_s'] * 1e3:.3f} ms, max "
          f"{rep['max_s'] * 1e3:.3f} ms, {rep['img_per_s']:.1f} img/s, top1 "
          f"{rep['top1']:.4f} vs chance {rep['chance']:.4f} (random "
          f"weights), max_memory_allocated "
          f"{rep['max_memory_allocated'] / 2**30:.3f} GiB", flush=True)
    print(f"main path launches: {launches}", flush=True)
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")

    # the answers: finite, well-formed, and equal to the plain path's
    res = rep["last_result"]
    if res.values.shape != (16, 5) or not np.isfinite(res.values).all():
        raise AssertionError(f"bad classify values {res.values}")
    if (res.indices < 0).any() or (res.indices >= 512).any():
        raise AssertionError(f"bad class ids {res.indices}")
    plain = dataclasses.replace(
        cfg, image_tower=dataclasses.replace(cfg.image_tower,
                                             attn_impl="naive"),
        text_tower=dataclasses.replace(cfg.text_tower, attn_impl="naive"))
    dev = torch.device("cuda")
    with torch.inference_mode():
        cm_plain = class_embeddings(
            lambda p: de.encode_text(plain, params, {
                k: torch.from_numpy(v).to(dev) for k, v in p.items()}),
            tok, res.class_names)
        cm_err = (cm_plain.cpu() - torch.from_numpy(rep["class_matrix"])
                  ).abs().max().item()
        iemb = de.encode_image(plain, params, {"image": torch.from_numpy(
            rep["last_images"]).to(dev)})
        inv_tau = float(torch.exp(-params["log_tau"]))
        ref_v, ref_i = similarity_topk_ref(
            iemb, torch.from_numpy(rep["class_matrix"]).to(dev), 6, inv_tau)
    if not cm_err <= E2E_CLASS_TOL:
        raise AssertionError(f"class matrix vs plain path: max err "
                             f"{cm_err:.3g}")
    logit_err = check_topk("main path vs plain path",
                           torch.from_numpy(res.values).to(dev),
                           torch.from_numpy(res.indices).to(dev),
                           ref_v, ref_i, 5, E2E_LOGIT_TOL)
    print(f"main path vs plain PyTorch path on the card: class matrix max "
          f"err {cm_err:.3g} (tol {E2E_CLASS_TOL}), logits max err "
          f"{logit_err:.3g} (tol {E2E_LOGIT_TOL}), ids agree", flush=True)
    return launches, cfg, params, tok


# the device kernels each wrapper launches, by name
WRAPPER_KERNELS = {"flash_fwd": ("flash_fwd_3xtf32_kernel",
                                 "flash_fwd_tc_kernel"),
                   "similarity_topk": ("topk_kernel",),
                   "flash_bwd": ("flash_bwd_delta_kernel",
                                 "flash_bwd_3xtf32_kernel",
                                 "flash_bwd_tc_kernel",
                                 "flash_bwd_dq_sum_kernel"),
                   "contrastive_fwd": ("contrastive_lse_tile_kernel",
                                       "contrastive_lse_combine_kernel"),
                   "contrastive_bwd": ("contrastive_grad_kernel",
                                       "contrastive_grad_sum_kernel",
                                       "contrastive_dtau_sum_kernel"),
                   "contrastive_row_col_lse": (
                       "contrastive_lse_tile_kernel",
                       "contrastive_lse_combine_kernel"),
                   "contrastive_grads": ("contrastive_grad_kernel",
                                         "contrastive_grad_sum_kernel",
                                         "contrastive_dtau_sum_kernel"),
                   "decode_attention": ("decode_split_kernel",
                                        "decode_merge_kernel"),
                   "ssd_scan": ("ssd_scan_kernel",),
                   "ssd_scan_bwd": ("ssd_bwd_",)}


# device kernels by group, first match wins: the port's kernels, the
# library GEMMs, copies; everything else is elementwise or reductions
KERNEL_GROUPS = (("flash kernels", ("flash_fwd_", "flash_bwd_")),
                 ("contrastive kernels", ("contrastive_",)),
                 ("top-k kernels", ("topk_",)),
                 ("decode kernels", ("decode_split_kernel",
                                     "decode_merge_kernel")),
                 ("ssd kernels", ("ssd_scan_kernel", "ssd_bwd_")),
                 ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("copies and casts", ("copy", "Memcpy", "Memset")))


def wrapper_kernels_seen(prof, wrappers):
    """For each wrapper name, the device kernels of a ``profile_window``
    that are its kernels (``WRAPPER_KERNELS``)."""
    seen = dict.fromkeys(wrappers, 0)
    for e in device_events(prof):
        for wrapper in seen:
            seen[wrapper] += any(n in e.name
                                 for n in WRAPPER_KERNELS[wrapper])
    return seen


def device_breakdown(prof, label, wall_us, units, calls,
                     groups=KERNEL_GROUPS, by_group_out=None):
    """Print the profiled window's device time by kernel, by group of
    ``groups`` and its busy share; return, for each wrapper in ``calls``
    (wrapper -> calls in the window), the device kernels the profiler saw
    per wrapper call. ``by_group_out`` (a dict), when given, receives the
    device milliseconds per unit by group."""
    by_kernel = {}
    seen = wrapper_kernels_seen(prof, calls)
    n_device = 0
    for e in device_events(prof):
        us = e.time_range.elapsed_us()
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us
        n_device += 1
    busy = sum(by_kernel.values())
    unit = label.split()[-1]
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device time "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall; the "
          f"rest is the device idle), {n_device / units:.1f} device "
          f"kernels and copies per {unit}", flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:14]:
        print(f"  {us / 1e3 / units:9.4f} ms/{unit}  "
              f"{100 * us / max(busy, 1e-9):5.1f}%  {name[:90]}", flush=True)
    by_group = {}
    for name, us in by_kernel.items():
        group = next((g for g, keys in groups if any(
            k in name for k in keys)), "other (elementwise, reductions)")
        by_group[group] = by_group.get(group, 0.0) + us
    if by_group_out is not None:
        by_group_out.update({g: us / 1e3 / units
                             for g, us in by_group.items()})
    print(f"profile {label} by group: " + "; ".join(
        f"{g} {us / 1e3 / units:.3f} ms/{unit} "
        f"({100 * us / max(busy, 1e-9):.1f}%)"
        for g, us in sorted(by_group.items(), key=lambda kv: -kv[1])),
        flush=True)
    per_call = {}
    for wrapper, n in calls.items():
        if n < 1 or seen[wrapper] < n:
            raise AssertionError(f"profile {label}: {wrapper} called {n} "
                                 f"times, the profiler saw {seen[wrapper]} "
                                 f"of its device kernels")
        per_call[wrapper] = seen[wrapper] / n
    print(f"profile {label}: device kernels per wrapper call {per_call} "
          f"(wrapper calls {calls})", flush=True)
    return per_call, busy / wall_us


def op_device_ms(prof, ops, units, unit):
    """Print the device time per ``unit`` that the aten ops named in
    ``ops`` (label -> op names) launched themselves in a profiled window
    (``self_device_time_total``, the kernels an op launched directly);
    return it by label."""
    out = {}
    for label, names in ops.items():
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 or getattr(e, "self_cuda_time_total", 0.0)
                 for e in prof.key_averages() if e.key in names)
        out[label] = us / 1e3 / units
    print("profile by op: " + "; ".join(
        f"{k} {v:.3f} ms/{unit}" for k, v in out.items()), flush=True)
    return out


def phase_profile(cfg, params, tok, requests: int = 4):
    """Where a warm classify request's device time goes: a torch.profiler
    window over ``requests`` requests (class matrix already built), device
    time summed by kernel, and the sum over the window's wall time. Returns,
    for each serving wrapper, the device kernels the profiler saw per
    wrapper call in the window."""
    import numpy as np
    import torch
    from repro_torch.data import render_images, world_for_tower
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.serving import ZeroShotService

    rng = np.random.default_rng(1)
    world = world_for_tower(rng, cfg.image_tower, n_classes=512)
    batches = [render_images(world, rng.integers(0, 512, 16), rng)
               for _ in range(requests + 1)]
    with ZeroShotService(cfg, params, tok, device="cuda") as svc:
        svc.classify(batches[0], world.class_names, k=5)      # warm
        prof, wall_us, calls = counted_window(
            lambda: [svc.classify(images, world.class_names, k=5)
                     for images in batches[1:]],
            (fa_ops.COUNTER, topk_ops.COUNTER))
    per_call, _ = device_breakdown(prof, f"{requests} warm requests",
                                   wall_us, requests, calls)
    return per_call


# ---------------------------------------------------------------------------
# phase 5: flash-attention backward
# ---------------------------------------------------------------------------


def flash_bwd_limit(ref):
    """Per-element limit on |kernel − plain| for one flash_bwd output."""
    import torch
    if ref.dtype != torch.bfloat16:
        return FLASH_BWD_TOL
    r = ref.float().abs()
    return (FLASH_BWD_BF16_ULPS * BF16_ULP * r
            + FLASH_BWD_BF16_REL_MAX * r.max() + FLASH_BWD_BF16_ABS)


def flash_bwd_tol_text(dt):
    """The flash_bwd limit for dtype name ``dt``, as printed."""
    if dt == "float32":
        return f"{FLASH_BWD_TOL}"
    return (f"{FLASH_BWD_BF16_ULPS} ulps + {FLASH_BWD_BF16_REL_MAX}"
            f"·max|ref| + {FLASH_BWD_BF16_ABS}")


def flash_bwd_case(label, b, h, s, d, dtype, padded, seed, causal=False,
                   window=None, timed=True, kv=None):
    """Backward kernel vs plain version at one shape (``kv`` kv heads,
    default ``h``: dk and dv then sum each group's query heads); returns
    the case's record (errors of dq, dk, dv; times when ``timed``)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                         flash_bwd_ref,
                                                         flash_fwd_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bh, kv = b * h, h if kv is None else kv
    q, dout = (torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
               for _ in range(2))
    k, v = (torch.randn((b * kv, s, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    bias = None
    if padded:   # text-style key padding: 1..s valid keys per example
        lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
        keep = torch.arange(s, device=dev)[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, NEG_INF).float()
    out, lse = flash_fwd_ref(q, k, v, bias, causal=causal, window=window)
    args = (q, k, v, bias, out, lse, dout)
    got = fa_ops.flash_bwd(*args, causal=causal, window=window)
    ref = flash_bwd_ref(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    dt = dtype_name(dtype)
    errs = {}
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        err = (x.float() - r.float()).abs()
        errs[name] = err.max().item()
        if not bool((err <= flash_bwd_limit(r)).all()):
            raise AssertionError(f"flash_bwd {label} {dt}: {name} max abs "
                                 f"err {errs[name]:.3g} (tol "
                                 f"{flash_bwd_tol_text(dt)})")
    rec = {"shape": f"{label} bh={bh} s={s} d={d} {dt}"
                    + (f" kv={b * kv}" if kv != h else "")
                    + (" padded" if padded else "")
                    + (" causal" if causal else "")
                    + (f" window={window}" if window else ""),
           "max_abs_err": max(errs.values()), "errs": errs}
    plan = fa_ops.bwd_plan(bh, s, s, d, dtype)
    rec["plan"] = tuple(plan)
    if dtype == torch.bfloat16:
        # not gated: the distance from the fp32 backward of the same bf16
        # values with p and ds left unrounded
        f32 = flash_bwd_ref(*(None if a is None else a.float()
                              for a in args), causal=causal, window=window)
        rec["unrounded_err"] = {
            n: (x.float() - r).abs().max().item()
            for n, x, r in zip(("dq", "dk", "dv"), got, f32)}
        rec["unrounded_rel"] = max(
            (x.float() - r).abs().max().item() / r.abs().max().item()
            for x, r in zip(got, f32))
        print(f"flash_bwd {rec['shape']}: plan {tuple(plan)}; distance from "
              f"the unrounded fp32 backward (not gated) {rec['unrounded_err']}"
              f", largest relative to max|ref| {rec['unrounded_rel']:.3g}",
              flush=True)
    if not timed:
        print(f"flash_bwd {rec['shape']}: plan {tuple(plan)}; err {errs}",
              flush=True)
        return rec

    def call():
        fa_ops.flash_bwd(*args, causal=causal, window=window)
    rec["ms"] = time_ms(call)
    rec["device_ms"], _ = device_ms(call, WRAPPER_KERNELS["flash_bwd"],
                                    iters=5)
    rec["plain_ms"] = time_ms(lambda: flash_bwd_ref(*args, causal=causal,
                                                    window=window), iters=5)
    # SDPA's backward: forward + backward through autograd, minus the
    # forward timed apart on the same inputs
    sdpa_fwd, views = sdpa_call(q, k, v, bias, b, h, kv, causal, window,
                                grad=True)
    do4 = dout.view(b, h, s, d)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), views, do4)

    with torch.no_grad():
        fwd_ms = time_ms(sdpa_fwd)
    rec["library_ms"] = time_ms(sdpa_fwd_bwd) - fwd_ms
    item = torch.finfo(dtype).bits // 8
    # q, out, dout, dq; k, v, dk, dv; five products of 2·d per attended
    # (query, key) pair: the q·kᵀ recompute, dout·vᵀ, ds·k, dsᵀ·q, pᵀ·dout
    nbytes, flops = flash_bwd_work(bh, b * kv, s, s, d, item, causal=causal,
                                   window=window,
                                   bias_rows=b if padded else 0)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dt,
                                             flash_peak(dt))
    print(f"flash_bwd {rec['shape']}: plan {tuple(plan)}; err {errs} (tol "
          f"{flash_bwd_tol_text(dt)}); "
          f"kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f} ms), "
          f"plain "
          f"{rec['plain_ms']:.4f} ms, sdpa "
          f"backward {rec['library_ms']:.4f} ms (its forward {fwd_ms:.4f} ms "
          f"subtracted), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)
    return rec


def phase_flash_bwd():
    """Backward kernel at one microbatch of the timed run (M = 256): image
    bh 3072, s 196; text bh 4096, s 16, padded; f32 and bf16; plus causal,
    windowed and head-dim-128 cases, checked once each."""
    import torch
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        recs[("image", dtype)] = flash_bwd_case("image", 256, 12, 196, 64,
                                                dtype, False, 11)
        recs[("text", dtype)] = flash_bwd_case("text", 256, 16, 16, 64,
                                               dtype, True, 12)
    for dtype in (torch.float32, torch.bfloat16):
        for d, causal, window in ((64, True, None), (64, True, 48),
                                  (128, False, None)):
            flash_bwd_case("mask", 2, 12, 200, d, dtype, False, 13,
                           causal=causal, window=window, timed=False)
    # past one key block (256 keys in bf16, 208 in f32): split keys, dq
    # summed from partials
    for dtype in (torch.float32, torch.bfloat16):
        flash_bwd_case("split", 2, 12, 520, 64, dtype, False, 14,
                       causal=True, timed=False)
    return recs


# ---------------------------------------------------------------------------
# phase 6: fused contrastive loss
# ---------------------------------------------------------------------------


def cl_grad_tol(ref, dt):
    """Max-abs limit on a contrastive_bwd gradient (dX or dY, fp32) whose
    inputs were of dtype name ``dt``."""
    if dt == "float32":
        return CL_GRAD_TOL_F32
    return CL_GRAD_REL_MAX_BF16 * ref.abs().max().item()


def contrastive_case(b, d, dtype, seed, timed=True, legacy=False):
    """Forward and backward kernels vs their plain versions at (B, D): the
    fused pair, or with ``legacy`` the 4-pass pair (``row_col_lse``,
    ``grads``); returns the case's records."""
    import torch
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.contrastive_loss import ref as cl_ref
    if legacy:
        names = ("contrastive_row_col_lse", "contrastive_grads")
        fwd_k, bwd_k = cl_ops.row_col_lse, cl_ops.grads
        fwd_ref, bwd_ref = cl_ref.row_col_lse_ref, cl_ref.grads_ref
    else:
        names = ("contrastive_fwd", "contrastive_bwd")
        fwd_k, bwd_k = cl_ops.fwd_fused, cl_ops.bwd_fused
        fwd_ref, bwd_ref = cl_ref.fwd_fused_ref, cl_ref.bwd_fused_ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, y = unit_rows(b, d, g, dtype), unit_rows(b, d, g, dtype)
    log_tau = torch.tensor(-2.659, device="cuda")          # ~ log 0.07
    inv_tau = torch.exp(-log_tau)
    dt = dtype_name(dtype)
    row, col = fwd_k(x, y, inv_tau)
    ref_row, ref_col = fwd_ref(x, y, inv_tau)
    fwd_err = max((row - ref_row).abs().max().item(),
                  (col - ref_col).abs().max().item())
    if not fwd_err <= CL_LSE_TOL:
        raise AssertionError(f"{names[0]} B={b} D={d} {dt}: max lse err "
                             f"{fwd_err:.3g} (tol {CL_LSE_TOL})")
    bwd_err, bwd_tol = 0.0, float("inf")
    for b_norm, with_diag in ((None, True), (3 * b, False)):
        got = bwd_k(x, y, inv_tau, ref_row, ref_col, b_norm=b_norm,
                    with_diag=with_diag)
        ref = bwd_ref(x, y, inv_tau, ref_row, ref_col, b_norm=b_norm,
                      with_diag=with_diag)
        gerr = max((got[0] - ref[0]).abs().max().item(),
                   (got[1] - ref[1]).abs().max().item())
        terr = abs((got[2] - ref[2]).item())
        gtol = min(cl_grad_tol(ref[0], dt), cl_grad_tol(ref[1], dt))
        if not (gerr <= gtol and terr <= CL_DTAU_RTOL[dt]
                * abs(ref[2].item()) + 1e-6):
            raise AssertionError(f"{names[1]} B={b} D={d} {dt} b_norm="
                                 f"{b_norm} with_diag={with_diag}: max grad "
                                 f"err {gerr:.3g}, dlog_tau err {terr:.3g}")
        bwd_err = max(bwd_err, gerr)
        bwd_tol = min(bwd_tol, gtol)
    if not legacy:
        # the fused forward runs row_col_lse's launches: the same bits
        same = all(torch.equal(a, r) for a, r in
                   zip((row, col), cl_ops.row_col_lse(x, y, inv_tau)))
        if not same:
            raise AssertionError(f"{names[0]} B={b} D={d} {dt}: not bit "
                                 f"for bit equal to row_col_lse")
    print(f"{names[0]} / {names[1]} B={b} D={d} {dt}: lse err "
          f"{fwd_err:.3g} (tol {CL_LSE_TOL})"
          + ("" if legacy else ", equal to row_col_lse bit for bit")
          + f", dX/dY err {bwd_err:.3g} (tol "
          f"{bwd_tol:.3g}; with_diag and b_norm=B, and without diag at "
          f"b_norm=3B)", flush=True)
    fwd = {"shape": f"B={b} D={d} {dt}", "max_abs_err": fwd_err}
    bwd = {"shape": f"B={b} D={d} {dt}", "max_abs_err": bwd_err}
    lp = cl_ops.lse_plan(b, dtype)
    fwd["plan"] = {"tile": lp.tile, "grid": lp.grid,
                   "scratch_bytes": 4 * lp.scratch_floats}
    print(f"{names[0]} B={b} D={d} {dt}: plan {fwd['plan']}", flush=True)
    if not timed:
        return fwd, bwd
    item = torch.finfo(dtype).bits // 8
    iters, warmup = cl_iters(b)

    def tm(fn):
        return time_ms(fn, iters, warmup)

    fwd["ms"] = tm(lambda: fwd_k(x, y, inv_tau))
    fwd["device_ms"], _ = device_ms(lambda: fwd_k(x, y, inv_tau),
                                    WRAPPER_KERNELS[names[0]], iters)
    fwd["plain_ms"] = tm(lambda: fwd_ref(x, y, inv_tau))

    def lib_fwd():
        a = (x @ y.T).float() * inv_tau
        return torch.logsumexp(a, 1), torch.logsumexp(a, 0)

    fwd["library_ms"] = tm(lib_fwd)
    fwd["bound_ms"], fwd["bound_by"] = bound(
        *contrastive_fwd_work(b, b, d, item), dt)
    bargs = (x, y, inv_tau, ref_row, ref_col)
    plan = cl_ops.bwd_plan(b, d)
    bwd["plan"] = {"grid": plan.grid, "slices": plan.slices,
                   "scratch_bytes": 4 * plan.scratch_floats,
                   "scratch_over_dx_dy": plan.scratch_floats / (2 * b * d)}
    bwd["ms"] = tm(lambda: bwd_k(*bargs))
    bwd["plain_ms"] = tm(lambda: bwd_ref(*bargs))
    # autograd of the materialised loss, minus its forward timed apart
    xr, yr, lr_ = (t.detach().clone().requires_grad_()
                   for t in (x, y, log_tau))
    with torch.no_grad():
        lfwd_ms = tm(lambda: cl_ref.loss_ref(xr, yr, lr_))
    bwd["library_ms"] = tm(lambda: torch.autograd.grad(
        cl_ref.loss_ref(xr, yr, lr_), (xr, yr, lr_))) - lfwd_ms
    bwd["bound_ms"], bwd["bound_by"] = bound(
        *contrastive_bwd_work(b, b, d, item), dt)
    for name, r in zip(names, (fwd, bwd)):
        print(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms"
              + (f" (device {r['device_ms']:.4f})" if "device_ms" in r
                 else "") + f", plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; plan {r['plan']}" if "plan" in r else ""), flush=True)
    return fwd, bwd


def cl_iters(b):
    """(timed launches, warm-ups) of a contrastive call at batch ``b``:
    few at B = 8192, where a backward takes ~0.2 s."""
    return (3, 1) if b >= 8192 else (20, 3)


def phase_contrastive():
    """Fused contrastive kernels at the timed run's B = 2048 and a ragged
    B = 1000 (D = 512): f32 timed, bf16 timed at B = 2048."""
    import torch
    recs = {}
    for b in (2048, 1000):
        recs[(b, torch.float32)] = contrastive_case(b, 512, torch.float32,
                                                    20 + b)
        recs[(b, torch.bfloat16)] = contrastive_case(b, 512, torch.bfloat16,
                                                     21 + b,
                                                     timed=b == 2048)
    return recs


# ---------------------------------------------------------------------------
# phase 7: the legacy 4-pass contrastive pair
# ---------------------------------------------------------------------------

# benchmarks/kernel_bench.py's shapes (B, D) and log_tau
LEGACY_SHAPES = ((512, 256), (512, 1024), (2048, 256), (2048, 1024),
                 (8192, 256), (8192, 1024))
LEGACY_LOG_TAU = -1.0


def phase_legacy():
    """``row_col_lse`` and ``grads`` vs their plain versions at the kernel
    bench's six shapes (f32, timed), bf16 at B = 2048 and a ragged B = 1000
    (untimed); then the path: the two 4-pass ops at the six shapes with the
    counts set to 0 before, held against the fused loss and its autograd;
    the bench's old4 / fused2 times and a profile of one 4-pass call.
    Returns (records, launches, device kernels per wrapper call)."""
    import torch
    from repro_torch.kernels.contrastive_loss import ops as cl_ops

    recs = {}
    for i, (b, d) in enumerate(LEGACY_SHAPES):
        recs[(b, d, "float32")] = contrastive_case(b, d, torch.float32,
                                                   40 + i, legacy=True)
    for b, dtype in ((2048, torch.bfloat16), (1000, torch.float32),
                     (1000, torch.bfloat16)):
        recs[(b, 512, dtype_name(dtype))] = contrastive_case(
            b, 512, dtype, 50 + b, timed=False, legacy=True)

    inputs = {}
    for b, d in LEGACY_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(b + d)
        inputs[(b, d)] = (unit_rows(b, d, g, torch.float32),
                          unit_rows(b, d, g, torch.float32),
                          torch.tensor(LEGACY_LOG_TAU, device="cuda"))
    counters = (cl_ops.ROW_COL_LSE_COUNTER, cl_ops.GRADS_COUNTER)
    for ctr in counters:
        ctr.reset()
    outs = {key: (cl_ops.fused_loss_and_lse_4pass(*args),
                  cl_ops.fused_contrastive_loss_4pass(*args))
            for key, args in inputs.items()}
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    print(f"legacy path launches: {launches} (the two 4-pass ops at "
          f"{len(inputs)} shapes)", flush=True)
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"legacy path")

    errs = {"loss": 0.0, "lse": 0.0, "grad": 0.0, "dtau_rel": 0.0}
    for (b, d), (x, y, lt) in inputs.items():
        (l4, r4, c4), (loss4, dx, dy, dtau) = outs[(b, d)]
        xr, yr, ltr = (t.clone().requires_grad_() for t in (x, y, lt))
        loss = cl_ops.fused_contrastive_loss(xr, yr, ltr)
        gx, gy, gt = torch.autograd.grad(loss, (xr, yr, ltr))
        _, rf, cf = cl_ops.fused_loss_and_lse(x, y, lt)
        e = {"loss": max(abs((l4 - loss).item()), abs((loss4 - loss).item())),
             "lse": max((r4 - rf).abs().max().item(),
                        (c4 - cf).abs().max().item()),
             "grad": max((dx - gx).abs().max().item(),
                         (dy - gy).abs().max().item()),
             "dtau_rel": abs((dtau - gt).item()) / abs(gt.item())}
        gtol = min(cl_grad_tol(gx, "float32"), cl_grad_tol(gy, "float32"))
        if not (e["loss"] <= CL_LSE_TOL and e["lse"] <= CL_LSE_TOL
                and e["grad"] <= gtol and abs((dtau - gt).item())
                <= CL_DTAU_RTOL["float32"] * abs(gt.item()) + 1e-6):
            raise AssertionError(f"4-pass vs fused loss at B={b} D={d}: {e}")
        errs = {k: max(v, e[k]) for k, v in errs.items()}
    print(f"legacy path vs fused loss + autograd, six shapes f32: max "
          f"errors {errs} (tols loss/lse {CL_LSE_TOL}, dX/dY "
          f"{CL_GRAD_TOL_F32}, dlog_tau rel {CL_DTAU_RTOL['float32']})",
          flush=True)

    bench = {}
    for (b, d), (x, y, lt) in inputs.items():
        iters, warmup = cl_iters(b)
        xr, yr, ltr = (t.clone().requires_grad_() for t in (x, y, lt))

        def fused_fwdbwd():
            loss = cl_ops.fused_contrastive_loss(xr, yr, ltr)
            return torch.autograd.grad(loss, (xr, yr, ltr))

        paths = (("old4", lambda: cl_ops.fused_loss_and_lse_4pass(x, y, lt),
                  lambda: cl_ops.fused_contrastive_loss_4pass(x, y, lt)),
                 ("fused2", lambda: cl_ops.fused_contrastive_loss(x, y, lt),
                  fused_fwdbwd))
        for name, fwd, fwdbwd in paths:
            for tag, fn in (("fwd", fwd), ("fwdbwd", fwdbwd)):
                bench[f"{name}/B{b}_D{d}/{tag}"] = 1e3 * time_ms(
                    fn, iters, warmup)
    print("legacy kernel_bench (us per call, CUDA events): "
          + json.dumps(bench), flush=True)

    x, y, lt = inputs[(2048, 1024)]
    cl_ops.fused_contrastive_loss_4pass(x, y, lt)              # warm
    torch.cuda.synchronize()

    def one_call():
        calls = {ctr.name: -ctr.count for ctr in counters}
        t0 = time.perf_counter()
        cl_ops.fused_contrastive_loss_4pass(x, y, lt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        for ctr in counters:
            calls[ctr.name] += ctr.count
        return wall_us, calls

    def complete(prof, out):
        seen = wrapper_kernels_seen(prof, out[1])
        return all(seen[w] >= n for w, n in out[1].items())

    # device_breakdown fails if the last window still misses a wrapper's
    # device kernels
    prof, (wall_us, calls) = retaken_window(one_call, complete)
    per_call, _ = device_breakdown(
        prof, "fused_contrastive_loss_4pass at B=2048 D=1024, 1 call",
        wall_us, 1, calls)
    return recs, launches, per_call


# ---------------------------------------------------------------------------
# phase 9: training parity, kernel path vs plain path
# ---------------------------------------------------------------------------


def phase_train_parity(batch_size: int = 256, num_micro: int = 2):
    """One GradAccum step + AdaFactorW of BASIC-S (full width and depth,
    f32) on both paths from the same weights and batch."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.core import remat as remat_lib
    from repro_torch.core.contrastive import (contrastive_loss,
                                              fused_kernel_loss)
    from repro_torch.core.gradaccum import contrastive_step
    from repro_torch.data import (contrastive_batch, load_tokenizer,
                                  world_for_tower)
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.launch.train import batch_to
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import dual_encoder as de
    from repro_torch.optim import apply_updates

    cfg = get_arch("basic-s")
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, cfg.image_tower, n_classes=64)
    batch, _ = contrastive_batch(world, load_tokenizer(), batch_size, rng)
    batch = batch_to(batch, "cuda")
    params = interop.init_params(cfg, torch.Generator().manual_seed(1),
                                 "cuda")
    opt = make_optimizer()
    lr = 2.5e-4
    policy = remat_lib.get_policy("basic")
    results, flash_launches = {}, {}
    for path, attn, loss_fn in (("kernel", "pallas", fused_kernel_loss),
                                ("plain", "naive", contrastive_loss)):
        pcfg = dataclasses.replace(
            cfg, image_tower=dataclasses.replace(cfg.image_tower,
                                                 attn_impl=attn),
            text_tower=dataclasses.replace(cfg.text_tower, attn_impl=attn))
        for ctr in (fa_ops.COUNTER, fa_ops.BWD_COUNTER):
            ctr.reset()
        t0 = time.perf_counter()
        loss, _, grads = contrastive_step(
            lambda p, im: de.encode_image(pcfg, p, im, precision="f32",
                                          remat_policy=policy),
            lambda p, tx: de.encode_text(pcfg, p, tx, precision="f32",
                                         remat_policy=policy),
            params, batch, num_micro, loss_fn=loss_fn)
        updates, _ = opt.update(grads, opt.init(params), params, lr)
        new = apply_updates(params, updates)
        torch.cuda.synchronize()
        results[path] = (loss.item(), dict(interop.leaves(grads)),
                         dict(interop.leaves(new)),
                         time.perf_counter() - t0)
        flash_launches[path] = {ctr.name: ctr.count for ctr in (
            fa_ops.COUNTER, fa_ops.BWD_COUNTER)}
    rec = check_step_parity(
        f"train parity (BASIC-S f32, B={batch_size}, {num_micro} "
        f"microbatches)", results, lr, flash_launches)
    return {**rec, "launches": flash_launches["kernel"]}


def factored_past(g, off):
    """Where a factored leaf's updates differ past the limit (``off``, a
    mask of the leaf's shape, ``g`` its plain-path gradient): a line that
    names the matrices (the leading indices: layer, expert) with each one's
    largest |gradient| over the leaf's largest, and the largest share of the
    leaf's largest row and column gradient RMS that a row or column holding
    such an element has; and whether each such element lies in a row or a
    column whose gradient RMS is within TRAIN_GRAD_RTOL of the leaf's
    largest, where AdaFactorW's factored update divides by that RMS."""
    g = g.float()
    g2 = g.square()
    row, col = g2.mean(-1).sqrt(), g2.mean(-2).sqrt()
    rows, cols = off.any(-1), off.any(-2)
    lead = off.flatten(-2).any(-1).nonzero().tolist()
    top = g.abs().max().clamp(min=1e-30)
    mats = ", ".join(
        f"{tuple(i)}: {(g[tuple(i)].abs().max() / top).item():.3g}"
        for i in lead[:8]) + (" ..." if len(lead) > 8 else "")
    share_r = (row[rows].max() / row.max().clamp(min=1e-30)).item()
    share_c = (col[cols].max() / col.max().clamp(min=1e-30)).item()
    line = (f"{int(off.sum())} elements in {len(lead)} matrices (index: max "
            f"|g| / the leaf's) {mats}; their rows' gradient RMS at most "
            f"{share_r:.3g}, their columns' {share_c:.3g} of the leaf's "
            f"largest")
    near_zero = ((row <= TRAIN_GRAD_RTOL * row.max())[..., :, None]
                 | (col <= TRAIN_GRAD_RTOL * col.max())[..., None, :])
    return line, not bool((off & ~near_zero).any())


def check_step_parity(label, results, lr, flash_launches, needed=None,
                      amplified=False):
    """Hold the kernel path's f32 training step against the plain path's:
    ``results[path] = (loss, gradients by leaf path, params after the
    update by leaf path, seconds)``. The loss within TRAIN_LOSS_TOL, every
    gradient leaf within TRAIN_GRAD_RTOL of its largest entry, the updated
    params within TRAIN_UPDATE_TOL_LR·lr (an unfactored element may differ
    more only where its gradient is near zero). A factored leaf past that
    limit is named (``factored_past``) and fails, unless ``amplified``:
    then its elements past the limit may differ by up to 2·lr where each
    lies in a row or column whose gradient RMS is near zero (the update
    divides by it), at most TRAIN_AMPLIFIED_SHARE of the leaf's elements;
    they are counted and printed. ``flash_launches[path]`` counts the
    path's kernels (the f32 flash kernels, or the others the step runs):
    the kernel path must launch each (``needed`` times, when given) and
    the plain path none. Returns the errors."""
    (lk, gk, pk, tk), (lp, gp, pp, tp) = results["kernel"], results["plain"]
    loss_err = abs(lk - lp)
    grad_rel = {path: ((gk[path] - gp[path]).abs().max()
                       / gp[path].abs().max().clamp(min=1e-30)).item()
                for path in gp}
    worst = max(grad_rel, key=grad_rel.get)
    limit = TRAIN_UPDATE_TOL_LR * lr
    upd_err, flips, excused = 0.0, 0, {}
    for path in pp:
        diff = (pk[path] - pp[path]).abs()
        g = gp[path]
        off = diff > limit
        if g.dim() >= 2 and min(g.shape[-2:]) >= 128:       # factored
            if bool(off.any()):
                most = diff.max().item()
                line, near_zero = factored_past(g, off)
                n = int(off.sum())
                print(f"{label}: {path} update differs by up to {most:.3g} "
                      f"({most / lr:.3g}·lr, limit {limit:.3g}): {line}",
                      flush=True)
                if not (amplified and near_zero and most <= 2 * lr
                        and n <= TRAIN_AMPLIFIED_SHARE * off.numel()):
                    raise AssertionError(
                        f"{label}: {path} update differs by {most:.3g} at "
                        f"{n} elements, past {limit:.3g}")
                excused[path] = {"elements": n, "max_diff": most}
                diff = diff[~off]
            upd_err = max(upd_err, diff.max().item() if diff.numel() else 0.0)
            continue
        near_zero = g.abs() <= TRAIN_GRAD_RTOL * g.abs().max()
        if bool((off & ~near_zero).any()):
            raise AssertionError(f"{label}: {path} update differs by "
                                 f"{diff.max().item():.3g} where its "
                                 f"gradient is not near zero")
        flips += int(off.sum())
        upd_err = max(upd_err, diff[~off].max().item() if bool(
            (~off).any()) else 0.0)
    print(f"{label}: loss kernel {lk:.6f} plain {lp:.6f} (|diff| "
          f"{loss_err:.3g}, tol {TRAIN_LOSS_TOL}); largest relative gradient "
          f"error {grad_rel[worst]:.3g} at {worst} (tol {TRAIN_GRAD_RTOL}); "
          f"updated params max diff {upd_err:.3g} (tol "
          f"{limit:.3g} = {TRAIN_UPDATE_TOL_LR}·lr; "
          f"{flips} unfactored elements with near-zero gradients differ "
          f"more"
          + (f"; factored leaves' elements in near-zero rows or columns "
             f"differ more: {excused}" if amplified else "")
          + f"); step {tk:.2f}s kernel path, {tp:.2f}s plain path; "
          f"f32 kernel launches {flash_launches}", flush=True)
    kernel_counts = flash_launches["kernel"].values()
    if (min(kernel_counts) < 1
            or (needed is not None and set(kernel_counts) != {needed})
            or max(flash_launches["plain"].values()) > 0):
        raise AssertionError(f"{label}: the kernel path must launch each "
                             f"of its kernels"
                             + (f" {needed} times each" if needed else "")
                             + f" and the plain path neither, got "
                             f"{flash_launches}")
    if not (loss_err <= TRAIN_LOSS_TOL and grad_rel[worst] <= TRAIN_GRAD_RTOL
            and upd_err <= limit):
        raise AssertionError(f"{label}: kernel path and plain path "
                             f"disagree beyond the stated tolerances")
    return {"loss_err": loss_err, "grad_rel_err": grad_rel[worst],
            "update_err": upd_err, "flips": flips, "amplified": excused}


def step_parity(label, cfg, params, seq, lr, seed, moe_args=None, needed=1,
                amplified=False):
    """One f32 step (``lm_step_results``) of ``cfg`` from ``params`` on a
    batch of 1 × ``seq`` drawn from ``seed``, on the kernel path and the
    plain path (chunked attention), held by ``check_step_parity`` (with
    ``amplified`` as given). The kernel path's trees are parked in host
    memory (a full-width MoE layer's gradients and updated params are 23
    GB: one path's at a time on the card). Returns the check's record and
    the kernel path's launches."""
    import numpy as np
    import torch
    from repro_torch.models import frontends
    data = frontends.synthetic_inputs(cfg, 1, seq,
                                      np.random.default_rng(seed),
                                      device="cuda")
    results, launches = {}, {}
    for path, attn in (("kernel", "pallas"), ("plain", "chunked")):
        results[path], launches[path] = lm_step_results(
            dataclasses.replace(cfg, attn_impl=attn), params, data, lr,
            lm_counters(), moe_args=moe_args, to_host=path == "kernel")
        if path == "kernel":
            loss, grads, new, secs = results[path]
            results[path] = (loss, OnCard(grads), OnCard(new), secs)
        torch.cuda.empty_cache()
    rec = check_step_parity(label, results, lr, launches, needed=needed,
                            amplified=amplified)
    del results, data
    torch.cuda.empty_cache()
    return {**rec, "launches": launches["kernel"]}


# ---------------------------------------------------------------------------
# phase 10: timed training through the trainer's entry point
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--mode", "contrastive", "--arch", "basic-s", "--batch",
              "2048", "--num-micro", "8", "--steps", "6", "--seed", "0",
              "--precision", "bf16", "--loss", "fused", "--attn", "pallas",
              "--remat", "basic"]


def train_step_flops(cfg, batch: int, text_len: int = 16):
    """(dense, attention) FLOP of one training step of the timed run's
    configuration, from the shapes: every weight matmul twice forward
    (pass 1, pass 2) and twice backward (remat ``basic`` keeps the matmul
    outputs); attention three times forward (pass 1, pass 2, the remat
    recompute) and once backward at 5·2·s²·d per head (the q·kᵀ recompute,
    dout·vᵀ, ds·k, dsᵀ·q, pᵀ·dout) against the forward's 4·s²·d."""
    def tower(t, tokens):
        hd = t.resolved_head_dim
        per_layer = (t.d_model * (t.n_heads + 2 * t.n_kv_heads) * hd
                     + t.n_heads * hd * t.d_model + 3 * t.d_model * t.d_ff)
        dense = 2.0 * tokens * t.n_layers * per_layer
        attn = t.n_layers * t.n_heads * 4.0 * tokens ** 2 * hd
        return dense, attn
    it, tt = cfg.image_tower, cfg.text_tower
    di, ai = tower(it, it.frontend_len)
    dt, at = tower(tt, text_len)
    patch = 2.0 * it.frontend_len * it.patch_size ** 2 * it.channels \
        * it.d_model
    proj = 2.0 * (it.d_model + tt.d_model) * cfg.embed_dim
    dense_fwd = di + dt + patch + proj
    return batch * 4 * dense_fwd, batch * (3 + 2.5) * (ai + at)


def phase_train_timed():
    """``repro_torch.launch.train.main`` at full width and depth; returns
    (launches per step, report)."""
    import math
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train

    counters = (fa_ops.COUNTER, fa_ops.BWD_COUNTER, cl_ops.FWD_COUNTER,
                cl_ops.BWD_COUNTER)
    for ctr in counters:
        ctr.reset()
    rep = train.main(TRAIN_ARGV)
    steps = len(rep["losses"])
    launches = {ctr.name: ctr.count for ctr in counters}
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"train timed: BASIC-S bf16, B=2048 in 8 microbatches, {steps} "
          f"steps: warm step median {rep['warm_step_median_s']:.4f} s over "
          f"{len(rep['step_s']) - 1} warm steps, {rep['pairs_per_s']:.1f} "
          f"pairs/s, max_memory_allocated "
          f"{rep['max_memory_allocated'] / 2**30:.3f} GiB; step s "
          f"{[round(t, 4) for t in rep['step_s']]}; data s "
          f"{[round(t, 3) for t in rep['data_s']]}; losses "
          f"{[round(v, 5) for v in rep['losses']]}", flush=True)
    print(f"train timed launches: {launches}, per step {per_step}",
          flush=True)
    from repro_torch.configs import get_arch
    dense, attn = train_step_flops(get_arch("basic-s"), 2048)
    step_bound = (dense + attn) / PEAK_FLOPS["bfloat16"]
    print(f"train FLOP model: dense {dense / 1e12:.1f} TFLOP/step, "
          f"attention {attn / 1e12:.2f} TFLOP/step; bound {step_bound:.4f} "
          f"s/step at the bf16 peak; the warm median is "
          f"{rep['warm_step_median_s'] / step_bound:.1f}x that; attention "
          f"alone bounds at {attn / PEAK_FLOPS['float32']:.4f} s on the fp32 "
          f"FMA units", flush=True)
    if not all(math.isfinite(v) for v in rep["losses"]):
        raise AssertionError(f"non-finite training loss {rep['losses']}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    return launches, per_step, rep


def phase_train_profile():
    """A torch.profiler window over one warm training step (after one
    unprofiled step) of the timed run's configuration: device time by
    kernel, busy share, device kernels per wrapper call."""
    import torch
    from repro_torch.data import contrastive_batch
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train

    args = train.parse_args(TRAIN_ARGV)
    dev = torch.device("cuda")
    run = train.build_contrastive(args, dev)
    batches = [train.batch_to(contrastive_batch(run["world"], run["tok"],
                                                args.batch, run["rng"])[0],
                              dev) for _ in range(2)]
    out = run["step_fn"](run["params"], run["opt_state"], batches[0])  # warm
    float(out[2])
    state = list(out[:2])

    def step():
        state[0], state[1], loss, _ = run["step_fn"](*state, batches[1])
        float(loss)
    prof, wall_us, calls = counted_window(
        step, (fa_ops.COUNTER, fa_ops.BWD_COUNTER, cl_ops.FWD_COUNTER,
               cl_ops.BWD_COUNTER))
    return device_breakdown(prof, "1 warm training step", wall_us, 1, calls)


# ---------------------------------------------------------------------------
# phase 11: the BASIC recipe (pretrain, frozen-tower contrastive, finetune)
# and zero-shot evaluation
# ---------------------------------------------------------------------------

RECIPE_ARGV = ["--arch", "basic-s", "--classes", "64", "--seed", "0",
               "--precision", "bf16", "--attn", "pallas", "--remat", "basic",
               "--loss", "fused"]
PRETRAIN_ARGV = ["--mode", "pretrain", "--batch", "1024", "--steps", "4",
                 *RECIPE_ARGV]
FROZEN_ARGV = ["--mode", "contrastive", "--batch", "2048", "--num-micro",
               "8", "--steps", "3", *RECIPE_ARGV]
FINETUNE_ARGV = ["--mode", "finetune", "--batch", "2048", "--num-micro",
                 "8", "--steps", "2", "--lr", "5e-4", *RECIPE_ARGV]
# the frozen tower after phase 2 against p·Π(1 − lr_t·wd): fp32 rounding of
# one multiply-add per step, a few ulps of each leaf's largest entry
FROZEN_TOL_REL = 1e-6
# the two evaluations' top-1 must agree on rows whose best and second
# cosine logits differ by more than this (both run the towers in f32 on
# the flash kernels; the class matrix and products sum in another order)
EVAL_GAP = 1e-5
EVAL_IMAGES = 1024


def recipe_counters():
    """The launch counters the recipe phase reads: flash forward and
    backward, the fused contrastive forward and backward, top-k."""
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    return (fa_ops.COUNTER, fa_ops.BWD_COUNTER, cl_ops.FWD_COUNTER,
            cl_ops.BWD_COUNTER, topk_ops.COUNTER)


def counted(fn):
    """(fn(), {kernel: launches during the call}), the counts set to 0
    just before."""
    counters = recipe_counters()
    for ctr in counters:
        ctr.reset()
    out = fn()
    return out, {ctr.name: ctr.count for ctr in counters}


def require_launches(label, launches, needed, absent=()):
    """Raise unless every kernel in ``needed`` launched and none in
    ``absent`` did."""
    print(f"recipe {label} launches: {launches}", flush=True)
    for name in needed:
        if launches[name] < 1:
            raise AssertionError(f"recipe {label}: kernel {name} was not "
                                 f"launched")
    for name in absent:
        if launches[name]:
            raise AssertionError(f"recipe {label}: kernel {name} launched "
                                 f"{launches[name]} times")


def require_equal_trees(label, got, want):
    """Raise unless two trees of tensors have the same leaf paths, dtypes,
    shapes and bits."""
    import torch
    from repro_torch.tree import leaves
    g, w = list(leaves(got)), list(leaves(want))
    if [p for p, _ in g] != [p for p, _ in w]:
        raise AssertionError(f"{label}: the trees' leaves differ")
    for (path, a), (_, b) in zip(g, w):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.reshape(-1).view(torch.uint8),
                b.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{label}: leaf {path} differs")


def phase_report(label, rep, unit):
    """Print a phase's step times, rate, peak memory and losses."""
    import math
    print(f"recipe {label}: warm step median {rep['warm_step_median_s']:.4f}"
          f" s, {rep[f'{unit}_per_s']:.1f} {unit}/s, max_memory_allocated "
          f"{rep['max_memory_allocated'] / 2**30:.3f} GiB; step s "
          f"{[round(t, 4) for t in rep['step_s']]}; data s "
          f"{[round(t, 3) for t in rep['data_s']]}; losses "
          f"{[round(v, 5) for v in rep['losses']]}", flush=True)
    if not all(math.isfinite(v) for v in rep["losses"]):
        raise AssertionError(f"recipe {label}: non-finite loss "
                             f"{rep['losses']}")


def phase_recipe():
    """BASIC's three phases through ``repro_torch.launch.train`` at full
    width and depth (bf16, flash attention, remat basic, 64 classes), then
    ``evaluate_benchmark`` and ``evaluate_with_service`` on the same fresh
    images and the zero-shot table on the card. Returns (launches by phase,
    report)."""
    import math

    import numpy as np
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch import interop
    from repro_torch.data import render_images
    from repro_torch.eval import (classify, evaluate_benchmark,
                                  evaluate_with_service, zero_shot_table)
    from repro_torch.eval.zero_shot import class_embeddings
    from repro_torch.launch import train
    from repro_torch.models import dual_encoder as de
    from repro_torch.optim import warmup_cosine
    from repro_torch.serving import ZeroShotService

    fa, fb, cf, cb, tk = (c.name for c in recipe_counters())
    launches, out = {}, {}

    ckpt_dir = os.path.join(CKPT_ROOT, "pretrain")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    pre, launches["pretrain"] = counted(
        lambda: train.main(PRETRAIN_ARGV + ["--ckpt-dir", ckpt_dir]))
    phase_report("phase 1 (pretrain, B=1024)", pre, "images")
    require_launches("phase 1", launches["pretrain"], (fa, fb), (cf, cb, tk))
    # phase 2 starts from the tower restored from phase 1's checkpoint
    trained = pre.pop("params")
    pre.pop("opt_state")
    t0 = time.perf_counter()
    restored = ckpt.restore(ckpt_dir, train.parse_args(PRETRAIN_ARGV).steps,
                            interop.to_device(trained, "meta"),
                            device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require_equal_trees("recipe phase 1 checkpoint", restored, trained)
    print(f"recipe phase 1: saved {pre['ckpt_path']} in "
          f"{pre['ckpt_save_s']:.3f} s, restored onto the card in "
          f"{restore_s:.3f} s, bit for bit", flush=True)
    shutil.rmtree(ckpt_dir)
    tower = restored["tower"]
    del trained, restored

    args2 = train.parse_args(FROZEN_ARGV)
    p2, launches["frozen"] = counted(lambda: train.run_contrastive(
        args2, image_tower_init=tower, train_image=False))
    phase_report("phase 2 (frozen image tower, B=2048 in 8)", p2, "pairs")
    require_launches("phase 2", launches["frozen"], (cf, cb, fa, fb), (tk,))
    lr = warmup_cosine(args2.lr, args2.lr / 100, args2.steps // 10 or 1,
                       args2.steps)
    factor = math.prod(1.0 - float(lr(t)) * 0.0025
                       for t in range(args2.steps))
    frozen_err = 0.0
    for (path, got), (_, p0) in zip(
            interop.leaves(p2["params"]["image"]["tower"]),
            interop.leaves(tower)):
        want = p0.double() * factor
        err = ((got.double() - want).abs().max()
               / want.abs().max().clamp(min=1e-30)).item()
        frozen_err = max(frozen_err, err)
    print(f"recipe phase 2: image tower vs phase 1's x {factor:.9f} "
          f"(= prod(1 - lr_t * 0.0025) over {args2.steps} steps): largest "
          f"relative error {frozen_err:.3g} (tol {FROZEN_TOL_REL})",
          flush=True)
    if not frozen_err <= FROZEN_TOL_REL:
        raise AssertionError("recipe phase 2: the frozen image tower is not "
                             "phase 1's times the weight-decay factor")
    del tower
    tower2 = p2.pop("params")["image"]["tower"]
    p2.pop("opt_state")
    torch.cuda.empty_cache()

    args3 = train.parse_args(FINETUNE_ARGV)
    p3, launches["finetune"] = counted(lambda: train.run_contrastive(
        args3, image_tower_init=tower2, train_image=True))
    phase_report("phase 3 (finetune, B=2048 in 8)", p3, "pairs")
    require_launches("phase 3", launches["finetune"], (cf, cb, fa, fb),
                     (tk,))
    params = p3.pop("params")
    p3.pop("opt_state")
    del tower2
    torch.cuda.empty_cache()

    # evaluation: the final model on the same fresh images, both ways
    cfg, world, tok, _ = train._build_world(args3)
    cfg = dataclasses.replace(
        cfg, image_tower=dataclasses.replace(cfg.image_tower,
                                             attn_impl="pallas"),
        text_tower=dataclasses.replace(cfg.text_tower, attn_impl="pallas"))
    rng = np.random.default_rng(1234)
    labels = rng.integers(0, world.n_classes, EVAL_IMAGES)
    images = render_images(world, labels, rng)
    dev = torch.device("cuda")

    def enc_i(im):
        with torch.inference_mode():
            return de.encode_image(cfg, params, {
                "image": torch.from_numpy(im).to(dev)}, precision="f32")

    def enc_t(tx):
        with torch.inference_mode():
            return de.encode_text(cfg, params, {
                k: torch.from_numpy(v).to(dev) for k, v in tx.items()},
                precision="f32")

    t0 = time.perf_counter()
    bench, launches["evaluate_benchmark"] = counted(
        lambda: evaluate_benchmark(enc_i, enc_t, tok, world.class_names,
                                   images, labels))
    bench_s = time.perf_counter() - t0
    require_launches("evaluate_benchmark", launches["evaluate_benchmark"],
                     (fa,), (tk,))
    with ZeroShotService(cfg, params, tok, device="cuda") as svc:
        t0 = time.perf_counter()
        served, launches["evaluate_with_service"] = counted(
            lambda: evaluate_with_service(svc, world.class_names, images,
                                          labels))
        served_s = time.perf_counter() - t0
        require_launches("evaluate_with_service",
                         launches["evaluate_with_service"], (fa, tk))
        res = svc.classify(images, world.class_names, k=5)
    with torch.inference_mode():
        cemb = class_embeddings(enc_t, tok, world.class_names)
        pred, logits = classify(enc_i(images), cemb)
    top2 = torch.topk(logits.float(), 2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    pred = pred.cpu().numpy()
    near = gap <= EVAL_GAP
    disagree = (pred != res.indices[:, 0]) & ~near
    print(f"recipe evaluation ({EVAL_IMAGES} fresh images, 64 classes x 4 "
          f"templates): evaluate_benchmark {bench_s:.3f}s top1 "
          f"{bench['top1']:.4f} top5 {bench['top5']:.4f} mean per-class "
          f"recall {bench['mean_per_class_recall']:.4f}; "
          f"evaluate_with_service {served_s:.3f}s top1 {served['top1']:.4f} "
          f"top5 {served['top5']:.4f} mean per-class recall "
          f"{served['mean_per_class_recall']:.4f}; chance "
          f"{1 / world.n_classes:.4f}; {int(near.sum())} rows with a top-2 "
          f"gap <= {EVAL_GAP}; {int(disagree.sum())} other rows disagree",
          flush=True)
    if disagree.any() or not bench["n"] == served["n"] == EVAL_IMAGES:
        raise AssertionError("recipe evaluation: the benchmark row and the "
                             "served row disagree beyond near-ties")
    if abs(bench["top1"] - served["top1"]) > near.sum() / EVAL_IMAGES:
        raise AssertionError("recipe evaluation: top-1 rates differ by more "
                             "than the near-tie rows")
    del params
    torch.cuda.empty_cache()

    (table, launches["zero_shot_table"]) = counted(
        lambda: zero_shot_table.run("cuda"))
    for line in zero_shot_table.csv_lines(table):
        print(f"recipe zero-shot table (card): {line}", flush=True)
    for name in ("seen", "unseen_openvocab", "shifted_robustness"):
        if not 0.0 <= table[name] <= 1.0:
            raise AssertionError(f"zero-shot table: bad {name} {table}")
    require_launches("zero-shot table", launches["zero_shot_table"],
                     (fa, fb), (tk,))
    out = {"pretrain": pre, "frozen": p2, "finetune": p3, "bench": bench,
           "served": served, "near_ties": int(near.sum()),
           "frozen_err": frozen_err, "table": table}
    return launches, out


# ---------------------------------------------------------------------------
# phase 12: the paper's §4.2 moment accumulation at the training shape
# ---------------------------------------------------------------------------


def phase_moment_accum(batch_size: int = 256, num_micro: int = 2):
    """One f32 step of BASIC-S (full width and depth, the kernel path) from
    ``microbatch_grads`` + ``update_from_microbatches`` against
    ``contrastive_step`` + ``update``: mean_K(c) against the gradient at
    TRAIN_GRAD_RTOL, the first moment exact (``store_m_bf16=False``), and
    peak memory of both, printed side by side."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.core import remat as remat_lib
    from repro_torch.core.contrastive import fused_kernel_loss
    from repro_torch.core.gradaccum import contrastive_step, microbatch_grads
    from repro_torch.data import (contrastive_batch, load_tokenizer,
                                  world_for_tower)
    from repro_torch.launch.train import batch_to
    from repro_torch.models import dual_encoder as de
    from repro_torch.optim import AdaFactorW
    from repro_torch.tree import tree_map

    cfg = get_arch("basic-s")
    cfg = dataclasses.replace(
        cfg, image_tower=dataclasses.replace(cfg.image_tower,
                                             attn_impl="pallas"),
        text_tower=dataclasses.replace(cfg.text_tower, attn_impl="pallas"))
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, cfg.image_tower, n_classes=64)
    batch = batch_to(contrastive_batch(world, load_tokenizer(), batch_size,
                                       rng)[0], "cuda")
    params = interop.init_params(cfg, torch.Generator().manual_seed(1),
                                 "cuda")
    policy = remat_lib.get_policy("basic")

    def enc_i(p, im):
        return de.encode_image(cfg, p, im, precision="f32",
                               remat_policy=policy)

    def enc_t(p, tx):
        return de.encode_text(cfg, p, tx, precision="f32",
                              remat_policy=policy)

    opt = AdaFactorW(beta1=0.9, beta2=0.99, weight_decay=0.0025,
                     store_m_bf16=False)
    lr = 2.5e-4
    peak = {}

    def measured(label, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peak[label] = torch.cuda.max_memory_allocated() - base
        return out

    def plain_step():
        _, _, g = contrastive_step(enc_i, enc_t, params, batch, num_micro,
                                   loss_fn=fused_kernel_loss)
        opt.update(g, opt.init(params), params, lr)
        return tree_map(lambda x: x.cpu(), g)

    def streamed_step():
        _, _, c = microbatch_grads(enc_i, enc_t, params, batch, num_micro,
                                   loss_fn=fused_kernel_loss)
        _, st = opt.update_from_microbatches(c, opt.init(params), params, lr)
        return tree_map(lambda x: x.mean(dim=0), c), st.m

    g = measured("contrastive_step + update", plain_step)
    mean, m_mb = measured("microbatch_grads + update_from_microbatches",
                          streamed_step)
    gm, gf = dict(interop.leaves(mean)), dict(interop.leaves(g))
    grad_rel = {k: ((gm[k] - gf[k].to(gm[k].device)).abs().max()
                    / gf[k].abs().max().clamp(min=1e-30)).item() for k in gf}
    worst = max(grad_rel, key=grad_rel.get)
    del g, gf
    _, st_ref = opt.update(mean, opt.init(params), params, lr)
    m_rel = 0.0
    for (path, a), (_, b) in zip(interop.leaves(m_mb),
                                 interop.leaves(st_ref.m)):
        m_rel = max(m_rel, ((a - b).abs().max()
                            / b.abs().max().clamp(min=1e-30)).item())
    print(f"moment accumulation (BASIC-S f32, B={batch_size}, {num_micro} "
          f"microbatches, kernel path): mean_K(c) vs contrastive_step's "
          f"gradient, largest relative error {grad_rel[worst]:.3g} at "
          f"{worst} (tol {TRAIN_GRAD_RTOL}); first moment of "
          f"update_from_microbatches vs update on mean_K(c), largest "
          f"relative error {m_rel:.3g} (tol {MOMENT_M_RTOL}); peak memory "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peak.items())
          + " (above the params and the batch)", flush=True)
    if not (grad_rel[worst] <= TRAIN_GRAD_RTOL and m_rel <= MOMENT_M_RTOL):
        raise AssertionError("moment accumulation: beyond the stated "
                             "tolerances")
    return {"grad_rel_err": grad_rel[worst], "m_rel_err": m_rel,
            "peak_bytes": peak}


# ---------------------------------------------------------------------------
# phase 13: split-K decode attention
# ---------------------------------------------------------------------------


def dec_limit(ref):
    """Per-element limit on |kernel − plain| for a decode_attention
    output."""
    import torch
    if ref.dtype != torch.bfloat16:
        return DEC_TOL_F32
    r = ref.float().abs()
    return DEC_BF16_ULPS * BF16_ULP * r + DEC_BF16_REL_MAX * r.max()


def decode_inputs(b, h, kv, t, d, dtype, seed):
    """(q, k, v) for one decode call, N(0, 1) in ``dtype``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, kv, t, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def decode_check(label, q, k, v, valid):
    """Kernel vs plain version on one call; returns the max abs error."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    got = dec_ops.decode_attention(q, k, v, valid)
    ref = decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    if not bool((err <= dec_limit(ref)).all()):
        raise AssertionError(f"decode_attention {label}: max abs err "
                             f"{err.max().item():.3g}")
    return got, err.max().item()


def decode_timed(state, q, k, v, lens, err):
    """The decode kernel at per-slot lengths ``lens``: checked against its
    plain version, then kernel (between events, and its device time from
    the profiler), plain version and SDPA timed, with the bound counted by
    the valid entries and by the full sweep. Returns the record (its
    ``max_abs_err`` the larger of ``err`` and this call's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    b, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    dt = dtype_name(q.dtype)
    item = torch.finfo(q.dtype).bits // 8
    # q, out, the bool mask and every cache entry
    full_ms, full_by = bound(*decode_work(b, h, kv, t, d, item), dt)
    valid = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    _, e = decode_check(f"{state} {dt}", q, k, v, valid)
    call = lambda: dec_ops.decode_attention(q, k, v, valid)
    q4 = q[:, :, None, :]
    mask4 = valid[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask4, enable_gqa=True)
    ms = time_ms(call)
    dev_ms, per_call = device_ms(call, WRAPPER_KERNELS["decode_attention"])
    plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, valid))
    lib_ms = time_ms(library)
    lib_dev_ms, _ = device_ms(library)
    n_valid = int(lens.sum())
    bound_ms, bound_by = bound(
        *decode_work(b, h, kv, t, d, item, n_valid), dt)
    plan = dec_ops.launch_plan(q, k)
    rec = {"shape": f"b={b} h={h} kv={kv} t={t} d={d} {dt}, {state}: "
                    f"{n_valid} valid entries",
           "plan": plan._asdict(), "max_abs_err": max(err, e),
           "ms": ms, "device_ms": dev_ms,
           "device_kernels_per_call": per_call, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_full_sweep_ms": full_ms,
           "bound_full_sweep_by": full_by}
    print(f"decode_attention {rec['shape']}: plan "
          f"{plan._asdict()}; kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms, {per_call:g} device kernels per call), "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f} ms), bound {bound_ms:.4f} ms "
          f"({bound_by}: q, out, mask and the valid k/v entries), "
          f"full-sweep bound {full_ms:.4f} ms ({full_by})",
          flush=True)
    return rec


def phase_decode_kernel():
    """The decode kernel at the timed path's shape (b 8 slots, kv 8, g 4,
    d 64, t 8192), one lockstep request (b 1), d 128 with g 8, and g 1, f32
    and bf16: per-slot lengths 0, 1, 255, 256, 257 (whole dead chunks and
    units), ragged and t (length 0 exactly zero), a shared mask bit-equal
    to equal per-slot rows, stale entries that change nothing, a row's
    result independent of its batch; at the serving state (~7% valid) and
    at a full cache, times kernel (between events, and its device time
    from the profiler), plain version and SDPA, with the bound counted by
    the valid entries and by the full sweep. Returns records keyed by
    (dtype, state) and the max errors by dtype."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    b, h, kv, t, d = 8, 32, 8, 8192, 64
    recs, errs = {}, {}
    ar = torch.arange(t, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dt = dtype_name(dtype)
        q, k, v = decode_inputs(b, h, kv, t, d, dtype, 40)
        lens = torch.tensor([0, 1, 255, 256, 257, t, 3001, t - 5],
                            device="cuda")
        valid = ar[None, :] < lens[:, None]
        out, err = decode_check(f"b={b} ragged {dt}", q, k, v, valid)
        if not bool((out[0] == 0).all()):
            raise AssertionError("decode_attention: a length-0 row is not "
                                 "exactly zero")
        keep = valid[:, None, :, None]
        stale = torch.full((), 1e6, dtype=dtype, device="cuda")
        dirty = dec_ops.decode_attention(q, torch.where(keep, k, stale),
                                         torch.where(keep, v, stale), valid)
        if not torch.equal(out, dirty):
            raise AssertionError("decode_attention: stale entries moved the "
                                 "output")
        shared = ar < 4000
        a = dec_ops.decode_attention(q, k, v, shared)
        rows = dec_ops.decode_attention(q, k, v, shared[None].expand(b, t))
        if not torch.equal(a, rows):
            raise AssertionError("decode_attention: a shared mask and equal "
                                 "per-slot rows differ")
        _, e = decode_check(f"shared {dt}", q, k, v, shared)
        err = max(err, e)
        alone = dec_ops.decode_attention(q[3:4].contiguous(), k[3:4],
                                         v[3:4], valid[3:4])
        if not torch.equal(alone[0], out[3]):
            raise AssertionError("decode_attention: a row's result depends "
                                 "on its batch")
        for label, shape in (("b=1", (1, h, kv, t, d)),
                             ("d=128", (2, 16, 2, 3000, 128)),
                             ("g=1", (2, 8, 8, 1000, 64))):
            q1, k1, v1 = decode_inputs(*shape, dtype, 41)
            n = shape[3]
            lens1 = torch.tensor([n - 7, 1][:shape[0]], device="cuda")
            _, e = decode_check(f"{label} {dt}", q1, k1, v1,
                                torch.arange(n, device="cuda")[None, :]
                                < lens1[:, None])
            err = max(err, e)
        errs[dt] = err
        # timed at the serving state (8 slots ~512 prompt tokens + up to 64
        # generated: ~7% of the 8192 entries are valid) and at a full cache
        # (a ring that has wrapped: every entry valid)
        for state, lens in (
                ("serving", torch.tensor([508 + 9 * i for i in range(b)],
                                         device="cuda")),
                ("full", torch.full((b,), t, device="cuda"))):
            recs[(dt, state)] = decode_timed(state, q, k, v, lens, err)
        print(f"decode_attention {dt}: max err {err:.3g} (lengths 0, 1, "
              f"255, 256, 257, ragged, t; shared mask; b=1; d=128, g 8; "
              f"g 1; full cache); length 0 exactly 0, shared mask "
              f"bit-equal, stale entries no change, row independent of its "
              f"batch", flush=True)
    return recs, errs


def phase_prefill_flash():
    """The flash forward at the decode path's prefill shape: b 1, 32
    heads over 8 kv, s 512, causal, window 8192, bf16 (the timed run) and
    f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    h, kv, s, d = 32, 8, 512, 64
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = dtype_name(dtype)
        g = torch.Generator(device="cuda").manual_seed(50)
        q = torch.randn((h, s, d), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((kv, s, d), generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        out, lse = fa_ops.flash_fwd(q, k, v, causal=True, window=8192)
        ref_out, ref_lse = flash_fwd_ref(q, k, v, causal=True, window=8192)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        err = max(err_out, err_lse)
        if not (err_out <= FLASH_TOL[dt]
                and err_lse <= FLASH_TOL["float32"]):
            raise AssertionError(f"flash_fwd prefill {dt}: max |out err| "
                                 f"{err_out:.3g}, max |lse err| "
                                 f"{err_lse:.3g}")

        def call():
            fa_ops.flash_fwd(q, k, v, causal=True, window=8192)
        ms = time_ms(call)
        dev_ms, _ = device_ms(call, WRAPPER_KERNELS["flash_fwd"])
        plain_ms = time_ms(lambda: flash_fwd_ref(q, k, v, causal=True,
                                                 window=8192))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, enable_gqa=True))
        item = torch.finfo(dtype).bits // 8
        bound_ms, bound_by = bound(
            *flash_fwd_work(h, kv, s, s, d, item, causal=True, window=8192),
            dt, flash_peak(dt))
        plan = tuple(fa_ops.fwd_plan(h, s, s, d, dtype))
        recs[dt] = {"shape": f"prefill bh={h} kv={kv} s={s} d={d} causal "
                             f"window=8192 {dt}", "max_abs_err": err,
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "plan": plan}
        print(f"flash_fwd {recs[dt]['shape']}: plan {plan}; err out "
              f"{err_out:.3g} (tol {FLASH_TOL[dt]}) lse {err_lse:.3g} (tol "
              f"{FLASH_TOL['float32']}); kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return recs


# ---------------------------------------------------------------------------
# phase 14: decode parity, kernel path vs plain path
# ---------------------------------------------------------------------------


def top2_gap(logits):
    """(rows,) gap between each row's two largest logits."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def parity_case(label, cfg, params, toks, plen, clen, steps):
    """Prefill ``toks[:, :plen]`` and decode ``steps`` tokens on the kernel
    path and the plain path, both fed the kernel path's greedy token;
    returns (max |logit diff|, greedy flips where the plain top-2 gap
    exceeds the tolerance, steps compared)."""
    import torch
    from repro_torch.models import transformer as tf
    paths = {"kernel": dataclasses.replace(cfg, attn_impl="pallas"),
             "plain": dataclasses.replace(cfg, attn_impl="chunked")}
    batch = {"tokens": toks[:, :plen]}
    state = {}
    t0 = time.perf_counter()
    for name, pcfg in paths.items():
        state[name] = tf.prefill(pcfg, params, batch, precision="f32",
                                 collect_cache_len=clen)
    worst, flips, compared = 0.0, 0, 0
    for i in range(steps + 1):
        lk, lp = (state[n][0][:, 0] for n in paths)
        worst = max(worst, (lk - lp).abs().max().item())
        tok = lk.argmax(-1)
        sep = top2_gap(lp) > DEC_PARITY_TOL
        flips += int(((tok != lp.argmax(-1)) & sep).sum())
        compared += tok.numel()
        if i == steps:
            break
        for name, pcfg in paths.items():
            state[name] = tf.decode_step(pcfg, params, tok[:, None],
                                         plen + i, state[name][1],
                                         precision="f32")
    torch.cuda.synchronize()
    print(f"decode parity {label}: max |logit diff| kernel vs plain "
          f"{worst:.3g} (tol {DEC_PARITY_TOL}) over prefill + {steps} "
          f"steps; greedy tokens that differ where the plain top-2 gap "
          f"exceeds the tol: {flips} of {compared}; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if not (worst <= DEC_PARITY_TOL and flips == 0):
        raise AssertionError(f"decode parity {label}: kernel path and plain "
                             f"path disagree")
    return worst, flips


def engines_case(kcfg, params, lens, plain_logits, moe_args=None):
    """The continuous engine (4 slots, 8 ragged requests of ``lens``
    tokens, greedy) against the lockstep engine run alone per request,
    both on the kernel path (``kcfg``), f32, with ``moe_args``. Where they
    diverge, the plain path's top-2 gap at that token
    (``plain_logits(tokens)`` -> (1, vocab)) must be under the parity
    tolerance. Each engine must launch the decode kernel once per
    attention layer per decode step (none for an attention-free
    model)."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.serving import ContinuousEngine, Engine
    rng = np.random.default_rng(7)
    budgets = [12, 16, 8, 16, 10, 16, 6, 14]
    prompts = [rng.integers(4, kcfg.vocab, (n,)).astype(np.int32)
               for n in lens]
    reqs = [(p, m, i) for i, (p, m) in enumerate(zip(prompts, budgets))]
    ce = ContinuousEngine(kcfg, params, cache_len=1024, num_slots=4,
                          moe_args=moe_args)
    dec_ops.COUNTER.reset()
    got = ce.run(reqs)
    per_step = {"continuous": dec_ops.COUNTER.count / len(ce.step_log)}
    eng = Engine(kcfg, params, cache_len=1024, moe_args=moe_args)
    same, divergences = 0, []
    launches = steps = 0
    for p, m, i in reqs:
        before = dec_ops.COUNTER.count
        row = eng.generate(p[None, :], m, temperature=0.0)[0]
        launches += dec_ops.COUNTER.count - before
        stop = np.nonzero(row == eng.eos_id)[0]
        want = row[:int(stop[0]) + 1] if stop.size else row
        steps += want.size - 1           # a decode step after each token
        if np.array_equal(got[i], want):
            same += 1
            continue
        n = min(got[i].size, want.size)
        diff = np.nonzero(got[i][:n] != want[:n])[0]
        j = int(diff[0]) if diff.size else n
        seq = np.concatenate([p, want[:j]])[None, :]
        with torch.no_grad():
            lp = plain_logits(torch.from_numpy(seq).cuda())
        gap = top2_gap(lp).item()
        divergences.append((i, j, gap))
        print(f"engines: request {i} first differs at token {j}: continuous "
              f"{got[i][j:j + 1].tolist()} lockstep {want[j:j + 1].tolist()}"
              f"; plain top-2 gap there {gap:.3g} (tol {DEC_PARITY_TOL})",
              flush=True)
    per_step["lockstep"] = launches / steps
    print(f"engines ({kcfg.name} f32, kernel path, 4 slots, 8 requests): "
          f"{same} of {len(reqs)} requests equal Engine.generate alone; "
          f"decode_attention launches per decode step {per_step}",
          flush=True)
    want = kcfg.layer_kinds().count("attn")
    for engine, n in per_step.items():
        if n != want:
            raise AssertionError(f"engines: the {engine} engine launched "
                                 f"decode_attention {n} times per step, "
                                 f"want {want}")
    if any(gap > DEC_PARITY_TOL for _, _, gap in divergences):
        raise AssertionError("continuous and lockstep engines diverge away "
                             "from a near-tie")
    return {"same": same, "requests": len(reqs), "divergences": divergences,
            "decode_attention_per_step": per_step}


def phase_decode_parity():
    """Llama-3.2-1B at full width and depth, f32, random weights from a
    CUDA generator: (a) 4 prompts of 512 with a linear cache of 1024 and
    16 steps; (b) one prompt of 8704 = 17·512 with a ring of 8192 (wrapped
    at prefill, wrapping on) and 16 steps; then the engines."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = get_arch("llama3.2-1b")
    t0 = time.perf_counter()
    params = interop.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in interop.leaves(params))
    print(f"decode parity: llama3.2-1b, {n} params, init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    with torch.no_grad():
        toks = torch.randint(4, cfg.vocab, (4, 512), generator=g,
                             device="cuda")
        out["linear"] = parity_case("(a) 4 x 512, linear cache 1024", cfg,
                                    params, toks, 512, 1024, 16)
        toks = torch.randint(4, cfg.vocab, (1, 8704), generator=g,
                             device="cuda")
        out["ring"] = parity_case("(b) 1 x 8704, ring 8192", cfg, params,
                                  toks, 8704, 8192, 16)
        pcfg = dataclasses.replace(cfg, attn_impl="chunked")
        out["engines"] = engines_case(
            dataclasses.replace(cfg, attn_impl="pallas"), params,
            [100, 37, 250, 64, 180, 12, 300, 90],
            lambda seq: tf.prefill(pcfg, params, {"tokens": seq},
                                   precision="f32")[:, 0])
    return out


# ---------------------------------------------------------------------------
# phase 15: timed decode serving through the launcher
# ---------------------------------------------------------------------------

DECODE_SLO_MS = 60000               # phase 15's request SLO (submit to finish)
SERVE_ARGV = ["--arch", "llama3.2-1b", "--engine", "continuous", "--slots",
              "8", "--requests", "16", "--arrival", "0", "--prompt-len",
              "512", "--max-new", "64", "--cache-len", "8192", "--attn",
              "pallas", "--precision", "bf16", "--temperature", "0",
              "--seed", "0"]


def phase_decode_serve():
    """``repro_torch.launch.serve.main`` at full width and depth after one
    untimed warm-up request; returns (launches, per prefill / per step,
    report)."""
    import math
    import numpy as np
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve

    warm = list(SERVE_ARGV)
    warm[warm.index("--requests") + 1] = "1"
    warm[warm.index("--max-new") + 1] = "4"
    serve.main(warm)
    counters = (fa_ops.COUNTER, dec_ops.COUNTER)
    for ctr in counters:
        ctr.reset()
    rep = serve.main(SERVE_ARGV + ["--slo-ms", str(DECODE_SLO_MS)])
    launches = {ctr.name: ctr.count for ctr in counters}
    per = {"flash_fwd_per_prefill": launches["flash_fwd"] / rep["prefills"],
           "decode_attention_per_step": (launches["decode_attention"]
                                         / rep["decode_steps"])}
    print(f"decode serve (llama3.2-1b bf16, 8 slots, 16 requests x ~512 "
          f"prompt tokens x 64 new, ring 8192): decode "
          f"{rep['decode_tokens_per_s']:.1f} tok/s over the warm steps, "
          f"{rep['tokens_per_s']:.1f} tok/s over the run (prefill "
          f"included); step median {rep['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{rep['step_p90_s'] * 1e3:.3f} ms over {rep['decode_steps']} "
          f"steps; prefill {rep['prefill_mean_s'] * 1e3:.3f} ms per request; "
          f"max_memory_allocated {rep['max_memory_allocated'] / 2**30:.3f} "
          f"GiB", flush=True)
    print(f"decode serve launches: {launches} over {rep['prefills']} "
          f"prefills and {rep['decode_steps']} steps: {per}", flush=True)
    for name, want in (("flash_fwd_per_prefill", 16),
                       ("decode_attention_per_step", 16)):
        if per[name] != want:
            raise AssertionError(f"decode serve: {name} {per[name]}, want "
                                 f"{want} (one per layer)")
    for rid, r in rep["results"].items():
        in_vocab = bool(np.all((r >= 0) & (r < 128256)))
        if not (in_vocab and (r.size == 64 or r[-1] == 3)):
            raise AssertionError(f"decode serve: bad tokens for request "
                                 f"{rid}: {r}")
    if rep["requests"] != 16:
        raise AssertionError(f"decode serve: {rep['requests']} of 16 "
                             f"requests finished")
    slo = rep["slo"]
    series = rep["engine"].registry.snapshot()["gauges"]
    print(f"decode serve SLO ({DECODE_SLO_MS} ms a request, submit to "
          f"finish): p99 {slo['p99_s'] * 1e3:.3f} ms over "
          f"{slo['requests']} requests, {slo['violations']} violations, "
          f"burn {slo['error_budget_burn']:.3f}, ready {slo['healthy']}; "
          f"decode/slo_* gauges "
          f"{ {k: v for k, v in series.items() if '/slo_' in k} }",
          flush=True)
    if slo["requests"] != 16 or "decode/slo_ready" not in series:
        raise AssertionError(f"decode serve: SLO tracker saw {slo}")
    if not math.isfinite(rep["decode_tokens_per_s"]):
        raise AssertionError("decode serve: no throughput")
    return launches, per, rep


@contextlib.contextmanager
def spans(targets):
    """Within the block, each function of ``targets`` (label -> (module,
    function name)) runs inside ``torch.profiler.record_function(label)``,
    so that a profile can sum the device time of the kernels it
    launched."""
    import torch
    saved = []
    for label, (mod, name) in targets.items():
        real = getattr(mod, name)

        def wrapped(*args, _real=real, _label=label, **kwargs):
            with torch.profiler.record_function(_label):
                return _real(*args, **kwargs)
        saved.append((mod, name, real))
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def phase_decode_profile(eng, steps: int = 4, prompt_len: int = 512,
                         counters=None, groups=KERNEL_GROUPS, ops=(),
                         labelled=None):
    """A torch.profiler window over ``steps`` warm decode steps of the
    timed run's engine with all its slots busy (prompts of ``prompt_len``
    tokens): device busy share, time by kernel group (``groups``), by the
    aten ops in ``ops`` and by the functions in ``labelled`` (``spans``:
    the device time of the kernels each launched), device kernels per call
    of each wrapper in ``counters`` (default: decode_attention)."""
    import numpy as np
    import torch
    if counters is None:
        from repro_torch.kernels.decode_attention import ops as dec_ops
        counters = (dec_ops.COUNTER,)
    rng = np.random.default_rng(9)
    for i in range(eng.num_slots):                # busy through 8 windows
        eng.submit(rng.integers(4, eng.cfg.vocab, (prompt_len,)).astype(
            np.int32), 8 * steps + 4)
    eng.step()                        # admits every slot, then one step
    eng.step()
    with spans(labelled or {}):
        prof, wall_us, calls = counted_window(
            lambda: [eng.step() for _ in range(steps)], counters)
    if labelled:
        by_label = span_device_ms(prof, labelled, steps)
        print("profile by function (device time of the kernels each "
              "launched): " + "; ".join(
                  f"{label} not measured" if ms is None
                  else f"{label} {ms:.3f} ms/step"
                  for label, ms in by_label.items()), flush=True)
    # where the host's time goes: its launch count and its costliest ops
    host = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda e: -e.self_cpu_time_total)
    launch = [e for e in host if e.key == "cudaLaunchKernel"]
    print(f"profile {steps} warm decode steps: host cudaLaunchKernel "
          f"{launch[0].count / steps if launch else 0:.1f} calls per step; "
          f"host ops by self time per step:", flush=True)
    for e in host[:10]:
        print(f"  {e.self_cpu_time_total / 1e3 / steps:9.4f} ms/step  "
              f"{e.count / steps:7.1f} calls/step  {e.key[:70]}", flush=True)
    if ops:
        op_device_ms(prof, ops, steps, "step")
    return device_breakdown(prof, f"{steps} warm decode steps", wall_us,
                            steps, calls, groups)


# ---------------------------------------------------------------------------
# phase 16: the SSD chunked scan
# ---------------------------------------------------------------------------


def plain_scan(x, dt, A, Bm, Cm, D=None, *, chunk, init_state=None):
    """The scan's plain version with the wrapper's signature: what the
    plain path runs in place of the kernel on the card."""
    from repro_torch.kernels.ssd_scan.ref import chunk_of, ssd_chunked
    return ssd_chunked(x, dt, A, Bm, Cm, chunk_of(x.shape[1], chunk),
                       init_state, D)


def ssd_inputs(b, l, dtype, seed, init=False, extreme=False, h=24, p=64,
               n=128):
    """(x, dt, A, Bm, Cm, D, init_state) at Mamba-2-130M's widths, x, B
    and C as split views of one (b, l, h·p + 2n) buffer as the mixer
    passes them; dt softplus'd, A = -exp(N(0, 0.3²)) (or, ``extreme``,
    dt 3 and A alternating -5 and -0.001)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn((b, l, h * p + 2 * n), generator=g,
                      device="cuda").to(dtype)
    x = buf[..., :h * p].reshape(b, l, h, p)
    Bm, Cm = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    dt = F.softplus(torch.randn((b, l, h), generator=g, device="cuda"))
    A = -torch.exp(0.3 * torch.randn((h,), generator=g, device="cuda"))
    if extreme:
        dt = torch.full((b, l, h), 3.0, device="cuda")
        A = torch.tensor([-5.0, -0.001] * (h // 2), device="cuda")
    D = torch.rand((h,), generator=g, device="cuda")
    s0 = (torch.randn((b, h, p, n), generator=g, device="cuda") if init
          else None)
    return x, dt, A, Bm, Cm, D, s0


def ssd_case(label, b, l, dtype, seed, init=False, extreme=False,
             timed=True, h=24, p=64, n=128):
    """Kernel vs plain version at one shape (``h`` heads of ``p``, state
    ``n``; Mamba-2-130M's by default): y and the final state within
    ``SSD_TOL_REL`` of their max |value|, all finite; times both. Returns
    the case's record."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    chunk = 256
    args = ssd_inputs(b, l, dtype, seed, init, extreme, h, p, n)
    x, dt, A, Bm, Cm, D, s0 = args
    y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, init_state=s0)
    yr, fr = plain_scan(x, dt, A, Bm, Cm, D, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    dt_name = dtype_name(dtype)
    err_y = (y - yr).abs().max().item()
    err_f = (f - fr).abs().max().item()
    lim_y = SSD_TOL_REL * yr.abs().max().item()
    lim_f = SSD_TOL_REL * fr.abs().max().item()
    finite = bool(torch.isfinite(y).all() and torch.isfinite(f).all())
    if not (finite and err_y <= lim_y and err_f <= lim_f):
        raise AssertionError(f"ssd_scan {label} {dt_name}: finite {finite}, "
                             f"max |y err| {err_y:.3g} (limit {lim_y:.3g}), "
                             f"max |state err| {err_f:.3g} (limit "
                             f"{lim_f:.3g})")
    rec = {"shape": f"{label}: b={b} l={l} h={h} p={p} n={n} {dt_name}"
                    + (" init_state" if init else ""),
           "max_abs_err": max(err_y, err_f), "max_abs_err_y": err_y,
           "max_abs_err_state": err_f, "tol_y": lim_y, "tol_state": lim_f,
           "library_ms": None}
    plan = ssd_ops.ssd_plan(b, l, h, p, n, dtype)
    rec["plan"] = plan._asdict()
    if timed:
        def call():
            ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, init_state=s0)
        rec["ms"] = time_ms(call)
        rec["device_ms"], _ = device_ms(call, WRAPPER_KERNELS["ssd_scan"])
        rec["plain_ms"] = time_ms(lambda: plain_scan(
            x, dt, A, Bm, Cm, D, chunk=chunk, init_state=s0))
        item = torch.finfo(dtype).bits // 8
        # f32 products run split 3×TF32 on the tensor cores: its bound is
        # taken at that rate, which the kernel cannot beat (bf16 at the
        # bf16 peak, the fastest of its products)
        rec["bound_ms"], rec["bound_by"] = bound(
            *ssd_scan_work(b, l, h, p, n, item, init), dt_name,
            flash_peak(dt_name))
    print(f"ssd_scan {rec['shape']}: plan {tuple(plan)}; max |y err| "
          f"{err_y:.3g} (tol {lim_y:.3g}), max |state err| {err_f:.3g} (tol "
          f"{lim_f:.3g}), finite" + (
              f"; kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f}),"
              f" plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
              if timed else ""), flush=True)
    return rec


# a rank's scan under --sharding tp (H/M heads of 64, state 128 whole):
# Mamba-2-130M at M 2 on phase 43's b 2 x s 1024, at M 4 on the four-card
# probe's b 2 x s 4096, and Jamba-1.5-Large at M 4 (b 1 x s 4096)
SSD_TP_SHAPES = (("tp rank mamba2 M=2", 2, 1024, 12),
                 ("tp rank mamba2 M=4", 2, 4096, 6),
                 ("tp rank jamba M=4", 1, 4096, 64))


def phase_ssd_kernel():
    """The SSD kernel at Mamba-2-130M's shapes, f32 and bf16: one chunk
    (l 256), a ragged chunk (l 244) and four chunks (b 1 × 1024), b 8 ×
    256, with an initial state in the ragged and b 8 cases, and the
    training shape (b 2 × 4096, ``SSM_TRAIN_ARGV``'s); the decay
    extremes; a rank's shapes under ``tp`` (``SSD_TP_SHAPES``); the same
    inputs twice give the same bits. Returns the records by (label, dtype
    name)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = dtype_name(dtype)
        for label, b, l, init in (("l=256", 1, 256, False),
                                  ("l=244", 1, 244, True),
                                  ("l=1024", 1, 1024, False),
                                  ("b=8", 8, 256, True),
                                  ("train b=2 l=4096", 2, 4096, False)):
            recs[(label, dt)] = ssd_case(label, b, l, dtype, 60, init)
        recs[("extreme", dt)] = ssd_case("decay extremes dt=3 A=-5", 1, 256,
                                         dtype, 61, extreme=True,
                                         timed=False)
        for label, b, l, h in SSD_TP_SHAPES:
            recs[(label, dt)] = ssd_case(label, b, l, dtype, 63, h=h)
    args = ssd_inputs(2, 512, torch.bfloat16, 62, init=True)
    one = ssd_ops.ssd_scan(*args[:6], chunk=256, init_state=args[6])
    two = ssd_ops.ssd_scan(*args[:6], chunk=256, init_state=args[6])
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError("ssd_scan: two launches on the same inputs "
                             "differ")
    print("ssd_scan: two launches on the same inputs give the same bits",
          flush=True)
    return recs


# ---------------------------------------------------------------------------
# phase 17: SSM parity, kernel path vs plain path
# ---------------------------------------------------------------------------


def plain_path():
    """A context in which the Mamba-2 mixer runs the scan's plain version
    on the card instead of the kernel (the plain path)."""
    from unittest import mock
    from repro_torch.models import ssm as ssm_lib
    return mock.patch.object(ssm_lib, "ssd_scan", plain_scan)


def phase_ssm_parity():
    """Mamba-2-130M at full width and depth, f32, random weights from a
    CUDA generator: prefill of 2 × 1024 tokens on the kernel path and the
    plain path (logits, SSM and conv caches), 16 decode steps fed the
    kernel path's greedy token on both; then the engines."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import transformer as tf
    cfg = get_arch("mamba2-130m")
    t0 = time.perf_counter()
    params = interop.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    n = sum(p.numel() for _, p in interop.leaves(params))
    print(f"ssm parity: mamba2-130m, {n} params (analytic count "
          f"{cfg.param_counts()['total']}), init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    plen, steps = 1024, 16
    toks = torch.randint(4, cfg.vocab, (2, plen), generator=g,
                         device="cuda")
    out = {}
    with torch.no_grad():
        before = ssd_ops.COUNTER.count
        kl, kc = tf.prefill(cfg, params, {"tokens": toks}, precision="f32",
                            collect_cache_len=2048)
        if ssd_ops.COUNTER.count - before != cfg.n_layers:
            raise AssertionError("ssm parity: the kernel path did not launch "
                                 "ssd_scan once per layer")
        with plain_path():
            pl, pc = tf.prefill(cfg, params, {"tokens": toks},
                                precision="f32", collect_cache_len=2048)
        if ssd_ops.COUNTER.count - before != cfg.n_layers:
            raise AssertionError("ssm parity: the plain path launched the "
                                 "kernel")
        cache_err = {}
        for leaf in ("ssm", "conv"):
            a, b = getattr(kc[0], leaf), getattr(pc[0], leaf)
            cache_err[leaf] = (a - b).abs().max().item()
            lim = SSM_PARITY_TOL * b.abs().max().item()
            if not cache_err[leaf] <= lim:
                raise AssertionError(f"ssm parity: {leaf} cache max err "
                                     f"{cache_err[leaf]:.3g} > {lim:.3g}")
        worst, flips, compared = 0.0, 0, 0
        lk, lp = kl[:, 0], pl[:, 0]
        for i in range(steps + 1):
            worst = max(worst, (lk - lp).abs().max().item())
            tok = lk.argmax(-1)
            sep = top2_gap(lp) > SSM_PARITY_TOL
            flips += int(((tok != lp.argmax(-1)) & sep).sum())
            compared += tok.numel()
            if i == steps:
                break
            lk = tf.decode_step(cfg, params, tok[:, None], plen + i, kc,
                                precision="f32")[0][:, 0]
            lp = tf.decode_step(cfg, params, tok[:, None], plen + i, pc,
                                precision="f32")[0][:, 0]
        torch.cuda.synchronize()
        print(f"ssm parity (2 x {plen}, f32): max |logit diff| kernel vs "
              f"plain {worst:.3g} (tol {SSM_PARITY_TOL}) over prefill + "
              f"{steps} steps; caches max err ssm {cache_err['ssm']:.3g}, "
              f"conv {cache_err['conv']:.3g} (tol {SSM_PARITY_TOL} of max "
              f"|value|); greedy tokens that differ where the plain top-2 "
              f"gap exceeds the tol: {flips} of {compared}", flush=True)
        if not (worst <= SSM_PARITY_TOL and flips == 0):
            raise AssertionError("ssm parity: kernel path and plain path "
                                 "disagree")
        out.update(max_logit_diff=worst, cache_err=cache_err, flips=flips)

        def plain_logits(seq):
            with plain_path():
                return tf.prefill(cfg, params, {"tokens": seq},
                                  precision="f32")[:, 0]

        out["engines"] = engines_case(cfg, params,
                                      [100, 37, 250, 64, 180, 12, 512, 90],
                                      plain_logits)
    return out


# ---------------------------------------------------------------------------
# phase 18: timed SSM serving through the launcher
# ---------------------------------------------------------------------------

SSM_SERVE_ARGV = ["--arch", "mamba2-130m", "--engine", "continuous",
                  "--slots", "8", "--requests", "16", "--arrival", "0",
                  "--prompt-len", "248", "--max-new", "64", "--cache-len",
                  "512", "--precision", "bf16", "--temperature", "0",
                  "--seed", "0"]


def phase_ssm_serve():
    """``repro_torch.launch.serve.main`` on Mamba-2-130M after one untimed
    warm-up request; returns (launches, per prefill, report)."""
    import math
    import numpy as np
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve

    warm = list(SSM_SERVE_ARGV)
    warm[warm.index("--requests") + 1] = "1"
    warm[warm.index("--max-new") + 1] = "4"
    serve.main(warm)
    ssd_ops.COUNTER.reset()
    rep = serve.main(SSM_SERVE_ARGV)
    launches = {ssd_ops.COUNTER.name: ssd_ops.COUNTER.count}
    per_prefill = launches["ssd_scan"] / rep["prefills"]
    print(f"ssm serve (mamba2-130m bf16, 8 slots, 16 requests x 244-256 "
          f"prompt tokens x 64 new): decode "
          f"{rep['decode_tokens_per_s']:.1f} tok/s over the warm steps, "
          f"{rep['tokens_per_s']:.1f} tok/s over the run (prefill "
          f"included); step median {rep['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{rep['step_p90_s'] * 1e3:.3f} ms over {rep['decode_steps']} "
          f"steps; prefill {rep['prefill_mean_s'] * 1e3:.3f} ms per request; "
          f"max_memory_allocated {rep['max_memory_allocated'] / 2**30:.3f} "
          f"GiB", flush=True)
    print(f"ssm serve launches: {launches} over {rep['prefills']} prefills "
          f"and {rep['decode_steps']} steps: {per_prefill} ssd_scan per "
          f"prefill", flush=True)
    if per_prefill != 24:
        raise AssertionError(f"ssm serve: {per_prefill} ssd_scan launches "
                             f"per prefill, want 24 (one per layer)")
    for rid, r in rep["results"].items():
        in_vocab = bool(np.all((r >= 0) & (r < 50280)))
        if not (in_vocab and (r.size == 64 or r[-1] == 3)):
            raise AssertionError(f"ssm serve: bad tokens for request {rid}: "
                                 f"{r}")
    if rep["requests"] != 16:
        raise AssertionError(f"ssm serve: {rep['requests']} of 16 requests "
                             f"finished")
    if not math.isfinite(rep["decode_tokens_per_s"]):
        raise AssertionError("ssm serve: no throughput")
    return launches, per_prefill, rep


def phase_ssm_prefill_profile(eng):
    """A torch.profiler window over one warm b = 1 prefill of 248 tokens
    through the timed run's engine: device time by kernel group and the
    device kernels per ssd_scan call."""
    import numpy as np
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    prompt = np.random.default_rng(10).integers(
        4, eng.cfg.vocab, (248,)).astype(np.int32)
    with torch.no_grad():
        eng._prefill(prompt)
        prof, wall_us, calls = counted_window(lambda: eng._prefill(prompt),
                                              (ssd_ops.COUNTER,))
    return device_breakdown(prof, "1 warm prefill", wall_us, 1, calls)


# ---------------------------------------------------------------------------
# phases 19-22: LM training (--mode lm), checkpoints, the registry's disk
# cache, and the paths the card refuses
# ---------------------------------------------------------------------------

# Llama-3.2-1B's attention at the timed run's shape: b 4 × s 1024, 32 query
# heads over 8 kv heads, d 64, causal, the window (8192) past the sequence
LM_ATTN = dict(b=4, h=32, kv=8, s=1024, d=64, causal=True, window=8192)
LM_ARGV = ["--mode", "lm", "--arch", "llama3.2-1b", "--batch", "4",
           "--seq", "1024", "--steps", "4", "--seed", "0"]


def phase_lm_flash():
    """The flash kernels at the LM training shape, forward and backward,
    f32 and bf16, against their plain versions; timed against SDPA with
    ``enable_gqa``. Returns the records by (direction, dtype)."""
    import torch
    a = LM_ATTN
    recs = {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        recs[("fwd", dtype)] = flash_case(
            "lm", a["b"], a["h"], a["s"], a["d"], dtype, False, 60 + i,
            kv=a["kv"], causal=a["causal"], window=a["window"])
        recs[("bwd", dtype)] = flash_bwd_case(
            "lm", a["b"], a["h"], a["s"], a["d"], dtype, False, 62 + i,
            causal=a["causal"], window=a["window"], kv=a["kv"])
    return recs


def lm_counters():
    """The flash forward and backward launch counters."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return (fa_ops.COUNTER, fa_ops.BWD_COUNTER)


def phase_lm_parity(batch: int = 2, seq: int = 512, lr: float = 1e-3):
    """One f32 step of Llama-3.2-1B at full width and depth (``lm_loss``
    with no remat, then ``run_lm``'s AdaFactorW(weight_decay=0.0025)) on
    the kernel path (flash) and the plain path (chunked attention), from
    one set of weights and one batch: loss, every gradient leaf, the
    params after the update; 16 + 16 flash launches on the kernel path,
    none on the plain path."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import frontends
    from repro_torch.models import transformer as tf

    cfg = get_arch("llama3.2-1b")
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(2), "cuda")
    batch = frontends.synthetic_inputs(cfg, batch, seq,
                                       np.random.default_rng(2),
                                       device="cuda")
    results, launches = {}, {}
    for path, attn in (("kernel", "pallas"), ("plain", "chunked")):
        pcfg = dataclasses.replace(cfg, attn_impl=attn)
        results[path], launches[path] = lm_step_results(
            pcfg, params, batch, lr, lm_counters())
    rec = check_step_parity(
        f"lm parity (Llama-3.2-1B f32, b={batch['tokens'].shape[0]} x "
        f"s={seq})", results, lr, launches, needed=cfg.n_layers)
    return {**rec, "launches": launches["kernel"]}


def phase_lm_timed():
    """``--mode lm`` through the trainer's ``main`` at full width and
    depth (f32, b 4 × s 1024, 4 steps, ``--ckpt-dir``); then the
    checkpoint: ``verify``, a ``restore`` onto the card equal to the
    returned params bit for bit (timed), and one
    ``AsyncCheckpointManager.save_async`` of the same tree (its stall and
    its background write), then a profile of one more warm step. Returns
    (launches per step, report)."""
    import math

    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch import interop
    from repro_torch.launch import train

    ckpt_dir = os.path.join(CKPT_ROOT, "lm")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    for ctr in lm_counters():
        ctr.reset()
    rep = train.main(LM_ARGV + ["--ckpt-dir", ckpt_dir])
    steps = len(rep["losses"])
    per_step = {c.name: c.count / steps for c in lm_counters()}
    params, opt_state = rep.pop("params"), rep.pop("opt_state")
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in interop.leaves(params))
    print(f"lm (Llama-3.2-1B f32, b 4 x s 1024): warm step median "
          f"{rep['warm_step_median_s']:.4f} s, {rep['tokens_per_s']:.1f} "
          f"tokens/s, max_memory_allocated "
          f"{rep['max_memory_allocated'] / 2**30:.3f} GiB; step s "
          f"{[round(t, 4) for t in rep['step_s']]}; losses "
          f"{[round(v, 5) for v in rep['losses']]}; launches per step "
          f"{per_step}", flush=True)
    if not all(math.isfinite(v) for v in rep["losses"]):
        raise AssertionError(f"lm: non-finite loss {rep['losses']}")
    if set(per_step.values()) != {16}:
        raise AssertionError(f"lm: expected 16 flash_fwd and 16 flash_bwd "
                             f"launches a step, got {per_step}")
    t0 = time.perf_counter()
    ckpt.verify(ckpt_dir, steps)   # reads the files the save just wrote
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.restore(ckpt_dir, steps, interop.to_device(params, "meta"),
                        device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require_equal_trees("lm checkpoint", back, params)
    del back
    shutil.rmtree(ckpt_dir)
    with ckpt.AsyncCheckpointManager(ckpt_dir) as mgr:
        mgr.save_async(steps, params)
        stall_s = mgr.metrics.gauge("ckpt/last_stall_s").value
        mgr.wait()
        write_s = mgr.metrics.histogram("ckpt/write_latency_s").sum
    shutil.rmtree(ckpt_dir)
    rep["device_kernels_per_call"], rep["busy"] = lm_step_profile(params,
                                                                  opt_state)
    gb = nbytes / 1e9
    rep.update(ckpt_bytes=nbytes, ckpt_verify_s=verify_s,
               ckpt_restore_s=restore_s, ckpt_async_stall_s=stall_s,
               ckpt_async_write_s=write_s)
    print(f"lm checkpoint ({gb:.3f} GB, {len(list(interop.leaves(params)))}"
          f" leaves): blocking save {rep['ckpt_save_s']:.3f} s "
          f"({gb / rep['ckpt_save_s']:.3f} GB/s), verify {verify_s:.3f} s, "
          f"restore onto the card {restore_s:.3f} s "
          f"({gb / restore_s:.3f} GB/s), bit for bit; save_async stall "
          f"{stall_s:.3f} s ({gb / stall_s:.3f} GB/s), its background "
          f"write {write_s:.3f} s", flush=True)
    return per_step, rep


def lm_step_profile(params, opt_state, arch="llama3.2-1b", batch=4,
                    seq=1024, counters=None, groups=KERNEL_GROUPS,
                    by_group=None, step=None, label="1 warm lm step"):
    """A torch.profiler window over one more warm ``--mode lm`` step (the
    trainer's ``lm_step`` at its f32 settings, or ``step``) of ``arch``
    from the timed run's state at ``batch`` × ``seq``: device time by
    kernel and group of ``groups`` (into ``by_group`` when given), busy
    share, device kernels per call of each of ``counters``' wrappers (the
    flash kernels by default)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import lm_step
    from repro_torch.models import frontends
    from repro_torch.optim import AdaFactorW

    counters = lm_counters() if counters is None else counters
    cfg = dataclasses.replace(get_arch(arch), attn_impl="pallas")
    if step is None:
        step = lm_step(cfg, AdaFactorW(weight_decay=0.0025), 1e-3,
                       precision="f32")
    data = frontends.synthetic_inputs(cfg, batch, seq,
                                      np.random.default_rng(3),
                                      device="cuda")
    calls = {}

    def one_step():
        before = {c.name: c.count for c in counters}
        t0 = time.perf_counter()
        _, _, loss, _ = step(params, opt_state, data)
        float(loss)
        torch.cuda.synchronize()
        calls.update({c.name: c.count - before[c.name]
                      for c in counters})
        return (time.perf_counter() - t0) * 1e6

    prof, wall_us = retaken_window(
        one_step, lambda prof, _: all(
            seen >= calls[w]
            for w, seen in wrapper_kernels_seen(prof, calls).items()))
    return device_breakdown(prof, label, wall_us, 1, calls, groups,
                            by_group)


def phase_lm_step_bf16(steps: int = 3):
    """``make_train_step`` (bf16, remat basic, flash attention) on
    Llama-3.2-1B at the timed run's shape, ``steps`` steps: warm step
    median, tokens/s, peak memory, flash launches per step."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_arch("llama3.2-1b"), attn_impl="pallas")
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), "cuda")
    step_fn, opt = make_train_step(cfg)
    rec, _, _ = timed_steps("lm make_train_step (bf16, remat basic)", cfg,
                            params, opt.init(params), step_fn, 4, 1024,
                            steps, lm_counters())
    return rec


def phase_registry_disk(cfg, params, tok):
    """Zero-shot serving with ``registry_dir``: once computing the class
    matrix, then in a fresh service, which must read it from disk
    (``source == 'disk'``) and give the same top-5 ids."""
    import numpy as np
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.launch import serve_zeroshot

    reg_dir = os.path.join(CKPT_ROOT, "registry")
    shutil.rmtree(reg_dir, ignore_errors=True)
    reps = []
    for _ in range(2):
        topk_ops.COUNTER.reset()
        reps.append(serve_zeroshot.run(
            cfg, params, tok, classes=512, batch=16, requests=2, k=5,
            seed=0, device="cuda", registry_dir=reg_dir))
        reps[-1]["topk_launches"] = topk_ops.COUNTER.count
    shutil.rmtree(reg_dir)
    first, second = reps
    same = np.array_equal(first["last_result"].indices,
                          second["last_result"].indices)
    print(f"registry on disk: first service {first['class_matrix_source']} "
          f"in {first['class_matrix_s']:.3f} s, second "
          f"{second['class_matrix_source']} in "
          f"{second['class_matrix_s']:.3f} s; top-5 ids equal: {same}; "
          f"topk_fused launches {first['topk_launches']} / "
          f"{second['topk_launches']}", flush=True)
    if (first["class_matrix_source"], second["class_matrix_source"]) != \
            ("computed", "disk") or not same or not np.array_equal(
                first["class_matrix"], second["class_matrix"]):
        raise AssertionError("registry: the second service did not serve "
                             "the first's class matrix from disk")
    if min(first["topk_launches"], second["topk_launches"]) < 1:
        raise AssertionError("registry: topk_fused was not launched")
    return {"computed_s": first["class_matrix_s"],
            "disk_s": second["class_matrix_s"]}


# ---------------------------------------------------------------------------
# phases 44-46: topk_fused with n_valid, retrieval at scale, SLOs
# ---------------------------------------------------------------------------

NV_SHAPES = ((64, 21841, 5, (0, 3, 20841, 21841)),)
NV_SHARD = (64, 250_000, 10, 249_999)   # one shard of the 1M gallery
RETRIEVAL_N = 999_999                   # gallery rows: 4 shards, a padded tail
RETRIEVAL_D = 512                       # BASIC-S's embedding width
RETRIEVAL_CLUSTERS = 1000
RETRIEVAL_BLOCKS = 1000                 # centroids of the two-stage index
RETRIEVAL_K = 10
RETRIEVAL_CALLS = 20
RETRIEVAL_NPROBE = 8
RETRIEVAL_SLO_S = 10.0


def check_n_valid(label, vals, idx, ref_v, ref_i, k, tol):
    """``check_topk`` on the live entries, and the masked tail exact: where
    the plain version's value is NEG, the kernel's value is NEG and its id
    the plain version's. Returns the max abs value error."""
    from repro_torch.kernels.similarity_topk.ops import NEG
    err = check_topk(label, vals, idx, ref_v, ref_i, k, tol)
    tail = ref_v[:, :k] <= NEG / 2
    if not (bool((vals[tail] == ref_v[:, :k][tail]).all())
            and bool((idx[tail] == ref_i[:, :k][tail]).all())
            and bool((vals[~tail] > NEG / 2).all())):
        raise AssertionError(f"{label}: the masked tail differs from the "
                             f"plain version's sentinels")
    return err


def phase_topk_n_valid():
    """Phase 44: the top-k kernel with ``n_valid`` against its plain
    version: f32 and bf16 at b 64 × n 21841 × d 512, k 5, n_valid in {0,
    3, 20841, 21841}; and one shard of the retrieval phase's gallery, f32
    b 64 × n_local 250,000, k 10, n_valid 249,999: ids where the values
    are apart, values within TOPK_TOL, sentinels exact. Times the kernel,
    the plain version and ``torch.topk`` over the valid columns at the two
    timed shapes; returns the records."""
    import torch
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref
    inv_tau = 1.0 / 0.07
    d = RETRIEVAL_D
    g = torch.Generator(device="cuda").manual_seed(44)
    recs, errs = {}, {"float32": 0.0, "bfloat16": 0.0}
    cases = [(b, n, k, nv, dt) for b, n, k, nvs in NV_SHAPES for nv in nvs
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((*NV_SHARD, torch.float32))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, n, k, nv, dt in cases:
        x, c = unit_rows(b, d, g, dt), unit_rows(n, d, g, dt)
        ref_v, ref_i = similarity_topk_ref(x, c, k + 1, inv_tau, nv)
        vals, idx = topk_ops.similarity_topk(x, c, k, inv_tau=inv_tau,
                                             n_valid=nv)
        label = f"topk n_valid b={b} n={n} k={k} n_valid={nv} " \
                f"{dtype_name(dt)}"
        e = check_n_valid(label, vals, idx, ref_v, ref_i, k, TOPK_TOL)
        errs[dtype_name(dt)] = max(errs[dtype_name(dt)], e)
        if dt != torch.float32 or nv not in (20841, NV_SHARD[3]):
            continue
        call = lambda: topk_ops.similarity_topk(x, c, k, inv_tau=inv_tau,
                                                n_valid=nv)
        ms = time_ms(call)
        plain_ms = time_ms(lambda: similarity_topk_ref(x, c, k, inv_tau, nv))
        live = c[:nv]
        lib_ms = time_ms(lambda: torch.topk(x @ live.T * inv_tau, k, dim=1))
        bound_ms, bound_by = bound(*topk_work(b, n, d, k, n_valid=nv),
                                   "float32")
        recs[(b, n, k, nv)] = {
            "shape": f"b={b} n={n} n_valid={nv} d={d} k={k} float32",
            "plan": topk_ops.topk_plan(b, n, d, k, 4, sms)._asdict(),
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"matmul+topk over the valid rows {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    print(f"similarity_topk n_valid: {len(cases)} cases match, sentinels "
          f"exact; max |value err| f32 {errs['float32']:.3g}, bf16 "
          f"{errs['bfloat16']:.3g} (tol {TOPK_TOL})", flush=True)
    for r in recs.values():
        r["max_abs_err"] = errs["float32"]
    return recs, errs


def fill_clustered(block, centres, seed: int, noise: float = 0.03,
                   chunk: int = 1 << 20):
    """Fill ``block`` (rows, d) in place with unit rows: a random row of
    ``centres`` plus Gaussian noise of ``noise`` per coordinate,
    re-normalised; drawn on the block's device from ``seed``, ``chunk``
    rows at a time (no temporary of the block's size)."""
    import torch
    g = torch.Generator(device=block.device).manual_seed(seed)
    for lo in range(0, block.shape[0], chunk):
        part = block[lo:lo + chunk]
        part.normal_(0.0, noise, generator=g)
        pick = torch.randint(0, centres.shape[0], (part.shape[0],),
                             generator=g, device=block.device)
        part += centres[pick]
        part /= part.norm(dim=1, keepdim=True)


def unit_centres(n, d, seed):
    """(n, d) random unit rows on the host from ``seed``."""
    import torch
    c = torch.randn((n, d), generator=torch.Generator().manual_seed(seed))
    return c / c.norm(dim=1, keepdim=True)


def scrape(url, path):
    """(status, body) of GET ``url + path`` on the local endpoint; an HTTP
    error status is returned, not raised."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url + path, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def retrieval_calls(svc, handle, queries, counter, **kw):
    """``retrieve`` once warm, once counting the top-k kernel's launches,
    then RETRIEVAL_CALLS timed calls; returns (result, launches per call,
    p50 s, p90 s)."""
    import numpy as np
    svc.retrieve(queries, handle, k=RETRIEVAL_K, **kw)
    before = counter.count
    res = svc.retrieve(queries, handle, k=RETRIEVAL_K, **kw)
    per_call = counter.count - before
    lat = []
    for _ in range(RETRIEVAL_CALLS):
        t0 = time.perf_counter()
        svc.retrieve(queries, handle, k=RETRIEVAL_K, **kw)
        lat.append(time.perf_counter() - t0)
    return res, per_call, float(np.percentile(lat, 50)), \
        float(np.percentile(lat, 90))


def phase_retrieval(cfg, params, tok):
    """Phases 45-46: zero-shot retrieval at scale with BASIC-S at full
    width: a 999,999 × 512 fp32 gallery of 1000 clusters made on the card,
    64 text queries through the text tower, k 10, through
    ``ZeroShotService`` in each retrieval mode (fused; sharded over
    [cuda:0] × 4, the last shard padded; two-stage at nprobe "all" and 8
    over 1000 blocks), every service with a 10 s SLO. Sharded and
    two-stage at "all" must equal fused bit for bit; nprobe 8 prints
    recall@10 against fused, its prune ratio and stage seconds; each
    gallery is prepared once. Then the live endpoint: /metrics (the
    serve/slo_* and serve/retrieval_* series), /healthz 200 and
    /snapshot.json mid-run, and a service whose target is half the fused
    p50 must answer 503 within its window. Returns the report (the top-k
    kernel's launches over the modes' calls included)."""
    import json as _json

    import numpy as np
    import torch
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.serving import ZeroShotService
    from repro_torch.serving import retrieval as rtv

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gallery = torch.empty((RETRIEVAL_N, RETRIEVAL_D), device=dev)
    fill_clustered(gallery, unit_centres(RETRIEVAL_CLUSTERS, RETRIEVAL_D,
                                         0).to(dev), seed=1)
    torch.cuda.synchronize()
    queries = [f"a photo of item {i}" for i in range(64)]
    modes = {"fused": {}, "sharded": {"mesh": [dev] * 4},
             "twostage": {"index_blocks": RETRIEVAL_BLOCKS}}
    counter = topk_ops.COUNTER
    counter.reset()
    out, results = {}, {}
    for mode, kw in modes.items():
        with ZeroShotService(cfg, params, tok, device=dev, retrieval=mode,
                             latency_slo_s=RETRIEVAL_SLO_S, **kw) as svc:
            t0 = time.perf_counter()
            handle = svc.prepare_gallery(gallery)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            server = svc.serve_metrics(port=0) if mode == "fused" else None
            res, per_call, p50, p90 = retrieval_calls(svc, handle, queries,
                                                      counter)
            rec = {"prepare_s": prep_s, "p50_s": p50, "p90_s": p90,
                   "launches_per_call": per_call}
            results[mode] = res
            if server is not None:
                rec["scrape"] = {p: scrape(server.url, p) for p in (
                    "/metrics", "/healthz", "/snapshot.json")}
                server.stop()
            if mode == "twostage":
                res8, per8, p50_8, p90_8 = retrieval_calls(
                    svc, handle, queries, counter, nprobe=RETRIEVAL_NPROBE)
                results["twostage_8"] = res8
                qemb = torch.as_tensor(svc.embed_texts(queries), device=dev)
                infos = [rtv.two_stage_topk(qemb, handle.data, handle.index,
                                            RETRIEVAL_K,
                                            nprobe=RETRIEVAL_NPROBE)[2]
                         for _ in range(5)]
                out["twostage_8"] = {
                    "p50_s": p50_8, "p90_s": p90_8,
                    "launches_per_call": per8,
                    **{k: float(np.median([i[k] for i in infos])) for k in (
                        "prune_ratio", "coarse_s", "gather_s",
                        "rerank_s")},
                    "n_blocks_probed": infos[0]["n_blocks_probed"]}
            st = svc.stats()
            rec["uploads"] = st["metrics"]["counters"]["serve/gallery_uploads"]
            rec["slo"] = st["slo"]
            out[mode] = rec
            if mode == "twostage":
                rec["index_build_s"] = prep_s
    launches = counter.count
    fv, fi = results["fused"]
    exact = {m: bool(np.array_equal(results[m][0], fv)
                     and np.array_equal(results[m][1], fi))
             for m in ("sharded", "twostage")}
    ids8 = results["twostage_8"][1]
    recall = float(np.mean([len(set(a) & set(b)) / RETRIEVAL_K
                            for a, b in zip(ids8, fi)]))
    out["twostage_8"]["recall_at_10"] = recall
    for mode in ("fused", "sharded", "twostage", "twostage_8"):
        r = out[mode]
        print(f"retrieval {mode} (BASIC-S text tower, 64 queries x "
              f"{RETRIEVAL_N} x {RETRIEVAL_D} f32, k {RETRIEVAL_K}): p50 "
              f"{r['p50_s'] * 1e3:.3f} ms, p90 {r['p90_s'] * 1e3:.3f} ms "
              f"over {RETRIEVAL_CALLS} calls; topk_fused launches a call "
              f"{r['launches_per_call']}"
              + (f"; prepared in {r['prepare_s']:.3f} s, gallery uploads "
                 f"{r['uploads']}" if "prepare_s" in r else ""),
              flush=True)
    t8 = out["twostage_8"]
    print(f"retrieval twostage nprobe {RETRIEVAL_NPROBE}: recall@10 vs fused "
          f"{recall:.4f}, prune ratio {t8['prune_ratio']:.4f} "
          f"({t8['n_blocks_probed']} of {RETRIEVAL_BLOCKS} blocks), coarse "
          f"{t8['coarse_s'] * 1e3:.3f} ms, gather {t8['gather_s'] * 1e3:.3f} "
          f"ms, rerank {t8['rerank_s'] * 1e3:.3f} ms; index build "
          f"{out['twostage']['index_build_s']:.3f} s; sharded / twostage "
          f"'all' equal fused bit for bit: {exact}", flush=True)
    if not all(exact.values()):
        raise AssertionError(f"retrieval: a mode differs from fused: {exact}")
    want = {"fused": 1, "sharded": 4, "twostage": 1, "twostage_8": 1}
    got = {m: out[m]["launches_per_call"] for m in want}
    if got != want or any(out[m]["uploads"] != 1 for m in modes):
        raise AssertionError(f"retrieval: launches a call {got} (want "
                             f"{want}) or a gallery uploaded twice")
    if not (fv.shape == (64, RETRIEVAL_K) and np.isfinite(fv).all()
            and (fi >= 0).all() and (fi < RETRIEVAL_N).all()):
        raise AssertionError("retrieval: malformed fused result")

    # phase 46: the live endpoint, and an SLO the service cannot meet
    scraped = out["fused"].pop("scrape")
    code, text = scraped["/metrics"]
    series = ("serve_slo_requests", "serve_slo_p99_s",
              "serve_slo_error_budget_burn", "serve_slo_ready",
              "serve_retrieval_latency_s_bucket")
    missing = [s for s in series if s not in text]
    health_code, health = scraped["/healthz"]
    snap_code, snap = scraped["/snapshot.json"]
    snap = _json.loads(snap)
    if code != 200 or missing or health_code != 200 or snap_code != 200 \
            or "serve/slo_requests" not in snap["counters"]:
        raise AssertionError(f"live endpoint: /metrics {code} missing "
                             f"{missing}, /healthz {health_code}, "
                             f"/snapshot.json {snap_code}")
    tight = out["fused"]["p50_s"] / 2
    with ZeroShotService(cfg, params, tok, device=dev,
                         latency_slo_s=tight) as svc:
        handle = svc.prepare_gallery(gallery)
        server = svc.serve_metrics(port=0)
        before = scrape(server.url, "/healthz")[0]
        for _ in range(4):
            svc.retrieve(queries, handle, k=RETRIEVAL_K)
        after_code, after = scrape(server.url, "/healthz")
        server.stop()
    print(f"live endpoint: /metrics 200 with {series}, /healthz "
          f"{health_code} {health.strip()}; at a target of "
          f"{tight * 1e3:.3f} ms (half the fused p50) /healthz went "
          f"{before} -> {after_code} {after.strip()}", flush=True)
    if (before, after_code) != (200, 503):
        raise AssertionError(f"live endpoint: /healthz {before} -> "
                             f"{after_code} under an unmet SLO")
    out["healthz_flip"] = [before, after_code]
    out["exact"] = exact
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"retrieval phases: {out['seconds']:.1f} s", flush=True)
    del gallery
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 47: the trainer's health tier on the card
# ---------------------------------------------------------------------------

HEALTH_ARGV = ["--arch", "basic-s", "--batch", "256", "--num-micro", "2",
               "--loss", "chunked", "--precision", "f32", "--attn", "pallas",
               "--steps", "3", "--lr", "1e-3", "--seed", "0", "--quiet",
               "--health", "--metrics-port", "0"]
HEALTH_NAN_STEP = 1


@contextlib.contextmanager
def step_inputs(log):
    """Within the block, the contrastive step that
    ``launch.steps.make_contrastive_step`` builds appends each call's
    incoming (params, opt_state) to ``log``."""
    from repro_torch.launch import steps as st
    make = st.make_contrastive_step

    def recording(*a, **kw):
        step_fn, opt = make(*a, **kw)

        def step(params, opt_state, batch):
            log.append((params, opt_state))
            return step_fn(params, opt_state, batch)
        return step, opt
    st.make_contrastive_step = recording
    try:
        yield log
    finally:
        st.make_contrastive_step = make


def nan_batch_hook(run_dir, probes, nan_step=HEALTH_NAN_STEP,
                   probe_step=HEALTH_NAN_STEP + 1):
    """A step fault hook: the image batch of ``nan_step`` times NaN, and at
    ``probe_step`` a scrape of the run's live /healthz (its port read from
    ``<run_dir>/metrics_port``) into ``probes``."""
    def hook(step, batch):
        if step == nan_step:
            images = dict(batch["images"])
            images["image"] = batch["images"]["image"] * float("nan")
            batch = dict(batch, images=images)
        if step == probe_step:
            with open(os.path.join(run_dir, "metrics_port")) as f:
                port = int(f.read())
            probes["healthz"] = scrape(f"http://127.0.0.1:{port}",
                                       "/healthz")
        return batch
    return hook


def health_outcome(run_dir, losses, inputs, probes,
                   nan_step=HEALTH_NAN_STEP):
    """The checks of a ``--health`` run with a NaN batch at ``nan_step``:
    only that step's loss is not finite, ``health/steps_skipped`` is 1, the
    nonfinite detector fired critical at that step, a flight dump exists,
    the params and optimizer state after the step equal those before it
    (and step 0 changed them), and /healthz answered 200 mid-run. Returns
    the summary; raises on a failed check."""
    import math

    import torch
    from repro_torch.obs import runlog
    from repro_torch.tree import tree_leaves
    recs = runlog.read_runlog(os.path.join(run_dir, "runlog.jsonl"))
    anomalies = [r for r in recs if r["kind"] == "anomaly"]
    final = [r for r in recs if r["kind"] == "metrics"][-1]
    skipped = final["counters"].get("health/steps_skipped")
    steps = {r["step"]: r for r in recs if r["kind"] == "step"}
    dumps = sorted(os.listdir(os.path.join(run_dir, "flight"))) \
        if os.path.isdir(os.path.join(run_dir, "flight")) else []

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    kept = same(inputs[nan_step], inputs[nan_step + 1])
    moved = not same(inputs[0][0], inputs[1][0])
    finite = [math.isfinite(v) for v in losses]
    out = {"losses": losses, "steps_skipped": skipped,
           "anomalies": [(a["detector"], a["step"], a["severity"])
                         for a in anomalies],
           "flight_dumps": dumps, "state_kept": kept,
           "step0_moved": moved, "healthz": probes.get("healthz", (None,))[0],
           "skipped_record": steps[nan_step].get("skipped")}
    ok = (finite == [i != nan_step for i in range(len(losses))]
          and skipped == 1 and kept and moved and out["healthz"] == 200
          and anomalies and all(a == ("nonfinite", nan_step, "critical")
                                for a in out["anomalies"])
          and dumps == [f"step{nan_step:06d}_nonfinite"]
          and out["skipped_record"] == 1)
    if not ok:
        raise AssertionError(f"health run: {out}")
    return out


def phase_train_health():
    """Phase 47: ``train_distributed.main --health --metrics-port 0`` at one
    rank, BASIC-S at full width, f32, B 256 in 2 microbatches, 3 steps,
    with a NaN image batch at step 1 through ``set_step_fault_hook``: the
    guard skips exactly that step (params and optimizer state unchanged),
    the nonfinite detector fires critical, a flight dump is written, steps
    0 and 2 are finite and /healthz answers 200 mid-run."""
    from repro_torch.launch import train_distributed as td
    from repro_torch.obs import health
    run_dir = os.path.join(CKPT_ROOT, "health")
    shutil.rmtree(run_dir, ignore_errors=True)
    probes, inputs = {}, []
    t0 = time.perf_counter()
    health.set_step_fault_hook(nan_batch_hook(run_dir, probes))
    try:
        with step_inputs(inputs):
            losses = td.main(HEALTH_ARGV + ["--run-dir", run_dir])
    finally:
        health.set_step_fault_hook(None)
    out = health_outcome(run_dir, losses, inputs, probes)
    del inputs
    out["seconds"] = time.perf_counter() - t0
    print(f"train health (BASIC-S f32, B 256, NaN batch at step "
          f"{HEALTH_NAN_STEP}): losses {losses}; health/steps_skipped "
          f"{out['steps_skipped']}, anomalies {out['anomalies']}, flight "
          f"dumps {out['flight_dumps']}, params and optimizer state kept "
          f"through the skipped step: {out['state_kept']}, /healthz "
          f"mid-run {out['healthz']} ({out['seconds']:.1f} s)", flush=True)
    shutil.rmtree(run_dir)
    return out


# ---------------------------------------------------------------------------
# phases 24-26: Mixtral-8x22B, the MoE family at full width
# ---------------------------------------------------------------------------

MIXTRAL = "mixtral-8x22b"
# Mixtral's attention: 48 query heads over 8 kv heads (a GQA group of 6,
# which the decode kernel runs in its 8-head CTA group), d 128, a window
# of 4096
MOE_ATTN = dict(h=48, kv=8, d=128, window=4096)
# MoE parity, kernel path vs plain path in f32 at full width: logits of
# ~unit scale through 2 layers whose attention sums in another order move
# by ~1e-5; 1e-3 still catches a wrong mask, position, expert or drop
# (those move logits by ~1e-1)
MOE_PARITY_TOL = 1e-3
# a router near-tie: where the plain path's k-th and (k+1)-th probability
# are closer than this, the kernel path may pick the other expert, and
# under capacity dispatch move the bucket places of the group after it
MOE_NEAR_TIE = 1e-5
# the timed MoE serving run: the decode serving run's traffic (8 slots,
# 16 requests of 508-520 prompt tokens, 64 new, a cache of 8192), bf16,
# the kernels, and capacity dispatch (the launcher's default without
# --smoke); 4 of Mixtral's 56 layers
MOE_SERVE_ARGV = ["--arch", MIXTRAL, "--engine", "continuous", "--slots",
                  "8", "--requests", "16", "--arrival", "0", "--prompt-len",
                  "512", "--max-new", "64", "--cache-len", "8192", "--attn",
                  "pallas", "--precision", "bf16", "--temperature", "0",
                  "--seed", "0"]
MOE_SERVE_LAYERS = 4
# device kernels by group on the MoE path, first match wins: the MoE's
# dispatch and combine are gathers, scatters, a sort and a cumsum
MOE_GROUPS = (KERNEL_GROUPS[0], KERNEL_GROUPS[3], KERNEL_GROUPS[5],
              ("copies and casts", ("copy", "Memcpy", "Memset")),
              ("MoE dispatch and combine", ("gather", "scatter", "Sort",
                                            "sort", "cumsum", "scan")))
# device time by the aten op that launched it: the experts' products are
# the batched ones (``bmm``; the combine's small einsum too), the
# projections and the LM head plain ones (``mm``)
MOE_OPS = {"expert GEMMs (bmm)": ("aten::bmm",),
           "projection GEMMs (mm)": ("aten::mm", "aten::addmm"),
           "casts and copies": ("aten::copy_",),
           "dispatch and combine": ("aten::gather", "aten::scatter_",
                                    "aten::scatter", "aten::sort",
                                    "aten::cumsum", "aten::one_hot")}


def phase_moe_kernels():
    """The two kernels of the MoE serving path at Mixtral's shapes, f32 and
    bf16: ``flash_fwd`` (b 1, 48 heads over 8 kv, d 128, causal, window
    4096) over 512 tokens and over 4608, where the window masks; and
    ``decode_attention`` (8 slots, the same heads; a GQA group of 6 in the
    kernel's 8-head CTA group) over the serving path's linear cache of 8192
    at the serving state and over a ring of 4096 at the serving state and
    full, with ragged lengths (0 exactly zero). Returns the records:
    flash by (s, dtype), decode by (t, state, dtype)."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    a = MOE_ATTN
    flash, decode = {}, {}
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        dt = dtype_name(dtype)
        for s in (512, 4608):
            flash[(s, dt)] = flash_case(
                "mixtral", 1, a["h"], s, a["d"], dtype, False, 70 + i,
                kv=a["kv"], causal=True, window=a["window"])
        b = 8
        for t, cache, states in ((8192, "linear", ("serving",)),
                                 (4096, "ring", ("serving", "full"))):
            q, k, v = decode_inputs(b, a["h"], a["kv"], t, a["d"], dtype,
                                    72 + i)
            group = dec_ops.launch_plan(q, k).group
            if group != 8:
                raise AssertionError(f"decode_attention: a GQA group of 6 "
                                     f"ran in a CTA group of {group}")
            lens = torch.tensor([0, 1, 255, 256, 257, t, 3001, t - 5],
                                device="cuda")
            out, err = decode_check(
                f"mixtral {cache} t={t} ragged {dt}", q, k, v,
                torch.arange(t, device="cuda")[None, :] < lens[:, None])
            if not bool((out[0] == 0).all()):
                raise AssertionError("decode_attention: a length-0 row is "
                                     "not exactly zero")
            for state in states:
                lens = (torch.tensor([516 + 9 * j for j in range(b)],
                                     device="cuda") if state == "serving"
                        else torch.full((b,), t, device="cuda"))
                decode[(t, state, dt)] = decode_timed(
                    f"mixtral {cache} {state}", q, k, v, lens, err)
    return flash, decode


@contextlib.contextmanager
def recorded_routes(log):
    """Within the block, every MoE router call appends (top_idx, the gap
    between the k-th and (k+1)-th probability) to ``log['now']``'s list
    in ``log``."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    real = moe_lib._router

    def router(p, cfg, x):
        out = real(p, cfg, x)
        probs = torch.softmax(L.dense(x, p["router"]).float(), dim=-1)
        top = probs.sort(dim=-1, descending=True).values
        k = cfg.moe.top_k
        log[log["now"]].append((out[1], top[..., k - 1] - top[..., k]))
        return out
    moe_lib._router = router
    try:
        yield log
    finally:
        moe_lib._router = real


def routes_diverge(log):
    """(pairs routed differently on the kernel and the plain path, whether
    the plain path's gap is under ``MOE_NEAR_TIE`` at every one of them)."""
    n, near = 0, True
    for (ik, _), (ip, gap) in zip(log["kernel"], log["plain"]):
        differ = (ik != ip).any(-1)
        n += int(differ.sum())
        near &= bool((gap[differ] < MOE_NEAR_TIE).all())
    return n, near


def routed_parity(label, cfg, params, toks, clen, steps, tol, counters,
                  moe_args=None):
    """Prefill ``toks`` (b, plen) into caches of ``clen``, then ``steps``
    decode steps over the b slots fed the kernel path's greedy token, on
    the kernel path (flash prefill, the scan kernel, decode kernel) and
    the plain path (chunked prefill, the scan's plain version, einsum
    decode), f32, with ``moe_args``. Logits agree within ``tol``; a row
    outside it passes only where the two paths routed some token
    differently and the plain path's router gap is under
    ``MOE_NEAR_TIE`` at each such token (counted and printed). Returns
    (max |logit diff|, the (step, row)s excused by a near-tie, pairs
    routed differently, the launches of ``counters`` by path, the last
    (logits, caches) by path)."""
    import torch
    from repro_torch.models import transformer as tf
    plen = toks.shape[1]
    paths = {"kernel": dataclasses.replace(cfg, attn_impl="pallas"),
             "plain": dataclasses.replace(cfg, attn_impl="chunked")}
    launches = {name: dict.fromkeys((c.name for c in counters), 0)
                for name in paths}
    log = {"now": None, "kernel": [], "plain": []}
    worst, near_tie_rows, state = 0.0, [], {}
    with torch.no_grad(), recorded_routes(log):
        for i in range(steps + 1):
            for name, pcfg in paths.items():
                log["now"] = name
                before = {c.name: c.count for c in counters}
                with (plain_path() if name == "plain"
                      else contextlib.nullcontext()):
                    if i == 0:
                        state[name] = tf.prefill(
                            pcfg, params, {"tokens": toks}, precision="f32",
                            moe_args=moe_args, collect_cache_len=clen)
                    else:
                        state[name] = tf.decode_step(
                            pcfg, params, tok[:, None], plen + i - 1,
                            state[name][1], precision="f32",
                            moe_args=moe_args)
                for c in counters:
                    launches[name][c.name] += c.count - before[c.name]
            lk, lp = (state[name][0][:, 0] for name in paths)
            diff = (lk - lp).abs().amax(-1)
            worst = max(worst, diff.max().item())
            out = torch.nonzero(diff > tol).flatten().tolist()
            if out:
                n_diff, near = routes_diverge(log)
                print(f"{label}: step {i}: rows {out} differ by "
                      f"{[round(diff[r].item(), 5) for r in out]}; pairs "
                      f"routed differently so far {n_diff}, each at a "
                      f"plain-path gap under {MOE_NEAR_TIE}: {near}",
                      flush=True)
                if not (n_diff and near):
                    raise AssertionError(f"{label}: step {i} rows {out} "
                                         f"differ with no router near-tie")
                near_tie_rows += [(i, r) for r in out]
            tok = lk.argmax(-1)
    torch.cuda.synchronize()
    n_diff, _ = routes_diverge(log)
    return worst, near_tie_rows, n_diff, launches, state


def phase_moe_parity(layers: int = 2, batch: int = 8, plen: int = 512,
                     steps: int = 8, clen: int = 8192, arch: str = MIXTRAL,
                     experts=None):
    """A MoE model (Mixtral-8x22B; Arctic-480B with its card's expert
    share ``experts``) at full width and ``layers`` layers, f32, capacity
    dispatch (``moe_ffn``'s defaults), random weights from a CUDA
    generator: prefill of ``batch`` × ``plen`` tokens into caches of
    ``clen``, then ``steps`` decode steps over the ``batch`` slots, on the
    kernel path and the plain path (``routed_parity``, within
    ``MOE_PARITY_TOL``); the caches of the rows within it agree within
    ``MOE_PARITY_TOL`` of each leaf's max |value|."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    margs = None if experts is None else {"experts": experts}
    t0 = time.perf_counter()
    params = interop.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(5), "cuda",
        experts=experts)
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in interop.leaves(params))
    print(f"moe parity: {arch} at full width, {layers} layers, experts "
          f"{experts or 'all'}, {n} params f32, init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(4, cfg.vocab, (batch, plen), generator=g,
                         device="cuda")
    t0 = time.perf_counter()
    worst, near_tie_rows, n_diff, launches, state = routed_parity(
        "moe parity", cfg, params, toks, clen, steps, MOE_PARITY_TOL,
        (fa_ops.COUNTER, dec_ops.COUNTER), margs)
    rows = sorted(set(range(batch)) - {r for _, r in near_tie_rows})
    cache_err = {}
    for ck, cp in zip(state["kernel"][1], state["plain"][1]):
        for leaf, a, b in zip(ck._fields, ck, cp):
            a, b = a[:, rows].float(), b[:, rows].float()
            err = (a - b).abs().max().item()
            lim = MOE_PARITY_TOL * b.abs().max().item()
            cache_err[leaf] = max(cache_err.get(leaf, 0.0), err)
            if not err <= lim:
                raise AssertionError(f"moe parity: cache {leaf} max err "
                                     f"{err:.3g} > {lim:.3g}")
    del state
    want = {"kernel": {"flash_fwd": layers,
                       "decode_attention": layers * steps},
            "plain": {"flash_fwd": 0, "decode_attention": 0}}
    print(f"moe parity ({arch} f32, {layers} layers, experts "
          f"{experts or 'all'}, capacity dispatch, "
          f"{batch} x {plen} prefill + {steps} steps over {batch} slots, "
          f"cache {clen}): caches max err {cache_err} over {len(rows)} rows "
          f"(tol {MOE_PARITY_TOL} of max |value|); "
          f"max |logit diff| kernel vs plain {worst:.3g} (tol "
          f"{MOE_PARITY_TOL}); rows outside it at a router near-tie: "
          f"{len(near_tie_rows)} of {batch * (steps + 1)}; pairs routed "
          f"differently {n_diff}; launches {launches}; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if launches != want:
        raise AssertionError(f"moe parity: launches {launches}, want {want}")
    return {"max_logit_diff": worst, "near_tie_rows": near_tie_rows,
            "routed_differently": n_diff, "launches": launches["kernel"],
            "cache_err": cache_err}


def with_flags(argv, **changes):
    """A copy of the launcher's ``argv`` with each flag of ``changes``
    (``max_new=4`` is ``--max-new 4``) set, or appended."""
    out = list(argv)
    for flag, value in changes.items():
        flag = "--" + flag.replace("_", "-")
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out


def phase_moe_serve(arch: str = MIXTRAL, layers: int = MOE_SERVE_LAYERS,
                    serve_argv=MOE_SERVE_ARGV, experts=None):
    """A MoE model at full width on ``layers`` of its layers (Mixtral-8x22B
    4 of 56; Arctic-480B 4 of 35 with its card's expert share
    ``experts``, drawn and served alone), bf16, the kernels, capacity
    dispatch (over the share), through the launcher's
    ``run_continuous`` (after one untimed warm-up request) and
    ``run_legacy`` (one lockstep request), the weights built once for all
    three: tokens per second, decode-step median and p90, prefill ms, peak
    memory; flash_fwd launches per prefill and decode_attention launches
    per step (one per layer), every token in the vocabulary; then profiles
    4 warm decode steps (device time by group and by op, busy share)."""
    import math

    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve

    def argv(**changes):
        return serve.parse_args(with_flags(serve_argv, **changes))

    args = argv()
    moe_args = serve.moe_args_for(args)        # None: capacity dispatch
    if experts is not None:
        moe_args = {**(moe_args or {}), "experts": experts}
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = interop.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed), "cuda",
        experts=experts)
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in interop.leaves(params))
    print(f"moe serve: {arch} at full width, {layers} of {full.n_layers} "
          f"layers, experts {experts or 'all'}, {n} params "
          f"({4 * n / 1e9:.2f} GB f32), init "
          f"{time.perf_counter() - t0:.2f}s, moe_args {moe_args}",
          flush=True)
    serve.run_continuous(cfg, params, argv(requests=1, max_new=4), moe_args)
    counters = (fa_ops.COUNTER, dec_ops.COUNTER)
    for ctr in counters:
        ctr.reset()
    rep = serve.run_continuous(cfg, params, args, moe_args)
    launches = {ctr.name: ctr.count for ctr in counters}
    per = {"flash_fwd_per_prefill": launches["flash_fwd"] / rep["prefills"],
           "decode_attention_per_step": (launches["decode_attention"]
                                         / rep["decode_steps"])}
    print(f"moe serve ({arch}, continuous, bf16, 8 slots, 16 requests x "
          f"508-520 prompt tokens x 64 new, cache {args.cache_len}): decode "
          f"{rep['decode_tokens_per_s']:.1f} tok/s over the warm steps, "
          f"{rep['tokens_per_s']:.1f} tok/s over the run (prefill "
          f"included); step median {rep['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{rep['step_p90_s'] * 1e3:.3f} ms over {rep['decode_steps']} "
          f"steps; prefill {rep['prefill_mean_s'] * 1e3:.3f} ms per "
          f"request; launches {launches}: {per}", flush=True)
    for name in per:
        if per[name] != layers:
            raise AssertionError(f"moe serve: {name} {per[name]}, want "
                                 f"{layers} (one per layer)")
    for rid, r in rep["results"].items():
        in_vocab = bool(np.all((r >= 0) & (r < cfg.vocab)))
        if not (in_vocab and (r.size == args.max_new or r[-1] == 3)):
            raise AssertionError(f"moe serve: bad tokens for request "
                                 f"{rid}: {r}")
    if rep["requests"] != args.requests or not math.isfinite(
            rep["decode_tokens_per_s"]):
        raise AssertionError(f"moe serve: {rep['requests']} of "
                             f"{args.requests} requests finished")

    for ctr in counters:
        ctr.reset()
    lock = serve.run_legacy(cfg, params, argv(engine="legacy", batch=1),
                            moe_args)
    row = lock["tokens"][0]
    stop = np.nonzero(row == 3)[0]
    emitted = int(stop[0]) + 1 if stop.size else row.size
    lock_launches = {ctr.name: ctr.count for ctr in counters}
    want = {"flash_fwd": layers, "decode_attention": layers * (emitted - 1)}
    print(f"moe serve (lockstep, 1 request x 512 prompt tokens): "
          f"{emitted} tokens, {lock['tokens_per_s']:.1f} tok/s (prefill "
          f"included); launches {lock_launches}", flush=True)
    if lock_launches != want or not bool(np.all((row >= 0)
                                                & (row < cfg.vocab))):
        raise AssertionError(f"moe serve lockstep: launches {lock_launches}"
                             f" (want {want}), tokens {row}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"moe serve: max_memory_allocated {peak / 2**30:.3f} GiB "
          f"(weights, caches and the warm-up, continuous and lockstep "
          f"runs)", flush=True)
    eng = rep.pop("engine")
    per_call, busy = phase_decode_profile(
        eng, counters=(dec_ops.COUNTER,), groups=MOE_GROUPS, ops=MOE_OPS)
    return {"launches": launches, "per": per, "rep": rep,
            "lockstep": {"launches": lock_launches, "tokens": emitted,
                         "tokens_per_s": lock["tokens_per_s"]},
            "max_memory_allocated": peak, "per_call": per_call,
            "busy": busy}


# ---------------------------------------------------------------------------
# phases 28-30: Jamba-1.5-Large, the hybrid family at full width
# ---------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"
# one period of Jamba's 72 layers (7 Mamba-2, 1 attention; MoE on the odd
# ones), and the experts this card holds: 0-3 of each MoE layer's 16, its
# share when four cards divide each MoE layer (expert parallel)
JAMBA_LAYERS = 8
JAMBA_SHARE = (0, 4)
# Jamba's attention: 64 query heads over 8 kv heads (a GQA group of 8, the
# decode kernel's whole 8-head CTA group), d 128, causal, no window; its
# Mamba-2 layers: 256 heads of 64, state 128
JAMBA_ATTN = dict(h=64, kv=8, d=128)
JAMBA_SSD = dict(h=256, p=64, n=128)
# hybrid parity, kernel path vs plain path in f32 at full width: logits of
# ~unit scale through 8 layers whose attention and scans sum in another
# order move by ~1e-5; 1e-3 still catches a wrong mask, position, state,
# chunk, expert or drop (those move logits by ~1e-1). Caches: 1e-3 of
# each leaf's max |value| (the SSM parity's rule)
HYBRID_PARITY_TOL = 1e-3
# the timed hybrid serving run: 8 slots, 16 requests of 244-256 prompt
# tokens (--prompt-len 248 + {-4, 0, 4, 8}: one SSD chunk at most, the
# chunk rule), 64 new, a cache of 1024, bf16, the kernels, capacity
# dispatch (the launcher's default without --smoke) over the share
HYBRID_SERVE_ARGV = ["--arch", JAMBA, "--engine", "continuous", "--slots",
                     "8", "--requests", "16", "--arrival", "0",
                     "--prompt-len", "248", "--max-new", "64", "--cache-len",
                     "1024", "--attn", "pallas", "--precision", "bf16",
                     "--temperature", "0", "--seed", "0"]
# device kernels by group on the hybrid path, first match wins
HYBRID_GROUPS = (KERNEL_GROUPS[0], KERNEL_GROUPS[3], KERNEL_GROUPS[4],
                 *MOE_GROUPS[2:])


def jamba_model():
    """(cfg, params): Jamba at full width, one period, this card's expert
    share, fp32 weights from a CUDA generator (built once for phases 29
    and 30)."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(JAMBA), n_layers=JAMBA_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = interop.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        experts=JAMBA_SHARE)
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in interop.leaves(params))
    print(f"hybrid: {JAMBA} at full width, {JAMBA_LAYERS} of 72 layers "
          f"(kinds {cfg.layer_kinds()}, MoE {cfg.moe_layer_mask()}), "
          f"experts {JAMBA_SHARE[0]}..{sum(JAMBA_SHARE) - 1} of 16, {n} "
          f"params ({4 * n / 1e9:.2f} GB f32), init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    return cfg, params


def phase_hybrid_kernels():
    """The three kernels of the hybrid serving path at Jamba's shapes, f32
    and bf16: ``flash_fwd`` (b 1, 64 heads over 8 kv, d 128, causal) over
    256 and 512 tokens; ``decode_attention`` (8 slots, the same heads, a
    GQA group of 8) over the serving path's linear cache of 1024 with
    ragged lengths (0 exactly zero) and at the serving state; ``ssd_scan``
    (256 heads of 64, state 128) at b 1 × l 244 (with an initial state)
    and 256, and b 8 × l 512 (two chunks) without and with an initial
    state. Returns the records: flash by (s, dtype), decode by dtype, the
    scan by (label, dtype)."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    a = JAMBA_ATTN
    flash, decode, scan = {}, {}, {}
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        dt = dtype_name(dtype)
        for s in (256, 512):
            flash[(s, dt)] = flash_case("jamba", 1, a["h"], s, a["d"], dtype,
                                        False, 80 + i, kv=a["kv"],
                                        causal=True)
        b, t = 8, 1024
        q, k, v = decode_inputs(b, a["h"], a["kv"], t, a["d"], dtype, 82 + i)
        group = dec_ops.launch_plan(q, k).group
        if group != 8:
            raise AssertionError(f"decode_attention: a GQA group of 8 ran "
                                 f"in a CTA group of {group}")
        lens = torch.tensor([0, 1, 255, 256, 257, t, 301, t - 5],
                            device="cuda")
        out, err = decode_check(
            f"jamba linear t={t} ragged {dt}", q, k, v,
            torch.arange(t, device="cuda")[None, :] < lens[:, None])
        if not bool((out[0] == 0).all()):
            raise AssertionError("decode_attention: a length-0 row is not "
                                 "exactly zero")
        # the serving state: 244-256 prompt tokens and up to 64 generated
        decode[dt] = decode_timed(
            "jamba linear serving", q, k, v,
            torch.tensor([248 + 7 * j for j in range(b)], device="cuda"),
            err)
        for label, b, l, init in (("jamba l=244", 1, 244, True),
                                  ("jamba l=256", 1, 256, False),
                                  ("jamba b=8 l=512", 8, 512, False),
                                  ("jamba b=8 l=512 init", 8, 512, True)):
            scan[(label, dt)] = ssd_case(label, b, l, dtype, 84 + i, init,
                                         **JAMBA_SSD)
    return flash, decode, scan


def phase_hybrid_parity(cfg, params, batch: int = 8, plen: int = 512,
                        steps: int = 8, clen: int = 1024):
    """Jamba at full width and one period, f32, this card's expert share,
    capacity dispatch (``moe_ffn``'s defaults): prefill of ``batch`` ×
    ``plen`` tokens (two SSD chunks), then ``steps`` decode steps over the
    ``batch`` slots, on the kernel path and the plain path
    (``routed_parity``, within ``HYBRID_PARITY_TOL``). The SSM, conv and
    KV caches agree within ``HYBRID_PARITY_TOL`` of each leaf's max
    |value| over the rows that stayed within the logit tolerance. Then
    the continuous engine against the lockstep engine, request by
    request, under dense dispatch (so that a row does not depend on its
    batch-mates' bucket places)."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import transformer as tf
    margs = {"experts": JAMBA_SHARE}
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(4, cfg.vocab, (batch, plen), generator=g,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    worst, near_tie_rows, n_diff, launches, state = routed_parity(
        "hybrid parity", cfg, params, toks, clen, steps, HYBRID_PARITY_TOL,
        (fa_ops.COUNTER, dec_ops.COUNTER, ssd_ops.COUNTER), margs)
    rows = sorted(set(range(batch)) - {r for _, r in near_tie_rows})
    cache_err = {}
    for r, (ck, cp) in enumerate(zip(state["kernel"][1], state["plain"][1])):
        for leaf, a, b in zip(ck._fields, ck, cp):
            a, b = a[:, rows].float(), b[:, rows].float()
            err = (a - b).abs().max().item()
            lim = HYBRID_PARITY_TOL * b.abs().max().item()
            key = f"{type(ck).__name__}.{leaf}"
            cache_err[key] = max(cache_err.get(key, 0.0), err)
            if not err <= lim:
                raise AssertionError(f"hybrid parity: position {r} {key} "
                                     f"max err {err:.3g} > {lim:.3g}")
    peak = torch.cuda.max_memory_allocated()
    n_attn = cfg.layer_kinds().count("attn")
    want = {"kernel": {"flash_fwd": n_attn,
                       "decode_attention": n_attn * steps,
                       "ssd_scan": cfg.n_layers - n_attn},
            "plain": {"flash_fwd": 0, "decode_attention": 0, "ssd_scan": 0}}
    print(f"hybrid parity ({JAMBA} f32, {cfg.n_layers} layers, experts "
          f"{JAMBA_SHARE}, capacity dispatch, {batch} x {plen} prefill + "
          f"{steps} steps over {batch} slots): max |logit diff| kernel vs "
          f"plain {worst:.3g} (tol {HYBRID_PARITY_TOL}); rows outside it at "
          f"a router near-tie: {len(near_tie_rows)} of "
          f"{batch * (steps + 1)}; pairs routed differently {n_diff}; "
          f"caches max err {cache_err} over {len(rows)} rows (tol "
          f"{HYBRID_PARITY_TOL} of max |value|); launches {launches}; peak "
          f"{peak / 2**30:.3f} GiB; {time.perf_counter() - t0:.2f}s",
          flush=True)
    if launches != want:
        raise AssertionError(f"hybrid parity: launches {launches}, want "
                             f"{want}")
    del state
    torch.cuda.empty_cache()
    dense = dict(margs, dispatch="dense")
    pcfg = dataclasses.replace(cfg, attn_impl="chunked")

    def plain_logits(seq):
        with plain_path():
            return tf.prefill(pcfg, params, {"tokens": seq},
                              precision="f32", moe_args=dense)[:, 0]

    with torch.no_grad():
        engines = engines_case(dataclasses.replace(cfg, attn_impl="pallas"),
                               params, [100, 37, 250, 64, 180, 12, 256, 90],
                               plain_logits, dense)
    return {"max_logit_diff": worst, "near_tie_rows": near_tie_rows,
            "routed_differently": n_diff, "cache_err": cache_err,
            "launches": launches["kernel"], "engines": engines,
            "max_memory_allocated": peak}


def phase_hybrid_serve(cfg, params):
    """Jamba at full width, one period, this card's expert share, bf16,
    the kernels, capacity dispatch, through the launcher's
    ``run_continuous`` (after one untimed warm-up request) and
    ``run_legacy`` (one lockstep request) on the weights of
    ``jamba_model``: tokens per second, decode-step median and p90,
    prefill ms, peak memory; flash_fwd and ssd_scan launches per prefill
    (one per attention and per Mamba layer: 1 and 7) and decode_attention
    launches per step (1), every token in
    the vocabulary; then profiles 4 warm decode steps (device time by
    group, by op and by function: the MoE FFN, the Mamba-2 decode; busy
    share)."""
    import math

    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib

    def argv(**changes):
        return serve.parse_args(with_flags(HYBRID_SERVE_ARGV, **changes))

    args = argv()
    # capacity dispatch (the launcher's default without --smoke) over the
    # experts this card holds
    moe_args = {**(serve.moe_args_for(args) or {}), "experts": JAMBA_SHARE}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve.run_continuous(cfg, params, argv(requests=1, max_new=4), moe_args)
    counters = (fa_ops.COUNTER, ssd_ops.COUNTER, dec_ops.COUNTER)
    for ctr in counters:
        ctr.reset()
    rep = serve.run_continuous(cfg, params, args, moe_args)
    launches = {ctr.name: ctr.count for ctr in counters}
    per = {"flash_fwd_per_prefill": launches["flash_fwd"] / rep["prefills"],
           "ssd_scan_per_prefill": launches["ssd_scan"] / rep["prefills"],
           "decode_attention_per_step": (launches["decode_attention"]
                                         / rep["decode_steps"])}
    print(f"hybrid serve (continuous, bf16, experts {JAMBA_SHARE}, 8 slots, "
          f"16 requests x 244-256 prompt tokens x 64 new, cache 1024): "
          f"decode {rep['decode_tokens_per_s']:.1f} tok/s over the warm "
          f"steps, {rep['tokens_per_s']:.1f} tok/s over the run (prefill "
          f"included); step median {rep['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{rep['step_p90_s'] * 1e3:.3f} ms over {rep['decode_steps']} "
          f"steps; prefill {rep['prefill_mean_s'] * 1e3:.3f} ms per "
          f"request; launches {launches}: {per}", flush=True)
    n_attn = cfg.layer_kinds().count("attn")         # 1 and 7 a period
    n_mamba = cfg.n_layers - n_attn
    want = {"flash_fwd_per_prefill": n_attn, "ssd_scan_per_prefill": n_mamba,
            "decode_attention_per_step": n_attn}
    if per != want:
        raise AssertionError(f"hybrid serve: launches {per}, want {want}")
    for rid, r in rep["results"].items():
        in_vocab = bool(np.all((r >= 0) & (r < cfg.vocab)))
        if not (in_vocab and (r.size == args.max_new or r[-1] == 3)):
            raise AssertionError(f"hybrid serve: bad tokens for request "
                                 f"{rid}: {r}")
    if rep["requests"] != args.requests or not math.isfinite(
            rep["decode_tokens_per_s"]):
        raise AssertionError(f"hybrid serve: {rep['requests']} of "
                             f"{args.requests} requests finished")

    for ctr in counters:
        ctr.reset()
    lock = serve.run_legacy(cfg, params, argv(engine="legacy", batch=1),
                            moe_args)
    row = lock["tokens"][0]
    stop = np.nonzero(row == 3)[0]
    emitted = int(stop[0]) + 1 if stop.size else row.size
    lock_launches = {ctr.name: ctr.count for ctr in counters}
    want = {"flash_fwd": n_attn, "ssd_scan": n_mamba,
            "decode_attention": n_attn * (emitted - 1)}
    print(f"hybrid serve (lockstep, 1 request x 248 prompt tokens): "
          f"{emitted} tokens, {lock['tokens_per_s']:.1f} tok/s (prefill "
          f"included); launches {lock_launches}", flush=True)
    if lock_launches != want or not bool(np.all((row >= 0)
                                                & (row < cfg.vocab))):
        raise AssertionError(f"hybrid serve lockstep: launches "
                             f"{lock_launches} (want {want}), tokens {row}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"hybrid serve: max_memory_allocated {peak / 2**30:.3f} GiB "
          f"(weights, caches and the warm-up, continuous and lockstep "
          f"runs)", flush=True)
    eng = rep.pop("engine")
    per_call, busy = phase_decode_profile(
        eng, prompt_len=248, counters=(dec_ops.COUNTER,),
        groups=HYBRID_GROUPS, ops=MOE_OPS,
        labelled={"MoE FFN (4 layers)": (moe_lib, "moe_ffn"),
                  "Mamba-2 decode (7 layers)": (ssm_lib, "mamba_decode")})
    return {"launches": launches, "per": per, "rep": rep,
            "lockstep": {"launches": lock_launches, "tokens": emitted,
                         "tokens_per_s": lock["tokens_per_s"]},
            "max_memory_allocated": peak, "per_call": per_call,
            "busy": busy}


# ---------------------------------------------------------------------------
# phase 23: the SSD scan's backward kernel
# ---------------------------------------------------------------------------

SSD_BWD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_bwd.cu"
SSD_BWD_REPLACES = ("none: the reference differentiates the jnp ssd_chunked "
                    "(src/repro/models/ssm.py:71) through XLA")
# the backward's sums over b·l (dA) and b·l·p (dD) take terms of either
# sign whose fp32 sums, in any order, carry ~1e-5 of the largest term
# (each case prints the plain fp32 version's own distance from an fp64
# evaluation beside the kernel's); the other gradients hold SSD_TOL_REL
SSD_GRAD_SUM_TOL_REL = 1e-4
SSD_GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")
# device kernels of one ssd_scan_bwd call (ops.ssd_scan_bwd's docstring):
# local term, carry, main kernel, sums
SSD_BWD_DEVICE_KERNELS = 4
# bf16 dx, dB, dC are the fp32 result rounded to bf16: one bf16 ulp (up to
# 2^-7 of |ref|) more per element, where autograd's bf16 gradient and the
# kernel's round across a boundary apart (half that against an fp32 ref)
BF16_GRAD_ULP = 2.0 ** -7


def ssd_grad_errs(label, got, ref, what):
    """Hold the seven gradients ``got`` against ``ref`` (plain, f32 or
    fp64): within SSD_TOL_REL of each one's max |ref| (dA, dD within
    SSD_GRAD_SUM_TOL_REL), a bf16 one within BF16_GRAD_ULP·|ref| more per
    element, all finite; returns the max abs errors by name."""
    import torch
    errs = {}
    for name, g, r in zip(SSD_GRAD_NAMES, got, ref):
        if r is None:
            if g is not None:
                raise AssertionError(f"{label}: {name} should be None")
            continue
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"{label}: {name} is not finite")
        r = r.to(torch.float64)
        err = (g.to(torch.float64) - r).abs()
        errs[name] = err.max().item()
        rel = SSD_GRAD_SUM_TOL_REL if name in ("dA", "dD") else SSD_TOL_REL
        lim = rel * r.abs().max().item()
        excess = err - (BF16_GRAD_ULP * r.abs() if g.dtype == torch.bfloat16
                        else 0.0)
        if not excess.max().item() <= lim:
            raise AssertionError(f"{label}: {name} max err {errs[name]:.3g} "
                                 f"against {what} (limit {rel}·max|ref| = "
                                 f"{lim:.3g})")
    return errs


def ssd_bwd_case(label, b, l, dtype, seed, init=False, dfinal=False, h=24,
                 p=64, n=128, timed=True):
    """The backward kernel against the plain backward ``ssd_chunked_bwd``
    (in the kernel's 64-token chunks where they divide l) and against
    autograd through ``ssd_chunked``, inputs as the mixer's split views;
    the plain version's and the kernel's distance from an fp64 evaluation
    printed beside; times kernel (events and device time) and plain
    version. Returns the case's record."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import (chunk_of, ssd_chunked,
                                                  ssd_chunked_bwd)
    args = ssd_inputs(b, l, dtype, seed, init, False, h, p, n)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    dy = torch.randn((b, l, h, p), generator=g, device="cuda")
    df = (torch.randn((b, h, p, n), generator=g, device="cuda") if dfinal
          else None)
    chunk = 64 if l % 64 == 0 else chunk_of(l, 256)
    _, final, states = ssd_ops._launch(*args, save_states=True)
    got = ssd_ops.ssd_scan_bwd(*args, states, final, dy, df)
    torch.cuda.synchronize()
    dt_name = dtype_name(dtype)
    shape = (f"{label}: b={b} l={l} h={h} p={p} n={n} {dt_name}"
             + (" init_state" if init else "") + (" dfinal" if dfinal
                                                  else ""))
    ref = ssd_chunked_bwd(*args, dy, df, chunk)
    errs = ssd_grad_errs(f"ssd_scan_bwd {shape}", got, ref,
                         "the plain backward")
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in args]
    yr, fr = ssd_chunked(*leaves[:5], chunk, leaves[6], leaves[5])
    loss = (yr * dy).sum() + ((fr * df).sum() if dfinal else 0)
    wanted = [t for t in leaves if t is not None]
    auto = iter(torch.autograd.grad(loss, wanted))
    auto = [None if t is None else next(auto) for t in leaves]
    del yr, fr, loss
    auto_errs = ssd_grad_errs(f"ssd_scan_bwd {shape}", got, auto,
                              "autograd through ssd_chunked")
    del auto
    ref64 = ssd_chunked_bwd(*(None if t is None else t.double()
                              for t in args), dy.double(),
                            None if df is None else df.double(), chunk)
    rel64 = {}
    for name, k, r32, r in zip(SSD_GRAD_NAMES, got, ref, ref64):
        if r is not None:
            scale = r.abs().max().item()
            rel64[name] = ((k.double() - r).abs().max().item() / scale,
                           (r32.double() - r).abs().max().item() / scale)
    del ref64
    plan = ssd_ops.ssd_bwd_plan(b, l, h, p, n, dtype)
    rec = {"shape": shape, "plan": plan._asdict(),
           "max_abs_err": max(errs.values()), "errs": errs,
           "autograd_errs": auto_errs,
           "fp64_rel": {k: {"kernel": v[0], "plain_f32": v[1]}
                        for k, v in rel64.items()},
           "library_ms": None}
    if timed:
        def call():
            ssd_ops.ssd_scan_bwd(*args, states, final, dy, df)
        rec["ms"] = time_ms(call, iters=10)
        # every device kernel of a call is seen, or the window is retaken
        rec["device_ms"], rec["device_kernels"] = device_ms(
            call, WRAPPER_KERNELS["ssd_scan_bwd"], iters=5,
            expect=SSD_BWD_DEVICE_KERNELS)
        rec["plain_ms"] = time_ms(lambda: ssd_chunked_bwd(
            *args, dy, df, chunk), iters=3, warmup=1)
        item = torch.finfo(dtype).bits // 8
        # the backward's least work is twice the forward's: each product
        # of the chunked form has two gradient products; fp32-accurate
        # (dy and the states are fp32 in both dtypes), so at split 3×TF32
        rec["bound_ms"], rec["bound_by"] = bound(
            *ssd_bwd_work(b, l, h, p, n, item, init, dfinal), dt_name,
            PEAK_3XTF32)
    print(f"ssd_scan_bwd {shape}: plan {tuple(plan)}; max abs err vs plain "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol "
          f"{SSD_TOL_REL}·max, dA and dD {SSD_GRAD_SUM_TOL_REL}·max), vs "
          f"autograd {max(auto_errs.values()):.3g}; relative to fp64 "
          f"(kernel, plain f32) "
          f"{ {k: (float(f'{a:.3g}'), float(f'{c:.3g}')) for k, (a, c) in rel64.items()} }"
          + (f"; kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f} "
             f"ms, {rec['device_kernels']} device kernels), plain "
             f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
             f"({rec['bound_by']})" if timed else ""), flush=True)
    return rec


def phase_ssd_bwd_kernel():
    """The SSD backward kernel at Mamba-2-130M's shapes (b 2 × l 4096, 16
    chunks of 256; b 1 × l 244 with an initial state and a final-state
    gradient), Jamba's (256 heads, b 1 × l 4096) and a rank's under ``tp``
    (``SSD_TP_SHAPES``), f32 and bf16, against
    the plain backward and autograd, each call's four device kernels all
    seen by the profiler; the same inputs twice give the same bits.
    Returns the records by (label, dtype name)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    recs = {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        dt = dtype_name(dtype)
        recs[("mamba2", dt)] = ssd_bwd_case("mamba2", 2, 4096, dtype, 80 + i)
        recs[("mamba2 l=244", dt)] = ssd_bwd_case(
            "mamba2 ragged", 1, 244, dtype, 82 + i, init=True, dfinal=True)
        recs[("jamba", dt)] = ssd_bwd_case("jamba", 1, 4096, dtype, 84 + i,
                                           **JAMBA_SSD)
        for label, b, l, h in SSD_TP_SHAPES:
            recs[(label, dt)] = ssd_bwd_case(label, b, l, dtype, 88 + i, h=h)
        args = ssd_inputs(2, 4096, dtype, 86 + i, init=True)
        dy = torch.randn((2, 4096, 24, 64), device="cuda")
        df = torch.randn((2, 24, 64, 128), device="cuda")
        _, final, states = ssd_ops._launch(*args, save_states=True)
        one = ssd_ops.ssd_scan_bwd(*args, states, final, dy, df)
        two = ssd_ops.ssd_scan_bwd(*args, states, final, dy, df)
        if not all(torch.equal(a, b) for a, b in zip(one, two)):
            raise AssertionError(f"ssd_scan_bwd {dt}: two runs on the same "
                                 f"inputs differ")
        print(f"ssd_scan_bwd {dt}: two runs on the same inputs give the "
              f"same bits (b 2 x l 4096, state in and out)", flush=True)
        del one, two, args, states, final
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 31-32: SSM training on the card
# ---------------------------------------------------------------------------

MAMBA = "mamba2-130m"
# the timed SSM training run: INPUT_SHAPES["train_4k"]'s sequence at b 2
SSM_TRAIN_ARGV = ["--mode", "lm", "--arch", MAMBA, "--batch", "2", "--seq",
                  "4096", "--steps", "4", "--seed", "0"]
# device kernels by group on the SSM training path, first match wins
SSM_TRAIN_GROUPS = (("ssd scan forward", ("ssd_scan_kernel",)),
                    ("ssd scan backward", ("ssd_bwd_",)),
                    *KERNEL_GROUPS[5:])


def ssd_counters():
    """The SSD scan's forward and backward launch counters."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return (ssd_ops.COUNTER, ssd_ops.BWD_COUNTER)


def lm_step_results(cfg, params, batch, lr, counters, moe_args=None,
                    to_host=False):
    """One f32 ``lm_loss`` step and ``run_lm``'s AdaFactorW update: (loss,
    gradients by leaf path, params after the update by leaf path,
    seconds), and the launches of ``counters`` in it. With ``to_host`` the
    trees go to host memory (a full-width MoE layer's gradients and
    updated params are 23 GB: one path's at a time on the card)."""
    import torch
    from repro_torch import interop
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdaFactorW, apply_updates
    for ctr in counters:
        ctr.reset()
    t0 = time.perf_counter()
    loss, _, grads = value_and_grad(
        lambda p: tf.lm_loss(cfg, p, batch, precision="f32",
                             moe_args=moe_args), params)
    opt = AdaFactorW(weight_decay=0.0025)
    updates, _ = opt.update(grads, opt.init(params), params, lr)
    new = apply_updates(params, updates)
    del updates
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    move = (lambda t: t.to("cpu")) if to_host else (lambda t: t)
    out = (loss.item(), {k: move(v) for k, v in interop.leaves(grads)},
           {k: move(v) for k, v in interop.leaves(new)}, secs)
    return out, launches


class OnCard(dict):
    """Leaves kept in host memory, each brought to the card when read."""

    def __getitem__(self, key):
        return super().__getitem__(key).to("cuda")


def f64_policy():
    """The precision policy of the float64 yardstick: parameters, compute,
    accumulation and projections in float64."""
    import torch
    from repro_torch.models.precision import Precision
    return Precision("f64", param_dtype=torch.float64,
                     compute_dtype=torch.float64,
                     accum_dtype=torch.float64, fp32_projections=False)


@contextlib.contextmanager
def fp64_plain_path():
    """The plain path (the scan's plain version, ``plain_path``) in
    float64, the yardstick of the f32 training parities: while it lasts,
    ``Tensor.float()``, with which the models keep their fp32 islands
    (dt, A, norms, logits, router), gives float64."""
    import torch

    def as_f64(self, memory_format=torch.preserve_format):
        return self.to(torch.float64, memory_format=memory_format)
    torch.Tensor.float = as_f64
    try:
        with plain_path():
            yield
    finally:
        del torch.Tensor.float


def lm_grads_f64(cfg, params, batch, moe_args=None):
    """(loss, gradients by leaf path) of one ``lm_loss`` of ``cfg`` (its
    ``attn_impl`` as given) in float64 on the plain path, from ``params``
    cast to float64."""
    import torch
    from repro_torch import interop
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map
    p64 = tree_map(lambda t: t.double(), params)
    with fp64_plain_path():
        loss, _, grads = value_and_grad(
            lambda p: tf.lm_loss(cfg, p, batch, precision=f64_policy(),
                                 moe_args=moe_args), p64)
    torch.cuda.synchronize()
    if loss.dtype != torch.float64:
        raise AssertionError(f"the float64 yardstick computed its loss in "
                             f"{loss.dtype}")
    return loss.item(), dict(interop.leaves(grads))


def fp64_distances(label, grads, g64):
    """Each path's f32 gradients (``grads[path]``: leaf path -> tensor)
    against the float64 plain path's ``g64``, leaf by leaf: max |g − g64|
    / max |g64|. Prints each path's worst leaf, both distances at the
    leaf where the two paths differ most from each other, and which path
    is farther from float64 (more than twice the other's distance);
    returns the summary."""
    rel = {path: {k: ((g[k].double() - r).abs().max()
                      / r.abs().max().clamp(min=1e-300)).item()
                  for k, r in g64.items()}
           for path, g in grads.items()}
    between = {k: ((grads["kernel"][k].double()
                    - grads["plain"][k].double()).abs().max()
                   / g64[k].abs().max().clamp(min=1e-300)).item()
               for k in g64}
    apart = max(between, key=between.get)
    out = {"between_worst_leaf": apart, "between": between[apart]}
    for path, r in rel.items():
        worst = max(r, key=r.get)
        out[f"{path}_vs_f64"] = r[worst]
        out[f"{path}_vs_f64_leaf"] = worst
        out[f"{path}_vs_f64_at_between_leaf"] = r[apart]
    k64, p64 = out["kernel_vs_f64"], out["plain_vs_f64"]
    far = ("the kernel path" if k64 > 2 * p64 else "the plain path"
           if p64 > 2 * k64 else "neither (within 2x of each other)")
    out["farther_from_f64"] = far
    print(f"{label} against a float64 plain path, leaf by leaf (max |g - "
          f"g64| / max |g64|): kernel path {out['kernel_vs_f64']:.3g} at "
          f"{out['kernel_vs_f64_leaf']}, plain path "
          f"{out['plain_vs_f64']:.3g} at {out['plain_vs_f64_leaf']}; the "
          f"paths differ most at {apart} ({between[apart]:.3g}), where the "
          f"kernel path is {out['kernel_vs_f64_at_between_leaf']:.3g} and "
          f"the plain path {out['plain_vs_f64_at_between_leaf']:.3g} from "
          f"float64; farther from float64: {far}", flush=True)
    return out


def phase_ssm_train_parity(batch: int = 2, seq: int = 1024,
                           lr: float = 1e-3):
    """One f32 step of Mamba-2-130M at full width and depth (b 2 × s
    1024) on the kernel path (the scan's forward and backward kernels) and
    the plain path (the scan's plain version, autograd), from one set of
    weights and one batch, held by ``check_step_parity``: 24 + 24 launches
    on the kernel path, none on the plain. Then one full-width Jamba
    Mamba-2 mixer layer (d 8192, 256 heads) forward and backward at b 1 ×
    l 4096 on both paths: every mixer leaf's gradient and the input's
    within TRAIN_GRAD_RTOL of its max. Both steps also hold each path
    against a float64 plain path, leaf by leaf (``fp64_distances``;
    printed, not gated)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import frontends
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tf

    cfg = get_arch(MAMBA)
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(9), "cuda")
    data = frontends.synthetic_inputs(cfg, batch, seq,
                                      np.random.default_rng(9),
                                      device="cuda")
    results, launches = {}, {}
    for path in ("kernel", "plain"):
        with plain_path() if path == "plain" else contextlib.nullcontext():
            results[path], launches[path] = lm_step_results(
                cfg, params, data, lr, ssd_counters())
    rec = check_step_parity(f"ssm train parity (Mamba-2-130M f32, b={batch} "
                            f"x s={seq})", results, lr, launches,
                            needed=cfg.n_layers)
    _, g64 = lm_grads_f64(cfg, params, data)
    rec["fp64"] = fp64_distances(
        f"ssm train parity (Mamba-2-130M f32, b={batch} x s={seq})",
        {path: r[1] for path, r in results.items()}, g64)
    del results, params, g64
    torch.cuda.empty_cache()

    jcfg = get_arch(JAMBA)
    g = torch.Generator(device="cuda").manual_seed(10)
    mixer = ssm_lib.init_ssm_params(jcfg, g, device="cuda")
    x = torch.randn((1, 4096, jcfg.d_model), generator=g, device="cuda")
    cot = torch.randn((1, 4096, jcfg.d_model), generator=g, device="cuda")
    grads, mix_launches = {}, {}
    for path in ("kernel", "plain", "fp64"):
        for ctr in ssd_counters():
            ctr.reset()
        cast = (lambda t: t.double()) if path == "fp64" else (lambda t: t)
        live = {k: cast(v).detach().requires_grad_()
                for k, v in mixer.items()}
        xin = cast(x).detach().requires_grad_()
        ctx = {"kernel": contextlib.nullcontext(), "plain": plain_path(),
               "fp64": fp64_plain_path()}[path]
        with ctx:
            out, _ = ssm_lib.mamba_mixer(live, jcfg, xin)
            (out * cast(cot)).sum().backward()
        torch.cuda.synchronize()
        grads[path] = {**{k: v.grad for k, v in live.items()}, "x": xin.grad}
        mix_launches[path] = {c.name: c.count for c in ssd_counters()}
        del live, xin, out
    g64 = grads.pop("fp64")
    del mix_launches["fp64"]
    mixer_fp64 = fp64_distances(
        f"jamba mixer layer (d {jcfg.d_model}, 256 heads, b 1 x l 4096, "
        f"f32)", grads, g64)
    del g64
    rel = {k: ((grads["kernel"][k] - g).abs().max()
               / g.abs().max().clamp(min=1e-30)).item()
           for k, g in grads["plain"].items()}
    worst = max(rel, key=rel.get)
    print(f"jamba mixer layer (d {jcfg.d_model}, 256 heads, b 1 x l 4096, "
          f"f32): largest relative gradient error {rel[worst]:.3g} at "
          f"{worst} (tol {TRAIN_GRAD_RTOL}) over {sorted(rel)}; launches "
          f"{mix_launches}", flush=True)
    if set(mix_launches["kernel"].values()) != {1} or max(
            mix_launches["plain"].values()) > 0:
        raise AssertionError(f"jamba mixer: the kernel path must launch the "
                             f"scan forward and backward once each and the "
                             f"plain path neither, got {mix_launches}")
    if not (rel[worst] <= TRAIN_GRAD_RTOL
            and all(bool((g.abs() > 0).any()) and bool(
                torch.isfinite(g).all()) for g in grads["kernel"].values())):
        raise AssertionError("jamba mixer: kernel path and plain path "
                             "gradients disagree, or one is zero or not "
                             "finite")
    del grads, mixer
    torch.cuda.empty_cache()
    return {**rec, "launches": launches["kernel"],
            "jamba_mixer_grad_rel_err": rel[worst],
            "jamba_mixer_fp64": mixer_fp64}


def timed_steps(label, cfg, params, opt_state, step_fn, batch, seq, steps,
                counters, seed=0):
    """``steps`` steps of ``step_fn`` on fresh synthetic batches of
    ``batch`` × ``seq`` tokens: warm step median, tokens/s, peak memory,
    losses, launches per step of ``counters``. Returns (record, params,
    opt_state)."""
    import math
    import statistics

    import numpy as np
    import torch
    from repro_torch.models import frontends
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    for ctr in counters:
        ctr.reset()
    step_s, losses = [], []
    for _ in range(steps):
        data = frontends.synthetic_inputs(cfg, batch, seq, rng,
                                          device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss, _ = step_fn(params, opt_state, data)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    median = statistics.median(step_s[1:])
    rec = {"warm_step_median_s": median,
           "tokens_per_s": batch * seq / median,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "step_s": step_s, "losses": losses,
           "launches_per_step": {c.name: c.count / steps for c in counters}}
    print(f"{label} (b {batch} x s {seq}): warm step median {median:.4f} s, "
          f"{rec['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
          f"{rec['max_memory_allocated'] / 2**30:.3f} GiB; step s "
          f"{[round(t, 4) for t in step_s]}; losses "
          f"{[round(v, 5) for v in losses]}; launches per step "
          f"{rec['launches_per_step']}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    return rec, params, opt_state


def phase_ssm_train_timed():
    """``--mode lm --arch mamba2-130m`` through the trainer's ``main`` at
    b 2 × s 4096, 4 steps (24 + 24 scan launches a step); a profile of one
    more warm step (by kernel group: the scan's forward and backward
    share, busy share); then ``make_train_step`` (bf16, remat basic) for 3
    steps at the same shape and a profile of one more of them by kernel
    group. Returns (total launches of the trainer's run, report)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf

    for ctr in ssd_counters():
        ctr.reset()
    rep = train.main(SSM_TRAIN_ARGV)
    steps = len(rep["losses"])
    launches = {c.name: c.count for c in ssd_counters()}
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"ssm train (Mamba-2-130M --mode lm f32, b 2 x s 4096): warm step "
          f"median {rep['warm_step_median_s']:.4f} s, "
          f"{rep['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
          f"{rep['max_memory_allocated'] / 2**30:.3f} GiB; step s "
          f"{[round(t, 4) for t in rep['step_s']]}; losses "
          f"{[round(v, 5) for v in rep['losses']]}; launches per step "
          f"{per_step}", flush=True)
    if set(per_step.values()) != {24}:
        raise AssertionError(f"ssm train: expected 24 ssd_scan and 24 "
                             f"ssd_scan_bwd launches a step, got {per_step}")
    rep["launches_per_step"] = per_step
    params, opt_state = rep.pop("params"), rep.pop("opt_state")
    by_group = {}
    rep["device_kernels_per_call"], rep["busy"] = lm_step_profile(
        params, opt_state, arch=MAMBA, batch=2, seq=4096,
        counters=ssd_counters(), groups=SSM_TRAIN_GROUPS, by_group=by_group)
    rep["profile_ms_by_group"] = by_group
    del params, opt_state
    torch.cuda.empty_cache()
    cfg = get_arch(MAMBA)
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), "cuda")
    step_fn, opt = make_train_step(cfg)
    rep["bf16"], params, opt_state = timed_steps(
        "ssm make_train_step (bf16, remat basic)", cfg, params,
        opt.init(params), step_fn, 2, 4096, 3, ssd_counters())
    bf16_groups = {}
    rep["bf16"]["device_kernels_per_call"], rep["bf16"]["busy"] = \
        lm_step_profile(params, opt_state, arch=MAMBA, batch=2, seq=4096,
                        counters=ssd_counters(), groups=SSM_TRAIN_GROUPS,
                        by_group=bf16_groups, step=step_fn,
                        label="1 warm bf16 make_train_step step")
    rep["bf16"]["profile_ms_by_group"] = bf16_groups
    del params, opt_state
    # remat basic runs each block's forward again in the backward
    if rep["bf16"]["launches_per_step"] != {"ssd_scan": 48,
                                            "ssd_scan_bwd": 24}:
        raise AssertionError(f"ssm bf16 step: expected 48 ssd_scan and 24 "
                             f"ssd_scan_bwd launches a step, got "
                             f"{rep['bf16']['launches_per_step']}")
    return launches, rep


# ---------------------------------------------------------------------------
# phases 33-34: MoE training at full width (Mixtral-8x22B, 1 of 56 layers)
# ---------------------------------------------------------------------------

MOE_TRAIN_LAYERS = 1
# the timed MoE training runs: run_lm's f32 computation (capacity
# dispatch) and make_train_step bf16, at b 1 × INPUT_SHAPES["train_4k"]'s
# sequence
MOE_TRAIN_SEQ = 4096


def phase_moe_train_flash():
    """The flash forward and backward at Mixtral's training shapes (b 1, 48
    heads over 8 kv, d 128, causal, window 4096) over 4096 tokens and over
    4608, where the window masks; f32 and bf16, against their plain
    versions, timed against SDPA with ``enable_gqa``; prints the backward
    plan's dq-partial bytes. Returns the records by (direction, s,
    dtype)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    a = MOE_ATTN
    recs = {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        dt = dtype_name(dtype)
        for s in (MOE_TRAIN_SEQ, 4608):
            recs[("fwd", s, dt)] = flash_case(
                "mixtral train", 1, a["h"], s, a["d"], dtype, False, 90 + i,
                kv=a["kv"], causal=True, window=a["window"])
            plan = fa_ops.bwd_plan(a["h"], s, s, a["d"], dtype)
            print(f"flash_bwd mixtral train s={s} {dt}: {plan.key_blocks} "
                  f"key blocks of {plan.key_block}, dq partial "
                  f"{plan.dq_part_floats * 4 / 1e9:.3f} GB", flush=True)
            recs[("bwd", s, dt)] = flash_bwd_case(
                "mixtral train", 1, a["h"], s, a["d"], dtype, False, 92 + i,
                causal=True, window=a["window"], kv=a["kv"])
            recs[("bwd", s, dt)]["dq_part_bytes"] = plan.dq_part_floats * 4
            torch.cuda.empty_cache()
    return recs


def phase_moe_train(parity_seq: int = 1024, lr: float = 1e-3):
    """Mixtral-8x22B at full width, 1 of its 56 layers (2.907G params,
    11.63 GB f32), weights built once: one f32 step at b 1 × s 1024 on the
    kernel path and the plain path (chunked attention), capacity dispatch,
    held by ``check_step_parity`` (one path's gradients on the card at a
    time); then ``run_lm``'s f32 ``lm_step`` (4 steps) and
    ``make_train_step`` bf16 with remat basic (3 steps) at b 1 × s 4096:
    step median, tokens/s, peak memory, flash launches per step."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import lm_step, make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdaFactorW, warmup_cosine

    cfg = dataclasses.replace(get_arch(MIXTRAL), n_layers=MOE_TRAIN_LAYERS,
                              attn_impl="pallas")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(11), "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in interop.leaves(params))
    print(f"moe train: {MIXTRAL} at full width, {MOE_TRAIN_LAYERS} of 56 "
          f"layers, {n} params ({4 * n / 1e9:.2f} GB f32), init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    parity = step_parity(
        f"moe train parity ({MIXTRAL} 1 layer f32, b=1 x s={parity_seq}, "
        f"capacity dispatch)", cfg, params, parity_seq, lr, 11,
        needed=MOE_TRAIN_LAYERS)

    opt = AdaFactorW(weight_decay=0.0025)
    step = lm_step(cfg, opt, warmup_cosine(lr, lr / 100, 1, 4),
                   precision="f32")
    f32, params, _ = timed_steps(
        "moe train (Mixtral-8x22B 1 layer, lm_step f32, capacity)", cfg,
        params, opt.init(params), step, 1, MOE_TRAIN_SEQ, 4, lm_counters())
    if set(f32["launches_per_step"].values()) != {MOE_TRAIN_LAYERS}:
        raise AssertionError(f"moe train: expected 1 flash_fwd and 1 "
                             f"flash_bwd launch a step, got "
                             f"{f32['launches_per_step']}")
    torch.cuda.empty_cache()
    step_fn, bopt = make_train_step(cfg)
    bf16, params, _ = timed_steps(
        "moe train (Mixtral-8x22B 1 layer, make_train_step bf16, remat "
        "basic)", cfg, params, bopt.init(params), step_fn, 1, MOE_TRAIN_SEQ,
        3, lm_counters())
    if bf16["launches_per_step"] != {"flash_fwd": 2, "flash_bwd": 1}:
        raise AssertionError(f"moe train bf16: expected 2 flash_fwd (remat "
                             f"basic) and 1 flash_bwd launch a step, got "
                             f"{bf16['launches_per_step']}")
    del params
    torch.cuda.empty_cache()
    return {"parity": parity, "f32": f32, "bf16": bf16, "params": n}


# ---------------------------------------------------------------------------
# phase 35: hybrid training on the card (Jamba-1.5-Large, smoke variant)
# ---------------------------------------------------------------------------


def phase_hybrid_train_parity(lr: float = 1e-3):
    """One f32 step of ``smoke_variant(jamba-1.5-large-398b)`` (b 2 × s
    64, dense dispatch, as ``--mode lm --smoke``) on the kernel path (flash
    forward and backward, the scan's forward and backward) and the plain
    path, held by ``check_step_parity``: every kernel of the path
    launches, and each path against a float64 plain path
    (``fp64_distances``); then ``--mode lm --smoke`` through the trainer's
    ``main``, 2 steps."""
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.launch import train
    from repro_torch.models import frontends
    from repro_torch.models import transformer as tf

    cfg = smoke_variant(get_arch(JAMBA))
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(12), "cuda")
    data = frontends.synthetic_inputs(cfg, 2, 64, np.random.default_rng(12),
                                      device="cuda")
    counters = (*lm_counters(), *ssd_counters())
    results, launches = {}, {}
    for path, attn in (("kernel", "pallas"), ("plain", "chunked")):
        pcfg = dataclasses.replace(cfg, attn_impl=attn)
        with plain_path() if path == "plain" else contextlib.nullcontext():
            results[path], launches[path] = lm_step_results(
                pcfg, params, data, lr, counters,
                moe_args={"dispatch": "dense"})
    rec = check_step_parity(f"hybrid train parity (smoke {JAMBA} f32, b=2 "
                            f"x s=64)", results, lr, launches)
    _, g64 = lm_grads_f64(dataclasses.replace(cfg, attn_impl="chunked"),
                          params, data, moe_args={"dispatch": "dense"})
    rec["fp64"] = fp64_distances(
        f"hybrid train parity (smoke {JAMBA} f32, b=2 x s=64)",
        {path: r[1] for path, r in results.items()}, g64)
    del g64
    for ctr in counters:
        ctr.reset()
    rep = train.main(["--mode", "lm", "--arch", JAMBA, "--smoke", "--steps",
                      "2", "--batch", "2", "--seq", "64"])
    cli = {c.name: c.count for c in counters}
    print(f"hybrid --mode lm --smoke on the card: losses {rep['losses']}; "
          f"launches {cli}", flush=True)
    if not all(math.isfinite(v) for v in rep["losses"]) or min(
            cli.values()) < 1:
        raise AssertionError(f"hybrid --mode lm --smoke: losses "
                             f"{rep['losses']}, launches {cli}")
    return {**rec, "launches": launches["kernel"], "cli_launches": cli}


# ---------------------------------------------------------------------------
# phases 36-40: the distributed trainer
# ---------------------------------------------------------------------------

DIST_D = 512                       # BASIC-S's embedding width
DIST_CHUNKS = (1024, 2048)         # B_local of the chunk kernels
DIST_RANKS = (2, 4)
DIST_LOG_TAU = -2.659              # ~ log 0.07
DIST_LOSS_B_LOCAL = 2048           # phase 37: global 4096 at R 2, 8192 at 4
DIST_TRAIN_ARGV = ["--arch", "basic-s", "--batch", "2048", "--num-micro",
                   "8", "--loss", "chunked", "--attn", "pallas", "--seq",
                   "16", "--steps", "4", "--quiet"]
DIST_GLOO_ARGV = ["--arch", "basic-s", "--batch", "256", "--num-micro", "2",
                  "--loss", "chunked", "--attn", "pallas", "--seq", "16",
                  "--precision", "f32", "--steps", "3", "--quiet"]
DIST_LM_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--seq", "1024",
                "--attn", "pallas",
                "--steps", "4", "--quiet"]
DIST_RESUME_RTOL = 1e-4            # tests/test_train_distributed.py:56
# phases 41-43: (world, model extent, --sharding) of the trainer on gloo
# ranks sharing the card: BASIC-S at full width on 1 layer a tower (of 8
# and 6), f32, global B 256, 1 step (its lr is constant, so the step
# moves every leaf), and Llama-3.2-1B at full width on 1 of its 16 layers,
# b 2 x s 1024, 2 steps (the warmup's lr is 0 at step 0), at (1, 2). The
# script's time limit keeps them this shallow: on an H100 41-43 took
# 461.7 s at 2 layers and 3 steps, the script 1078.4 s with phase 43
# alone there, and 1165.6 s at 2 steps with phases 44-47 added
WS_GRIDS = ((2, 2, "basic_ws"), (4, 2, "basic_ws"), (2, 2, "replicated"),
            (2, 2, "tp"), (4, 2, "tp"))
WS_MOVED_SHARE = 1e-3          # tests/test_torch_train_distributed.py:120-131
# the depth-cut configs: (base, name, layers) for register_cut_arch
WS_ARCHS = (("basic-s", "basic-s-1layer", 1),
            ("llama3.2-1b", "llama3.2-1b-1of16", 1),
            ("mamba2-130m", "mamba2-130m-2of24", 2),
            ("llama3.2-1b", "llama3.2-1b-2of16", 2))
WS_ARGV = ["--arch", WS_ARCHS[0][1]] + DIST_GLOO_ARGV[2:-3] + [
    "--steps", "1", "--quiet"]
WS_LM_ARGV = ["--arch", WS_ARCHS[1][1], "--batch", "2", "--seq", "1024",
              "--attn", "pallas", "--steps", "2", "--quiet", "--lr", "3e-3"]
# the runs of each rule: --sharding -> (contrastive argv, LM argv or None)
WS_RUNS = {"basic_ws": (WS_ARGV, WS_LM_ARGV), "replicated": (WS_ARGV, None),
           "tp": (WS_ARGV, WS_LM_ARGV)}
# phase 43's Mamba-2 mixer split by heads, train_lm under tp at (1, 2) in
# the world of 2, each with a checkpoint: Mamba-2-130M at full width on 2
# of its 24 layers, b 2 x s 1024, f32, 2 steps (12 of its 24 heads a
# rank), and the smoke Jamba (mixer, attention and expert-parallel MoE in
# one model; no full-width Jamba cut fits one card twice)
WS_SSM_RUNS = {
    "mamba2 1x2 tp": ["--arch", WS_ARCHS[2][1], "--batch", "2", "--seq",
                      "1024", "--steps", "2", "--quiet", "--lr", "3e-3"],
    "jamba smoke 1x2 tp": ["--arch", "jamba-1.5-large-398b", "--smoke",
                           "--batch", "4", "--seq", "64", "--attn",
                           "pallas", "--steps", "2", "--quiet", "--lr",
                           "3e-3"]}
# phase 56: the sharded serving steps (steps.make_prefill_step /
# make_serve_step on a rank's parts) on phase 43's world of 2, each case
# against the one-rank whole-weight steps on the plain path (the CPU,
# attention 'naive', the scan's plain version): (label, arch, its layers at
# full width (0: the smoke variant), rule, greedy decode steps), f32, b 4
# prompts of 512 into a linear cache of 1024. The basic_ws case takes 2
# steps, not 8: each of its passes all-gathers 2.6 GB of f32 leaves (the
# tied 1.05 GB embedding twice) through the host on the shared card, and
# its 9 passes took 60.4 s of the phase's 77.7 s (M9)
SERVE_SHARD_CASES = (
    ("llama 1x2 tp", "llama3.2-1b", 2, "tp", 8),
    ("llama 1x2 basic_ws", "llama3.2-1b", 2, "basic_ws", 2),
    ("mamba2 1x2 tp", "mamba2-130m", 2, "tp", 8),
    ("jamba smoke 1x2 tp", "jamba-1.5-large-398b", 0, "tp", 8))
SERVE_SHARD_SHAPE = {"batch": 4, "prompt": 512, "cache": 1024}
SERVE_SHARD_TOL = 1e-4      # of the plain one-rank step's largest |logit|
# phase 57: a KV cache's sequence split over the ranks of phase 56's world
# (context-parallel decode, steps.cache_seq_axis), f32, b 1, each case
# against the one-rank steps on the plain path on ``plain_device``: (label,
# arch, layers at full width (0: the smoke variant), rule, (data, model),
# prompt tokens, cache slots, greedy steps, plain_device). Llama-3.2-1B at
# (2, 1): the one row does not split over the two data ranks, so its
# cache's sequence lies over both and no weight is gathered; on its ring
# of 8192 (the window) after a prompt that wrapped it, and on a linear
# cache of 16384 after 1000 tokens (rank 1 sweeps no valid key). Smoke
# Jamba under basic_ws at (1, 2), a cache of 256 slots (past the head dim
# of 64, so the rule splits the sequence): its KV cache split, its SSM
# state whole; its plain path on the CPU (the scan's plain version). The
# prompts are whole 512-query blocks of 'chunked' or short enough for the
# materialised scores
SPLIT_CASES = (
    ("llama ring 2x1", "llama3.2-1b", 2, "basic_ws", (2, 1), 8704, 8192, 8,
     "cuda"),
    ("llama linear 2x1", "llama3.2-1b", 2, "basic_ws", (2, 1), 1000, 16384,
     8, "cuda"),
    ("jamba smoke basic_ws 1x2", "jamba-1.5-large-398b", 0, "basic_ws",
     (1, 2), 160, 256, 8, "cpu"))
# the decode kernel's lse output against its plain version, at the slice
# shapes of the split paths: (label, b, h, kv, t, d, dtype, valid keys a
# row): Llama-3.2-1B's slice of its ring over 2 (full), and Jamba-1.5-Large's
# rank shape at (1, 4) of a 524,288-slot cache after a 4096-token prompt
# and 64 steps (rank 0: 4160 valid keys; ranks 1-3: none)
SPLIT_LSE = (("llama ring slice", 1, 32, 8, 4096, 64, "float32", 4096),
             ("llama ring slice", 1, 32, 8, 4096, 64, "bfloat16", 4096),
             ("jamba rank 0 of 4", 1, 64, 8, 131072, 128, "bfloat16", 4160),
             ("jamba rank 1 of 4", 1, 64, 8, 131072, 128, "bfloat16", 0))
# lse against the plain version's: fp32 sums of exponentials in another
# order (bf16 products are exact in fp32), on values of ~log t
SPLIT_LSE_TOL = 2e-5
# the cross-shard loss against the single-device fused loss: the
# reference's own limits (tests/distributed_checks.py:79-83, :99-103), and
# under bf16 1e-3 on the loss, 2e-2 on dX
DIST_LOSS_TOL = {"float32": {"loss": 2e-6, "rtol": 1e-5, "atol": 1e-6,
                             "dtau": 1e-5},
                 "bfloat16": {"loss": 1e-3, "rtol": 0.0, "atol": 2e-2,
                              "dtau": 2e-2}}
# dX / dY of a chunk, and of the cross-shard loss, also within this share
# of the reference's largest entry: at a global b_norm without the
# diagonal a chunk's gradients are a few 1e-6, the size of the fused
# pair's f32 limit (CL_GRAD_TOL_F32); in bf16 the fused pair's own share
CHUNK_GRAD_SHARE = {"float32": 1e-5, "bfloat16": CL_GRAD_REL_MAX_BF16}


def chunk_grad_tol(ref, dt):
    """Max-abs limit on a chunk's or the cross-shard loss's dX or dY whose
    inputs were of dtype name ``dt``: CHUNK_GRAD_SHARE of max |ref|."""
    return CHUNK_GRAD_SHARE[dt] * ref.abs().max().item() + 1e-12


def cl_counters():
    """The fused contrastive pair's launch counters."""
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    return (cl_ops.FWD_COUNTER, cl_ops.BWD_COUNTER)


def dist_counters():
    """The kernels of the distributed trainer's contrastive path."""
    return (*lm_counters(), *cl_counters())


def chunk_case(b, dtype, seed):
    """``chunk_row_col_lse`` and ``chunk_grads`` at (B_local, 512) against
    their plain versions: the chunk's LSEs, then the gradients from global
    LSEs (the chunk's plus log R: R - 1 other chunks of like mass) at
    ``b_norm`` R·B_local, with and without the diagonal, R 2 and 4; times
    each (``with_diag=False``, R 4 for the backward) against its plain
    version, the library call and the bound."""
    import math

    import torch
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.contrastive_loss import ref as cl_ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, y = unit_rows(b, DIST_D, g, dtype), unit_rows(b, DIST_D, g, dtype)
    log_tau = torch.tensor(DIST_LOG_TAU, device="cuda")
    inv_tau = torch.exp(-log_tau)
    dt = dtype_name(dtype)
    shape = f"B_local={b} D={DIST_D} {dt}"
    row, col = cl_ops.chunk_row_col_lse(x, y, inv_tau)
    ref_row, ref_col = cl_ref.fwd_fused_ref(x, y, inv_tau)
    fwd_err = max((row - ref_row).abs().max().item(),
                  (col - ref_col).abs().max().item())
    if not fwd_err <= CL_LSE_TOL:
        raise AssertionError(f"chunk_row_col_lse {shape}: max lse err "
                             f"{fwd_err:.3g} (tol {CL_LSE_TOL})")
    bwd_err, bwd_share, cases = 0.0, 0.0, {}
    for ranks in DIST_RANKS:
        grow, gcol = ref_row + math.log(ranks), ref_col + math.log(ranks)
        for with_diag in (False, True):
            args = (x, y, inv_tau, grow, gcol)
            kw = dict(b_norm=ranks * b, with_diag=with_diag)
            got = cl_ops.chunk_grads(*args, **kw)
            ref = cl_ref.bwd_fused_ref(*args, **kw)
            gerr = max((got[0] - ref[0]).abs().max().item(),
                       (got[1] - ref[1]).abs().max().item())
            terr = abs((got[2] - ref[2]).item())
            gtol = min(chunk_grad_tol(ref[0], dt), chunk_grad_tol(ref[1], dt))
            gmax = min(ref[0].abs().max().item(), ref[1].abs().max().item())
            print(f"chunk_grads {shape} b_norm={ranks}B with_diag="
                  f"{with_diag}: max grad err {gerr:.3g} = {gerr / gmax:.3g}"
                  f" of max|ref| {gmax:.3g} (tol {gtol:.3g}), dlog_tau err "
                  f"{terr:.3g}", flush=True)
            if not (gerr <= gtol and terr <= CL_DTAU_RTOL[dt]
                    * abs(ref[2].item()) + 1e-6):
                raise AssertionError(f"chunk_grads {shape} b_norm={ranks}B "
                                     f"with_diag={with_diag}: max grad err "
                                     f"{gerr:.3g} (tol {gtol:.3g}), dlog_tau "
                                     f"err {terr:.3g}")
            bwd_err = max(bwd_err, gerr)
            bwd_share = max(bwd_share, gerr / gmax)
            cases[(ranks, with_diag)] = args, kw
    item = torch.finfo(dtype).bits // 8
    fwd = {"shape": shape, "max_abs_err": fwd_err,
           "ms": time_ms(lambda: cl_ops.chunk_row_col_lse(x, y, inv_tau)),
           "plain_ms": time_ms(lambda: cl_ref.fwd_fused_ref(x, y, inv_tau))}

    def lib_fwd():
        a = (x @ y.T).float() * inv_tau
        return torch.logsumexp(a, 1), torch.logsumexp(a, 0)

    fwd["library_ms"] = time_ms(lib_fwd)
    fwd["bound_ms"], fwd["bound_by"] = bound(
        *contrastive_fwd_work(b, b, DIST_D, item), dt)
    args, kw = cases[(4, False)]
    bwd = {"shape": f"{shape}, b_norm=4B_local, with_diag=False",
           "max_abs_err": bwd_err, "max_err_share": bwd_share,
           "ms": time_ms(lambda: cl_ops.chunk_grads(*args, **kw)),
           "plain_ms": time_ms(lambda: cl_ref.bwd_fused_ref(*args, **kw))}
    xr, yr, lr_ = (t.detach().clone().requires_grad_()
                   for t in (x, y, log_tau))
    with torch.no_grad():
        lfwd_ms = time_ms(lambda: cl_ref.loss_ref(xr, yr, lr_))
    bwd["library_ms"] = time_ms(lambda: torch.autograd.grad(
        cl_ref.loss_ref(xr, yr, lr_), (xr, yr, lr_))) - lfwd_ms
    bwd["bound_ms"], bwd["bound_by"] = bound(
        *contrastive_bwd_work(b, b, DIST_D, item), dt)
    for name, r in (("chunk_row_col_lse", fwd), ("chunk_grads", bwd)):
        print(f"{name} {r['shape']}: err {r['max_abs_err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return fwd, bwd


def phase_chunk_kernels():
    """Phase 36: the chunk kernels at B_local 1024 and 2048, f32 and
    bf16."""
    import torch
    return {(b, dtype_name(dt)): chunk_case(b, dt, seed=80 + i)
            for i, (b, dt) in enumerate(itertools.product(
                DIST_CHUNKS, (torch.float32, torch.bfloat16)))}


def cross_shard_worker(rank, world, b_local, seed):
    """One gloo rank of phase 37 on the card: the global embeddings drawn
    from ``seed`` (the same on every rank), the single-device fused loss
    and its gradients on all of them, and the rank's ``allgather`` and
    ``chunked`` losses on its rows, f32 and bf16. Returns, by (method,
    dtype), the loss, the reference loss, the dX / dY blocks' largest
    excess over the limit (<= 0 passes), distance and its share of max
    |ref|, the dlog_tau partial and the reference's, and the rank's
    contrastive launches in that case's cross-shard call only."""
    import torch
    from repro_torch.core import distributed_loss as dl
    from repro_torch.device import resolve_device
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.launch.mesh import make_local_mesh
    resolve_device("cuda")
    mesh = make_local_mesh()
    g = torch.Generator(device="cuda").manual_seed(seed)
    xg = unit_rows(world * b_local, DIST_D, g, torch.float32)
    yg = unit_rows(world * b_local, DIST_D, g, torch.float32)
    rows = slice(rank * b_local, (rank + 1) * b_local)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = DIST_LOSS_TOL[dtype_name(dt)]
        xf, yf = (t.to(dt, copy=True).requires_grad_() for t in (xg, yg))
        lt = torch.tensor(DIST_LOG_TAU, device="cuda", requires_grad=True)
        ref = cl_ops.fused_contrastive_loss(xf, yf, lt)
        rdx, rdy, rdt = torch.autograd.grad(ref, (xf, yf, lt))
        for method in dl.METHODS:
            xl = xg[rows].to(dt, copy=True).requires_grad_()
            yl = yg[rows].to(dt, copy=True).requires_grad_()
            ll = torch.tensor(DIST_LOG_TAU, device="cuda",
                              requires_grad=True)
            for c in cl_counters():
                c.reset()
            loss, _ = dl.make_global_loss_fn(mesh, method)(
                xl, yl, torch.exp(ll))
            dx, dy, dtau = torch.autograd.grad(loss, (xl, yl, ll))
            torch.cuda.synchronize()
            rec = {"loss": loss.item(), "ref_loss": ref.item(),
                   "dtau": dtau.item(), "ref_dtau": rdt.item(),
                   "launches": {c.name: c.count for c in cl_counters()}}
            for name, got, want in (("dx", dx, rdx[rows]),
                                    ("dy", dy, rdy[rows])):
                diff = (got.float() - want.float()).abs()
                want = want.float()
                rec[f"{name}_err"] = diff.max().item()
                rec[f"{name}_share"] = (rec[f"{name}_err"]
                                        / want.abs().max().item())
                rec[f"{name}_excess"] = max(
                    (diff - tol["atol"] - tol["rtol"]
                     * want.abs()).max().item(),
                    rec[f"{name}_err"] - chunk_grad_tol(want,
                                                        dtype_name(dt)))
            out[(method, dtype_name(dt))] = rec
    return out


def phase_cross_shard_loss():
    """Phase 37: ``allgather`` and ``chunked`` on 2 and 4 gloo ranks sharing
    the card (B_local 2048: global 4096 and 8192), against the
    single-device fused loss on the same global embeddings; every rank must
    have launched, for each dtype, one forward and one backward kernel for
    ``allgather`` and one of each per chunk (R) for ``chunked``. Not
    timed: the ranks share one card and gloo stages its collectives
    through the host."""
    from repro_torch.launch.spawn import run_world
    out = {}
    for world in DIST_RANKS:
        t0 = time.perf_counter()
        ranks = run_world(cross_shard_worker, world,
                          os.path.join(CKPT_ROOT, "rdv"), DIST_LOSS_B_LOCAL,
                          90 + world, timeout=300)
        for (method, dt), r0 in ranks[0].items():
            tol = DIST_LOSS_TOL[dt]
            recs = [r[(method, dt)] for r in ranks]
            losses = {r["loss"] for r in recs}
            dtau = sum(r["dtau"] for r in recs)
            loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
            dtau_rel = abs(dtau - r0["ref_dtau"]) / abs(r0["ref_dtau"])
            excess = max(max(r["dx_excess"], r["dy_excess"]) for r in recs)
            rec = {"shape": f"R={world} B={world * DIST_LOSS_B_LOCAL} "
                            f"D={DIST_D} {dt}",
                   "loss_rel_err": loss_rel, "dtau_rel_err": dtau_rel,
                   "dx_max_abs_err": max(r["dx_err"] for r in recs),
                   "dy_max_abs_err": max(r["dy_err"] for r in recs),
                   "grad_err_share": max(max(r["dx_share"], r["dy_share"])
                                         for r in recs)}
            want = {c.name: 1 if method == "allgather" else world
                    for c in cl_counters()}
            launches = [r["launches"] for r in recs]
            print(f"cross-shard {method} {rec['shape']}: loss rel err "
                  f"{loss_rel:.3g} (tol {tol['loss']}), dX max err "
                  f"{rec['dx_max_abs_err']:.3g}, dY {rec['dy_max_abs_err']:.3g}"
                  f" (at most {rec['grad_err_share']:.3g} of max|ref|, tol "
                  f"{CHUNK_GRAD_SHARE[dt]:.3g}), dlog_tau rel err "
                  f"{dtau_rel:.3g}; launches per rank {launches[0]}",
                  flush=True)
            if len(losses) != 1 or loss_rel > tol["loss"] or excess > 0 or \
                    dtau_rel > tol["dtau"]:
                raise AssertionError(f"cross-shard {method} {rec['shape']}: "
                                     f"{rec}, losses {losses}, excess "
                                     f"{excess:.3g}")
            if any(lr != want for lr in launches):
                raise AssertionError(f"cross-shard {method} {rec['shape']}: "
                                     f"launches per rank {launches}, want "
                                     f"{want} on each")
            out[(world, method, dt)] = dict(rec, launches=launches[0])
        print(f"cross-shard R={world}: {time.perf_counter() - t0:.1f} s, "
              f"untimed", flush=True)
    return out


def runlog_split(path):
    """From a trainer runlog: the step records' warm median (the first
    step of each segment left out), and each phase's share of the summed
    step time."""
    import statistics
    from repro_torch.obs import runlog
    recs = runlog.read_runlog(path)
    steps = [r for r in recs if r["kind"] == "step"]
    starts = {r["resumed_from"] for r in recs if r["kind"] == "resume"}
    warm = [r["step_s"] for i, r in enumerate(steps)
            if i and r["step"] not in starts] or [r["step_s"] for r in steps]
    total = sum(r["step_s"] for r in steps)
    split = {k: sum(r[k] for r in steps) / total
             for k in ("data_wait_s", "device_step_s", "ckpt_stall_s")}
    metrics = [r for r in recs if r["kind"] == "metrics"]
    stall = metrics[-1]["gauges"].get("ckpt/last_stall_s") if metrics \
        else None
    # the loader's own draw of a block on its prefetch thread (contrastive)
    draw = metrics[-1]["histograms"].get("data/gen_seconds{host=0}") \
        if metrics else None
    device = [r["device_step_s"] for i, r in enumerate(steps)
              if i and r["step"] not in starts]
    return {"warm_step_median_s": statistics.median(warm), "split": split,
            "ckpt_last_stall_s": stall, "steps": len(steps),
            "warm_device_step_median_s": statistics.median(device)
            if device else None,
            "draw_s": None if not draw or not draw["count"] else
            {"mean": draw["sum"] / draw["count"], "min": draw["min"],
             "max": draw["max"], "count": draw["count"]}}


def phase_dist_train():
    """Phase 38: the distributed trainer at R = 1 through its ``main``, at
    full width: BASIC-S, B 2048 in 8 microbatches, the chunked loss (the
    fused loss at one rank), bf16, 4 steps uninterrupted; then 4 steps cut
    at 2 (``--stop-after 2 --ckpt-every 2``) and ``--resume auto`` to 4,
    whose losses must equal the uninterrupted run's (6 steps cut at 4
    until the audio and vlm phases needed the script's time). Prints step median,
    pairs/s, peak memory, the last checkpoint stall and the runlog's
    data-wait / device-step / ckpt-stall split."""
    import math

    import torch
    from repro_torch.launch import train_distributed as td

    root = os.path.join(CKPT_ROOT, "dist_r1")
    shutil.rmtree(root, ignore_errors=True)
    for c in dist_counters():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    full = td.main(DIST_TRAIN_ARGV + ["--run-dir",
                                      os.path.join(root, "full")])
    peak = torch.cuda.max_memory_allocated()
    launches = {c.name: c.count for c in dist_counters()}
    d = os.path.join(root, "ck")
    cut = td.main(DIST_TRAIN_ARGV + ["--ckpt-dir", d, "--ckpt-every", "2",
                                     "--stop-after", "2"])
    rest = td.main(DIST_TRAIN_ARGV + ["--ckpt-dir", d, "--ckpt-every", "2"])
    clean = runlog_split(os.path.join(root, "full", "runlog.jsonl"))
    resumed = runlog_split(os.path.join(d, "runlog.jsonl"))
    rep = {"losses": full, "resumed_losses": cut + rest,
           "launches": launches,
           "launches_per_step": {k: v / len(full)
                                 for k, v in launches.items()},
           "max_memory_allocated": peak, **clean,
           "pairs_per_s": 2048 / clean["warm_step_median_s"],
           "resumed_split": resumed["split"],
           "ckpt_last_stall_s": resumed["ckpt_last_stall_s"]}
    print(f"dist train R=1 (BASIC-S bf16, B=2048 in 8, chunked): losses "
          f"{[round(v, 5) for v in full]}; cut at 2 and resumed "
          f"{[round(v, 5) for v in cut + rest]}; warm step median "
          f"{rep['warm_step_median_s']:.4f} s, {rep['pairs_per_s']:.1f} "
          f"pairs/s, max_memory_allocated {peak / 2**30:.3f} GiB; runlog "
          f"split {clean['split']} (resumed run {resumed['split']}); "
          f"ckpt/last_stall_s {rep['ckpt_last_stall_s']}; warm device "
          f"step median {clean['warm_device_step_median_s']:.4f} s; the "
          f"loader's draw of a block on its thread {clean['draw_s']}; "
          f"launches per step {rep['launches_per_step']}", flush=True)
    if not all(math.isfinite(v) for v in full) or len(cut) != 2 or \
            len(rest) != 2:
        raise AssertionError(f"dist train R=1: losses {full}, {cut}, {rest}")
    bad = [i for i, (a, b) in enumerate(zip(cut + rest, full))
           if abs(a - b) > DIST_RESUME_RTOL * abs(b)]
    if bad or min(launches.values()) < 1:
        raise AssertionError(f"dist train R=1: resumed steps {bad} differ "
                             f"from the uninterrupted run, or a kernel did "
                             f"not launch: {launches}")
    shutil.rmtree(root)
    return rep


def dist_train_worker(rank, world, argv):
    """One gloo rank of phase 39 on the card: the trainer's ``main``;
    returns its losses and its kernel launches."""
    from repro_torch.launch import train_distributed as td
    for c in dist_counters():
        c.reset()
    losses = td.main(argv)
    return losses, {c.name: c.count for c in dist_counters()}


def same_batch_r1(argv, n_hosts):
    """The one-rank run of a global batch: the trainer's state
    (``build_state`` from the seed) and step (``make_contrastive_step``,
    the fused loss at one rank) on the batches the loader's layout of
    ``n_hosts`` blocks gives (``ShardedLoader.global_batch_at``, its
    blocks joined in host order); returns (per-step losses, the initial
    and the final (params, opt_state) on the host)."""
    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.data.sharded import HostLayout, device_put_global
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    from repro_torch.tree import tree_leaves, unflatten
    args = td.parse_args(argv)
    device, mesh = td.setup(args)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_dual_variant(cfg)
    step_fn, opt = st.make_contrastive_step(
        cfg, num_micro=args.num_micro, remat=args.remat,
        precision=args.precision, attn=args.attn, lr=args.lr, mesh=mesh,
        loss=args.loss)
    params, opt_state = td.build_state(cfg, opt, args.seed, device)

    def host(tree):
        return unflatten(tree, [x.cpu() for x in tree_leaves(tree)])
    init = host((params, opt_state))
    loader = td.make_loader(args, cfg, HostLayout(n_hosts, 0))
    losses = []
    for step in range(args.steps):
        batch = device_put_global(loader.global_batch_at(step), device)
        params, opt_state, loss, _ = step_fn(params, opt_state, batch)
        losses.append(loss.item())
    return losses, init, host((params, opt_state))


def same_batch_r1_losses(argv):
    """The R = 1 run of phase 39's global batch (``same_batch_r1`` of the
    2-rank run's 2-host layout); returns the per-step losses."""
    return same_batch_r1(argv, 2)[0]


def phase_dist_train_gloo():
    """Phase 39: the trainer on 2 gloo ranks sharing the card (BASIC-S full
    width, f32, global B 256 in 2 microbatches a rank, 3 steps); every
    rank's losses must match the R = 1 run of the same global batch within
    rtol 1e-4, and every rank must launch the flash and contrastive
    kernels. Not timed (two ranks on one card)."""
    from repro_torch.launch.spawn import run_world
    argv = DIST_GLOO_ARGV + ["--device", "cuda"]
    t0 = time.perf_counter()
    ranks = run_world(dist_train_worker, 2, os.path.join(CKPT_ROOT, "rdv"),
                      argv, timeout=600)
    r1 = same_batch_r1_losses(argv)
    print(f"dist train R=2 gloo (BASIC-S f32, B=256): losses per rank "
          f"{[r[0] for r in ranks]}, R=1 on the same batch {r1}; launches "
          f"per rank {[r[1] for r in ranks]} "
          f"({time.perf_counter() - t0:.1f} s, untimed)", flush=True)
    for losses, launches in ranks:
        if len(losses) != len(r1) or any(
                abs(a - b) > DIST_RESUME_RTOL * abs(b)
                for a, b in zip(losses, r1)) or min(launches.values()) < 1:
            raise AssertionError(f"dist train R=2: losses {losses} vs R=1 "
                                 f"{r1}, launches {launches}")
    return {"losses": [r[0] for r in ranks], "r1_losses": r1,
            "launches": [r[1] for r in ranks]}


def phase_dist_train_lm():
    """Phase 40: ``train_lm`` through the trainer's ``main`` at R = 1,
    Llama-3.2-1B full width, f32, b 4 × s 1024: 3 steps then a checkpoint
    (params and AdaFactorW state), 1 resumed step, against 4 steps
    uninterrupted. Prints step, tokens/s, peak memory."""
    import math

    import torch
    from repro_torch.launch import train_distributed as td

    root = os.path.join(CKPT_ROOT, "dist_lm")
    shutil.rmtree(root, ignore_errors=True)
    for c in lm_counters():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    full = td.main(DIST_LM_ARGV + ["--run-dir", os.path.join(root, "full")])
    peak = torch.cuda.max_memory_allocated()
    launches = {c.name: c.count for c in lm_counters()}
    d = os.path.join(root, "ck")
    cut = td.main(DIST_LM_ARGV + ["--ckpt-dir", d, "--stop-after", "3",
                                  "--ckpt-keep", "1"])
    rest = td.main(DIST_LM_ARGV + ["--ckpt-dir", d, "--ckpt-keep", "1"])
    clean = runlog_split(os.path.join(root, "full", "runlog.jsonl"))
    rep = {"losses": full, "resumed_losses": cut + rest, **clean,
           "tokens_per_s": 4 * 1024 / clean["warm_step_median_s"],
           "max_memory_allocated": peak, "launches": launches,
           "ckpt_last_stall_s": runlog_split(os.path.join(
               d, "runlog.jsonl"))["ckpt_last_stall_s"]}
    print(f"dist train_lm R=1 (Llama-3.2-1B f32, b 4 x s 1024): losses "
          f"{[round(v, 5) for v in full]}, 3 + 1 resumed "
          f"{[round(v, 5) for v in cut + rest]}; warm step median "
          f"{rep['warm_step_median_s']:.4f} s, {rep['tokens_per_s']:.1f} "
          f"tokens/s, max_memory_allocated {peak / 2**30:.3f} GiB; split "
          f"{clean['split']}; last checkpoint stall "
          f"{rep['ckpt_last_stall_s']}; launches {launches}", flush=True)
    if not all(math.isfinite(v) for v in full) or len(cut) != 3 or any(
            abs(a - b) > DIST_RESUME_RTOL * abs(b)
            for a, b in zip(cut + rest, full)) or min(
            launches.values()) < 1:
        raise AssertionError(f"dist train_lm: {full} vs {cut} + {rest}, "
                             f"launches {launches}")
    shutil.rmtree(root)
    return rep


def ws_train_worker(rank, world, argvs, archs=(), serving=None):
    """One gloo rank of phases 41-43 on the card: the trainer's ``main``
    on each argv of ``argvs`` in turn (``archs``: depth-cut configs to
    register first, since a spawned rank imports this module afresh);
    returns, for each, its losses, its kernel launches in that run (the
    SSD scan's also by the shape its wrapper launched at, "b x l x h x p
    x n"), and the bytes its resident params and optimizer state take
    (``build_state`` on the same mesh, measured on the card, then
    freed). With ``serving`` = (cases, device, phase 57's cases) phases 56
    and 57 run after them on the same ranks (``serve_shard_rank``), their
    records last."""
    import torch
    from repro_torch.configs import (get_arch, smoke_dual_variant,
                                     smoke_variant)
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    from repro_torch.tree import tree_leaves
    for arch in archs:
        register_cut_arch(*arch)
    out = []
    for argv in argvs:
        for c in (*dist_counters(), *ssd_counters()):
            c.reset()
        losses = td.main(argv)
        launches = {c.name: c.count for c in dist_counters()}
        ssd = {c.name: {"launches": c.count, "shapes": {
            "x".join(map(str, k)): v for k, v in c.shapes.items()}}
            for c in ssd_counters()}
        args = td.parse_args(argv)
        device, mesh = td.setup(args)
        cfg = get_arch(args.arch)
        if args.smoke:
            cfg = smoke_dual_variant(cfg) if hasattr(cfg, "image_tower") \
                else smoke_variant(cfg)
        params, state = td.build_state(cfg, st.make_optimizer(), args.seed,
                                       device, mesh, args.sharding)
        nbytes = [sum(x.numel() * x.element_size() for x in tree_leaves(t))
                  for t in (params, state)]
        del params, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out.append({"losses": losses, "launches": launches, "ssd": ssd,
                    "params_bytes": nbytes[0], "state_bytes": nbytes[1]})
    if serving is not None:
        out.append(serve_shard_rank(*serving))
    return out


def register_cut_arch(base, name, layers):
    """Register ``base`` cut to its first ``layers`` layers (each tower's,
    for a dual encoder) as ``name``, at full width."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import register
    cfg = get_arch(base)
    if hasattr(cfg, "image_tower"):
        register(dataclasses.replace(
            cfg, name=name, image_tower=dataclasses.replace(
                cfg.image_tower, n_layers=layers),
            text_tower=dataclasses.replace(cfg.text_tower, n_layers=layers)))
    else:
        register(dataclasses.replace(cfg, name=name, n_layers=layers))


def expected_bytes(cfg, grid, sharding):
    """Per-rank bytes of the trainer's f32 params and bf16 first moment
    on a (data, model) ``grid`` under ``sharding``: 1/M of every leaf
    ``params_specs`` splits over the model axis plus the whole leaves."""
    import torch
    from repro_torch.core import sharding as shd
    from repro_torch.interop import init_params
    from repro_torch.launch.mesh import Mesh
    from repro_torch.tree import leaves
    whole = init_params(cfg, torch.Generator(), "meta")
    specs = dict(shd.spec_leaves(shd.params_specs(
        whole, Mesh({"data": grid[0], "model": grid[1]}), sharding)))
    p = m = 0
    for path, x in leaves(whole):
        share = grid[1] if "model" in specs[path] else 1
        p += x.numel() * 4 // share
        m += x.numel() * 2 // share
    return p, m


def leaf_distances(got, want, init):
    """Leaves of ``got`` farther from ``want`` than WS_MOVED_SHARE of the
    change the steps made (``want - init``): [(index, distance, moved)]."""
    import torch
    from repro_torch.tree import tree_leaves
    bad = []
    for i, (g, w, s) in enumerate(zip(*(tree_leaves(t)
                                         for t in (got, want, init)))):
        g, w, s = (t.double() for t in (g, w, s))
        moved = torch.linalg.vector_norm(w - s).item()
        dist = torch.linalg.vector_norm(g - w).item()
        if dist > WS_MOVED_SHARE * moved + 1e-7:
            bad.append((i, dist, moved))
    return bad


def ws_config(argv):
    """The config of a phase 41-43 run's ``argv`` (its ``--smoke`` variant
    in a CPU rehearsal)."""
    from repro_torch.launch import train_distributed as td
    return td.arch_config(td.parse_args(argv))


def phase_weight_sharding(runs=WS_RUNS, device="cuda", ssm_runs=WS_SSM_RUNS,
                          serve_cases=SERVE_SHARD_CASES,
                          split_cases=SPLIT_CASES):
    """Phases 41-43: the trainer with the paper's §5.1 weight sharding and
    with Megatron execution on gloo ranks sharing the card (untimed; two
    spawned worlds: one of 2 ranks runs the (1, 2) runs in turn, one of 4
    the (2, 2) runs; the gloo collectives go through the host).

    Phase 41: BASIC-S at full width on 1 layer a tower (``WS_RUNS``),
    f32, global B 256, 1 step, at (data 1, model 2) and (2, 2) under
    ``basic_ws`` and (1, 2) under ``replicated``. Each rank's losses must
    match the one-rank run on the same global batch within rtol 1e-4;
    each rank's resident params and first moment are 1/M of the split
    leaves plus the whole ones, in bytes (the optimizer state less than
    the whole state); the final checkpoint's whole leaves match the
    one-rank run's within 1e-3 of the change the steps made; every rank
    launches the flash and contrastive kernels.

    Phase 42: ``train_lm`` at (1, 2), Llama-3.2-1B at full width on 1 of
    its 16 layers, f32, b 2 x s 1024, 2 steps; each rank's losses against
    the one-rank run within rtol 1e-4, its params' bytes, and every rank
    launches the flash kernels.

    Phase 43: the same under ``--sharding tp`` (``WS_GRIDS``' 'tp' grids),
    contrastive and LM, with the same checks (the params' bytes
    ``expected_bytes(cfg, grid, 'tp')``); and the Mamba-2 mixer split by
    heads (``WS_SSM_RUNS``, ``train_lm`` under ``tp`` at (1, 2), in the
    world of 2): each rank's losses within 1e-5 of the one-rank run's,
    its params' bytes, its checkpoint's whole leaves within 1e-3 of the
    change the one-rank run made, and on every rank the SSD scan and its
    backward launched, every launch at the rank's H/M heads (12 for
    Mamba-2-130M), read from the shapes the wrapper saw; the hybrid's
    flash kernels too.

    Phases 56 and 57 run in the world of 2 after its trainer runs
    (``serve_cases``, ``split_cases``, ``serve_shard_rank``); their checks
    are ``phase_serve_shard``'s and ``phase_serve_split``'s, on what this
    returns.

    ``runs`` maps each rule to its (contrastive argv, LM argv or None)
    (``WS_RUNS``; a CPU rehearsal passes ``--smoke`` ones, ``ssm_runs``
    and smoke ``serve_cases`` to match, and ``device`` 'cpu'). Returns
    (the contrastive records by "<data>x<model> <sharding>", the LM
    records by sharding, the SSM runs' by their ``ssm_runs`` label, and
    each rank's phase 56 records with the world's seconds in them)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train_distributed as td
    from repro_torch.launch.spawn import run_world
    from repro_torch.tree import tree_leaves
    for arch in WS_ARCHS:
        register_cut_arch(*arch)
    t0 = time.perf_counter()

    def run(world, model, sharding):
        d = os.path.join(CKPT_ROOT, f"ws_{world // model}x{model}_{sharding}")
        shutil.rmtree(d, ignore_errors=True)
        return d, runs[sharding][0] + [
            "--device", device, "--model-parallel", str(model),
            "--sharding", sharding, "--ckpt-dir", d]
    grid_runs = {(w, m, sh): run(w, m, sh) for w, m, sh in WS_GRIDS}
    lm_shardings = [sh for sh, (_, lm) in runs.items() if lm is not None]
    lm_argvs = [runs[sh][1] + ["--device", device, "--model-parallel", "2",
                               "--sharding", sh] for sh in lm_shardings]

    def ssm_dir(label, ranks):
        d = os.path.join(CKPT_ROOT, f"ws_{label.replace(' ', '_')}_{ranks}")
        shutil.rmtree(d, ignore_errors=True)
        return d
    ssm_argvs = [argv + ["--device", device, "--model-parallel", "2",
                         "--sharding", "tp", "--ckpt-dir", ssm_dir(k, 2)]
                 for k, argv in ssm_runs.items()]
    worlds = {}
    for world in sorted({w for w, _, _ in WS_GRIDS}):
        keys = [k for k in WS_GRIDS if k[0] == world]
        argvs = [grid_runs[k][1] for k in keys] + (
            lm_argvs + ssm_argvs if world == 2 else [])
        t_world = time.perf_counter()
        ranks = run_world(ws_train_worker, world,
                          os.path.join(CKPT_ROOT, "rdv"), argvs,
                          WS_ARCHS, (serve_cases, device, split_cases)
                          if world == 2 else None, timeout=900)
        print(f"weight sharding world of {world}: "
              f"{time.perf_counter() - t_world:.1f} s", flush=True)
        if world == 2:
            serving = [r.pop() for r in ranks]
        for i, k in enumerate(keys):
            worlds[k] = [r[i] for r in ranks]
        if world == 2:
            lm_ranks = {sh: [r[len(keys) + i] for r in ranks]
                        for i, sh in enumerate(lm_shardings)}
            ssm_ranks = {k: [r[len(keys) + len(lm_shardings) + i]
                             for r in ranks]
                         for i, k in enumerate(ssm_runs)}
    r1, out = {}, {}
    for world, model, sharding in WS_GRIDS:
        data = world // model
        base = runs[sharding][0]
        cfg, steps = ws_config(base), td.parse_args(base).steps
        d = grid_runs[(world, model, sharding)][0]
        ranks = worlds[(world, model, sharding)]
        if (data, tuple(base)) not in r1:
            r1[(data, tuple(base))] = same_batch_r1(
                base + ["--device", device], data)
        losses, init, final = r1[(data, tuple(base))]
        got = ckpt.restore(d, steps, final, device="cpu")
        bad_leaves = leaf_distances(got, final, init)
        want_p, want_m = expected_bytes(cfg, (data, model), sharding)
        whole_state = sum(x.numel() * x.element_size() for x in tree_leaves(
            init[1]))
        key = f"{data}x{model} {sharding}"
        out[key] = {"losses": [r["losses"] for r in ranks],
                    "r1_losses": losses,
                    "launches": [r["launches"] for r in ranks],
                    "params_bytes": [r["params_bytes"] for r in ranks],
                    "state_bytes": [r["state_bytes"] for r in ranks],
                    "expected_params_bytes": want_p,
                    "first_moment_bytes": want_m,
                    "whole_state_bytes": whole_state,
                    "checkpoint_leaves_off": bad_leaves}
        print(f"weight sharding {key} ({cfg.name} f32, B=256, {steps} "
              f"steps): losses per rank {out[key]['losses']}, R=1 on the "
              f"same batch {losses}; params bytes per rank "
              f"{out[key]['params_bytes']} (expected {want_p}); optimizer "
              f"state bytes per rank {out[key]['state_bytes']} (first "
              f"moment {want_m}, whole state {whole_state}); checkpoint "
              f"leaves beyond {WS_MOVED_SHARE} of their move: {bad_leaves}; "
              f"launches per rank {out[key]['launches']}", flush=True)
        shutil.rmtree(d)
        for r in ranks:
            split = sharding != "replicated"
            if len(r["losses"]) != len(losses) or any(
                    abs(a - b) > DIST_RESUME_RTOL * abs(b)
                    for a, b in zip(r["losses"], losses)) or \
                    min(r["launches"].values()) < 1 or \
                    r["params_bytes"] != want_p or bad_leaves or \
                    not (want_m < r["state_bytes"] <= whole_state) or \
                    split != (r["state_bytes"] < whole_state):
                raise AssertionError(f"weight sharding {key}: {out[key]}")
    lm, lm_r1s = {}, {}
    for sh, sh_ranks in lm_ranks.items():
        argv = tuple(runs[sh][1])
        if argv not in lm_r1s:
            lm_r1s[argv] = td.main(list(argv) + ["--device", device])
        lm_r1 = lm_r1s[argv]
        lm_cfg = ws_config(runs[sh][1])
        want_p, _ = expected_bytes(lm_cfg, (1, 2), sh)
        rec = lm[sh] = {
            "losses": [r["losses"] for r in sh_ranks], "r1_losses": lm_r1,
            "launches": [{k: v for k, v in r["launches"].items()
                          if k in {c.name for c in lm_counters()}}
                         for r in sh_ranks],
            "params_bytes": [r["params_bytes"] for r in sh_ranks],
            "expected_params_bytes": want_p}
        print(f"weight sharding train_lm 1x2 {sh} ({lm_cfg.name} f32, b 2 x "
              f"s 1024): losses per rank {rec['losses']}, R=1 {lm_r1}; "
              f"params bytes per rank {rec['params_bytes']} (expected "
              f"{want_p}); launches per rank {rec['launches']}", flush=True)
        for r, launches in zip(sh_ranks, rec["launches"]):
            if any(abs(a - b) > DIST_RESUME_RTOL * abs(b)
                   for a, b in zip(r["losses"], lm_r1)) or \
                    len(r["losses"]) != len(lm_r1) or \
                    min(launches.values()) < 1 or \
                    r["params_bytes"] != want_p:
                raise AssertionError(f"weight sharding train_lm {sh}: {rec}")
    ssm = {label: ws_ssm_check(label, ssm_runs[label], r, device,
                               ssm_dir(label, 1))
           for label, r in ssm_ranks.items()}
    for i, label in enumerate(ssm_runs):
        shutil.rmtree(ssm_argvs[i][-1], ignore_errors=True)
    print(f"weight sharding phases 41-43: {time.perf_counter() - t0:.1f} s "
          f"(untimed)", flush=True)
    return out, lm, ssm, serving


# each rank of a phase 43 SSM run against the one-rank run: losses
WS_SSM_RTOL = 1e-5


def ws_ssm_check(label, argv, ranks, device, r1_dir):
    """Phase 43's checks of one ``WS_SSM_RUNS`` run at (1, 2) under
    ``tp`` (``ranks``: each rank's ``ws_train_worker`` record; its
    checkpoint in the ``--ckpt-dir`` of its argv) against the one-rank
    run of ``argv`` (checkpoint under ``r1_dir``): losses within
    WS_SSM_RTOL, params' bytes, the checkpoint's leaves within
    WS_MOVED_SHARE of the change the one-rank run made from the seeded
    state, the SSD scan and its backward launched on every rank at H/M
    heads only, the flash kernels where the model has attention. Returns
    the record."""
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train_distributed as td
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.optim import AdaFactorW
    from repro_torch.tree import tree_leaves, unflatten
    args = td.parse_args(argv)
    cfg = td.arch_config(args)
    want_heads = ssm_lib.dims(cfg)[1] // 2
    r1 = td.main(argv + ["--device", device, "--ckpt-dir", r1_dir])
    init = td.build_state(cfg, AdaFactorW(weight_decay=0.0025), args.seed,
                          device)
    init = unflatten(init, [x.cpu() for x in tree_leaves(init)])
    final = ckpt.restore(r1_dir, args.steps, init, device="cpu")
    d = os.path.join(CKPT_ROOT, f"ws_{label.replace(' ', '_')}_2")
    got = ckpt.restore(d, args.steps, init, device="cpu")
    bad_leaves = leaf_distances(got, final, init)
    shutil.rmtree(r1_dir)
    want_p, _ = expected_bytes(cfg, (1, 2), "tp")
    kernels = {c.name for c in ssd_counters()} | (
        {c.name for c in lm_counters()} if cfg.family == "hybrid" else set())
    rec = {"losses": [r["losses"] for r in ranks], "r1_losses": r1,
           "launches": [{**{k: v for k, v in r["launches"].items()
                            if k in kernels},
                         **{k: v["launches"] for k, v in r["ssd"].items()}}
                        for r in ranks],
           "ssd_shapes": [{k: v["shapes"] for k, v in r["ssd"].items()}
                          for r in ranks],
           "heads": want_heads,
           "params_bytes": [r["params_bytes"] for r in ranks],
           "expected_params_bytes": want_p,
           "checkpoint_leaves_off": bad_leaves}
    print(f"weight sharding train_lm {label} ({cfg.name} "
          f"{args.batch} x {args.seq}, {args.steps} steps): losses per rank "
          f"{rec['losses']}, R=1 {r1}; params bytes per rank "
          f"{rec['params_bytes']} (expected {want_p}); checkpoint leaves "
          f"beyond {WS_MOVED_SHARE} of their move: {bad_leaves}; launches "
          f"per rank {rec['launches']}; ssd shapes per rank (b x l x h x p "
          f"x n) {rec['ssd_shapes']}", flush=True)
    for r, launches, shapes in zip(ranks, rec["launches"],
                                   rec["ssd_shapes"]):
        seen = {int(k.split("x")[2]) for by in shapes.values() for k in by}
        if len(r["losses"]) != len(r1) or any(
                abs(a - b) > WS_SSM_RTOL * abs(b)
                for a, b in zip(r["losses"], r1)) or \
                min(launches.values()) < 1 or seen != {want_heads} or \
                r["params_bytes"] != want_p or bad_leaves:
            raise AssertionError(f"weight sharding train_lm {label}: {rec}")
    return rec


def serve_shard_model(arch, layers, device):
    """(cfg, whole params) of a phase 56 case: ``arch`` cut to its first
    ``layers`` layers at full width (0: its smoke variant) on the kernels
    ('pallas'), f32 params drawn from seed 0 on ``device``."""
    import torch
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.interop import init_params
    cfg = get_arch(arch)
    cfg = (dataclasses.replace(cfg, n_layers=layers) if layers
           else smoke_variant(cfg))
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, gen, device)


def serve_shard_prompt(cfg, device):
    """Phase 56's prompts: (b, prompt) int32 tokens from seed 0."""
    import torch
    g = torch.Generator().manual_seed(0)
    return torch.randint(4, cfg.vocab, (SERVE_SHARD_SHAPE["batch"],
                                        SERVE_SHARD_SHAPE["prompt"]),
                         generator=g, dtype=torch.int32).to(device)


def serve_shard_steps(cfg, params, prompt, steps, feed=None, mesh=None,
                      layout=None, cache=SERVE_SHARD_SHAPE["cache"],
                      seq_axis=None, out_caches=None):
    """The prefill of ``prompt`` (b, s) into a cache of ``cache`` slots and
    ``steps`` decode steps at positions s, s + 1, ..., f32, each step fed
    the last greedy token (or ``feed``'s tokens (steps + 1, b)), the KV
    caches' sequence over ``seq_axis``: returns the last-position logits
    (steps + 1, b, vocab) and the tokens fed (steps + 1, b), on the CPU
    (and the caches after the last step into the list ``out_caches``)."""
    import torch
    from repro_torch.launch import steps as st
    kw = {"precision": "f32", "mesh": mesh, "layout": layout,
          "seq_axis": seq_axis}
    start = prompt.shape[1]
    with torch.no_grad():
        logits, caches = st.make_prefill_step(
            cfg, collect_cache_len=cache, **kw)(params, {"tokens": prompt})
        serve = st.make_serve_step(cfg, **kw)
        out, fed = [logits[:, 0].cpu()], []
        for i in range(steps + 1):
            tok = (logits[:, 0].argmax(-1) if feed is None
                   else feed[i].to(logits.device)).to(torch.int32)
            fed.append(tok.cpu())
            if i == steps:
                break
            logits, caches = serve(params, caches, tok[:, None], start + i)
            out.append(logits[:, 0].cpu())
    if out_caches is not None:
        out_caches.extend(caches)
    return torch.stack(out), torch.stack(fed)


def serve_shard_rank(cases, device, split_cases=()):
    """Phase 56 on this rank of phase 43's world of 2: for each case the
    whole params are drawn and cut to the rank's parts under the case's
    rule (``steps.serving_layout`` on the (1, 2) mesh), then
    prefill and greedy decode on them (``serve_shard_steps``); then phase
    57's ``split_cases`` (``serve_split_rank``). Returns
    {"serving": {label: {logits, tokens (numpy), launches and shapes by kernel,
    params_bytes, cache_bytes, seconds}}, "split": phase 57's records}."""
    import torch
    from repro_torch.core import weight_sharding as ws
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves
    mesh = make_local_mesh(model=2)
    counters = (fa_ops.COUNTER, dec_ops.COUNTER, ssd_ops.COUNTER)
    out = {}
    for label, arch, layers, rule, steps in cases:
        t0 = time.perf_counter()
        cfg, whole = serve_shard_model(arch, layers, device)
        layout = st.serving_layout(cfg, mesh, rule)
        params = ws.cut(whole, layout)
        del whole
        placed = time.perf_counter() - t0
        caches = tf.init_caches(cfg, SERVE_SHARD_SHAPE["batch"],
                                SERVE_SHARD_SHAPE["cache"], torch.float32,
                                device="meta", layout=layout)
        for c in counters:
            c.reset()
        logits, tokens = serve_shard_steps(
            cfg, params, serve_shard_prompt(cfg, device), steps, mesh=mesh,
            layout=layout)
        # numpy: a tensor sent to the parent would share a storage that
        # ends with this process
        out[label] = {
            "logits": logits.numpy(), "tokens": tokens.numpy(),
            "launches": {c.name: c.count for c in counters},
            "shapes": {c.name: {"x".join(map(str, k)): v
                                for k, v in c.shapes.items()}
                       for c in counters},
            "params_bytes": sum(x.numel() * x.element_size()
                                for x in tree_leaves(params)),
            "cache_bytes": sum(x.numel() * x.element_size()
                               for x in tree_leaves(caches)),
            "seconds": time.perf_counter() - t0, "place_seconds": placed}
        del params
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return {"serving": out, "split": serve_split_rank(split_cases, device)}


def serve_shard_want(cfg, rule):
    """The (flash "bh x bkv", decode "h x kv", SSD heads) a rank of phase
    56 launches at under ``rule`` at (1, 2), batch b: its H/2 query and
    KV/2 kv heads and H_ssd/2 SSD heads under 'tp', all of them under
    ``basic_ws``; None where the model has no such layer."""
    from repro_torch.models import ssm as ssm_lib
    m = 2 if rule == "tp" else 1
    b = SERVE_SHARD_SHAPE["batch"]
    attn = cfg.family != "ssm"
    return ((f"{b * cfg.n_heads // m}x{b * cfg.n_kv_heads // m}"
             if attn else None),
            f"{cfg.n_heads // m}x{cfg.n_kv_heads // m}" if attn else None,
            ssm_lib.dims(cfg)[1] // m if cfg.ssm is not None else None)


def phase_serve_shard(ranks, device="cuda", cases=SERVE_SHARD_CASES):
    """Phase 56: the port's sharded serving steps on two gloo ranks sharing
    the card (run in phase 43's world, ``serve_shard_rank``; ``ranks``:
    each rank's records), each case held to the one-rank whole-weight
    steps on the plain path: the same weights (drawn on ``device``) and
    prompts on the CPU, attention 'naive' (the reference's einsum decode
    and plain prefill) and the SSD scan's plain version, fed the same
    greedy tokens. So each rank's kernels, at its local shapes, are held
    to their plain versions on the same inputs: every rank's logits
    within SERVE_SHARD_TOL of the plain step's largest |logit|, both
    ranks' greedy tokens alike and equal to the plain step's wherever its
    top-2 gap exceeds the error, and every rank launched the flash and
    decode kernels (and the scan, for a Mamba layer) at its local heads,
    read from the launch counters' shapes. ``cases``: the
    ``serve_cases`` phase 43's world ran (smoke ones in a CPU rehearsal,
    with ``device`` 'cpu'). Returns the records by label."""
    import torch
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    out = {}
    for label, arch, layers, rule, steps in cases:
        recs = [dict(r["serving"][label], **{
            k: torch.from_numpy(r["serving"][label][k])
            for k in ("logits", "tokens")}) for r in ranks]
        cfg, whole = serve_shard_model(arch, layers, device)
        whole = tree_map(lambda x: x.cpu(), whole)
        tw = time.perf_counter()
        want, _ = serve_shard_steps(
            dataclasses.replace(cfg, attn_impl="naive"), whole,
            serve_shard_prompt(cfg, "cpu"), steps, feed=recs[0]["tokens"])
        want_s = time.perf_counter() - tw
        del whole
        scale = want.abs().max().item()
        errs = [(r["logits"] - want).abs().max().item() for r in recs]
        sep = top2_gap(want) > max(errs)
        flips = [int(((r["tokens"] != want.argmax(-1)) & sep).sum())
                 for r in recs]
        flash, dec, heads = serve_shard_want(cfg, rule)
        seen = [({k.rsplit("x", 3)[0] for k in r["shapes"]["flash_fwd"]},
                 {"x".join(k.split("x")[1:3])
                  for k in r["shapes"]["decode_attention"]},
                 {int(k.split("x")[2]) for k in r["shapes"]["ssd_scan"]})
                for r in recs]
        rec = out[label] = {
            "max_logit_diff": errs, "max_abs_logit": scale,
            "greedy_flips": flips,
            "ranks_tokens_equal": bool(torch.equal(recs[0]["tokens"],
                                                   recs[1]["tokens"])),
            "launches": [r["launches"] for r in recs],
            "shapes": [r["shapes"] for r in recs],
            "params_bytes": [r["params_bytes"] for r in recs],
            "cache_bytes": [r["cache_bytes"] for r in recs],
            "rank_seconds": [r["seconds"] for r in recs],
            "plain_seconds": want_s}
        print(f"sharded serving {label} ({cfg.name}, {cfg.n_layers} layers, "
              f"f32, b {SERVE_SHARD_SHAPE['batch']} x "
              f"{SERVE_SHARD_SHAPE['prompt']}, {steps} steps): max |logit "
              f"diff| vs one rank's plain path on the CPU ({want_s:.1f} s) "
              f"{errs} (tol "
              f"{SERVE_SHARD_TOL} x {scale:.4g}); greedy flips past the "
              f"error {flips}; ranks' tokens equal "
              f"{rec['ranks_tokens_equal']}; launches per rank "
              f"{rec['launches']}; shapes per rank {rec['shapes']}; params "
              f"bytes {rec['params_bytes']}, cache bytes "
              f"{rec['cache_bytes']}; seconds a rank "
              f"{[round(x, 2) for x in rec['rank_seconds']]} (placing the "
              f"params {[round(r['place_seconds'], 2) for r in recs]})",
              flush=True)
        launched = all(
            (flash is None or (r["launches"]["flash_fwd"] > 0
                               and got[0] == {flash}))
            and (dec is None or (r["launches"]["decode_attention"] > 0
                                 and got[1] == {dec}))
            and (heads is None or (r["launches"]["ssd_scan"] > 0
                                   and got[2] == {heads}))
            for r, got in zip(recs, seen))
        if device == "cpu":     # the plain versions launch nothing
            launched = True
        if not (max(errs) <= SERVE_SHARD_TOL * scale and not any(flips)
                and rec["ranks_tokens_equal"] and launched):
            raise AssertionError(f"sharded serving {label}: {rec}")
    world_s = max(sum(r["seconds"] for r in x["serving"].values())
                  for x in ranks)
    print(f"phase 56 sharded serving: {time.perf_counter() - t0:.1f} s here "
          f"+ {world_s:.1f} s in the world of 2", flush=True)
    return out


# the kernels at a rank's shapes under --sharding tp on the sharded serving
# paths (label, dtype name, b, query heads, kv heads, d, prompt s, cache t,
# the rows' valid entries at the serving state): phase 56's Llama-3.2-1B at
# M 2 (f32, b 4 x 512 prompts, a cache of 1024, 8 steps), and
# scripts/serve_sharded_probe.py's InternVL2-76B and Jamba-1.5-Large at M 4
# (bf16, b 8 x 512, a cache of 4096, 64 steps; both 16 query heads over 2
# kv heads of 128 a rank)
SERVE_TP_ATTN = (("llama tp rank M=2", "float32", 4, 16, 4, 64, 512, 1024,
                  516),
                 ("internvl2 / jamba tp rank M=4", "bfloat16", 8, 16, 2, 128,
                  512, 4096, 544))
# the scan there: phase 56's Mamba-2-130M at M 2 (f32, 12 heads) and the
# probe's Jamba-1.5-Large at M 4 (bf16, 64 heads of 64, state 128)
SERVE_TP_SSD = (("mamba2 tp rank M=2 serving", "float32", 4, 512, 12),
                ("jamba tp rank M=4 serving", "bfloat16", 8, 512, 64))


def phase_serve_shard_kernels():
    """Phase 56's kernels at a rank's shapes on the sharded serving paths
    (``SERVE_TP_ATTN``, ``SERVE_TP_SSD``), against their plain versions on
    the same inputs and timed: ``flash_fwd`` causal over the prompt,
    ``decode_attention`` over the rank's kv heads of a linear cache with
    ragged lengths (0 exactly zero), then at the serving state, and
    ``ssd_scan`` over the prompt. Returns the records (flash, decode,
    scan), each a list."""
    import torch
    flash, decode, scan = [], [], []
    for i, (label, dt, b, h, kv, d, s, t, state) in enumerate(SERVE_TP_ATTN):
        dtype = getattr(torch, dt)
        flash.append(flash_case(label, b, h, s, d, dtype, False, 130 + i,
                                kv=kv, causal=True))
        q, k, v = decode_inputs(b, h, kv, t, d, dtype, 132 + i)
        lens = torch.tensor([0, 1, 255, t, 257, 301, t - 5, 511][:b],
                            device="cuda")
        out, err = decode_check(
            f"{label} t={t} ragged {dt}", q, k, v,
            torch.arange(t, device="cuda")[None, :] < lens[:, None])
        if not bool((out[0] == 0).all()):
            raise AssertionError("decode_attention: a length-0 row is not "
                                 "exactly zero")
        decode.append(decode_timed(f"{label} serving", q, k, v,
                                   torch.full((b,), state, device="cuda"),
                                   err))
        del q, k, v
    for i, (label, dt, b, l, h) in enumerate(SERVE_TP_SSD):
        scan.append(ssd_case(label, b, l, getattr(torch, dt), 134 + i, h=h))
    torch.cuda.empty_cache()
    return flash, decode, scan


def serve_split_rank(cases, device):
    """Phase 57 on this rank of phase 56's world of 2: for each case (its
    model drawn once for the cases that share it) the params cut to the
    rank's parts under the case's rule on its (data, model) mesh, the KV
    caches placed by ``steps.cache_seq_axis`` for b 1 and the case's
    cache, then prefill and greedy decode (``serve_shard_steps``). Returns
    {label: {logits, tokens (numpy), seq (the mesh axis, this rank's slice
    and the slice count), launches and shapes by kernel, kv_bytes (after
    the last step), seconds}}."""
    import torch
    from repro_torch.core import weight_sharding as ws
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_local_mesh
    counters = (fa_ops.COUNTER, dec_ops.COUNTER, ssd_ops.COUNTER)
    out, model = {}, None
    for label, arch, layers, rule, grid, plen, cache, steps, _ in cases:
        t0 = time.perf_counter()
        mesh = make_local_mesh(model=grid[1])
        if model is None or model[0] != (arch, layers):
            model = None            # the last model freed before the next
            model = ((arch, layers), *serve_shard_model(arch, layers, device))
        _, cfg, whole = model
        layout = st.serving_layout(cfg, mesh, rule)
        params = ws.cut(whole, layout)
        seq = st.cache_seq_axis(cfg, mesh, layout, 1, cache)
        caches = []
        for c in counters:
            c.reset()
        logits, tokens = serve_shard_steps(
            cfg, params, split_prompt(cfg, plen, device), steps, mesh=mesh,
            layout=layout, cache=cache, seq_axis=seq, out_caches=caches)
        out[label] = {
            "logits": logits.numpy(), "tokens": tokens.numpy(),
            "seq": None if seq is None else [
                next(a for a in ("batch", "data", "model")
                     if getattr(mesh, a) is seq), seq.index, seq.size],
            "launches": {c.name: c.count for c in counters},
            "shapes": {c.name: {"x".join(map(str, k)): v
                                for k, v in c.shapes.items()}
                       for c in counters},
            "kv_bytes": sum(x.numel() * x.element_size() for c in caches
                            if type(c).__name__ == "KVCache" for x in c),
            "seconds": time.perf_counter() - t0}
        del params, caches
    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def split_prompt(cfg, n, device):
    """Phase 57's prompt: (1, n) int32 tokens from seed 0."""
    import torch
    g = torch.Generator().manual_seed(0)
    return torch.randint(4, cfg.vocab, (1, n), generator=g,
                         dtype=torch.int32).to(device)


def phase_serve_split(ranks, device="cuda", cases=SPLIT_CASES):
    """Phase 57's checks on phase 56's world's records (``ranks``: each
    rank's ``serve_split_rank`` records): each case against the one-rank
    whole-weight steps on the plain path (attention 'chunked', the
    einsum decode, the scan's plain version; on the card for Llama, on
    the CPU for smoke Jamba) fed the same greedy tokens. Every rank's
    logits within SERVE_SHARD_TOL of the plain step's largest |logit|,
    greedy tokens alike on both ranks and equal to the plain step's
    wherever its top-2 gap exceeds the error, the sequence over both ranks
    (rank r holding slice r of 2), a rank's KV bytes half the whole
    cache's, and every rank launched the flash and decode kernels, the
    decode kernel at the slice's length (and the scan, for Jamba), read
    from the launch counters' shapes. ``device`` 'cpu' (a rehearsal with
    smoke ``cases``) checks no launch. Returns the records by label."""
    import torch
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    out = {}
    for label, arch, layers, rule, grid, plen, cache, steps, plain in cases:
        recs = [dict(r[label], **{k: torch.from_numpy(r[label][k])
                                  for k in ("logits", "tokens")})
                for r in ranks]
        on = plain if device == "cuda" else "cpu"
        cfg, whole = serve_shard_model(arch, layers, device)
        whole = tree_map(lambda x: x.to(on), whole)
        tw = time.perf_counter()
        kept = []
        want, _ = serve_shard_steps(
            dataclasses.replace(cfg, attn_impl="chunked"), whole,
            split_prompt(cfg, plen, on), steps, feed=recs[0]["tokens"],
            cache=cache, out_caches=kept)
        want_s = time.perf_counter() - tw
        kv_whole = sum(x.numel() * x.element_size() for c in kept
                       if type(c).__name__ == "KVCache" for x in c)
        del whole, kept
        if on == "cuda":
            torch.cuda.empty_cache()
        scale = want.abs().max().item()
        errs = [(r["logits"] - want).abs().max().item() for r in recs]
        sep = top2_gap(want) > max(errs)
        flips = [int(((r["tokens"] != want.argmax(-1)) & sep).sum())
                 for r in recs]
        t_slice = cache // 2
        seen = [{int(k.split("x")[3]) for k in r["shapes"]["decode_attention"]}
                for r in recs]
        rec = out[label] = {
            "max_logit_diff": errs, "max_abs_logit": scale,
            "greedy_flips": flips,
            "ranks_tokens_equal": bool(torch.equal(recs[0]["tokens"],
                                                   recs[1]["tokens"])),
            "seq": [r["seq"] for r in recs],
            "kv_bytes": [r["kv_bytes"] for r in recs],
            "kv_bytes_whole": kv_whole,
            "launches": [r["launches"] for r in recs],
            "decode_t": [sorted(x) for x in seen],
            "rank_seconds": [r["seconds"] for r in recs],
            "plain_seconds": want_s}
        print(f"sequence split {label} ({cfg.name}, {cfg.n_layers} layers, "
              f"f32, b 1 x {plen}, a cache of {cache}, {steps} steps, "
              f"sequence over {rec['seq']}): max |logit diff| vs one rank's "
              f"plain path on the {on} ({want_s:.1f} s) {errs} (tol "
              f"{SERVE_SHARD_TOL} x {scale:.4g}); greedy flips past the "
              f"error {flips}; ranks' tokens equal "
              f"{rec['ranks_tokens_equal']}; KV bytes a rank "
              f"{rec['kv_bytes']} of {kv_whole}; launches per rank "
              f"{rec['launches']}; decode t per rank {rec['decode_t']}; "
              f"seconds a rank {[round(x, 2) for x in rec['rank_seconds']]}",
              flush=True)
        placed = all(r["seq"] is not None and r["seq"][1:] == [i, 2]
                     for i, r in enumerate(recs)) and all(
            2 * b == kv_whole for b in rec["kv_bytes"])
        launched = device == "cpu" or all(
            r["launches"]["flash_fwd"] > 0
            and r["launches"]["decode_attention"] > 0 and got == {t_slice}
            and (cfg.ssm is None or r["launches"]["ssd_scan"] > 0)
            for r, got in zip(recs, seen))
        if not (max(errs) <= SERVE_SHARD_TOL * scale and not any(flips)
                and rec["ranks_tokens_equal"] and placed and launched):
            raise AssertionError(f"sequence split {label}: {rec}")
    world_s = max(sum(x["seconds"] for x in r.values()) for r in ranks)
    print(f"phase 57 sequence split: {time.perf_counter() - t0:.1f} s here "
          f"+ {world_s:.1f} s in the world of 2", flush=True)
    return out


def phase_split_lse():
    """Phase 57's kernel records: the decode kernel with ``return_lse`` at
    the slice shapes of ``SPLIT_LSE`` against its plain version (the
    output per ``dec_limit``, the lse within SPLIT_LSE_TOL, -1e30 exactly
    and zeros on a row with no valid key), its output bit-equal to the
    call without the lse, timed (events and profiler device time), its
    plain version and SDPA (``enable_gqa``) over the valid keys timed, and
    the bound of the valid entries. Returns the records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import (
        NEG_INF, decode_attention_ref)
    recs = []
    for i, (label, b, h, kv, t, d, dt, n) in enumerate(SPLIT_LSE):
        dtype = getattr(torch, dt)
        q, k, v = decode_inputs(b, h, kv, t, d, dtype, 140 + i)
        valid = (torch.arange(t, device="cuda") < n)[None].expand(b, t)
        out, lse = dec_ops.decode_attention(q, k, v, valid, return_lse=True)
        ref, ref_lse = decode_attention_ref(q, k, v, valid, return_lse=True)
        bare = dec_ops.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = bool((err <= dec_limit(ref)).all()) and torch.equal(out, bare)
        if n == 0:
            ok = ok and bool((lse == NEG_INF).all()) and bool(
                (out == 0).all())
        else:
            ok = ok and lse_err <= SPLIT_LSE_TOL
        if not ok:
            raise AssertionError(f"decode_attention lse {label} {dt}: max "
                                 f"out err {err.max().item():.3g}, lse err "
                                 f"{lse_err:.3g}, equal without the lse "
                                 f"{torch.equal(out, bare)}")
        call = lambda: dec_ops.decode_attention(q, k, v, valid,
                                                return_lse=True)
        ms = time_ms(call)
        dev_ms, per_call = device_ms(call, WRAPPER_KERNELS["decode_attention"])
        plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, valid,
                                                        return_lse=True))
        lib_ms = lib_dev_ms = None
        if n:
            kn, vn = k[:, :, :n], v[:, :, :n]
            library = lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kn, vn, enable_gqa=True)
            lib_ms = time_ms(library)
            lib_dev_ms, _ = device_ms(library)
        item = torch.finfo(dtype).bits // 8
        bound_ms, bound_by = bound(
            *decode_work(b, h, kv, t, d, item, b * n, lse=True), dt)
        rec = {"shape": f"b={b} h={h} kv={kv} t={t} d={d} {dt}, {label}: "
                        f"{b * n} valid entries, with lse",
               "plan": dec_ops.launch_plan(q, k)._asdict(),
               "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
               "ms": ms, "device_ms": dev_ms,
               "device_kernels_per_call": per_call, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        recs.append(rec)
        print(f"decode_attention {rec['shape']}: max err "
              f"{rec['max_abs_err']:.3g}, lse err {lse_err:.3g} (tol "
              f"{SPLIT_LSE_TOL}), output "
              f"equal to the call without the lse; kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms, {per_call:g} device kernels per "
              f"call), plain {plain_ms:.4f} ms, sdpa over the valid keys "
              f"{lib_ms} ms (device {lib_dev_ms} ms), bound {bound_ms:.4f} "
              f"ms ({bound_by})", flush=True)
        del q, k, v
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 48-52: head dim 80, GQA 7, the audio encoder and the vlm
# ---------------------------------------------------------------------------

HUBERT = "hubert-xlarge"
# HuBERT-XLarge's attention: 16 heads of 80 (kv = heads), bidirectional,
# at its training shape (INPUT_SHAPES["train_4k"]'s 4096 frames)
HUBERT_ATTN = dict(h=16, d=80, s=4096)
# the timed HuBERT run through the trainer: f32, b 2 × s 4096. --mode lm
# has no remat: a layer keeps ~30K floats of activations a frame (its
# norms, q/k/v, attention out, the three 5120-wide FFN tensors), 5.9 MB a
# frame over 48 layers, 48 GB at b 2; b 3 (72 GB) with the 5 GB of params,
# their gradients and AdaFactorW's slots would pass the card's 80 GB
HUBERT_ARGV = ["--mode", "lm", "--arch", HUBERT, "--batch", "2", "--seq",
               "4096", "--steps", "4", "--seed", "0"]
# Arctic-480B's attention: 56 query heads over 8 kv heads (a GQA group of
# 7), d 128, causal
ARCTIC_ATTN = dict(h=56, kv=8, d=128)
# Arctic-480B served on one card (phases 53-54): full width (d 7168, d_ff
# 4864 an expert, vocab 32000), 4 of its 35 layers (the depth Mixtral's
# serving phase takes) and experts 0-15 of each layer's 128, one card's
# share when eight cards split the experts: a layer is ~0.22G params
# outside its experts and 16 × 0.105G inside, 8.0G with the embedding and
# the head (~32 GB f32). The parity phase holds 2 of those layers with the
# same share (~17 GB f32), built before the served model and freed first.
ARCTIC = "arctic-480b"
ARCTIC_LAYERS = 4
ARCTIC_PARITY_LAYERS = 2
ARCTIC_SHARE = (0, 16)
# Arctic-480B trained on one card (phase 58): full width, 1 of its 35
# layers (a depth cut) with the same share: ~0.223G params outside the
# experts, 16 × 0.105G inside, 0.459G for the embedding and the head,
# ~2.355G in all (9.42 GB f32); the timed bf16 steps at b 1 ×
# INPUT_SHAPES["train_4k"]'s sequence, the f32 parity steps at s 1024
# (capacity dispatch) and s 512 (dense dispatch: the 16 held experts
# compute every token)
ARCTIC_TRAIN_LAYERS = 1
ARCTIC_TRAIN_SEQ = 4096
ARCTIC_DENSE_SEQ = 512
# the MoE serving run's traffic (8 slots, 16 requests of 508-520 prompt
# tokens, 64 new) on a linear cache of 4096 (Arctic has no window)
ARCTIC_SERVE_ARGV = with_flags(MOE_SERVE_ARGV, arch=ARCTIC, cache_len=4096)
ARCTIC_CACHE = 4096
INTERNVL2 = "internvl2-76b"
# InternVL2-76B at full width: the embedding and the untied head are
# 2.10G params (8.4 GB f32), a layer 0.856G (3.42 GB). Training holds 1 of
# its 80 layers (2.96G, 11.8 GB f32), at b 1 × s 4096 (256 patches of a
# 256×256 image, then 3840 tokens): 2 layers (15.28 GB) ran out of memory
# in the f32 step's AdaFactorW update (the old and the new params, the
# gradients and the slots at once: 66.8 GiB allocated, 3.9 GiB asked for
# the embedding's update). Serving holds 8 layers (8.95G, 35.8 GB f32).
VLM_TRAIN_LAYERS = 1
VLM_TRAIN_SEQ = 4096
VLM_SERVE_LAYERS = 8
# the timed vlm serving run: 8 slots, 16 token requests of 508-520 prompt
# tokens, 64 new, a linear cache of 1024, bf16, the kernels (the engines
# serve a vlm on tokens, as the reference's)
VLM_SERVE_ARGV = ["--arch", INTERNVL2, "--engine", "continuous", "--slots",
                  "8", "--requests", "16", "--arrival", "0", "--prompt-len",
                  "512", "--max-new", "64", "--cache-len", "1024", "--attn",
                  "pallas", "--precision", "bf16", "--temperature", "0",
                  "--seed", "0"]


def phase_flash_d80():
    """Both flash kernels at head dim 80, HuBERT-XLarge's training shape
    (b 2, 16 heads = kv, s 4096, bidirectional), f32 and bf16, against
    their plain versions, timed against SDPA; then, untimed, a causal
    case with a window of 70 and a bidirectional one with GQA 4, both at
    s 520 (past one key block of the backward), forward and backward.
    Returns the timed records by (direction, dtype name)."""
    import torch
    a = HUBERT_ATTN
    recs = {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        dt = dtype_name(dtype)
        recs[("fwd", dt)] = flash_case("hubert", 2, a["h"], a["s"], a["d"],
                                       dtype, False, 100 + i)
        torch.cuda.empty_cache()
        recs[("bwd", dt)] = flash_bwd_case("hubert", 2, a["h"], a["s"],
                                           a["d"], dtype, False, 102 + i)
        torch.cuda.empty_cache()
        for label, kv, causal, window in (("d80 window", 8, True, 70),
                                          ("d80 gqa", 2, False, None)):
            flash_case(label, 2, 8, 520, a["d"], dtype, False, 104 + i,
                       kv=kv, causal=causal, window=window, timed=False)
            flash_bwd_case(label, 2, 8, 520, a["d"], dtype, False, 106 + i,
                           causal=causal, window=window, kv=kv,
                           timed=False)
    return recs


def phase_gqa7_kernels():
    """Arctic-480B's grouping, 56 query heads over 8 kv heads (a GQA group
    of 7, d 128), in the kernels, f32 and bf16: the flash forward and
    backward at b 1 × s 1024 and at the training shape b 1 × s 4096
    (``ARCTIC_TRAIN_SEQ``), causal, against their plain versions and
    timed against SDPA; ``decode_attention`` over 8 slots of a linear
    cache of 4096 with ragged lengths (0 exactly zero), then timed at the
    serving state. Returns (flash records by (direction, dtype name),
    the training shape's by (direction, dtype name), decode records by
    dtype name)."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    a = ARCTIC_ATTN
    flash, train, decode = {}, {}, {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        dt = dtype_name(dtype)
        flash[("fwd", dt)] = flash_case("arctic", 1, a["h"], 1024, a["d"],
                                        dtype, False, 110 + i, kv=a["kv"],
                                        causal=True)
        flash[("bwd", dt)] = flash_bwd_case("arctic", 1, a["h"], 1024,
                                            a["d"], dtype, False, 112 + i,
                                            causal=True, kv=a["kv"])
        train[("fwd", dt)] = flash_case(
            "arctic train", 1, a["h"], ARCTIC_TRAIN_SEQ, a["d"], dtype, False,
            116 + i, kv=a["kv"], causal=True)
        train[("bwd", dt)] = flash_bwd_case(
            "arctic train", 1, a["h"], ARCTIC_TRAIN_SEQ, a["d"], dtype, False,
            118 + i, causal=True, kv=a["kv"])
        torch.cuda.empty_cache()
        b, t = 8, 4096
        q, k, v = decode_inputs(b, a["h"], a["kv"], t, a["d"], dtype, 114 + i)
        lens = torch.tensor([0, 1, 255, 256, 257, t, 3001, t - 5],
                            device="cuda")
        out, err = decode_check(
            f"arctic g=7 t={t} ragged {dt}", q, k, v,
            torch.arange(t, device="cuda")[None, :] < lens[:, None])
        if not bool((out[0] == 0).all()):
            raise AssertionError("decode_attention: a length-0 row is not "
                                 "exactly zero")
        decode[dt] = decode_timed(
            f"arctic g=7 (CTA group {dec_ops.launch_plan(q, k).group}) "
            f"serving", q, k, v,
            torch.tensor([516 + 9 * j for j in range(b)], device="cuda"),
            err)
    return flash, train, decode


def phase_hubert_train(parity_batch: int = 2, parity_seq: int = 1024,
                       lr: float = 1e-3):
    """HuBERT-XLarge at full width and depth (48 layers, d 1280, 16 heads
    of 80, 1.26G params): one f32 step of ``lm_loss`` (the masked-frame
    loss, no remat) and ``run_lm``'s AdaFactorW on the kernel path (the
    flash kernels at d 80) and the plain path (chunked attention), from
    one set of weights and one batch of b 2 × s 1024 frames, held by
    ``check_step_parity``: 48 + 48 flash launches on the kernel path, none
    on the plain path; then ``--mode lm`` through the trainer's ``main``
    (``HUBERT_ARGV``: f32, b 2 × s 4096, 4 steps): step median, tokens/s,
    peak memory, 48 + 48 flash launches a step."""
    import math

    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import frontends
    from repro_torch.models import transformer as tf

    cfg = get_arch(HUBERT)
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(12), "cuda")
    n = sum(p.numel() for _, p in interop.leaves(params))
    batch = frontends.synthetic_inputs(cfg, parity_batch, parity_seq,
                                       np.random.default_rng(12),
                                       device="cuda")
    results, launches = {}, {}
    for path, attn in (("kernel", "pallas"), ("plain", "chunked")):
        pcfg = dataclasses.replace(cfg, attn_impl=attn)
        results[path], launches[path] = lm_step_results(
            pcfg, params, batch, lr, lm_counters())
    parity = check_step_parity(
        f"hubert parity ({HUBERT} f32, {cfg.n_layers} layers, {n} params, "
        f"b={parity_batch} x s={parity_seq}, "
        f"{int(batch['mask'].sum())} masked frames)", results, lr,
        launches, needed=cfg.n_layers)
    del results, params, batch
    torch.cuda.empty_cache()
    for ctr in lm_counters():
        ctr.reset()
    rep = train.main(HUBERT_ARGV)
    steps = len(rep["losses"])
    per_step = {c.name: c.count / steps for c in lm_counters()}
    del rep["params"], rep["opt_state"]
    print(f"hubert train ({HUBERT} f32 --mode lm, full width and depth, b 2 "
          f"x s 4096): warm step median {rep['warm_step_median_s']:.4f} s, "
          f"{rep['tokens_per_s']:.1f} frames/s, max_memory_allocated "
          f"{rep['max_memory_allocated'] / 2**30:.3f} GiB; step s "
          f"{[round(t, 4) for t in rep['step_s']]}; losses "
          f"{[round(v, 5) for v in rep['losses']]}; launches per step "
          f"{per_step}", flush=True)
    if not all(math.isfinite(v) for v in rep["losses"]):
        raise AssertionError(f"hubert train: non-finite loss "
                             f"{rep['losses']}")
    if set(per_step.values()) != {cfg.n_layers}:
        raise AssertionError(f"hubert train: expected {cfg.n_layers} "
                             f"flash_fwd and flash_bwd launches a step, got "
                             f"{per_step}")
    torch.cuda.empty_cache()
    return {"parity": {**parity, "launches": launches["kernel"]},
            "rep": rep, "launches_per_step": per_step, "params": n}


def vlm_model(layers: int, seed: int):
    """(cfg, params): InternVL2-76B at full width on ``layers`` of its 80
    layers, fp32 weights from a CUDA generator, the flash kernels."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_arch(INTERNVL2), n_layers=layers,
                              attn_impl="pallas")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in interop.leaves(params))
    print(f"vlm: {INTERNVL2} at full width, {layers} of 80 layers, {n} "
          f"params ({4 * n / 1e9:.2f} GB f32), init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    return cfg, params, n


def phase_vlm_train(parity_seq: int = 512, lr: float = 1e-3):
    """InternVL2-76B at full width on ``VLM_TRAIN_LAYERS`` layer(s),
    weights built once: one f32 step of ``lm_loss`` (256×256 images
    through the patchify frontend, the text tail's next-token loss) and
    ``run_lm``'s AdaFactorW at b 1 × s 512 (256 patches, 256 tokens),
    kernel path against plain path (chunked attention), held by
    ``check_step_parity`` (the kernel path's trees parked in host memory);
    then ``run_lm``'s f32 ``lm_step``, 3 steps at b 1 × s 4096: step
    median, tokens/s, peak memory, one flash_fwd and one flash_bwd launch
    a layer a step."""
    import torch
    from repro_torch.launch.steps import lm_step
    from repro_torch.optim import AdaFactorW, warmup_cosine

    cfg, params, n = vlm_model(VLM_TRAIN_LAYERS, 13)
    parity = step_parity(
        f"vlm train parity ({INTERNVL2} f32, {VLM_TRAIN_LAYERS} of 80 "
        f"layers, b=1 x s={parity_seq}: 256 patches, {parity_seq - 256} "
        f"tokens)", cfg, params, parity_seq, lr, 13,
        needed=VLM_TRAIN_LAYERS)
    opt = AdaFactorW(weight_decay=0.0025)
    step = lm_step(cfg, opt, warmup_cosine(lr, lr / 100, 1, 3),
                   precision="f32")
    f32, params, _ = timed_steps(
        f"vlm train ({INTERNVL2} {VLM_TRAIN_LAYERS} of 80 layers, lm_step "
        f"f32, 256 patches + {VLM_TRAIN_SEQ - 256} tokens)", cfg, params,
        opt.init(params), step, 1, VLM_TRAIN_SEQ, 3, lm_counters())
    if set(f32["launches_per_step"].values()) != {VLM_TRAIN_LAYERS}:
        raise AssertionError(f"vlm train: expected {VLM_TRAIN_LAYERS} "
                             f"flash_fwd and flash_bwd launches a step, got "
                             f"{f32['launches_per_step']}")
    del params
    torch.cuda.empty_cache()
    return {"parity": parity, "f32": f32, "params": n}


def phase_vlm_serve():
    """InternVL2-76B at full width on ``VLM_SERVE_LAYERS`` layers, weights
    built once: f32 decode parity (4 token prompts of 512, a linear cache
    of 1024, 8 greedy steps) of the kernel path against the plain path
    (``parity_case``), with one flash_fwd launch a layer at the prefill and
    one decode_attention launch a layer a step; then the same weights
    served in bf16 through the launcher's ``run_continuous`` (after one
    untimed warm-up request; ``VLM_SERVE_ARGV``) and ``run_legacy`` (one
    lockstep request): tokens per second, decode-step median and p90,
    prefill ms, peak memory, flash_fwd launches per prefill and
    decode_attention launches per step (one a layer), every token in the
    vocabulary."""
    import math

    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve

    cfg, params, n = vlm_model(VLM_SERVE_LAYERS, 14)
    counters = (fa_ops.COUNTER, dec_ops.COUNTER)
    g = torch.Generator(device="cuda").manual_seed(15)
    for ctr in counters:
        ctr.reset()
    steps = 8
    with torch.no_grad():
        toks = torch.randint(4, cfg.vocab, (4, 512), generator=g,
                             device="cuda")
        worst, flips = parity_case(
            f"vlm ({INTERNVL2} f32, {VLM_SERVE_LAYERS} of 80 layers, 4 x "
            f"512 tokens, linear cache 1024)", cfg, params, toks, 512, 1024,
            steps)
    parity_launches = {ctr.name: ctr.count for ctr in counters}
    want = {"flash_fwd": cfg.n_layers, "decode_attention":
            cfg.n_layers * steps}
    if parity_launches != want:
        raise AssertionError(f"vlm parity: launches {parity_launches}, "
                             f"want {want}")
    torch.cuda.empty_cache()

    def argv(**changes):
        return serve.parse_args(with_flags(VLM_SERVE_ARGV, **changes))

    args = argv()
    torch.cuda.reset_peak_memory_stats()
    serve.run_continuous(cfg, params, argv(requests=1, max_new=4))
    for ctr in counters:
        ctr.reset()
    rep = serve.run_continuous(cfg, params, args)
    launches = {ctr.name: ctr.count for ctr in counters}
    per = {"flash_fwd_per_prefill": launches["flash_fwd"] / rep["prefills"],
           "decode_attention_per_step": (launches["decode_attention"]
                                         / rep["decode_steps"])}
    print(f"vlm serve ({INTERNVL2} {VLM_SERVE_LAYERS} of 80 layers, "
          f"continuous, bf16, 8 slots, 16 requests x 508-520 prompt tokens "
          f"x 64 new, cache 1024): decode {rep['decode_tokens_per_s']:.1f} "
          f"tok/s over the warm steps, {rep['tokens_per_s']:.1f} tok/s over "
          f"the run (prefill included); step median "
          f"{rep['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{rep['step_p90_s'] * 1e3:.3f} ms over {rep['decode_steps']} "
          f"steps; prefill {rep['prefill_mean_s'] * 1e3:.3f} ms per "
          f"request; launches {launches}: {per}", flush=True)
    want = {"flash_fwd_per_prefill": cfg.n_layers,
            "decode_attention_per_step": cfg.n_layers}
    if per != want:
        raise AssertionError(f"vlm serve: launches {per}, want {want}")
    for rid, r in rep["results"].items():
        if not (bool(np.all((r >= 0) & (r < cfg.vocab)))
                and (r.size == args.max_new or r[-1] == 3)):
            raise AssertionError(f"vlm serve: bad tokens for request "
                                 f"{rid}: {r}")
    if rep["requests"] != args.requests or not math.isfinite(
            rep["decode_tokens_per_s"]):
        raise AssertionError(f"vlm serve: {rep['requests']} of "
                             f"{args.requests} requests finished")
    for ctr in counters:
        ctr.reset()
    lock = serve.run_legacy(cfg, params, argv(engine="legacy", batch=1))
    row = lock["tokens"][0]
    stop = np.nonzero(row == 3)[0]
    emitted = int(stop[0]) + 1 if stop.size else row.size
    lock_launches = {ctr.name: ctr.count for ctr in counters}
    want = {"flash_fwd": cfg.n_layers,
            "decode_attention": cfg.n_layers * (emitted - 1)}
    print(f"vlm serve (lockstep, 1 request x 512 prompt tokens): {emitted} "
          f"tokens, {lock['tokens_per_s']:.1f} tok/s (prefill included); "
          f"launches {lock_launches}", flush=True)
    if lock_launches != want or not bool(np.all((row >= 0)
                                                & (row < cfg.vocab))):
        raise AssertionError(f"vlm serve lockstep: launches {lock_launches} "
                             f"(want {want}), tokens {row}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"vlm serve: max_memory_allocated {peak / 2**30:.3f} GiB (weights, "
          f"caches and the warm-up, continuous and lockstep runs)",
          flush=True)
    rep.pop("engine", None)
    del params
    torch.cuda.empty_cache()
    return {"parity": {"max_logit_diff": worst, "flips": flips},
            "parity_launches": parity_launches, "launches": launches,
            "per": per, "rep": rep,
            "lockstep": {"launches": lock_launches, "tokens": emitted,
                         "tokens_per_s": lock["tokens_per_s"]},
            "max_memory_allocated": peak, "params": n}


# ---------------------------------------------------------------------------
# phase 58: Arctic-480B trained on the card with an expert share
# ---------------------------------------------------------------------------


def phase_arctic_train(parity_seq: int = 1024,
                       dense_seq: int = ARCTIC_DENSE_SEQ, lr: float = 1e-3):
    """Arctic-480B at full width on ``ARCTIC_TRAIN_LAYERS`` of its 35
    layers with the serving phases' expert share (``ARCTIC_SHARE``: 16 of
    each layer's 128 experts, beside the dense residual FFN), weights drawn
    once with ``init_params(..., experts=)``: one f32 step of ``lm_loss``
    and ``run_lm``'s AdaFactorW on the kernel path and the plain path
    (chunked attention), held by ``step_parity`` (the kernel path's trees
    parked in host memory; a factored leaf's elements in near-zero rows or
    columns may differ by up to 2·lr, ``TRAIN_AMPLIFIED_SHARE`` of the
    leaf at most), (a) at b 1 × s ``parity_seq`` under capacity dispatch
    and (b) at b 1 × s ``dense_seq`` under dense dispatch, where every
    held expert computes every token; then (c)
    ``make_train_step`` bf16 with remat 'basic', 3 steps at b 1 ×
    ``ARCTIC_TRAIN_SEQ``: step median, tokens/s, peak memory, 2 flash_fwd
    and 1 flash_bwd launch a step, each flash_bwd at 56 query rows over 8
    kv rows (GQA 7) at d 128."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.steps import DEFAULT_MOE_ARGS, make_train_step

    cfg = dataclasses.replace(get_arch(ARCTIC), n_layers=ARCTIC_TRAIN_LAYERS,
                              attn_impl="pallas")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = interop.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(14), "cuda",
        experts=ARCTIC_SHARE)
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in interop.leaves(params))
    print(f"arctic train: {ARCTIC} at full width, {ARCTIC_TRAIN_LAYERS} of "
          f"35 layers, experts {ARCTIC_SHARE[0]}-{sum(ARCTIC_SHARE) - 1} of "
          f"128, {n} params ({4 * n / 1e9:.2f} GB f32), init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    capacity = dict(DEFAULT_MOE_ARGS, experts=ARCTIC_SHARE)
    parity = {}
    for label, seq, margs in (
            ("capacity", parity_seq, capacity),
            ("dense", dense_seq, {"dispatch": "dense",
                                  "experts": ARCTIC_SHARE})):
        t0 = time.perf_counter()
        parity[label] = step_parity(
            f"arctic train parity ({ARCTIC} {ARCTIC_TRAIN_LAYERS} layer f32, "
            f"experts {ARCTIC_SHARE}, b=1 x s={seq}, {label} dispatch)",
            cfg, params, seq, lr, 14, moe_args=margs,
            needed=ARCTIC_TRAIN_LAYERS, amplified=True)
        parity[label]["seconds"] = time.perf_counter() - t0
    step_fn, opt = make_train_step(cfg, moe_args=capacity)
    bf16, params, _ = timed_steps(
        f"arctic train ({ARCTIC} {ARCTIC_TRAIN_LAYERS} layer, experts "
        f"{ARCTIC_SHARE}, make_train_step bf16, remat basic, capacity)", cfg,
        params, opt.init(params), step_fn, 1, ARCTIC_TRAIN_SEQ, 3,
        lm_counters())
    shapes = {"x".join(map(str, k)): v
              for k, v in fa_ops.BWD_COUNTER.shapes.items()}
    bf16["flash_bwd_shapes"] = shapes
    a = ARCTIC_ATTN
    want = f"{a['h']}x{a['kv']}x{ARCTIC_TRAIN_SEQ}x{ARCTIC_TRAIN_SEQ}x{a['d']}"
    print(f"arctic train bf16: flash_bwd launched at (bh x bkv x s x t x d) "
          f"{shapes}", flush=True)
    if bf16["launches_per_step"] != {"flash_fwd": 2, "flash_bwd": 1}:
        raise AssertionError(f"arctic train bf16: expected 2 flash_fwd (remat "
                             f"basic) and 1 flash_bwd launch a step, got "
                             f"{bf16['launches_per_step']}")
    if set(shapes) != {want}:
        raise AssertionError(f"arctic train bf16: every flash_bwd launch must "
                             f"be at {want} (56 query rows over 8 kv rows, "
                             f"d 128), got {shapes}")
    del params
    torch.cuda.empty_cache()
    return {"parity": parity, "bf16": bf16, "params": n}


# ---------------------------------------------------------------------------
# phase 55: the tooling (roofline, memstats, dryrun) held to the card
# ---------------------------------------------------------------------------

# a dry run's predicted peak against the same step's peak on the card: the
# trace counts live storages (rounded to the allocator's 512-byte blocks)
# and the kernels' per-call workspaces; it does not see the caching
# allocator's larger blocks and splits, cuBLAS workspaces or the per-stream
# scratch the decode and top-k kernels keep
TOOL_PEAK_SHARE = 0.15
TOOL_DRY_RUNS = os.path.join(HERE, "build", "chip_smoke_dryrun.json")
# (a) the distributed trainer at one rank, the run of phase 38 for 1 step
TOOL_TRAIN_ARGV = with_flags(DIST_TRAIN_ARGV, steps=1) + ["--memstats"]
# (b) the shapes of the dry runs held to the card: phase 38's contrastive
# step (BASIC-S, B 2048 in 8, captions of 16) and Llama-3.2-1B's
# ``make_train_step`` at b 4 x s 1024
TOOL_CONTRASTIVE = ("contrastive_b2048", 16, 2048, "contrastive")
TOOL_LM = ("train_b4_s1024", 1024, 4, "train")


def dry_run_worker(path):
    """The three dry runs (meta tensors only, this process's CPU), run in a
    spawned process while the card's phases run; the results go to
    ``path`` as JSON: (b) phase 38's contrastive step and Llama-3.2-1B's
    ``make_train_step`` (bf16, remat basic, the flash kernels) at one rank
    (mesh (1, 1)), and (c) BASIC-L's contrastive step at the paper's
    ``contrastive_64k`` on the pod mesh (16, 16), the batch over every
    rank (paper §5.1, the trainer's layout: 256 pairs a rank)."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    out = {
        "contrastive": dryrun.run_contrastive_dryrun(
            "basic-s", InputShape(*TOOL_CONTRASTIVE), mesh=(1, 1),
            attn="pallas", verbose=False),
        "lm": dryrun.run_one("llama3.2-1b", InputShape(*TOOL_LM),
                             mesh=(1, 1), attn="pallas", verbose=False),
        "pod": dryrun.run_contrastive_dryrun(
            "basic-l", "contrastive_64k", batch_over="all", verbose=False)}
    with open(path, "w") as f:
        json.dump(out, f)


def start_dry_runs():
    """``dry_run_worker`` in a spawned process (daemonic: it ends with the
    script); returns the process."""
    import multiprocessing
    if os.path.exists(TOOL_DRY_RUNS):
        os.remove(TOOL_DRY_RUNS)
    proc = multiprocessing.get_context("spawn").Process(
        target=dry_run_worker, args=(TOOL_DRY_RUNS,), daemon=True)
    proc.start()
    return proc


def printed_peak_gb(text, label):
    """The peak GB column of ``format_rows``' row ``label`` in ``text``."""
    for line in text.splitlines():
        if line.startswith(label):
            return float(line[len(label):].split()[0])
    raise AssertionError(f"tooling: no memstats row {label!r} in {text!r}")


def held_to_card(name, predicted, fn, abstract, args, base):
    """Run ``fn`` once on the card's inputs ``args`` (made after the card
    held ``base`` bytes; the shapes and dtypes of the dry run's
    ``abstract`` inputs) under ``memstats.step_stats`` and hold the
    dry run's ``predicted`` result to it: the FLOPs equal, the peak within
    ``TOOL_PEAK_SHARE`` of the step's own peak on the card
    (``max_memory_allocated`` less what the card held before the inputs
    were made); then times one more run and prints the roofline terms
    beside it. Returns the record."""
    import torch
    from repro_torch.launch import memstats
    from repro_torch.launch import roofline as rf
    from repro_torch.tree import tree_leaves
    pairs = list(zip(tree_leaves(abstract), tree_leaves(args)))
    if len(pairs) != len(tree_leaves(args)) or any(
            a.shape != r.shape or a.dtype != r.dtype for a, r in pairs):
        raise AssertionError(f"tooling {name}: the card's inputs are not "
                             f"the dry run's shapes and dtypes")
    row = memstats.step_stats(fn, args, label=name)
    peak = torch.cuda.max_memory_allocated()
    own = peak - base
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del out
    want = predicted["roofline"]["flops_per_device"]
    got = row["flops_per_device"]
    pred = predicted["memory"]["peak_bytes_per_device"]
    terms = rf.roofline_terms({"flops": got, "bytes accessed":
                               row["bytes_accessed_per_device"]},
                              row["collectives"])
    rec = {"flops_predicted": want, "flops_measured": got,
           "peak_predicted_bytes": pred, "peak_measured_bytes": own,
           "max_memory_allocated": peak, "peak_share": pred / own - 1,
           "step_s": step_s, "roofline": terms,
           "trace_s": predicted["lower_s"], "row": row}
    print(f"tooling {name}: FLOPs dry run {want:.6e}, card {got:.6e}; peak "
          f"dry run {pred / 2**30:.4f} GiB, card {own / 2**30:.4f} GiB "
          f"(max_memory_allocated {peak / 2**30:.4f} GiB, of which held "
          f"before {base / 2**30:.4f}), {100 * rec['peak_share']:+.2f}%; "
          f"bytes accessed {row['bytes_accessed_per_device'] / 1e9:.3f} GB; "
          f"step {step_s:.4f} s against the roofline's compute "
          f"{terms['compute_s']:.4f} s, memory {terms['memory_s']:.4f} s, "
          f"collective {terms['collective_s']:.4f} s (bottleneck "
          f"{terms['bottleneck']}); traced in {predicted['lower_s']} s",
          flush=True)
    if got != want:
        raise AssertionError(f"tooling {name}: the dry run counts {want} "
                             f"FLOPs, the card's step {got}")
    if not abs(rec["peak_share"]) <= TOOL_PEAK_SHARE:
        raise AssertionError(f"tooling {name}: the predicted peak is "
                             f"{100 * rec['peak_share']:+.2f}% off the "
                             f"card's (limit {100 * TOOL_PEAK_SHARE}%)")
    return rec


def phase_tooling(proc):
    """Phase 55. (a) ``train_distributed --memstats`` at one rank (phase
    38's run, 1 step): its printed row's peak equals
    ``max_memory_allocated`` over the run, and its runlog holds the row;
    (b) the dry runs of ``dry_run_worker`` (joined here) of phase 38's
    contrastive step and of Llama-3.2-1B's ``make_train_step``, each held
    to the same step function run once on the card on real inputs of the
    same shapes (``held_to_card``); (c) BASIC-L at ``contrastive_64k`` on
    the pod mesh: the params, optimizer state and peak a rank, and the
    roofline's bottleneck."""
    import io

    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models import frontends
    from repro_torch.obs import runlog

    # joined first: no step below is timed beside the dry runs
    proc.join(timeout=900)
    if proc.is_alive() or proc.exitcode != 0:
        proc.kill()
        raise AssertionError(f"tooling: the dry runs' process ended with "
                             f"{proc.exitcode}")
    with open(TOOL_DRY_RUNS) as f:
        dry = json.load(f)
    root = os.path.join(CKPT_ROOT, "tooling")
    shutil.rmtree(root, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        td.main(TOOL_TRAIN_ARGV + ["--run-dir", root])
    peak = torch.cuda.max_memory_allocated()
    text = buf.getvalue()
    print(text, end="", flush=True)
    rows = [r["row"] for r in runlog.read_runlog(
        os.path.join(root, "runlog.jsonl"))
        if r["kind"] == "event" and r.get("event") == "memstats"]
    if len(rows) != 1:
        raise AssertionError(f"tooling: {len(rows)} memstats rows in the "
                             f"runlog, want 1")
    train = rows[0]
    printed = printed_peak_gb(text, train["label"])
    print(f"tooling (a): train_distributed --memstats peak "
          f"{train['memory']['peak_bytes_per_device']} bytes (printed "
          f"{printed} GB), max_memory_allocated {peak} bytes; "
          f"{train['flops_per_device'] / 1e12:.3f} TFLOP, collectives "
          f"{train['collectives']['total']} bytes", flush=True)
    if train["memory"]["peak_bytes_per_device"] != peak or \
            printed != round(peak / 2**30, 4):
        raise AssertionError(f"tooling (a): the row's peak "
                             f"{train['memory']['peak_bytes_per_device']} "
                             f"(printed {printed}) is not "
                             f"max_memory_allocated {peak}")
    shutil.rmtree(root)
    torch.cuda.empty_cache()

    out = {"train_memstats": {"peak": peak, "row": train}, "dry": dry}

    # (b) the contrastive step: BASIC-S at full width, bf16, the fused loss
    cfg = get_arch("basic-s")
    shape = InputShape(*TOOL_CONTRASTIVE)
    with fake_world((1, 1)) as mesh:
        fn, abstract = dryrun.contrastive_step(cfg, shape, mesh,
                                               attn="pallas")
        base = torch.cuda.memory_allocated()
        params = interop.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        spec = abstract[2]
        batch = {"images": {"image": torch.rand(
            spec["images"]["image"].shape, generator=g, device="cuda")},
            "texts": {"tokens": torch.randint(
                4, cfg.text_tower.vocab, spec["texts"]["tokens"].shape,
                generator=g, device="cuda", dtype=torch.int32)}}
        args = (params, st.make_optimizer().init(params), batch)
        out["contrastive"] = held_to_card(
            "(b) BASIC-S contrastive B=2048 micro=8 bf16", dry["contrastive"],
            fn, abstract, args, base)
        del params, batch, args
    torch.cuda.empty_cache()

    # (b) Llama-3.2-1B's make_train_step, bf16, remat basic, flash kernels
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), attn_impl="pallas")
    shape = InputShape(*TOOL_LM)
    with fake_world((1, 1)) as mesh:
        fn, abstract = dryrun.lm_step(cfg, shape, mesh)
        base = torch.cuda.memory_allocated()
        params = interop.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        batch = frontends.synthetic_inputs(
            cfg, shape.global_batch, shape.seq_len,
            np.random.default_rng(0), device="cuda")
        args = (params, st.make_optimizer().init(params), batch)
        out["lm"] = held_to_card("(b) Llama-3.2-1B make_train_step b4 s1024",
                                 dry["lm"], fn, abstract, args, base)
        del params, batch, args
    torch.cuda.empty_cache()

    # (c) the paper's step per rank on the pod mesh
    pod = dry["pod"]
    m = pod["memory"]
    print(f"tooling (c): basic-l x contrastive_64k x {pod['mesh']} x "
          f"{pod['sharding']} (the batch over every rank: 256 pairs, 8 "
          f"microbatches of 32): params {m['params_bytes_per_device'] / 1e9:.4f} "
          f"GB, optimizer state {m['opt_state_bytes_per_device'] / 1e9:.4f} "
          f"GB, peak {m['peak_gb_per_device']} GB a rank; roofline compute "
          f"{pod['roofline']['compute_s']:.4f} s, memory "
          f"{pod['roofline']['memory_s']:.4f} s, collective "
          f"{pod['roofline']['collective_s']:.4f} s: bottleneck "
          f"{pod['roofline']['bottleneck']}; collectives "
          f"{pod['collectives']['total'] / 1e9:.3f} GB in "
          f"{pod['collectives']['count']} calls; traced in {pod['lower_s']} "
          f"s", flush=True)
    if not pod["ok"] or m["params_bytes_per_device"] <= 0:
        raise AssertionError(f"tooling (c): {pod}")
    return out


def main() -> int:
    """Run every phase; returns the exit code."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    resolve_device("cuda")

    libs = (fa_ops.LIB, fa_ops.BWD_LIB, topk_ops.LIB, cl_ops.LIB,
            dec_ops.LIB, ssd_ops.LIB, ssd_ops.BWD_LIB)
    t0 = time.perf_counter()
    kbuild.build_all(libs)
    print(f"built kernels in {time.perf_counter() - t0:.1f}s (sm_90a)",
          flush=True)
    for lib in libs:
        print(f"  {lib.name}: nvcc {lib.build_seconds or 0.0:.1f}s", flush=True)
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)

    flash = phase_flash()
    topk, topk_errs = phase_topk()
    flash_bwd = phase_flash_bwd()
    contrastive = phase_contrastive()
    legacy, legacy_launches, legacy_per_call = phase_legacy()
    decode, decode_errs = phase_decode_kernel()
    prefill_flash = phase_prefill_flash()
    ssd = phase_ssd_kernel()
    launches, cfg, params, tok = phase_main_path()
    per_call = phase_profile(cfg, params, tok)
    registry = phase_registry_disk(cfg, params, tok)
    n_valid, n_valid_errs = phase_topk_n_valid()
    retrieval = phase_retrieval(cfg, params, tok)
    del params
    train_parity = phase_train_parity()
    train_launches, train_per_step, _ = phase_train_timed()
    train_per_call, busy = phase_train_profile()
    torch.cuda.empty_cache()
    recipe_launches, recipe = phase_recipe()
    torch.cuda.empty_cache()
    accum = phase_moment_accum()
    torch.cuda.empty_cache()
    parity = phase_decode_parity()
    torch.cuda.empty_cache()
    dec_launches, dec_per, dec_rep = phase_decode_serve()
    dec_per_call, dec_busy = phase_decode_profile(dec_rep.pop("engine"))
    del dec_rep
    torch.cuda.empty_cache()
    ssm_parity = phase_ssm_parity()
    torch.cuda.empty_cache()
    ssm_launches, ssm_per_prefill, ssm_rep = phase_ssm_serve()
    ssm_eng = ssm_rep.pop("engine")
    ssm_per_call, ssm_prefill_busy = phase_ssm_prefill_profile(ssm_eng)
    _, ssm_busy = phase_decode_profile(ssm_eng, prompt_len=248, counters=())
    del ssm_eng, ssm_rep
    torch.cuda.empty_cache()
    lm_flash = phase_lm_flash()
    lm_parity = phase_lm_parity()
    torch.cuda.empty_cache()
    lm_per_step, lm_rep = phase_lm_timed()
    torch.cuda.empty_cache()
    lm_bf16 = phase_lm_step_bf16()
    torch.cuda.empty_cache()
    ssd_bwd = phase_ssd_bwd_kernel()
    torch.cuda.empty_cache()
    ssm_train_parity = phase_ssm_train_parity()
    torch.cuda.empty_cache()
    ssm_train_launches, ssm_train = phase_ssm_train_timed()
    torch.cuda.empty_cache()
    moe_flash, moe_decode = phase_moe_kernels()
    torch.cuda.empty_cache()
    moe_parity = phase_moe_parity()
    torch.cuda.empty_cache()
    moe = phase_moe_serve()
    torch.cuda.empty_cache()
    moe_train_flash = phase_moe_train_flash()
    torch.cuda.empty_cache()
    moe_train = phase_moe_train()
    torch.cuda.empty_cache()
    jamba_flash, jamba_decode, jamba_scan = phase_hybrid_kernels()
    torch.cuda.empty_cache()
    print(f"hybrid: {torch.cuda.memory_allocated() / 2**30:.3f} GiB held "
          f"before the model is built", flush=True)
    jamba_cfg, jamba_params = jamba_model()
    hybrid_parity = phase_hybrid_parity(jamba_cfg, jamba_params)
    torch.cuda.empty_cache()
    hybrid = phase_hybrid_serve(jamba_cfg, jamba_params)
    del jamba_params
    torch.cuda.empty_cache()
    hybrid_train = phase_hybrid_train_parity()
    torch.cuda.empty_cache()
    flash_d80 = phase_flash_d80()
    torch.cuda.empty_cache()
    gqa7_flash, gqa7_train, gqa7_decode = phase_gqa7_kernels()
    serve_tp_kernels = phase_serve_shard_kernels()
    split_lse = phase_split_lse()
    torch.cuda.empty_cache()
    hubert = phase_hubert_train()
    torch.cuda.empty_cache()
    vlm_train = phase_vlm_train()
    torch.cuda.empty_cache()
    vlm_serve = phase_vlm_serve()
    torch.cuda.empty_cache()
    arctic_parity = phase_moe_parity(ARCTIC_PARITY_LAYERS, clen=ARCTIC_CACHE,
                                     arch=ARCTIC, experts=ARCTIC_SHARE)
    torch.cuda.empty_cache()
    arctic = phase_moe_serve(ARCTIC, ARCTIC_LAYERS, ARCTIC_SERVE_ARGV,
                             ARCTIC_SHARE)
    torch.cuda.empty_cache()
    arctic_train = phase_arctic_train()
    torch.cuda.empty_cache()
    chunk = phase_chunk_kernels()
    torch.cuda.empty_cache()
    cross_shard = phase_cross_shard_loss()
    dist_train = phase_dist_train()
    torch.cuda.empty_cache()
    train_health = phase_train_health()
    torch.cuda.empty_cache()
    dist_gloo = phase_dist_train_gloo()
    torch.cuda.empty_cache()
    dist_lm = phase_dist_train_lm()
    torch.cuda.empty_cache()
    # the dry runs are the host's work alone: they run beside the untimed
    # gloo worlds, after every phase that times the card or the host
    dry_runs = start_dry_runs()
    ws, ws_lm, ws_ssm, ws_serving = phase_weight_sharding()
    torch.cuda.empty_cache()
    serve_shard = phase_serve_shard(ws_serving)
    torch.cuda.empty_cache()
    split = phase_serve_split([r["split"] for r in ws_serving])
    torch.cuda.empty_cache()
    tooling = phase_tooling(dry_runs)
    torch.cuda.empty_cache()

    f_main = flash[("image", torch.float32)]
    f_bf16 = max(r["max_abs_err"] for (_, dt), r in flash.items()
                 if dt == torch.bfloat16)
    t_main = topk[(16, 512, 5)]
    dec_main = decode[("bfloat16", "serving")]
    b_main = flash_bwd[("image", torch.float32)]
    b_bf16 = max(flash_bwd[(s, torch.bfloat16)]["max_abs_err"]
                 for s in ("image", "text"))
    c_fwd, c_bwd = contrastive[(2048, torch.float32)]
    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")

    def lm_of(direction, name):
        """The kernel at the LM training shape and its launches there."""
        return {"lm_train": [{k: lm_flash[(direction, dt)][k] for k in (
                    "shape", "plan", *timing, "device_ms")}
                    for dt in (torch.float32, torch.bfloat16)],
                "lm_launches_per_step": lm_per_step[name],
                "lm_device_kernels_per_call": lm_rep[
                    "device_kernels_per_call"][name],
                "lm_bf16_launches_per_step": lm_bf16["launches_per_step"][
                    name],
                "lm_f32_parity_launches": lm_parity["launches"][name]}

    def mixtral_of(name, recs, per):
        """The kernel at Mixtral's shapes and its launches on the MoE
        paths."""
        return {"mixtral": [{k: r[k] for k in (
                    "shape", "plan", *timing, "device_ms",
                    "library_device_ms")} for r in recs.values()],
                "mixtral_launches": moe["launches"][name],
                f"mixtral_launches_{per}": moe["per"][f"{name}_{per}"],
                "mixtral_lockstep_launches": moe["lockstep"]["launches"][
                    name],
                "mixtral_f32_parity_launches": moe_parity["launches"][name],
                "mixtral_device_kernels_per_call": moe["per_call"].get(name)}

    def mixtral_train_of(direction, name):
        """The kernel at Mixtral's training shapes and its launches on the
        MoE and hybrid training paths."""
        return {"mixtral_train": [{k: r[k] for k in (
                    "shape", "plan", *timing, "device_ms", "dq_part_bytes")
                    if k in r} for (d, _, _), r in moe_train_flash.items()
                    if d == direction],
                "mixtral_train_f32_launches_per_step": moe_train["f32"][
                    "launches_per_step"][name],
                "mixtral_train_bf16_launches_per_step": moe_train["bf16"][
                    "launches_per_step"][name],
                "mixtral_train_f32_parity_launches": moe_train["parity"][
                    "launches"][name],
                "jamba_smoke_train_parity_launches": hybrid_train[
                    "launches"][name]}

    def arctic_train_of(direction, name):
        """The kernel at Arctic's training shape (GQA 7, s 4096) and its
        launches on Arctic's training paths."""
        return {"arctic_train": [{k: gqa7_train[(direction, dt)][k] for k in (
                    "shape", "plan", *timing, "device_ms")}
                    for dt in ("float32", "bfloat16")],
                "arctic_train_bf16_launches_per_step": arctic_train["bf16"][
                    "launches_per_step"][name],
                "arctic_train_f32_parity_launches": {
                    label: r["launches"][name]
                    for label, r in arctic_train["parity"].items()}}

    def jamba_of(name, recs, per):
        """The kernel at Jamba's shapes and its launches on the hybrid
        paths."""
        return {"jamba": [{k: r[k] for k in (
                    "shape", "plan", *timing, "device_ms")
                    if k in r} for r in recs],
                "jamba_launches": hybrid["launches"][name],
                f"jamba_launches_{per}": hybrid["per"][f"{name}_{per}"],
                "jamba_lockstep_launches": hybrid["lockstep"]["launches"][
                    name],
                "jamba_f32_parity_launches": hybrid_parity["launches"][name],
                "jamba_device_kernels_per_call": hybrid["per_call"].get(
                    name)}

    def arctic_of(name, per):
        """The kernel's launches on Arctic-480B's serving and parity
        paths (GQA 7)."""
        return {"arctic_launches": arctic["launches"][name],
                f"arctic_launches_{per}": arctic["per"][f"{name}_{per}"],
                "arctic_lockstep_launches": arctic["lockstep"]["launches"][
                    name],
                "arctic_f32_parity_launches": arctic_parity["launches"][name],
                "arctic_device_kernels_per_call": arctic["per_call"].get(
                    name)}

    def families_of(direction, name):
        """The kernel at head dim 80 (HuBERT's training shape) and at
        Arctic's GQA 7, and its launches on the HuBERT and InternVL2
        paths."""
        def recs(table):
            return [{k: table[(direction, dt)][k] for k in (
                "shape", "plan", *timing, "device_ms")}
                for dt in ("float32", "bfloat16")]
        out = {"hubert_d80": recs(flash_d80),
               "hubert_launches_per_step": hubert["launches_per_step"][name],
               "hubert_f32_parity_launches": hubert["parity"]["launches"][
                   name],
               "arctic_gqa7": recs(gqa7_flash),
               "internvl2_train_launches_per_step": vlm_train["f32"][
                   "launches_per_step"][name],
               "internvl2_train_f32_parity_launches": vlm_train["parity"][
                   "launches"][name]}
        if direction == "fwd":
            out.update(
                internvl2_serve_launches=vlm_serve["launches"][name],
                internvl2_launches_per_prefill=vlm_serve["per"][
                    "flash_fwd_per_prefill"],
                internvl2_lockstep_launches=vlm_serve["lockstep"][
                    "launches"][name],
                internvl2_f32_parity_launches=vlm_serve["parity_launches"][
                    name])
        return out

    def dist_of(name, i=None):
        """The kernel's launches on the distributed trainer's paths and,
        for the contrastive pair (``i``: 0 forward, 1 backward), its chunk
        shapes."""
        out = {"dist_r1_launches_per_step": dist_train["launches_per_step"][
                   name],
               "dist_gloo_launches_per_rank": [
                   lc[name] for lc in dist_gloo["launches"]],
               "weight_sharding_launches_per_rank": {
                   k: [lc[name] for lc in r["launches"]]
                   for k, r in ws.items() if not k.endswith(" tp")},
               "tensor_parallel_launches_per_rank": {
                   k: [lc[name] for lc in r["launches"]]
                   for k, r in ws.items() if k.endswith(" tp")}}
        if i is None:
            out["tensor_parallel_launches_per_rank"]["lm 1x2 tp"] = [
                lc[name] for lc in ws_lm["tp"]["launches"]]
            out["tensor_parallel_launches_per_rank"].update(ssm_tp_of(name))
            return {**out, "dist_lm_launches": dist_lm["launches"][name],
                    "weight_sharding_lm_launches_per_rank": [
                        lc[name] for lc in ws_lm["basic_ws"]["launches"]]}
        return {**out, "chunk": [{k: r[i][k] for k in ("shape", *timing)}
                                 for r in chunk.values()],
                "cross_shard_launches_per_rank": {
                    f"R={w} {m} {dt}": cross_shard[(w, m, dt)]["launches"][
                        name]
                    for w in DIST_RANKS for m in ("allgather", "chunked")
                    for dt in ("float32", "bfloat16")}}

    def ssm_tp_of(name):
        """The kernel's launches on each rank of phase 43's Mamba-2 and
        hybrid runs under ``tp``, where it ran there."""
        return {label: [lc[name] for lc in r["launches"]]
                for label, r in ws_ssm.items() if name in r["launches"][0]}

    def ssd_tp_of(name):
        """The SSD kernel's launches and the shapes it launched at (b x l
        x h x p x n) on each rank of phase 43's runs under ``tp``."""
        return {"tensor_parallel_launches_per_rank": ssm_tp_of(name),
                "tensor_parallel_shapes_per_rank": {
                    label: [sh[name] for sh in r["ssd_shapes"]]
                    for label, r in ws_ssm.items()}}

    def serving_of(name, recs):
        """The kernel's launches on each rank of phase 56's sharded
        serving cases, where it ran there, and its records at a rank's
        shapes there and on the four-card probe's paths."""
        return {"sharded_serving_launches_per_rank": {
            label: [lc[name] for lc in r["launches"]]
            for label, r in serve_shard.items() if r["launches"][0][name]},
            "sharded_serving_shapes": [
                {k: r[k] for k in ("shape", "max_abs_err", *timing,
                                   "device_ms") if k in r} for r in recs]}

    def split_of(name, recs=None):
        """The kernel's launches on each rank of phase 57's sequence-split
        cases, where it ran there, and (``recs``) its records with the
        lse at a rank's slice shapes."""
        out = {"sequence_split_launches_per_rank": {
            label: [lc[name] for lc in r["launches"]]
            for label, r in split.items() if r["launches"][0][name]}}
        if recs is not None:
            out["sequence_split_lse"] = [
                {k: r[k] for k in ("shape", "max_abs_err", "lse_max_abs_err",
                                   *timing, "device_ms",
                                   "library_device_ms")} for r in recs]
        return out

    def recipe_of(name):
        """The kernel's launches in each part of the recipe phase."""
        return {part: counts[name]
                for part, counts in recipe_launches.items()}

    def train_entry(name, source, replaces, rec, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": train_launches[name],
                **{k: rec[k] for k in timing}, "shape": rec["shape"],
                "launches_per_step": train_per_step[name],
                "device_kernels_per_call": train_per_call[name],
                "recipe_launches": recipe_of(name), **extra}

    def legacy_entry(i, name, replaces):
        main = legacy[(2048, 1024, "float32")][i]
        f32 = [r[i] for (_, _, dt), r in legacy.items() if dt == "float32"]
        return {"name": name, "route": "cuda", "source": CL_SOURCE,
                "replaces": replaces, "launches": legacy_launches[name],
                **{k: main[k] for k in timing},
                "max_abs_err": max(r["max_abs_err"] for r in f32),
                "shape": main["shape"],
                "max_abs_err_bf16": max(r[i]["max_abs_err"] for (_, _, dt), r
                                        in legacy.items()
                                        if dt == "bfloat16"),
                "cases": [{k: r[k] for k in ("shape", *timing)}
                          for r in f32 if "ms" in r],
                "device_kernels_per_call": legacy_per_call[name]}

    kernels = [
        {"name": fa_ops.COUNTER.name, "route": "cuda",
         "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
         "launches": launches[fa_ops.COUNTER.name],
         **{k: f_main[k] for k in timing},
         "shape": f_main["shape"], "max_abs_err_bf16": f_bf16,
         **{k: f_main[k] for k in ("device_ms", "library_device_ms",
                                   "plan")},
         "text_f32": {k: flash[("text", torch.float32)][k]
                      for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                "library_device_ms", "bound_ms", "bound_by",
                                "plan")},
         "bf16": [{k: r[k] for k in ("shape", "plan", *timing,
                                     "unrounded_err")}
                  for (_, dt), r in flash.items()
                  if dt == torch.bfloat16],
         "device_kernels_per_call": per_call[fa_ops.COUNTER.name],
         "train_launches": train_launches[fa_ops.COUNTER.name],
         "recipe_launches": recipe_of(fa_ops.COUNTER.name),
         "train_launches_per_step": train_per_step[fa_ops.COUNTER.name],
         "f32_train_parity_launches": train_parity["launches"][
             fa_ops.COUNTER.name],
         "decode_launches": dec_launches[fa_ops.COUNTER.name],
         "decode_launches_per_prefill": dec_per["flash_fwd_per_prefill"],
         "prefill_bf16": prefill_flash["bfloat16"],
         "prefill_f32": prefill_flash["float32"],
         **lm_of("fwd", fa_ops.COUNTER.name),
         **mixtral_of(fa_ops.COUNTER.name, moe_flash, "per_prefill"),
         **jamba_of(fa_ops.COUNTER.name, jamba_flash.values(),
                    "per_prefill"),
         **mixtral_train_of("fwd", fa_ops.COUNTER.name),
         **arctic_train_of("fwd", fa_ops.COUNTER.name),
         **families_of("fwd", fa_ops.COUNTER.name),
         **arctic_of(fa_ops.COUNTER.name, "per_prefill"),
         **dist_of(fa_ops.COUNTER.name),
         **serving_of(fa_ops.COUNTER.name, serve_tp_kernels[0]),
         **split_of(fa_ops.COUNTER.name)},
        {"name": topk_ops.COUNTER.name, "route": "cuda",
         "source": TOPK_SOURCE, "replaces": TOPK_REPLACES,
         "launches": launches[topk_ops.COUNTER.name],
         **{k: t_main[k] for k in timing},
         "shape": t_main["shape"], "max_abs_err_bf16": topk_errs["bfloat16"],
         **{k: t_main[k] for k in ("device_ms", "library_device_ms",
                                   "plan")},
         "cases": [{k: topk[key][k] for k in (
             "shape", "ms", "device_ms", "plain_ms", "library_ms",
             "library_device_ms", "bound_ms", "bound_by")}
             for key in ((16, 512, 5), (64, 21841, 5))],
         "block_rows_ms": topk["block_rows_ms"],
         "recipe_launches": recipe_of(topk_ops.COUNTER.name),
         "device_kernels_per_call": per_call[topk_ops.COUNTER.name]},
        {"name": "topk_fused (n_valid)", "route": "cuda",
         "source": TOPK_SOURCE, "replaces": TOPK_REPLACES,
         "launches": retrieval["launches"],
         **{k: n_valid[NV_SHARD][k] for k in (*timing, "shape", "plan")},
         "max_abs_err_bf16": n_valid_errs["bfloat16"],
         "cases": [{k: r[k] for k in ("shape", *timing)}
                   for r in n_valid.values()],
         "retrieval_launches_per_call": {
             m: retrieval[m]["launches_per_call"]
             for m in ("fused", "sharded", "twostage", "twostage_8")}},
        train_entry(fa_ops.BWD_COUNTER.name, FLASH_BWD_SOURCE,
                    FLASH_BWD_REPLACES, b_main, max_abs_err_bf16=b_bf16,
                    **{k: b_main[k] for k in ("device_ms", "plan")},
                    f32_train_parity_launches=train_parity["launches"][
                        fa_ops.BWD_COUNTER.name],
                    text_f32={k: flash_bwd[("text", torch.float32)][k]
                              for k in (*timing, "device_ms", "plan")},
                    **lm_of("bwd", fa_ops.BWD_COUNTER.name),
                    **mixtral_train_of("bwd", fa_ops.BWD_COUNTER.name),
                    **arctic_train_of("bwd", fa_ops.BWD_COUNTER.name),
                    arctic_train_bwd_shapes=arctic_train["bf16"][
                        "flash_bwd_shapes"],
                    **families_of("bwd", fa_ops.BWD_COUNTER.name),
                    **dist_of(fa_ops.BWD_COUNTER.name)),
        train_entry(cl_ops.FWD_COUNTER.name, CL_SOURCE, CL_FWD_REPLACES,
                    c_fwd, max_abs_err_bf16=contrastive[
                        (2048, torch.bfloat16)][0]["max_abs_err"],
                    bf16={k: contrastive[(2048, torch.bfloat16)][0][k]
                          for k in ("shape", *timing, "device_ms")},
                    device_ms=c_fwd["device_ms"], plan=c_fwd["plan"],
                    ragged={k: contrastive[(1000, torch.float32)][0][k]
                            for k in ("shape", *timing, "device_ms",
                                      "plan")},
                    **dist_of(cl_ops.FWD_COUNTER.name, 0)),
        train_entry(cl_ops.BWD_COUNTER.name, CL_SOURCE, CL_BWD_REPLACES,
                    c_bwd, max_abs_err_bf16=contrastive[
                        (2048, torch.bfloat16)][1]["max_abs_err"],
                    bf16={k: contrastive[(2048, torch.bfloat16)][1][k]
                          for k in ("shape", *timing)},
                    **dist_of(cl_ops.BWD_COUNTER.name, 1)),
        *(legacy_entry(i, name, replaces) for i, (name, replaces) in
          enumerate(((cl_ops.ROW_COL_LSE_COUNTER.name, CL_LSE_REPLACES),
                     (cl_ops.GRADS_COUNTER.name, CL_GRADS_REPLACES)))),
        {"name": dec_ops.COUNTER.name, "route": "cuda",
         "source": DEC_SOURCE, "replaces": DEC_REPLACES,
         "launches": dec_launches[dec_ops.COUNTER.name],
         **{k: dec_main[k] for k in timing},
         "shape": dec_main["shape"],
         "max_abs_err_f32": decode_errs["float32"],
         **{k: dec_main[k] for k in ("device_ms", "library_device_ms",
                                     "bound_full_sweep_ms", "plan")},
         "cases": [{k: r[k] for k in ("shape", "ms", "device_ms",
                                      "plain_ms", "library_ms",
                                      "library_device_ms", "bound_ms",
                                      "bound_by", "bound_full_sweep_ms")}
                   for r in decode.values()],
         "launches_per_step": dec_per["decode_attention_per_step"],
         "device_kernels_per_call": dec_per_call[dec_ops.COUNTER.name],
         "parity_max_logit_diff": max(parity["linear"][0],
                                      parity["ring"][0]),
         **mixtral_of(dec_ops.COUNTER.name, moe_decode, "per_step"),
         "mixtral_parity_max_logit_diff": moe_parity["max_logit_diff"],
         **jamba_of(dec_ops.COUNTER.name, jamba_decode.values(), "per_step"),
         "jamba_parity_max_logit_diff": hybrid_parity["max_logit_diff"],
         "arctic_gqa7": [{k: gqa7_decode[dt][k] for k in (
             "shape", "plan", *timing, "device_ms")}
             for dt in ("float32", "bfloat16")],
         "internvl2_launches": vlm_serve["launches"][dec_ops.COUNTER.name],
         "internvl2_launches_per_step": vlm_serve["per"][
             "decode_attention_per_step"],
         "internvl2_lockstep_launches": vlm_serve["lockstep"]["launches"][
             dec_ops.COUNTER.name],
         "internvl2_f32_parity_launches": vlm_serve["parity_launches"][
             dec_ops.COUNTER.name],
         "internvl2_parity_max_logit_diff": vlm_serve["parity"][
             "max_logit_diff"],
         **arctic_of(dec_ops.COUNTER.name, "per_step"),
         "arctic_parity_max_logit_diff": arctic_parity["max_logit_diff"],
         **serving_of(dec_ops.COUNTER.name, serve_tp_kernels[1]),
         **split_of(dec_ops.COUNTER.name, split_lse)},
        {"name": ssd_ops.COUNTER.name, "route": "cuda",
         "source": SSD_SOURCE, "replaces": SSD_REPLACES,
         "launches": ssm_launches[ssd_ops.COUNTER.name],
         **{k: ssd[("l=256", "bfloat16")][k] for k in timing},
         "shape": ssd[("l=256", "bfloat16")]["shape"],
         "max_abs_err_f32": max(r["max_abs_err"] for (_, dt), r in
                                ssd.items() if dt == "float32"),
         "device_ms": ssd[("l=256", "bfloat16")]["device_ms"],
         "plan": ssd[("l=256", "bfloat16")]["plan"],
         "cases": [{k: r[k] for k in ("shape", "plan", "max_abs_err_y",
                                      "max_abs_err_state", "tol_y",
                                      "tol_state", "ms", "device_ms",
                                      "plain_ms", "bound_ms", "bound_by")
                    if k in r}
                   for r in ssd.values()],
         "launches_per_prefill": ssm_per_prefill,
         "device_kernels_per_call": ssm_per_call[ssd_ops.COUNTER.name],
         "parity_max_logit_diff": ssm_parity["max_logit_diff"],
         **jamba_of(ssd_ops.COUNTER.name, jamba_scan.values(),
                    "per_prefill"),
         "jamba_max_abs_err_f32": max(r["max_abs_err"] for (_, dt), r in
                                      jamba_scan.items()
                                      if dt == "float32"),
         "ssm_train_launches_per_step": ssm_train["launches_per_step"][
             ssd_ops.COUNTER.name],
         "ssm_train_device_kernels_per_call": ssm_train[
             "device_kernels_per_call"][ssd_ops.COUNTER.name],
         "ssm_train_f32_parity_launches": ssm_train_parity["launches"][
             ssd_ops.COUNTER.name],
         "jamba_smoke_train_parity_launches": hybrid_train["launches"][
             ssd_ops.COUNTER.name],
         **ssd_tp_of(ssd_ops.COUNTER.name),
         **serving_of(ssd_ops.COUNTER.name, serve_tp_kernels[2]),
         **split_of(ssd_ops.COUNTER.name)},
        {"name": ssd_ops.BWD_COUNTER.name, "route": "cuda",
         "source": SSD_BWD_SOURCE, "replaces": SSD_BWD_REPLACES,
         "launches": ssm_train_launches[ssd_ops.BWD_COUNTER.name],
         **{k: ssd_bwd[("mamba2", "float32")][k] for k in timing},
         **{k: ssd_bwd[("mamba2", "float32")][k] for k in (
             "shape", "device_ms", "plan", "errs", "fp64_rel")},
         "max_abs_err_bf16": max(r["max_abs_err"] for (_, dt), r in
                                 ssd_bwd.items() if dt == "bfloat16"),
         "cases": [{k: r[k] for k in ("shape", "plan", "max_abs_err", "ms",
                                      "device_ms", "device_kernels",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "fp64_rel")}
                   for r in ssd_bwd.values()],
         "launches_per_step": ssm_train["launches_per_step"][
             ssd_ops.BWD_COUNTER.name],
         "device_kernels_per_call": ssm_train["device_kernels_per_call"][
             ssd_ops.BWD_COUNTER.name],
         "bf16_launches_per_step": ssm_train["bf16"]["launches_per_step"][
             ssd_ops.BWD_COUNTER.name],
         "f32_parity_launches": ssm_train_parity["launches"][
             ssd_ops.BWD_COUNTER.name],
         "jamba_smoke_train_parity_launches": hybrid_train["launches"][
             ssd_ops.BWD_COUNTER.name],
         **ssd_tp_of(ssd_ops.BWD_COUNTER.name)},
    ]
    print(f"recipe: phase 1 {recipe['pretrain']['images_per_s']:.1f} "
          f"images/s, phase 2 {recipe['frozen']['pairs_per_s']:.1f} pairs/s, "
          f"phase 3 {recipe['finetune']['pairs_per_s']:.1f} pairs/s; top1 "
          f"{recipe['bench']['top1']:.4f} (benchmark) / "
          f"{recipe['served']['top1']:.4f} (served); zero-shot table seen "
          f"{recipe['table']['seen']:.3f}, unseen "
          f"{recipe['table']['unseen_openvocab']:.3f}, shifted "
          f"{recipe['table']['shifted_robustness']:.3f}; §4.2 mean_K(c) "
          f"error {accum['grad_rel_err']:.3g}, first moment error "
          f"{accum['m_rel_err']:.3g}", flush=True)
    print(f"lm: --mode lm {lm_rep['warm_step_median_s']:.4f} s a step, "
          f"{lm_rep['tokens_per_s']:.1f} tokens/s, "
          f"{lm_rep['max_memory_allocated'] / 2**30:.3f} GiB; "
          f"make_train_step bf16 {lm_bf16['warm_step_median_s']:.4f} s, "
          f"{lm_bf16['tokens_per_s']:.1f} tokens/s, "
          f"{lm_bf16['max_memory_allocated'] / 2**30:.3f} GiB; f32 parity "
          f"loss {lm_parity['loss_err']:.3g}, gradients "
          f"{lm_parity['grad_rel_err']:.3g}; checkpoint "
          f"{lm_rep['ckpt_bytes'] / 1e9:.3f} GB: save "
          f"{lm_rep['ckpt_save_s']:.3f} s, restore "
          f"{lm_rep['ckpt_restore_s']:.3f} s, async stall "
          f"{lm_rep['ckpt_async_stall_s']:.3f} s; registry from disk "
          f"{registry['disk_s']:.3f} s (computed "
          f"{registry['computed_s']:.3f} s)", flush=True)
    print(f"lm profile busy share {lm_rep['busy']:.4f}", flush=True)
    mrep = moe["rep"]
    print(f"moe: Mixtral-8x22B ({MOE_SERVE_LAYERS} of 56 layers) bf16 "
          f"decode {mrep['decode_tokens_per_s']:.1f} tok/s, step median "
          f"{mrep['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{mrep['step_p90_s'] * 1e3:.3f} ms, prefill "
          f"{mrep['prefill_mean_s'] * 1e3:.3f} ms, "
          f"{moe['max_memory_allocated'] / 2**30:.3f} GiB, decode profile "
          f"busy share {moe['busy']:.4f}; f32 parity max |logit diff| "
          f"{moe_parity['max_logit_diff']:.3g} ("
          f"{len(moe_parity['near_tie_rows'])} rows at a router near-tie)",
          flush=True)
    hrep = hybrid["rep"]
    print(f"hybrid: Jamba-1.5-Large ({JAMBA_LAYERS} of 72 layers, experts "
          f"{JAMBA_SHARE[0]}-{sum(JAMBA_SHARE) - 1} of 16) bf16 decode "
          f"{hrep['decode_tokens_per_s']:.1f} tok/s, step median "
          f"{hrep['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{hrep['step_p90_s'] * 1e3:.3f} ms, prefill "
          f"{hrep['prefill_mean_s'] * 1e3:.3f} ms, "
          f"{hybrid['max_memory_allocated'] / 2**30:.3f} GiB, decode profile "
          f"busy share {hybrid['busy']:.4f}; f32 parity max |logit diff| "
          f"{hybrid_parity['max_logit_diff']:.3g} ("
          f"{len(hybrid_parity['near_tie_rows'])} rows at a router near-tie)"
          f", engines {hybrid_parity['engines']['same']} of "
          f"{hybrid_parity['engines']['requests']} requests equal",
          flush=True)
    srep, mt = ssm_train, moe_train
    print(f"ssm train: Mamba-2-130M --mode lm f32 (b 2 x s 4096) "
          f"{srep['warm_step_median_s']:.4f} s a step, "
          f"{srep['tokens_per_s']:.1f} tokens/s, "
          f"{srep['max_memory_allocated'] / 2**30:.3f} GiB, profile busy "
          f"share {srep['busy']:.4f}, device ms by group "
          f"{ {k: round(v, 3) for k, v in srep['profile_ms_by_group'].items()} }"
          f"; make_train_step bf16 "
          f"{srep['bf16']['warm_step_median_s']:.4f} s, "
          f"{srep['bf16']['tokens_per_s']:.1f} tokens/s, "
          f"{srep['bf16']['max_memory_allocated'] / 2**30:.3f} GiB; f32 "
          f"parity gradients {ssm_train_parity['grad_rel_err']:.3g}, Jamba "
          f"mixer layer {ssm_train_parity['jamba_mixer_grad_rel_err']:.3g}",
          flush=True)
    print(f"moe train: {MIXTRAL} 1 layer ({mt['params']} params) lm_step f32 "
          f"(b 1 x s {MOE_TRAIN_SEQ}) {mt['f32']['warm_step_median_s']:.4f} "
          f"s, {mt['f32']['tokens_per_s']:.1f} tokens/s, "
          f"{mt['f32']['max_memory_allocated'] / 2**30:.3f} GiB; "
          f"make_train_step bf16 {mt['bf16']['warm_step_median_s']:.4f} s, "
          f"{mt['bf16']['tokens_per_s']:.1f} tokens/s, "
          f"{mt['bf16']['max_memory_allocated'] / 2**30:.3f} GiB; f32 parity "
          f"gradients {mt['parity']['grad_rel_err']:.3g}; hybrid smoke "
          f"parity gradients {hybrid_train['grad_rel_err']:.3g}", flush=True)
    at, atb = arctic_train, arctic_train["bf16"]
    print(f"arctic train: {ARCTIC} {ARCTIC_TRAIN_LAYERS} of 35 layers, "
          f"experts {ARCTIC_SHARE[0]}-{sum(ARCTIC_SHARE) - 1} of 128 "
          f"({at['params']} params) make_train_step bf16 (b 1 x s "
          f"{ARCTIC_TRAIN_SEQ}) {atb['warm_step_median_s']:.4f} s, "
          f"{atb['tokens_per_s']:.1f} tokens/s, "
          f"{atb['max_memory_allocated'] / 2**30:.3f} GiB, flash_bwd at "
          f"{atb['flash_bwd_shapes']}; f32 parity gradients capacity "
          f"{at['parity']['capacity']['grad_rel_err']:.3g}, dense "
          f"{at['parity']['dense']['grad_rel_err']:.3g}", flush=True)
    print(f"distributed: R=1 BASIC-S bf16 B 2048 "
          f"{dist_train['warm_step_median_s']:.4f} s a step, "
          f"{dist_train['pairs_per_s']:.1f} pairs/s, "
          f"{dist_train['max_memory_allocated'] / 2**30:.3f} GiB, split "
          f"{ {k: round(v, 4) for k, v in dist_train['split'].items()} }, "
          f"last checkpoint stall {dist_train['ckpt_last_stall_s']}; "
          f"train_lm Llama-3.2-1B {dist_lm['warm_step_median_s']:.4f} s, "
          f"{dist_lm['tokens_per_s']:.1f} tokens/s, "
          f"{dist_lm['max_memory_allocated'] / 2**30:.3f} GiB; cross-shard "
          f"loss worst f32 loss rel err "
          f"{max(r['loss_rel_err'] for k, r in cross_shard.items() if k[-1] == 'float32'):.3g}"
          f"; R=2 gloo trainer losses {dist_gloo['losses'][0]} vs R=1 "
          f"{dist_gloo['r1_losses']}", flush=True)
    hr, vr, vs = hubert["rep"], vlm_train["f32"], vlm_serve["rep"]
    print(f"audio: {HUBERT} --mode lm f32 (48 layers, b 2 x s 4096) "
          f"{hr['warm_step_median_s']:.4f} s a step, "
          f"{hr['tokens_per_s']:.1f} frames/s, "
          f"{hr['max_memory_allocated'] / 2**30:.3f} GiB; f32 parity "
          f"gradients {hubert['parity']['grad_rel_err']:.3g}; vlm: "
          f"{INTERNVL2} lm_step f32 ({VLM_TRAIN_LAYERS} of 80 layers, b 1 x "
          f"s {VLM_TRAIN_SEQ}) {vr['warm_step_median_s']:.4f} s, "
          f"{vr['tokens_per_s']:.1f} tokens/s, "
          f"{vr['max_memory_allocated'] / 2**30:.3f} GiB; f32 parity "
          f"gradients {vlm_train['parity']['grad_rel_err']:.3g}; serving "
          f"({VLM_SERVE_LAYERS} of 80 layers) bf16 decode "
          f"{vs['decode_tokens_per_s']:.1f} tok/s, step median "
          f"{vs['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{vs['step_p90_s'] * 1e3:.3f} ms, prefill "
          f"{vs['prefill_mean_s'] * 1e3:.3f} ms, "
          f"{vlm_serve['max_memory_allocated'] / 2**30:.3f} GiB; f32 parity "
          f"max |logit diff| {vlm_serve['parity']['max_logit_diff']:.3g}",
          flush=True)
    arep = arctic["rep"]
    print(f"moe: {ARCTIC} ({ARCTIC_LAYERS} of 35 layers, experts "
          f"{ARCTIC_SHARE[0]}-{sum(ARCTIC_SHARE) - 1} of 128) bf16 decode "
          f"{arep['decode_tokens_per_s']:.1f} tok/s, step median "
          f"{arep['step_median_s'] * 1e3:.3f} ms, p90 "
          f"{arep['step_p90_s'] * 1e3:.3f} ms, prefill "
          f"{arep['prefill_mean_s'] * 1e3:.3f} ms, "
          f"{arctic['max_memory_allocated'] / 2**30:.3f} GiB, decode profile "
          f"busy share {arctic['busy']:.4f}; f32 parity "
          f"({ARCTIC_PARITY_LAYERS} layers) max |logit diff| "
          f"{arctic_parity['max_logit_diff']:.3g} ("
          f"{len(arctic_parity['near_tie_rows'])} rows at a router "
          f"near-tie)", flush=True)
    tc, tl, tp_ = tooling["contrastive"], tooling["lm"], tooling["dry"]["pod"]
    print(f"tooling: train_distributed --memstats peak "
          f"{tooling['train_memstats']['peak'] / 2**30:.4f} GiB = "
          f"max_memory_allocated; dry runs against the card: BASIC-S "
          f"contrastive peak {100 * tc['peak_share']:+.2f}%, FLOPs equal, "
          f"step {tc['step_s']:.4f} s vs compute bound "
          f"{tc['roofline']['compute_s']:.4f} s; Llama-3.2-1B peak "
          f"{100 * tl['peak_share']:+.2f}%, FLOPs equal, step "
          f"{tl['step_s']:.4f} s vs compute bound "
          f"{tl['roofline']['compute_s']:.4f} s; BASIC-L contrastive_64k on "
          f"16x16: {tp_['memory']['peak_gb_per_device']} GB a rank, "
          f"bottleneck {tp_['roofline']['bottleneck']}", flush=True)
    t8 = retrieval["twostage_8"]
    print(f"retrieval: BASIC-S 64 queries x {RETRIEVAL_N} rows, k "
          f"{RETRIEVAL_K}, p50 / p90 ms: " + ", ".join(
              f"{m} {retrieval[m]['p50_s'] * 1e3:.3f} / "
              f"{retrieval[m]['p90_s'] * 1e3:.3f}"
              for m in ("fused", "sharded", "twostage", "twostage_8"))
          + f"; nprobe {RETRIEVAL_NPROBE} recall@10 {t8['recall_at_10']:.4f}"
          f"; /healthz {retrieval['healthz_flip']} under an unmet SLO; "
          f"train health: skipped {train_health['steps_skipped']} step, "
          f"state kept {train_health['state_kept']}", flush=True)
    print(f"train profile busy share {busy:.4f}; decode profile busy share "
          f"{dec_busy:.4f}; ssm prefill profile busy share "
          f"{ssm_prefill_busy:.4f}; ssm decode profile busy share "
          f"{ssm_busy:.4f}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
