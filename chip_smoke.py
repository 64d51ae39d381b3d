#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``mxnet_tpu_torch/csrc`` for
   sm_90a (one nvcc per source, in parallel) into ``build/kernels/``;
3. one phase per kernel at the served shapes: the kernel against its
   plain PyTorch version on the same inputs (f32: rtol 1e-4, atol 1e-5,
   since the reductions run in another order; cache bytes and inactive
   slots exact), CUDA-event times of kernel, plain version and, where
   one exists, the single PyTorch call computing the same function
   (median of 60 launches after warm-up, L2 flushed before each), and
   the least time the card could take (bytes over 3.35 TB/s or f32
   operations over 67 TFLOP/s, whichever is larger; for the f32
   attention kernels and the f32 fused GEMM, which run split TF32 on the
   tensor cores, operations over 494.7 / 3 TFLOP/s, the CUDA-core bound
   printed beside); the chunked prefill (split TF32 over key ranges, then
   an ordered combine; its instances' ptxas lines first, no spills) is
   checked at the mixed step's chunk, ragged and empty chunks, the spec
   step's 8 x 5-row spans and bf16 caches (padded rows zeros, caches
   equal to the plain version's, nothing written outside [start, start +
   len), two runs bit-identical) and timed at the mixed chunk and the
   spec spans beside SDPA on the gathered context; its bf16 kernel
   (bf16 q/k/v over bf16 caches, attention_bf16.cuh; its instances'
   ptxas lines, no spills) the same way at the same cases and at the
   head_dims of PAGED_BF16_DIMS, outputs at rtol 2^-7 / atol 1e-5, timed
   beside SDPA in bf16; decode (each slot's
   keys split evenly over the blocks of a thread block cluster; its
   instances' ptxas lines first, no spills) is checked in all four (q,
   cache) type pairs over long contexts (positions 20-731) and serve's
   short ones (20-145), with an inactive slot and a position past the
   table, and over one slot, two runs bit-identical, and timed alone
   and 200 calls back to back beside SDPA over each slot's gathered
   context, in f32 and in bf16 (q and caches); the LayerNorm forward (a group of warps a row, the row in
   registers; its instances' ptxas lines first, no spills) at the rows
   of every path that runs it (8, 40, 64, 1024, 4096 and 8192 of 2048
   columns), at the widths of LN_FWD_EDGES (ragged, looped, the widest
   row the wrapper took before) and on misaligned rows, two runs
   bit-identical, timed alone after a flush that writes and one that
   reads, and 200 calls back to back, beside ``F.layer_norm``;
4. serve: the transformer LM at full width (L12, d2048, h16, vocab
   16384, ffn 8192, seq 1024; random N(0, 0.02) weights from a numpy
   seed) through ``DecodeEngine``: 8 ragged requests fill the 8 slots
   and the first one, submitted again, waits for a slot and is admitted
   mid-flight; every request must finish with its token count, the
   resubmitted one must repeat its stream.  Since PR 18 each step is one
   replay of the step captured as a CUDA graph (``serve_arms``: the
   engine's warm-up and capture inside the counted run): the step graph
   records each paged kernel 12 times and LayerNorm 50 (one replay a
   step; the wrappers count only the warm-up walks and the capture), the
   witnesses hold (``dispatches_per_step`` 1.0, no retrace), no plain
   version runs; a profiled window of 4 steady steps makes one
   ``cudaGraphLaunch`` and no kernel launch call a step and syncs the
   host only at the token readback; an eager arm
   (``MXNET_DECODE_DONATE=0``) on the same prompts gives the same streams
   and bit-equal first-step logits (else rtol/atol 1e-4 and the first
   differing op named); wall, tokens/s, step p50, TTFT, device ms, idle
   share and peak memory of both arms printed;
5. agreement: the same engine at 2 layers on the card (captured), on
   the card eager and on the CPU (plain versions) over 3 requests:
   per-step logits within rtol 1e-4 / atol 1e-4 and equal greedy streams
   card against CPU (a stream is compared only up to a step where the
   CPU's top-2 logit margin is inside that tolerance), bit-equal logits
   captured against eager; two captured engines stepping at once on two
   threads, a ``swap_params`` while serving, and two forwards that
   cannot be captured (a host read, a random draw) raising every time;
6. layernorm_bwd, flash_fwd, flash_bwd: the training kernels at the
   training shapes (LayerNorm backward on 4096 x 2048 and at the widths
   of LN_BWD_EDGES, with and without a residual, two runs bit-identical,
   its instances' ptxas lines, no spills; causal flash attention on
   (4, 16, 1024, 128), (2, 4, 1000, 36) and (1, 2, 200, 30), after the
   f32 kernels' ptxas lines (no spills) and the name of the kernel SDPA
   launches in f32), each against its plain version, timed as in 3,
   beside ``native_layer_norm_backward`` and
   ``scaled_dot_product_attention`` (forward, and its backward) as the
   library yardsticks;
7. train: the same full-width model trained through ``Module.fit``'s
   eager pair (``MXNET_FIT_FUSED=0``; 31 drives the fused step)
   (SGD, momentum 0.9, learning rate 0.05, perplexity metric) over two
   fixed batches of 4 x 1024 random tokens for 5 epochs: the loss must
   be finite and fall on the repeated batch, every step must launch
   LayerNorm forward and backward 25 times and each flash kernel 12
   times, and no plain version may run; step time p50 over the last 8
   steps, tokens/s and peak device memory are printed;
8. train_agreement: the model at 2 layers, batch 2, seq 256, from the
   same numpy weights on the card and on the CPU: the loss, every
   parameter's gradient after one forward/backward and every
   parameter's change after 2 SGD steps agree within 1e-3 of the CPU's
   largest value of that quantity;
9. quant: the 2-bit quantizer against its plain version, bit for bit
   (int32 views, so NaN and -0.0 count) at the lengths of ``QUANT``, a
   4-byte-offset view and the edge values (NaN, +-inf, -0.0, sums at
   +-t and one ulp either side), thresholds 0.5 and 0.1; timed at a full
   4 MiB bucket and at ResNet-50's largest array (16 bytes per element
   over 3.35 TB/s bound it);
10. kvstore: the same numpy gradient streams (3 per key, 4 steps, the
   shapes of ``KV``, one key above the 4 MiB bucket cap) through a
   2-bit store on the card and one on the CPU: with no updater the
   pulled values and residuals are bit-identical, card against CPU and
   bucketed against eager; with SGD they agree within rtol/atol 5e-7;
11. train_resnet: ResNet-50 v2 (3x224x224, 1000 classes, seeded weights
   and BatchNorm statistics) through ``Module.fit``'s eager pair
   (``MXNET_FIT_FUSED=0``) with
   ``mx.kv.create('device')``, batch 128, two fixed synthetic batches
   for 5 epochs (SGD, learning rate 0.05, momentum 0.9, wd 1e-4,
   accuracy metric), a dense arm (the loss must be finite and fall on
   the repeated batch, the quantizer never runs) and a 2-bit arm
   (threshold 0.5: each step launches the quantizer once per bucket the
   engine dispatched, the same count every step after the first, the
   flat residuals stay finite, no plain version runs); step p50,
   images/s, peak memory and buckets per step are printed;
12. resnet_agreement: ResNet-18 (7x7 stem and max-pool) at 3x64x64, 10
   classes, batch 4, card against CPU from the same numpy weights: loss
   (rtol 1e-3), every gradient and moving statistic after the train
   forward (within 1e-3 and 1e-4 of the CPU's largest value of each),
   and one 2-bit update at the median |g|: q equal wherever the CPU's
   |g| lies farther than 1e-4 t from t, the elements inside that band
   counted and under 1e-4 of all;
13. fused_matmul: the fused BN-apply/ReLU/1x1-convolution kernel in f32
   (split TF32 on the tensor cores, fused_gemm_f32.cuh; its instances'
   ptxas lines and shared memory first, no spills, no CUDA-core kernel
   left) against its plain version (rtol 1e-4 / atol 1e-5) at the 8 (M,
   K, N) shapes of ResNet-50's 28 fused sites at batch 128 and one odd
   shape, two runs bit-identical; timed as in 3 beside
   ``torch.addmm``/``torch.matmul`` on the already activated input (the
   product alone: a yardstick that skips the activation pass the kernel
   fuses), each site's TFLOP/s and GB/s;
14. train_resnet_nhwc: ResNet-50 v2 through ``parallel.TrainStep`` from
   the same numpy weights (OIHW transposed to OHWI for the channel-last
   arms) in three arms, NCHW, NHWC, and NHWC after ``fuse_conv_bn``:
   batch 128, SGD (learning rate 0.05, momentum 0.9, wd 1e-4, gradients
   rescaled by 1/batch as bench.py and Module.fit do), 10 steps over two
   fixed batches; the first-step losses agree within 1e-3, the
   loss falls on the repeated batch, the fused arm launches the kernel
   exactly 28 times per step and no plain version, the others never
   launch it; step p50, images/s and peak memory are printed per arm;
15. resnet_nhwc_agreement: one fused site's backward (16384 x 64 ->
   256 with a residual) card against CPU, each gradient within 1e-4 of
   its largest CPU value; then the fused NHWC ResNet-50 at 3x64x64, 10
   classes, batch 4, one TrainStep step on the card and on the CPU from
   the same numpy weights: loss (rtol 1e-3), probabilities (atol 1e-4),
   every moving statistic (1e-4 of its largest CPU value) and the whole
   gradient's relative L2 error (0.1: at random initialisation the
   gradient moves by percents under rounding-level changes, so a CPU run
   on the input scaled by 1 + 2^-22 is printed beside it);
16. prefill (with the kernel phases of 3): the one-shot prefill kernel
   against its plain version on all S output rows (rtol 1e-4 / atol
   1e-5) and on the cache bytes (exact, the bytes it must leave alone
   included) at the served shape (B 8, S 1024, 16 heads of 128, block
   16, 512 blocks, lengths 0 to 1024 over a scrambled table whose
   padding entries are out-of-range ids), at S = 1000 with a table wider
   than S needs, and with bf16 caches; the bf16 kernel (bf16 q/k/v over
   bf16 caches, attention_bf16.cuh) at the served shape and the head_dims
   of PAGED_BF16_DIMS at rtol 2^-7 / atol 1e-5; two runs bit-identical
   (the instances' ptxas lines first, no spills); timed, f32 and bf16, as
   in 3 beside ``scaled_dot_product_attention(is_causal=True)`` on
   (B, H, S, D) views of the same q/k/v (the attention without the
   scatter);
17. serve_prefill (after 5): the full-width model's decode-step and
   prefill symbols bound as a pair with ``shared_exec`` (one copy of the
   weights and caches): the 8 prompts of 4 prefilled in one forward
   (exactly 12 prefill and 25 LayerNorm launches), then 31 decode-step
   forwards (12 decode and 25 LayerNorm launches each), no plain
   version; the greedy streams equal the mixed-step engine's on the
   same prompts under 5's margin rule; prefill ms, decode step p50 and
   peak memory printed.  Two arms (``prefill_arms``): eager, then both
   executors donating their caches and capturing into one graph pool
   (each graph records the counts above, a steady decode step is one
   graph launch, streams and prefill logits equal the eager arm's), peak
   GB allocated and reserved beside each;
18. serve_spec: ``DecodeEngine(spec_k=4)`` at full width, an n-gram arm
   (8 prompts with repeating tails, 32 new tokens each: streams equal
   the mixed-step engine's under the margin rule, drafts proposed, and
   every step launches the chunk kernel 24 times, LayerNorm 50 and the
   decode kernel never) and a draft arm (the target's own weights as
   the draft model, 4 requests of 16 tokens: accept rate at least 0.9,
   12 flash-forward launches per proposed token); tokens per launch,
   accept rate, step p50 and tokens/s printed.  Each drafter in two arms
   (``spec_arms``): eager, then captured (the spec step's graph and one
   draft graph per span length, all captured by ``warmup()``; the counts
   above are what the graphs record and replay; one graph launch a step
   and one a proposal in the steady window; streams and first-step
   logits equal the eager arm's);
19. prefill_agreement: the pair at 2 layers (prefill length 256) on the
   card and on the CPU from the same numpy weights over 3 prompts:
   prefill logits (rtol 1e-4 / atol 1e-4), the prefilled cache rows
   (rtol 1e-4 / atol 1e-5), and 8-token decode streams under the margin
   rule with their logits within the same bound;
20. flash_bf16, layernorm_bf16, fused_matmul_bf16 (with the kernel
   phases of 3): the bf16 forms against their plain versions, within one
   bf16 ulp of the value (2^-7 relative) plus 2^-9 of the array's
   largest magnitude (f32 statistics and lse at 3's bound): flash
   forward, dK/dV and dQ (tensor cores; their ptxas register, stack and
   spill lines printed first) at (4, 16, 1024, 128) and at the edges of
   their tiling (S 17 and 1000, D 80 and 36, batch 1, head_dim 256 and
   512), FlashAttentionFn end to end against autograd through the
   reference (relative L2 1e-2), each kernel's achieved TFLOP/s;
   LayerNorm forward and backward at
   4096 x 2048 (the forward also at LN_FWD_EDGES and misaligned rows,
   the backward at LN_BWD_EDGES, two runs bit-identical); the fused kernel (tensor cores: the mma.sync GEMM of
   fused_gemm_bf16.cuh; its instances' ptxas lines and shared memory
   printed first, no spills allowed, the CUDA-core kernel f32 only) at
   ResNet-50's 8 site shapes at batch 256, the odd shape and the edges of
   its tiling (M off the row tile, K 72, N 64 and 36, x 2 bytes off
   alignment), two runs bit-identical, each site's TFLOP/s and GB/s;
   timed as in 3 beside
   SDPA, F.layer_norm / native_layer_norm_backward and cuBLAS bf16 on
   the same bf16 tensors, bounded by bytes over 3.35 TB/s or operations
   over the dense bf16 tensor-core peak (989 TFLOP/s);
21. head_dim: every attention kernel (flash x3, prefill, chunk, decode)
   at head_dim 256 and 512 with d_model kept at 2048, against its plain
   version (f32 bound of 3, cache bytes exact), timed at 256; decode
   also at the ragged head_dims 72, 30 and (bf16 caches) 36;
22. train_bf16 (after 7): bench.py's transformer train mode in bf16,
   the full-width model through ``parallel.TrainStep`` with SGD momentum
   0.9 and multi_precision (learning rate 0.01, gradients rescaled by
   1/(B*S)), 10 steps over two fixed batches of 4 x 1024 tokens: every
   step launches each flash kernel 12 times and LayerNorm forward and
   backward 25 times, all in bf16, no plain version; the loss stays
   finite and every bf16 weight matrix's f32 master moves; step p50 over
   the last 8, tokens/s, peak memory;
23. train_resnet_bf16 (after 15): bench.py's flagship, ResNet-50 v2
   NHWC bf16 at batch 256 through TrainStep with its SGD (0.1, momentum
   0.9, wd 1e-4, multi_precision), unfused and after ``fuse_conv_bn``:
   exactly 28 bf16 fused launches per step in the fused arm, none in
   the other; the loss finite and falling on the repeated batch; step
   p50, images/s and peak memory per arm;
24. bf16_agreement: bf16 TrainStep, card against CPU, 2 steps from the
   same numpy weights: ResNet-18 NCHW at 3x32x32 batch 4, the fused
   NHWC arm on a small bottleneck ResNet, a 2-layer bf16 transformer;
   outputs and the f32 masters' moves within relative L2 bounds
   (phase_bf16_agreement), a perturbed CPU run printed beside;
25. head_dim_agreement: a 2-layer transformer at head_dim 256 (d_model
   512, 2 heads), card against CPU: one f32 TrainStep step, then
   prefill plus 8 decode steps through the decode-step pair.

26. rtc (with the kernel phases of 3): ``mx.rtc.CudaModule`` compiles
   three user kernels with NVRTC for sm_90a (compile ms printed) and
   each is launched once through ``get_kernel(...).launch`` (the counted
   run): MXNet's ``axpy`` on 2^26 f32 at rtol 1e-4 / atol 1e-5 and
   ``row_sum`` (dynamic shared memory, one block per row of an (8192,
   4096) f32 matrix) within 1e-4 of each row's sum of magnitudes plus
   1e-5, and the template ``axpy<double>`` through ``exports``
   (compiled with ``--fmad=false``) bit-equal to its plain version; a
   compile error must raise with NVRTC's log, a CPU context, a wrong
   dtype and an unknown kernel must raise; times as in 3 beside
   ``add_`` and ``sum``, and the host microseconds per launch;
27. gluon_resnet (after 11): model-zoo ResNet-50 v2 (3x224x224, 1000
   classes, Xavier from ``mx.random.seed``) trained through Gluon at
   batch 128 with ``SoftmaxCrossEntropyLoss`` and ``Trainer(..., 'sgd',
   lr 0.1, momentum 0.9, wd 1e-4, kvstore='device')`` for 10 steps over
   two fixed batches in three arms: imperative, hybridized, and
   hybridized with 2-bit compression (threshold 0.5: one quantizer
   launch per dispatched bucket); each step is ``autograd.record()`` ->
   forward -> loss -> ``backward()`` -> ``trainer.step(128)`` and one
   loss readback; the loss must fall on the repeated batch in every arm,
   the arms' first losses agree within 1e-3 and no plain version runs;
   step p50 over the last 8, images/s and peak memory are printed beside
   11's ``Module.fit`` p50 from the same run;
28. gluon_agreement: Gluon ResNet-18 v2 at 3x32x32, batch 4, card
   against CPU from the same numpy weights, one Trainer step,
   imperative and hybridized: outputs within 1e-3 and parameter moves
   within 0.1 relative L2 (ROADMAP C's bound for BatchNorm nets); an
   ``nn.LayerNorm`` block (64 x 1024) forward and backward, eager and
   hybridized, within 3's bound, launching the LayerNorm kernels once
   each on the card;
29. fused_band4d (with the kernel phases of 3): row 10's kernel against
   its plain version (bf16 at 20's bound, f32 at 3's), two runs
   bit-identical, at the fused-sandwich microbenchmark's two bands
   (batch 256, 28 x 28, 128 -> 512 on the channel-last view of cuDNN's
   output and 512 -> 128 on a contiguous tensor) in both types, at 64 x
   56 x 56 (64 -> 256, the TPU kernel's th = 16 rows), on an NHWC view
   of an NCHW tensor, on a channel slice, at an odd shape, at the bf16
   GEMM's edges (BAND4D_EDGES) and in f32 at a ragged M; the f32 form
   (split TF32, fused_gemm_f32.cuh with W (K, N)) bit-equal to row 7's
   f32 kernel on the 2-D view; both GEMMs' ptxas lines as in 20; the
   bands timed as in 3 beside ``torch.matmul`` on the activated input
   and row 7's kernel on the 2-D view, bounded by bytes over 3.35 TB/s
   or operations over the bf16 tensor-core peak (bf16) or the split-TF32
   peak (f32, the CUDA-core bound beside);
30. sandwich (after 26): ``tools/torch_fused_sandwich_bench.py``'s
   three arms (plain: elementwise ops and ``torch.matmul``; pal2d: row
   7's kernel on the 2-D view; pal4d: row 10's kernel) at its shapes, in
   bf16 and then in f32 (TF32 off): pal2d and pal4d outputs bit-equal,
   plain within 1e-2 relative L2; ms per iteration from CUDA graphs of 2
   and 62 iterations (best of 3 replays each); every band launch of the
   captured loops counted (2 per iteration, per type), no plain version;
31. fit_fused (after 22): ``Module.fit`` at full width through the
   single-launch fused step (two warm-up steps, one capture, then one
   graph replay per step) against its eager pair, each for 6 steps
   over two fixed batches, cuDNN's deterministic algorithms in both:
   ResNet-50 v2 at batch 128 through ``mx.kv.create('device')`` dense
   and 2-bit (threshold 0.5; SGD 0.1, momentum 0.9, wd 1e-4, accuracy)
   and the transformer (6 layers of FULL's widths) at 4 x 1024 tokens
   (SGD 0.05, momentum 0.9,
   perplexity).  Each fused arm captures once, runs every step fused,
   makes no host sync in a steady step (``set_sync_debug_mode``
   warnings inside ``fit_step`` and ``update_metric``), launches one
   graph per steady step (``torch.profiler``'s runtime calls over 2
   more steps), records the quantizer once per bucket (2-bit) or the
   LayerNorm and flash kernels (transformer) in its graph, ends with
   weights within 1e-3 relative L2 of the eager arm's move and its
   metric within 1e-5; step p50s, peak memory and the launch counts are
   printed;
32. serve_bf16 (after 19): the LM at full width in bf16
   (``dtype='bfloat16'``: bf16 weights, LayerNorms and caches, f32
   embeddings, logits, block tables, positions and lengths) through
   ``DecodeEngine`` on the mixed step, serve's requests and geometry,
   with SERVE_BF16_RESERVED blocks held off the free list so the block
   ids pass 256: every step's graph records decode and chunk 12 times
   and LayerNorm 50, all bf16, no plain version, with 4's graph checks
   and eager arm; tokens/s, step p50, TTFT p50/max, peak memory;
   LayerNorm's bf16 form is also timed at its 8 and 64 rows in
   layernorm_bf16 (20);
33. serve_prefill_bf16: the bf16 prefill/decode-step pair at full width,
   one 8 x 1024 prefill forward (12 bf16 prefill launches) and 31
   decode steps (12 bf16 decode launches each), the first token's
   logits within relative L2 2e-2 of the bf16 engine's; prefill ms,
   decode step p50, peak memory; eager and donated arms as in 17;
34. serve_spec_bf16: ``spec_k=4`` in bf16, the n-gram arm (24 bf16
   chunk launches a step) and a bf16 draft model (12 bf16 flash
   launches a proposed token, accept rate at least 0.5); eager and
   captured arms as in 18;
35. serve_bf16_agreement: the mixed step, the spec step and the
   prefill/decode-step pair at 2 layers in bf16, card against CPU, each
   driven with the card engine's greedy tokens forced on both devices:
   logits rows within relative L2 2e-2, cache rows within one bf16 ulp
   at the cache's scale; the card's greedy streams printed beside, and
   whether the CPU's argmax at each forced position gives the same
   tokens;
36. fit_bf16 (after 31): bf16 ``Module.fit`` at full width under
   multi_precision (f32 masters), fused against eager as in 31 (6
   steps over two fixed batches): the transformer with
   ``dtype='bfloat16'`` at 4 x 1024 tokens (SGD 0.05, momentum 0.9;
   its graph records each bf16 flash kernel 12 times and the bf16
   LayerNorm forward and backward 25 times) and ResNet-50 v2 in bf16 at
   batch 128 through ``mx.kv.create('device')`` with 2-bit compression
   (threshold 0.5; its graph records the f32 quantizer once per bucket
   the eager store dispatches).  Each fused arm captures once, runs
   every step fused with no host sync and one graph launch in a steady
   step and no plain version, keeps its loss scaler at 2^15 with no skip
   (published by ``_fit_sync``); every bf16 weight matrix's f32 master
   moves in both arms; fused weights within one bf16 ulp (rtol and atol
   1e-2) of eager's.  The fused transformer graph is replayed 20 times
   under CUDA events with the scaler and again with
   ``MXNET_LOSS_SCALE=off`` (the device ms of the finiteness check and
   select).  The overflow case: a bf16 MLP through a 2-bit store, one
   batch holding an inf after the capture: that step is a replay with no
   host sync, weights, stored weights, masters, momenta and residuals
   stay bit for bit, the scale halves with one skip, and the next finite
   step moves the weights.  Step p50, tokens/s or images/s and peak
   memory per arm.

37. checkpoint (after 36): ``mx.checkpoint`` through the fused bf16
   ``Module.fit`` (ROADMAP A.7), in a temporary directory removed at
   the end.  ResNet-50 v2 in bf16 at batch 128 through a 2-bit device
   store (SGD 0.1, momentum 0.9, wd 1e-4, multi_precision) and the
   transformer LM at full width cut to 2 layers in bf16 at 4 x 1024
   tokens (SGD 0.05, momentum 0.9): run A takes 8 steps with
   ``checkpoint_every`` (2 for ResNet-50, 4 for the LM), run B is a
   fresh Module restored from tag 4 by ``checkpoint.restore`` that
   takes steps 5-8 (two warm-up steps, the capture, a replay); weights,
   f32 masters, momenta, 2-bit residuals and the loss scaler's triple
   end bit-equal to run A's, each module captures once, each graph
   records its kernels (the quantizer; bf16 flash and LayerNorm), and a
   steady step syncs the host only when it checkpoints.  Printed:
   each save's snapshot block ms (the training thread's wait), save ms,
   bytes and MB/s, the restore ms, and a capture into pinned and into
   pageable host memory.  Then ``DecodeEngine(dtype='bfloat16')
   .reload(prefix)`` serves 8 requests (a second reload while they run)
   with streams equal to an engine given the same weights by
   ``swap_params``, the paged decode, chunk and LayerNorm kernels
   launched; and an f32 ResNet-50's ``model.save_checkpoint`` read back
   by ``Module.load`` on the card gives a forward bit-equal to the saved
   module's.
38. float16 serving's kernels (ROADMAP A.1, float16; with the kernel
   phases of 3): the f16 forms of rows 1, 2 and 5 inside 3's decode,
   chunk and prefill phases (f16 q/k/v over f16 caches at the same
   shapes, cases and head_dims as the bf16 forms, outputs within
   close_f16: rtol 2^-10, one f16 ulp of the value, atol 1e-5; cache
   bytes exact, the bytes each must leave alone included; timed beside
   SDPA in f16, bounded at the dense 16-bit tensor-core peak); then
   layernorm_f16 (row 3's f16 form at the rows of every f16 path and
   LN_FWD_EDGES, timed at serve's 8 and 64 rows beside F.layer_norm in
   f16), flash_f16 (row 8's f16 forward at the draft model's (1, 16,
   1024, 128) and FLASH_F16_EDGES within close_f16_flash, timed beside
   SDPA's f16 forward; since float16 training also its dK/dV and dQ, 41)
   and dtype_codes (every C entry point returns an error for a code or
   pairing it has no kernel for, f16 beside another type included;
   since 45 codes 0, 1 and 2 run rows 7 and 10 and the wrappers refuse
   a mixed 16-bit pair there, row 6's f16 as f32 by design); each
   kernel's f16 instances' ptxas lines first, no spills;
39. serve_f16, serve_prefill_f16, serve_spec_f16 (after 35): 32, 33
   and 34 with ``dtype='float16'``: the engine's cache holds
   SERVE_F16_BLOCKS blocks with the first SERVE_F16_RESERVED off the
   free list, so every block id passes 2048 (f16 holds integers exactly
   only to 2048; the port keeps index inputs f32); every recorded count
   is of f16 instances, one graph launch a steady step; every step's
   logits finite (f16 overflows past 65504: an engine collecting every
   step's logits on the same prompts and geometry, the pair's every
   step, the spec phase's reference engine); the draft arm's accept rate
   at least 0.5;
40. serve_f16_agreement: 35 in f16 (logits at relative L2 2.5e-3, cache
   rows within one f16 ulp), under PyTorch's default
   ``allow_fp16_reduced_precision_reduction``; the CPU's greedy tokens
   under forcing equal the card's on every arm (so the two devices'
   greedy streams are equal).
41. float16 training's kernels (ROADMAP A.1, float16 training; with the
   kernel phases of 3): layernorm_bwd_f16 (row 4's f16 form at 4096 x
   2048 and LN_BWD_EDGES, with and without a residual, two runs
   bit-identical: dx at rtol 2^-10 / atol 1e-5, dgamma and dbeta at
   rtol 2^-10 / atol 2e-4; timed beside native_layer_norm_backward in
   f16) and flash_f16's backward (dK/dV and dQ in f16 at (4, 16, 1024,
   128) and FLASH_BF16_EDGES within close_f16_flash, two runs
   bit-identical, FlashAttentionFn against autograd through the
   reference at relative L2 FLASH_F16_FN_L2, the overflow case
   FLASH_F16_OVERFLOW non-finite exactly where the plain version is;
   timed beside SDPA's f16 autograd backward); the f16 instances'
   ptxas lines first, no spills;
42. train_f16 (after 22): 22 with ``dtype='float16'``: every step
   launches the f16 flash kernels 12 times and the f16 LayerNorm
   forward and backward 25 times, no plain version, the loss finite,
   every f16 weight matrix's f32 master moves;
43. fit_f16 (after 36): float16 ``Module.fit`` of the full-width
   transformer as FIT_F16 says: a fused arm (the module's loss scaler;
   one capture, every step fused, no host sync and one graph launch in
   a steady step, no plain version, the f16 kernels recorded 12 and 25
   times in its graph; its scale and skips printed, at least one update
   applied), an eager arm and a fused arm with ``MXNET_LOSS_SCALE=off``
   held against the eager one (f16 weights within one f16 ulp); every
   f16 weight matrix's master moves and every weight stays finite in
   all three; graph replay ms and tokens/s beside fit_bf16's; 10's
   kvstore phase also runs f16 values (dense and 2-bit, bucketed and
   eager on the card against the CPU: residuals bit-identical, masters
   within KV's bound, weights within one f16 ulp);
44. f16_train_agreement (after 24): a 2-layer transformer in f16 (seq
   256, d_model 256) through TrainStep, card against CPU: outputs and the masters' moves
   within F16_TRAIN_AGREE's relative L2 bounds, f16 weights within one
   f16 ulp at each array's scale.
45. float16 for rows 7 and 10 (ROADMAP A.1; with the kernel phases of
   3): fused_matmul_f16 (row 7's f16 form, the f16 instances of the
   16-bit GEMM template fused_gemm_bf16.cuh, at the 28 sites' 8 shapes
   at batch 256, FUSED_ODD and FUSED_BF16_EDGES, and the overflow and
   NaN cases of _f16_special with and without a residual, within
   close_f16_fused, two runs bit-identical; timed beside its bf16 twin
   on the same values and torch.addmm / torch.matmul in f16) and the
   fused_band4d phase's f16 form (the sandwich's bands in f16, the th =
   16, odd and edge shapes, the NHWC view, the channel slice and the
   special case as a band, bit-equal to row 7 on the 2-D view); the f16
   instances' ptxas lines first, no spills; the sandwich phase also runs
   in f16 (pal2d and pal4d bit-equal, 2 band launches an iteration);
46. train_resnet_f16 (after train_resnet_bf16): bench.py's NHWC
   ResNet-50 v2 at batch 256 with ``dtype='float16'``, unfused and
   fused (exactly 28 f16 launches of row 7 a step in the fused arm,
   none unfused, no plain version; the loss finite and falling; each
   step's non-finite gradient elements and largest |gradient|; TrainStep
   has no loss scaler in either package);
47. fit_f16's ResNet arm (``_fit_resnet16``): fit_bf16's ResNet-50 v2
   through a 2-bit device store in f16, fused against eager: one
   capture, one graph launch and no host sync a steady step, the f32
   quantizer recorded once per bucket, no skip, fused weights within
   one f16 ulp of eager's, graph replay ms;
48. gluon_resnet's f16 arms: imperative and hybridized model-zoo
   ResNet-50 v2 cast to f16 before ``initialize``, a multi-precision
   Trainer (every weight matrix's f32 master rounds to its weight);
49. resnet_f16_agreement: card against CPU at RESNET_F16_AGREE's sizes
   (the fused NHWC ResNet-50 through TrainStep, the CIFAR ResNet-8
   through Module.fit with a 2-bit device store, resnet18_v1 through
   Gluon imperative and hybridized), each tensor within twice the CPU's
   own f16-to-f32 gap (F16Gap, tests/test_torch_resnet_f16.py's check);
50. dropout (the LM trained as its users train it, ROADMAP A.5's first
   half; with the kernel phases): Dropout's draw on CUDA tensors at the
   LM's (8, 1024, 2048) bf16 activations, bit for bit the CPU's draw
   from the same step seed, its keep share within 5 sigma of 1 - p and
   its values 0 or the reference's 1/(1 - p) rounded to the type, the
   axes broadcast; the apply against its plain version on the CPU (bit
   for bit); a captured graph of the op replayed with two staged seeds
   draws two different masks, each the eager draw of its seed; draw and
   apply timed; and the kernels at this slice's new shapes against their
   plain versions: bf16 flash at (8, 16, 1024, 128), bf16 LayerNorm
   forward and backward at 8192 x 2048;
51. fit_lm_dropout (after 43): the LM at full width with dropout 0.1 in
   bf16 with f32 masters through ``Module.fit``'s fused step: LAMB (wd
   0.01, bias correction) under WarmupScheduler(CosineScheduler),
   perplexity and top-5 accuracy, ``log_train_metric(1)``; batches of 8,
   then a batch of 4 (re-binds, captures a second graph), then 8 again
   (replays the first, no capture): two captures, every step fused,
   rows 3, 4 and 8 launched in bf16 and recorded in both graphs, no
   plain version, finite weights; two later replays' staged seeds differ
   and their masks (the embedding's, recomputed from the seeds) differ,
   each keep share in bounds; step p50, tokens/s, peak GB, the batch-8
   graph's replay ms; then ``TrainStep`` over the LM at 6 layers with
   dropout and Nadam (its fused kind, extras staged each step);
52. fused_kinds: LBSGD, Adamax, Nadam and LAMB, each kind's update
   captured as a CUDA graph (its per-step scalars staged before each
   replay) against the optimizer's eager updates over random weights
   and gradients, 3 steps; then LBSGD, Nadam and LAMB each through
   ``Module.fit`` on the LM at full width cut to 2 layers (f32, dropout
   0.1, 2 x 1024 tokens, 6 steps), the captured graph against the eager
   pair from the same seeds: weights (and states) within FUSED_KINDS's
   move_l2.
53. causal_attention (the rest of the training surface, ROADMAP A.5's
   second half; with the kernel phases): ``_contrib_CausalSelfAttention``
   at (8, 1024, 3 x 2048), 16 heads, in f32, bf16 and f16: the op through
   ``mx.nd`` under autograd launches row 8's forward, dK/dV and dQ once
   each in its type (no plain version); the kernels on its views against
   their plain versions (each row's bound); the op end to end against
   autograd through the plain attention (f32 rtol 1e-4 / atol 1e-5,
   16-bit CAUSAL's relative L2); its times beside SDPA's; then Module.fit
   of FullyConnected -> op -> FullyConnected (fused, one capture, row 8
   recorded once each), card against CPU within CAUSAL's fit_l2 of each
   weight's move;
54. deconv_leaky (with the kernel phases): Deconvolution at the DCGAN
   generator's four shapes at batch 128 and every LeakyReLU act on
   (128, 256, 32, 32), f32 and bf16, forward and backward, card against
   CPU; times; rrelu's slopes card against CPU bit for bit from one
   seed, and two replays of a captured graph drawing two sets;
55. fit_lm_mirror (after 51): MXNET_BACKWARD_DO_MIRROR=1 on the LM at
   full width in bf16 with dropout through Module.fit's fused step,
   against the same run without it: one graph each, the mirrored graph
   recording rows 3 and 8's forwards twice (LayerNorm forward 50, flash
   forward 24 a step), weights after the same steps equal (or the
   largest difference printed), step p50, replay ms and peak memory of
   both; ResNet-50's moving statistics after mirrored Module.fit steps
   equal the unmirrored ones;
56. harness (last): example/torch's train_mnist (mlp, lenet; synthetic
   digits, one epoch), train_imagenet --benchmark 1 (ResNet-50 at 224,
   batch 64, 10 batches, NCHW f32 and NHWC bf16) and dcgan, each in a
   process of its own: exit 0, finite final metrics, the Speedometer's
   samples/s printed beside the card's name.

Then the kernels' JSON line (every kernel with its dtype; the bf16 and
f16 forms as rows of their own, the serving kernels' bf16 and f16
instances with their serve phases' launches, row 8's f16 forward with
the f16 draft arm's, row 4 and row 8's backward in f16 with fit_f16's
fused arm's, row 7 in f16 with train_resnet_f16's fused arm's, row 10's
three forms with the sandwich's, the attention kernels with their
head_dim-256 times; row 8's rows with causal_attention's launches and
the bf16 rows of rows 3, 4 and 8 with fit_lm_mirror's), and
last ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no
result; it also exits non-zero when no CUDA device is present.
TF32 is off for every matrix product and convolution.
"""
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
F64_FLOPS_PER_S = 34e12            # H100 SXM f64 outside the tensor cores
# the f32 attention kernels (flash, prefill) run split TF32 on the tensor
# cores: three dense TF32 products (494.7 TFLOP/s, H100 SXM data sheet)
# per f32-accurate product bound them; the CUDA-core bound is printed
# beside it
TF32_FLOPS_PER_S = 494.7e12
SPLIT_TF32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
SEED = 20261016
FULL = dict(num_classes=16384, num_layers=12, d_model=2048, num_heads=16,
            ffn_dim=8192, seq_len=1024)
GEOMETRY = dict(capacity=8, block_size=16, num_blocks=512, chunk_tokens=64)
RTOL, ATOL = 1e-4, 1e-5
TRAIN = dict(batch=4, lr=0.05, momentum=0.9, batches=2, epochs=5, warmup=2)
AGREE = dict(num_layers=2, seq_len=256, batch=2, rtol=1e-3)
# kernel launches of one training step of the full-width model
TRAIN_LAUNCHES = {"layernorm_fused": 25, "layernorm_fused_bwd": 25,
                  "flash_attention_fwd": 12, "flash_attention_bwd_dkv": 12,
                  "flash_attention_bwd_dq": 12}
# the 2-bit quantizer: lengths checked bit for bit (0 to a 4 MiB bucket,
# ResNet-50's largest array, an odd length) and the two timed
QUANT = dict(lengths=(0, 1, 7, 1048576, 2359296, 1000003),
             timed=(1048576, 2359296), thresholds=(0.5, 0.1))
# card store against CPU store: tests/test_kvstore_fused.py's shapes plus
# one key above the 4 MiB bucket cap
KV = dict(shapes=[(64, 32), (128,), (3, 3, 8, 8), (500, 10), (7,),
                  (1100, 1000)], streams=3, steps=4, threshold=0.1,
          sgd=dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
                   rescale_grad=0.5), rtol=5e-7, atol=5e-7)
# ResNet-50 v2 through Module.fit: common/fit.py's batch and the repo's
# compressed-training configuration (bench.py bench_checkpoint)
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))
RESNET_TRAIN = dict(batch=128, lr=0.05, momentum=0.9, wd=1e-4, batches=2,
                    epochs=5, warmup=2, threshold=0.5)
RESNET_AGREE = dict(num_classes=10, num_layers=18, image_shape=(3, 64, 64),
                    batch=4, loss_rtol=1e-3, grad_rtol=1e-3, aux_rtol=1e-4,
                    band=1e-4, band_share=1e-4)
# bench.py's channel-last ResNet-50 through TrainStep (f32, train_resnet's
# batch); the fused arm has 28 BN -> ReLU -> Conv1x1 sites
NHWC_TRAIN = dict(batch=128, lr=0.05, momentum=0.9, wd=1e-4, batches=2,
                  steps=10, warmup=2, sites=28, loss_rtol=1e-3)
NHWC_AGREE = dict(num_classes=10, num_layers=50, image_shape=(3, 64, 64),
                  batch=4, loss_rtol=1e-3, prob_atol=1e-4, aux_rtol=1e-4,
                  grad_l2=0.1, perturb=2.0 ** -22, site=(16384, 64, 256),
                  site_rtol=1e-4)
# (M, K, N, residual): site count, for ResNet-50's fused sites at batch 128
FUSED_SHAPES = {(401408, 256, 64, False): 2, (401408, 64, 256, True): 3,
                (100352, 512, 128, False): 3, (100352, 128, 512, True): 4,
                (25088, 1024, 256, False): 5, (25088, 256, 1024, True): 6,
                (6272, 2048, 512, False): 2, (6272, 512, 2048, True): 3}
FUSED_ODD = (1000, 37, 93, True)
# the bf16 fused kernels (tensor cores, fused_gemm_bf16.cuh) at the edges
# of their tiling: M not a multiple of the 128-row tile, K a multiple of 8
# but not of the 32-column K step, N = 64 and N not a multiple of 8, and
# x a contiguous view whose data pointer is 2 bytes off 16-byte
# alignment; (M, K, N, residual, x's element offset)
FUSED_BF16_EDGES = ((12544 + 37, 512, 2048, True, 0),
                    (12544 + 37, 2048, 512, False, 0),
                    (1000, 72, 64, False, 0), (1000, 72, 36, True, 0),
                    (4096, 256, 128, True, 1))
# the bf16 GEMM's tile widths (128 rows each); each is instantiated with
# X staged by cp.async and element by element (_fused_gemm_ptxas)
FUSED_GEMM_TILES = (128, 64)
# the C entry points' dtype codes (kernels/dispatch.py DTYPE_CODE)
DTYPE_CODES = (("float32", 0), ("bfloat16", 1), ("float16", 2))
# row 7's f16 overflow and NaN cases (_f16_special), (M, K, N): the
# vector path, each with and without a residual
F16_SPECIAL = (4096, 256, 128)
# bf16: the dense tensor-core peak bounds the bf16 forms (NVIDIA data
# sheet, H100 SXM); a bf16 kernel is held against its plain version at
# one bf16 ulp of the value plus 2^-9 of the array's largest magnitude
BF16_FLOPS_PER_S = 989e12
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -9
# the bf16 flash kernels (tensor cores) at the edges of their tiling:
# 64-row blocks and 32-row dK/dV steps (S 17 and 1000), 16-column mma
# steps and element-by-element copies (D 80 and 36, the latter not a
# multiple of 8), batch 1, and the 128-column head_dim chunks (256 and
# 512 at d_model 2048); (B, H, S, D)
FLASH_BF16_EDGES = ((2, 4, 17, 128), (2, 4, 1000, 128), (2, 4, 1024, 80),
                    (2, 4, 1000, 36), (1, 16, 1024, 128), (4, 8, 1024, 256),
                    (4, 4, 1024, 512))
# the 16-bit flash kernels' entry functions in csrc/flash_attention.cu
# (templates over the element type: the mangled name up to the kFull
# argument, Lb1 or Lb0, which follows) at bf16 and f16, and their
# numbers in mx_flash_bf16_smem
FLASH_16_ENTRIES = {dt: {"flash_attention_fwd": ("flash_fwd16_kernelI" + t, 0),
                         "flash_attention_bwd_dkv":
                         ("flash_bwd_dkv16_kernelI" + t, 1),
                         "flash_attention_bwd_dq":
                         ("flash_bwd_dq16_kernelI" + t, 2)}
                    for dt, t in (("bfloat16", "13__nv_bfloat16"),
                                  ("float16", "6__half"))}
# bench.py's transformer train mode in bf16 (its learning rate and
# 1/(B*S) rescale) and its flagship, ResNet-50 NHWC bf16 at batch 256
TRAIN_BF16 = dict(batch=4, lr=0.01, momentum=0.9, steps=10, warmup=2)
RESNET_BF16 = dict(batch=256, lr=0.1, momentum=0.9, wd=1e-4, steps=10,
                   warmup=2, sites=28)
# LayerNorm backward beside the training shape, (rows, cols): one warp a
# row (f32 256, bf16 512), two and four (a ragged row end), a width off
# the 16-byte vector (element by element), eight warps in bf16 and the
# looped form in f32 (4096), the looped form in both (6000) and the
# widest row the wrapper takes
LN_BWD_EDGES = ((256, 256), (256, 512), (128, 1000), (64, 2046), (64, 4096),
                (64, 6000), (64, 14528))
# LayerNorm forward beside the served and training shapes, (rows, cols):
# one to four warps a row, a width off the 16-byte vector, the looped
# form past 2048 f32 (4096 bf16) columns, the widest row the wrapper took
# with a shared-memory row buffer (58112), tiny rows
LN_FWD_EDGES = ((256, 256), (256, 512), (128, 1000), (64, 2046), (64, 4096),
                (64, 6000), (16, 14528), (4, 58112), (5, 100), (3, 1))
# the forward's instances in csrc/layernorm.cu's ptxas log
LN_FWD_PATTERN = r"layernorm_fwd_\w+?_kernelI\w+?E(?=Ev)"
# bf16 serving (ROADMAP A.1): the full-width model with dtype='bfloat16'
# (bf16 weights, LayerNorms and caches; f32 embeddings, logits, block
# tables, positions and lengths)
BF16_SERVE = dict(FULL, dtype="bfloat16")
# the bf16 instances of the prefills at head_dims past the served 128
# (d_model 2048) and ragged ones (72: a ragged 128-column chunk with
# 16-byte copies; 36: element by element)
PAGED_BF16_DIMS = (256, 512, 72, 36)
# blocks serve_bf16 takes off the cache's free list before its traffic,
# so the requests' block ids pass 256 (bf16 holds integers exactly only
# to 256; the port keeps block tables f32)
SERVE_BF16_RESERVED = 280
# card against CPU in bf16 (2 layers): logits under teacher forcing at
# relative L2 2e-2 (phase_bf16_agreement's bound), caches within one
# bf16 ulp at each cache's scale (_ulps)
BF16_AGREE = dict(num_layers=2, new=8, logits_l2=2e-2, cache_ulps=1)
# float16 serving (ROADMAP A.1, float16): the full-width model with
# dtype='float16' (f16 weights, LayerNorms and caches; f32 embeddings,
# logits, block tables, positions and lengths)
F16_SERVE = dict(FULL, dtype="float16")
# an f16 kernel against its plain version: one f16 ulp of the value
# (2^-10 relative) plus atol 1e-5, each side rounding an f32 result to
# f16 once (rows 1, 2, 3, 5); row 8's forward rounds P to one f16 term
# relative to its running max where the plain version rounds the
# normalised P (2^-11 each), which moves a sum by a fraction of the
# array's scale: also 2^-12 of the array's largest magnitude (bf16's
# close_bf16, 2^-7 and 2^-9, scaled by f16's 3 more significand bits)
F16_RTOL, F16_FLASH_ATOL_SHARE = 2.0 ** -10, 2.0 ** -12
# row 8's f16 forward beside the draft model's (1, 16, 1024, 128): a
# ragged S, D off the 16-byte copies, head_dim 256; (B, H, S, D)
FLASH_F16_EDGES = ((2, 4, 17, 128), (2, 4, 1000, 36), (2, 8, 1024, 256))
# row 8's f16 backward (float16 training, ROADMAP A.1): FlashAttentionFn
# against autograd through the materialised reference at relative L2
# bf16's 1e-2 over f16's 3 more bits; the overflow case, (B, H, S, D)
# with V scaled by v_scale and dO's `rows` by do_scale (clamped inside
# f16's range), so that dS passes 65504 on those rows' keys
FLASH_F16_FN_L2 = 1e-2 / 8
# the shapes row 8's f16 forms are timed at: the forward at the f16
# draft model's spans, dK/dV and dQ at the f16 training step's
FLASH_F16_SHAPES = dict(draft=(1, 16, 1024, 128), train=(4, 16, 1024, 128))
FLASH_F16_OVERFLOW = dict(shape=(1, 2, 256, 64), v_scale=64.0,
                          do_scale=20000.0, rows=(2, 7, 60, 200))
# serve_f16's cache: SERVE_F16_BLOCKS blocks, of which the first
# SERVE_F16_RESERVED are taken off the free list before its traffic, so
# every block id the requests get passes 2048 (f16 holds integers
# exactly only to 2048; the port keeps block tables f32)
SERVE_F16_BLOCKS, SERVE_F16_RESERVED = 2304, 2048
# card against CPU in f16 (2 layers): logits under teacher forcing at
# relative L2 2.5e-3 (tests/test_torch_serve_f16.py's bound: bf16's 2e-2
# over f16's 3 more bits), caches within one f16 ulp at each cache's
# scale (_ulps with 10 fraction bits)
F16_AGREE = dict(num_layers=2, new=8, logits_l2=2.5e-3, cache_ulps=1)
# the attention kernels at head_dims past 128, d_model kept at 2048
HEAD_DIM = dict(dims=(256, 512), d_model=2048,
                decode_ragged=((72, "float32"), (30, "float32"),
                               (36, "bfloat16")))
# the f32 flash kernels (split TF32, attention_f32.cuh) beside the
# training shape: a ragged S with D % 4 == 0 (16-byte copies) and a
# D % 4 != 0 shape (element-by-element copies); (B, H, S, D)
FLASH_F32_EDGES = ((2, 4, 1000, 36), (1, 2, 200, 30))
# their entry functions in csrc/flash_attention.cu and their numbers in
# mx_flash_f32_smem
FLASH_F32_ENTRIES = {
    "flash_attention_fwd": ("flash_fwd_f32_kernel", 0),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_f32_kernel", 1),
    "flash_attention_bwd_dq": ("flash_bwd_dq_f32_kernel", 2)}


# mx.rtc: MXNet's own rtc example (axpy) on 2^26 f32, a row sum with
# dynamic shared memory over an (8192, 4096) f32 matrix, and a template
# axpy<double> on 2^20 doubles through ``exports`` (compiled without FMA
# contraction, so it equals the plain version exactly)
RTC = dict(n=1 << 26, rows=8192, cols=4096, n_double=1 << 20, alpha=2.5,
           block=256, grid=132 * 8, rtol=1e-4, atol=1e-5, launch_reps=200)
RTC_AXPY = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    y[i] += alpha * x[i];
}
"""
RTC_ROW_SUM = r"""
extern "C" __global__ void row_sum(const float *x, float *out, int cols) {
  extern __shared__ float partial[];
  const float *row = x + (long long)blockIdx.x * cols;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) acc += row[j];
  partial[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) partial[threadIdx.x] += partial[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = partial[0];
}
"""
RTC_AXPY_T = r"""
template <typename T>
__global__ void axpy(const T *x, T *y, T alpha, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    y[i] += alpha * x[i];
}
"""
# Gluon: model-zoo ResNet-50 v2 trained at full width (f32, NCHW,
# 3x224x224, batch 128; SGD 0.1, momentum 0.9, wd 1e-4 through
# kvstore='device') over two fixed batches, and ResNet-18 v2 card
# against CPU (outputs at 1e-3 relative L2, parameter moves at the 0.1
# of ROADMAP C for BatchNorm nets)
GLUON = dict(classes=1000, image=(3, 224, 224), batch=128, batches=2,
             steps=10, warmup=2, lr=0.1, momentum=0.9, wd=1e-4,
             threshold=0.5, loss_rtol=1e-3, loss_rtol_f16=1e-3)
GLUON_AGREE = dict(classes=10, image=(3, 32, 32), batch=4, out_l2=1e-3,
                   move_l2=0.1, ln_shape=(64, 1024))


# row 10, fused_band4d, beside the sandwich's two bands (bf16): a shape
# whose rows pick the TPU kernel's th = 16 band, an f32 shape, and an
# odd shape that takes the kernel's element-by-element paths
BAND4D = dict(th_shape=(64, 56, 56, 64, 256), f32_shape=(64, 28, 28, 128, 512),
              odd_shape=(3, 7, 9, 37, 93))
# and the bf16 kernel's tiling edges: M = 53824 not a multiple of the
# 128-row tile, K 72 (not a multiple of the K step) with N 64, and N 60
# (not a multiple of 8: W and Y element by element)
BAND4D_EDGES = dict(ragged_m=(64, 29, 29, 64, 256), k72_n64=(3, 13, 17, 72, 64),
                    n60=(2, 9, 11, 64, 60))
# the sandwich's arms agree: pal2d and pal4d run one tiling and one sum
# order (bit-equal); the plain arm's cuBLAS bf16 product rounds its f32
# sums once more per band (relative L2 bound)
SANDWICH = dict(plain_l2=1e-2)
# Module.fit fused against eager at full width, 6 steps each over two
# fixed batches (3 steady steps after the two warm-up steps and the
# capture, 2 profiled after them): ResNet-50 v2 at batch 128 through
# kvstore='device',
# dense and 2-bit at 0.5, SGD 0.1 / 0.9 / wd 1e-4, metric acc; the
# transformer at 4 x 1024 tokens, SGD 0.05 / 0.9, metric perplexity, its
# depth cut to 6 layers for time (widths those of FULL).
# Both arms run cuDNN's deterministic algorithms, so the fused and
# eager steps compute the same sums and their weights are compared at
# move_l2 (the difference over the eager arm's move, relative L2).
FIT_FUSED = dict(resnet=dict(batch=128, lr=0.1, momentum=0.9, wd=1e-4,
                             threshold=0.5, batches=2, epochs=3),
                 transformer=dict(batch=4, lr=0.05, momentum=0.9, batches=2,
                                  epochs=3, num_layers=6),
                 move_l2=1e-3, profiled_steps=2)


# bf16 Module.fit (fit_bf16): the transformer with dtype='bfloat16' at
# 4 x 1024 tokens, and ResNet-50 v2 in bf16 at batch 128 through
# kvstore='device' with 2-bit compression at 0.5, both SGD momentum 0.9
# with multi_precision (f32 masters), fused against eager, 6 steps each
# over two fixed batches; fused weights within one bf16 ulp (rtol and
# atol weights_tol) of eager's, metrics within weights_tol; the
# transformer once more fused with MXNET_LOSS_SCALE=off, and each fused
# transformer graph replayed `replays` times under CUDA events (the
# device ms of the scaler's finiteness check and select); the overflow
# case, a bf16 MLP through a 2-bit store with one batch holding an inf.
FIT_BF16 = dict(transformer=dict(batch=4, lr=0.05, momentum=0.9, batches=2,
                                 epochs=3),
                resnet=dict(batch=128, lr=0.1, momentum=0.9, wd=1e-4,
                            threshold=0.5, batches=2, epochs=3),
                weights_tol=1e-2, replays=20,
                overflow=dict(batch=64, features=256, hidden=512,
                              classes=16, threshold=0.05, lr=0.05))


# float16 Module.fit (fit_f16, ROADMAP A.1's float16 training): the
# transformer with dtype='float16' at FIT_BF16's transformer settings
# (4 x 1024 tokens, SGD 0.05 / 0.9 with multi_precision, 6 steps over two
# fixed batches) in three arms: fused with the module's loss scaler (the
# main path; the reference's dynamic scaler, 2^15, is the overflow
# check's bookkeeping and scales no gradient), eager (no scaler, as in
# the reference), and fused with MXNET_LOSS_SCALE=off, held against the
# eager arm: f16 weights within one f16 ulp of the value (rtol 2^-10,
# atol 2^-24, the smallest subnormal), the masters' moves within
# FIT_FUSED's move_l2
FIT_F16 = dict(weights_rtol=2.0 ** -10, weights_atol=2.0 ** -24)
# float16 ResNet training card against CPU (resnet_f16_agreement): the
# fused NHWC ResNet-50 through TrainStep at 32x32, batch 2, one step; the
# CIFAR ResNet-8 through Module.fit with a 2-bit device store, 2 steps;
# the model zoo's resnet18_v1 through Gluon at 64x64, batch 4, one step;
# each held by F16Gap (tests/test_torch_resnet_f16.py's check, the CPU's
# f16-to-f32 gap in place of the JAX package's)
RESNET_F16_AGREE = dict(
    trainstep=dict(net=dict(num_classes=4, num_layers=50,
                            image_shape=(3, 32, 32)), batch=2, lr=0.05),
    fit=dict(net=dict(num_classes=10, num_layers=8, image_shape=(3, 28, 28)),
             batch=4, lr=0.05, threshold=0.05),
    gluon=dict(classes=10, image=(3, 64, 64), batch=4, lr=0.05),
    gap_factor=2.0, rel_floor=2.0 ** -9, abs_floor=2.0 ** -8)
# f16 TrainStep card against CPU (f16_train_agreement): a 2-layer
# transformer in f16 at seq 256, batch 2 (bf16_agreement's at half its
# widths: the CPU's f16 products are slow, 40 s at bf16_agreement's),
# 2 steps; outputs and the f32 masters' moves within bf16's bounds (3e-2,
# 5e-2) over f16's 3 more significand bits, f16 weights within one f16
# ulp at each array's scale
F16_TRAIN_AGREE = dict(config=dict(num_classes=2048, num_layers=2,
                                   d_model=256, num_heads=4, ffn_dim=1024,
                                   seq_len=256),
                       out_l2=3e-2 / 8, master_l2=5e-2 / 8, steps=2)


# Dropout (phase dropout): the draw and apply at the bf16 LM's activation
# of one site, (8, 1024, 2048), p 0.1; keep share within `sigmas` binomial
# standard deviations
DROPOUT = dict(shape=(8, 1024, 2048), p=0.1, sigmas=5.0)
# the LM trained as its users train it (fit_lm_dropout): FULL with
# dropout 0.1 in bf16 with f32 masters, LAMB (wd 0.01, bias correction)
# under WarmupScheduler(CosineScheduler(max_update = the steps), 2 warm-up
# steps), batches of `pattern` sequences (8, then 4: a re-bind and a
# second graph, then 8: the first graph again); TrainStep at 6 layers
# with Nadam over `trainstep`'s steps
FIT_DROPOUT = dict(dropout=0.1, pattern=(8,) * 5 + (4,) * 3 + (8,) * 3,
                   lr=1e-3, wd=0.01, warmup=2, replays=10,
                   trainstep=dict(num_layers=6, batch=8, steps=4, lr=1e-3,
                                  wd=0.01))
# the new fused kinds on the card (fused_kinds): each kind's bulk update
# captured as a CUDA graph against its optimizer's eager updates over
# `bulk_shapes` (random weights and gradients, `bulk_steps` steps); then
# Module.fit, graph against eager, on the LM cut to 2 layers in f32 with
# dropout, 2 x 1024 tokens, 6 steps, for the kinds in `fit_kinds`
# (Adamax's first step divides 0 by 0 where a weight's gradient plus its
# decay is exactly 0, as the reference's formula does; at the LM's sizes
# a few elements a layer do, and the weights turn NaN in both arms)
FUSED_KINDS = dict(kinds=("lbsgd", "adamax", "nadam", "lamb"),
                   fit_kinds=("lbsgd", "nadam", "lamb"), num_layers=2,
                   batch=2, steps=6, lr=1e-3, wd=0.01, move_l2=1e-3,
                   bulk_shapes=((2048, 2048), (8192, 2048), (2048,),
                                (16384, 64)), bulk_steps=3)

# gradient mirroring (fit_lm_mirror): FULL in bf16 with f32 masters and
# dropout 0.1 through Module.fit's fused step, SGD with momentum, `steps`
# batches of `batch` x 1024 tokens, once without and once with
# MXNET_BACKWARD_DO_MIRROR=1 from the same weights, batches and seed;
# `replays` more replays of each graph timed; then one Module.fit step
# of ResNet-50 (224 x 224, batch `resnet_batch`, f32) each way, whose
# BatchNorm moving statistics must be equal (after a second step they
# would also carry the first step's weight updates, whose convolution
# weight gradients cuDNN may sum in another order from run to run)
FIT_MIRROR = dict(dropout=0.1, batch=8, steps=5, lr=0.01, momentum=0.9,
                  replays=5, resnet_batch=32, resnet_steps=1, lr_resnet=0.01)
# CausalSelfAttention (causal_attention): (batch, seq, 3 * d_model) at
# the LM's width and heads, in f32, bf16 and f16, forward and backward;
# the op end to end against autograd through the plain attention within
# close (f32) or relative L2 `l2` (16-bit: the op's backward rounds P and
# dS where autograd does not); then `fit_steps` Module.fit steps of
# FullyConnected -> op -> FullyConnected at the same width cut to
# `fit_seq` tokens and `fit_batch` sequences, card against CPU, each
# weight's difference within `fit_l2` of its move (relative L2)
CAUSAL = dict(batch=8, seq=1024, d_model=2048, heads=16,
              l2={"bfloat16": 1e-2, "float16": 1e-2 / 8}, fit_batch=1,
              fit_seq=256, fit_steps=3, classes=16, fit_lr=0.05,
              fit_l2=1e-3)
# Deconvolution and LeakyReLU (deconv_leaky): the DCGAN generator's
# transposed convolutions (Radford et al. 2016: 4x4x1024 -> 8x8x512 ->
# 16x16x256 -> 32x32x128 -> 64x64x3, kernel 4, stride 2, pad 1, no bias)
# at batch 128; every LeakyReLU act on a (128, 256, 32, 32) tensor; f32
# and bf16, card against CPU on the first `cpu_batch` samples (each
# sample's output and input gradient depend on that sample only; the
# weight and gamma gradients are summed over the same samples on both)
DECONV = dict(batch=128, channels=(1024, 512, 256, 128, 3), size=4,
              kernel=(4, 4), stride=(2, 2), pad=(1, 1), cpu_batch=8,
              leaky_shape=(128, 256, 32, 32),
              acts=("leaky", "prelu", "elu", "selu", "gelu", "rrelu"),
              f32_rtol=1e-4, f32_atol_share=1e-5)
# the harnesses (harness): each port script under example/torch/ in a
# process of its own on the card, with its time limit in seconds; the
# runs of a wave start together (the small ones share the card; the
# ResNet-50 arms run alone, so their samples/s are the card's own)
HARNESS_WAVES = (
    (("train_mnist mlp", "image-classification/train_mnist.py",
      ["--network", "mlp", "--num-epochs", "1", "--disp-batches", "7"],
      180),
     ("train_mnist lenet", "image-classification/train_mnist.py",
      ["--network", "lenet", "--num-epochs", "1", "--disp-batches", "7"],
      180),
     ("dcgan", "gan/dcgan.py", [], 240)),
    (("train_imagenet resnet-50 NCHW f32",
      "image-classification/train_imagenet.py",
      ["--benchmark", "1", "--batch-size", "64", "--num-examples", "640",
       "--num-epochs", "1", "--disp-batches", "3"], 300),),
    (("train_imagenet resnet-50 NHWC bf16",
      "image-classification/train_imagenet.py",
      ["--benchmark", "1", "--batch-size", "64", "--num-examples", "640",
       "--num-epochs", "1", "--disp-batches", "3", "--layout", "NHWC",
       "--dtype", "bfloat16"], 300),),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries the seconds since the
    script started (``elapsed_s``), so a run shows where its time went."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _START, 1)}
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def env_set(name, value):
    """``os.environ[name] = value`` inside the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def fit_fused_off():
    """Modules made inside keep the eager pair (``MXNET_FIT_FUSED=0``):
    the phases written before the fused fit step check that path."""
    return env_set("MXNET_FIT_FUSED", "0")


def serving_eager():
    """Engines made inside keep the eager walk (``MXNET_DECODE_DONATE=0``,
    the JAX engine's copy path): the serve phases' eager arm."""
    return env_set("MXNET_DECODE_DONATE", "0")


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def time_ms(torch, fn, flush, reps=60, warmup=5):
    """Median device time of one ``fn()`` over ``reps`` launches, each
    bracketed by CUDA events after an L2 flush; a device-side sleep
    before the start event keeps the host's launch overhead out of the
    bracket."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class ReadFlush:
    """A flush for ``time_ms`` that reads its buffer (its ``zero_`` sums
    it): the L2 is left full of clean lines, where the usual flush
    (writing zeros) leaves dirty lines that a kernel's first reads must
    write back."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.sum()


def bound(nbytes, flops, peak=F32_FLOPS_PER_S):
    """The least time for the work, ms: bytes over the memory rate or
    operations over ``peak`` (f32 CUDA cores by default), the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def close(torch, a, b):
    return bool(torch.allclose(a.float(), b.float(), rtol=RTOL, atol=ATOL))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device(torch):
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        line = torch.cuda.get_device_name(0)
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


def phase_build():
    from mxnet_tpu_torch.kernels import _build
    secs = _build.build_all()
    logs = {n: sorted(_build.BUILD_DIR.glob("lib%s-*.log" % n))
            for n in _build.SOURCES}
    ptxas = {n: sorted({ln.split(":", 1)[-1].strip() for p in logs[n][-1:]
                        for ln in p.read_text().splitlines()
                        if "registers" in ln or "spill" in ln})
             for n in _build.SOURCES}
    emit({"phase": "build", "seconds": secs, "sources": list(_build.SOURCES),
          "ptxas": ptxas})


def _instances_ptxas(source, pattern, what, smem_fn=None):
    """ptxas's registers, stack and spills (none allowed) of every entry
    function of csrc/<source>.cu whose mangled name matches the regex
    ``pattern`` (keyed by the match: kernel and template arguments),
    printed, with its dynamic shared memory at D = 128 when ``smem_fn``
    gives it (``smem_fn(key)``)."""
    import re
    from mxnet_tpu_torch.kernels import _build
    keys = sorted({re.search(pattern, line).group(0)
                   for line in _build.log_path(source).read_text().splitlines()
                   if "Compiling entry function" in line
                   and re.search(pattern, line)})
    check(keys, "ptxas log of %s.cu: no entry function matches %s"
          % (source, pattern))
    ptx = _ptxas(source, {key: key for key in keys})
    for key in keys:
        line = "ptxas %s: %s" % (key, "; ".join(ptx[key]["lines"]))
        if smem_fn is not None:
            ptx[key]["dynamic_smem_bytes_d128"] = smem_fn(key)
            line += "; %d bytes of dynamic shared memory at D = 128" \
                % ptx[key]["dynamic_smem_bytes_d128"]
        print(line, flush=True)
        check(ptx[key]["spill_stores"] == 0 and ptx[key]["spill_loads"] == 0,
              "%s: %s %s spills: %s"
              % (source, what, key, ptx[key]["lines"][0]))
    return ptx


def pipelined_ms(torch, fn, n=200, warmup=5):
    """Device ms a call over ``n`` calls launched back to back, as a
    serving step launches them (CUDA events around the run; no flush)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _decode_bytes(positions, H, D, M, bs, q_size, kv_size):
    """Bytes decode must move: the K/V rows of each live slot's context
    (positions past the table attend the table's M bs rows), q read and
    the output written, the table and the positions read."""
    rows = sum(min(p + 1, M * bs) for p in positions if p >= 0)
    C = len(positions)
    return (rows * H * D * 2 * kv_size + 2 * C * H * D * q_size
            + C * (M + 1) * 4), rows


def phase_decode(torch, mxk, dev, flush):
    """Paged decode (each slot's keys split evenly over the blocks of a
    thread block cluster, ``decode_plan``) against its plain version:
    f32 outputs at rtol 1e-4 / atol 1e-5, bf16 outputs (bf16 q: one
    rounding of an f32 result computed in another order) within
    close_bf16, f16 outputs (f16 q over f16 caches, the f16 serve step)
    within close_f16, inactive slots exact zeros, two runs
    bit-identical; at the served shape (8 slots, 16 heads of 128, block
    16, 64 table blocks) over long contexts (positions 20-731), serve's
    short ones (20-145), an inactive slot and a position past the table,
    for all five (q, cache) type pairs, and over one slot (8 ranges a
    cluster).  Timed alone (L2 flushed) and 200 calls back to back at
    the long and the short contexts, beside SDPA over each slot's
    context gathered contiguous, in f32, bf16 and f16.  First prints ptxas's lines of the kernel's instances
    (no spills allowed)."""
    import ctypes
    from mxnet_tpu_torch.kernels import _build
    lib = _build.load("paged_attention")
    lib.mx_paged_decode_smem.argtypes = [ctypes.c_int] * 5
    lib.mx_paged_decode_smem.restype = ctypes.c_size_t
    ptx = _instances_ptxas("paged_attention",
                           r"paged_decode_kernelI\w+?E(?=Ev)",
                           "the decode kernel")
    check(len(ptx) == 10, "paged_attention: %d decode instances, not 10 "
          "(5 type pairs x 2 load forms)" % len(ptx))
    C, H, D, nb, bs, M = 8, 16, 128, 512, 16, 64
    g = torch.Generator(device="cpu").manual_seed(SEED)
    q = torch.randn(C, H, D, generator=g).to(dev)
    kc = torch.randn(nb, bs, H, D, generator=g).to(dev)
    vc = torch.randn(nb, bs, H, D, generator=g).to(dev)
    table = torch.randperm(nb, generator=g)[:C * M].reshape(C, M) \
        .to(torch.int32).to(dev)
    pos_live = torch.randint(20, 732, (C,), generator=g).to(torch.int32)
    pos_short = torch.randint(20, 146, (C,), generator=g).to(torch.int32)
    pos_mixed = pos_live.clone()
    pos_mixed[7] = -1
    pos_mixed[2] = M * bs + 5000          # past the table: all M bs rows
    sc = 1.0 / D ** 0.5
    bf, hf = torch.bfloat16, torch.float16
    plan = mxk.paged_attention.decode_plan(C, H, D, bs, M)
    errs = {}

    def hold(what, q, kc, vc, table, pos):
        out = mxk.paged_decode_attend(q, kc, vc, table, pos, scale=sc)
        again = mxk.paged_decode_attend(q, kc, vc, table, pos, scale=sc)
        ref = mxk.paged_decode_attend_plain(q, kc, vc, table, pos, scale=sc)
        torch.cuda.synchronize()
        act = pos >= 0
        check(torch.equal(out, again), "paged_decode_attend %s: two runs "
              "differ" % what)
        ok = {torch.float32: close, bf: close_bf16, hf: close_f16}[q.dtype](
            torch, out[act], ref[act])
        check(ok, "paged_decode_attend %s disagrees with its plain version "
              "(max abs err %g)" % (what, max_err(out[act], ref[act])))
        check(bool((out[~act] == 0).all()),
              "paged_decode_attend %s: inactive slot is not exact zeros"
              % what)
        errs[what] = max_err(out[act], ref[act])

    for qt, ct in ((torch.float32, torch.float32), (torch.float32, bf),
                   (bf, torch.float32), (bf, bf), (hf, hf)):
        tag = "q %s, cache %s" % (str(qt)[6:], str(ct)[6:])
        qq, kk, vv = q.to(qt), kc.to(ct), vc.to(ct)
        for name, pos in (("long", pos_live), ("short", pos_short),
                          ("inactive and past the table", pos_mixed)):
            hold("%s, %s" % (tag, name), qq, kk, vv, table, pos.to(dev))
    # one slot: the plan's most ranges (8) a cluster
    one = mxk.paged_attention.decode_plan(1, H, D, bs, M)
    check(one["ranges"] == 8, "decode_plan: one slot takes %d ranges, not 8"
          % one["ranges"])
    hold("one slot", q[:1], kc, vc, table[:1], pos_mixed[2:3].to(dev))
    hold("one slot, short", q[:1], kc, vc, table[:1], pos_short[:1].to(dev))
    hold("one slot, float16", q[:1].to(hf), kc.to(hf), vc.to(hf), table[:1],
         pos_mixed[2:3].to(dev))
    timed = {}
    # f32 and, as the 16-bit serve steps run it, bf16 q over bf16 caches
    # and f16 over f16
    prefix = {torch.float32: "", bf: "bf16_", hf: "f16_"}
    for dt in (torch.float32, bf, hf):
        qq, kk, vv = q.to(dt), kc.to(dt), vc.to(dt)
        size = 4 if dt == torch.float32 else 2
        for name, pos_c in (("long", pos_live), ("short", pos_short)):
            pos = pos_c.to(dev)
            fn = lambda: mxk.paged_decode_attend(qq, kk, vv, table, pos,
                                                 scale=sc)
            ctx = int(pos_c.max()) + 1
            lib_call = _sdpa_on_context(torch, qq[:, :, None], kk, vv, table,
                                        pos_c.tolist(), [1] * C, ctx, sc)
            nbytes, rows = _decode_bytes(pos_c.tolist(), H, D, M, bs, size,
                                         size)
            b_ms, b_by = bound(nbytes, rows * H * D * 4)
            key = prefix[dt] + name
            timed[key] = {
                "ms": time_ms(torch, fn, flush),
                "back_to_back_ms": pipelined_ms(torch, fn),
                "plain_ms": time_ms(torch, lambda: mxk.paged_decode_attend_plain(
                    qq, kk, vv, table, pos, scale=sc), flush),
                "library_ms": time_ms(torch, lib_call, flush),
                "library_back_to_back_ms": pipelined_ms(torch, lib_call),
                "bound_ms": b_ms, "bound_by": b_by, "context_rows": rows,
                "positions": pos_c.tolist()}
            timed[key]["gbps"] = nbytes / timed[key]["ms"] / 1e6
    rows_out = []
    for tag, dtype in (("", "float32"), ("bf16_", "bfloat16"),
                       ("f16_", "float16")):
        long = timed[tag + "long"]
        rows_out.append({
            "name": "paged_decode_attend", "route": "cuda", "dtype": dtype,
            "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
            "replaces": "mxnet_tpu/pallas/attention.py:116",
            "max_abs_err": max(e for w, e in errs.items()
                               if w.startswith("q %s, cache %s"
                                               % (dtype, dtype))
                               or (dtype == "float32"
                                   and w in ("one slot", "one slot, short"))
                               or (dtype == "float16"
                                   and w == "one slot, float16")),
            **{k: long[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "back_to_back_ms")},
            "short_contexts": {k: timed[tag + "short"][k] for k in (
                "ms", "back_to_back_ms", "plain_ms", "library_ms",
                "bound_ms")}})
    res = rows_out[0]
    emit({"phase": "kernel", **res, "shapes": {
        "q": [C, H, D], "cache": [nb, bs, H, D], "table": [C, M]},
        "plan": plan, "one_slot_plan": one, "timed": timed, "errors": errs,
        "ptxas": ptx,
        "dynamic_smem_bytes": {
            "f32_cache": lib.mx_paged_decode_smem(D, M * bs, bs,
                                                  plan["ranges"], 0),
            "bf16_cache": lib.mx_paged_decode_smem(D, M * bs, bs,
                                                   plan["ranges"], 1),
            "f16_cache": lib.mx_paged_decode_smem(D, M * bs, bs,
                                                  plan["ranges"], 2)},
        "library_call": "F.scaled_dot_product_attention on (C, H, 1, D) "
                        "queries over the context gathered contiguous, "
                        "(C, H, max position + 1, D), keys past each "
                        "position masked", "bf16": rows_out[1],
        "f16": rows_out[2]})
    return rows_out


def _sdpa_on_context(torch, q, kc, vc, table, starts, lens, ctx, sc):
    """A call of ``scaled_dot_product_attention`` computing what the
    paged kernels compute, on K/V gathered contiguous beforehand: q (B,
    H, S, D) rows at positions starts[b] + i; keys [0, ctx) of each
    row's table, key j visible to row i when j <= starts[b] + i (rows at
    or past lens[b] see their causal prefix too: padding, don't-care).
    The gather is outside the call."""
    import torch.nn.functional as F
    nb, bs, H, D = kc.shape
    j = torch.arange(ctx, device=kc.device)
    ridx = table.long()[:, j // bs] * bs + j % bs                # (B, ctx)
    kh, vh = (c.view(nb * bs, H, D)[ridx].transpose(1, 2).contiguous()
              for c in (kc, vc))
    S = q.shape[2]
    apos = (torch.tensor(starts, device=kc.device)[:, None]
            + torch.arange(S, device=kc.device)[None, :])        # (B, S)
    mask = (j[None, None, :] <= apos[:, :, None])[:, None]       # (B, 1, S, ctx)
    qh = q.contiguous()
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  scale=sc)


def _chunk_bound(H, D, M, K, starts, lens, size=4):
    """Bytes and operations the chunked prefill must move and do (q/k/v
    and caches of ``size`` bytes an element): the cached context read
    once (K and V), the chunk's q/k/v read and its real K/V rows written
    into the cache, the (B, K) output written, the table, start and
    length read; 4 H D flops per (query, visible key)."""
    B = len(starts)
    nbytes = sum((st * 2 + 3 * L + L * 2) * H * D * size
                 for st, L in zip(starts, lens)) \
        + B * K * H * D * size + B * M * 4 + 2 * B * 4
    flops = sum(st + i + 1 for st, L in zip(starts, lens)
                for i in range(L)) * H * D * 4
    return nbytes, flops


def phase_chunk(torch, mxk, dev, flush):
    """The chunked prefill (split TF32 on the tensor cores over key
    ranges, then an ordered combine) against its plain version: outputs
    of the real rows at rtol 1e-4 / atol 1e-5, padded rows exact zeros,
    the caches equal to the plain version's and nothing written outside
    [start, start + len), two runs bit-identical; at the mixed step's
    64-row chunk (start 576, len 64; 600, 37; 320, 0), the spec step's 8
    x 5-row spans and with bf16 caches.  Both served shapes timed beside
    SDPA on the context gathered contiguous (B, H, start + len, D) with
    the offset-causal mask (the attention alone), bounded by bytes or by
    operations at the split-TF32 peak (the CUDA-core bound beside).
    First prints ptxas's lines of the kernel's instances (warps, head_dim
    form, q/k/v and cache types; no spills allowed) and its combine.  The
    spans are also timed over short contexts, as serve_spec's prompts
    give them.  The 16-bit tile's instances, bf16/bf16 and f16/f16 (the
    16-bit serve and spec steps), the same way at the same cases and at
    the head_dims of PAGED_BF16_DIMS, bf16 outputs within
    close_bf16_out, f16 within close_f16; each type's row returned."""
    import ctypes
    from mxnet_tpu_torch.kernels import _build
    lib = _build.load("paged_attention")
    lib.mx_paged_chunk_prefill_smem.argtypes = [ctypes.c_int] * 5
    lib.mx_paged_chunk_prefill_smem.restype = ctypes.c_size_t
    B, K, H, D, nb, bs, M = 1, 64, 16, 128, 512, 16, 64
    served_range = mxk.paged_attention.chunk_plan(B, K, H, D, M * bs)[
        "key_range"]
    ptx = _instances_ptxas(
        "paged_attention", r"paged_chunk_kernelILi\d+ELb[01]E"
        r"(?:f|13__nv_bfloat16)(?:f|13__nv_bfloat16)",
        "the f32 attention kernel",
        lambda key: lib.mx_paged_chunk_prefill_smem(
            int(key.split("ILi")[1].split("E")[0]), 128, served_range, bs,
            0))
    check(len(ptx) == 12, "paged_attention: %d split-TF32 chunk instances, "
          "not 12 (warps x head_dim forms x 3 type pairs; bf16/bf16 runs "
          "the bf16 kernel)" % len(ptx))
    ptx_bf16 = _instances_ptxas(
        "paged_attention",
        r"paged_chunk16_kernelI13__nv_bfloat16Li\d+ELb[01]E",
        "the bf16 attention kernel",
        lambda key: lib.mx_paged_chunk_prefill_smem(
            int(key.split("Li")[1].split("E")[0]), 128, served_range, bs,
            1))
    check(len(ptx_bf16) == 4, "paged_attention: %d bf16 chunk instances, not "
          "4 (warps x head_dim forms)" % len(ptx_bf16))
    ptx_f16 = _instances_ptxas(
        "paged_attention", r"paged_chunk16_kernelI6__halfLi\d+ELb[01]E",
        "the f16 attention kernel",
        lambda key: lib.mx_paged_chunk_prefill_smem(
            int(key.split("Li")[1].split("E")[0]), 128, served_range, bs,
            1))
    check(len(ptx_f16) == 4, "paged_attention: %d f16 chunk instances, not "
          "4 (warps x head_dim forms)" % len(ptx_f16))
    import re
    combine = sorted({re.search(r"paged_chunk_combine_kernelI\w+?E(?=Ev)", line)
                      .group(0) for line in _build.log_path("paged_attention")
                      .read_text().splitlines()
                      if "Compiling entry function" in line
                      and "paged_chunk_combine_kernel" in line})
    check(len(combine) == 5, "paged_attention: %d chunk combine instances, "
          "not 5 (q and cache types)" % len(combine))
    ptx.update(_ptxas("paged_attention", {key: key for key in combine}))
    for key in combine:
        print("ptxas %s: %s" % (key, "; ".join(ptx[key]["lines"])), flush=True)
        check(ptx[key]["spill_stores"] == 0 and ptx[key]["spill_loads"] == 0,
              "paged_attention: the chunk combine %s spills" % key)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    q, k, v = (torch.randn(B, K, H, D, generator=g).to(dev)
               for _ in range(3))
    kc0 = torch.randn(nb, bs, H, D, generator=g).to(dev)
    vc0 = torch.randn(nb, bs, H, D, generator=g).to(dev)
    table = torch.randperm(nb, generator=g)[:M].reshape(B, M) \
        .to(torch.int32).to(dev)
    sc = 1.0 / D ** 0.5

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def run_case(what, q, k, v, kc0, vc0, table, starts, lens):
        """Kernel twice and plain once on clones of the caches; the
        checks; returns the max abs error over the real rows."""
        Bc, Kc = q.shape[:2]
        nb, bs = kc0.shape[:2]
        runs = []
        for fn in (mxk.paged_chunk_prefill_attend,
                   mxk.paged_chunk_prefill_attend,
                   mxk.paged_chunk_prefill_attend_plain):
            kk, vk = kc0.clone(), vc0.clone()
            out, _, _ = fn(q, k, v, kk, vk, table, i32(starts), i32(lens),
                           scale=sc)
            runs.append((out, kk, vk))
        torch.cuda.synchronize()
        (o1, k1, v1), (o2, k2, v2), (ref, kr, vr) = runs
        real = torch.zeros(Bc, Kc, dtype=torch.bool)
        touched = torch.zeros(nb * bs, dtype=torch.bool)
        for b, (st, L) in enumerate(zip(starts, lens)):
            real[b, :L] = True
            for ap in range(st, st + L):
                touched[int(table[b, ap // bs]) * bs + ap % bs] = True
        real, touched = real.to(dev), touched.to(dev)
        check(torch.equal(o1, o2) and torch.equal(k1, k2)
              and torch.equal(v1, v2), what + ": two runs differ")
        ok = {torch.float32: close, torch.bfloat16: close_bf16_out,
              torch.float16: close_f16}[q.dtype](torch, o1[real], ref[real])
        check(ok, what + " disagrees with its plain version (max abs err %g)"
              % max_err(o1[real], ref[real]))
        check(bool((o1[~real] == 0).all()), what + ": padded rows are not "
              "zeros")
        check(torch.equal(k1, kr) and torch.equal(v1, vr),
              what + ": caches differ from the plain version's")
        check(all(torch.equal(a.view(nb * bs, -1)[~touched],
                              a0.view(nb * bs, -1)[~touched])
                  for a, a0 in ((k1, kc0), (v1, vc0))),
              what + " wrote outside each row's [start, start + len)")
        return max_err(o1[real], ref[real])

    errs = []
    # a block-aligned full chunk (the served case), a ragged chunk that
    # straddles block boundaries, and the no-op len == 0
    for st, L in ((576, 64), (600, 37), (320, 0)):
        errs.append(run_case("paged_chunk_prefill_attend (start %d, len %d)"
                             % (st, L), q, k, v, kc0, vc0, table, [st], [L]))
    # the spec step's span stream: C = 8 rows of K = 5, each at its own
    # cache offset with its own length (0 = an inactive slot) over its
    # own scrambled table
    spans = ([37, 700, 0, 1018, 255, 512, 96, 3], [5, 3, 0, 5, 1, 2, 4, 5])
    C, S5 = len(spans[0]), 5
    qs, ks, vs = (torch.randn(C, S5, H, D, generator=g).to(dev)
                  for _ in range(3))
    stable = torch.randperm(nb, generator=g)[:C * M].reshape(C, M) \
        .to(torch.int32).to(dev)
    errs.append(run_case("paged_chunk_prefill_attend (spec spans, C, K = %d, "
                         "%d)" % (C, S5), qs, ks, vs, kc0, vc0, stable,
                         *spans))
    bf = torch.bfloat16
    bf16_err = run_case("paged_chunk_prefill_attend (bf16 caches)", q, k, v,
                        kc0.to(bf), vc0.to(bf), table, [600], [37])
    # the 16-bit kernel (bf16 q/k/v over bf16 caches, the bf16 serve and
    # spec steps; f16 over f16, the f16 ones): the same cases, then at the
    # head_dims of PAGED_BF16_DIMS (d_model 2048 past 128, 4 heads below)
    errs16 = {}
    for h16 in (bf, torch.float16):
        name16 = str(h16)[6:]
        e16 = errs16[name16] = {}
        for st, L in ((576, 64), (600, 37), (320, 0)):
            e16["start %d, len %d" % (st, L)] = run_case(
                "paged_chunk_prefill_attend %s (start %d, len %d)"
                % (name16, st, L), q.to(h16), k.to(h16), v.to(h16),
                kc0.to(h16), vc0.to(h16), table, [st], [L])
        e16["spec spans"] = run_case(
            "paged_chunk_prefill_attend %s (spec spans)" % name16,
            qs.to(h16), ks.to(h16), vs.to(h16), kc0.to(h16), vc0.to(h16),
            stable, *spans)
        for d_ in PAGED_BF16_DIMS:
            h_ = 2048 // d_ if d_ > 128 else 4
            qd, kd, vd = (torch.randn(2, 40, h_, d_, generator=g).to(dev)
                          .to(h16) for _ in range(3))
            kcd, vcd = (torch.randn(96, bs, h_, d_, generator=g).to(dev)
                        .to(h16) for _ in range(2))
            td = torch.randperm(96, generator=g)[:2 * 40].reshape(2, 40) \
                .to(torch.int32).to(dev)
            e16["head_dim %d" % d_] = run_case(
                "paged_chunk_prefill_attend %s (head_dim %d)" % (name16, d_),
                qd, kd, vd, kcd, vcd, td, [300, 7], [40, 23])
    bf16_errs = errs16["bfloat16"]
    # times: the mixed step's chunk, the spec step's spans above, and
    # full spans over the short contexts of serve_spec's prompts; f32,
    # then bf16 and f16 (their bound at the dense 16-bit tensor-core peak,
    # the same for both)
    timed = {}
    prefix = {torch.float32: "", bf: "bf16_", torch.float16: "f16_"}
    for dt, peak in ((torch.float32, SPLIT_TF32_FLOPS_PER_S),
                     (bf, BF16_FLOPS_PER_S),
                     (torch.float16, BF16_FLOPS_PER_S)):
        for name, args, starts, lens in (
                ("mixed", (q, k, v, table), [576], [64]),
                ("spec_spans", (qs, ks, vs, stable), *spans),
                ("spec_spans_short", (qs, ks, vs, stable),
                 [60, 90, 130, 70, 100, 120, 140, 80], [S5] * C)):
            qq, kk_, vv_ = (t.to(dt) for t in args[:3])
            tb = args[3]
            kk, vk = kc0.to(dt), vc0.to(dt)
            s_t, l_t = i32(starts), i32(lens)
            ms = time_ms(torch, lambda: mxk.paged_chunk_prefill_attend(
                qq, kk_, vv_, kk, vk, tb, s_t, l_t, scale=sc), flush)
            plain_ms = time_ms(
                torch, lambda: mxk.paged_chunk_prefill_attend_plain(
                    qq, kk_, vv_, kk, vk, tb, s_t, l_t, scale=sc), flush)
            # the cache now holds the chunk rows: SDPA attends over them
            ctx = max(st + L for st, L in zip(starts, lens))
            lib_ms = time_ms(torch, _sdpa_on_context(
                torch, qq.transpose(1, 2), kk, vk, tb, starts, lens, ctx,
                sc), flush)
            nbytes, flops = _chunk_bound(H, D, M, qq.shape[1], starts, lens,
                                         qq.element_size())
            b_ms, b_by = bound(nbytes, flops, peak)
            key = prefix[dt] + name
            timed[key] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "bytes": nbytes, "flops": flops,
                          "plan": mxk.paged_attention.chunk_plan(
                              qq.shape[0], qq.shape[1], H, D, M * bs)}
            if dt == torch.float32:
                timed[key]["bound_cuda_cores_ms"] = bound(nbytes, flops)[0]
            else:
                timed[key]["back_to_back_ms"] = pipelined_ms(
                    torch, lambda: mxk.paged_chunk_prefill_attend(
                        qq, kk_, vv_, kk, vk, tb, s_t, l_t, scale=sc))
    mixed = timed["mixed"]
    res = {"name": "paged_chunk_prefill_attend", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
           "replaces": "mxnet_tpu/pallas/attention.py:360",
           "max_abs_err": max(errs), "ms": mixed["ms"],
           "plain_ms": mixed["plain_ms"], "bound_ms": mixed["bound_ms"],
           "bound_by": mixed["bound_by"], "library_ms": mixed["library_ms"],
           "bound_peak": "split TF32, %g TFLOP/s"
                         % (SPLIT_TF32_FLOPS_PER_S / 1e12),
           "bound_cuda_cores_ms": mixed["bound_cuda_cores_ms"],
           **{case: {key: timed[case][key] for key in
                     ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                      "bound_cuda_cores_ms")}
              for case in ("spec_spans", "spec_spans_short")}}
    emit({"phase": "kernel", **res, "shapes": {
        "q": [B, K, H, D], "cache": [nb, bs, H, D], "table": [B, M],
        "start": 576, "len": 64}, "checked": [[576, 64], [600, 37], [320, 0]],
        "spec_spans_checked": {"q": [C, S5, H, D], "span_start": spans[0],
                               "span_len": spans[1]},
        "timed": timed, "bf16_cache_max_abs_err": bf16_err,
        "bf16_errors": bf16_errs, "f16_errors": errs16["float16"],
        "ptxas": ptx, "ptxas_bf16": ptx_bf16, "ptxas_f16": ptx_f16,
        "library_call": "F.scaled_dot_product_attention on the context "
                        "gathered contiguous, (B, H, start + len, D), with "
                        "the offset-causal boolean mask: the attention "
                        "alone, without the cache scatter"})
    rows = [res]
    for tag, dtype in (("bf16_", "bfloat16"), ("f16_", "float16")):
        rows.append({"name": "paged_chunk_prefill_attend", "route": "cuda",
                     "dtype": dtype,
                     "source": "mxnet_tpu_torch/csrc/paged_attention.cu "
                               "(on csrc/attention_bf16.cuh)",
                     "replaces": "mxnet_tpu/pallas/attention.py:360",
                     "max_abs_err": max(errs16[dtype].values()),
                     **{k: timed[tag + "mixed"][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "back_to_back_ms")},
                     "f32_instance_ms": mixed["ms"],
                     **{case: {k: timed[tag + case][k] for k in
                               ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "back_to_back_ms")}
                        for case in ("spec_spans", "spec_spans_short")}})
    return rows


def _ln_fwd_hold(torch, mxk, x, gamma, beta, res, tag, errs):
    """LayerNorm forward on (x, gamma, beta), with and without ``res``:
    two runs bit-identical, against the plain version (out at rtol 1e-4 /
    atol 1e-5 in f32, close_bf16 in bf16, close_f16 in f16; the f32
    statistics at rtol 1e-4 / atol 1e-5).  Records each max abs error in
    ``errs``."""
    for r in (None, res):
        what_r = tag + (", residual" if r is not None else "")
        got = mxk.layernorm_fused(x, gamma, beta, residual=r)
        again = mxk.layernorm_fused(x, gamma, beta, residual=r)
        ref = mxk.layernorm_plain(x, gamma, beta, residual=r)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "layernorm_fused %s: two runs differ" % what_r)
        for a, b, what in zip(got, ref, ("out", "mean", "rstd")):
            ok = {torch.bfloat16: close_bf16, torch.float16: close_f16}.get(
                x.dtype if what == "out" else None, close)(torch, a, b)
            check(ok, "layernorm_fused %s (%s) disagrees with its plain "
                  "version (max abs err %g)" % (what, what_r, max_err(a, b)))
            errs["%s %s" % (what, what_r)] = max_err(a, b)


def _ln_fwd_edges(torch, mxk, dev, g, dtype, errs):
    """The forward at the widths of LN_FWD_EDGES and on rows one element
    off 16-byte alignment (element by element), as _ln_fwd_hold holds
    it."""
    for rows, cols in LN_FWD_EDGES:
        x, res = (torch.randn(rows, cols, generator=g).to(dev).to(dtype)
                  for _ in range(2))
        gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(dtype)
        beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(dtype)
        _ln_fwd_hold(torch, mxk, x, gamma, beta, res,
                     "%s %d x %d" % (str(dtype)[6:], rows, cols), errs)
    rows, cols = 64, 2048
    flat = torch.randn(2 * rows * cols + 2, generator=g).to(dev).to(dtype)
    x = flat[1:rows * cols + 1].view(rows, cols)
    res = flat[rows * cols + 2:].view(rows, cols)
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(dtype)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(dtype)
    _ln_fwd_hold(torch, mxk, x, gamma, beta, res, "%s misaligned %d x %d"
                 % (str(dtype)[6:], rows, cols), errs)


def phase_layernorm(torch, mxk, dev, flush):
    """LayerNorm forward in f32 (a group of warps a row, the row in
    registers; its instances' ptxas lines first, no spills) at the rows
    of every path that runs it, 2048 columns, with and without a
    residual, two runs bit-identical, and at the widths of LN_FWD_EDGES
    and on misaligned rows; timed alone (L2 flushed by writing, and by
    reading) and 200 calls back to back beside F.layer_norm."""
    import torch.nn.functional as F
    ptx = _instances_ptxas("layernorm", LN_FWD_PATTERN,
                           "the LayerNorm forward")
    clean = ReadFlush(flush)
    cols = 2048
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev)
    per_shape = []
    errs = {}
    # 8 and 64 rows are the serve step's (the decode and chunk streams),
    # 40 the spec step's span stream (8 slots x 5), 1024 the draft
    # model's (1, seq_len) forward, 4096 Module.fit's (4 x 1024), 8192
    # the one-shot prefill's (8 x 1024)
    for rows in (8, 64, 40, 1024, 4096, 8192):
        x = torch.randn(rows, cols, generator=g).to(dev)
        res = torch.randn(rows, cols, generator=g).to(dev)
        before = len(errs)
        _ln_fwd_hold(torch, mxk, x, gamma, beta, res,
                     "float32 %d x %d" % (rows, cols), errs)
        err = max(list(errs.values())[before:])
        fn = lambda: mxk.layernorm_fused(x, gamma, beta)
        lib = lambda: F.layer_norm(x, (cols,), gamma, beta, 1e-5)
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, lambda: mxk.layernorm_plain(x, gamma, beta),
                           flush)
        lib_ms = time_ms(torch, lib, flush)
        nbytes = 2 * rows * cols * 4 + 2 * cols * 4 + 2 * rows * 4
        b_ms, b_by = bound(nbytes, 8 * rows * cols)
        shape = {"rows": rows, "cols": cols, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": b_ms, "bound_by": b_by,
                 "read_flush_ms": time_ms(torch, fn, clean),
                 "library_read_flush_ms": time_ms(torch, lib, clean),
                 "back_to_back_ms": pipelined_ms(torch, fn),
                 "library_back_to_back_ms": pipelined_ms(torch, lib),
                 "share_of_bound": b_ms / ms}
        emit({"phase": "kernel", "name": "layernorm_fused", **shape})
        per_shape.append(shape)
    _ln_fwd_edges(torch, mxk, dev, g, torch.float32, errs)
    emit({"phase": "layernorm", "ptxas": ptx, "errors": errs,
          "edges": [list(e) for e in LN_FWD_EDGES], "deterministic": True})
    # the serve path calls it 25 times per step at 8 rows and 25 at 64:
    # the kernels line carries the mean of those two shapes
    mean = {k: statistics.mean(s[k] for s in per_shape[:2])
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"name": "layernorm_fused", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/layernorm.cu",
            "replaces": "mxnet_tpu/pallas/layernorm.py:127",
            "max_abs_err": max(errs.values()),
            "bound_by": per_shape[1]["bound_by"], **mean}


# seeded_params' arrays by (name, shape): each phase gets copies, so a
# later phase's model (a 2-layer model shares its layers with the
# 12-layer one) is not drawn again
_SEEDED = {}


def seeded_params(cfg):
    """Random weights from a numpy seed, one stream per parameter name
    (so a 2-layer model shares its layers with the 12-layer one):
    N(0, 0.02), LayerNorm scales 1 + N(0, 0.02).  The streams are drawn
    on 8 threads (numpy's generators release the GIL) and kept, so the
    same name and shape are drawn once a run; the caller gets copies."""
    from concurrent.futures import ThreadPoolExecutor
    from mxnet_tpu_torch.weights import param_shapes
    shapes = {n: tuple(s) for n, s in param_shapes(cfg).items()}

    def draw(name):
        rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
        a = rng.standard_normal(shapes[name], dtype=np.float32) \
            * np.float32(0.02)
        if name.endswith("_gamma"):
            a += np.float32(1.0)
        return a
    todo = [n for n, s in shapes.items() if (n, s) not in _SEEDED]
    with ThreadPoolExecutor(8) as pool:
        for name, a in zip(todo, pool.map(draw, todo)):
            _SEEDED[(name, shapes[name])] = a
    return {n: _SEEDED[(n, s)].copy() for n, s in shapes.items()}


# ----------------------------------------------------------------------
# the serving step as one captured CUDA graph (ROADMAP A.3): the
# measurements and checks every serve phase shares
# ----------------------------------------------------------------------
SERVE_LENGTHS = [700, 20, 350, 90, 520, 45, 260, 610]
_KERNEL_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
# a steady window: one request whose prompt fits one chunk, so its chunk
# step emits its first token and each later step one more
WINDOW = dict(prompt=48, new=4)


def profiled(torch, run):
    """``run()`` (returns the steps it took) under ``torch.profiler`` and
    ``torch.cuda.set_sync_debug_mode('warn')``: per step, the CUDA
    runtime's launch and copy calls (every thread), the host syncs with
    the Python line of each, and the device ms (kernels and copies)."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                steps = run()
                wall = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    sites = sorted({"%s:%d" % (os.path.relpath(w.filename, HERE), w.lineno)
                    for w in caught if "synchroniz" in str(w.message)})
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    calls = {}
    for ev in prof.events():
        if ev.name in _RUNTIME_CALLS:
            calls[ev.name] = calls.get(ev.name, 0) + 1
    device_us = sum(getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0))
                    for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "runtime_calls_per_step": {k: v / steps
                                       for k, v in sorted(calls.items())},
            "host_syncs_per_step": syncs / steps, "sync_sites": sites,
            "device_ms_per_step": device_us / 1e3 / steps}


def engine_window(torch, eng, cfg, seed, exes=()):
    """``profiled`` over one WINDOW request on a warm, started engine;
    with ``exes``, also their forwards a step (``dispatches_per_step``:
    the step's and the draft model's graph replays)."""
    prompt = _serve_prompts(cfg, seed, (WINDOW["prompt"],))[0]
    d0 = [e.dispatches for e in exes]

    def run():
        s0 = eng.stats()["steps"]
        out = eng.generate(prompt, max_new_tokens=WINDOW["new"], timeout=900)
        check(len(out) == WINDOW["new"], "window: %d tokens" % len(out))
        return eng.stats()["steps"] - s0
    win = profiled(torch, run)
    if exes:
        win["dispatches_per_step"] = sum(
            e.dispatches - d for e, d in zip(exes, d0)) / win["steps"]
    return win


def check_graph_window(what, win, graph_launches=1.0):
    """A steady step of a captured engine or executor: ``graph_launches``
    ``cudaGraphLaunch`` calls a step (the step's graph, and a draft
    model's), no kernel launch call, and host syncs only at the
    readbacks (``NDArray.asnumpy``), one after each graph launch."""
    calls = win["runtime_calls_per_step"]
    check(calls.get("cudaGraphLaunch", 0) == graph_launches
          and not any(calls.get(k, 0) for k in _KERNEL_CALLS),
          "%s: a steady step made runtime calls %s (want %s graph launch, "
          "no kernel launch)" % (what, calls, graph_launches))
    check(win["host_syncs_per_step"] == graph_launches
          and all(s.startswith("mxnet_tpu_torch/ndarray/ndarray.py:")
                  for s in win["sync_sites"]),
          "%s: host syncs %s a step at %s (want the readbacks only)"
          % (what, win["host_syncs_per_step"], win["sync_sites"]))


def step_replay_ms(torch, exe, lock, n=20):
    """Device ms of one replay of ``exe``'s captured step: ``n`` replays
    (the last step again, writing the same cache rows) between two CUDA
    events, under the engine's step lock."""
    with lock:
        graph = exe._program.graph
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / n


def graph_launches(exes, d0=None):
    """Device launches of the executors' captured graphs, by kernel:
    each graph's recorded launches times its forwards (since the counts
    ``d0``, one per executor)."""
    out = {}
    for i, exe in enumerate(exes):
        n = exe.dispatches - (d0[i] if d0 else 0)
        for k, v in exe.captured_launches().items():
            out[k] = out.get(k, 0) + v * n
    return out


def check_captured(what, exes, launches, plain):
    """Every kernel the wrappers counted since the counts were set to 0
    came from the executors' warm-up walks and captures (``WARMUP`` + 1
    times what each graph recorded, each captured once): nothing else
    ran eagerly; no plain version ran."""
    from mxnet_tpu_torch.cuda_graph import WARMUP
    want = {}
    for exe in exes:
        check(exe.captures == 1, "%s: %d captures of one executor"
              % (what, exe.captures))
        for k, v in exe.captured_launches().items():
            want[k] = want.get(k, 0) + (WARMUP + 1) * v
    got = {k: v for k, v in launches.items() if v}
    check(got == want, "%s: the wrappers launched %s, the warm-ups and "
          "captures account for %s" % (what, got, want))
    check(not any(plain.values()), "%s: plain versions ran on the main "
          "path: %s" % (what, plain))


WITNESS_KEYS = ("cache_donation", "steady_state_retraces",
                "decode_step_dispatches", "steps", "dispatches_per_step")


def check_witnesses(what, st):
    """The JAX engine's witnesses: every step one dispatch, none
    captured again, the caches donated."""
    check(st["cache_donation"] is True and st["steady_state_retraces"] == 0
          and st["decode_step_dispatches"] == st["steps"] > 0
          and st["dispatches_per_step"] == 1.0,
          "%s: witnesses %s" % (what, {k: st[k] for k in WITNESS_KEYS}))


def first_step_logits(eng, prompts):
    """Each prompt's first-step logits (the chunk head's row) and first
    token, one request after another."""
    out = []
    for p in prompts:
        h = eng.submit(p, max_new_tokens=1, collect_logits=True)
        tok = h.result(timeout=900)
        out.append((tok, h.logits[0]))
    return out


def probe_feeds(eng, prompt):
    """The mixed or spec step's inputs with ``prompt``'s first chunk at
    start 0 in blocks 0.. (the decode rows inactive)."""
    feeds = eng._idle_feeds()
    K, bs = eng._chunk_tokens, eng.cache.block_size
    n = min(K, len(prompt))
    feeds["chunk_data"][0, :n] = prompt[:n]
    feeds["chunk_positions"][0, :n] = np.arange(n)
    feeds["chunk_len"][0] = n
    feeds["chunk_table"][0, :-(-n // bs)] = np.arange(-(-n // bs))
    return feeds


def first_differing_op(torch, exe, feeds):
    """The first node, in the walk's order, whose output differs bit for
    bit between ``exe``'s walk captured as a CUDA graph and the same walk
    run eagerly, every intermediate kept, on the same feeds and bound
    tensors (an inference walk rewrites the same cache bytes); None when
    every output is equal.  On the CPU both sides are eager."""
    from mxnet_tpu_torch.cuda_graph import WARMUP, Program
    from mxnet_tpu_torch.executor import GraphPlan, run_graph
    plan = GraphPlan.__new__(GraphPlan)
    plan.nodes = exe._plan.nodes
    plan.heads = [(n, i) for n in plan.nodes if not n.is_var
                  for i in range(n.op.out_count(n.attrs))]
    plan.drop_after = [[] for _ in plan.nodes]
    exe._feed(feeds)

    def walk():
        values = {n: nd._data for n, nd in exe.aux_dict.items()}
        values.update((n, nd._data) for n, nd in exe.arg_dict.items())
        with torch.no_grad():
            return run_graph(plan, values, False)[0]
    eager = [t.clone() for t in walk()]
    if exe._device.type == "cuda":
        prog = Program(walk, exe._device, "probe", "")
        for _ in range(WARMUP):
            prog.warm_up()
        graph = prog.capture()
        torch.cuda.synchronize()
    else:
        graph = walk()
    for (node, i), a, b in zip(plan.heads, eager, graph):
        if not torch.equal(a, b):
            return "%s[%d]" % (node.name, i)
    return None


def hold_arms(torch, what, eng, got, ref, prompt):
    """The captured engine's first-step logits against the eager arm's:
    bit-equal, or else the first op whose bits part is named and the
    logits held at rtol 1e-4 / atol 1e-4; the first tokens equal."""
    check([g[0] for g in got] == [r[0] for r in ref],
          "%s: first tokens differ from the eager arm's" % what)
    equal = all(np.array_equal(g[1], r[1]) for g, r in zip(got, ref))
    res = {"first_step_logits_bit_equal": equal,
           "max_abs_logit_diff": max(float(np.abs(g[1] - r[1]).max())
                                     for g, r in zip(got, ref))}
    if not equal:
        with eng._step_lock:
            res["first_differing_op"] = first_differing_op(
                torch, eng._exe, probe_feeds(eng, prompt))
        check(all(np.allclose(g[1], r[1], rtol=1e-4, atol=1e-4)
                  for g, r in zip(got, ref)),
              "%s: first-step logits differ from the eager arm's past "
              "rtol/atol 1e-4 (first differing op %s)"
              % (what, res["first_differing_op"]))
    return res


def _serve_requests(torch, eng, prompts, new, collect=False):
    """serve's requests on a started engine: ``prompts`` at once and the
    first one again (it waits for a slot); outputs, wall s, TTFTs,
    ``stats()`` and, with ``collect``, every step's logits rows of every
    request (else None)."""
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=new, collect_logits=collect)
               for p in prompts + prompts[:1]]
    outs = [h.result(timeout=900) for h in handles]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return outs, wall, sorted(h.ttft_ms for h in handles), eng.stats(), \
        [row for h in handles for row in h.logits] if collect else None


def serve_arms(torch, mx, np_params, cfg, what, held=0, binding=None,
               geometry=GEOMETRY, collect=False):
    """serve's requests at full width through two engines on the same
    prompts: the eager arm (``MXNET_DECODE_DONATE=0``) first, then the
    main path, the captured engine, with the kernel counts set to 0
    before it is built (its warm-up and capture are in the counted run).
    Each arm: wall, tokens/s, step p50, TTFT, peak GB, a profiled steady
    window and the first-step logits of three prompts; the captured arm
    also its step graph's replay ms and recorded launches.  ``held``
    blocks are taken off each engine's free list first (of
    ``geometry["num_blocks"]``); ``binding(exe, what)`` checks each step
    executor.  The captured arm's checks: the
    witnesses, ``check_captured``, ``check_graph_window``, streams equal
    to the eager arm's, first-step logits held by ``hold_arms``.  With
    ``collect`` the eager arm's requests collect every step's logits
    rows (``step_logits``; that arm's wall then includes their
    readback).
    Returns the two arms' results, the prompt lengths and the new tokens
    a request."""
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.kernels import (LAUNCHES, PLAIN_CALLS,
                                         reset_counts)
    from mxnet_tpu_torch.weights import convert_params
    new = 32
    lengths = SERVE_LENGTHS
    prompts = _serve_prompts(cfg, SEED, lengths)
    arms = {}
    for arm in ("eager", "graph"):
        gc_collect(torch)
        t0 = time.perf_counter()
        if arm == "graph":
            reset_counts()
        params = convert_params(np_params, mx.gpu(0), cfg)
        with (serving_eager() if arm == "eager"
              else contextlib.nullcontext()):
            eng = DecodeEngine(params, cfg, ctx=mx.gpu(0), warmup=True,
                               **geometry)
        del params
        torch.cuda.synchronize()
        res = {"setup_s": time.perf_counter() - t0}
        if binding is not None:
            binding(eng._exe, what)
        held_ids = eng.cache.alloc(held) if held else []
        check(sorted(held_ids) == list(range(held)),
              "%s: the free list did not hand out the lowest ids first"
              % what)
        try:
            torch.cuda.reset_peak_memory_stats()
            outs, wall, ttft, st, rows = _serve_requests(
                torch, eng, prompts, new, collect and arm == "eager")
            res["step_logits"] = rows
            res.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if arm == "graph":
                res["launches"] = dict(LAUNCHES)
                res["plain_calls"] = dict(PLAIN_CALLS)
                check_captured(what, [eng._exe], LAUNCHES, PLAIN_CALLS)
                res["recorded"] = eng._exe.captured_launches()
                res["recorded_by_dtype"] = eng._exe.captured_launches(True)
                res["step_replay_ms"] = step_replay_ms(torch, eng._exe,
                                                       eng._step_lock)
            res["window"] = engine_window(torch, eng, cfg, SEED + 20)
            logits = first_step_logits(eng, prompts[2:5])
            if arm == "graph":
                res.update(hold_arms(torch, what, eng, logits,
                                     arms["eager"]["logits"], prompts[2]))
        finally:
            eng.cache.free(held_ids)
            eng.stop()
        steps = st["steps"]
        res.update(outs=outs, logits=logits, stats=st, wall_s=wall,
                   steps=steps, prefill_chunks=st["prefill_chunks"],
                   decode_tokens_per_s=len(outs) * new / wall,
                   step_ms_p50=st["step_ms_p50"],
                   ttft_ms_p50=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
                   device_ms_per_step=res["window"]["device_ms_per_step"],
                   idle_share=1 - res["window"]["device_ms_per_step"]
                   / st["step_ms_p50"])
        arms[arm] = res
        del eng
    g, e = arms["graph"], arms["eager"]
    check(g["outs"] == e["outs"], "%s: the captured engine's streams differ "
          "from the eager arm's" % what)
    check_witnesses(what, g["stats"])
    check_graph_window(what, g["window"])
    return g, e, lengths, new


def arm_summary(res, keys=("setup_s", "wall_s", "steps", "decode_tokens_per_s",
                           "step_ms_p50", "ttft_ms_p50", "ttft_ms_max",
                           "device_ms_per_step", "idle_share", "peak_mem_gb",
                           "step_replay_ms", "window",
                           "first_step_logits_bit_equal",
                           "max_abs_logit_diff", "first_differing_op")):
    return {k: res[k] for k in keys if k in res}


def gc_collect(torch):
    """Drop an earlier engine's executors, graphs and pools before the
    next arm (peak memory per arm)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_serve(torch, mx, np_params):
    """serve (4): ``serve_arms`` at full width in f32.  The captured
    engine's step graph records 12 decode, 12 chunk and 50 LayerNorm
    launches (one replay a step), the wrappers launched nothing beyond
    its warm-up and capture, every request finishes with its count, the
    resubmitted one repeats its stream, the streams equal the eager
    arm's.  Returns the counted run's wrapper launches, the steps, and
    the launches the step graph records (one step's)."""
    g, e, lengths, new = serve_arms(torch, mx, np_params, FULL, "serve")
    outs, steps = g["outs"], g["steps"]
    check(all(len(o) == new for o in outs),
          "serve: a request finished with %s tokens, not %d"
          % ([len(o) for o in outs], new))
    check(outs[-1] == outs[0], "serve: the resubmitted request gave another "
          "stream")
    want = {"paged_decode_attend": 12, "paged_chunk_prefill_attend": 12,
            "layernorm_fused": 50}
    rec = g["recorded"]
    check(all(rec.get(k, 0) == w for k, w in want.items()),
          "serve: the step graph records %s (want %s a step)" % (rec, want))
    emit({"phase": "serve", "config": FULL, "geometry": GEOMETRY,
          "requests": len(outs), "prompt_lengths": lengths + lengths[:1],
          "new_tokens_each": new, **arm_summary(g),
          "prefill_chunks": g["prefill_chunks"],
          "launches": {k: v for k, v in g["launches"].items() if v},
          "recorded_per_step": rec,
          "graph_launches": {k: v * steps for k, v in rec.items()},
          "plain_calls": {k: v for k, v in g["plain_calls"].items() if v},
          "witnesses": {k: g["stats"][k] for k in WITNESS_KEYS},
          "eager_arm": arm_summary(e), "streams_equal_eager_arm": True,
          "deterministic_resubmit": True})
    return g["launches"], steps, rec


def margin_cut(ref_toks, ref_logits, toks, what):
    """Hold a greedy stream against a reference stream and its
    per-step logits: they must be equal, except that from a step where
    the reference's top-2 logit margin is within 1e-4 (plus 1e-4
    relative) the two may part, and the comparison stops there.
    Returns ``(steps compared, [step, margin] or None)``."""
    for t, (a, b) in enumerate(zip(ref_toks, toks)):
        if a != b:
            top2 = np.sort(ref_logits[t])[-2:]
            margin = float(top2[1] - top2[0])
            check(margin <= 1e-4 + 1e-4 * abs(float(top2[1])),
                  "%s: greedy tokens differ at step %d at a top-2 margin of "
                  "%g" % (what, t, margin))
            return t, [t, margin]
    n = min(len(ref_toks), len(toks))
    check(len(toks) == len(ref_toks), "%s: %d tokens against the "
          "reference's %d" % (what, len(toks), len(ref_toks)))
    return n, None


def _hold_streams(what, got, ref):
    """Two card runs of one engine kind, ``[(tokens, logits rows)]`` per
    request: equal streams, logits bit-equal at every step, or else
    within rtol 1e-4 / atol 1e-4.  Returns (bit-equal, max abs diff)."""
    check([g[0] for g in got] == [r[0] for r in ref],
          "%s: greedy streams differ" % what)
    worst, equal = 0.0, True
    for (_, gl), (_, rl) in zip(got, ref):
        for a, b in zip(gl, rl):
            equal = equal and np.array_equal(a, b)
            worst = max(worst, float(np.abs(a - b).max()))
            check(np.allclose(a, b, rtol=1e-4, atol=1e-4),
                  "%s: logits differ (max abs err %g)"
                  % (what, float(np.abs(a - b).max())))
    return equal, worst


def _two_engines(torch, mx, np_params, cfg, prompts, warm):
    """Two captured engines stepping at once on their own threads.
    ``warm``: both captured by ``warmup()`` first, and this thread keeps
    synchronizing the card while they step; else neither is warmed up,
    so each captures at its first step on its own thread, and this
    thread only waits (CUDA refuses a device-wide synchronize while any
    stream captures).  Returns each engine's streams and logits, stats
    and captures, and the synchronizes made."""
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.weights import convert_params
    params = convert_params(np_params, mx.gpu(0), cfg)
    engs = [DecodeEngine(params, cfg, ctx=mx.gpu(0), warmup=warm,
                         **GEOMETRY) for _ in range(2)]
    try:
        hs = [[e.submit(p, max_new_tokens=8, collect_logits=True)
               for p in prompts] for e in engs]
        syncs = 0
        while warm and not all(h.done() for row in hs for h in row):
            torch.cuda.synchronize()
            syncs += 1
            time.sleep(0.001)
        runs = [[(h.result(timeout=900), h.logits) for h in row]
                for row in hs]
        return runs, [e.stats() for e in engs], \
            [e._exe.captures for e in engs], syncs
    finally:
        for e in engs:
            e.stop()


def _swap_while_serving(mx, np_params, new_np, cfg, prompts):
    """A captured engine serves the prompts on the old weights, then again
    with ``swap_params`` to ``new_np`` made while those run, then once
    more (with logits) on the new weights; returns the three runs, the
    stats and the captures."""
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.weights import convert_params
    eng = DecodeEngine(convert_params(np_params, mx.gpu(0), cfg), cfg,
                       ctx=mx.gpu(0), warmup=True, **GEOMETRY)
    try:
        old = [eng.generate(p, max_new_tokens=8, timeout=900)
               for p in prompts]
        mid = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.swap_params(convert_params(new_np, mx.gpu(0), cfg),
                        version="swapped")
        mid = [h.result(timeout=900) for h in mid]
        hs = [eng.submit(p, max_new_tokens=8, collect_logits=True)
              for p in prompts]
        after = [(h.result(timeout=900), h.logits) for h in hs]
        return old, mid, after, eng.stats(), eng._exe.captures
    finally:
        eng.stop()


def _capture_cases(torch, mx):
    """Donated forwards at the edges of capture, on the card.  Two that
    cannot be captured: one whose walk reads a device value on the host
    (its FullyConnected wrapped to sum its output into a float) and one
    whose walk draws random numbers; each forward raises ``MXNetError``
    naming the symbol and the cause, twice in a row (nothing falls back
    to the eager walk, and a failed capture leaves the next one able to
    run), and captures nothing.  One that captures again: a bound weight
    replaced (``_set_data``) makes the next forward capture once more (a
    retrace) into the pool the first graph holds, donation turned off
    runs the eager walk and turned on again replays with no capture;
    every output equals a fresh executor's.  Returns the messages and
    the counts."""
    import copy
    sym = mx.sym
    data = sym.Variable("data")
    x = np.random.RandomState(SEED + 31).standard_normal((4, 16)) \
        .astype(np.float32)
    out = {}
    for case in ("host_read", "random_draw"):
        net = data + sym.random_uniform(low=0, high=1, shape=(4, 16),
                                        name="draw") \
            if case == "random_draw" else data
        net = sym.FullyConnected(net, num_hidden=8, name="fc_" + case)
        exe = net.simple_bind(ctx=mx.gpu(0), grad_req="null", data=(4, 16))
        if case == "host_read":
            node = [n for n in exe._plan.nodes if not n.is_var][-1]
            op = copy.copy(node.op)
            inner = op.fn

            def reading(*args, _inner=inner, **kw):
                res = _inner(*args, **kw)
                float(res.sum())
                return res
            op.fn = reading
            node.op = op
        exe.donate_args(["data"])
        for attempt in range(2):
            try:
                exe.forward(is_train=False, data=x)
                msg = None
            except mx.MXNetError as exc:
                msg = str(exc)
            cause = "stream is capturing" if case == "host_read" \
                else "draws random numbers"
            check(msg is not None and "fc_" + case in msg and cause in msg,
                  "capture (%s): forward %d gave %r, not an MXNetError "
                  "naming the symbol and %r" % (case, attempt, msg, cause))
        check(exe.captures == 0, "capture (%s): %d captures"
              % (case, exe.captures))
        out[case] = msg[:300]
    net = sym.FullyConnected(data, num_hidden=8, name="fc_recapture")
    exe, ref = (net.simple_bind(ctx=mx.gpu(0), grad_req="null",
                                data=(4, 16)) for _ in range(2))
    w = np.random.RandomState(SEED + 32).standard_normal((8, 16)) \
        .astype(np.float32)
    for e in (exe, ref):
        e.copy_params_from({"fc_recapture_weight": w,
                            "fc_recapture_bias": np.zeros(8, np.float32)})
    exe.donate_args(["data"])
    steps = []
    for step, what in enumerate(("capture", "replace", "off", "on")):
        if what == "replace":
            nd = exe.arg_dict["fc_recapture_weight"]
            nd._set_data(nd._data.clone())
        exe.donate_args([] if what == "off" else ["data"])
        xs = x + np.float32(step)
        got = exe.forward(is_train=False, data=xs)[0].asnumpy()
        want = ref.forward(is_train=False, data=xs)[0].asnumpy()
        check(np.array_equal(got, want), "capture (recapture, %s): the "
              "donated forward differs from a fresh executor's" % what)
        steps.append([what, exe.captures, exe.retraces])
    check(steps == [["capture", 1, 0], ["replace", 2, 1], ["off", 2, 1],
                    ["on", 2, 1]],
          "capture (recapture): captures and retraces %s" % steps)
    out["recapture"] = steps
    torch.cuda.synchronize()
    return out


def phase_agreement(torch, mx):
    """agreement (5): the engine at 2 layers over 3 requests on the card
    (captured), on the card with ``MXNET_DECODE_DONATE=0`` (eager) and on
    the CPU.  Card against CPU: per-step logits within rtol 1e-4 / atol
    1e-4 and greedy streams under the margin rule.  Captured against
    eager on the card: equal streams and bit-equal logits at every step
    (else within rtol/atol 1e-4, with the first op whose bits part named
    by ``first_differing_op``, which runs either way).  Two captured
    engines stepping at once on two threads (``_two_engines``: warmed up
    while this thread synchronizes, and capturing at their first steps):
    each gives the single engine's streams and logits.  A
    ``swap_params`` while requests run: the requests served after it
    equal an eager engine's on the new weights, and nothing is captured
    again.  ``_capture_cases``: a donated forward that cannot be
    captured raises, every time; one whose bound weight is replaced
    captures again."""
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.weights import convert_params
    cfg = dict(FULL, num_layers=2)
    np_params = seeded_params(cfg)
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, cfg["num_classes"], n).tolist()
               for n in (40, 100, 150)]
    runs, probe = {}, None
    for name, ctx in (("card", mx.gpu(0)), ("card_eager", mx.gpu(0)),
                      ("cpu", mx.cpu())):
        with (serving_eager() if name == "card_eager"
              else contextlib.nullcontext()):
            eng = DecodeEngine(convert_params(np_params, ctx, cfg), cfg,
                               ctx=ctx, **GEOMETRY)
        try:
            hs = [eng.submit(p, max_new_tokens=8, collect_logits=True)
                  for p in prompts]
            runs[name] = [(h.result(timeout=900), h.logits) for h in hs]
            if name == "card":
                check_witnesses("agreement", eng.stats())
                with eng._step_lock:
                    probe = first_differing_op(torch, eng._exe,
                                               probe_feeds(eng, prompts[0]))
        finally:
            eng.stop()
    worst, compared, cut = 0.0, 0, []
    for r, ((gt, gl), (ct, cl)) in enumerate(zip(runs["card"], runs["cpu"])):
        n, at = margin_cut(ct, cl, gt, "agreement: request %d" % r)
        for t, (a, b) in enumerate(zip(gl[:n + 1], cl[:n + 1])):
            check(np.allclose(a, b, rtol=1e-4, atol=1e-4),
                  "agreement: request %d step %d logits differ (max abs err "
                  "%g)" % (r, t, float(np.abs(a - b).max())))
            worst = max(worst, float(np.abs(a - b).max()))
        compared += min(n + 1, len(gl))
        if at:
            cut.append([r] + at)
    arms_equal, arms_diff = _hold_streams(
        "agreement (captured against eager%s)" % (
            "" if probe is None else ", first differing op %s" % probe),
        runs["card"], runs["card_eager"])
    two_info = {}
    for warm in (True, False):
        two, two_st, two_caps, syncs = _two_engines(torch, mx, np_params,
                                                    cfg, prompts, warm)
        what = "agreement (two engines, %s)" % (
            "warmed up" if warm else "capturing on their threads")
        for i, (got, st) in enumerate(zip(two, two_st)):
            _hold_streams("%s, engine %d" % (what, i), got, runs["card"])
            check_witnesses("%s, engine %d" % (what, i), st)
        check(two_caps == [1, 1], "%s: captures %s" % (what, two_caps))
        two_info["warmed_up" if warm else "capturing"] = {
            "streams_equal_single": True, "captures": two_caps,
            "synchronizes_meanwhile": syncs}
    rs = np.random.RandomState(SEED + 30)
    new_np = {n: (v + rs.standard_normal(v.shape).astype(np.float32)
                  * np.float32(0.01)) for n, v in np_params.items()}
    old, mid, after, sw_st, sw_caps = _swap_while_serving(
        mx, np_params, new_np, cfg, prompts)
    check(old == [r[0] for r in runs["card"]],
          "agreement (swap): the streams before the swap differ")
    check(all(len(m) == 8 for m in mid), "agreement (swap): a request "
          "served across the swap finished early")
    with serving_eager():
        eng = DecodeEngine(convert_params(new_np, mx.gpu(0), cfg), cfg,
                           ctx=mx.gpu(0), **GEOMETRY)
    try:
        hs = [eng.submit(p, max_new_tokens=8, collect_logits=True)
              for p in prompts]
        swapped_ref = [(h.result(timeout=900), h.logits) for h in hs]
    finally:
        eng.stop()
    swap_equal, _ = _hold_streams("agreement (swap against an eager engine "
                                  "on the new weights)", after, swapped_ref)
    check(sw_caps == 1 and sw_st["steady_state_retraces"] == 0
          and sw_st["model_version"] == "swapped",
          "agreement (swap): captures %d, stats %s" % (sw_caps, sw_st))
    emit({"phase": "agreement", "config": cfg, "requests": len(prompts),
          "steps_compared": compared, "max_abs_logit_err": worst,
          "streams_equal": all(g[0] == c[0] for g, c in
                               zip(runs["card"], runs["cpu"])),
          "cut_at_small_margin": cut,
          "captured_vs_eager": {"logits_bit_equal": arms_equal,
                                "max_abs_logit_diff": arms_diff,
                                "first_differing_op": probe},
          "two_engines": two_info,
          "swap_while_serving": {"streams_equal_eager_new_weights": True,
                                 "logits_bit_equal": swap_equal,
                                 "captures": sw_caps,
                                 "streams_changed": after[0][0] != old[0]},
          "capture_cases": _capture_cases(torch, mx)})


# ----------------------------------------------------------------------
# one-shot prefill, the decode step and speculative decoding
# ----------------------------------------------------------------------
def _prefill_inputs(torch, g, B, S, H, D, nb, bs, M, lengths):
    """Seeded q/k/v/caches, a scrambled table (each row's real blocks
    from one permutation, its padding entries out-of-range ids) and
    the lengths."""
    q, k, v = (torch.randn(B, S, H, D, generator=g) for _ in range(3))
    kc = torch.randn(nb, bs, H, D, generator=g)
    vc = torch.randn(nb, bs, H, D, generator=g)
    perm = torch.randperm(nb, generator=g).to(torch.int32)
    table = torch.randint(nb, 4 * nb, (B, M), generator=g,
                          dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        nblk = -(-n // bs)
        table[b, :nblk] = perm[used:used + nblk]
        used += nblk
    return q, k, v, kc, vc, table, torch.tensor(lengths, dtype=torch.int32)


def phase_prefill(torch, mxk, dev, flush):
    """The one-shot prefill kernel against its plain version on all S
    output rows (rtol 1e-4 / atol 1e-5) and on the cache bytes (exact,
    the rows it must not write included), at the served shape and an
    odd one (S = 1000, a table wider than S needs), with f32 and bf16
    caches, and with bf16 q/k/v (rtol 2**-7, at least one bf16 ulp of
    the plain value, / atol 1e-5: each rounds an f32 result to bf16
    once), and f16 q/k/v over f16 caches (rtol 2**-10, close_f16) at the
    served shape, whose row of length 1024 attends a full 1024-token
    context, and at the head_dims of PAGED_BF16_DIMS; two runs
    bit-identical;
    timed beside
    ``scaled_dot_product_attention(is_causal=True)`` on the same q/k/v
    as (B, H, S, D) views (the attention alone, without the scatter),
    bounded by bytes or by operations at the split-TF32 peak (the
    CUDA-core bound beside).  First prints ptxas's lines of the kernel's
    instances (q/k/v and cache types, head_dim forms; no spills
    allowed)."""
    import ctypes
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import _build
    lib = _build.load("paged_attention")
    lib.mx_paged_prefill_smem.argtypes = [ctypes.c_int] * 2
    lib.mx_paged_prefill_smem.restype = ctypes.c_size_t
    ptx = _instances_ptxas("paged_attention",
                           r"paged_prefill_kernelI\w+?Lb[01]E",
                           "the f32 attention kernel",
                           lambda key: lib.mx_paged_prefill_smem(128, 0))
    check(len(ptx) == 6, "paged_attention: %d split-TF32 prefill instances, "
          "not 6 (head_dim forms x 3 type pairs; bf16/bf16 runs the bf16 "
          "kernel)" % len(ptx))
    ptx_bf16 = _instances_ptxas("paged_attention",
                                r"paged_prefill16_kernelI13__nv_bfloat16Lb[01]E",
                                "the bf16 attention kernel",
                                lambda key: lib.mx_paged_prefill_smem(128, 1))
    check(len(ptx_bf16) == 2, "paged_attention: %d bf16 prefill instances, "
          "not 2 (head_dim forms)" % len(ptx_bf16))
    ptx_f16 = _instances_ptxas("paged_attention",
                               r"paged_prefill16_kernelI6__halfLb[01]E",
                               "the f16 attention kernel",
                               lambda key: lib.mx_paged_prefill_smem(128, 1))
    check(len(ptx_f16) == 2, "paged_attention: %d f16 prefill instances, "
          "not 2 (head_dim forms)" % len(ptx_f16))
    B, S, H, D, nb, bs, M = 8, 1024, 16, 128, 512, 16, 64
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    served = [20, 960, 0, 1024, 513, 77, 300, 641]
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    # (shape, lengths, q/k/v dtype, cache dtype)
    cases = [((B, S, H, D, nb, bs, M), served, f32, f32),
             ((3, 1000, H, D, nb, bs, 70), [1000, 0, 457], f32, f32),
             ((2, 300, H, D, nb, bs, 20), [300, 129], f32, bf16),
             ((2, 300, H, D, nb, bs, 20), [300, 129], bf16, bf16),
             ((B, S, H, D, nb, bs, M), served, bf16, bf16)] + \
        [((2, 300, 2048 // d_ if d_ > 128 else 4, d_, 64, bs, 20),
          [300, 129], bf16, bf16) for d_ in PAGED_BF16_DIMS] + \
        [((B, S, H, D, nb, bs, M), served, f16, f16),
         ((2, 300, H, D, nb, bs, 20), [300, 129], f16, f16)] + \
        [((2, 300, 2048 // d_ if d_ > 128 else 4, d_, 64, bs, 20),
          [300, 129], f16, f16) for d_ in PAGED_BF16_DIMS]
    errs = []
    for (b_, s_, h_, d_, nb_, bs_, m_), lens, qdt, cdt in cases:
        q, k, v, kc0, vc0, table, L = (
            t.to(dev) for t in _prefill_inputs(torch, g, b_, s_, h_, d_, nb_,
                                               bs_, m_, lens))
        q, k, v = q.to(qdt), k.to(qdt), v.to(qdt)
        kc0, vc0 = kc0.to(cdt), vc0.to(cdt)
        rtol = {f32: RTOL, bf16: 2.0 ** -7, f16: F16_RTOL}[qdt]
        sc = 1.0 / d_ ** 0.5
        runs = []
        for fn in (mxk.paged_prefill_attend, mxk.paged_prefill_attend,
                   mxk.paged_prefill_attend_plain):
            kk, vk = kc0.clone(), vc0.clone()
            out, ko, vo = fn(q, k, v, kk, vk, table, L, scale=sc)
            check(ko is kk and vo is vk, "paged_prefill_attend: the caches "
                  "are not written in place")
            runs.append((out, kk, vk))
        torch.cuda.synchronize()
        (o1, k1, v1), (o2, k2, v2), (ref, kr, vr) = runs
        what = "paged_prefill_attend (B, S, M = %d, %d, %d, %s q/k/v, %s " \
            "caches)" % (b_, s_, m_, str(qdt).split(".")[-1],
                         str(cdt).split(".")[-1])
        check(torch.equal(o1, o2) and torch.equal(k1, k2)
              and torch.equal(v1, v2), what + ": two runs differ")
        check(torch.allclose(o1.float(), ref.float(), rtol=rtol, atol=ATOL),
              what + " disagrees with its plain version on the S rows (max "
              "abs err %g)" % max_err(o1, ref))
        check(torch.equal(k1, kr) and torch.equal(v1, vr),
              what + ": caches differ from the plain version's")
        touched = torch.zeros(nb_ * bs_, dtype=torch.bool)
        for b, n in enumerate(lens):
            for j in range(n):
                touched[int(table[b, j // bs_]) * bs_ + j % bs_] = True
        touched = touched.to(dev)
        check(torch.equal(k1.view(nb_ * bs_, -1)[~touched],
                          kc0.view(nb_ * bs_, -1)[~touched])
              and torch.equal(v1.view(nb_ * bs_, -1)[~touched],
                              vc0.view(nb_ * bs_, -1)[~touched]),
              what + " wrote outside the rows below each length")
        errs.append((str(qdt), str(cdt), d_, max_err(o1, ref)))
    inputs = _prefill_inputs(torch, g, B, S, H, D, nb, bs, M, served)
    sc = 1.0 / D ** 0.5
    rows = sum(served)
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    timed = {}
    # f32, then the 16-bit kernel on the same values in bf16 and in f16
    # (q/k/v and caches), its bound at the dense 16-bit tensor-core peak
    for dt, peak in ((f32, SPLIT_TF32_FLOPS_PER_S), (bf16, BF16_FLOPS_PER_S),
                     (f16, BF16_FLOPS_PER_S)):
        q, k, v, kc, vc = (t.to(dev).to(dt) for t in inputs[:5])
        table, L = (t.to(dev) for t in inputs[5:])
        size = q.element_size()
        ms = time_ms(torch, lambda: mxk.paged_prefill_attend(
            q, k, v, kc, vc, table, L, scale=sc), flush)
        plain_ms = time_ms(torch, lambda: mxk.paged_prefill_attend_plain(
            q, k, v, kc, vc, table, L, scale=sc), flush, reps=20)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, scale=sc), flush)
        nbytes = 4 * B * S * H * D * size + 2 * rows * H * D * size \
            + B * (M + 1) * 4
        b_ms, b_by = bound(nbytes, flops, peak)
        timed[str(dt)] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "bytes": nbytes,
                          "bound_cuda_cores_ms": bound(nbytes, flops)[0],
                          "tflops": flops / ms / 1e9}
    res = {"name": "paged_prefill_attend", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
           "replaces": "mxnet_tpu/pallas/attention.py:209",
           "max_abs_err": max(e for t, _, _, e in errs if t == str(f32)),
           **timed[str(f32)],
           "bound_peak": "split TF32, %g TFLOP/s"
                         % (SPLIT_TF32_FLOPS_PER_S / 1e12)}
    rows16 = []
    for h16 in (bf16, f16):
        bt = timed[str(h16)]
        rows16.append({
            "name": "paged_prefill_attend", "route": "cuda",
            "dtype": str(h16)[6:],
            "source": "mxnet_tpu_torch/csrc/paged_attention.cu "
                      "(on csrc/attention_bf16.cuh)",
            "replaces": "mxnet_tpu/pallas/attention.py:209",
            "max_abs_err": max(e for t, c, _, e in errs
                               if t == c == str(h16)),
            **{k: bt[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "tflops")},
            "f32_instance_ms": res["ms"],
            "errors_by_head_dim": {d_: e for t, c, d_, e in errs
                                   if t == c == str(h16)}})
    res_bf16, res_f16 = rows16
    emit({"phase": "kernel", **res, "shapes": {
        "q": [B, S, H, D], "cache": [nb, bs, H, D], "table": [B, M],
        "lengths": served}, "checked": [[c[0][0], c[0][1], c[0][6],
                                          str(c[2]), str(c[3])]
                                         for c in cases],
        "timed": timed, "bf16": res_bf16, "f16": res_f16, "ptxas": ptx,
        "ptxas_bf16": ptx_bf16, "ptxas_f16": ptx_f16,
        "library_call": "F.scaled_dot_product_attention(is_causal=True) on "
                        "(B, H, S, D) views: the attention alone, without "
                        "the cache scatter"})
    return [res, res_bf16, res_f16]


def _serve_prompts(cfg, seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg["num_classes"], n).tolist() for n in lengths]


def _reference_streams(mx, params, cfg, ctx, prompts, new):
    """Greedy streams and per-step logits of the mixed-step engine."""
    from mxnet_tpu_torch.decode import DecodeEngine
    eng = DecodeEngine(params, cfg, ctx=ctx, **GEOMETRY)
    try:
        hs = [eng.submit(p, max_new_tokens=new, collect_logits=True)
              for p in prompts]
        return [(h.result(timeout=900), h.logits) for h in hs]
    finally:
        eng.stop()


def bind_prefill_pair(mx, params, cfg, ctx, batch, prefill_len):
    """The decode-step and prefill executors, the second bound with
    ``shared_exec`` so both hold the same weight and cache tensors."""
    from mxnet_tpu_torch.models import transformer
    geo = dict(block_size=GEOMETRY["block_size"],
               num_blocks=GEOMETRY["num_blocks"])
    M = -(-cfg["seq_len"] // GEOMETRY["block_size"])
    dexe = transformer.get_decode_step_symbol(**geo, **cfg).simple_bind(
        ctx=ctx, grad_req="null", data=(batch, 1), positions=(batch, 1),
        block_table=(batch, M))
    dexe.copy_params_from(params)
    pexe = transformer.get_prefill_symbol(
        prefill_len=prefill_len, **geo, **cfg).simple_bind(
        ctx=ctx, grad_req="null", shared_exec=dexe, data=(batch, prefill_len),
        prompt_len=(batch,), block_table=(batch, M))
    check(all(pexe.arg_dict[n] is dexe.arg_dict[n] for n in dexe.arg_dict
              if n not in ("data", "positions")),
          "prefill pair: the executors do not share weights and caches")
    return dexe, pexe


def run_prefill_pair(torch, dexe, pexe, prompts, new, on_card,
                     forced=None, donate=False):
    """Prefill ``prompts`` in one forward, then ``new - 1`` decode-step
    forwards, each fed the greedy tokens of the step before, or with
    ``forced`` (per request, ``new`` token ids) the forced tokens
    instead (teacher forcing).  With ``donate`` both executors donate
    their caches (captured forwards on the card), and each window starts
    with an untimed forward on its first feeds, which the timed one
    repeats (the same cache bytes): the prefill's and the decode step's
    warm-up and capture.  Returns per request (tokens, logits per step),
    the prefill wall ms, the decode steps' wall ms, the table, and the
    kernel counts ``(launches, plain calls, launches by dtype)`` of the
    prefill window and of the decode window, each set to 0 just before
    that window."""
    from mxnet_tpu_torch.kernels import (LAUNCHES, LAUNCHES_BY_DTYPE,
                                         PLAIN_CALLS, reset_counts)
    B, S = pexe.arg_dict["data"].shape
    M = dexe.arg_dict["block_table"].shape[1]
    bs = GEOMETRY["block_size"]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    data = np.zeros((B, S), np.float32)
    table = np.zeros((B, M), np.float32)
    lens = np.array([len(p) for p in prompts], np.float32)
    blocks = np.random.RandomState(SEED + 10).permutation(
        GEOMETRY["num_blocks"])
    used = 0
    for b, p in enumerate(prompts):
        data[b, :len(p)] = p
        n = -(-(len(p) + new) // bs)
        table[b, :n] = blocks[used:used + n]
        used += n
    if donate:
        caches = [n for n in dexe.arg_dict if n.endswith("_cache")]
        dexe.donate_args(caches)
        pexe.donate_args(caches)
    feeds = dict(data=data, prompt_len=lens, block_table=table)
    sync()
    reset_counts()
    if donate:
        pexe.forward(is_train=False, **feeds)
        sync()
    t0 = time.perf_counter()
    outs = pexe.forward(is_train=False, **feeds)
    tok = outs[1].asnumpy().astype(np.int64)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = {"prefill": (dict(LAUNCHES), dict(PLAIN_CALLS),
                          dict(LAUNCHES_BY_DTYPE))}
    reset_counts()
    logits = [[row] for row in outs[0].asnumpy()]
    toks = [[int(t)] for t in tok]

    def step_feeds(t, tok):
        if forced is not None:
            tok = np.array([f[t] for f in forced], np.int64)
        return dict(data=tok.reshape(B, 1),
                    positions=(lens + t).reshape(B, 1), block_table=table)
    if donate:
        dexe.forward(is_train=False, **step_feeds(0, tok))
        sync()
    step_ms = []
    for t in range(new - 1):
        f = step_feeds(t, tok)
        sync()
        t0 = time.perf_counter()
        outs = dexe.forward(is_train=False, **f)
        tok = outs[1].asnumpy().astype(np.int64)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for b, row in enumerate(outs[0].asnumpy()):
            logits[b].append(row)
            toks[b].append(int(tok[b]))
    counts["decode"] = (dict(LAUNCHES), dict(PLAIN_CALLS),
                        dict(LAUNCHES_BY_DTYPE))
    return list(zip(toks, logits)), prefill_ms, step_ms, table, counts


def pair_window(torch, dexe, got, lens, table, steps=4):
    """``profiled`` over decode steps 0..steps-1 of a pair run again (the
    same tokens at the same positions: the same cache bytes), each with
    its token readback."""
    B = len(got)

    def run():
        for t in range(steps):
            tok = np.array([g[0][t] for g in got], np.float32)
            outs = dexe.forward(is_train=False, data=tok.reshape(B, 1),
                                positions=(lens + t).reshape(B, 1),
                                block_table=table)
            outs[1].asnumpy()
        return steps
    return profiled(torch, run)


def prefill_arms(torch, mx, np_params, cfg, ctx, what, binding=None):
    """The decode-step and prefill executors bound as a pair
    (``shared_exec``), serve's 8 prompts prefilled in one forward and 31
    decode steps, in two arms: eager, then donated (both executors
    capture, into one graph pool).  Per arm: prefill ms, decode p50,
    peak GB allocated and reserved; the donated arm also its recorded
    launches and a profiled window of 4 decode steps.  The donated
    arm's streams equal the eager arm's and its prefill logits are
    bit-equal (else within rtol/atol 1e-4, the first differing op
    named).  ``binding(exe, name)`` checks each bound executor."""
    from mxnet_tpu_torch.weights import convert_params
    on_card = ctx.device_type == "gpu"
    lengths = SERVE_LENGTHS
    prompts = _serve_prompts(cfg, SEED, lengths)
    new = 32
    lens = np.array(lengths, np.float32)
    arms = {}
    for arm in ("eager", "graph"):
        if on_card:
            gc_collect(torch)
        params = convert_params(np_params, ctx, cfg)
        dexe, pexe = bind_prefill_pair(mx, params, cfg, ctx, len(prompts),
                                       cfg["seq_len"])
        del params
        if binding is not None:
            binding(dexe, "%s (decode step)" % what)
            binding(pexe, "%s (prefill)" % what)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        got, prefill_ms, step_ms, table, counts = run_prefill_pair(
            torch, dexe, pexe, prompts, new, on_card,
            donate=arm == "graph")
        res = {"got": got, "counts": counts, "prefill_ms": prefill_ms,
               "decode_step_ms_p50": statistics.median(step_ms),
               "decode_step_ms": step_ms,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
               if on_card else None,
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9
               if on_card else None}
        if arm == "graph":
            check(pexe._graph_pool is dexe._graph_pool,
                  "%s: the pair does not share a graph pool" % what)
            res["recorded_prefill"] = pexe.captured_launches()
            res["recorded_decode"] = dexe.captured_launches()
            res["recorded_prefill_by_dtype"] = pexe.captured_launches(True)
            res["recorded_decode_by_dtype"] = dexe.captured_launches(True)
            check_captured("%s (prefill window)" % what, [pexe],
                           counts["prefill"][0], counts["prefill"][1])
            check_captured("%s (decode window)" % what, [dexe],
                           counts["decode"][0], counts["decode"][1])
            if on_card:
                res["window"] = pair_window(torch, dexe, got, lens, table)
                check_graph_window(what, res["window"])
            res["logits_equal"] = all(
                np.array_equal(g[1][0], e[1][0])
                for g, e in zip(got, arms["eager"]["got"]))
            if not res["logits_equal"]:
                feeds = dict(data=np.zeros(pexe.arg_dict["data"].shape,
                                           np.float32),
                             prompt_len=lens, block_table=table)
                for b, p in enumerate(prompts):
                    feeds["data"][b, :len(p)] = p
                res["first_differing_op"] = first_differing_op(
                    torch, pexe, feeds)
            res["max_abs_logit_diff"] = max(
                float(np.abs(a - b).max()) for g, e in
                zip(got, arms["eager"]["got"]) for a, b in zip(g[1], e[1]))
            check([g[0] for g in got] == [e[0] for e in arms["eager"]["got"]],
                  "%s: the donated pair's streams differ from the eager "
                  "pair's" % what)
            check(all(np.allclose(g[1][0], e[1][0], rtol=1e-4, atol=1e-4)
                      for g, e in zip(got, arms["eager"]["got"])),
                  "%s: prefill logits differ from the eager pair's (first "
                  "differing op %s)" % (what, res.get("first_differing_op")))
        arms[arm] = res
        del dexe, pexe
    return arms, lengths, prompts, new


def _pair_summary(res):
    return {k: res[k] for k in ("prefill_ms", "decode_step_ms_p50",
                                "peak_mem_gb", "peak_reserved_gb", "window",
                                "logits_equal", "max_abs_logit_diff",
                                "first_differing_op", "recorded_prefill",
                                "recorded_decode") if k in res}


def phase_serve_prefill(torch, mx, np_params, cfg=FULL, ctx=None):
    """serve_prefill (17): ``prefill_arms`` at full width in f32.  The
    eager pair's prefill forward launches the prefill kernel 12 times
    and LayerNorm 25, each decode step the decode kernel 12 and LayerNorm
    25; the donated pair's graphs record the same (prefill and decode
    step), and the wrappers launch nothing beyond their warm-ups and
    captures; no plain version runs; the greedy streams equal the
    mixed-step engine's on the same prompts under the margin rule.
    Returns the donated prefill window's wrapper launches and the
    launches its graph records."""
    from mxnet_tpu_torch.weights import convert_params
    ctx = ctx or mx.gpu(0)
    L, new = cfg["num_layers"], 32
    prompts = _serve_prompts(cfg, SEED, SERVE_LENGTHS)
    ref = _reference_streams(mx, convert_params(np_params, ctx, cfg), cfg,
                             ctx, prompts, new)
    arms, lengths, prompts, new = prefill_arms(torch, mx, np_params, cfg,
                                               ctx, "serve_prefill")
    steps = new - 1
    (pl, pp, _), (launches, plain, _) = arms["eager"]["counts"]["prefill"], \
        arms["eager"]["counts"]["decode"]
    check(pl["paged_prefill_attend"] == L and pl["layernorm_fused"] == 2 * L
          + 1 and pl["paged_decode_attend"] == 0,
          "serve_prefill: the prefill forward launched %s (want %d prefill, "
          "%d LayerNorm)" % (pl, L, 2 * L + 1))
    check(launches["paged_decode_attend"] == L * steps
          and launches["layernorm_fused"] == (2 * L + 1) * steps
          and launches["paged_prefill_attend"] == 0,
          "serve_prefill: %d decode steps launched %s (want %d decode, %d "
          "LayerNorm each)" % (steps, launches, L, 2 * L + 1))
    check(not any(pp.values()) and not any(plain.values()),
          "serve_prefill: plain versions ran on the main path: %s %s"
          % (pp, plain))
    g = arms["graph"]
    want_p = {"paged_prefill_attend": L, "layernorm_fused": 2 * L + 1}
    want_d = {"paged_decode_attend": L, "layernorm_fused": 2 * L + 1}
    check(g["recorded_prefill"] == want_p and g["recorded_decode"] == want_d,
          "serve_prefill: the graphs record %s and %s (want %s, %s)"
          % (g["recorded_prefill"], g["recorded_decode"], want_p, want_d))
    cut = []
    for r, ((gt, _), (rt, rl)) in enumerate(zip(g["got"], ref)):
        _, at = margin_cut(rt, rl, gt, "serve_prefill: request %d" % r)
        if at:
            cut.append([r] + at)
    worst = max(float(np.abs(a - b).max()) for (_, gl), (_, rl)
                in zip(g["got"], ref) for a, b in zip(gl[:1], rl[:1]))
    emit({"phase": "serve_prefill", "config": cfg, "prompt_lengths": lengths,
          "prefill_len": cfg["seq_len"], "new_tokens_each": new,
          **_pair_summary(g), "decode_steps": steps,
          "decode_step_ms": g["decode_step_ms"],
          "prefill_launches": {k: v for k, v in
                               g["counts"]["prefill"][0].items() if v},
          "decode_launches_per_step": g["recorded_decode"],
          "eager_arm": {**_pair_summary(arms["eager"]),
                        "prefill_launches": {k: v for k, v in pl.items()
                                             if v},
                        "decode_launches_per_step": {
                            k: v / steps for k, v in launches.items() if v}},
          "first_token_max_abs_logit_diff_vs_engine": worst,
          "streams_equal_engine": all(g_[0] == r[0] for g_, r in
                                      zip(g["got"], ref)),
          "cut_at_small_margin": cut})
    return g["counts"]["prefill"][0], g["recorded_prefill"]


def _repeating_prompts(cfg, seed, n, motif_lens, repeats):
    """Prompts whose tails repeat an earlier n-gram: a random motif
    repeated, after a random head, so the n-gram drafter proposes."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        motif = rng.randint(0, cfg["num_classes"],
                            motif_lens[i % len(motif_lens)]).tolist()
        head = rng.randint(0, cfg["num_classes"], 16 + 8 * i).tolist()
        out.append(head + motif * repeats)
    return out


def spec_arms(torch, mx, np_params, cfg, what, accept_min, dtype=None):
    """``DecodeEngine(spec_k=4)`` at full width, per drafter (n-gram: 8
    requests with repeating tails, 32 new tokens each; draft model: the
    target's own weights on 4 of them, 16 new tokens each) in two arms on
    the same prompts: eager (``MXNET_DECODE_DONATE=0``) first, then
    captured, with the counts set to 0 before it is built.  The captured
    arm: the witnesses; the spec step's graph records the chunk kernel
    2L times and LayerNorm 4L + 2 (the decode kernel never), each draft
    span program of K tokens L * K flash forwards, the wrappers launched
    nothing beyond the warm-ups and captures (every span length captured
    by ``warmup()``), the draft graphs ran L flash forwards a proposed
    token, no plain version; a profiled steady window (one graph launch a
    step and one a proposal, no kernel launch call, one readback each);
    streams equal the eager arm's, first-step logits bit-equal (else
    held at 1e-4, the first differing op named).  With ``dtype`` (a
    16-bit type's name) every count above is of that type's instances
    and the executors bind it (``_check_16bit_binding``).  Returns per drafter the captured
    arm's results, with the eager arm's under ``"eager_arm"``."""
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.kernels import (LAUNCHES, PLAIN_CALLS,
                                         reset_counts)
    from mxnet_tpu_torch.weights import convert_params
    L, spec_k = cfg["num_layers"], 4
    prompts = _repeating_prompts(cfg, SEED + 11, 8, (5, 8, 12, 3), 6)
    sfx = ":" + dtype if dtype else ""
    out = {}
    for drafter, n_req, n_new, kw in (
            ("ngram", 8, 32, dict(spec_impl="ngram")),
            ("draft", 4, 16, dict(spec_impl="draft", draft_params=np_params,
                                  draft_config=cfg))):
        tag = "%s (%s)" % (what, drafter)
        arms = {}
        for arm in ("eager", "graph"):
            gc_collect(torch)
            if arm == "graph":
                reset_counts()
            with (serving_eager() if arm == "eager"
                  else contextlib.nullcontext()):
                eng = DecodeEngine(convert_params(np_params, mx.gpu(0), cfg),
                                   cfg, ctx=mx.gpu(0), spec_k=spec_k,
                                   warmup=True, **kw, **GEOMETRY)
            res = {}
            try:
                if dtype:
                    _check_16bit_binding(eng._exe, tag, dtype)
                drafts = list(getattr(eng._drafter, "_exes", {}).items())
                exes = [eng._exe] + [e for _, e in drafts]
                d0 = [e.dispatches for e in exes]
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                hs = [eng.submit(p, max_new_tokens=n_new)
                      for p in prompts[:n_req]]
                outs = [h.result(timeout=900) for h in hs]
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                st = eng.stats()
                res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
                if arm == "graph":
                    check_captured(tag, exes, LAUNCHES, PLAIN_CALLS)
                    check_witnesses(tag, st)
                    rec = eng._exe.captured_launches(True) if dtype \
                        else eng._exe.captured_launches()
                    want = {"paged_chunk_prefill_attend" + sfx: 2 * L,
                            "layernorm_fused" + sfx: 4 * L + 2}
                    check(rec == want, "%s: the spec step's graph records "
                          "%s (want %s)" % (tag, rec, want))
                    res["recorded_per_step"] = eng._exe.captured_launches()
                    res["launches"] = dict(LAUNCHES)
                    for k, e in drafts:
                        r = e.captured_launches(True) if dtype \
                            else e.captured_launches()
                        check(r.get("flash_attention_fwd" + sfx) == L * k,
                              "%s: the %d-token span graph records %s"
                              % (tag, k, r))
                    if drafts:
                        flash = graph_launches(exes[1:], d0[1:]).get(
                            "flash_attention_fwd", 0)
                        check(flash == L * st["spec_proposed"],
                              "%s: the draft graphs ran %d flash forwards "
                              "for %d proposed tokens (want %d each)"
                              % (tag, flash, st["spec_proposed"], L))
                        res["draft_flash_launches"] = flash
                    res["step_replay_ms"] = step_replay_ms(torch, eng._exe,
                                                           eng._step_lock)
                res["window"] = engine_window(torch, eng, cfg, SEED + 21,
                                              exes=exes)
                logits = first_step_logits(eng, prompts[:3])
                if arm == "graph":
                    win = res["window"]
                    check_graph_window(tag, win, win["dispatches_per_step"])
                    res.update(hold_arms(torch, tag, eng, logits,
                                         arms["eager"]["logits"], prompts[0]))
            finally:
                eng.stop()
            check(st["spec_impl"] == drafter and st["spec_proposed"] > 0,
                  "%s: no draft was proposed (%s)" % (tag, st))
            if drafter == "draft":
                check(st["accept_rate"] >= accept_min,
                      "%s: accept rate %s < %s with the target as its own "
                      "draft model" % (tag, st["accept_rate"], accept_min))
            res.update(outs=outs, logits=logits, stats=st, steps=st["steps"],
                       requests=n_req, new_tokens_each=n_new, wall_s=wall,
                       tokens_per_s=n_req * n_new / wall,
                       step_ms_p50=st["step_ms_p50"],
                       device_ms_per_step=res["window"]["device_ms_per_step"],
                       idle_share=1 - res["window"]["device_ms_per_step"]
                       / st["step_ms_p50"],
                       tokens_per_launch=st["tokens_per_launch"],
                       accept_rate=st["accept_rate"],
                       spec_proposed=st["spec_proposed"],
                       spec_accepted=st["spec_accepted"])
            arms[arm] = res
            del eng
        g, e = arms["graph"], arms["eager"]
        check(g["outs"] == e["outs"], "%s: the captured engine's streams "
              "differ from the eager arm's" % tag)
        g["eager_arm"] = e
        out[drafter] = g
    return out, prompts


SPEC_KEYS = ("requests", "new_tokens_each", "steps", "wall_s", "tokens_per_s",
             "step_ms_p50", "device_ms_per_step", "idle_share", "peak_mem_gb",
             "step_replay_ms", "window", "tokens_per_launch", "accept_rate",
             "spec_proposed", "spec_accepted", "recorded_per_step",
             "draft_flash_launches", "first_step_logits_bit_equal",
             "max_abs_logit_diff", "first_differing_op")


def _spec_summary(res):
    return {**{k: res[k] for k in SPEC_KEYS if k in res},
            "eager_arm": {k: res["eager_arm"][k] for k in SPEC_KEYS
                          if k in res["eager_arm"]},
            "streams_equal_eager_arm": True}


def phase_serve_spec(torch, mx, np_params, cfg=FULL, ctx=None):
    """serve_spec (18): ``spec_arms`` at full width in f32; the streams
    equal the mixed-step engine's under the margin rule; the draft
    arm's accept rate is at least 0.9.  Returns the n-gram arm's
    counted launches, steps and the launches its step graph records."""
    from mxnet_tpu_torch.weights import convert_params
    ctx = ctx or mx.gpu(0)
    new = 32
    arms, prompts = spec_arms(torch, mx, np_params, cfg, "serve_spec", 0.9)
    ref = _reference_streams(mx, convert_params(np_params, ctx, cfg), cfg,
                             ctx, prompts, new)
    line = {}
    for arm, res in arms.items():
        cut = []
        for r, (got, (rt, rl)) in enumerate(zip(res["outs"], ref)):
            _, at = margin_cut(rt[:res["new_tokens_each"]], rl, got,
                               "serve_spec (%s): request %d" % (arm, r))
            if at:
                cut.append([r] + at)
        line[arm] = {**_spec_summary(res),
                     "streams_equal_engine": all(
                         o == r[0][:res["new_tokens_each"]]
                         for o, r in zip(res["outs"], ref)),
                     "cut_at_small_margin": cut}
    emit({"phase": "serve_spec", "config": cfg, "spec_k": 4,
          "prompt_lengths": [len(p) for p in prompts], **line})
    ng = arms["ngram"]
    return ng["launches"], ng["steps"], ng["recorded_per_step"]


def phase_prefill_agreement(torch, mx, ctxs=None):
    """The prefill/decode-step pair at 2 layers on the card and on the
    CPU from the same numpy weights: prefill logits (rtol 1e-4 / atol
    1e-4), the cache rows the prefill wrote (rtol 1e-4 / atol 1e-5) and
    the decode streams under the margin rule, with their logits within
    the same bound up to the cut."""
    from mxnet_tpu_torch.weights import convert_params
    cfg = dict(FULL, num_layers=2)
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    np_params = seeded_params(cfg)
    prompts = _serve_prompts(cfg, SEED + 12, (40, 100, 150))
    new, S = 8, 256
    runs = []
    for ctx in ctxs:
        dexe, pexe = bind_prefill_pair(mx, convert_params(np_params, ctx,
                                                          cfg), cfg, ctx,
                                       len(prompts), S)
        got, _, _, table, _ = run_prefill_pair(
            torch, dexe, pexe, prompts, new, ctx.device_type == "gpu")
        caches = [dexe.arg_dict["layer%d_%s_cache" % (i, kv)].asnumpy()
                  for i in range(cfg["num_layers"]) for kv in "kv"]
        runs.append((got, caches))
        del dexe, pexe
    (gg, gc), (cg, cc) = runs
    worst, cut = 0.0, []
    for r, ((gt, gl), (ct, cl)) in enumerate(zip(gg, cg)):
        n, at = margin_cut(ct, cl, gt, "prefill_agreement: request %d" % r)
        for t, (a, b) in enumerate(zip(gl[:n + 1], cl[:n + 1])):
            check(np.allclose(a, b, rtol=1e-4, atol=1e-4),
                  "prefill_agreement: request %d step %d logits differ "
                  "(max abs err %g)" % (r, t, float(np.abs(a - b).max())))
            worst = max(worst, float(np.abs(a - b).max()))
        if at:
            cut.append([r] + at)
    bs = GEOMETRY["block_size"]
    rows = [int(table[b, j // bs]) * bs + j % bs
            for b, p in enumerate(prompts) for j in range(len(p))]
    cache_err = 0.0
    for a, b in zip(gc, cc):
        a, b = a.reshape(-1, a.shape[2] * a.shape[3])[rows], \
            b.reshape(-1, b.shape[2] * b.shape[3])[rows]
        check(np.allclose(a, b, rtol=1e-4, atol=1e-5),
              "prefill_agreement: prefilled cache rows differ (max abs err "
              "%g)" % float(np.abs(a - b).max()))
        cache_err = max(cache_err, float(np.abs(a - b).max()))
    emit({"phase": "prefill_agreement", "config": cfg, "prefill_len": S,
          "prompt_lengths": [len(p) for p in prompts], "new_tokens": new,
          "max_abs_logit_err": worst, "max_abs_cache_err": cache_err,
          "streams_equal": all(g[0] == c[0] for g, c in zip(gg, cg)),
          "cut_at_small_margin": cut})


# ----------------------------------------------------------------------
# bf16 serving (ROADMAP A.1): the engine, the prefill pair and the spec
# engine at full width in bf16, and each held against the CPU
# ----------------------------------------------------------------------
SERVE_KERNELS = ("paged_decode_attend", "paged_chunk_prefill_attend",
                 "paged_prefill_attend", "layernorm_fused",
                 "flash_attention_fwd")


def _by_dtype(by_dtype, dtype="bfloat16"):
    """The serving kernels' launches counted under ``dtype``."""
    return {n: by_dtype.get(n + ":" + dtype, 0) for n in SERVE_KERNELS}


def _check_16bit_binding(exe, what, dtype):
    """A 16-bit serving executor: weights, LayerNorms and caches in
    ``dtype`` (a name), the embeddings f32, the index inputs f32 (bf16
    would round them past 256, f16 past 2048)."""
    import torch
    half = getattr(torch, dtype)
    types = {n: nd._data.dtype for n, nd in exe.arg_dict.items()}
    bad = [n for n, t in types.items()
           if t != (half if n.startswith(("layer", "ln_f", "lm_head"))
                    else torch.float32)]
    check(not bad, "%s: unexpected bound types %s"
          % (what, {n: str(types[n]) for n in bad}))


# the 16-bit serve phases' settings by type: the config, the blocks held
# off the free list (so block ids pass the largest integer the type holds
# exactly), the cache's geometry, the short name in phase names and the
# logits bound
SERVE16 = {
    "bfloat16": dict(cfg=BF16_SERVE, held=SERVE_BF16_RESERVED,
                     geometry=GEOMETRY, short="bf16",
                     logits_l2=BF16_AGREE["logits_l2"]),
    "float16": dict(cfg=F16_SERVE, held=SERVE_F16_RESERVED,
                    geometry=dict(GEOMETRY, num_blocks=SERVE_F16_BLOCKS),
                    short="f16", logits_l2=F16_AGREE["logits_l2"])}


def _binding16(dtype):
    """``serve_arms``' and ``prefill_arms``' binding check for ``dtype``."""
    return lambda exe, what: _check_16bit_binding(exe, what, dtype)


def _all_finite(rows):
    """Every logits row finite (f16 overflows past 65504 to inf, which
    the cast to f32 keeps)."""
    return all(bool(np.isfinite(r).all()) for r in rows)


def _serve16(torch, mx, np_params, dtype):
    """serve_bf16 (32) and serve_f16 (38): ``serve_arms`` for the
    full-width LM in ``dtype`` on the mixed step, with SERVE16's blocks
    held off the free list first, so every block id the requests get
    passes the largest integer the type holds exactly (their chunk starts
    and positions pass it too).  Every request finishes with its count,
    the resubmitted one repeats its stream, the step graph records the
    decode and chunk kernels 12 times and LayerNorm 50, all on their
    ``dtype`` instances, and no plain version runs.  In f16 the eager
    arm collects every step's logits (its streams equal the captured
    arm's): every row finite.  Returns the counted run's wrapper
    launches, the steps and the launches the step graph records."""
    st16 = SERVE16[dtype]
    cfg, short, geo = st16["cfg"], st16["short"], st16["geometry"]
    what = "serve_" + short
    g, e, lengths, new = serve_arms(torch, mx, np_params, cfg, what,
                                    held=st16["held"],
                                    binding=_binding16(dtype), geometry=geo,
                                    collect=dtype == "float16")
    L, outs, steps = cfg["num_layers"], g["outs"], g["steps"]
    check(all(len(o) == new for o in outs),
          "%s: a request finished with %s tokens, not %d"
          % (what, [len(o) for o in outs], new))
    check(outs[-1] == outs[0], "%s: the resubmitted request gave another "
          "stream" % what)
    want = {"paged_decode_attend:" + dtype: L,
            "paged_chunk_prefill_attend:" + dtype: L,
            "layernorm_fused:" + dtype: 4 * L + 2}
    check(g["recorded_by_dtype"] == want,
          "%s: the step graph records %s (want %s a step)"
          % (what, g["recorded_by_dtype"], want))
    line = {}
    if dtype == "float16":
        rows = e["step_logits"]
        check(_all_finite(rows), "%s: a step's logits are not finite" % what)
        line = {"logits_rows_checked": len(rows), "all_logits_finite": True,
                "largest_logit": max(float(np.abs(row).max())
                                     for row in rows)}
    emit({"phase": what, "config": cfg, "geometry": geo,
          "requests": len(outs), "prompt_lengths": lengths + lengths[:1],
          "new_tokens_each": new, "block_ids_from": st16["held"],
          "largest_chunk_start": max((n - 1) // geo["chunk_tokens"]
                                     * geo["chunk_tokens"]
                                     for n in lengths),
          **arm_summary(g), "prefill_chunks": g["prefill_chunks"],
          "launches": {k: v for k, v in g["launches"].items() if v},
          "recorded_per_step": g["recorded"],
          short + "_recorded_per_step": g["recorded_by_dtype"],
          "graph_launches": {k: v * steps for k, v in g["recorded"].items()},
          "plain_calls": {k: v for k, v in g["plain_calls"].items() if v},
          "witnesses": {k: g["stats"][k] for k in WITNESS_KEYS},
          "eager_arm": arm_summary(e), "streams_equal_eager_arm": True,
          **line,
          "matmul_reduced_precision_reduction": getattr(
              torch.backends.cuda.matmul,
              "allow_%s_reduced_precision_reduction"
              % ("bf16" if dtype == "bfloat16" else "fp16"))})
    return g["launches"], steps, g["recorded"]


def phase_serve_bf16(torch, mx, np_params):
    return _serve16(torch, mx, np_params, "bfloat16")


def phase_serve_f16(torch, mx, np_params):
    return _serve16(torch, mx, np_params, "float16")


def _serve_prefill16(torch, mx, np_params, dtype, ctx=None):
    """serve_prefill_bf16 (33) and serve_prefill_f16 (39):
    ``prefill_arms`` at full width in ``dtype`` (one copy of the 16-bit
    weights and caches a pair): each prefill forward launches, and the
    donated prefill graph records, the prefill kernel 12 times and
    LayerNorm 25, each decode step the decode kernel 12 and LayerNorm 25,
    all in ``dtype``, no plain version; the first token's logits within
    SERVE16's relative L2 of the mixed-step engine's in the same type on
    the same prompts (streams compared and printed); in f16 every logits
    row of both the pair and the engine finite.  Returns the donated
    prefill window's wrapper launches and what its graph records."""
    from mxnet_tpu_torch.weights import convert_params
    st16 = SERVE16[dtype]
    cfg, short = st16["cfg"], st16["short"]
    what = "serve_prefill_" + short
    ctx = ctx or mx.gpu(0)
    L, new = cfg["num_layers"], 32
    prompts = _serve_prompts(cfg, SEED, SERVE_LENGTHS)
    ref = _reference_streams(mx, convert_params(np_params, ctx, cfg), cfg,
                             ctx, prompts, new)
    arms, lengths, prompts, new = prefill_arms(
        torch, mx, np_params, cfg, ctx, what, binding=_binding16(dtype))
    steps = new - 1
    e, g = arms["eager"], arms["graph"]
    (pl, pp, pb), (dl, dp, db) = e["counts"]["prefill"], e["counts"]["decode"]
    pb, db = _by_dtype(pb, dtype), _by_dtype(db, dtype)
    check(pb["paged_prefill_attend"] == pl["paged_prefill_attend"] == L
          and pb["layernorm_fused"] == pl["layernorm_fused"] == 2 * L + 1
          and pl["paged_decode_attend"] == 0,
          "%s: the prefill forward launched %s, %s %s" % (what, pl, short, pb))
    check(db["paged_decode_attend"] == dl["paged_decode_attend"] == L * steps
          and db["layernorm_fused"] == dl["layernorm_fused"]
          == (2 * L + 1) * steps and dl["paged_prefill_attend"] == 0,
          "%s: %d decode steps launched %s, %s %s"
          % (what, steps, dl, short, db))
    check(not any(pp.values()) and not any(dp.values()),
          "%s: plain versions ran on the main path: %s %s" % (what, pp, dp))
    want_p = {"paged_prefill_attend:" + dtype: L,
              "layernorm_fused:" + dtype: 2 * L + 1}
    want_d = {"paged_decode_attend:" + dtype: L,
              "layernorm_fused:" + dtype: 2 * L + 1}
    check(g["recorded_prefill_by_dtype"] == want_p
          and g["recorded_decode_by_dtype"] == want_d,
          "%s: the graphs record %s and %s (want %s, %s)"
          % (what, g["recorded_prefill_by_dtype"],
             g["recorded_decode_by_dtype"], want_p, want_d))
    first = [_rel_l2(a[1][0], r[1][0]) for a, r in zip(g["got"], ref)]
    check(max(first) <= st16["logits_l2"],
          "%s: first-token logits off the %s engine's by relative L2 %s"
          % (what, short, first))
    line = {}
    if dtype == "float16":
        check(all(_all_finite(a[1]) for a in g["got"] + e["got"])
              and all(_all_finite(r[1]) for r in ref),
              "%s: a step's logits are not finite" % what)
        line = {"all_logits_finite": True,
                "logits_rows_checked": sum(len(a[1]) for a in
                                           g["got"] + e["got"] + ref)}
    emit({"phase": what, "config": cfg,
          "prompt_lengths": lengths, "prefill_len": cfg["seq_len"],
          "new_tokens_each": new, **_pair_summary(g), "decode_steps": steps,
          "decode_step_ms": g["decode_step_ms"],
          "prefill_launches": {k: v for k, v in
                               g["counts"]["prefill"][0].items() if v},
          "prefill_%s_recorded" % short: g["recorded_prefill_by_dtype"],
          "decode_launches_per_step": g["recorded_decode"],
          "eager_arm": {**_pair_summary(e),
                        "prefill_launches": {k: v for k, v in pl.items()
                                             if v},
                        "prefill_%s_launches" % short: pb,
                        "decode_launches_per_step": {
                            k: v / steps for k, v in dl.items() if v}},
          "first_token_logits_rel_l2_vs_engine": first, **line,
          "streams_equal_engine": [a[0] == r[0] for a, r in
                                   zip(g["got"], ref)]})
    return g["counts"]["prefill"][0], g["recorded_prefill"]


def phase_serve_prefill_bf16(torch, mx, np_params, ctx=None):
    return _serve_prefill16(torch, mx, np_params, "bfloat16", ctx)


def phase_serve_prefill_f16(torch, mx, np_params, ctx=None):
    return _serve_prefill16(torch, mx, np_params, "float16", ctx)


def _serve_spec16(torch, mx, np_params, dtype, ctx=None):
    """serve_spec_bf16 (34) and serve_spec_f16 (40): ``spec_arms`` at
    full width in ``dtype`` (every recorded count of its instances); the
    draft arm's accept rate at least 0.5 (the draft model's flash forward
    rounds P to one 16-bit term, the target's chunk kernel keeps two, so
    near-tie tokens may part); streams against the mixed-step engine in
    the same type printed; in f16 every logits row of that engine and the
    arms' first-step logits finite.  Returns the n-gram arm's counted
    launches, steps and its step graph's recorded launches, and the draft
    arm's results."""
    from mxnet_tpu_torch.weights import convert_params
    st16 = SERVE16[dtype]
    cfg, short = st16["cfg"], st16["short"]
    what = "serve_spec_" + short
    ctx = ctx or mx.gpu(0)
    arms, prompts = spec_arms(torch, mx, np_params, cfg, what, 0.5,
                              dtype=dtype)
    ref = _reference_streams(mx, convert_params(np_params, ctx, cfg), cfg,
                             ctx, prompts, 32)
    line = {}
    if dtype == "float16":
        check(all(_all_finite(r[1]) for r in ref)
              and all(_all_finite([lg for _, lg in r["logits"]])
                      for res in arms.values()
                      for r in (res, res["eager_arm"])),
              "%s: a step's logits are not finite" % what)
        line = {"all_logits_finite": True}
    emit({"phase": what, "config": cfg, "spec_k": 4,
          "prompt_lengths": [len(p) for p in prompts], **line,
          **{arm: {**_spec_summary(res),
                   "streams_equal_engine": [
                       o == r[0][:res["new_tokens_each"]]
                       for o, r in zip(res["outs"], ref)]}
             for arm, res in arms.items()}})
    ng = arms["ngram"]
    return ng["launches"], ng["steps"], ng["recorded_per_step"], \
        arms["draft"]


def phase_serve_spec_bf16(torch, mx, np_params, ctx=None):
    return _serve_spec16(torch, mx, np_params, "bfloat16", ctx)


def phase_serve_spec_f16(torch, mx, np_params, ctx=None):
    return _serve_spec16(torch, mx, np_params, "float16", ctx)


def _ulps(a, b, bits=7):
    """The largest difference between two 16-bit tensors in ulps at the
    scale of ``b`` (the ulp of its largest magnitude; ``bits`` fraction
    bits: 7 for bf16, 10 for f16): later layers' caches see inputs that
    already differ by a rounding, so elementwise ulps of values near
    zero would count noise far below the cache's resolution."""
    a, b = a.float(), b.float()
    top = float(b.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - bits) if top else 2.0 ** -133
    return float((a - b).abs().max()) / ulp


def _bind_step(mx, params, cfg, ctx, spec_k):
    """The mixed step (``spec_k`` 0) or the spec step bound as the engine
    binds it, at serve's geometry, with ``params`` copied in."""
    from mxnet_tpu_torch.models import transformer
    C, K, bs = (GEOMETRY[k] for k in ("capacity", "chunk_tokens",
                                      "block_size"))
    M = -(-cfg["seq_len"] // bs)
    S = spec_k + 1
    shapes = dict(data=(C, S), positions=(C, S), block_table=(C, M),
                  chunk_data=(1, K), chunk_positions=(1, K),
                  chunk_start=(1,), chunk_len=(1,), chunk_table=(1, M))
    geo = dict(block_size=bs, num_blocks=GEOMETRY["num_blocks"])
    if spec_k:
        shapes.update(span_start=(C,), span_len=(C,))
        sym = transformer.get_spec_step_symbol(**geo, **cfg)
    else:
        sym = transformer.get_mixed_step_symbol(**geo, **cfg)
    exe = sym.simple_bind(ctx=ctx, grad_req="null", **shapes)
    exe.copy_params_from({n: v for n, v in params.items()
                          if n in exe.arg_dict})
    return exe


def _drive_step(exe, prompts, forced, spec_k):
    """Teacher-forced drive of a bound mixed or spec step: each prompt
    through the chunk stream, a chunk a forward (the decode rows
    inactive), then the ``forced`` tokens of every slot together, one a
    forward on the mixed step or ``spec_k + 1`` a forward as spans on the
    spec step (every span token a forced one).  The blocks come from a
    fixed permutation of the cache, so ids pass 256.  Returns per prompt
    the f32 logits rows (the chunk head's first token, then one row per
    forced token but the last) and the cache rows written."""
    C, S = exe.arg_dict["data"].shape
    K = exe.arg_dict["chunk_data"].shape[1]
    M = exe.arg_dict["block_table"].shape[1]
    bs = GEOMETRY["block_size"]
    new = len(forced[0])
    blocks = np.random.RandomState(SEED + 13).permutation(
        GEOMETRY["num_blocks"])
    table = np.zeros((C, M), np.float32)
    used = 0
    for b, p in enumerate(prompts):
        n = -(-(len(p) + new + S) // bs)
        table[b, :n] = blocks[used:used + n]
        used += n

    def idle():
        f = dict(data=np.zeros((C, S), np.float32),
                 positions=np.full((C, S), -1.0 if not spec_k else 0.0,
                                   np.float32),
                 block_table=table.copy(),
                 chunk_data=np.zeros((1, K), np.float32),
                 chunk_positions=np.zeros((1, K), np.float32),
                 chunk_start=np.zeros((1,), np.float32),
                 chunk_len=np.zeros((1,), np.float32),
                 chunk_table=np.zeros((1, M), np.float32))
        if spec_k:
            f.update(span_start=np.zeros((C,), np.float32),
                     span_len=np.zeros((C,), np.float32))
        return f

    logits = [[] for _ in prompts]
    for b, p in enumerate(prompts):
        for s0 in range(0, len(p), K):
            n = min(K, len(p) - s0)
            f = idle()
            f["chunk_data"][0, :n] = p[s0:s0 + n]
            f["chunk_positions"][0, :n] = np.arange(s0, s0 + n)
            f["chunk_start"][0], f["chunk_len"][0] = s0, n
            f["chunk_table"][0] = table[b]
            outs = exe.forward(is_train=False, **f)
        logits[b].append(outs[2].asnumpy()[0])
    for t0 in range(0, new - 1, S):
        n = min(S, new - 1 - t0)
        f = idle()
        for b, p in enumerate(prompts):
            pos = len(p) + t0
            f["data"][b, :n] = forced[b][t0:t0 + n]
            f["positions"][b, :n] = np.arange(pos, pos + n)
            if spec_k:
                f["span_start"][b], f["span_len"][b] = pos, n
        rows = exe.forward(is_train=False, **f)[0].asnumpy()
        for b in range(len(prompts)):
            logits[b] += [rows[b * S + j] for j in range(n)]
    written = [int(table[b, j // bs]) * bs + j % bs
               for b, p in enumerate(prompts) for j in range(len(p) + new - 1)]
    return logits, written


def _cache_ulps(exes, layers, written, bits=7):
    """Per layer, the largest difference in ulps (``_ulps``: bf16's by
    default) between the card's and the CPU's cache rows ``written`` (K
    and V)."""
    out = []
    for i in range(layers):
        worst = 0
        for kv in "kv":
            a, b = (e.arg_dict["layer%d_%s_cache" % (i, kv)]._data.cpu()
                    for e in exes)
            a, b = (t.reshape(-1, t.shape[2] * t.shape[3])[written]
                    for t in (a, b))
            worst = max(worst, _ulps(a, b, bits))
        out.append(worst)
    return out


def phase_serve_bf16_agreement(torch, mx, ctxs=None):
    return _agreement16(torch, mx, "bfloat16", ctxs)


def phase_serve_f16_agreement(torch, mx, ctxs=None):
    return _agreement16(torch, mx, "float16", ctxs)


def _agreement16(torch, mx, dtype, ctxs=None):
    """serve_bf16_agreement (35) and serve_f16_agreement (40): the
    16-bit serving paths at 2 layers (full width), card against CPU from
    the same numpy weights: the mixed step, the spec step (spec_k 4) and
    the prefill/decode-step pair, each driven with the card engine's
    greedy tokens forced on both sides (teacher forcing): every logits
    row within relative L2 of the CPU's (bf16 2e-2, BF16_AGREE; f16
    2.5e-3, F16_AGREE), every cache row written within one ulp of the
    type at the cache's scale (``_ulps``).  The CPU's own greedy token
    at each forced position (the argmax of its logits row) is compared
    with the card's: equal at every position is the CPU's greedy stream
    equal to the card's (the same prefix gives the same next token), and
    f16 checks it, for every arm.  bf16 runs each path on the card twice,
    under PyTorch's default ``allow_bf16_reduced_precision_reduction``
    (True, the port's setting) and with it off, since the TPU sums bf16
    products in f32; f16 runs the default only."""
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.weights import convert_params
    agree = BF16_AGREE if dtype == "bfloat16" else F16_AGREE
    short = SERVE16[dtype]["short"]
    bits = 7 if dtype == "bfloat16" else 10
    flag_name = "allow_%s_reduced_precision_reduction" \
        % ("bf16" if dtype == "bfloat16" else "fp16")
    cfg = dict(SERVE16[dtype]["cfg"], num_layers=agree["num_layers"])
    card, cpu = ctxs or (mx.gpu(0), mx.cpu())
    L, new = cfg["num_layers"], agree["new"]
    np_params = seeded_params(cfg)
    prompts = _serve_prompts(cfg, SEED + 12, (40, 100, 150))
    spec_prompts = _repeating_prompts(cfg, SEED + 14, 3, (5, 8, 3), 6)
    params = {ctx: convert_params(np_params, ctx, cfg) for ctx in (card, cpu)}
    # the card engines' greedy streams: the tokens every drive forces
    streams = {}
    for arm, ps, kw in (("mixed", prompts, {}),
                        ("spec", spec_prompts,
                         dict(spec_k=4, spec_impl="ngram"))):
        eng = DecodeEngine(params[card], cfg, ctx=card, **kw, **GEOMETRY)
        try:
            streams[arm] = [eng.generate(p, max_new_tokens=new, timeout=900)
                            for p in ps]
        finally:
            eng.stop()

    def drive(ctx, ps, forced, spec_k):
        """Logits rows (row i of a request predicts its token i), the
        executor holding the caches, the cache rows written."""
        if spec_k is None:
            dexe, pexe = bind_prefill_pair(mx, params[ctx], cfg, ctx, len(ps),
                                           256)
            got, _, _, table, _ = run_prefill_pair(
                torch, dexe, pexe, ps, new, ctx.device_type == "gpu",
                forced=forced)
            bs = GEOMETRY["block_size"]
            return [g[1] for g in got], dexe, [
                int(table[b, j // bs]) * bs + j % bs
                for b, p in enumerate(ps) for j in range(len(p) + new - 1)]
        exe = _bind_step(mx, params[ctx], cfg, ctx, spec_k)
        lg, written = _drive_step(exe, ps, forced, spec_k)
        return lg, exe, written

    matmul = torch.backends.cuda.matmul
    default = getattr(matmul, flag_name)
    flags = (default, not default) \
        if card.device_type == "gpu" and dtype == "bfloat16" else (default,)
    res = {}
    for arm, ps, spec_k in (("mixed", prompts, 0),
                            ("spec", spec_prompts, 4),
                            ("prefill_pair", prompts, None)):
        forced = streams["spec" if arm == "spec" else "mixed"]
        ref, ref_exe, written = drive(cpu, ps, forced, spec_k)
        cpu_greedy = [[int(np.argmax(row)) for row in rows] for rows in ref]
        greedy_equal = cpu_greedy == [f[:len(r)] for f, r in
                                      zip(forced, cpu_greedy)]
        res[arm] = {"cpu_greedy_equal_card": greedy_equal}
        if dtype == "float16":
            check(greedy_equal, "serve_f16_agreement (%s): the CPU's greedy "
                  "tokens under forcing %s differ from the card's %s"
                  % (arm, cpu_greedy, forced))
        for flag in flags:
            setattr(matmul, flag_name, flag)
            try:
                got, exe, _ = drive(card, ps, forced, spec_k)
            finally:
                setattr(matmul, flag_name, default)
            l2 = [_rel_l2(a, b) for ga, ca in zip(got, ref)
                  for a, b in zip(ga, ca)]
            ulps = _cache_ulps((exe, ref_exe), L, written, bits)
            what = "serve_%s_agreement (%s, reduced-precision reduction " \
                "%s)" % (short, arm, flag)
            check(max(l2) <= agree["logits_l2"],
                  "%s: logits off the CPU's by relative L2 %g"
                  % (what, max(l2)))
            check(max(ulps) <= agree["cache_ulps"],
                  "%s: cache rows off the CPU's by %s %s ulps (per layer)"
                  % (what, ulps, short))
            if dtype == "float16":
                check(all(_all_finite(ga) for ga in got),
                      "%s: logits not finite" % what)
            res[arm]["reduced_precision_reduction_%s" % flag] = {
                "rows_compared": len(l2), "max_logits_rel_l2": max(l2),
                "cache_ulps_by_layer": ulps}
            del exe
        del ref_exe
    emit({"phase": "serve_%s_agreement" % short, "config": cfg,
          "prompt_lengths": [len(p) for p in prompts],
          "spec_prompt_lengths": [len(p) for p in spec_prompts],
          "new_tokens": new, **res, "card_greedy_streams": streams,
          "port_setting_reduced_precision_reduction": default})


# ----------------------------------------------------------------------
# training kernels
# ----------------------------------------------------------------------
def _ln_bwd_hold(torch, mxk, dev, g, rows, cols, dtype, errs):
    """LayerNorm backward on seeded (rows, cols) inputs in ``dtype``, with
    and without a residual: two runs bit-identical, against the plain
    version (f32: dx at rtol 1e-4 / atol 1e-5, dgamma and dbeta at atol
    2e-4, see phase_layernorm_bwd; bf16: close_bf16; f16: rtol 2^-10,
    one f16 ulp, with the f32 atols, see phase_layernorm_bwd_f16).
    Records each max abs error in ``errs``; returns whether the strict
    f32 bound held."""
    x, res, dy = (torch.randn(rows, cols, generator=g).to(dev).to(dtype)
                  for _ in range(3))
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(dtype)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(dtype)
    strict = True
    for r in (None, res):
        tag = "%d x %d%s" % (rows, cols, ", residual" if r is not None else "")
        _, mean, rstd = mxk.layernorm_plain(x, gamma, beta, residual=r)
        got = mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy, residual=r)
        again = mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy, residual=r)
        ref = mxk.layernorm_bwd_plain(x, gamma, mean, rstd, dy, residual=r)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "layernorm_fused_bwd %s (%s): two runs differ" % (dtype, tag))
        for a, b, what in zip(got, ref, ("dx", "dgamma", "dbeta")):
            atol = ATOL if what == "dx" else 2e-4
            if dtype == torch.float32:
                ok = bool(torch.allclose(a, b, rtol=RTOL, atol=atol))
                strict = strict and close(torch, a, b)
            elif dtype == torch.float16:
                ok = bool(torch.allclose(a.float(), b.float(),
                                         rtol=F16_RTOL, atol=atol))
            else:
                ok = close_bf16(torch, a, b)
            check(ok, "layernorm_fused_bwd %s %s (%s) disagrees with its "
                  "plain version (max abs err %g)"
                  % (dtype, what, tag, max_err(a, b)))
            errs["%s %s" % (what, tag)] = max_err(a, b)
    return strict


def phase_layernorm_bwd(torch, mxk, dev, flush):
    """LayerNorm backward at the training shape.  dx is held at rtol
    1e-4 / atol 1e-5.  dgamma and dbeta are sums over 4096 rows whose
    partial sums reach ~64 in magnitude, taken in another order than the
    plain version's: their rounding error is of order 1e-5 whatever the
    size of the result, so they are held at rtol 1e-4 / atol 2e-4, and
    whether the strict bound held too is printed.  Also held, with and
    without a residual and two runs bit-identical, at the widths of
    LN_BWD_EDGES (one to eight warps a row, a ragged row end, a width off
    the 16-byte vector, the looped form, the widest row the wrapper
    takes)."""
    rows, cols = 4096, 2048
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    errs = {}
    strict = _ln_bwd_hold(torch, mxk, dev, g, rows, cols, torch.float32, errs)
    for r_e, c_e in LN_BWD_EDGES:
        strict = _ln_bwd_hold(torch, mxk, dev, g, r_e, c_e, torch.float32,
                              errs) and strict
    x = torch.randn(rows, cols, generator=g).to(dev)
    dy = torch.randn(rows, cols, generator=g).to(dev)
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev)
    _, mean, rstd = mxk.layernorm_plain(x, gamma, beta)
    fn = lambda: mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy)
    ms = time_ms(torch, fn, flush)
    plain_ms = time_ms(torch, lambda: mxk.layernorm_bwd_plain(
        x, gamma, mean, rstd, dy), flush)
    m2, r2 = mean.reshape(rows, 1), rstd.reshape(rows, 1)
    lib_ms = time_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [cols], m2, r2, gamma, beta, [True, True, True]), flush)
    # x and dy read, dx written, gamma and the stats read, dgamma/dbeta
    # written; ~12 flops per element
    nbytes = 3 * rows * cols * 4 + 3 * cols * 4 + 2 * rows * 4
    b_ms, b_by = bound(nbytes, 12 * rows * cols)
    out = {"name": "layernorm_fused_bwd", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/layernorm.cu",
           "replaces": "mxnet_tpu/pallas/layernorm.py:158",
           "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    emit({"phase": "kernel", **out, "rows": rows, "cols": cols,
          "back_to_back_ms": pipelined_ms(torch, fn),
          "share_of_bound": b_ms / ms, "gbps": nbytes / ms / 1e6,
          "ptxas": _instances_ptxas("layernorm",
                                    r"layernorm_bwd_\w+?_kernelI\w+?E(?=Ev)",
                                    "the LayerNorm backward"),
          "errors": errs, "strict_tolerance_held": strict,
          "deterministic": True, "edges": [list(e) for e in LN_BWD_EDGES],
          "library_call": "aten.native_layer_norm_backward"})
    return out


def _library_kernels(torch, fn):
    """Names of the device kernels one call of ``fn`` launches (one
    torch.profiler pass): the library yardstick's route."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")})


def phase_flash(torch, mxk, dev, flush):
    """Causal flash attention in f32 (split TF32 on the tensor cores,
    attention_f32.cuh) at the training shape, at the edges of
    FLASH_F32_EDGES (ragged S, D % 4 != 0), and the forward at the draft
    model's batch 1: each kernel against its plain version on the same
    inputs (rtol 1e-4 / atol 1e-5), and FlashAttentionFn's output and
    gradients against autograd through the materialised reference.
    First prints ptxas's register, stack and spill lines of the three
    kernels (no spills allowed) and their shared memory, and the kernel
    SDPA launches in f32 (its route).  Timed beside SDPA, bounded by
    bytes or by operations at the split-TF32 peak (the CUDA-core bound
    printed beside).  Returns the three kernel rows."""
    import ctypes
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import _build
    lib = _build.load("flash_attention")
    lib.mx_flash_f32_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mx_flash_f32_smem.restype = ctypes.c_int
    which = {entry: w for entry, w in FLASH_F32_ENTRIES.values()}
    ptx = _instances_ptxas(
        "flash_attention", r"flash_\w+_f32_kernelI\w+?E(?=E)",
        "the f32 attention kernel",
        lambda key: lib.mx_flash_f32_smem(which[key.split("I")[0]], 128))
    B, H, S, D = 4, 16, 1024, 128
    sc = 1.0 / D ** 0.5
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(dev)
                   for _ in range(4))
    errs = {}

    def hold(pairs, tag=""):
        for what, a, b in pairs:
            check(close(torch, a, b), "flash attention %s%s disagrees with "
                  "its plain version (max abs err %g)"
                  % (what, tag, max_err(a, b)))
            errs[what + tag] = max_err(a, b)

    hold(_flash_pairs(torch, mxk, q, k, v, do, sc))
    for shape in FLASH_F32_EDGES:
        ins = [torch.randn(*shape, generator=g).to(dev) for _ in range(4)]
        hold(_flash_pairs(torch, mxk, *ins, 1.0 / shape[-1] ** 0.5),
             "_" + "x".join(map(str, shape)))
        del ins
    # the draft model's forward: batch 1 over the (1, seq_len) history
    q1, k1, v1 = (torch.randn(1, H, S, D, generator=g).to(dev)
                  for _ in range(3))
    hold(zip(("out_b1", "lse_b1"),
             mxk.flash_attention_fwd(q1, k1, v1, scale=sc),
             mxk.flash_attention_fwd_plain(q1, k1, v1, scale=sc)))
    del q1, k1, v1
    # the autograd Function end to end against the reference's autograd
    ends = []
    for fn in (mxk.flash_attention, mxk.flash_attention_plain):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins, scale=sc)
        ends.append([out.detach()] + list(torch.autograd.grad(out, ins, do)))
        del out, ins
    for what, a, b in zip(("out", "dq", "dk", "dv"), *ends):
        check(close(torch, a, b), "FlashAttentionFn %s disagrees with "
              "autograd through the reference (max abs err %g)"
              % (what, max_err(a, b)))
        errs["fn_" + what] = max_err(a, b)
    del ends
    sdpa = _library_kernels(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sc))
    rows = _flash_rows(torch, mxk, q, k, v, do, sc, flush, "float32",
                       SPLIT_TF32_FLOPS_PER_S)
    for r in rows:
        r["max_abs_err"] = max(errs.values())
        r["bound_peak"] = "split TF32, %g TFLOP/s" % (
            SPLIT_TF32_FLOPS_PER_S / 1e12)
        r["bound_cuda_cores_ms"] = bound(r["bytes"], r["flops"])[0]
        r["ptxas"] = {key: ptx[key] for key in ptx
                      if key.startswith(FLASH_F32_ENTRIES[r["name"]][0] + "I")}
    emit({"phase": "flash_fwd", **rows[0], "shape": [B, H, S, D],
          "edge_shapes": [list(e) for e in FLASH_F32_EDGES],
          "scale": sc, "errors": errs, "library_kernels": sdpa,
          "library_call": "F.scaled_dot_product_attention(is_causal=True)"})
    emit({"phase": "flash_bwd", "kernels": rows[1:], "shape": [B, H, S, D],
          "library_call": "autograd backward of F.scaled_dot_product_attention"
                          " (dq, dk and dv together: the library_ms of both "
                          "rows)"})
    return rows


# ----------------------------------------------------------------------
# training through Module.fit
# ----------------------------------------------------------------------
class FlatLabels:
    """An NDArrayIter whose (B, S) label batches are flattened to the
    (B * S,) next-token targets that SoftmaxOutput over the (B * S,
    vocab) logits takes."""

    def __init__(self, mx, it):
        self.mx, self.it = mx, it

    @property
    def provide_data(self):
        return self.it.provide_data

    @property
    def provide_label(self):
        return [self.mx.io.DataDesc(d.name, (d.shape[0] * d.shape[1],))
                for d in self.it.provide_label]

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        return self.mx.io.DataBatch(
            data=b.data, pad=b.pad,
            label=[self.mx.nd.NDArray(x._data.reshape(-1)) for x in b.label])

    def reset(self):
        self.it.reset()


def _token_batches(cfg, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, cfg["num_classes"], (n, cfg["seq_len"]))
    return x.astype(np.float32), np.roll(x, -1, axis=1).astype(np.float32)


def phase_train(torch, mx, np_params, cfg=FULL, ctx=None):
    """Module.fit on the full-width model; returns the launch counts of
    the fit run."""
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    B, S = TRAIN["batch"], cfg["seq_len"]
    x, y = _token_batches(cfg, B * TRAIN["batches"], SEED + 6)
    t0 = time.perf_counter()
    with fit_fused_off():
        mod = mx.Module(transformer.get_symbol(**cfg), context=ctx)
    mod.bind(data_shapes=[("data", (B, S))],
             label_shapes=[("softmax_label", (B * S,))])
    mod.set_params(convert_params(np_params, ctx, cfg), {})
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    ppl, stamps = [], []

    def per_step(param):
        sync()
        stamps.append(time.perf_counter())
        ppl.append(param.eval_metric.get()[1])
        param.eval_metric.reset()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stamps.append(time.perf_counter())
    mod.fit(FlatLabels(mx, mx.io.NDArrayIter(x, y, batch_size=B)),
            num_epoch=TRAIN["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN["lr"],
                              "momentum": TRAIN["momentum"]},
            eval_metric="perplexity", batch_end_callback=per_step)
    sync()
    launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
    steps = len(ppl)
    check(steps == TRAIN["batches"] * TRAIN["epochs"],
          "train: %d steps ran" % steps)
    check(all(np.isfinite(ppl)), "train: non-finite loss %s" % ppl)
    first, last = ppl[0], ppl[-TRAIN["batches"]]      # batch 0, epochs 0, -1
    check(last < first, "train: the loss on the repeated batch did not fall "
          "(perplexity %g -> %g)" % (first, last))
    for name, per in TRAIN_LAUNCHES.items():
        check(launches[name] == per * steps,
              "train: %s launched %d times over %d steps (want %d per step)"
              % (name, launches[name], steps, per))
    check(not any(plain.values()), "train: plain versions ran on the main "
          "path: %s" % plain)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    timed = sorted(step_ms[TRAIN["warmup"]:])
    p50 = statistics.median(timed)
    emit({"phase": "train", "config": cfg, "train": TRAIN,
          "setup_s": setup_s, "steps": steps,
          "step_ms": step_ms, "step_ms_p50": p50,
          "tokens_per_s": B * S / (p50 / 1e3),
          "perplexity": ppl, "loss_first": math.log(first),
          "loss_last_same_batch": math.log(last),
          "final_perplexity": ppl[-1],
          "launches": {k: launches[k] for k in TRAIN_LAUNCHES},
          "launches_per_step": {k: launches[k] / steps
                                for k in TRAIN_LAUNCHES},
          "plain_calls": plain,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
          if on_card else None})
    return launches, steps


def phase_train_agreement(torch, mx, cfg=None, ctxs=None):
    """Gradients after one forward/backward and parameter changes after
    two SGD steps, card against CPU, from the same numpy weights."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    cfg = cfg or dict(FULL, num_layers=AGREE["num_layers"],
                      seq_len=AGREE["seq_len"])
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    B, S, rtol = AGREE["batch"], cfg["seq_len"], AGREE["rtol"]
    np_params = seeded_params(cfg)
    x, y = _token_batches(cfg, B, SEED + 7)
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y.reshape(-1), ctx=mx.cpu())])
    runs = []
    for ctx in ctxs:
        mod = mx.Module(transformer.get_symbol(**cfg), context=ctx)
        mod.bind(data_shapes=[("data", (B, S))],
                 label_shapes=[("softmax_label", (B * S,))])
        mod.set_params(convert_params(np_params, ctx, cfg), {})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": TRAIN["lr"], "momentum": TRAIN["momentum"]})
        mod.forward_backward(batch)
        prob = mod.get_outputs()[0].asnumpy()
        loss = float(-np.log(prob[np.arange(B * S), y.reshape(-1)
                                  .astype(int)]).mean())
        group = mod._exec_group
        grads = {n: g[0].asnumpy() for n, g in zip(group.param_names,
                                                   group.grad_arrays)}
        mod.update()
        mod.forward_backward(batch)
        mod.update()
        moved = {n: v.asnumpy() - np_params[n]
                 for n, v in mod.get_params()[0].items()}
        runs.append((loss, grads, moved))
        del mod
    (gl, gg, gm), (cl, cg, cm) = runs
    check(abs(gl - cl) <= rtol * abs(cl), "train_agreement: loss %g on the "
          "card, %g on the CPU" % (gl, cl))
    worst = {"grad": {}, "step": {}}
    for kind, a, b in (("grad", gg, cg), ("step", gm, cm)):
        for name in b:
            scale = float(np.abs(b[name]).max())
            err = float(np.abs(a[name] - b[name]).max())
            check(err <= rtol * scale, "train_agreement: %s of %s differs "
                  "by %g (largest CPU value %g)" % (kind, name, err, scale))
            grp = name.split("_", 1)[1] if name.startswith("layer") else name
            worst[kind][grp] = max(worst[kind].get(grp, 0.0),
                                   err / scale if scale else 0.0)
    emit({"phase": "train_agreement", "config": cfg, "batch": B,
          "loss_card": gl, "loss_cpu": cl, "rtol": rtol,
          "worst_rel_err_by_group": worst})


# ----------------------------------------------------------------------
# the 2-bit quantizer and the kvstore
# ----------------------------------------------------------------------
def _bits(torch, t):
    return t.contiguous().view(torch.int32)


def phase_quant(torch, mxk, dev, flush):
    """two_bit_quantize_fused against its plain version on the card, bit
    for bit (int32 views, so NaN and -0.0 count): the lengths of QUANT,
    a view at a 4-byte offset, and the edge values (NaN, +-inf, -0.0,
    sums exactly at +-t and one ulp either side), at both thresholds;
    then the times of the two timed lengths."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 8)
    cases = 0
    for t in QUANT["thresholds"]:
        t32 = np.float32(t)
        up = float(np.nextafter(t32, np.float32(np.inf)))
        dn = float(np.nextafter(t32, np.float32(0)))
        edge = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                             0.0, float(t32), -float(t32), up, -up, dn, -dn],
                            device=dev)
        zero = torch.zeros_like(edge)
        ins = [(zero, edge), (edge, zero), (edge, edge)]
        for n in QUANT["lengths"]:
            ins.append(tuple((torch.randn(n, generator=g) * t).to(dev)
                             for _ in range(2)))
        base = (torch.randn(2, 1001, generator=g) * t).to(dev)
        ins.append((base[0, 1:], base[1, 1:]))          # 4-byte offset
        for r, gr in ins:
            got = mxk.two_bit_quantize_fused(r, gr, t)
            ref = mxk.two_bit_quantize_plain(r, gr, t)
            torch.cuda.synchronize()
            check(all(torch.equal(_bits(torch, a), _bits(torch, b))
                      for a, b in zip(got, ref)),
                  "two_bit_quantize_fused (n %d, threshold %g) differs from "
                  "its plain version" % (r.numel(), t))
            cases += 1
    per_len = []
    for n in QUANT["timed"]:
        r, gr = ((torch.randn(n, generator=g) * 0.5).to(dev) for _ in range(2))
        ms = time_ms(torch, lambda: mxk.two_bit_quantize_fused(r, gr, 0.5),
                     flush)
        plain_ms = time_ms(torch, lambda: mxk.two_bit_quantize_plain(
            r, gr, 0.5), flush)
        # r and g read, q and the new residual written; 4 ops per element
        b_ms, b_by = bound(16 * n, 4 * n)
        row = {"n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        emit({"phase": "kernel", "name": "two_bit_quantize_fused", **row})
        per_len.append(row)
    mean = {k: statistics.mean(s[k] for s in per_len)
            for k in ("ms", "plain_ms", "bound_ms")}
    emit({"phase": "quant", "cases_bit_identical": cases,
          "lengths": list(QUANT["lengths"]),
          "thresholds": list(QUANT["thresholds"])})
    return {"name": "two_bit_quantize_fused", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/quant.cu",
            "replaces": "mxnet_tpu/pallas/quant.py:44", "max_abs_err": 0.0,
            "bound_by": per_len[0]["bound_by"], "library_ms": None, **mean}


def _kv_run(mx, ctx, bucketed, updater):
    """KV's gradient streams through a 2-bit device store on ``ctx``:
    the pulled values and the per-(key, stream) residuals, as numpy."""
    kv = mx.kv.create("device")
    kv.set_bucketing(bucketed)
    kv.set_gradient_compression({"type": "2bit",
                                 "threshold": KV["threshold"]})
    if updater:
        kv.set_optimizer(mx.optimizer.SGD(**KV["sgd"]))
    keys = ["p%d" % i for i in range(len(KV["shapes"]))]
    rng = np.random.RandomState(SEED + 9)
    for k, s in zip(keys, KV["shapes"]):
        kv.init(k, mx.nd.array(rng.normal(0, 1, s), ctx=ctx))
    r = np.random.RandomState(SEED + 10)
    for _ in range(KV["steps"]):
        grads = [[mx.nd.array(r.normal(0, 0.3, s), ctx=ctx)
                  for _ in range(KV["streams"])] for s in KV["shapes"]]
        kv.push(keys, grads, priority=[-i for i in range(len(keys))])
    outs = [mx.nd.zeros(s, ctx=ctx) for s in KV["shapes"]]
    kv.pull(keys, out=outs)
    if kv._engine is not None:
        kv._engine.spill_residuals()
    res = {k: v.asnumpy() for k, v in kv._compression_residuals.items()}
    stats = dict(kv._engine.stats) if kv._engine is not None else None
    return [o.asnumpy() for o in outs], res, stats


def _kv_run16(mx, ctx, bucketed, compress):
    """KV's gradient streams as f16 values (f16 weights, f16 gradient
    streams) through a device store on ``ctx`` under KV's SGD with
    multi_precision, 2-bit at KV's threshold when ``compress``: the
    pulled weights, the f32 masters and the residuals, as numpy, and the
    engine's stats."""
    kv = mx.kv.create("device")
    kv.set_bucketing(bucketed)
    if compress:
        kv.set_gradient_compression({"type": "2bit",
                                     "threshold": KV["threshold"]})
    kv.set_optimizer(mx.optimizer.SGD(multi_precision=True, **KV["sgd"]))
    keys = ["p%d" % i for i in range(len(KV["shapes"]))]
    rng = np.random.RandomState(SEED + 9)
    for k, s in zip(keys, KV["shapes"]):
        kv.init(k, mx.nd.array(rng.normal(0, 1, s), ctx=ctx)
                .astype("float16"))
    r = np.random.RandomState(SEED + 10)
    for _ in range(KV["steps"]):
        grads = [[mx.nd.array(r.normal(0, 0.3, s), ctx=ctx)
                  .astype("float16") for _ in range(KV["streams"])]
                 for s in KV["shapes"]]
        kv.push(keys, grads, priority=[-i for i in range(len(keys))])
    outs = [mx.nd.zeros(s, ctx=ctx).astype("float16") for s in KV["shapes"]]
    kv.pull(keys, out=outs)
    if kv._engine is not None:
        kv._engine.spill_residuals()
    masters = {k: kv._updater.states[k][1].asnumpy() for k in keys}
    res = {k: v.asnumpy() for k, v in kv._compression_residuals.items()}
    stats = dict(kv._engine.stats) if kv._engine is not None else None
    return [o.astype("float32").asnumpy() for o in outs], masters, res, \
        stats


def _kvstore_f16(torch, mx):
    """f16 values through the store (ROADMAP A.1, float16 training),
    dense and 2-bit: the card's bucketed store (f16 values bucketed under
    the optimizer through their f32 master-gradient view; the quantizer
    on that f32 view) against the card's eager store and the CPU's
    bucketed one: residuals bit-identical, masters within KV's rtol/atol,
    f16 weights within one f16 ulp (rtol 2^-10, atol 2^-24)."""
    from mxnet_tpu_torch.kernels import LAUNCHES_BY_DTYPE, reset_counts
    out = {}
    for compress in (False, True):
        tag = "2bit" if compress else "dense"
        reset_counts()
        card = _kv_run16(mx, mx.gpu(0), True, compress)
        quant = dict(LAUNCHES_BY_DTYPE)
        check(card[3]["flushes"] > 0, "kvstore f16 %s: nothing bucketed %s"
              % (tag, card[3]))
        check(not compress or quant.get("two_bit_quantize_fused:float32", 0)
              == KV["streams"] * card[3]["buckets"], "kvstore f16 2bit: "
              "quantize launches %s for %d buckets" % (quant,
                                                       card[3]["buckets"]))
        worst = {}
        for label, other in (("eager", _kv_run16(mx, mx.gpu(0), False,
                                                 compress)),
                             ("cpu", _kv_run16(mx, mx.cpu(), True,
                                               compress))):
            for a, b in zip(card[0], other[0]):
                check(np.allclose(a, b, rtol=FIT_F16["weights_rtol"],
                                  atol=FIT_F16["weights_atol"]),
                      "kvstore f16 %s card vs %s: weights differ by %g"
                      % (tag, label, float(np.abs(a - b).max())))
            for k in card[1]:
                check(np.allclose(card[1][k], other[1][k], rtol=KV["rtol"],
                                  atol=KV["atol"]), "kvstore f16 %s card "
                      "vs %s: masters differ by %g" % (
                          tag, label,
                          float(np.abs(card[1][k] - other[1][k]).max())))
            check(sorted(card[2]) == sorted(other[2]) and all(
                np.array_equal(card[2][k].view(np.int32),
                               other[2][k].view(np.int32))
                for k in card[2]), "kvstore f16 %s card vs %s: residuals "
                "not bit-identical" % (tag, label))
            worst[label] = {
                "weights_max_abs_diff": max(float(np.abs(a - b).max())
                                            for a, b in zip(card[0],
                                                            other[0])),
                "masters_max_abs_diff": max(
                    float(np.abs(card[1][k] - other[1][k]).max())
                    for k in card[1])}
        out[tag] = {"buckets": card[3]["buckets"],
                    "flushes": card[3]["flushes"],
                    "quantize_launches_by_dtype": quant,
                    "residuals": len(card[2]), **worst}
    return out


def phase_kvstore(torch, mx):
    """The same numpy gradient streams through a store on the card and
    one on the CPU: with no updater the pulled values and the residuals
    are bit-identical, card against CPU and bucketed against eager on
    the card; with SGD they agree within KV's rtol/atol (FMA contraction
    in the update).  Then f16 values, dense and 2-bit (``_kvstore_f16``).
    """
    from mxnet_tpu_torch.kernels import LAUNCHES, reset_counts
    reset_counts()
    card, card_res, stats = _kv_run(mx, mx.gpu(0), True, False)
    launches = LAUNCHES["two_bit_quantize_fused"]
    check(launches == KV["streams"] * stats["buckets"],
          "kvstore: %d quantize launches for %d buckets of %d streams"
          % (launches, stats["buckets"], KV["streams"]))
    eager, eager_res, _ = _kv_run(mx, mx.gpu(0), False, False)
    cpu, cpu_res, _ = _kv_run(mx, mx.cpu(), True, False)
    for what, (a, ar), (b, br) in (
            ("card vs CPU", (card, card_res), (cpu, cpu_res)),
            ("bucketed vs eager", (card, card_res), (eager, eager_res))):
        check(sorted(ar) == sorted(br), "kvstore %s: residual keys differ"
              % what)
        check(all(np.array_equal(x.view(np.int32), y.view(np.int32))
                  for x, y in zip(a, b))
              and all(np.array_equal(ar[k].view(np.int32),
                                     br[k].view(np.int32)) for k in ar),
              "kvstore %s: values or residuals not bit-identical" % what)
    sgd_card, sgd_res, _ = _kv_run(mx, mx.gpu(0), True, True)
    sgd_cpu, sgd_cpu_res, _ = _kv_run(mx, mx.cpu(), True, True)
    worst = 0.0
    for a, b in zip(sgd_card, sgd_cpu):
        check(np.allclose(a, b, rtol=KV["rtol"], atol=KV["atol"]),
              "kvstore SGD: card and CPU differ by %g"
              % float(np.abs(a - b).max()))
        worst = max(worst, float(np.abs(a - b).max()))
    emit({"phase": "kvstore", "shapes": KV["shapes"],
          "streams": KV["streams"], "steps": KV["steps"],
          "threshold": KV["threshold"], "buckets": stats["buckets"],
          "flushes": stats["flushes"], "quantize_launches": launches,
          "no_updater_bit_identical": True,
          "sgd_max_abs_diff": worst,
          "sgd_residuals_bit_identical": all(
              np.array_equal(sgd_res[k].view(np.int32),
                             sgd_cpu_res[k].view(np.int32))
              for k in sgd_res),
          "float16": _kvstore_f16(torch, mx)})


# ----------------------------------------------------------------------
# ResNet training through Module.fit
# ----------------------------------------------------------------------
def seeded_resnet_params(sym, batch, image):
    """Random weights and BatchNorm statistics from a numpy seed, one
    stream per name: He-normal convolution and FC weights (fan-in),
    gammas 1 + N(0, 0.1), betas and biases N(0, 0.1) and 0, moving means
    N(0, 0.1), moving variances 1 + |N(0, 0.1)|."""
    from mxnet_tpu_torch.weights import symbol_shapes
    args, auxs = symbol_shapes(sym, data=(batch,) + tuple(image),
                               softmax_label=(batch,))
    out = ({}, {})
    for i, shapes in enumerate((args, auxs)):
        for name, shape in shapes.items():
            rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
            z = rng.standard_normal(shape, dtype=np.float32)
            if name.endswith("_weight"):
                a = z * np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
            elif name.endswith("_gamma"):
                a = 1 + z * np.float32(0.1)
            elif name.endswith("_bias"):
                a = np.zeros(shape, np.float32)
            elif name.endswith("_var"):
                a = 1 + np.abs(z) * np.float32(0.1)
            else:                                # betas, moving means
                a = z * np.float32(0.1)
            out[i][name] = a
    return out


def _image_batches(image, n, seed, classes):
    """common/fit.py's synthetic data: uniform(-1, 1) images and random
    labels."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n,) + tuple(image)).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def phase_train_resnet(torch, mx, ctx=None, cfg=RESNET, train=RESNET_TRAIN):
    """ResNet-50 through Module.fit with mx.kv.create('device'), a dense
    arm and a 2-bit arm from the same seeded weights.  Returns the 2-bit
    arm's launch counts, its step count and the dense arm's step p50."""
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.weights import convert_symbol_params
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    B = train["batch"]
    sym = resnet.get_symbol(**cfg)
    np_args, np_aux = seeded_resnet_params(sym, B, cfg["image_shape"])
    x, y = _image_batches(cfg["image_shape"], B * train["batches"],
                          SEED + 11, cfg["num_classes"])
    arms = {}
    for arm, comp in (("dense", None),
                      ("2bit", {"type": "2bit",
                                "threshold": train["threshold"]})):
        t0 = time.perf_counter()
        args, auxs = convert_symbol_params(
            np_args, np_aux, ctx, sym, data=(B,) + tuple(cfg["image_shape"]),
            softmax_label=(B,))
        with fit_fused_off():
            mod = mx.Module(resnet.get_symbol(**cfg), context=ctx,
                            compression_params=comp)
        kv = mx.kv.create("device")
        sync()
        setup_s = time.perf_counter() - t0
        labels = torch.from_numpy(y).long()
        losses, stamps, buckets, quant = [], [], [], []
        # launches on the card; on the CPU (a rehearsal) the plain calls
        counts = LAUNCHES if on_card else PLAIN_CALLS

        def per_step(param):
            sync()
            stamps.append(time.perf_counter())
            prob = mod.get_outputs()[0]._data
            lab = labels[param.nbatch * B:(param.nbatch + 1) * B] \
                .to(prob.device)
            losses.append(float(-torch.log(prob.gather(
                1, lab[:, None]).clamp(min=1e-30)).mean()))
            buckets.append(kv._engine.stats["buckets"])
            quant.append(counts["two_bit_quantize_fused"])

        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stamps.append(time.perf_counter())
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=B),
                num_epoch=train["epochs"], kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": train["lr"],
                                  "momentum": train["momentum"],
                                  "wd": train["wd"]},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                arg_params=args, aux_params=auxs, eval_metric="acc",
                batch_end_callback=per_step)
        sync()
        launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        steps = len(losses)
        check(steps == train["batches"] * train["epochs"],
              "train_resnet %s: %d steps ran" % (arm, steps))
        check(all(np.isfinite(losses)), "train_resnet %s: non-finite loss %s"
              % (arm, losses))
        step_buckets = np.diff([0] + buckets).tolist()
        step_quant = np.diff([0] + quant).tolist()
        stats = kv._engine.stats
        check(stats["flushes"] > 0, "train_resnet %s: the bucketed kvstore "
              "never flushed" % arm)
        if comp is None:
            check(quant[-1] == 0, "train_resnet dense: the quantizer ran %d "
                  "times" % quant[-1])
            first, last = losses[0], losses[-train["batches"]]
            check(last < first, "train_resnet dense: the loss on the "
                  "repeated batch did not fall (%g -> %g)" % (first, last))
        else:
            check(step_quant == step_buckets,
                  "train_resnet 2bit: quantize launches per step %s, "
                  "buckets per step %s" % (step_quant, step_buckets))
            check(len(set(step_buckets[1:])) == 1,
                  "train_resnet 2bit: buckets per step vary after the first "
                  "%s" % step_buckets)
            flat = kv._engine._flat_res
            check(all(bool(torch.isfinite(r).all()) for rec in flat.values()
                      for r in rec["res"]),
                  "train_resnet 2bit: a flat residual is not finite")
            if on_card:
                check(not any(plain.values()), "train_resnet 2bit: plain "
                      "versions ran on the main path: %s" % plain)
            arms["launches"] = launches
        step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        p50 = statistics.median(sorted(step_ms[train["warmup"]:]))
        arms[arm] = {"setup_s": setup_s, "step_ms": step_ms,
                     "step_ms_p50": p50, "images_per_s": B / (p50 / 1e3),
                     "loss": losses, "buckets_per_step": step_buckets,
                     "quantize_launches_per_step": step_quant,
                     "kv_stats": dict(stats),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None}
        del mod, kv, args, auxs
    emit({"phase": "train_resnet", "config": cfg, "train": train,
          "dense": arms["dense"], "2bit": arms["2bit"]})
    return arms["launches"], train["batches"] * train["epochs"], \
        arms["dense"]["step_ms_p50"]


def phase_resnet_agreement(torch, mx, ctxs=None, cfg=RESNET_AGREE):
    """ResNet-18 (ImageNet layout, 7x7 stem and max-pool) at 3x64x64 from
    the same numpy weights on the card and on the CPU: the loss, every
    parameter's gradient and moving statistic after the train forward
    (within grad_rtol and aux_rtol of the CPU's largest value of that
    array), and
    one 2-bit Module.update with the threshold at the median of the
    CPU's |g|: q is equal wherever the CPU's |acc| lies farther than
    band * t from t, and the elements inside that band are counted."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.weights import convert_symbol_params
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    B, image = cfg["batch"], cfg["image_shape"]
    kw = {k: cfg[k] for k in ("num_classes", "num_layers", "image_shape")}
    sym = resnet.get_symbol(**kw)
    np_args, np_aux = seeded_resnet_params(sym, B, image)
    x, y = _image_batches(image, B, SEED + 12, cfg["num_classes"])
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                            label=[mx.nd.array(y, ctx=mx.cpu())])
    shapes = dict(data=(B,) + tuple(image), softmax_label=(B,))

    def run(ctx, threshold):
        mod = mx.Module(resnet.get_symbol(**kw), context=ctx,
                        compression_params=None if threshold is None else
                        {"type": "2bit", "threshold": threshold})
        mod.bind(data_shapes=[("data", shapes["data"])],
                 label_shapes=[("softmax_label", shapes["softmax_label"])])
        mod.set_params(*convert_symbol_params(np_args, np_aux, ctx, sym,
                                              **shapes))
        kv = mx.kv.create("device")
        mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
        mod.forward_backward(batch)
        prob = mod.get_outputs()[0].asnumpy()
        loss = float(-np.log(prob[np.arange(B), y.astype(int)]).mean())
        group = mod._exec_group
        grads = {n: g[0].asnumpy() for n, g in zip(group.param_names,
                                                   group.grad_arrays)}
        aux = {n: a[0].asnumpy() for n, a in zip(group.aux_names,
                                                 group.aux_arrays)}
        q = None
        if threshold is not None:
            mod.update()
            kv._engine.spill_residuals()
            # residuals start at zero, so acc = g and new_r = g - q:
            # (g - new_r) / t rounds to q's sign class, -1, 0 or +1
            q = {n: np.rint((grads[n] - kv._compression_residuals[(n, 0)]
                             .asnumpy()) / np.float32(threshold))
                 for n in grads}
        return loss, grads, aux, q

    _, cpu_grads, _, _ = run(ctxs[1], None)
    t = float(np.median(np.abs(np.concatenate(
        [g.ravel() for g in cpu_grads.values()]))))
    (gl, gg, ga, gq), (cl, cg, ca, cq) = (run(c, t) for c in ctxs)
    check(abs(gl - cl) <= cfg["loss_rtol"] * abs(cl),
          "resnet_agreement: loss %g on the card, %g on the CPU" % (gl, cl))
    worst_grad = 0.0
    for name, ref in cg.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(gg[name] - ref).max())
        check(err <= cfg["grad_rtol"] * scale, "resnet_agreement: gradient "
              "of %s differs by %g (largest CPU value %g)" % (name, err, scale))
        worst_grad = max(worst_grad, err / scale if scale else 0.0)
    worst_aux = 0.0
    for name, ref in ca.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(ga[name] - ref).max())
        check(err <= cfg["aux_rtol"] * scale, "resnet_agreement: %s differs "
              "by %g after the train forward (largest CPU value %g)"
              % (name, err, scale))
        worst_aux = max(worst_aux, err / scale if scale else 0.0)
    band = total = 0
    t32 = np.float32(t)
    for name, ref in cq.items():
        near = np.abs(np.abs(cg[name]) - t32) <= cfg["band"] * t32
        band += int(near.sum())
        total += near.size
        diff = int((gq[name] != ref)[~near].sum())
        check(diff == 0, "resnet_agreement: q of %s differs in %d elements "
              "outside the band" % (name, diff))
    share = band / total
    check(share < cfg["band_share"], "resnet_agreement: %d of %d elements (%g) lie "
          "inside the band" % (band, total, share))
    emit({"phase": "resnet_agreement", "config": cfg, "loss_card": gl,
          "loss_cpu": cl, "worst_grad_rel_err": worst_grad,
          "worst_aux_rel_err": worst_aux, "threshold": t,
          "q_elements": total, "q_in_band": band, "q_in_band_share": share,
          "q_plus_minus_share": float(sum(int((v != 0).sum())
                                          for v in cq.values())) / total})


# ----------------------------------------------------------------------
# channel-last ResNet-50 through TrainStep, with the fused kernel
# ----------------------------------------------------------------------
def _fused_gemm_f32_ptxas(source="fused_matmul"):
    """The f32 GEMM's instances (split TF32, fused_gemm_f32.cuh) in
    csrc/<source>.cu's build (W (N, K) in fused_matmul, (K, N) in
    fused_band4d): ptxas's registers, stack and spills (none allowed) and
    each tile's dynamic shared memory, printed; and no CUDA-core kernel
    left in the library."""
    import ctypes
    from mxnet_tpu_torch.kernels import _build
    w_kn = int(source == "fused_band4d")
    entries = {"128x%d:%s" % (bn, "cp_async" if vec else "elementwise"):
               "fused_gemm_f32_kernelILi%dELb%dELb%dE" % (bn, w_kn, vec)
               for bn in FUSED_GEMM_TILES for vec in (1, 0)}
    ptx = _ptxas(source, entries)
    lib = _build.load(source)
    lib.mx_fused_gemm_f32_smem.argtypes = [ctypes.c_int]
    lib.mx_fused_gemm_f32_smem.restype = ctypes.c_int
    for key in sorted(ptx):
        bn = int(key.split(":")[0].split("x")[1])
        ptx[key]["dynamic_smem_bytes"] = lib.mx_fused_gemm_f32_smem(bn)
        print("ptxas %s fused_gemm_f32_kernel %s: %s; %d bytes of dynamic "
              "shared memory" % (source, key, "; ".join(ptx[key]["lines"]),
                                 ptx[key]["dynamic_smem_bytes"]), flush=True)
        check(ptx[key]["spill_stores"] == 0 and ptx[key]["spill_loads"] == 0,
              "%s: the f32 GEMM %s spills: %s"
              % (source, key, ptx[key]["lines"][0]))
    old_entry = "fused_scale_relu_matmul_kernel" if source == "fused_matmul" \
        else "fused_band4d_kernel"
    old = [line for line in _build.log_path(source).read_text()
           .splitlines() if "Compiling entry function" in line
           and old_entry in line]
    check(not old, "%s: the CUDA-core kernel is still built: %s"
          % (source, old[:1]))
    return ptx


def phase_fused_matmul(torch, mxk, dev, flush):
    """fused_scale_relu_matmul in f32 (split TF32 on the tensor cores,
    fused_gemm_f32.cuh; its instances' ptxas lines and shared memory
    printed first, no spills allowed) against its plain version at every
    shape of FUSED_SHAPES and FUSED_ODD, two runs bit-identical; times at
    the ResNet-50 shapes with each shape's TFLOP/s and GB/s, bounded by
    bytes or by operations at the split-TF32 peak (the CUDA-core bound
    beside).  Returns the kernels-line row: times per launch averaged
    over one step's 28 launches."""
    ptx = _fused_gemm_f32_ptxas()
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    rows, errs = [], []
    for shape in list(FUSED_SHAPES) + [FUSED_ODD]:
        M, K, N, with_res = shape
        x = torch.randn(M, K, device=dev, generator=g)
        sc = 1 + 0.2 * torch.randn(K, device=dev, generator=g)
        sh = 0.2 * torch.randn(K, device=dev, generator=g)
        w = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
        res = torch.randn(M, N, device=dev, generator=g) if with_res \
            else None
        got = mxk.fused_scale_relu_matmul_fwd(x, sc, sh, w, res)
        again = mxk.fused_scale_relu_matmul_fwd(x, sc, sh, w, res)
        ref = mxk.fused_scale_relu_matmul_plain(x, sc, sh, w, res)
        torch.cuda.synchronize()
        check(close(torch, got, ref), "fused_scale_relu_matmul %s disagrees "
              "with its plain version (max abs err %g)"
              % (shape, max_err(got, ref)))
        check(torch.equal(got, again), "fused_scale_relu_matmul %s: two "
              "runs differ" % (shape,))
        errs.append(max_err(got, ref))
        del got, again, ref
        if shape == FUSED_ODD:
            continue
        a = torch.relu(x * sc + sh)
        ms = time_ms(torch, lambda: mxk.fused_scale_relu_matmul_fwd(
            x, sc, sh, w, res), flush)
        plain_ms = time_ms(torch, lambda: mxk.fused_scale_relu_matmul_plain(
            x, sc, sh, w, res), flush)
        wt = w.t()
        lib_ms = time_ms(torch, (lambda: torch.addmm(res, a, wt))
                         if with_res else (lambda: torch.matmul(a, wt)),
                         flush)
        # x, w, scale, shift (and the residual) read once, y written once;
        # the product's 2MNK, the prologue's 3 per x element, the add
        nbytes = 4 * (M * K + N * K + 2 * K + M * N * (2 if with_res else 1))
        flops = 2 * M * N * K + 3 * M * K + (M * N if with_res else 0)
        b_ms, b_by = bound(nbytes, flops, SPLIT_TF32_FLOPS_PER_S)
        row = {"M": M, "K": K, "N": N, "residual": with_res,
               "sites": FUSED_SHAPES[shape], "max_abs_err": errs[-1],
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_cuda_cores_ms": bound(nbytes, flops)[0],
               "tflops": 2 * M * N * K / ms / 1e9,
               "gbps": nbytes / ms / 1e6}
        emit({"phase": "kernel", "name": "fused_scale_relu_matmul", **row})
        rows.append(row)
        del x, a, res, w
    sites = sum(FUSED_SHAPES.values())
    per_launch = {k: sum(r[k] * r["sites"] for r in rows) / sites
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_cuda_cores_ms")}
    # the step's bound is by operations when the sites bound by
    # operations make up most of it
    ops_ms = sum(r["sites"] * r["bound_ms"] for r in rows
                 if r["bound_by"] == "operations")
    emit({"phase": "fused_matmul", "shapes_checked": len(FUSED_SHAPES) + 1,
          "odd_shape": list(FUSED_ODD), "deterministic": True, "ptxas": ptx,
          "step_ms": per_launch["ms"] * sites,
          "step_plain_ms": per_launch["plain_ms"] * sites,
          "step_library_ms": per_launch["library_ms"] * sites,
          "step_bound_ms": per_launch["bound_ms"] * sites,
          "step_bound_cuda_cores_ms": per_launch["bound_cuda_cores_ms"] * sites,
          "bound_peak": "split TF32, %g TFLOP/s"
                        % (SPLIT_TF32_FLOPS_PER_S / 1e12),
          "library_call": "torch.addmm / torch.matmul on relu(x*scale+shift)"
                          " (the product alone)"})
    return {"name": "fused_scale_relu_matmul", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/fused_gemm_f32.cuh",
            "replaces": "mxnet_tpu/ops/fused.py:91",
            "max_abs_err": max(errs),
            "bound_by": "operations" if ops_ms * 2 >= per_launch["bound_ms"]
            * sites else "bytes", **per_launch}


def _nhwc(a):
    """An NCHW array or OIHW weight as contiguous NHWC / OHWI."""
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1)) if a.ndim == 4 \
        else a


def phase_train_resnet_nhwc(torch, mx, ctx=None, cfg=RESNET,
                            train=NHWC_TRAIN):
    """ResNet-50 through TrainStep in three arms from the same seeded
    weights: NCHW, NHWC, NHWC with the fusion pass.  Returns the fused
    arm's launch counts and step count."""
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dev = ctx.torch_device
    B, steps, name = train["batch"], train["steps"], "fused_scale_relu_matmul"
    np_args, np_aux = seeded_resnet_params(resnet.get_symbol(**cfg), B,
                                           cfg["image_shape"])
    x, y = _image_batches(cfg["image_shape"], B * train["batches"],
                          SEED + 14, cfg["num_classes"])
    arms, result = {}, None
    for arm, layout, fuse in (("nchw", "NCHW", False), ("nhwc", "NHWC", False),
                              ("nhwc_fused", "NHWC", True)):
        t0 = time.perf_counter()
        sym = resnet.get_symbol(layout=layout, **cfg)
        if fuse:
            sym = fuse_conv_bn(sym)
            check(count_fused(sym) == train["sites"], "train_resnet_nhwc: "
                  "%d fused sites, not %d" % (count_fused(sym),
                                              train["sites"]))
        conv = _nhwc if layout == "NHWC" else (lambda a: a)
        data = conv(x)
        batches = [{"data": torch.from_numpy(data[i * B:(i + 1) * B]).to(dev),
                    "softmax_label": torch.from_numpy(
                        y[i * B:(i + 1) * B]).to(dev)}
                   for i in range(train["batches"])]
        ts = TrainStep(sym, mx.optimizer.SGD(
            learning_rate=train["lr"], momentum=train["momentum"],
            wd=train["wd"], rescale_grad=1.0 / B),
            data_shapes={"data": data[:B].shape},
            label_shapes={"softmax_label": (B,)}, ctx=ctx)
        ts.init_params(mx.init.Xavier(), arg_params={
            n: conv(a) for n, a in np_args.items()}, aux_params=np_aux)
        sync()
        setup_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        losses, stamps = [], [time.perf_counter()]
        reset_counts()
        for i in range(steps):
            batch = batches[i % train["batches"]]
            prob = ts.step(batch)[0]
            lab = batch["softmax_label"].long()
            losses.append(float(-torch.log(prob.gather(
                1, lab[:, None]).clamp(min=1e-30)).mean()))
            stamps.append(time.perf_counter())
        sync()
        launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        check(all(np.isfinite(losses)), "train_resnet_nhwc %s: non-finite "
              "loss %s" % (arm, losses))
        first, last = losses[0], losses[-train["batches"]]
        check(last < first, "train_resnet_nhwc %s: the loss on the repeated "
              "batch did not fall (%g -> %g)" % (arm, first, last))
        counts = launches if on_card else plain
        want = train["sites"] * steps if fuse else 0
        check(counts[name] == want, "train_resnet_nhwc %s: %d %s calls over "
              "%d steps, want %d" % (arm, counts[name], name, steps, want))
        if on_card:
            check(not any(plain.values()), "train_resnet_nhwc %s: plain "
                  "versions ran on the main path: %s" % (arm, plain))
        step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        p50 = statistics.median(step_ms[train["warmup"]:])
        arms[arm] = {"layout": layout, "fused_sites": train["sites"] if fuse
                     else 0, "setup_s": setup_s, "step_ms": step_ms,
                     "step_ms_p50": p50, "images_per_s": B / (p50 / 1e3),
                     "loss": losses, "kernel_launches_per_step":
                         launches[name] / steps,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None}
        if fuse:
            result = (launches, steps)
        del ts, batches
    firsts = [a["loss"][0] for a in arms.values()]
    check(max(firsts) - min(firsts) <= train["loss_rtol"] * abs(firsts[0]),
          "train_resnet_nhwc: first-step losses differ across arms: %s"
          % firsts)
    emit({"phase": "train_resnet_nhwc", "config": cfg, "train": train,
          **arms})
    return result


def phase_resnet_nhwc_agreement(torch, mx, ctxs=None, cfg=NHWC_AGREE):
    """Card against CPU on the fused path, in two parts.

    1. One fused site's backward (the autograd Function's dx, dscale,
       dshift, dW and dres for a fixed cotangent at the shape
       ``cfg['site']``) from the same numpy inputs: each within
       site_rtol of its largest CPU value (sums in another order).
    2. The fused NHWC ResNet-50 at 3x64x64, batch 4, one TrainStep step
       from the same numpy weights on the card and on the CPU, and once
       more on the CPU with the input scaled by 1 + perturb (a change
       at the rounding level): the loss (loss_rtol), the output
       probabilities (prob_atol) and every moving statistic after the
       train forward (aux_rtol of its largest CPU value) are held as in
       resnet_agreement.  The whole gradient is held by its relative L2
       error (grad_l2): at random initialisation the gradient of a
       BatchNorm ResNet-50 moves by percents under rounding-level
       changes (ReLU masks flip and BatchNorm's backward amplifies the
       difference), and the perturbed CPU run's own distance is printed
       beside the card's, so an element bound cannot hold."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops.fused import fused_scale_relu_matmul
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    rng = np.random.default_rng(SEED + 16)
    M, K, N = cfg["site"]
    x2d, sc, sh, w, res, dy = (rng.standard_normal(s, dtype=np.float32)
                               for s in ((M, K), (K,), (K,), (N, K), (M, N),
                                         (M, N)))
    site = [x2d, 1 + 0.2 * sc, 0.2 * sh, w / np.float32(np.sqrt(K)), res]
    site_grads = []
    for ctx in ctxs:
        dev = ctx.torch_device
        ins = [torch.from_numpy(a).to(dev).requires_grad_() for a in site]
        out = fused_scale_relu_matmul(*ins)
        site_grads.append([g.cpu().numpy() for g in torch.autograd.grad(
            out, ins, torch.from_numpy(dy).to(dev))])
    site_worst = {}
    for name, a, b in zip(("dx", "dscale", "dshift", "dW", "dres"),
                          *site_grads):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        check(err <= cfg["site_rtol"] * scale, "resnet_nhwc_agreement: "
              "fused site %s differs by %g (largest CPU value %g)"
              % (name, err, scale))
        site_worst[name] = err / scale

    B, image = cfg["batch"], cfg["image_shape"]
    kw = {k: cfg[k] for k in ("num_classes", "num_layers", "image_shape")}
    np_args, np_aux = seeded_resnet_params(resnet.get_symbol(**kw), B, image)
    np_args = {n: _nhwc(a) for n, a in np_args.items()}
    x, y = _image_batches(image, B, SEED + 15, cfg["num_classes"])
    runs = []
    for ctx, scale in ((ctxs[0], 1.0), (ctxs[1], 1.0),
                       (ctxs[1], 1.0 + cfg["perturb"])):
        sym = fuse_conv_bn(resnet.get_symbol(layout="NHWC", **kw))
        ts = TrainStep(sym, mx.optimizer.SGD(learning_rate=0.05,
                                             momentum=0.9, wd=1e-4,
                                             rescale_grad=1.0 / B),
                       data_shapes={"data": (B,) + _nhwc(x).shape[1:]},
                       label_shapes={"softmax_label": (B,)}, ctx=ctx)
        ts.init_params(mx.init.Xavier(), arg_params=np_args,
                       aux_params=np_aux)
        prob = ts.step({"data": _nhwc(x) * np.float32(scale),
                        "softmax_label": y})[0].cpu().numpy()
        loss = float(-np.log(prob[np.arange(B), y.astype(int)]).mean())
        grad = np.concatenate([g.cpu().numpy().ravel()
                               for g in ts.grads.values()])
        runs.append((loss, prob, grad,
                     {n: a.cpu().numpy() for n, a in ts.auxs.items()}))
        del ts
    (gl, gp, gg, ga), (cl, cp, cg, ca), (_, _, pg, _) = runs
    check(abs(gl - cl) <= cfg["loss_rtol"] * abs(cl),
          "resnet_nhwc_agreement: loss %g on the card, %g on the CPU"
          % (gl, cl))
    check(np.allclose(gp, cp, rtol=0, atol=cfg["prob_atol"]),
          "resnet_nhwc_agreement: probabilities differ by %g"
          % float(np.abs(gp - cp).max()))
    worst_aux = 0.0
    for name, ref in ca.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(ga[name] - ref).max())
        check(err <= cfg["aux_rtol"] * scale, "resnet_nhwc_agreement: %s "
              "differs by %g after the train forward (largest CPU value %g)"
              % (name, err, scale))
        worst_aux = max(worst_aux, err / scale if scale else 0.0)
    norm = float(np.linalg.norm(cg))
    grad_l2 = float(np.linalg.norm(gg - cg)) / norm
    check(grad_l2 <= cfg["grad_l2"], "resnet_nhwc_agreement: the gradient "
          "differs by %g (relative L2) between the card and the CPU"
          % grad_l2)
    emit({"phase": "resnet_nhwc_agreement", "config": cfg,
          "fused_sites": count_fused(sym), "site_worst_rel_err": site_worst,
          "loss_card": gl, "loss_cpu": cl,
          "prob_max_abs_err": float(np.abs(gp - cp).max()),
          "worst_aux_rel_err": worst_aux, "grad_rel_l2_card_vs_cpu": grad_l2,
          "grad_rel_l2_cpu_vs_perturbed_cpu":
              float(np.linalg.norm(pg - cg)) / norm})


# ----------------------------------------------------------------------
# bf16: the kernels' bf16 forms, training, agreement; head_dim tiling
# ----------------------------------------------------------------------
def close_bf16_out(torch, a, b):
    """A bf16 attention output against its plain version (phase_prefill's
    bf16 bound): rtol 2^-7, at least one bf16 ulp of the plain value,
    atol 1e-5; each rounds an f32 result to bf16 once."""
    return bool(torch.allclose(a.float(), b.float(), rtol=2.0 ** -7,
                               atol=ATOL))


def close_bf16(torch, a, b):
    """bf16 kernel against its plain version: within one bf16 ulp of the
    value (2^-7 relative) plus 2^-9 of the array's largest magnitude.
    Each output is an f32 sum rounded to bf16 once; the kernel rounds
    its bf16 summands (P, dS, the activation) where the plain version
    does, but from f32 values computed in another order, so a summand
    may round to its neighbour, which moves a sum by a fraction of the
    array's scale."""
    a, b = a.float(), b.float()
    lim = BF16_RTOL * b.abs() + BF16_ATOL_SHARE * float(b.abs().max())
    return bool(((a - b).abs() <= lim).all())


def close_f16(torch, a, b):
    """An f16 kernel against its plain version (rows 1, 2, 3 and 5):
    rtol 2^-10, at least one f16 ulp of the plain value, atol 1e-5; each
    rounds an f32 result to f16 once."""
    return bool(torch.allclose(a.float(), b.float(), rtol=F16_RTOL,
                               atol=ATOL))


def close_f16_flash(torch, a, b):
    """Row 8's f16 forward against its plain version: one f16 ulp of the
    value plus 2^-12 of the array's largest magnitude (F16_FLASH_ATOL_
    SHARE: P rounds to f16 at another point than the plain version's)."""
    a, b = a.float(), b.float()
    lim = F16_RTOL * b.abs() + F16_FLASH_ATOL_SHARE * float(b.abs().max())
    return bool(((a - b).abs() <= lim).all())


def _flash_rows(torch, mxk, q, k, v, do, sc, flush, dtype, peak):
    """Times and bounds of the three flash kernels on (q, k, v, do),
    beside SDPA forward and its autograd backward."""
    import torch.nn.functional as F
    B, H, S, D = q.shape
    o, lse = mxk.flash_attention_fwd(q, k, v, scale=sc)
    delta = (do.float() * o.float()).sum(-1)
    ms_f = time_ms(torch, lambda: mxk.flash_attention_fwd(q, k, v, scale=sc),
                   flush)
    ms_dkv = time_ms(torch, lambda: mxk.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, scale=sc), flush)
    ms_dq = time_ms(torch, lambda: mxk.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, scale=sc), flush)
    pl_f = time_ms(torch, lambda: mxk.flash_attention_fwd_plain(
        q, k, v, scale=sc), flush, reps=20)
    pl_dkv = time_ms(torch, lambda: mxk.flash_attention_bwd_dkv_plain(
        q, k, v, do, lse, delta, scale=sc), flush, reps=20)
    pl_dq = time_ms(torch, lambda: mxk.flash_attention_bwd_dq_plain(
        q, k, v, do, lse, delta, scale=sc), flush, reps=20)
    lib_f = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sc), flush)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=sc)
    lib_b = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qr, kr, vr), do, retain_graph=True), flush)
    del o_lib, qr, kr, vr
    tri = 2.0 * B * H * D * S * (S + 1) / 2
    io = B * H * S * D * q.element_size()
    rows = []
    for name, ms, plain_ms, n_prod, nbytes, lib in (
            ("flash_attention_fwd", ms_f, pl_f, 2, 4 * io + B * H * S * 4,
             lib_f),
            ("flash_attention_bwd_dkv", ms_dkv, pl_dkv, 4,
             6 * io + 2 * B * H * S * 4, lib_b),
            ("flash_attention_bwd_dq", ms_dq, pl_dq, 3,
             5 * io + 2 * B * H * S * 4, lib_b)):
        b_ms, b_by = bound(nbytes, n_prod * tri, peak)
        rows.append({"name": name, "route": "cuda", "dtype": dtype,
                     "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
                     "replaces": "mxnet_tpu/ops/nn.py:744", "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib,
                     "tflops": n_prod * tri / ms / 1e9,
                     "bytes": nbytes, "flops": n_prod * tri})
    return rows


def _ptxas(source, entries):
    """ptxas's stack/spill and register lines (``-Xptxas=-v``) for the
    entry functions named in ``entries`` ({key: substring of the mangled
    name}) in csrc/<source>.cu's build log."""
    import re
    from mxnet_tpu_torch.kernels import _build
    lines = _build.log_path(source).read_text().splitlines()
    found = {}
    for i, line in enumerate(lines):
        key = next((k for k, sub in entries.items()
                    if "Compiling entry function" in line and sub in line),
                   None)
        if key is None:
            continue
        spill = next(x for x in lines[i + 1:i + 4] if "spill" in x)
        used = next(x for x in lines[i + 1:i + 4] if "registers" in x)
        num = lambda pat, text: int(re.search(pat, text).group(1))
        found[key] = {"lines": [spill.strip(),
                                used.split(" : ", 1)[-1].strip()],
                      "registers": num(r"Used (\d+) registers", used),
                      "stack_bytes": num(r"(\d+) bytes stack frame", spill),
                      "spill_stores": num(r"(\d+) bytes spill stores", spill),
                      "spill_loads": num(r"(\d+) bytes spill loads", spill)}
    check(set(found) == set(entries), "ptxas log of %s.cu: entry functions "
          "%s not found" % (source, sorted(set(entries) - set(found))))
    return found


# the 16-bit GEMM's element types as its instances' mangled names spell
# them (fused_gemm16_kernel<T, BN, W_KN, VEC_X>)
GEMM16_TYPES = {"bfloat16": "13__nv_bfloat16", "float16": "6__half"}


def _fused_gemm_ptxas(source, dtype="bfloat16"):
    """The 16-bit GEMM's ``dtype`` instances in csrc/<source>.cu's build:
    ptxas's registers, stack and spills (none allowed) and each tile's
    dynamic shared memory (the same for both 16-bit types), printed."""
    import ctypes
    from mxnet_tpu_torch.kernels import _build
    w_kn = int(source == "fused_band4d")
    entries = {"128x%d:%s" % (bn, "cp_async" if vec else "elementwise"):
               "fused_gemm16_kernelI%sLi%dELb%dELb%dE"
               % (GEMM16_TYPES[dtype], bn, w_kn, vec)
               for bn in FUSED_GEMM_TILES for vec in (1, 0)}
    ptx = _ptxas(source, entries)
    lib = _build.load(source)
    lib.mx_fused_gemm_bf16_smem.argtypes = [ctypes.c_int]
    lib.mx_fused_gemm_bf16_smem.restype = ctypes.c_int
    for key in sorted(ptx):
        bn = int(key.split(":")[0].split("x")[1])
        ptx[key]["dynamic_smem_bytes"] = lib.mx_fused_gemm_bf16_smem(bn)
        print("ptxas %s fused_gemm16_kernel<%s> %s: %s; %d bytes of dynamic "
              "shared memory" % (source, dtype, key,
                                 "; ".join(ptx[key]["lines"]),
                                 ptx[key]["dynamic_smem_bytes"]), flush=True)
        check(ptx[key]["spill_stores"] == 0 and ptx[key]["spill_loads"] == 0,
              "%s: the %s GEMM %s spills: %s"
              % (source, dtype, key, ptx[key]["lines"][0]))
    return ptx


def _flash_pairs(torch, mxk, q, k, v, do, sc):
    """(what, kernel result, plain result) for the forward's output and
    lse, dK/dV and dQ on one set of inputs (f32 or bf16); the backward kernels
    take the plain forward's lse and Dr, as their plain versions do."""
    o, lse = mxk.flash_attention_fwd(q, k, v, scale=sc)
    o_ref, lse_ref = mxk.flash_attention_fwd_plain(q, k, v, scale=sc)
    delta = (do.float() * o_ref.float()).sum(-1)
    got = (o, lse) + mxk.flash_attention_bwd_dkv(
        q, k, v, do, lse_ref, delta, scale=sc) + (
        mxk.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta, scale=sc),)
    ref = (o_ref, lse_ref) + mxk.flash_attention_bwd_dkv_plain(
        q, k, v, do, lse_ref, delta, scale=sc) + (
        mxk.flash_attention_bwd_dq_plain(q, k, v, do, lse_ref, delta,
                                         scale=sc),)
    torch.cuda.synchronize()
    return list(zip(("out", "lse", "dk", "dv", "dq"), got, ref))


def _flash16_ptxas(torch, dtype):
    """ptxas's register, stack and spill lines (no spills allowed) of
    the three 16-bit flash kernels' instances at ``dtype``, each in its
    two forms (compile-time step counts when every head_dim chunk is
    full, D % 128 == 0; a branch per step otherwise), printed with their
    dynamic shared memory at D = 128."""
    import ctypes
    from mxnet_tpu_torch.kernels import _build
    forms = {"full": "Lb1", "ragged": "Lb0"}
    entries = FLASH_16_ENTRIES[dtype]
    ptx = _ptxas("flash_attention", {
        "%s:%s" % (n, form): entry + tag for n, (entry, _) in entries.items()
        for form, tag in forms.items()})
    lib = _build.load("flash_attention")
    lib.mx_flash_bf16_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mx_flash_bf16_smem.restype = ctypes.c_int
    for key in sorted(ptx):
        name, form = key.split(":")
        entry, which = entries[name]
        ptx[key]["dynamic_smem_bytes_d128"] = lib.mx_flash_bf16_smem(which,
                                                                     128)
        print("ptxas %s (%s form): %s; %d bytes of dynamic shared memory at "
              "D = 128" % (entry, form, "; ".join(ptx[key]["lines"]),
                           ptx[key]["dynamic_smem_bytes_d128"]), flush=True)
        check(ptx[key]["spill_stores"] == 0 and
              ptx[key]["spill_loads"] == 0,
              "flash_attention: the %s %s (%s) spills" % (dtype, name, form))
    return ptx


def phase_flash_bf16(torch, mxk, dev, flush):
    """The bf16 forms of the three flash kernels (tensor cores) at the
    bf16 transformer's shape (4, 16, 1024, 128) and at the edges of
    their tiling (FLASH_BF16_EDGES: S 17 and 1000, D 80 and 36, batch 1,
    head_dim 256 and 512), each against its plain version (close_bf16;
    the f32 lse exactly as the f32 phase holds it, rtol 1e-4 / atol
    1e-5), FlashAttentionFn end to end against autograd through the
    materialised reference (relative L2 under 1e-2), and timed beside
    SDPA on the same bf16 tensors, with each kernel's achieved TFLOP/s.
    The bound is bytes over 3.35 TB/s or operations over the dense bf16
    tensor-core peak.  First prints ptxas's register, stack and spill
    lines for the three kernels and their dynamic shared memory at
    D = 128."""
    emit({"phase": "flash_bf16_ptxas",
          "kernels": _flash16_ptxas(torch, "bfloat16")})
    B, H, S, D = 4, 16, 1024, 128
    sc = 1.0 / D ** 0.5
    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(SEED + 21)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(dev).to(bf)
                   for _ in range(4))
    errs = {}

    def hold(pairs, tag=""):
        for what, a, b in pairs:
            check(a.dtype == b.dtype, "flash bf16 %s%s: dtype %s, plain %s"
                  % (what, tag, a.dtype, b.dtype))
            ok = close(torch, a, b) if what == "lse" \
                else close_bf16(torch, a, b)
            check(ok, "flash attention bf16 %s%s disagrees with its plain "
                  "version (max abs err %g)" % (what, tag, max_err(a, b)))
            errs[what + tag] = max_err(a, b)

    hold(_flash_pairs(torch, mxk, q, k, v, do, sc))
    for shape in FLASH_BF16_EDGES:
        ins = [torch.randn(*shape, generator=g).to(dev).to(bf)
               for _ in range(4)]
        hold(_flash_pairs(torch, mxk, *ins, 1.0 / shape[-1] ** 0.5),
             "_" + "x".join(map(str, shape)))
        del ins
    ends = []
    for fn in (mxk.flash_attention, mxk.flash_attention_plain):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins, scale=sc)
        ends.append([out.detach()] + list(torch.autograd.grad(out, ins, do)))
        del out, ins
    for what, a, b in zip(("out", "dq", "dk", "dv"), *ends):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        check(rel < 1e-2, "FlashAttentionFn bf16 %s: relative L2 %g against "
              "autograd through the reference" % (what, rel))
        errs["fn_%s_rel_l2" % what] = rel
    del ends
    rows = _flash_rows(torch, mxk, q, k, v, do, sc, flush, "bfloat16",
                       BF16_FLOPS_PER_S)
    for r in rows:
        r["max_abs_err"] = max(v for n, v in errs.items()
                               if not n.startswith("fn_"))
    emit({"phase": "flash_bf16", "kernels": rows, "shape": [B, H, S, D],
          "edge_shapes": [list(e) for e in FLASH_BF16_EDGES],
          "errors": errs, "tolerance": "one bf16 ulp (2^-7 relative) plus "
          "2^-9 of the array's largest value; lse rtol 1e-4 / atol 1e-5",
          "library_call": "F.scaled_dot_product_attention(is_causal=True) on "
                          "the bf16 tensors, forward and autograd backward"})
    return rows


def phase_layernorm_bf16(torch, mxk, dev, flush):
    """LayerNorm forward and backward in bf16 (bf16 x, gamma, beta, dy;
    f32 statistics) at the bf16 transformer's 4096 x 2048 rows, with and
    without a residual, against the plain versions: outputs close_bf16,
    statistics rtol 1e-4 / atol 1e-5; the forward also at the widths of
    LN_FWD_EDGES and on misaligned rows, the backward at those of
    LN_BWD_EDGES, two runs bit-identical (the forward's ptxas lines are
    phase_layernorm's: its instances cover both types); timed beside
    F.layer_norm and aten.native_layer_norm_backward on the same bf16
    tensors, the forward also after a flush that reads and 200 calls
    back to back.  Returns the two kernels-line rows."""
    import torch.nn.functional as F
    rows, cols = 4096, 2048
    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(SEED + 22)
    x, res, dy = (torch.randn(rows, cols, generator=g).to(dev).to(bf)
                  for _ in range(3))
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(bf)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(bf)
    errs = {}
    for r in (None, res):
        tag = "_res" if r is not None else ""
        got = mxk.layernorm_fused(x, gamma, beta, residual=r)
        ref = mxk.layernorm_plain(x, gamma, beta, residual=r)
        _, mean, rstd = ref
        got += mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy, residual=r)
        ref += mxk.layernorm_bwd_plain(x, gamma, mean, rstd, dy, residual=r)
        torch.cuda.synchronize()
        for what, a, b in zip(("out", "mean", "rstd", "dx", "dgamma",
                               "dbeta"), got, ref):
            ok = close(torch, a, b) if what in ("mean", "rstd") \
                else close_bf16(torch, a, b)
            check(ok, "layernorm bf16 %s%s disagrees with its plain version "
                  "(max abs err %g)" % (what, tag, max_err(a, b)))
            errs[what + tag] = max_err(a, b)
    # the forward and the backward again, two runs bit-identical, at 4096
    # x 2048 and at the widths of LN_FWD_EDGES (and misaligned rows) and
    # LN_BWD_EDGES, with and without a residual
    _ln_fwd_hold(torch, mxk, x, gamma, beta, res, "bfloat16 %d x %d"
                 % (rows, cols), errs)
    _ln_fwd_edges(torch, mxk, dev, g, bf, errs)
    for r_e, c_e in ((rows, cols),) + LN_BWD_EDGES:
        _ln_bwd_hold(torch, mxk, dev, g, r_e, c_e, bf, errs)
    _, mean, rstd = mxk.layernorm_plain(x, gamma, beta)
    m2, r2 = mean.reshape(rows, 1), rstd.reshape(rows, 1)
    out = []
    for name, src, fn, plain, lib, nbytes, flops in (
            ("layernorm_fused", "mxnet_tpu/pallas/layernorm.py:127",
             lambda: mxk.layernorm_fused(x, gamma, beta),
             lambda: mxk.layernorm_plain(x, gamma, beta),
             lambda: F.layer_norm(x, (cols,), gamma, beta, 1e-5),
             2 * rows * cols * 2 + 2 * cols * 2 + 2 * rows * 4,
             8 * rows * cols),
            ("layernorm_fused_bwd", "mxnet_tpu/pallas/layernorm.py:158",
             lambda: mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy),
             lambda: mxk.layernorm_bwd_plain(x, gamma, mean, rstd, dy),
             lambda: torch.ops.aten.native_layer_norm_backward(
                 dy, x, [cols], m2, r2, gamma, beta, [True, True, True]),
             3 * rows * cols * 2 + 3 * cols * 2 + 2 * rows * 4,
             12 * rows * cols)):
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        out.append({"name": name, "route": "cuda", "dtype": "bfloat16",
                    "source": "mxnet_tpu_torch/csrc/layernorm.cu",
                    "replaces": src, "max_abs_err": max(errs.values()),
                    "ms": time_ms(torch, fn, flush),
                    "plain_ms": time_ms(torch, plain, flush),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": time_ms(torch, lib, flush)})
    out[1]["back_to_back_ms"] = pipelined_ms(
        torch, lambda: mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy))
    fwd = lambda: mxk.layernorm_fused(x, gamma, beta)
    lib = lambda: F.layer_norm(x, (cols,), gamma, beta, 1e-5)
    clean = ReadFlush(flush)
    out[0].update(read_flush_ms=time_ms(torch, fwd, clean),
                  library_read_flush_ms=time_ms(torch, lib, clean),
                  back_to_back_ms=pipelined_ms(torch, fwd),
                  library_back_to_back_ms=pipelined_ms(torch, lib))
    # the bf16 serve step's rows of the forward (its 8 decode slots and
    # its 64-row chunk), with and without a residual, beside F.layer_norm
    serve = {}
    for n in (8, 64):
        xs, rs_ = x[:n].contiguous(), res[:n].contiguous()
        for r in (None, rs_):
            got = mxk.layernorm_fused(xs, gamma, beta, residual=r)
            ref = mxk.layernorm_plain(xs, gamma, beta, residual=r)
            torch.cuda.synchronize()
            check(close_bf16(torch, got[0], ref[0])
                  and all(close(torch, a, b) for a, b in zip(got[1:], ref[1:])),
                  "layernorm bf16 at %d serve rows%s disagrees with its "
                  "plain version (max abs err %g)"
                  % (n, "" if r is None else " with a residual",
                     max_err(got[0], ref[0])))
            errs["serve_%d%s" % (n, "" if r is None else "_res")] = \
                max_err(got[0], ref[0])
        fn = lambda: mxk.layernorm_fused(xs, gamma, beta)
        lib = lambda: F.layer_norm(xs, (cols,), gamma, beta, 1e-5)
        b_ms, b_by = bound(2 * n * cols * 2 + 2 * cols * 2 + 2 * n * 4,
                           8 * n * cols, BF16_FLOPS_PER_S)
        serve[n] = {"ms": time_ms(torch, fn, flush),
                    "plain_ms": time_ms(torch, lambda: mxk.layernorm_plain(
                        xs, gamma, beta), flush),
                    "library_ms": time_ms(torch, lib, flush),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "back_to_back_ms": pipelined_ms(torch, fn),
                    "library_back_to_back_ms": pipelined_ms(torch, lib)}
    out.append({"name": "layernorm_fused", "route": "cuda",
                "dtype": "bfloat16", "path": "serve_bf16 rows (8, 64 rows)",
                "source": "mxnet_tpu_torch/csrc/layernorm.cu",
                "replaces": "mxnet_tpu/pallas/layernorm.py:127",
                "max_abs_err": max(e for w, e in errs.items()
                                   if w.startswith("serve_")),
                **serve[8], "rows_64": serve[64]})
    for k in out:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    emit({"phase": "layernorm_bf16", "rows": rows, "cols": cols,
          "errors": errs, "edges": [list(e) for e in LN_BWD_EDGES],
          "fwd_edges": [list(e) for e in LN_FWD_EDGES], "kernels": out})
    return out


def phase_layernorm_f16(torch, mxk, dev, flush):
    """Row 3's f16 form (f16 x, gamma and beta: the f16 serving symbols'
    LayerNorms) against its plain version, output within close_f16, the
    f32 statistics at rtol 1e-4 / atol 1e-5, two runs bit-identical, with
    and without a residual: at the rows of every f16 path (8 and 64, the
    serve step's decode slots and chunk; 40, the spec step's spans; 1024,
    the draft model's; 8192, the one-shot prefill's) of 2048 columns, at
    the widths of LN_FWD_EDGES and on misaligned rows.  Timed at the
    serve rows beside F.layer_norm on the same f16 tensors (alone, and
    200 calls back to back).  First prints ptxas's lines of the f16
    instances (no spills).  Returns the kernels-line row."""
    import torch.nn.functional as F
    hf = torch.float16
    ptx = _instances_ptxas("layernorm",
                           r"layernorm_fwd_\w+?_kernelI6__half\w+?E(?=Ev)",
                           "the f16 LayerNorm forward")
    cols = 2048
    g = torch.Generator(device="cpu").manual_seed(SEED + 40)
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(hf)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(hf)
    errs = {}
    serve = {}
    for rows in (8, 64, 40, 1024, 8192):
        x, res = (torch.randn(rows, cols, generator=g).to(dev).to(hf)
                  for _ in range(2))
        _ln_fwd_hold(torch, mxk, x, gamma, beta, res,
                     "float16 %d x %d" % (rows, cols), errs)
        if rows not in (8, 64):
            continue
        fn = lambda: mxk.layernorm_fused(x, gamma, beta)
        lib = lambda: F.layer_norm(x, (cols,), gamma, beta, 1e-5)
        b_ms, b_by = bound(2 * rows * cols * 2 + 2 * cols * 2 + 2 * rows * 4,
                           8 * rows * cols, BF16_FLOPS_PER_S)
        serve[rows] = {"ms": time_ms(torch, fn, flush),
                       "plain_ms": time_ms(torch, lambda: mxk.layernorm_plain(
                           x, gamma, beta), flush),
                       "library_ms": time_ms(torch, lib, flush),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "back_to_back_ms": pipelined_ms(torch, fn),
                       "library_back_to_back_ms": pipelined_ms(torch, lib)}
    _ln_fwd_edges(torch, mxk, dev, g, hf, errs)
    row = {"name": "layernorm_fused", "route": "cuda", "dtype": "float16",
           "path": "serve_f16 rows (8, 64 rows)",
           "source": "mxnet_tpu_torch/csrc/layernorm.cu",
           "replaces": "mxnet_tpu/pallas/layernorm.py:127",
           "max_abs_err": max(errs.values()), **serve[8], "rows_64": serve[64]}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    emit({"phase": "layernorm_f16", "cols": cols, "errors": errs,
          "fwd_edges": [list(e) for e in LN_FWD_EDGES], "ptxas": ptx,
          "tolerance": "out: rtol 2^-10 (one f16 ulp) / atol 1e-5; mean "
                       "and rstd: rtol 1e-4 / atol 1e-5", "kernel": row})
    return row


def phase_layernorm_bwd_f16(torch, mxk, dev, flush):
    """Row 4's f16 form (f16 x, gamma and dy; f32 statistics: the f16
    transformer's training LayerNorms) at the training shape 4096 x 2048
    and at the widths of LN_BWD_EDGES, with and without a residual, two
    runs bit-identical, against its plain version: dx at rtol 2^-10 (one
    f16 ulp: each side rounds one f32 value) / atol 1e-5, dgamma and
    dbeta at rtol 2^-10 / atol 2e-4 (f32 sums over every row in another
    order, rounded once to f16: phase_layernorm_bwd's f32 atol).  Timed
    at 4096 x 2048 beside aten.native_layer_norm_backward on the same f16
    tensors, bounded by bytes, with 200 calls back to back.  First prints
    ptxas's lines of the f16 instances (no spills).  Returns the
    kernels-line row."""
    hf = torch.float16
    ptx = _instances_ptxas("layernorm",
                           r"layernorm_bwd_\w+?_kernelI6__half\w*?E(?=Ev)",
                           "the f16 LayerNorm backward")
    rows, cols = 4096, 2048
    g = torch.Generator(device="cpu").manual_seed(SEED + 42)
    errs = {}
    for r_e, c_e in ((rows, cols),) + LN_BWD_EDGES:
        _ln_bwd_hold(torch, mxk, dev, g, r_e, c_e, hf, errs)
    x, dy = (torch.randn(rows, cols, generator=g).to(dev).to(hf)
             for _ in range(2))
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(hf)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(hf)
    _, mean, rstd = mxk.layernorm_plain(x, gamma, beta)
    m2, r2 = mean.reshape(rows, 1), rstd.reshape(rows, 1)
    fn = lambda: mxk.layernorm_fused_bwd(x, gamma, mean, rstd, dy)
    nbytes = 3 * rows * cols * 2 + 3 * cols * 2 + 2 * rows * 4
    b_ms, b_by = bound(nbytes, 12 * rows * cols, BF16_FLOPS_PER_S)
    ms = time_ms(torch, fn, flush)
    row = {"name": "layernorm_fused_bwd", "route": "cuda", "dtype": "float16",
           "path": "fit_f16's training step",
           "source": "mxnet_tpu_torch/csrc/layernorm.cu",
           "replaces": "mxnet_tpu/pallas/layernorm.py:158",
           "max_abs_err": max(errs.values()), "ms": ms,
           "plain_ms": time_ms(torch, lambda: mxk.layernorm_bwd_plain(
               x, gamma, mean, rstd, dy), flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(
               torch, lambda: torch.ops.aten.native_layer_norm_backward(
                   dy, x, [cols], m2, r2, gamma, beta, [True, True, True]),
               flush),
           "back_to_back_ms": pipelined_ms(torch, fn),
           "share_of_bound": b_ms / ms, "gbps": nbytes / ms / 1e6}
    emit({"phase": "layernorm_bwd_f16", "rows": rows, "cols": cols,
          "errors": errs, "edges": [list(e) for e in LN_BWD_EDGES],
          "ptxas": ptx, "tolerance": "dx rtol 2^-10 (one f16 ulp) / atol "
          "1e-5; dgamma, dbeta rtol 2^-10 / atol 2e-4",
          "library_call": "aten.native_layer_norm_backward (f16)",
          "kernel": row})
    return row


def _overflow_pairs(torch, mxk, dev, g):
    """Row 8's f16 backward where dS passes f16's range: (1, 2, 256, 64)
    inputs whose dO is N(0, 1) but for FLASH_F16_OVERFLOW's rows, scaled
    so that |dS| = P |dP - Dr| scale passes 65504 over most of their
    keys; the kernels' (dk, dv, dq) beside the plain versions', from
    the plain forward's lse and Dr."""
    hf = torch.float16
    B, H, S, D = FLASH_F16_OVERFLOW["shape"]
    q, k, v, do = (torch.randn(B, H, S, D, generator=g) for _ in range(4))
    v = v * FLASH_F16_OVERFLOW["v_scale"]
    for r in FLASH_F16_OVERFLOW["rows"]:
        do[:, :, r] = (do[:, :, r] * FLASH_F16_OVERFLOW["do_scale"]).clamp(
            -60000, 60000)
    q, k, v, do = (t.to(dev).to(hf) for t in (q, k, v, do))
    sc = 1.0 / D ** 0.5
    o_ref, lse = mxk.flash_attention_fwd_plain(q, k, v, scale=sc)
    delta = (do.float() * o_ref.float()).sum(-1)
    got = mxk.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=sc) + (
        mxk.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=sc),)
    ref = mxk.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                            scale=sc) + (
        mxk.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale=sc),)
    torch.cuda.synchronize()
    return list(zip(("dk", "dv", "dq"), got, ref))


def _hold_overflow(torch, what, a, b):
    """The overflow case's bound: the kernel is non-finite exactly where
    the plain version is, save for an output whose finite side lies
    within one f16 ulp of 65504 (each side rounds its f32 sum once, in
    another order, at the edge of the range), and the finite values
    agree within close_f16_flash.  Returns the count of non-finite
    elements."""
    a, b = a.float(), b.float()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    edge = torch.where(fa, a, b).abs() >= 65504 * (1 - F16_RTOL)
    check(bool(((fa == fb) | edge).all()), "flash f16 overflow %s: the "
          "kernel is finite at %d elements where the plain version is not, "
          "and not at %d where it is" % (what, int((fa & ~fb & ~edge).sum()),
                                         int((~fa & fb & ~edge).sum())))
    both = fa & fb
    check(close_f16_flash(torch, a[both], b[both]), "flash f16 overflow %s: "
          "finite values disagree (max abs err %g)"
          % (what, max_err(a[both], b[both])))
    return int((~fb).sum())


def phase_flash_f16(torch, mxk, dev, flush):
    """Row 8's f16 forms (the 16-bit kernels at f16: P and dS rounded to
    one f16 term each, dP and every sum f32).  The forward (the draft
    model's spans in f16 serving and the f16 training step) against its
    plain version at the draft model's (1, 16, 1024, 128) and at
    FLASH_F16_EDGES: the output within close_f16_flash, the f32 lse at
    rtol 1e-4 / atol 1e-5, two runs bit-identical.  dK/dV and dQ (the
    f16 training step's) with the forward at the training shape (4, 16,
    1024, 128) and at the bf16 phase's edges (FLASH_BF16_EDGES: ragged S
    and D, batch 1, head_dim 256 and 512), each output within
    close_f16_flash (one f16 ulp plus 2^-12 of the array's largest:
    bf16's bound scaled by f16's 3 more bits), two runs bit-identical;
    FlashAttentionFn end to end against autograd through the reference
    within relative L2 FLASH_F16_FN_L2; the overflow case
    (_overflow_pairs: the kernel non-finite exactly where the plain
    version is).  Timed: the forward at the draft shape beside SDPA's
    f16 forward, dK/dV and dQ at the training shape beside SDPA's f16
    autograd backward, bounded by bytes or by operations at the dense
    16-bit tensor-core peak.  First prints ptxas's lines of the three
    f16 kernels' two forms (no spills).  Returns the kernels-line rows:
    forward, dK/dV, dQ."""
    import torch.nn.functional as F
    hf = torch.float16
    ptx = _flash16_ptxas(torch, "float16")
    g = torch.Generator(device="cpu").manual_seed(SEED + 41)
    errs = {}
    shape, train = FLASH_F16_SHAPES["draft"], FLASH_F16_SHAPES["train"]
    for shp in (shape,) + FLASH_F16_EDGES:
        q, k, v = (torch.randn(*shp, generator=g).to(dev).to(hf)
                   for _ in range(3))
        sc = 1.0 / shp[-1] ** 0.5
        o, lse = mxk.flash_attention_fwd(q, k, v, scale=sc)
        o2, lse2 = mxk.flash_attention_fwd(q, k, v, scale=sc)
        o_ref, lse_ref = mxk.flash_attention_fwd_plain(q, k, v, scale=sc)
        torch.cuda.synchronize()
        tag = "x".join(map(str, shp))
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              "flash_attention_fwd f16 %s: two runs differ" % tag)
        check(o.dtype == hf and close_f16_flash(torch, o, o_ref),
              "flash_attention_fwd f16 %s disagrees with its plain version "
              "(max abs err %g)" % (tag, max_err(o, o_ref)))
        check(close(torch, lse, lse_ref), "flash_attention_fwd f16 %s: lse "
              "disagrees (max abs err %g)" % (tag, max_err(lse, lse_ref)))
        errs["out " + tag] = max_err(o, o_ref)
        errs["lse " + tag] = max_err(lse, lse_ref)
    for shp in (train,) + FLASH_BF16_EDGES:
        ins = [torch.randn(*shp, generator=g).to(dev).to(hf)
               for _ in range(4)]
        sc = 1.0 / shp[-1] ** 0.5
        pairs = _flash_pairs(torch, mxk, *ins, sc)
        again = _flash_pairs(torch, mxk, *ins, sc)
        tag = "x".join(map(str, shp))
        for (what, a, b), (_, a2, _) in zip(pairs, again):
            check(torch.equal(a, a2), "flash f16 %s %s: two runs differ"
                  % (what, tag))
            ok = close(torch, a, b) if what == "lse" \
                else a.dtype == hf and close_f16_flash(torch, a, b)
            check(ok, "flash attention f16 %s %s disagrees with its plain "
                  "version (max abs err %g)" % (what, tag, max_err(a, b)))
            errs["%s %s" % (what, tag)] = max_err(a, b)
        del ins, pairs, again
    q, k, v, do = (torch.randn(*train, generator=g).to(dev).to(hf)
                   for _ in range(4))
    sc = 1.0 / train[-1] ** 0.5
    ends = []
    for fn in (mxk.flash_attention, mxk.flash_attention_plain):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins, scale=sc)
        ends.append([out.detach()] + list(torch.autograd.grad(out, ins, do)))
        del out, ins
    for what, a, b in zip(("out", "dq", "dk", "dv"), *ends):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        check(rel < FLASH_F16_FN_L2, "FlashAttentionFn f16 %s: relative L2 "
              "%g against autograd through the reference" % (what, rel))
        errs["fn_%s_rel_l2" % what] = rel
    del ends
    overflow = {}
    for what, a, b in _overflow_pairs(torch, mxk, dev, g):
        overflow[what + "_non_finite"] = _hold_overflow(torch, what, a, b)
    check(overflow["dk_non_finite"] and overflow["dq_non_finite"],
          "flash f16 overflow: dS did not overflow: %s" % overflow)
    B, H, S, D = shape
    tri = 2.0 * B * H * D * S * (S + 1) / 2
    nbytes = 4 * B * H * S * D * 2 + B * H * S * 4
    b_ms, b_by = bound(nbytes, 2 * tri, BF16_FLOPS_PER_S)
    qd, kd, vd = (t[:1].contiguous() for t in (q, k, v))
    fwd = lambda: mxk.flash_attention_fwd(qd, kd, vd, scale=sc)
    ms = time_ms(torch, fwd, flush)
    errs_k = max(e for n, e in errs.items() if not n.startswith("fn_"))
    row = {"name": "flash_attention_fwd", "route": "cuda", "dtype": "float16",
           "path": "the f16 draft model's spans",
           "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
           "replaces": "mxnet_tpu/ops/nn.py:744",
           "max_abs_err": errs_k, "ms": ms,
           "plain_ms": time_ms(torch, lambda: mxk.flash_attention_fwd_plain(
               qd, kd, vd, scale=sc), flush, reps=20),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
               qd, kd, vd, is_causal=True, scale=sc), flush),
           "back_to_back_ms": pipelined_ms(torch, fwd),
           "tflops": 2 * tri / ms / 1e9, "bytes": nbytes, "flops": 2 * tri}
    rows = _flash_rows(torch, mxk, q, k, v, do, sc, flush, "float16",
                       BF16_FLOPS_PER_S)
    row["train_shape"] = {key: rows[0][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops")}
    for r in rows[1:]:
        r["max_abs_err"] = errs_k
        r["path"] = "fit_f16's training step"
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    emit({"phase": "flash_f16", "shape": list(shape), "train_shape":
          list(train), "edge_shapes": [list(e) for e in FLASH_F16_EDGES],
          "backward_edge_shapes": [list(e) for e in FLASH_BF16_EDGES],
          "errors": errs, "overflow": dict(FLASH_F16_OVERFLOW, **overflow),
          "ptxas": ptx,
          "tolerance": "out, dk, dv, dq: one f16 ulp (2^-10 relative) plus "
                       "2^-12 of the array's largest value; lse rtol 1e-4 / "
                       "atol 1e-5; FlashAttentionFn relative L2 %g"
                       % FLASH_F16_FN_L2,
          "library_call": "F.scaled_dot_product_attention(is_causal=True) "
                          "forward and autograd backward on the f16 tensors",
          "kernels": [row] + rows[1:]})
    return [row] + rows[1:]


def phase_dtype_codes(torch, mxk, dev):
    """Every C entry point that takes dtype codes returns an error for a
    code or a pairing it has no kernel for (f16 beside another type, an
    unknown code), and launches nothing, never another type's kernel;
    codes 0, 1 and 2 (f32, bf16, f16) run rows 7 and 10 through their C
    entry points, each held against the plain version; the wrappers
    refuse f16 tensors bound for row 6 (f32 by design, naming ROADMAP
    A.1) and a mixed pair for rows 7 and 10 (f16 x with bf16 w), before
    any pointer reaches a kernel."""
    import importlib
    from mxnet_tpu_torch.base import MXNetError
    mods = {n: importlib.import_module("mxnet_tpu_torch.kernels." + n)
            for n in ("paged_attention", "layernorm", "flash_attention",
                      "fused_matmul", "fused_band4d")}
    libs = {n: m._lib() for n, m in mods.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    nul = [None] * 12
    pa, ln, fa = (libs[n] for n in ("paged_attention", "layernorm",
                                    "flash_attention"))
    calls = {}
    for qd, kd in ((2, 0), (2, 1), (0, 2), (1, 2), (3, 3), (2, 7)):
        calls["mx_paged_decode %d/%d" % (qd, kd)] = pa.mx_paged_decode(
            *nul[:6], 1, 1, 128, 16, 1, 1, 1.0, qd, kd, 0, stream)
        calls["mx_paged_chunk_prefill %d/%d" % (qd, kd)] = \
            pa.mx_paged_chunk_prefill(*nul[:11], 1, 1, 1, 128, 16, 1, 32, 1,
                                      1.0, qd, kd, 0, stream)
        calls["mx_paged_prefill %d/%d" % (qd, kd)] = pa.mx_paged_prefill(
            *nul[:8], 1, 16, 1, 128, 16, 1, 1.0, qd, kd, 0, stream)
        calls["mx_layernorm_fwd %d/%d" % (qd, kd)] = ln.mx_layernorm_fwd(
            *nul[:7], 1, 128, 1e-5, qd, kd, 0, stream)
        calls["mx_layernorm_bwd %d/%d" % (qd, kd)] = ln.mx_layernorm_bwd(
            *nul[:10], 1, 128, 1, qd, kd, 0, stream)
    for code in (3, 7):
        calls["mx_flash_bwd_dkv %d" % code] = fa.mx_flash_bwd_dkv(
            *nul[:8], 1, 16, 128, 1.0, code, 0, stream)
        calls["mx_flash_bwd_dq %d" % code] = fa.mx_flash_bwd_dq(
            *nul[:7], 1, 16, 128, 1.0, code, 0, stream)
    for code in (3, 7):
        calls["mx_fused_scale_relu_matmul %d" % code] = \
            libs["fused_matmul"].mx_fused_scale_relu_matmul(
                *nul[:6], 1, 8, 8, code, 0, stream)
        calls["mx_fused_band4d %d" % code] = \
            libs["fused_band4d"].mx_fused_band4d(
                *nul[:5], 1, 1, 1, 8, 8, 64, 64, 8, 1, code, 0, stream)
    calls["mx_flash_fwd 3"] = fa.mx_flash_fwd(*nul[:5], 1, 16, 128, 1.0, 3,
                                              0, stream)
    torch.cuda.synchronize()
    check(all(calls.values()), "C entry points took a code they have no "
          "kernel for: %s" % {k: v for k, v in calls.items() if not v})
    # codes 0, 1 and 2 run rows 7 and 10 through their C entry points,
    # each against its plain version
    import ctypes
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    ran = {}
    for name, code in DTYPE_CODES:
        dtype = getattr(torch, name)
        x = torch.randn(200, 72, device=dev, generator=g).to(dtype)
        sc = 1 + 0.2 * torch.randn(72, device=dev, generator=g)
        sh = 0.2 * torch.randn(72, device=dev, generator=g)
        w = (torch.randn(40, 72, device=dev, generator=g) / 8).to(dtype)
        y7 = torch.empty(200, 40, dtype=dtype, device=dev)
        y10 = torch.empty(200, 40, dtype=dtype, device=dev)
        wkn = w.t().contiguous()
        p = lambda t: ctypes.c_void_p(t.data_ptr())
        err7 = libs["fused_matmul"].mx_fused_scale_relu_matmul(
            p(x), p(sc), p(sh), p(w), None, p(y7), 200, 72, 40, code, 0,
            stream)
        err10 = libs["fused_band4d"].mx_fused_band4d(
            p(x), p(sc), p(sh), p(wkn), p(y10), 1, 10, 20, 72, 40,
            72 * 200, 72 * 20, 72, 1, code, 0, stream)
        torch.cuda.synchronize()
        ref = mxk.fused_scale_relu_matmul_plain(x, sc, sh, w)
        near = {torch.float32: lambda a: close(torch, a, ref),
                torch.bfloat16: lambda a: close_bf16(torch, a, ref),
                torch.float16: lambda a: close_f16_fused(torch, a, ref)}[
                    dtype]
        ran[name] = {"code": code, "row7_err": err7, "row10_err": err10,
                     "row7_max_abs_err": max_err(y7, ref),
                     "row10_max_abs_err": max_err(y10, ref)}
        check(err7 == 0 and err10 == 0 and near(y7) and near(y10),
              "dtype code %d (%s): rows 7 and 10 %s" % (code, name,
                                                       ran[name]))
    hf = torch.float16
    x = torch.zeros(64, 128, dtype=hf, device=dev)
    one, zero = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    refused = {}
    # row 6 is f32 by design; rows 7 and 10 take f16 with f16 only
    for name, fn, why in (
            ("two_bit_quantize_fused", lambda: mxk.two_bit_quantize_fused(
                x.view(-1), x.view(-1), 0.5), "ROADMAP A.1"),
            ("fused_scale_relu_matmul f16 x, bf16 w",
             lambda: mxk.fused_scale_relu_matmul_fwd(
                 x, one, zero, x.to(torch.bfloat16)), "dtype"),
            ("fused_band4d f16 x, bf16 w", lambda: mxk.fused_band4d(
                x.view(1, 8, 8, 128), one, zero,
                torch.zeros(128, 64, dtype=torch.bfloat16, device=dev)),
             "dtype")):
        try:
            fn()
        except MXNetError as e:
            refused[name] = str(e)
            check(why in str(e), "%s refused without naming %s: %s"
                  % (name, why, e))
        else:
            raise SmokeFailure("%s was taken" % name)
    emit({"phase": "dtype_codes", "calls": calls, "ran": ran,
          "refused": refused})


def phase_fused_matmul_bf16(torch, mxk, dev, flush):
    """The bf16 fused kernel (tensor cores, fused_gemm_bf16.cuh) against
    its plain version (close_bf16) at the 8 (M, K, N) shapes of
    ResNet-50's 28 fused sites at batch 256, one odd shape and the edges
    of its tiling (FUSED_BF16_EDGES), two runs bit-identical; timed
    beside torch.matmul / torch.addmm in bf16 on the already activated
    input, with each shape's TFLOP/s and GB/s.  First prints ptxas's
    lines and the dynamic shared memory of the GEMM's instances.
    Returns the kernels-line row, per-launch means over one step's 28
    launches."""
    return _fused_matmul16(torch, mxk, dev, flush, torch.bfloat16)


def phase_fused_matmul_f16(torch, mxk, dev, flush):
    """Row 7's f16 form (the f16 instances of fused_gemm_bf16.cuh's
    template) as phase_fused_matmul_bf16 holds the bf16 one, at
    close_f16_fused, with the overflow and NaN cases of _f16_special
    (with and without a residual) beside the shapes; each shape also
    timed through the bf16 form on the same values (its twin).  Returns
    the kernels-line row."""
    return _fused_matmul16(torch, mxk, dev, flush, torch.float16)


def close_f16_fused(torch, a, b):
    """Rows 7 and 10's f16 forms against their plain versions: close_bf16's
    bound scaled to f16's unit roundoff (one f16 ulp of the value, 2^-10
    relative, plus 2^-12 of the array's largest finite magnitude) on the
    finite outputs, and the same non-finite outputs (NaN where NaN, inf
    of the same sign where inf): an activation or a sum past 65504
    rounds to inf on both sides, and NaN passes the ReLU."""
    a, b = a.float(), b.float()
    fin = torch.isfinite(b)
    inf = torch.isinf(b)
    if not (torch.equal(fin, torch.isfinite(a))
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a[inf], b[inf])):
        return False
    if not bool(fin.any()):
        return True
    af, bf = a[fin], b[fin]
    lim = F16_RTOL * bf.abs() + F16_FLASH_ATOL_SHARE * float(bf.abs().max())
    return bool(((af - bf).abs() <= lim).all())


def _f16_special(torch, g, dev, M, K, N, with_res):
    """Inputs of row 7 in f16 that reach f16's range (F16_SPECIAL): the
    scale of channels 0-7 at 2, so row 3's 60000 there gives activations
    past 65504 (inf, and NaN where infs of both signs meet in a sum);
    W's rows 0-3 all 0.5, so row 5's 1000 in every channel sums past
    65504 in those columns; NaN in row 7 and inf in row 9 of the input;
    with a residual, row 11's 50 and a residual of 65504 in columns 0-3
    overflow in the epilogue.  (x, scale, shift, w (N, K), res)."""
    hf = torch.float16
    x = torch.randn(M, K, device=dev, generator=g)
    sc = 1 + 0.2 * torch.randn(K, device=dev, generator=g)
    sh = 0.2 * torch.randn(K, device=dev, generator=g)
    w = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
    sc[:8] = 2.0
    w[:4] = 0.5
    x[3, :8] = 60000.0
    x[5] = 1000.0
    x[7, 5] = float("nan")
    x[9, 0] = float("inf")
    res = None
    if with_res:
        res = torch.randn(M, N, device=dev, generator=g)
        x[11] = 50.0
        res[11, :4] = 65504.0
        res = res.to(hf)
    return x.to(hf), sc, sh, w.to(hf), res


def _fused_matmul16(torch, mxk, dev, flush, dtype):
    """phase_fused_matmul_bf16 and phase_fused_matmul_f16 in ``dtype``."""
    dt = str(dtype).replace("torch.", "")
    f16 = dtype == torch.float16
    ptx = _fused_gemm_ptxas("fused_matmul", dt)
    g = torch.Generator(device=dev).manual_seed(SEED + (47 if f16 else 23))
    bf = torch.bfloat16
    near = (lambda a, b: close_f16_fused(torch, a, b)) if f16 \
        else (lambda a, b: close_bf16(torch, a, b))
    shapes = {(M * 2, K, N, r): n for (M, K, N, r), n in FUSED_SHAPES.items()}
    cases = list(shapes) + [FUSED_ODD] + list(FUSED_BF16_EDGES)
    if f16:
        cases += [F16_SPECIAL + (False, "special"),
                  F16_SPECIAL + (True, "special")]
    rows, errs, special = [], [], {}
    for shape in cases:
        M, K, N, with_res = shape[:4]
        if shape[4:] == ("special",):
            x, sc, sh, w, res = _f16_special(torch, g, dev, M, K, N,
                                             with_res)
        else:
            off = shape[4] if len(shape) > 4 else 0
            x = torch.randn(M * K + off, device=dev, generator=g).to(
                dtype)[off:].view(M, K)
            sc = 1 + 0.2 * torch.randn(K, device=dev, generator=g)
            sh = 0.2 * torch.randn(K, device=dev, generator=g)
            w = (torch.randn(N, K, device=dev, generator=g)
                 / K ** 0.5).to(dtype)
            res = torch.randn(M, N, device=dev, generator=g).to(dtype) \
                if with_res else None
        got = mxk.fused_scale_relu_matmul_fwd(x, sc, sh, w, res)
        again = mxk.fused_scale_relu_matmul_fwd(x, sc, sh, w, res)
        ref = mxk.fused_scale_relu_matmul_plain(x, sc, sh, w, res)
        torch.cuda.synchronize()
        check(got.dtype == dtype, "fused_scale_relu_matmul %s returned %s"
              % (dt, got.dtype))
        check(near(got, ref), "fused_scale_relu_matmul %s %s disagrees with "
              "its plain version (max abs err %g)"
              % (dt, shape, max_err(got, ref)))
        check(torch.equal(got.view(torch.int16), again.view(torch.int16)),
              "fused_scale_relu_matmul %s %s: two runs differ" % (dt, shape))
        if shape[4:] == ("special",):
            special["residual" if with_res else "no_residual"] = {
                "nan": int(torch.isnan(ref).sum()),
                "inf": int(torch.isinf(ref).sum()),
                "same_non_finite": True}
            check(special[("residual" if with_res else "no_residual")][
                "inf"] > 0 and int(torch.isnan(ref).sum()) > 0,
                  "fused_scale_relu_matmul f16 %s: the case reached no inf "
                  "or NaN" % (shape,))
            del got, again, ref
            continue
        errs.append(max_err(got, ref))
        del got, again, ref
        if shape not in shapes:
            continue
        a = torch.relu(x.float() * sc + sh).to(dtype)
        ms = time_ms(torch, lambda: mxk.fused_scale_relu_matmul_fwd(
            x, sc, sh, w, res), flush)
        plain_ms = time_ms(torch, lambda: mxk.fused_scale_relu_matmul_plain(
            x, sc, sh, w, res), flush, reps=20)
        wt = w.t()
        lib_ms = time_ms(torch, (lambda: torch.addmm(res, a, wt))
                         if with_res else (lambda: torch.matmul(a, wt)),
                         flush)
        nbytes = 2 * (M * K + N * K + M * N * (2 if with_res else 1)) \
            + 4 * 2 * K
        flops = 2 * M * N * K + 3 * M * K + (M * N if with_res else 0)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        row = {"M": M, "K": K, "N": N, "residual": with_res,
               "sites": shapes[shape], "max_abs_err": errs[-1], "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "tflops": 2 * M * N * K / ms / 1e9,
               "gbps": nbytes / ms / 1e6}
        if f16:
            # the bf16 form on the same values, in turn with the f16 one
            xb, wb = x.to(bf), w.to(bf)
            rb = None if res is None else res.to(bf)
            row["bf16_twin_ms"] = time_ms(
                torch, lambda: mxk.fused_scale_relu_matmul_fwd(
                    xb, sc, sh, wb, rb), flush)
            del xb, wb, rb
        emit({"phase": "kernel", "name": "fused_scale_relu_matmul",
              "dtype": dt, **row})
        rows.append(row)
        del x, a, res, w
    sites = sum(shapes.values())
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") + \
        (("bf16_twin_ms",) if f16 else ())
    per_launch = {k: sum(r[k] * r["sites"] for r in rows) / sites
                  for k in keys}
    emit({"phase": "fused_matmul_" + ("f16" if f16 else "bf16"),
          "shapes_checked": len(cases),
          "edge_shapes": [list(e) for e in FUSED_BF16_EDGES],
          "special": special, "batch": 256, "deterministic": True,
          "ptxas": ptx, **{"step_" + k: per_launch[k] * sites for k in keys},
          "library_call": "torch.addmm / torch.matmul in %s on "
                          "relu(x*scale+shift) (the product alone)" % dt})
    out = {"name": "fused_scale_relu_matmul", "route": "cuda",
           "dtype": dt, "source": "mxnet_tpu_torch/csrc/fused_gemm_bf16.cuh",
           "replaces": "mxnet_tpu/ops/fused.py:91",
           "max_abs_err": max(errs), "bound_by": "bytes"
           if all(r["bound_by"] == "bytes" for r in rows)
           else "operations", **per_launch}
    return out


def phase_head_dim(torch, mxk, dev, flush):
    """Every attention kernel at head_dim 256 and 512, d_model 2048 kept
    (8 and 4 heads): flash forward, dK/dV and dQ at the training shape
    (4, H, 1024, D), the one-shot prefill at the served (8, 1024, H, D)
    with ragged lengths, the chunk kernel at one 64-row chunk after 700
    cached rows, decode at 8 slots with an inactive one; each against
    its plain version (f32: rtol 1e-4 / atol 1e-5; cache bytes exact,
    inactive slots exact zeros).  Times at head_dim 256 beside each
    kernel's bound and plain version (and SDPA for the flash forward,
    backward and the prefill).  Returns {kernel: timing at 256}."""
    import torch.nn.functional as F
    g = torch.Generator(device="cpu").manual_seed(SEED + 24)
    nb, bs, M = 512, 16, 64
    timings, errs = {}, {}
    for D in HEAD_DIM["dims"]:
        H = HEAD_DIM["d_model"] // D
        sc = 1.0 / D ** 0.5
        timed = D == HEAD_DIM["dims"][0]

        def hold(name, a, b, exact=False):
            ok = torch.equal(a, b) if exact else close(torch, a, b)
            check(ok, "%s at head_dim %d disagrees with its plain version "
                  "(max abs err %g)" % (name, D, max_err(a, b)))
            errs["%s_%d" % (name, D)] = max_err(a, b)

        # flash at the training shape
        q, k, v, do = (torch.randn(4, H, 1024, D, generator=g).to(dev)
                       for _ in range(4))
        o, lse = mxk.flash_attention_fwd(q, k, v, scale=sc)
        o2, lse2 = mxk.flash_attention_fwd_plain(q, k, v, scale=sc)
        delta = (do * o2).sum(-1)
        hold("flash_attention_fwd", o, o2)
        hold("flash_attention_fwd_lse", lse, lse2)
        for what, a, b in zip(("dk", "dv"), mxk.flash_attention_bwd_dkv(
                q, k, v, do, lse2, delta, scale=sc),
                mxk.flash_attention_bwd_dkv_plain(q, k, v, do, lse2, delta,
                                                  scale=sc)):
            hold("flash_attention_bwd_dkv_" + what, a, b)
        hold("flash_attention_bwd_dq",
             mxk.flash_attention_bwd_dq(q, k, v, do, lse2, delta, scale=sc),
             mxk.flash_attention_bwd_dq_plain(q, k, v, do, lse2, delta,
                                              scale=sc))
        del o, lse, o2, lse2
        if timed:
            for r in _flash_rows(torch, mxk, q, k, v, do, sc, flush,
                                 "float32", SPLIT_TF32_FLOPS_PER_S):
                timings[r["name"]] = r
        del q, k, v, do
        # one-shot prefill at the served shape
        lengths = [20, 960, 0, 1024, 513, 77, 300, 641]
        q, k, v, kc, vc, table, lens = (
            t.to(dev) for t in _prefill_inputs(torch, g, 8, 1024, H, D, nb,
                                               bs, M, lengths))
        kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        out, _, _ = mxk.paged_prefill_attend(q, k, v, kc1, vc1, table, lens,
                                             scale=sc)
        ref, _, _ = mxk.paged_prefill_attend_plain(q, k, v, kc2, vc2, table,
                                                   lens, scale=sc)
        torch.cuda.synchronize()
        hold("paged_prefill_attend", out, ref)
        hold("paged_prefill_attend_cache", kc1, kc2, exact=True)
        hold("paged_prefill_attend_cache_v", vc1, vc2, exact=True)
        if timed:
            ms = time_ms(torch, lambda: mxk.paged_prefill_attend(
                q, k, v, kc1, vc1, table, lens, scale=sc), flush)
            plain_ms = time_ms(torch, lambda: mxk.paged_prefill_attend_plain(
                q, k, v, kc2, vc2, table, lens, scale=sc), flush, reps=20)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, scale=sc), flush)
            tri = 2.0 * 8 * H * D * 1024 * 1025 / 2
            nbytes = 4 * 8 * 1024 * H * D * 4 + 2 * sum(lengths) * H * D * 4
            b_ms, b_by = bound(nbytes, 2 * tri, SPLIT_TF32_FLOPS_PER_S)
            timings["paged_prefill_attend"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)
        del q, k, v, kc1, vc1, kc2, vc2, out, ref
        # chunk: one 64-row chunk after 700 cached rows
        K, st = 64, 700
        qc, kk, vv = (torch.randn(1, K, H, D, generator=g).to(dev)
                      for _ in range(3))
        tb = table[:1].clone()
        tb[0] = torch.randperm(nb, generator=g)[:M].to(torch.int32).to(dev)
        stt = torch.tensor([st], dtype=torch.int32, device=dev)
        ln = torch.tensor([K], dtype=torch.int32, device=dev)
        kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        out, _, _ = mxk.paged_chunk_prefill_attend(qc, kk, vv, kc1, vc1, tb,
                                                   stt, ln, scale=sc)
        ref, _, _ = mxk.paged_chunk_prefill_attend_plain(
            qc, kk, vv, kc2, vc2, tb, stt, ln, scale=sc)
        torch.cuda.synchronize()
        hold("paged_chunk_prefill_attend", out, ref)
        hold("paged_chunk_prefill_attend_cache", kc1, kc2, exact=True)
        hold("paged_chunk_prefill_attend_cache_v", vc1, vc2, exact=True)
        if timed:
            ms = time_ms(torch, lambda: mxk.paged_chunk_prefill_attend(
                qc, kk, vv, kc1, vc1, tb, stt, ln, scale=sc), flush)
            plain_ms = time_ms(torch, lambda: (
                mxk.paged_chunk_prefill_attend_plain(
                    qc, kk, vv, kc2, vc2, tb, stt, ln, scale=sc)), flush,
                reps=20)
            nbytes, flops = _chunk_bound(H, D, M, K, [st], [K])
            b_ms, b_by = bound(nbytes, flops, SPLIT_TF32_FLOPS_PER_S)
            timings["paged_chunk_prefill_attend"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)
        del qc, kk, vv, kc1, vc1, kc2, vc2, out, ref
        # decode: 8 slots, one inactive
        C = 8
        qd = torch.randn(C, H, D, generator=g).to(dev)
        td = torch.randperm(nb, generator=g)[:C * M].reshape(C, M) \
            .to(torch.int32).to(dev)
        pos = torch.randint(20, 732, (C,), generator=g).to(torch.int32)
        pos[7] = -1
        pos = pos.to(dev)
        out = mxk.paged_decode_attend(qd, kc, vc, td, pos, scale=sc)
        ref = mxk.paged_decode_attend_plain(qd, kc, vc, td, pos, scale=sc)
        torch.cuda.synchronize()
        act = pos >= 0
        hold("paged_decode_attend", out[act], ref[act])
        check(bool((out[~act] == 0).all()), "paged_decode_attend at head_dim "
              "%d: inactive slot is not exact zeros" % D)
        if timed:
            ms = time_ms(torch, lambda: mxk.paged_decode_attend(
                qd, kc, vc, td, pos, scale=sc), flush)
            plain_ms = time_ms(torch, lambda: mxk.paged_decode_attend_plain(
                qd, kc, vc, td, pos, scale=sc), flush)
            rows = int((pos[act].long() + 1).sum())
            nbytes = rows * H * D * 2 * 4 + 2 * C * H * D * 4
            b_ms, b_by = bound(nbytes, rows * H * D * 4)
            timings["paged_decode_attend"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)
        del qd, kc, vc, out, ref
    # decode at ragged head_dims: 72 (16-byte loads, lanes past D idle),
    # 30 and, with bf16 caches, 36 (element by element), 16 heads
    for D, cname in HEAD_DIM["decode_ragged"]:
        H, C, sc, cdt = 16, 8, 1.0 / D ** 0.5, getattr(torch, cname)
        qd = torch.randn(C, H, D, generator=g).to(dev)
        kc, vc = (torch.randn(nb, bs, H, D, generator=g).to(dev).to(cdt)
                  for _ in range(2))
        td = torch.randperm(nb, generator=g)[:C * M].reshape(C, M) \
            .to(torch.int32).to(dev)
        pos = torch.randint(20, 732, (C,), generator=g).to(torch.int32)
        pos[7] = -1
        pos = pos.to(dev)
        out = mxk.paged_decode_attend(qd, kc, vc, td, pos, scale=sc)
        again = mxk.paged_decode_attend(qd, kc, vc, td, pos, scale=sc)
        ref = mxk.paged_decode_attend_plain(qd, kc, vc, td, pos, scale=sc)
        torch.cuda.synchronize()
        act = pos >= 0
        tag = "paged_decode_attend (%s cache) at head_dim %d" % (cname, D)
        check(torch.equal(out, again), tag + ": two runs differ")
        check(close(torch, out[act], ref[act]), "%s disagrees with its plain "
              "version (max abs err %g)" % (tag, max_err(out[act], ref[act])))
        check(bool((out[~act] == 0).all()), tag + ": inactive slot is not "
              "exact zeros")
        errs["paged_decode_attend_%s_%d" % (cname, D)] = \
            max_err(out[act], ref[act])
        del qd, kc, vc, out, again, ref
    emit({"phase": "head_dim", "head_dims": list(HEAD_DIM["dims"]),
          "d_model": HEAD_DIM["d_model"], "errors": errs,
          "timed_head_dim": HEAD_DIM["dims"][0],
          "timings": {n: {k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")}
                      for n, t in timings.items()}})
    return timings


def phase_train_bf16(torch, mx, np_params, cfg=FULL, ctx=None,
                     train=TRAIN_BF16):
    """bench.py's transformer train mode in bf16: ``_train16``."""
    return _train16(torch, mx, np_params, "bfloat16", cfg, ctx, train)


def phase_train_f16(torch, mx, np_params, cfg=FULL, ctx=None,
                    train=TRAIN_BF16):
    """The same in float16 (ROADMAP A.1, float16 training): ``_train16``
    with ``dtype='float16'`` at TRAIN_BF16's settings; every step
    launches the f16 forms of the flash and LayerNorm kernels."""
    return _train16(torch, mx, np_params, "float16", cfg, ctx, train)


def _train16(torch, mx, np_params, dtype, cfg, ctx, train):
    """bench.py's transformer train mode in a 16-bit ``dtype``: the
    full-width model with ``dtype`` through TrainStep, SGD momentum 0.9
    with multi_precision (bench.py's learning rate and 1/(B*S) rescale),
    10 steps over two fixed batches, the last 8 timed.  Every step
    launches each flash kernel 12 times in ``dtype`` and LayerNorm
    forward and backward 25 times; the loss stays finite; every 16-bit
    weight matrix's f32 master moves (the counts of moved masters and of
    16-bit weights that changed are printed).  Returns the launch counts
    and the step count."""
    from mxnet_tpu_torch.kernels import (LAUNCHES, LAUNCHES_BY_DTYPE,
                                         PLAIN_CALLS, reset_counts)
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import TrainStep
    what = {"bfloat16": "train_bf16", "float16": "train_f16"}[dtype]
    low_t = getattr(torch, dtype)
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dev = ctx.torch_device
    B, S, steps = train["batch"], cfg["seq_len"], train["steps"]
    x, y = _token_batches(cfg, B * 2, SEED + 25)
    batches = [{"data": torch.from_numpy(x[i * B:(i + 1) * B]).to(dev),
                "softmax_label": torch.from_numpy(
                    y[i * B:(i + 1) * B].reshape(-1)).to(dev)}
               for i in range(2)]
    t0 = time.perf_counter()
    sym = transformer.get_symbol(dtype=dtype, **cfg)
    ts = TrainStep(sym, mx.optimizer.SGD(
        learning_rate=train["lr"], momentum=train["momentum"],
        multi_precision=True, rescale_grad=1.0 / (B * S)),
        data_shapes={"data": (B, S)}, label_shapes={"softmax_label": (B * S,)},
        ctx=ctx)
    ts.init_params(mx.init.Xavier(), arg_params=np_params)
    low = [n for n, t in ts.params.items() if t.dtype == low_t]
    check(len(low) == 12 * cfg["num_layers"] + 4, "%s: %d %s "
          "parameters" % (what, len(low), dtype))
    w0 = {n: ts.states[n][-1].clone() for n in low}
    sync()
    setup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    losses, stamps = [], [time.perf_counter()]
    reset_counts()
    for i in range(steps):
        batch = batches[i % 2]
        prob = ts.step(batch)[0]
        lab = batch["softmax_label"].long()
        losses.append(float(-torch.log(prob.gather(1, lab[:, None]).clamp(
            min=1e-30)).mean()))
        stamps.append(time.perf_counter())
    sync()
    launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
    by_dtype = dict(LAUNCHES_BY_DTYPE)
    check(all(np.isfinite(losses)), "%s: non-finite loss %s"
          % (what, losses))
    for name, per in TRAIN_LAUNCHES.items():
        key = "%s:%s" % (name, dtype)
        counts = by_dtype if on_card else plain
        got = by_dtype.get(key, 0) if on_card else plain[name]
        check(got == per * steps, "%s: %s launched %d times in %s over %d "
              "steps (want %d per step; by type %s)"
              % (what, name, got, dtype, steps, per, counts))
    if on_card:
        check(not any(plain.values()), "%s: plain versions ran on "
              "the main path: %s" % (what, plain))
    # bench.py's 1/(B*S) rescale on top of the loss's own batch
    # normalisation makes every update small: the weight matrices'
    # masters (|w| ~ 0.02) move while their 16-bit copies mostly cannot,
    # and the LayerNorm scales near 1 may move by less than an f32 ulp
    moved = {n: float((ts.states[n][-1] - w0[n]).abs().max()) for n in low}
    low_moved = sum(int((ts.params[n] != w0[n].to(low_t)).any())
                    for n in low)
    check(all(moved[n] > 0 for n in low if n.endswith("_weight")),
          "%s: weight masters that did not move: %s"
          % (what, [n for n in low if n.endswith("_weight")
                    and not moved[n] > 0]))
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    p50 = statistics.median(step_ms[train["warmup"]:])
    emit({"phase": what, "config": dict(cfg, dtype=dtype),
          "train": train, "setup_s": setup_s, "steps": steps,
          "step_ms": step_ms, "step_ms_p50": p50,
          "tokens_per_s": B * S / (p50 / 1e3), "loss": losses,
          "launches_per_step": {k: launches[k] / steps
                                for k in TRAIN_LAUNCHES},
          "launches_by_dtype": by_dtype, "plain_calls": plain,
          "low_params": len(low),
          "masters_moved": sum(m > 0 for m in moved.values()),
          "low_weights_changed": low_moved,
          "masters_moved_max_abs": max(moved.values()),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
          if on_card else None})
    del ts, batches
    return launches, steps


def phase_train_resnet_bf16(torch, mx, ctx=None, cfg=RESNET,
                            train=RESNET_BF16):
    """bench.py's flagship: ResNet-50 v2 NHWC in bf16 at batch 256
    through TrainStep with bench.py's SGD (learning rate 0.1, momentum
    0.9, wd 1e-4, multi_precision, rescale 1/batch) from the seeded
    weights, in two arms: unfused, and after fuse_conv_bn (28 sites,
    exactly 28 bf16 fused launches per step; the unfused arm none).
    10 steps over two fixed batches; the loss stays finite and falls on
    the repeated batch; step p50, images/s and peak memory per arm.
    Returns the fused arm's launch counts and step count."""
    return _train_resnet16(torch, mx, "bfloat16", ctx, cfg, train)


def phase_train_resnet_f16(torch, mx, ctx=None, cfg=RESNET,
                           train=RESNET_BF16):
    """phase_train_resnet_bf16 in float16 (ROADMAP A.1): the same net,
    batch, optimizer and arms with dtype='float16', f16 weights and f32
    masters; the fused arm records exactly 28 f16 launches of row 7 a
    step, the unfused arm none, and no plain version runs.  TrainStep
    has no loss scaler in either package (neither scales the loss): a
    gradient past 65504 would reach the update as inf, so each step's
    count of non-finite gradient elements and largest finite |gradient|
    are printed beside the loss, with the count of gradient elements in
    f16's subnormal range (below 2^-14, not zero).  Returns the fused
    arm's launch counts and step count."""
    return _train_resnet16(torch, mx, "float16", ctx, cfg, train)


def _train_resnet16(torch, mx, dtype, ctx, cfg, train):
    """phase_train_resnet_bf16 and phase_train_resnet_f16 in ``dtype``."""
    from mxnet_tpu_torch.kernels import (LAUNCHES, LAUNCHES_BY_DTYPE,
                                         PLAIN_CALLS, reset_counts)
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dev = ctx.torch_device
    tag = "f16" if dtype == "float16" else "bf16"
    what = "train_resnet_" + tag
    low = getattr(torch, dtype)
    B, steps, name = train["batch"], train["steps"], "fused_scale_relu_matmul"
    np_args, np_aux = seeded_resnet_params(resnet.get_symbol(**cfg), B,
                                           cfg["image_shape"])
    np_args = {n: _nhwc(a) for n, a in np_args.items()}
    x, y = _image_batches(cfg["image_shape"], B * 2, SEED + 26,
                          cfg["num_classes"])
    x = _nhwc(x)
    batches = [{"data": torch.from_numpy(x[i * B:(i + 1) * B]).to(dev),
                "softmax_label": torch.from_numpy(y[i * B:(i + 1) * B])
                .to(dev)} for i in range(2)]
    arms, result = {}, None
    for arm, fuse in (("nhwc_" + tag, False), ("nhwc_%s_fused" % tag, True)):
        t0 = time.perf_counter()
        sym = resnet.get_symbol(layout="NHWC", dtype=dtype, **cfg)
        if fuse:
            sym = fuse_conv_bn(sym)
            check(count_fused(sym) == train["sites"], "%s: %d fused sites"
                  % (what, count_fused(sym)))
        ts = TrainStep(sym, mx.optimizer.SGD(
            learning_rate=train["lr"], momentum=train["momentum"],
            wd=train["wd"], multi_precision=True, rescale_grad=1.0 / B),
            data_shapes={"data": x[:B].shape},
            label_shapes={"softmax_label": (B,)}, ctx=ctx)
        ts.init_params(mx.init.Xavier(), arg_params=np_args,
                       aux_params=np_aux)
        check(ts.params["conv0_weight"].dtype == low,
              "%s: conv0_weight is %s" % (what, ts.params["conv0_weight"]
                                          .dtype))
        sync()
        setup_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        losses, step_ms, nonfinite, grad_max, subnormal = [], [], [], [], []
        reset_counts()
        for i in range(steps):
            batch = batches[i % 2]
            t0 = time.perf_counter()
            prob = ts.step(batch)[0]
            lab = batch["softmax_label"].long()
            losses.append(float(-torch.log(prob.gather(
                1, lab[:, None]).clamp(min=1e-30)).mean()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if low == torch.float16:          # outside the step's time
                grads = list(ts.grads.values())
                nonfinite.append(int(sum(
                    (~torch.isfinite(g)).sum() for g in grads)))
                grad_max.append(float(max(
                    torch.nan_to_num(g.float(), 0.0, 0.0, 0.0).abs().max()
                    for g in grads)))
                subnormal.append(int(sum(
                    ((g != 0) & (g.abs() < 2.0 ** -14)).sum() for g in grads)))
        sync()
        launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        by_dtype = dict(LAUNCHES_BY_DTYPE)
        check(all(np.isfinite(losses)), "%s %s: non-finite loss %s"
              % (what, arm, losses))
        check(losses[-2] < losses[0], "%s %s: the loss on the repeated "
              "batch did not fall (%g -> %g)" % (what, arm, losses[0],
                                                 losses[-2]))
        want = train["sites"] * steps if fuse else 0
        got = by_dtype.get("%s:%s" % (name, dtype), 0) if on_card \
            else plain[name]
        check(got == want, "%s %s: %d %s %s launches over %d steps, want %d"
              % (what, arm, got, dtype, name, steps, want))
        if on_card:
            check(not any(plain.values()), "%s %s: plain versions ran on the "
                  "main path: %s" % (what, arm, plain))
        p50 = statistics.median(step_ms[train["warmup"]:])
        arms[arm] = {"fused_sites": train["sites"] if fuse else 0,
                     "setup_s": setup_s, "step_ms": step_ms,
                     "step_ms_p50": p50, "images_per_s": B / (p50 / 1e3),
                     "loss": losses, "launches_by_dtype": by_dtype,
                     "kernel_launches_per_step": launches[name] / steps,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None}
        if low == torch.float16:
            arms[arm].update(
                nonfinite_grad_elements=nonfinite, grad_abs_max=grad_max,
                subnormal_grad_elements=subnormal,
                grad_elements=sum(g.numel() for g in grads),
                loss_scaler="none: TrainStep scales no loss and skips no "
                            "step in either package")
        if fuse:
            result = (launches, steps)
        del ts
    emit({"phase": what, "config": dict(cfg, layout="NHWC", dtype=dtype),
          "train": train, **arms})
    del batches
    return result


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_trainstep(torch, mx, sym, ctx, args, auxs, batch, opt, steps=2):
    """``steps`` TrainStep steps; returns the last output (f32 numpy)
    and the f32 masters' moves from ``args``, concatenated."""
    from mxnet_tpu_torch.parallel import TrainStep
    shapes = {n: tuple(v.shape) for n, v in batch.items()}
    ts = TrainStep(sym, mx.optimizer.SGD(**opt), ctx=ctx,
                   data_shapes={"data": shapes["data"]},
                   label_shapes={"softmax_label": shapes["softmax_label"]})
    ts.init_params(mx.init.Xavier(), arg_params=args, aux_params=auxs)
    for _ in range(steps):
        out = ts.step(batch)[0]
    low = [n for n, t in ts.params.items() if t.dtype == torch.bfloat16]
    check(low, "bf16_agreement: no bf16 parameter")
    start = {n: torch.from_numpy(args[n]).to(torch.bfloat16).float().numpy()
             for n in low}
    moved = np.concatenate([(ts.states[n][-1].cpu().numpy() - start[n])
                            .ravel() for n in low])
    return out.float().cpu().numpy(), moved


def phase_bf16_agreement(torch, mx, ctxs=None):
    """bf16 TrainStep with multi-precision SGD, card against CPU from the
    same numpy weights, 2 steps: ResNet-18 NCHW (3x32x32, batch 4, 4
    classes: tests/test_trainer.py's bf16 configuration), the fused
    NHWC arm on tests/test_torch_bf16.py's small bottleneck ResNet at
    the same size (5 fused sites; ResNet-18 has none to fuse), and a
    2-layer bf16 transformer (d_model 512, 8 heads, vocab 4096, seq 256,
    batch 2).  The last step's outputs are held at relative L2 2e-2
    (ResNets) and 3e-2 (transformer); the f32 masters' moves from their
    bf16 start at 0.75 (ResNets: 2.5 times the 0.29 to 0.33 that a CPU
    run on the input scaled by 1 + 2^-12 lands from the CPU run, which
    is printed beside) and 5e-2 (transformer).  A random-init BatchNorm
    ResNet's gradient moves by tens of percents under bf16-level
    changes (tests/test_torch_bf16.py; a deeper ResNet-50 at
    this size moves its masters by more than their norm, which is why
    the fused arm is the small net)."""
    from mxnet_tpu_torch.models import resnet, transformer
    from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    rng = np.random.RandomState(SEED + 27)
    res = {}
    x = rng.uniform(0, 1, (4, 3, 32, 32)).astype(np.float32)
    y = rng.randint(0, 4, 4).astype(np.float32)
    opt = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
               multi_precision=True, rescale_grad=0.25)
    r18 = dict(num_classes=4, num_layers=18, image_shape=(3, 32, 32))
    neck = dict(units=[2, 1, 1], num_stages=3, filter_list=[8, 32, 64, 128],
                num_classes=4, image_shape=(3, 32, 32), bottle_neck=True)
    args18, auxs18 = seeded_resnet_params(resnet.get_symbol(**r18), 4,
                                          (3, 32, 32))
    argsn, auxsn = seeded_resnet_params(resnet.resnet(**neck), 4,
                                        (3, 32, 32))
    fused = lambda: fuse_conv_bn(resnet.resnet(layout="NHWC",
                                               dtype="bfloat16", **neck))
    check(count_fused(fused()) == 5, "bf16_agreement: fused sites")
    cases = [("resnet18_nchw", lambda: resnet.get_symbol(dtype="bfloat16",
                                                         **r18),
              args18, auxs18, x, y, opt, (2e-2, 0.75)),
             ("bottleneck_nhwc_fused", fused,
              {n: _nhwc(a) for n, a in argsn.items()}, auxsn, _nhwc(x), y,
              opt, (2e-2, 0.75))]
    lm = dict(num_classes=4096, num_layers=2, d_model=512, num_heads=8,
              ffn_dim=2048, seq_len=256)
    tx, ty = _token_batches(lm, 2, SEED + 28)
    lm_args = seeded_params(lm)
    cases.append(("transformer_2layer", lambda: transformer.get_symbol(
        dtype="bfloat16", **lm), lm_args, {}, tx, ty.reshape(-1),
        dict(learning_rate=0.1, momentum=0.9, multi_precision=True,
             rescale_grad=1.0 / 512), (3e-2, 5e-2)))
    for arm, make, args, auxs, data, lab, o, (out_l2, master_l2) in cases:
        runs = []
        for ctx, scale in ((ctxs[0], 1.0), (ctxs[1], 1.0),
                           (ctxs[1], 1.0 + 2.0 ** -12)):
            feed = data * np.float32(scale) if arm != "transformer_2layer" \
                else data
            runs.append(_bf16_trainstep(torch, mx, make(), ctx, args, auxs,
                                        {"data": feed, "softmax_label": lab},
                                        o))
        (go, gm), (co, cm), (_, pm) = runs
        out_err, master_err = _rel_l2(go, co), _rel_l2(gm, cm)
        check(np.isfinite(go).all(), "bf16_agreement %s: non-finite output"
              % arm)
        check(out_err < out_l2, "bf16_agreement %s: outputs differ by %g "
              "(relative L2) between the card and the CPU" % (arm, out_err))
        check(master_err < master_l2, "bf16_agreement %s: the f32 masters' "
              "moves differ by %g (relative L2)" % (arm, master_err))
        res[arm] = {"out_rel_l2": out_err, "out_bound": out_l2,
                    "master_moves_rel_l2": master_err,
                    "master_bound": master_l2,
                    "cpu_vs_perturbed_cpu_master_rel_l2": _rel_l2(pm, cm)}
    emit({"phase": "bf16_agreement", "steps": 2, **res})


def phase_f16_train_agreement(torch, mx, ctxs=None):
    """float16 TrainStep with multi-precision SGD, card against CPU from
    the same numpy weights (ROADMAP A.1, float16 training):
    F16_TRAIN_AGREE's 2-layer transformer (seq 256, batch 2) with
    ``dtype='float16'``, its steps.  Held: the last step's outputs within relative L2 out_l2, the
    f32 masters' moves within master_l2 (bf16_agreement's bounds over
    f16's 3 more significand bits), each f16 weight within one f16 ulp
    at its array's scale; the f16 weights' moves' relative L2 printed
    beside."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import TrainStep
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    hf = torch.float16
    lm = F16_TRAIN_AGREE["config"]
    tx, ty = _token_batches(lm, 2, SEED + 28)
    args = seeded_params(lm)
    batch = {"data": tx, "softmax_label": ty.reshape(-1)}
    opt = dict(learning_rate=0.1, momentum=0.9, multi_precision=True,
               rescale_grad=1.0 / ty.size)
    runs = []
    for ctx in ctxs:
        ts = TrainStep(transformer.get_symbol(dtype="float16", **lm),
                       mx.optimizer.SGD(**opt), ctx=ctx,
                       data_shapes={"data": tx.shape},
                       label_shapes={"softmax_label": (ty.size,)})
        ts.init_params(mx.init.Xavier(), arg_params=args)
        for _ in range(F16_TRAIN_AGREE["steps"]):
            out = ts.step(batch)[0]
        low = sorted(n for n, t in ts.params.items() if t.dtype == hf)
        check(low, "f16_train_agreement: no f16 parameter")
        runs.append((out.float().cpu().numpy(), low,
                     {n: ts.params[n].float().cpu().numpy() for n in low},
                     {n: ts.states[n][-1].cpu().numpy() for n in low}))
        del ts
    (go, glow, gw, gm), (co, clow, cw, cm) = runs
    check(glow == clow, "f16_train_agreement: f16 parameters differ")
    start = {n: torch.from_numpy(args[n]).to(hf).float().numpy()
             for n in glow}
    cat = lambda d, base: np.concatenate([(d[n] - base[n]).ravel()
                                          for n in glow])
    out_err = _rel_l2(go, co)
    master_err = _rel_l2(cat(gm, start), cat(cm, start))
    weight_err = _rel_l2(cat(gw, start), cat(cw, start))
    check(np.isfinite(go).all(), "f16_train_agreement: non-finite output")
    check(out_err < F16_TRAIN_AGREE["out_l2"], "f16_train_agreement: "
          "outputs differ by %g (relative L2) between the card and the CPU"
          % out_err)
    check(master_err < F16_TRAIN_AGREE["master_l2"], "f16_train_agreement: "
          "the f32 masters' moves differ by %g (relative L2)" % master_err)
    ulps = {}
    for n in glow:
        spacing = float(np.spacing(np.float16(np.abs(cw[n]).max())))
        ulps[n] = float(np.abs(gw[n] - cw[n]).max()) / spacing
    check(max(ulps.values()) <= 1.0, "f16_train_agreement: f16 weights "
          "past one ulp at their scale: %s" % {n: u for n, u in ulps.items()
                                               if u > 1})
    emit({"phase": "f16_train_agreement", "config": dict(lm, dtype="float16"),
          "steps": F16_TRAIN_AGREE["steps"], "out_rel_l2": out_err,
          "out_bound": F16_TRAIN_AGREE["out_l2"],
          "master_moves_rel_l2": master_err,
          "master_bound": F16_TRAIN_AGREE["master_l2"],
          "f16_weight_moves_rel_l2": weight_err,
          "f16_weights_worst_ulps_at_scale": max(ulps.values()),
          "f16_params": len(glow)})


class F16Gap:
    """resnet_f16_agreement's check for a deep BatchNorm net in f16 (the
    check tests/test_torch_resnet_f16.py holds against the JAX package):
    each tensor of the card's f16 run within RESNET_F16_AGREE's
    gap_factor times the CPU's own f16-to-f32 gap of the CPU's f16 run
    (relative L2), plus rel_floor; outputs and the loss within
    abs_floor, or gap_factor times the CPU's own f16-to-f32 difference
    where that is larger.  Records the worst ratio to the gap."""

    def __init__(self, case):
        self.case, self.n, self.worst = case, 0, [0.0, None]

    def hold(self, got, ref16, ref32, what):
        cfg = RESNET_F16_AGREE
        got, ref16, ref32 = (np.asarray(a, np.float64)
                             for a in (got, ref16, ref32))
        check(np.isfinite(got).all(), "resnet_f16_agreement %s %s: not "
              "finite" % (self.case, what))
        d, gap = _rel_l2_any(got, ref16), _rel_l2_any(ref16, ref32)
        self.n += 1
        ratio = d / max(gap, cfg["rel_floor"])
        if ratio > self.worst[0]:
            self.worst = [ratio, "%s: %.4g against a gap of %.4g"
                          % (what, d, gap)]
        check(d <= cfg["gap_factor"] * gap + cfg["rel_floor"],
              "resnet_f16_agreement %s %s: %g from the CPU's f16, its own "
              "f16-to-f32 gap %g" % (self.case, what, d, gap))

    def hold_abs(self, got, ref16, ref32, what):
        cfg = RESNET_F16_AGREE
        got, ref16, ref32 = (np.asarray(a, np.float64)
                             for a in (got, ref16, ref32))
        err = float(np.abs(got - ref16).max())
        lim = max(cfg["abs_floor"],
                  cfg["gap_factor"] * float(np.abs(ref16 - ref32).max()))
        check(err <= lim, "resnet_f16_agreement %s %s: %g from the CPU's "
              "f16 (bound %g)" % (self.case, what, err, lim))
        return err

    def summary(self):
        return {"tensors_held": self.n, "worst_ratio_to_gap": self.worst[0],
                "worst": self.worst[1]}


def _rel_l2_any(a, b):
    nb = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / nb if nb else \
        float(np.linalg.norm(a))


def _np32(t):
    """f32 numpy of a tensor or an NDArray."""
    import torch
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else t.astype("float32").asnumpy()


def _hold_masters(gap, runs, start, label):
    """Each f16 weight is its f32 master rounded once (in every run);
    the masters' moves held by ``gap`` (the f32 run's weights' moves as
    the reference's own)."""
    card, cpu16, cpu32 = runs
    for k in sorted(card["masters"]):
        for run in (card, cpu16):
            check(np.array_equal(run["weights"][k], run["masters"][k].astype(
                np.float16).astype(np.float32)), "resnet_f16_agreement %s: "
                "%s is not its master rounded to f16" % (label, k))
        s16 = start[k].astype(np.float16).astype(np.float32)
        gap.hold(card["masters"][k] - s16, cpu16["masters"][k] - s16,
                 cpu32["weights"][k] - start[k], "master move " + k)


def phase_resnet_f16_agreement(torch, mx, ctxs=None):
    """float16 ResNet training, card against CPU from the same numpy
    weights and batches, at RESNET_F16_AGREE's small sizes, each path
    held by F16Gap (the CPU's f16 run against the CPU's f32 run gives
    the noise): (1) NHWC ResNet-50 after fuse_conv_bn through TrainStep,
    one step (outputs, loss, every gradient, every moving statistic,
    the masters' moves; each f16 weight its master rounded once);
    (2) the CIFAR ResNet-8 through Module.fit with a 2-bit device store,
    fused, 2 steps (moving statistics; the masters' moves within two
    steps' quantizer flips element by element, at most 2% of elements
    flipped); (3) the model zoo's resnet18_v1 cast to f16 through Gluon,
    one step, imperative and hybridized on the card against the CPU's
    hybridized f16 and f32 (outputs, loss, every gradient, moving
    statistics, masters' moves)."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.base import NameManager
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.symbol.fuse import fuse_conv_bn
    from mxnet_tpu_torch.weights import gluon_params_from_numpy
    cfg = RESNET_F16_AGREE
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    card, cpu = ctxs
    out = {}
    # (1) TrainStep, fused NHWC ResNet-50
    tc = cfg["trainstep"]
    net = dict(tc["net"], layout="NHWC")
    B = tc["batch"]
    np_args, np_aux = seeded_resnet_params(
        resnet.get_symbol(**tc["net"]), B, tc["net"]["image_shape"])
    np_args = {n: _nhwc(a) for n, a in np_args.items()}
    x, y = _image_batches(tc["net"]["image_shape"], B, SEED + 61,
                          tc["net"]["num_classes"])
    batch = {"data": _nhwc(x), "softmax_label": y}
    runs = []
    for ctx, dtype in ((card, "float16"), (cpu, "float16"),
                       (cpu, "float32")):
        sym = fuse_conv_bn(resnet.get_symbol(dtype=dtype, **net))
        ts = TrainStep(sym, mx.optimizer.SGD(
            learning_rate=tc["lr"], momentum=0.9, wd=1e-4,
            multi_precision=True, rescale_grad=1.0 / B),
            data_shapes={"data": batch["data"].shape},
            label_shapes={"softmax_label": (B,)}, ctx=ctx)
        ts.init_params(mx.init.Xavier(), arg_params=np_args,
                       aux_params=np_aux)
        o = _np32(ts.step(batch)[0])
        runs.append({"outputs": o, "grads": {k: _np32(v) for k, v in
                                             ts.grads.items()},
                     "aux": {k: _np32(v) for k, v in ts.auxs.items()},
                     "weights": {k: _np32(v) for k, v in ts.params.items()},
                     "masters": {k: _np32(st[-1]) for k, st in
                                 ts.states.items() if dtype == "float16"
                                 and isinstance(st, tuple) and len(st) == 2}})
        del ts
    gap = F16Gap("trainstep_fused")
    loss = [-np.log(np.maximum(r["outputs"][np.arange(B), y.astype(int)],
                               1e-30)).mean() for r in runs]
    gap.hold(runs[0]["outputs"], runs[1]["outputs"], runs[2]["outputs"],
             "outputs")
    out_err = gap.hold_abs(runs[0]["outputs"], runs[1]["outputs"],
                           runs[2]["outputs"], "outputs")
    loss_err = gap.hold_abs(loss[0], loss[1], loss[2], "loss")
    for key in ("grads", "aux"):
        for k in runs[0][key]:
            gap.hold(runs[0][key][k], runs[1][key][k], runs[2][key][k],
                     "%s %s" % (key, k))
    check(runs[0]["masters"] and sorted(runs[0]["masters"])
          == sorted(runs[1]["masters"]), "resnet_f16_agreement: masters")
    _hold_masters(gap, runs, np_args, "trainstep")
    out["trainstep_fused"] = dict(gap.summary(), outputs_max_abs=out_err,
                                  loss_abs=loss_err)
    # (2) Module.fit, 2-bit device store, fused
    fc = cfg["fit"]
    B = fc["batch"]
    sym = resnet.get_symbol(**fc["net"])
    np_args, np_aux = seeded_resnet_params(sym, B, fc["net"]["image_shape"])
    xs, ys = _image_batches(fc["net"]["image_shape"], 2 * B, SEED + 62,
                            fc["net"]["num_classes"])
    runs = []
    for ctx, dtype in ((card, "float16"), (cpu, "float16"),
                       (cpu, "float32")):
        mod = mx.Module(resnet.get_symbol(dtype=dtype, **fc["net"]),
                        context=ctx, compression_params={
                            "type": "2bit", "threshold": fc["threshold"]})
        mod.bind(data_shapes=[("data", (B,) + xs.shape[1:])],
                 label_shapes=[("softmax_label", (B,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=cpu)
                                    for k, v in np_args.items()},
                        aux_params={k: mx.nd.array(v, ctx=cpu)
                                    for k, v in np_aux.items()})
        mod.init_optimizer(kvstore=mx.kv.create("device"), optimizer="sgd",
                           optimizer_params={"learning_rate": fc["lr"],
                                             "momentum": 0.9, "wd": 1e-4,
                                             "multi_precision": True})
        for i in range(2):
            mod.fit_step(mx.io.DataBatch(
                data=[mx.nd.array(xs[i * B:(i + 1) * B], ctx=cpu)],
                label=[mx.nd.array(ys[i * B:(i + 1) * B], ctx=cpu)]))
        upd = mod._kvstore._updater if mod._update_on_kvstore \
            else mod._updater
        names = mod._param_names
        args_p, aux_p = mod.get_params()
        runs.append({"aux": {k: _np32(v) for k, v in aux_p.items()},
                     "weights": {k: _np32(v) for k, v in args_p.items()},
                     "masters": {names[k] if isinstance(k, int) else k:
                                 _np32(st[1]) for k, st in upd.states.items()
                                 if dtype == "float16"
                                 and isinstance(st, tuple) and len(st) == 2},
                     "fused": mod._fused_fit is not None
                     and mod._fused_fit.launches == 2})
        del mod
    check(runs[0]["fused"], "resnet_f16_agreement: Module.fit on the card "
          "did not take the fused step")
    gap = F16Gap("module_fit_2bit")
    for k in runs[0]["aux"]:
        gap.hold(runs[0]["aux"][k], runs[1]["aux"][k], runs[2]["aux"][k],
                 "aux " + k)
    flip = (2 + 0.9) * fc["lr"] / B * 2 * fc["threshold"]
    flipped = total = 0
    for k in sorted(runs[0]["masters"]):
        d = np.abs(runs[0]["masters"][k] - runs[1]["masters"][k])
        check(float(d.max()) <= flip * (1 + 1e-3), "resnet_f16_agreement "
              "Module.fit: %s's master moved %g off the CPU's, past two "
              "steps' quantizer flips %g" % (k, float(d.max()), flip))
        flipped += int((d > flip / 16).sum())
        total += d.size
        check(np.array_equal(runs[0]["weights"][k], runs[0]["masters"][k]
                             .astype(np.float16).astype(np.float32)),
              "resnet_f16_agreement Module.fit: %s is not its master "
              "rounded to f16" % k)
    check(total and flipped <= total // 50, "resnet_f16_agreement "
          "Module.fit: %d of %d master elements flipped" % (flipped, total))
    out["module_fit_2bit"] = dict(gap.summary(), master_elements=total,
                                  flipped=flipped)
    # (3) Gluon resnet18_v1 cast to f16
    gc_ = cfg["gluon"]
    B = gc_["batch"]
    x, y = _image_batches(gc_["image"], B, SEED + 63, gc_["classes"])

    def gluon_run(ctx, dtype, hybrid, values=None):
        with NameManager():
            net = gluon.model_zoo.vision.resnet18_v1(classes=gc_["classes"])
        if dtype == "float16":
            net.cast("float16")
        net.initialize(mx.init.Xavier(), ctx=ctx)
        xs = mx.nd.array(x, ctx=ctx).astype(dtype)
        net(xs)
        params = net.collect_params()
        if values is None:
            return {k: tuple(p.shape) for k, p in params.items()}
        gluon_params_from_numpy(net, values)
        if hybrid:
            net.hybridize()
        trainer = gluon.Trainer(params, "sgd", {
            "learning_rate": gc_["lr"], "momentum": 0.9, "wd": 1e-4,
            "multi_precision": True}, kvstore="device",
            update_on_kvstore=False)
        with autograd.record():
            o = mx.nd.Cast(net(xs), dtype="float32")
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                o, mx.nd.array(y, ctx=ctx))
        loss.backward()
        grads = {k: _np32(p.grad()) for k, p in params.items()
                 if p.grad_req != "null"}
        trainer.step(B)
        names = [p.name for p in trainer._params]
        return {"outputs": _np32(o), "loss": float(_np32(loss).mean()),
                "grads": grads,
                "aux": {k: _np32(p.data()) for k, p in params.items()
                        if p.grad_req == "null"},
                "weights": {k: _np32(p.data()) for k, p in params.items()},
                "masters": {names[k]: _np32(st[1]) for k, st in
                            trainer._updaters[0].states.items()
                            if isinstance(st, tuple) and len(st) == 2}}

    shapes = gluon_run(cpu, "float32", False)
    rng = np.random.default_rng([SEED, 64])
    values = {}
    for k, shp in sorted(shapes.items()):
        z = rng.standard_normal(shp, dtype=np.float32)
        values[k] = (1 + 0.1 * z if k.endswith("gamma") else
                     0.1 * z if k.endswith(("beta", "bias", "running_mean"))
                     else 1 + 0.1 * np.abs(z) if k.endswith("running_var")
                     else z * np.float32(np.sqrt(2.0 / np.prod(shp[1:]))))
    ref16 = gluon_run(cpu, "float16", True, values)
    ref32 = gluon_run(cpu, "float32", True, values)
    for hybrid in (False, True):
        got = gluon_run(card, "float16", hybrid, values)
        arm = "gluon_" + ("hybridized" if hybrid else "imperative")
        gap = F16Gap(arm)
        gap.hold(got["outputs"], ref16["outputs"], ref32["outputs"],
                 "outputs")
        out_err = gap.hold_abs(got["outputs"], ref16["outputs"],
                               ref32["outputs"], "outputs")
        loss_err = gap.hold_abs(got["loss"], ref16["loss"], ref32["loss"],
                                "loss")
        for key in ("grads", "aux"):
            for k in got[key]:
                gap.hold(got[key][k], ref16[key][k], ref32[key][k],
                         "%s %s" % (key, k))
        check(got["masters"] and sorted(got["masters"])
              == sorted(got["grads"]), "resnet_f16_agreement %s: masters"
              % arm)
        _hold_masters(gap, (got, ref16, ref32), values, arm)
        out[arm] = dict(gap.summary(), outputs_max_abs=out_err,
                        loss_abs=loss_err)
    emit({"phase": "resnet_f16_agreement", "config": cfg, **out})


def phase_head_dim_agreement(torch, mx, ctxs=None):
    """A 2-layer transformer at head_dim 256 (d_model 512, 2 heads, ffn
    2048, vocab 4096, seq 256), card against CPU from the same numpy
    weights: one f32 TrainStep step (train_agreement's SGD, learning rate
    0.05 and momentum 0.9; outputs within 1e-4 of their largest CPU
    value, every parameter's move within 1e-3 of its largest CPU move,
    as train_agreement holds them), then prefill
    plus 8 decode steps through the decode-step
    pair (prefill logits rtol/atol 1e-4, greedy streams under the
    margin rule)."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.weights import convert_params
    cfg = dict(num_classes=4096, num_layers=2, d_model=512, num_heads=2,
               ffn_dim=2048, seq_len=256)
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    np_params = seeded_params(cfg)
    B, S = 2, cfg["seq_len"]
    x, y = _token_batches(cfg, B, SEED + 29)
    runs = []
    for ctx in ctxs:
        ts = TrainStep(transformer.get_symbol(**cfg), mx.optimizer.SGD(
            learning_rate=TRAIN["lr"], momentum=TRAIN["momentum"]),
            data_shapes={"data": (B, S)},
            label_shapes={"softmax_label": (B * S,)}, ctx=ctx)
        ts.init_params(mx.init.Xavier(), arg_params=np_params)
        out = ts.step({"data": x, "softmax_label": y.reshape(-1)})[0]
        runs.append((out.cpu().numpy(), {n: t.cpu().numpy() - np_params[n]
                                          for n, t in ts.params.items()}))
        del ts
    (go, gp), (co, cp) = runs
    check(np.allclose(go, co, rtol=0, atol=1e-4 * float(np.abs(co).max())),
          "head_dim_agreement: step outputs differ by %g"
          % float(np.abs(go - co).max()))
    worst = 0.0
    for n, ref in cp.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(gp[n] - ref).max())
        check(err <= 1e-3 * scale, "head_dim_agreement: %s moved by %g "
              "more or less than on the CPU (largest CPU move %g)"
              % (n, err, scale))
        worst = max(worst, err / scale if scale else 0.0)
    prompts = _serve_prompts(cfg, SEED + 30, (40, 100, 150))
    new = 8
    streams = []
    for ctx in ctxs:
        dexe, pexe = bind_prefill_pair(mx, convert_params(np_params, ctx,
                                                          cfg), cfg, ctx,
                                       len(prompts), S)
        got, _, _, _, counts = run_prefill_pair(
            torch, dexe, pexe, prompts, new, ctx.device_type == "gpu")
        streams.append((got, counts))
        del dexe, pexe
    (gg, gcount), (cg, _) = streams
    if ctxs[0].device_type == "gpu":
        check(gcount["prefill"][0]["paged_prefill_attend"] == 2
              and gcount["decode"][0]["paged_decode_attend"] == 2 * (new - 1),
              "head_dim_agreement: kernel launches %s" % gcount)
    logit_err, cut = 0.0, []
    for r, ((gt, gl), (ct, cl)) in enumerate(zip(gg, cg)):
        n, at = margin_cut(ct, cl, gt, "head_dim_agreement: request %d" % r)
        check(np.allclose(gl[0], cl[0], rtol=1e-4, atol=1e-4),
              "head_dim_agreement: request %d prefill logits differ by %g"
              % (r, float(np.abs(gl[0] - cl[0]).max())))
        logit_err = max(logit_err, float(np.abs(gl[0] - cl[0]).max()))
        if at:
            cut.append([r] + at)
    emit({"phase": "head_dim_agreement", "config": cfg, "head_dim": 256,
          "train_worst_rel_err": worst,
          "train_out_max_abs_err": float(np.abs(go - co).max()),
          "prefill_logit_max_abs_err": logit_err,
          "streams_equal": all(g[0] == c[0] for g, c in zip(gg, cg)),
          "cut_at_small_margin": cut})


# ----------------------------------------------------------------------
# mx.rtc (row 9) and Gluon
# ----------------------------------------------------------------------
def rtc_axpy_plain(x, y, alpha):
    """The plain PyTorch version of the axpy kernels: y + alpha * x."""
    return y + alpha * x


def rtc_row_sum_plain(x):
    """The plain PyTorch version of row_sum."""
    return x.sum(dim=1)


def _host_launch_us(torch, launch, reps):
    """Host microseconds per launch call, the device drained first."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def phase_rtc(torch, mx, dev, flush):
    """mx.rtc.CudaModule: compile the three user kernels with NVRTC,
    launch each once through the user API (the counted run), hold each
    against its plain version, time it, and check that a compile error
    raises with NVRTC's log and a CPU context raises."""
    from mxnet_tpu_torch import rtc
    g = torch.Generator(device="cpu").manual_seed(SEED + 31)
    n, R, C, nd_ = RTC["n"], RTC["rows"], RTC["cols"], RTC["n_double"]
    a = RTC["alpha"]
    x = torch.randn(n, generator=g).to(dev)
    y0 = torch.randn(n, generator=g).to(dev)
    m = torch.randn(R, C, generator=g).to(dev)
    xd = torch.randn(nd_, generator=g, dtype=torch.float64).to(dev)
    yd0 = torch.randn(nd_, generator=g, dtype=torch.float64).to(dev)
    compile_ms = {}
    mods = {}
    for name, src, opts, exports in (
            ("axpy", RTC_AXPY, (), ()),
            ("row_sum", RTC_ROW_SUM, (), ()),
            ("axpy<double>", RTC_AXPY_T, ("--fmad=false",),
             ("axpy<double>",))):
        t0 = time.perf_counter()
        mods[name] = rtc.CudaModule(src, options=opts, exports=exports,
                                    ctx=mx.gpu(0))
        compile_ms[name] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rtc.CudaModule(RTC_AXPY, ctx=mx.gpu(0))
    cached_ms = (time.perf_counter() - t0) * 1e3
    kernels = {
        "axpy": mods["axpy"].get_kernel(
            "axpy", "const float *x, float *y, float alpha, int n"),
        "row_sum": mods["row_sum"].get_kernel(
            "row_sum", "const float *x, float *out, int cols"),
        "axpy<double>": mods["axpy<double>"].get_kernel(
            "axpy<double>", "const double *x, double *y, double alpha, "
            "int n")}
    nd = mx.nd
    X, M, XD = nd.NDArray(x), nd.NDArray(m), nd.NDArray(xd)
    Y, YD = nd.NDArray(y0.clone()), nd.NDArray(yd0.clone())
    OUT = nd.NDArray(torch.empty(R, device=dev))
    grid, block = (RTC["grid"], 1, 1), (RTC["block"], 1, 1)
    calls = {
        "axpy": lambda: kernels["axpy"].launch([X, Y, a, n], mx.gpu(0),
                                               grid, block),
        "row_sum": lambda: kernels["row_sum"].launch(
            [M, OUT, C], mx.gpu(0), (R, 1, 1), block,
            RTC["block"] * 4),
        "axpy<double>": lambda: kernels["axpy<double>"].launch(
            [XD, YD, a, nd_], mx.gpu(0), grid, block)}
    # the counted run: each kernel once through the user API
    rtc.LAUNCHES.clear()
    for name in calls:
        calls[name]()
    torch.cuda.synchronize()
    launches = dict(rtc.LAUNCHES)
    check(launches == {k: 1 for k in calls}, "rtc: launches %s" % launches)
    got = {"axpy": Y._data, "row_sum": OUT._data, "axpy<double>": YD._data}
    ref = {"axpy": rtc_axpy_plain(x, y0, a), "row_sum": rtc_row_sum_plain(m),
           "axpy<double>": rtc_axpy_plain(xd, yd0, a)}
    errs = {k: max_err(got[k], ref[k]) for k in got}
    check(close(torch, got["axpy"], ref["axpy"]), "rtc: axpy differs from "
          "its plain version by %g" % errs["axpy"])
    # a sum in another order: rtol of the row's sum of magnitudes (a row
    # of N(0, 1) can sum to nearly 0, where a plain rtol means nothing)
    scale = m.abs().sum(dim=1)
    check(bool(((got["row_sum"] - ref["row_sum"]).abs()
                <= RTOL * scale + ATOL).all()),
          "rtc: row_sum differs from its plain version by %g"
          % errs["row_sum"])
    check(bool(torch.equal(got["axpy<double>"], ref["axpy<double>"])),
          "rtc: axpy<double> is not bit-equal to its plain version (max "
          "error %g)" % errs["axpy<double>"])
    # errors: a compile error carries NVRTC's log; a CPU context, a wrong
    # dtype and an unknown kernel raise
    for what, fn, needle in (
            ("compile error", lambda: rtc.CudaModule(
                'extern "C" __global__ void bad(float *y) '
                '{ y[0] = undefined_symbol; }', ctx=mx.gpu(0)),
             "undefined_symbol"),
            ("cpu ctx", lambda: kernels["axpy"].launch(
                [X, Y, a, n], mx.cpu(), grid, block), "GPU"),
            ("dtype", lambda: kernels["axpy"].launch(
                [XD, Y, a, n], mx.gpu(0), grid, block), "float64"),
            ("unknown kernel", lambda: mods["axpy"].get_kernel(
                "nope", "int n"), "nope")):
        try:
            fn()
        except mx.MXNetError as e:
            check(needle in str(e), "rtc: the %s error does not name %r: %s"
                  % (what, needle, e))
        else:
            raise SmokeFailure("rtc: %s did not raise" % what)
    # times: each kernel's launch (y reset is outside the bracket; axpy
    # stays right whatever y holds), plain version, library call
    Yt, YDt = nd.NDArray(y0.clone()), nd.NDArray(yd0.clone())
    timed = {
        "axpy": (lambda: kernels["axpy"].launch([X, Yt, a, n], mx.gpu(0),
                                                grid, block),
                 lambda: rtc_axpy_plain(x, y0, a),
                 lambda: Yt._data.add_(x, alpha=a),
                 bound(3 * 4 * n, 2 * n)),
        "row_sum": (calls["row_sum"], lambda: rtc_row_sum_plain(m),
                    lambda: m.sum(dim=1), bound(4 * R * C + 4 * R, R * C)),
        "axpy<double>": (
            lambda: kernels["axpy<double>"].launch(
                [XD, YDt, a, nd_], mx.gpu(0), grid, block),
            lambda: rtc_axpy_plain(xd, yd0, a),
            lambda: YDt._data.add_(xd, alpha=a),
            bound(3 * 8 * nd_, 2 * nd_, F64_FLOPS_PER_S))}
    rows = []
    for name, (kern, plain, lib, (b, by)) in timed.items():
        rows.append({
            "name": "rtc:" + name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/rtc.cu",
            "replaces": "mxnet_tpu/rtc.py:54", "max_abs_err": errs[name],
            "ms": time_ms(torch, kern, flush),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(torch, lib, flush),
            "dtype": "float64" if "double" in name else "float32",
            "compile_ms": compile_ms[name],
            "host_launch_us": _host_launch_us(torch, kern,
                                              RTC["launch_reps"]),
            "launches": launches[name]})
    emit({"phase": "rtc", "config": RTC, "cached_module_ms": cached_ms,
          "kernels": rows})
    return rows


def _gluon_resnet50(mx, classes):
    from mxnet_tpu_torch.base import NameManager
    with NameManager():
        return mx.gluon.model_zoo.vision.resnet50_v2(classes=classes)


def phase_gluon_resnet(torch, mx, ctx=None, cfg=GLUON, fit_p50=None):
    """Model-zoo ResNet-50 v2 trained through Gluon at full width in
    three f32 arms (imperative, hybridized, hybridized with 2-bit
    compression), each from the same Xavier draw (mx.random.seed) over
    two fixed batches, then two float16 arms (imperative and hybridized:
    ``net.cast('float16')`` before ``initialize``, f16 batches, the
    logits cast to f32 for the loss, a Trainer with ``multi_precision``,
    whose masters every weight matrix's must move; the hybridized graph
    passes the executor's float16 check).  Returns the 2-bit arm's
    launch counts and steps."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    ctx = ctx or mx.gpu(0)
    on_card = ctx.device_type == "gpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    B, steps = cfg["batch"], cfg["steps"]
    x, y = _image_batches(cfg["image"], B * cfg["batches"], SEED + 23,
                          cfg["classes"])
    data = [(mx.nd.array(x[i * B:(i + 1) * B], ctx=ctx),
             mx.nd.array(y[i * B:(i + 1) * B], ctx=ctx))
            for i in range(cfg["batches"])]
    counts = LAUNCHES if on_card else PLAIN_CALLS
    data16 = [(d.astype("float16"), lab) for d, lab in data]
    arms = {}
    for arm, hybrid, comp, f16 in (
            ("imperative", False, None, False),
            ("hybridized", True, None, False),
            ("hybridized_2bit", True, {"type": "2bit",
                                       "threshold": cfg["threshold"]},
             False),
            ("imperative_f16", False, None, True),
            ("hybridized_f16", True, None, True)):
        t0 = time.perf_counter()
        mx.random.seed(SEED)
        net = _gluon_resnet50(mx, cfg["classes"])
        if f16:
            net.cast("float16")
        net.initialize(mx.init.Xavier(), ctx=ctx)
        if hybrid:
            net.hybridize()
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": cfg["lr"], "momentum": cfg["momentum"],
             "wd": cfg["wd"], "multi_precision": f16}, kvstore="device",
            compression_params=comp)
        sync()
        setup_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_ms, quant, buckets = [], [], [], []
        for i in range(steps):
            d, lab = (data16 if f16 else data)[i % cfg["batches"]]
            t0 = time.perf_counter()
            with autograd.record():
                out = net(d)
                loss = loss_fn(mx.nd.Cast(out, dtype="float32") if f16
                               else out, lab)
            loss.backward()
            trainer.step(B)
            losses.append(float(loss.mean().asscalar()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            quant.append(counts["two_bit_quantize_fused"])
            buckets.append(trainer._kvstore._engine.stats["buckets"])
        sync()
        launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
        step_quant = np.diff([0] + quant).tolist()
        step_buckets = np.diff([0] + buckets).tolist()
        check(all(np.isfinite(losses)), "gluon_resnet %s: non-finite loss "
              "%s" % (arm, losses))
        last_same = losses[steps - cfg["batches"]]
        check(last_same < losses[0], "gluon_resnet %s: the loss on the "
              "repeated batch did not fall (%g -> %g)"
              % (arm, losses[0], last_same))
        if comp is None:
            check(quant[-1] == 0, "gluon_resnet %s: the quantizer ran %d "
                  "times" % (arm, quant[-1]))
        else:
            check(step_quant == step_buckets and step_quant[-1] > 0,
                  "gluon_resnet 2bit: quantize launches per step %s, "
                  "buckets per step %s" % (step_quant, step_buckets))
            arms["launches"] = launches
        if on_card:
            check(not any(plain.values()), "gluon_resnet %s: plain versions "
                  "ran on the main path: %s" % (arm, plain))
        masters = None
        if f16:
            params = net.collect_params()
            low = [k for k, p in params.items() if k.endswith("_weight")]
            check(all(params[k].data()._data.dtype == torch.float16
                      for k in low), "gluon_resnet %s: weights not f16" % arm)
            upd = trainer._kvstore._updater if trainer._update_on_kvstore \
                else trainer._updaters[0]
            names = [p.name for p in trainer._params]
            w32 = {names[k]: st[1]._data for k, st in upd.states.items()
                   if isinstance(st, tuple) and len(st) == 2}
            masters = sum(1 for k in low if k in w32 and bool(
                (w32[k].half() != params[k].data()._data).sum() == 0)
                and bool((w32[k] != w32[k].half().float()).any()))
            check(sorted(w32) == sorted(k for k, p in params.items()
                                        if p.grad_req != "null")
                  and masters == len(low),
                  "gluon_resnet %s: %d of %d weight matrices have an f32 "
                  "master that rounds to the weight and moved off f16's "
                  "grid" % (arm, masters, len(low)))
        p50 = statistics.median(sorted(step_ms[cfg["warmup"]:]))
        arms[arm] = {"setup_s": setup_s, "step_ms": step_ms,
                     "step_ms_p50": p50, "images_per_s": B / (p50 / 1e3),
                     "loss_first": losses[0], "loss_last": losses[-1],
                     "loss": losses, "launches": {
                         k: v for k, v in launches.items() if v},
                     "quantize_launches_per_step": step_quant,
                     "buckets_per_step": step_buckets,
                     "f32_masters_of_f16_weights": masters,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                     if on_card else None}
        del net, trainer, loss, out
    for names, rtol in ((("imperative", "hybridized", "hybridized_2bit"),
                         cfg["loss_rtol"]),
                        (("imperative_f16", "hybridized_f16"),
                         cfg["loss_rtol_f16"])):
        first = [arms[a]["loss"][0] for a in names]
        check(max(first) - min(first) <= rtol * abs(first[0]),
              "gluon_resnet: first-step losses of the arms differ: %s"
              % first)
    emit({"phase": "gluon_resnet", "config": cfg,
          "module_fit_step_ms_p50": fit_p50,
          **{a: arms[a] for a in ("imperative", "hybridized",
                                  "hybridized_2bit", "imperative_f16",
                                  "hybridized_f16")}})
    return arms["launches"], steps


def _gluon_step(mx, net, x, y, hybrid):
    """One recorded step of ``net`` (SGD through kvstore='device');
    returns the output and each parameter's move, as numpy."""
    from mxnet_tpu_torch import autograd, gluon
    if hybrid:
        net.hybridize()
    params = net.collect_params()
    before = {k: p.data().asnumpy() for k, p in params.items()}
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": GLUON["lr"],
                                            "momentum": GLUON["momentum"],
                                            "wd": GLUON["wd"]},
                            kvstore="device")
    with autograd.record():
        out = net(x)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, y)
    loss.backward()
    trainer.step(x.shape[0])
    moved = np.concatenate([(p.data().asnumpy() - before[k]).ravel()
                            for k, p in params.items()])
    return out.asnumpy(), moved


def phase_gluon_agreement(torch, mx, ctxs=None, cfg=GLUON_AGREE):
    """Gluon on the card against the CPU from the same numpy weights:
    ResNet-18 v2 one step, imperative and hybridized (outputs and
    parameter moves within relative-L2 bounds), and an nn.LayerNorm
    block forward and backward (row 3's kernels on the Gluon path)."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.base import NameManager
    from mxnet_tpu_torch.kernels import LAUNCHES, reset_counts
    from mxnet_tpu_torch.weights import gluon_params_from_numpy
    ctxs = ctxs or (mx.gpu(0), mx.cpu())
    B = cfg["batch"]
    x, y = _image_batches(cfg["image"], B, SEED + 29, cfg["classes"])
    arrays = None
    result = {}
    for hybrid in (False, True):
        runs = []
        for ctx in ctxs:
            with NameManager():
                net = gluon.model_zoo.vision.resnet18_v2(
                    classes=cfg["classes"])
            net.initialize(mx.init.Xavier(), ctx=ctx)
            xs = mx.nd.array(x, ctx=ctx)
            if arrays is None:
                mx.random.seed(SEED)
                net(xs)                       # finishes deferred init
                arrays = {k: p.data().asnumpy()
                          for k, p in net.collect_params().items()}
            gluon_params_from_numpy(net, arrays)
            runs.append(_gluon_step(mx, net, xs, mx.nd.array(y, ctx=ctx),
                                    hybrid))
        (go, gm), (co, cm) = runs
        out_l2, move_l2 = _rel_l2(go, co), _rel_l2(gm, cm)
        arm = "hybridized" if hybrid else "imperative"
        check(out_l2 <= cfg["out_l2"], "gluon_agreement %s: outputs differ "
              "by %g relative L2" % (arm, out_l2))
        check(move_l2 <= cfg["move_l2"], "gluon_agreement %s: parameter "
              "moves differ by %g relative L2" % (arm, move_l2))
        result[arm] = {"out_rel_l2": out_l2, "move_rel_l2": move_l2}
    # nn.LayerNorm: the LayerNorm kernels forward and backward
    rows, width = cfg["ln_shape"]
    rng = np.random.RandomState(SEED + 37)
    xa = rng.standard_normal((rows, width)).astype(np.float32)
    gamma = 1 + 0.1 * rng.standard_normal(width).astype(np.float32)
    beta = 0.1 * rng.standard_normal(width).astype(np.float32)
    dy = rng.standard_normal((rows, width)).astype(np.float32)
    for hybrid in (False, True):
        got = []
        for ctx in ctxs:
            with NameManager():
                ln = gluon.nn.LayerNorm(in_channels=width)
            ln.initialize(ctx=ctx)
            gluon_params_from_numpy(ln, {"layernorm0_gamma": gamma,
                                         "layernorm0_beta": beta})
            if hybrid:
                ln.hybridize()
            xs = mx.nd.array(xa, ctx=ctx)
            xs.attach_grad()
            reset_counts()
            with autograd.record():
                out = ln(xs)
            out.backward(mx.nd.array(dy, ctx=ctx))
            got.append([out.asnumpy(), xs.grad.asnumpy(),
                        ln.gamma.grad().asnumpy(), ln.beta.grad().asnumpy()])
            if ctx.device_type == "gpu":
                check(LAUNCHES["layernorm_fused"] == 1
                      and LAUNCHES["layernorm_fused_bwd"] == 1,
                      "gluon_agreement: nn.LayerNorm launched %s"
                      % {k: v for k, v in LAUNCHES.items() if v})
        for a, b, what in zip(got[0], got[1], ("out", "dx", "dgamma",
                                               "dbeta")):
            check(np.allclose(a, b, rtol=RTOL, atol=ATOL * max(
                1.0, float(np.abs(b).max()))), "gluon_agreement: "
                "nn.LayerNorm %s differs by %g" % (what,
                                                    float(np.abs(a - b).max())))
    emit({"phase": "gluon_agreement", "config": cfg, **result,
          "layernorm": "agrees"})


# ----------------------------------------------------------------------
# Row 10: fused_band4d, and the fused-sandwich microbenchmark
# ----------------------------------------------------------------------
def _band_case(torch, g, dev, B, H, W, K, N, dtype):
    x = torch.randn(B, H, W, K, device=dev, generator=g).to(dtype)
    s = 1 + 0.2 * torch.randn(K, device=dev, generator=g)
    t = 0.2 * torch.randn(K, device=dev, generator=g)
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).to(dtype)
    return x, s, t, w


def _band_times(torch, mxk, x, s, t, w, flush):
    """One band timed as in 3 (f32, bf16 or f16): the kernel, its plain
    version, torch.matmul on the already activated input (the product
    alone) and row 7's kernel on the 2-D view; bounded by bytes or by
    operations at the tensor cores' peak (split TF32 in f32, the CUDA-core
    bound beside it), with TFLOP/s and GB/s."""
    B, H, W, K = x.shape
    N = w.shape[1]
    M = B * H * W
    a = torch.relu(x.float() * s + t).to(w.dtype)
    w_nk = w.t().contiguous()
    x2 = x.reshape(-1, K).contiguous()
    row = dict(
        ms=time_ms(torch, lambda: mxk.fused_band4d(x, s, t, w), flush),
        plain_ms=time_ms(torch, lambda: mxk.fused_band4d_plain(x, s, t, w),
                         flush, reps=20),
        library_ms=time_ms(torch, lambda: torch.matmul(a, w), flush),
        pal2d_ms=time_ms(torch, lambda: mxk.fused_scale_relu_matmul_fwd(
            x2, s, t, w_nk), flush))
    nbytes = x.element_size() * (M * K + K * N + M * N) + 4 * 2 * K
    flops = 2 * M * K * N + 3 * M * K
    f32 = x.dtype == torch.float32
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, flops, SPLIT_TF32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S)
    if f32:
        row["bound_cuda_cores_ms"] = bound(nbytes, flops)[0]
    row["tflops"] = 2 * M * K * N / row["ms"] / 1e9
    row["gbps"] = nbytes / row["ms"] / 1e6
    return row


def phase_fused_band4d(torch, mxk, dev, flush):
    """fused_band4d against its plain version (bf16: close_bf16; f32:
    rtol 1e-4 / atol 1e-5), two runs bit-identical, at the sandwich's
    two bands (the up band's input the channel-last view of cuDNN's
    output, the down band's a contiguous (B, H, W, K) tensor), at a shape
    whose rows pick the TPU kernel's th = 16, on an NHWC view of an NCHW
    tensor (channel stride H*W), on a channel slice of a wider tensor, at
    an odd shape and, in bf16, at the edges of the GEMM's tiling
    (BAND4D_EDGES).  The f32 form (split TF32 on the tensor cores,
    fused_gemm_f32.cuh with W (K, N)) is held at the sandwich's bands in
    f32, at the f32 shape, the odd shape, a ragged M, the NHWC view and
    the channel slice, and bit-equal to row 7's f32 kernel on the 2-D
    view.  The f16 form (the 16-bit GEMM's f16 instances) is held at
    close_f16_fused at the sandwich's bands in f16, the th = 16 and odd
    shapes, the tiling edges, the NHWC view, the channel slice and the
    overflow and NaN case of _f16_special as a (1, 64, 64, K) band, and
    bit-equal to row 7's f16 kernel on the 2-D view.  ptxas's lines and
    the dynamic shared memory of both GEMMs' instances are printed first
    (no spills).  Every type's bands are timed beside the plain version,
    torch.matmul on the already activated input and row 7's kernel on
    the 2-D view, with TFLOP/s and GB/s; f16's also beside its bf16 twin
    on the same values.  Returns the three kernels-line rows (bf16, f32,
    f16), per-launch means over the sandwich's two bands."""
    from mxnet_tpu_torch.tools import fused_sandwich as fs
    ptx = {"bfloat16": _fused_gemm_ptxas("fused_band4d"),
           "float32": _fused_gemm_f32_ptxas("fused_band4d"),
           "float16": _fused_gemm_ptxas("fused_band4d", "float16")}
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    bf, f32, hf = torch.bfloat16, torch.float32, torch.float16
    tags = {bf: "", f32: "_f32", hf: "_f16"}
    cases = [(name, x, s, t, w) for name, x, s, t, w
             in fs.band_shapes(fs.inputs(dev))]
    cases += [(name + "_f32", x, s, t, w) for name, x, s, t, w
              in fs.band_shapes(fs.inputs(dev, f32))]
    cases += [(name + "_f16", x, s, t, w) for name, x, s, t, w
              in fs.band_shapes(fs.inputs(dev, hf))]
    for key, dtype in (("th_shape", bf), ("f32_shape", f32),
                       ("odd_shape", bf), ("odd_shape", f32),
                       ("th_shape", hf), ("odd_shape", hf)):
        cases.append((key + ("" if key == "f32_shape" else tags[dtype]),
                      *_band_case(torch, g, dev, *BAND4D[key], dtype)))
    for key, shape in BAND4D_EDGES.items():
        for dtype in (bf, hf):
            cases.append((key + tags[dtype],
                          *_band_case(torch, g, dev, *shape, dtype)))
    cases.append(("ragged_m_f32", *_band_case(
        torch, g, dev, *BAND4D_EDGES["ragged_m"], f32)))
    for dtype in (bf, f32, hf):
        x, s, t, w = _band_case(torch, g, dev, *BAND4D["f32_shape"], dtype)
        nchw_view = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        wide = torch.zeros(*x.shape[:3], x.shape[3] + 8, dtype=dtype,
                           device=dev)
        wide[..., :x.shape[3]] = x
        cases += [("nchw_view" + tags[dtype], nchw_view, s, t, w),
                  ("channel_slice" + tags[dtype], wide[..., :x.shape[3]], s,
                   t, w)]
    M, K, N = F16_SPECIAL
    x, s, t, w, _ = _f16_special(torch, g, dev, M, K, N, False)
    cases.append(("special_f16", x.view(1, 64, M // 64, K), s, t,
                  w.t().contiguous()))
    rows = {"bfloat16": [], "float32": [], "float16": []}
    errs = {"bfloat16": [], "float32": [], "float16": []}
    special = None
    for name, x, s, t, w in cases:
        dt = str(x.dtype).replace("torch.", "")
        got = mxk.fused_band4d(x, s, t, w)
        again = mxk.fused_band4d(x, s, t, w)
        ref = mxk.fused_band4d_plain(x, s, t, w)
        torch.cuda.synchronize()
        ok = close_bf16(torch, got, ref) if x.dtype == bf \
            else close_f16_fused(torch, got, ref) if x.dtype == hf \
            else close(torch, got, ref)
        check(got.dtype == x.dtype and tuple(got.shape)
              == tuple(x.shape[:3]) + (w.shape[1],),
              "fused_band4d %s returned %s %s" % (name, got.dtype,
                                                 tuple(got.shape)))
        check(ok, "fused_band4d %s disagrees with its plain version (max abs "
              "err %g)" % (name, max_err(got, ref)))
        bits = torch.int16 if x.dtype != f32 else torch.int32
        check(torch.equal(got.view(bits), again.view(bits)),
              "fused_band4d %s: two runs differ" % name)
        if x.dtype != bf:
            # row 7's kernel on the 2-D view: one tiling, one sum order
            two = mxk.fused_scale_relu_matmul_fwd(
                x.reshape(-1, x.shape[3]).contiguous(), s, t,
                w.t().contiguous())
            check(torch.equal(got.reshape(two.shape).view(bits),
                              two.view(bits)),
                  "fused_band4d %s %s: not bit-equal to row 7 on the 2-D "
                  "view (max abs %g)" % (dt, name, max_err(
                      got.reshape(two.shape), two)))
            del two
        if name == "special_f16":
            special = {"nan": int(torch.isnan(ref).sum()),
                       "inf": int(torch.isinf(ref).sum()),
                       "same_non_finite": True}
            check(special["nan"] > 0 and special["inf"] > 0, "fused_band4d "
                  "special_f16: the case reached no inf or NaN")
            del got, again, ref
            continue
        errs[dt].append(max_err(got, ref))
        row = {"case": name, "shape": list(x.shape) + [w.shape[1]],
               "dtype": dt, "x_strides": list(x.stride()),
               "x_contiguous": x.is_contiguous(), "max_abs_err": errs[dt][-1]}
        del got, again, ref
        if name in ("up", "down", "up_f32", "down_f32", "up_f16",
                    "down_f16"):
            row.update(_band_times(torch, mxk, x, s, t, w, flush))
            if x.dtype == hf:
                xb, wb = x.to(bf), w.to(bf)
                row["bf16_twin_ms"] = time_ms(
                    torch, lambda: mxk.fused_band4d(xb, s, t, wb), flush)
                del xb, wb
            rows[dt].append(row)
        emit({"phase": "kernel", "name": "fused_band4d", **row})
    out = []
    for dt, source, lib_call in (
            ("bfloat16", "mxnet_tpu_torch/csrc/fused_gemm_bf16.cuh",
             "torch.matmul in bf16"),
            ("float32", "mxnet_tpu_torch/csrc/fused_gemm_f32.cuh",
             "torch.matmul in f32, TF32 off,"),
            ("float16", "mxnet_tpu_torch/csrc/fused_gemm_bf16.cuh",
             "torch.matmul in f16")):
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "pal2d_ms") + \
            (("bound_cuda_cores_ms",) if dt == "float32" else ()) + \
            (("bf16_twin_ms",) if dt == "float16" else ())
        per_launch = {k: sum(r[k] for r in rows[dt]) / len(rows[dt])
                      for k in keys}
        extra = {"special": special} if dt == "float16" else {}
        emit({"phase": "fused_band4d" + {"bfloat16": "", "float32": "_f32",
                                         "float16": "_f16"}[dt], **extra,
              "cases_checked": len(errs[dt]), "ptxas": ptx[dt],
              "bands": {r["case"]: {k: r[k] for k in keys + ("tflops", "gbps")}
                        for r in rows[dt]},
              "library_call": lib_call + " on relu(x*scale+shift) (the "
                              "product alone)", **per_launch})
        out.append({"name": "fused_band4d", "route": "cuda", "dtype": dt,
                    "source": source,
                    "replaces": "tools/fused_sandwich_bench.py:61",
                    "max_abs_err": max(errs[dt]),
                    "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                               for r in rows[dt])
                    else "operations",
                    **{k: per_launch[k] for k in ("ms", "plain_ms",
                                                  "library_ms", "bound_ms")}})
    return out


def _sandwich_run(torch, fs, dev, dtype):
    """The sandwich in ``dtype``: the three arms' outputs agree (pal2d and
    pal4d bit for bit, plain within SANDWICH's relative L2, pal4d
    finite), then each arm's timed run; every band launch is counted
    under ``dtype``, 2 an iteration, and no plain version runs.  Returns
    (arms, plain-vs-pal4d relative L2, the timed runs' launches of the
    two kernels in ``dtype``)."""
    from mxnet_tpu_torch.kernels import (LAUNCHES_BY_DTYPE, PLAIN_CALLS,
                                         reset_counts)
    dt = str(dtype).replace("torch.", "")
    args = fs.inputs(dev, dtype)
    with torch.no_grad():
        outs = {name: fs.make_net(band)(*fs.arm_args(name, args))
                for name, band in fs.ARMS.items()}
        torch.cuda.synchronize()
        check(torch.equal(outs["pal2d"], outs["pal4d"]),
              "sandwich %s: pal2d and pal4d outputs differ (max abs %g)"
              % (dt, max_err(outs["pal2d"], outs["pal4d"])))
        plain_l2 = float((outs["plain"].float() - outs["pal4d"].float())
                         .norm() / outs["pal4d"].float().norm())
        check(plain_l2 <= SANDWICH["plain_l2"] and bool(
            torch.isfinite(outs["pal4d"].float()).all()),
              "sandwich %s: plain and pal4d outputs differ by %g relative L2"
              % (dt, plain_l2))
        del outs
        torch.cuda.empty_cache()
        reset_counts()
        arms = {}
        for name, band in fs.ARMS.items():
            arms[name] = fs.bench(fs.make_net(band), fs.arm_args(name, args))
            torch.cuda.empty_cache()
        by_dtype, plain = dict(LAUNCHES_BY_DTYPE), dict(PLAIN_CALLS)
        del args
    # each of the two captures ran one warm-up iteration, then recorded
    # its loop: two band launches per iteration
    iters = 2 + fs.N0 + fs.N0 + fs.ITERS
    launches = {k: by_dtype.get("%s:%s" % (k, dt), 0)
                for k in ("fused_band4d", "fused_scale_relu_matmul")}
    for kernel, n in launches.items():
        check(n == 2 * iters, "sandwich %s: %s launched %d times for %d "
              "iterations" % (dt, kernel, n, iters))
    check(not any(plain.values()), "sandwich %s: plain versions ran: %s"
          % (dt, plain))
    return arms, plain_l2, launches


def phase_sandwich(torch, mx):
    """The fused-sandwich microbenchmark (``tools/
    torch_fused_sandwich_bench.py``) at its shapes, in bf16, then in f32
    (TF32 off) and in f16 (_sandwich_run): each arm's ms per iteration
    from captured loops.  Returns the iterations each timed run captured
    per arm and the band launches of the bf16, f32 and f16 timed runs
    (the main path of row 10's three forms)."""
    from mxnet_tpu_torch.tools import fused_sandwich as fs
    dev = torch.device("cuda", 0)
    runs = {dt: _sandwich_run(torch, fs, dev, t) for dt, t in (
        ("bfloat16", torch.bfloat16), ("float32", torch.float32),
        ("float16", torch.float16))}
    iters = 2 + fs.N0 + fs.N0 + fs.ITERS
    out = {dt: {"plain_vs_pal4d_rel_l2": l2, "pal2d_pal4d_bit_equal": True,
                "ms_per_iter": {k: v["ms_per_iter"] for k, v in arms.items()},
                "arms": arms, "launches": launches}
           for dt, (arms, l2, launches) in runs.items()}
    emit({"phase": "sandwich", "shape": fs.SHAPE, "iters": fs.ITERS,
          "n0": fs.N0, "reps": fs.REPS, **out["bfloat16"],
          "float32": out["float32"], "float16": out["float16"]})
    return iters, {dt: r[2]["fused_band4d"] for dt, r in runs.items()}


# ----------------------------------------------------------------------
# Module.fit's single-launch fused step against the eager pair
# ----------------------------------------------------------------------
_RUNTIME_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                  "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                  "cudaMemsetAsync")


def _fit_arm(torch, mx, make, it, fit_kw, fused, steps, inspect=None):
    """Module.fit of one arm: step times, peak memory, kernel launches
    of the run, host syncs in each step (``torch.cuda.set_sync_debug_mode``
    warnings inside fit_step and update_metric), the final weights and
    metric, then ``profiled_steps`` more fit_steps under torch.profiler
    (runtime launch calls per step); ``inspect(mod)``'s result, taken
    last, under ``info["inspect"]``."""
    import gc
    import warnings
    from mxnet_tpu_torch.kernels import (LAUNCHES, LAUNCHES_BY_DTYPE,
                                         PLAIN_CALLS, reset_counts)
    from torch.profiler import ProfilerActivity, profile
    gc.collect()                    # an earlier arm's graph and its pool
    if fused:
        mod = make()
    else:
        with fit_fused_off():
            mod = make()
    metric = mx.metric.create(fit_kw["eval_metric"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stamps, syncs = [], []

    def watched(fn):
        # the step's own calls only: the loop's epoch-end metric log is
        # a read the fit loop makes once per epoch
        def run(*args, **kw):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    mod.fit_step = watched(mod.fit_step)
    mod.update_metric = watched(mod.update_metric)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def per_step(param):
            syncs.append(sum("synchroniz" in str(w.message) for w in caught))
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        reset_counts()
        stamps.append(time.perf_counter())
        syncs.append(0)
        mod.fit(it, eval_metric=metric, batch_end_callback=per_step,
                **{k: v for k, v in fit_kw.items() if k != "eval_metric"})
    torch.cuda.synchronize()
    launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
    by_dtype = dict(LAUNCHES_BY_DTYPE)
    check(len(stamps) == steps + 1, "fit_fused: %d steps ran" % (len(stamps)
                                                                 - 1))
    peak = torch.cuda.max_memory_allocated() / 1e9
    # as f32 (exact for every type; numpy's f16 arithmetic is slow and
    # rounds the comparisons' bounds)
    weights = {k: v.astype("float32").asnumpy()
               for k, v in mod.get_params()[0].items()}
    value = metric.get()[1]
    fused_fit = mod._fused_fit
    fused_steps = fused_fit.launches if fused_fit is not None else 0
    it.reset()
    batch = next(iter(it))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(FIT_FUSED["profiled_steps"]):
            mod.fit_step(batch, metric)
            mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()
    calls = {}
    for ev in prof.events():
        if ev.name in _RUNTIME_CALLS:
            calls[ev.name] = calls.get(ev.name, 0) \
                + 1 / FIT_FUSED["profiled_steps"]
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    step_syncs = np.diff(syncs).tolist()
    info = {"fused": fused_fit is not None, "step_ms": step_ms,
            "peak_mem_gb": peak, "metric": value,
            "host_syncs_per_step": step_syncs,
            "runtime_calls_per_step": calls,
            "plain_calls": {k: v for k, v in plain.items() if v},
            "launches": {k: v for k, v in launches.items() if v},
            "launches_by_dtype": by_dtype}
    if fused_fit is not None:
        first = 1 + 2                      # warm-up steps, then the capture
        info.update(captures=fused_fit.captures,
                    fused_steps=fused_steps,
                    captured_launches=fused_fit.captured_launches(),
                    captured_by_dtype=fused_fit.captured_launches(True),
                    step_ms_p50=statistics.median(step_ms[first:]))
    else:
        info["step_ms_p50"] = statistics.median(step_ms[2:])
    check(not info["plain_calls"], "fit_fused: plain versions ran: %s"
          % info["plain_calls"])
    if inspect is not None:
        info["inspect"] = inspect(mod)
    del mod
    return info, weights


def _compare_arms(name, fused, eager, initial, tol):
    """Relative L2 of the fused-minus-eager weights over the eager
    arm's move from the initial weights; fails past ``tol``."""
    diff = math.sqrt(sum(float(np.square(fused[k].astype(np.float64)
                                         - eager[k]).sum()) for k in eager))
    move = math.sqrt(sum(float(np.square(eager[k].astype(np.float64)
                                         - initial[k]).sum())
                         for k in eager))
    rel = diff / move
    worst = max(float(np.abs(fused[k] - eager[k]).max()) for k in eager)
    equal = all(np.array_equal(fused[k], eager[k]) for k in eager)
    check(move > 0 and rel <= tol, "fit_fused %s: fused and eager weights "
          "differ by %g of the move (bound %g)" % (name, rel, tol))
    return {"move_rel_l2": rel, "max_abs_diff": worst, "bit_equal": equal,
            "move_l2": move}


def phase_fit_fused(torch, mx, np_params, cfg=FULL):
    """Module.fit at full width, fused (the single-launch step: one CUDA
    graph replay per step after two warm-up steps and one capture)
    against eager (``MXNET_FIT_FUSED=0``): ResNet-50 v2 dense and 2-bit,
    the transformer (FIT_FUSED's depth; ``np_params`` are FULL's, of
    which its layers are the first).  Each fused arm must capture once, run every step
    fused, make no host sync in its steady steps, launch one graph per
    steady step, and record in its graph the quantizer once per bucket
    (2-bit) or the transformer's LayerNorm and flash kernels; its
    weights after the run within FIT_FUSED's move_l2 of the eager arm's
    and its metric within 1e-5 of the eager arm's.  Returns the fused
    arms' launch counts and captured launches."""
    from mxnet_tpu_torch.models import resnet, transformer
    from mxnet_tpu_torch.weights import convert_params, convert_symbol_params
    ctx = mx.gpu(0)
    rc = FIT_FUSED["resnet"]
    B = rc["batch"]
    shapes = dict(data=(B,) + tuple(RESNET["image_shape"]),
                  softmax_label=(B,))
    sym = resnet.get_symbol(**RESNET)
    np_args, np_aux = seeded_resnet_params(sym, B, RESNET["image_shape"])
    x, y = _image_batches(RESNET["image_shape"], B * rc["batches"],
                          SEED + 11, RESNET["num_classes"])

    def resnet_arm(thr, fused):
        comp = None if thr is None else {"type": "2bit", "threshold": thr}
        args, auxs = convert_symbol_params(np_args, np_aux, ctx, sym,
                                           **shapes)
        kv = mx.kv.create("device")
        info, w = _fit_arm(
            torch, mx, lambda: mx.Module(resnet.get_symbol(**RESNET),
                                         context=ctx, compression_params=comp),
            mx.io.NDArrayIter(x, y, batch_size=B),
            dict(num_epoch=rc["epochs"], kvstore=kv, optimizer="sgd",
                 optimizer_params={"learning_rate": rc["lr"],
                                   "momentum": rc["momentum"],
                                   "wd": rc["wd"]},
                 arg_params=args, aux_params=auxs, eval_metric="acc"),
            fused, rc["batches"] * rc["epochs"])
        if thr is not None and not fused:
            info["kv_buckets_per_step"] = kv._engine.stats["buckets"] \
                / (len(info["step_ms"]) + FIT_FUSED["profiled_steps"])
        return info, w

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out, ret = {}, {}
    try:
        for arm, thr in (("dense", None), ("2bit", rc["threshold"])):
            res = {"fused": resnet_arm(thr, True),
                   "eager": resnet_arm(thr, False)}
            out["resnet_" + arm] = _fused_arms(
                "resnet_" + arm, res, np_args,
                "two_bit_quantize_fused" if thr is not None else None)
            if thr is not None:
                ret["resnet_2bit"] = res["fused"][0]
                captured = (res["fused"][0]["captured_launches"]
                            or [{}])[0].get("two_bit_quantize_fused", 0)
                check(captured == res["eager"][0]["kv_buckets_per_step"],
                      "fit_fused resnet_2bit: %d quantizer launches captured, "
                      "%g buckets per eager step" % (
                          captured, res["eager"][0]["kv_buckets_per_step"]))
        tc = FIT_FUSED["transformer"]
        cfg = dict(cfg, num_layers=tc["num_layers"])
        Bt, S = tc["batch"], cfg["seq_len"]
        tokens, targets = _token_batches(cfg, Bt * tc["batches"], SEED + 6)
        res = {}
        for fused in (True, False):
            def make():
                mod = mx.Module(transformer.get_symbol(**cfg), context=ctx)
                mod.bind(data_shapes=[("data", (Bt, S))],
                         label_shapes=[("softmax_label", (Bt * S,))])
                mod.set_params(convert_params(np_params, ctx, cfg), {})
                return mod
            res["fused" if fused else "eager"] = _fit_arm(
                torch, mx, make,
                FlatLabels(mx, mx.io.NDArrayIter(tokens, targets,
                                                 batch_size=Bt)),
                dict(num_epoch=tc["epochs"], optimizer="sgd",
                     optimizer_params={"learning_rate": tc["lr"],
                                       "momentum": tc["momentum"]},
                     eval_metric="perplexity"),
                fused, tc["batches"] * tc["epochs"])
        out["transformer"] = _fused_arms("transformer", res, np_params,
                                         "flash_attention_fwd")
        ret["transformer"] = res["fused"][0]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # the step time with cuDNN's default algorithms, beside train_resnet's
    # eager 2-bit arm of the same run
    info, _ = resnet_arm(rc["threshold"], True)
    out["resnet_2bit_fused_default_algorithms"] = {
        k: info[k] for k in ("step_ms", "step_ms_p50", "peak_mem_gb",
                             "captures", "host_syncs_per_step")}
    emit({"phase": "fit_fused", "config": {"resnet": RESNET,
                                           "transformer": cfg},
          "train": FIT_FUSED, **out})
    return ret


def _graph_replay_ms(torch, mod, n):
    """Device ms per step of the fused step's captured graph: ``n``
    replays (more training steps on the last batch) between two CUDA
    events."""
    graphs = [p.graph for p in mod._fused_fit._programs.values()
              if p.graph is not None]
    check(len(graphs) == 1, "fit_bf16: %d captured graphs" % len(graphs))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        graphs[0].replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _low_inspect(torch, initial, replays=0, dtype=None):
    """``inspect`` for a 16-bit arm (``dtype``, bf16 by default): the
    weight matrices of that type whose f32 master moved from its initial
    (rounded) value and those that did not, the loss scaler after
    ``Module._fit_sync`` publishes it, and with ``replays`` the captured
    graph's device ms per step."""
    from mxnet_tpu_torch import fused_update
    dtype = dtype or torch.bfloat16

    def inspect(mod):
        upd = mod._kvstore._updater if mod._update_on_kvstore \
            else mod._updater
        exe = mod._exec_group._exec
        low = sorted(n for n in mod._param_names if n.endswith("_weight")
                     and exe.arg_dict[n]._data.dtype == dtype)
        moved, still = [], []
        for k, st in upd.states.items():
            name = mod._param_names[k] if isinstance(k, int) else k
            if name not in low:
                continue
            w32 = st[1]._data
            w0 = torch.from_numpy(initial[name]).to(w32.device) \
                .to(dtype).float()
            (moved if bool((w32 != w0).any()) else still).append(name)
        out = {"low_weight_matrices": len(low), "dtype": str(dtype),
               "masters_moved": len(moved), "masters_still": still,
               "masters_missing": sorted(set(low) - set(moved)
                                         - set(still))}
        if mod._loss_scaler is not None:
            mod._fit_sync()
            out.update(loss_scale=mod._loss_scaler.scale,
                       overflow_skips=mod._loss_scaler.skips,
                       loss_scale_gauge=fused_update.LOSS_SCALE.value)
        if replays:
            out["graph_replay_ms"] = _graph_replay_ms(torch, mod, replays)
        return out
    return inspect


def _low_weights(name, fw, ew, initial, tol, atol=None):
    """Fused against eager 16-bit weights: each within rtol ``tol`` and
    ``atol`` (``tol`` when not given) of the eager arm's (one bf16 ulp:
    1e-2 both; one f16 ulp: 2^-10 and 2^-24)."""
    atol = tol if atol is None else atol
    worst = max(float((np.abs(fw[k] - ew[k])
                       / (atol + tol * np.abs(ew[k]))).max()) for k in ew)
    diff = math.sqrt(sum(float(np.square(fw[k].astype(np.float64)
                                         - ew[k]).sum()) for k in ew))
    move = math.sqrt(sum(float(np.square(ew[k].astype(np.float64)
                                         - initial[k]).sum()) for k in ew))
    check(worst <= 1.0, "fit %s: fused and eager weights differ past "
          "rtol %g / atol %g (worst %g of the bound)"
          % (name, tol, atol, worst))
    return {"worst_of_bound": worst, "move_rel_l2": diff / move,
            "bit_equal": all(np.array_equal(fw[k], ew[k]) for k in ew)}


def _bf16_arm_checks(name, res, want_captured, tol):
    """``_fused_arm_checks`` with the metric at ``tol``, then the bf16
    run's own: every ``want_captured`` ("name:dtype" -> count) recorded
    in the graph and launched on the path, the loss scaler published
    with no skip, every bf16 weight matrix's master moved in both
    arms."""
    _fused_arm_checks(name, res, None, tol)
    (fi, _), (ei, _) = res["fused"], res["eager"]
    captured = (fi["captured_by_dtype"] or [{}])[0]
    for key, n in want_captured.items():
        check(captured.get(key, 0) == n and fi["launches"].get(
            key.split(":")[0], 0) > 0, "fit %s: %s recorded %d times "
              "in the graph (want %d): %s" % (name, key, captured.get(key, 0),
                                             n, captured))
    ins = fi["inspect"]
    check(ins.get("overflow_skips") == 0 and ins["loss_scale"] == 2.0 ** 15
          and ins["loss_scale_gauge"] == ins["loss_scale"],
          "fit %s: loss scaler %s" % (name, ins))
    for arm in (fi, ei):
        i = arm["inspect"]
        check(i["masters_moved"] == i["low_weight_matrices"] > 0,
              "fit %s: masters that did not move %s, missing %s"
              % (name, i["masters_still"], i["masters_missing"]))


def _overflow_case(torch, mx, ctx):
    """A bf16 MLP through a 2-bit device store, fused: two warm-up steps,
    the capture and a replay, then a batch with an inf (NaN gradients):
    the step is a graph replay with no host sync, leaves weights, stored
    weights, masters, momenta and residuals bit for bit, backs the scale
    off to 2^14 with one skip; the next finite step moves the weights."""
    import warnings
    from mxnet_tpu_torch import fused_update
    oc = FIT_BF16["overflow"]
    B, F, H, C = oc["batch"], oc["features"], oc["hidden"], oc["classes"]
    sym = mx.sym
    net = sym.Cast(sym.Variable("data"), dtype="bfloat16")
    net = sym.Activation(sym.FullyConnected(net, num_hidden=H, name="fc1"),
                         act_type="relu")
    net = sym.Cast(sym.FullyConnected(net, num_hidden=C, name="fc2"),
                   dtype="float32")
    net = sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(SEED + 40)
    params = {"fc1_weight": rng.normal(0, 0.05, (H, F)),
              "fc1_bias": np.zeros(H), "fc2_weight": rng.normal(0, 0.05,
                                                                (C, H)),
              "fc2_bias": np.zeros(C)}
    mod = mx.Module(net, context=ctx, compression_params={
        "type": "2bit", "threshold": oc["threshold"]})
    mod.bind(data_shapes=[("data", (B, F))],
             label_shapes=[("softmax_label", (B,))])
    mod.init_params(arg_params={k: mx.nd.array(v.astype(np.float32),
                                               ctx=ctx)
                                for k, v in params.items()}, aux_params={})
    kv = mx.kv.create("device")
    mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params={
        "learning_rate": oc["lr"], "momentum": 0.9,
        "multi_precision": True})

    def batch(seed, bad=False):
        r = np.random.RandomState(seed)
        x = r.rand(B, F).astype(np.float32)
        if bad:
            x[0, 0] = np.inf
        return mx.io.DataBatch(     # host batches, as an iterator gives
            data=[mx.nd.array(x, ctx=mx.cpu())],
            label=[mx.nd.array(r.randint(0, C, B).astype(np.float32),
                               ctx=mx.cpu())])

    for i in range(4):
        check(mod.fit_step(batch(i)), "fit_bf16 overflow: step %d not fused"
              % i)
    fit, scaler = mod._fused_fit, mod._loss_scaler
    exe = mod._exec_group._exec

    def snapshot():
        return ([exe.arg_dict[n]._data.clone() for n in mod._param_names]
                + [kv._store[n]._data.clone() for n in mod._param_names]
                + [leaf._data.clone() for st in kv._updater.states.values()
                   for leaf in fused_update.flatten_state(st)[0]]
                + [r.clone() for r in fit._res_flat])

    torch.cuda.synchronize()
    before = snapshot()
    bad = batch(9, bad=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fused = mod.fit_step(bad)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    after = snapshot()
    equal = len(before) == len(after) and all(
        torch.equal(a, b) for a, b in zip(before, after))
    residual_l1 = float(sum(float(r.abs().sum()) for r in fit._res_flat))
    mod._fit_sync()
    skipped = {"scale": scaler.scale, "skips": scaler.skips,
               "skips_counter": fused_update.OVERFLOW_SKIPS.value}
    check(fused and syncs == 0 and fit.captures == 1 and fit.launches == 5,
          "fit_bf16 overflow: the bad step fused %s, %d host syncs, %d "
          "captures, %d fused steps" % (fused, syncs, fit.captures,
                                        fit.launches))
    check(equal and residual_l1 > 0, "fit_bf16 overflow: the skipped step "
          "changed the training state (bit-equal %s, residual L1 %g)"
          % (equal, residual_l1))
    check(skipped["skips"] == 1 and skipped["scale"] == 2.0 ** 14,
          "fit_bf16 overflow: scaler after the bad step %s" % skipped)
    check(mod.fit_step(batch(10)), "fit_bf16 overflow: finite step not fused")
    torch.cuda.synchronize()
    moved = any(not torch.equal(a, b) for a, b in zip(before, snapshot()))
    mod._fit_sync()
    check(moved and scaler.skips == 1, "fit_bf16 overflow: the finite step "
          "after it moved %s, skips %d" % (moved, scaler.skips))
    return {"bad_step_host_syncs": syncs, "state_bit_equal": equal,
            "tensors_compared": len(before),
            "residual_l1_before": residual_l1, "after_bad_step": skipped,
            "scale_after_finite_step": scaler.scale,
            "captures": fit.captures, "fused_steps": fit.launches}


def phase_fit_bf16(torch, mx, np_params, cfg=FULL):
    """bf16 ``Module.fit`` at full width, fused against eager
    (``MXNET_FIT_FUSED=0``), as FIT_BF16 says: the transformer with
    ``dtype='bfloat16'`` (its graph records each bf16 flash kernel 12
    times and the bf16 LayerNorm forward and backward 25 times) and
    ResNet-50 v2 in bf16 through a 2-bit device store (its graph records
    the f32 quantizer once per bucket the eager store dispatches).  Each
    fused arm: one capture, every step fused, no host sync and one graph
    launch in a steady step, no plain version, the loss scaler published
    with no skip; every bf16 weight matrix's f32 master moves in both
    arms; fused weights within one bf16 ulp of eager's.  Then the
    transformer fused with ``MXNET_LOSS_SCALE=off`` (graph replay ms
    beside the scaler's) and the overflow case.  Returns the fused arms'
    info."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    ctx = mx.gpu(0)
    tol, replays = FIT_BF16["weights_tol"], FIT_BF16["replays"]
    out, ret = {}, {}
    tc = FIT_BF16["transformer"]
    Bt, S = tc["batch"], cfg["seq_len"]
    tokens, targets = _token_batches(cfg, Bt * tc["batches"], SEED + 41)
    fit_t = dict(num_epoch=tc["epochs"], optimizer="sgd",
                 optimizer_params={"learning_rate": tc["lr"],
                                   "momentum": tc["momentum"],
                                   "multi_precision": True},
                 eval_metric="perplexity")

    def make_lm():
        mod = mx.Module(transformer.get_symbol(dtype="bfloat16", **cfg),
                        context=ctx)
        mod.bind(data_shapes=[("data", (Bt, S))],
                 label_shapes=[("softmax_label", (Bt * S,))])
        mod.set_params(convert_params(np_params, ctx, cfg), {})
        return mod

    def lm_iter():
        return FlatLabels(mx, mx.io.NDArrayIter(tokens, targets,
                                                batch_size=Bt))

    res = {}
    for fused in (True, False):
        res["fused" if fused else "eager"] = _fit_arm(
            torch, mx, make_lm, lm_iter(), fit_t, fused,
            tc["batches"] * tc["epochs"],
            _low_inspect(torch, np_params, replays if fused else 0))
    _bf16_arm_checks("transformer", res, {
        "%s:bfloat16" % k: n for k, n in TRAIN_LAUNCHES.items()}, tol)
    out["transformer"] = {"fused": res["fused"][0], "eager": res["eager"][0],
                          "weights": _low_weights(
                              "transformer", res["fused"][1],
                              res["eager"][1], np_params, tol)}
    ret["transformer"] = res["fused"][0]
    for arm in ("fused", "eager"):
        info = res[arm][0]
        info["tokens_per_s"] = Bt * S / (info["step_ms_p50"] / 1e3)
    # the same fused step without the scaler: the select's device cost
    os.environ["MXNET_LOSS_SCALE"] = "off"
    try:
        mod = make_lm()
        mod.fit(lm_iter(), **dict(fit_t, num_epoch=2))
        check(mod._loss_scaler is None and mod._fused_fit.captures == 1,
              "fit_bf16: MXNET_LOSS_SCALE=off kept a scaler or captured %d"
              % mod._fused_fit.captures)
        off_ms = _graph_replay_ms(torch, mod, replays)
        del mod
    finally:
        del os.environ["MXNET_LOSS_SCALE"]
    on_ms = res["fused"][0]["inspect"]["graph_replay_ms"]
    out["loss_scaler_cost"] = {"graph_replay_ms_scaler": on_ms,
                               "graph_replay_ms_off": off_ms,
                               "select_ms_per_step": on_ms - off_ms}
    del res
    out["resnet_2bit"] = _fit_resnet16(torch, mx, "bfloat16", tol)
    ret["resnet_2bit"] = out["resnet_2bit"]["fused"]
    out["overflow"] = _overflow_case(torch, mx, ctx)
    emit({"phase": "fit_bf16", "config": {"transformer": dict(
        cfg, dtype="bfloat16"), "resnet": dict(RESNET, dtype="bfloat16")},
          "train": FIT_BF16, **out})
    return ret


def _fit_resnet16(torch, mx, dtype, tol, replays=0):
    """ResNet-50 v2 in ``dtype`` through ``Module.fit`` with a 2-bit device
    store as FIT_BF16's resnet says, fused against eager (cuDNN's
    deterministic algorithms in both), checked by ``_bf16_arm_checks``
    (the f32 quantizer recorded once per bucket the eager store
    dispatches a step, no skip) and ``_low_weights`` at ``tol``.  Returns
    the phase line's entry, the fused arm's info under "fused"."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.weights import convert_symbol_params
    ctx = mx.gpu(0)
    rc = FIT_BF16["resnet"]
    B = rc["batch"]
    rcfg = dict(RESNET, dtype=dtype)
    shapes = dict(data=(B,) + tuple(RESNET["image_shape"]),
                  softmax_label=(B,))
    sym = resnet.get_symbol(**rcfg)
    np_args, np_aux = seeded_resnet_params(sym, B, RESNET["image_shape"])
    x, y = _image_batches(RESNET["image_shape"], B * rc["batches"],
                          SEED + 42, RESNET["num_classes"])
    res, kvs = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for fused in (True, False):
            args, auxs = convert_symbol_params(np_args, np_aux, ctx, sym,
                                               **shapes)
            kv = kvs[fused] = mx.kv.create("device")
            res["fused" if fused else "eager"] = _fit_arm(
                torch, mx, lambda: mx.Module(
                    resnet.get_symbol(**rcfg), context=ctx,
                    compression_params={"type": "2bit",
                                        "threshold": rc["threshold"]}),
                mx.io.NDArrayIter(x, y, batch_size=B),
                dict(num_epoch=rc["epochs"], kvstore=kv, optimizer="sgd",
                     optimizer_params={"learning_rate": rc["lr"],
                                       "momentum": rc["momentum"],
                                       "wd": rc["wd"],
                                       "multi_precision": True},
                     arg_params=args, aux_params=auxs, eval_metric="acc"),
                fused, rc["batches"] * rc["epochs"],
                _low_inspect(torch, np_args, replays if fused else 0,
                             getattr(torch, dtype)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    name = "resnet" if dtype == "bfloat16" else "f16 resnet"
    ei = res["eager"][0]
    buckets = kvs[False]._engine.stats["buckets"] \
        / (len(ei["step_ms"]) + FIT_FUSED["profiled_steps"])
    ei["kv_buckets_per_step"] = buckets
    check(buckets == int(buckets) > 0, "fit %s: %g buckets per eager step"
          % (name, buckets))
    _bf16_arm_checks(name, res, {"two_bit_quantize_fused:float32":
                                 int(buckets)}, tol)
    for arm in ("fused", "eager"):
        info = res[arm][0]
        info["images_per_s"] = B / (info["step_ms_p50"] / 1e3)
    atol = FIT_F16["weights_atol"] if dtype == "float16" else None
    return {"fused": res["fused"][0], "eager": ei,
            "weights": _low_weights(name, res["fused"][1], res["eager"][1],
                                    np_args, tol, atol)}


def phase_fit_f16(torch, mx, np_params, bf16_lm=None, cfg=FULL):
    """float16 ``Module.fit`` at full width (ROADMAP A.1, float16
    training): the transformer with ``dtype='float16'`` as FIT_F16 says.
    The fused arm (the main path) captures once, runs every step fused
    with no host sync and one graph launch in a steady step and no plain
    version, records each f16 flash kernel 12 times and the f16
    LayerNorm forward and backward 25 times in its graph; its scaler's
    scale and skips are printed (a skip is the reference's semantics,
    not a failure), at least one update applies and every f16 weight
    matrix's f32 master moves.  The eager arm and the fused arm with
    ``MXNET_LOSS_SCALE=off`` (neither skips) move every master and end
    within FIT_F16's weight bound of each other.  Every arm's weights
    stay finite.  The fused arm's graph is replayed 20 times under CUDA
    events; its replay ms and tokens/s stand beside ``bf16_lm``'s
    (fit_bf16's fused transformer arm, the same run).  Then ResNet-50 v2
    in f16 through a 2-bit device store (``_fit_resnet16``, fit_bf16's
    ResNet arm in f16): one capture, every step fused, one graph launch
    and no host sync in a steady step, the f32 quantizer recorded once
    per bucket, no skip, fused weights within one f16 ulp of eager's,
    its graph replayed 20 times.  Returns the fused arms' info
    ("transformer", "resnet_2bit")."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    ctx = mx.gpu(0)
    hf = torch.float16
    replays = FIT_BF16["replays"]
    tc = FIT_BF16["transformer"]
    Bt, S = tc["batch"], cfg["seq_len"]
    steps = tc["batches"] * tc["epochs"]
    tokens, targets = _token_batches(cfg, Bt * tc["batches"], SEED + 41)
    fit_t = dict(num_epoch=tc["epochs"], optimizer="sgd",
                 optimizer_params={"learning_rate": tc["lr"],
                                   "momentum": tc["momentum"],
                                   "multi_precision": True},
                 eval_metric="perplexity")

    def make_lm():
        mod = mx.Module(transformer.get_symbol(dtype="float16", **cfg),
                        context=ctx)
        mod.bind(data_shapes=[("data", (Bt, S))],
                 label_shapes=[("softmax_label", (Bt * S,))])
        mod.set_params(convert_params(np_params, ctx, cfg), {})
        return mod

    def arm(fused, reps=0):
        it = FlatLabels(mx, mx.io.NDArrayIter(tokens, targets,
                                              batch_size=Bt))
        return _fit_arm(torch, mx, make_lm, it, fit_t, fused, steps,
                        _low_inspect(torch, np_params, reps, hf))

    res = {"fused": arm(True, replays), "eager": arm(False)}
    with env_set("MXNET_LOSS_SCALE", "off"):
        res["fused_off"] = arm(True)
    fi, ei, oi = (res[k][0] for k in ("fused", "eager", "fused_off"))
    # the fused arms' graph checks; the metric only where neither side
    # of the pair skips (the scaler-on arm may skip a step)
    _fused_arm_checks("f16 transformer", {"fused": res["fused"],
                                          "eager": res["eager"]},
                      None, float("inf"))
    _fused_arm_checks("f16 transformer (scaler off)",
                      {"fused": res["fused_off"], "eager": res["eager"]},
                      None, FIT_F16["weights_rtol"])
    captured = (fi["captured_by_dtype"] or [{}])[0]
    for name, n in TRAIN_LAUNCHES.items():
        key = "%s:float16" % name
        check(captured.get(key, 0) == n and fi["launches_by_dtype"].get(
            key, 0) > 0, "fit_f16: %s recorded %d times in the graph (want "
              "%d): %s" % (key, captured.get(key, 0), n, captured))
    ins = fi["inspect"]
    check(oi["inspect"].get("loss_scale") is None
          and ei["inspect"].get("loss_scale") is None
          and ins["loss_scale_gauge"] == ins["loss_scale"],
          "fit_f16: loss scalers %s / %s / %s" % (
              ins, ei["inspect"], oi["inspect"]))
    applied = steps + FIT_FUSED["profiled_steps"] - ins["overflow_skips"]
    check(applied > 0, "fit_f16: the scaler skipped every step: %s" % ins)
    for label, info in (("fused", fi), ("eager", ei), ("fused_off", oi)):
        i = info["inspect"]
        check(i["masters_moved"] == i["low_weight_matrices"] > 0,
              "fit_f16 %s: masters that did not move %s, missing %s"
              % (label, i["masters_still"], i["masters_missing"]))
        check(all(np.isfinite(w).all() for w in res[label][1].values()),
              "fit_f16 %s: non-finite weights" % label)
        info["tokens_per_s"] = Bt * S / (info["step_ms_p50"] / 1e3)
    out = {"fused": fi, "eager": ei, "fused_off": oi,
           "fused_off_vs_eager": _low_weights(
               "f16 transformer", res["fused_off"][1], res["eager"][1],
               np_params, FIT_F16["weights_rtol"], FIT_F16["weights_atol"]),
           "compared_arm": "MXNET_LOSS_SCALE=off: the eager path has no "
                           "scaler, and with the scaler off neither arm "
                           "can skip"}
    if bf16_lm is not None:
        out["beside_bf16"] = {
            "graph_replay_ms": {"float16": ins["graph_replay_ms"],
                                "bfloat16": bf16_lm["inspect"][
                                    "graph_replay_ms"]},
            "tokens_per_s": {"float16": fi["tokens_per_s"],
                             "bfloat16": bf16_lm.get("tokens_per_s")}}
    # ResNet-50 v2 in f16 through a 2-bit device store (float16 for rows
    # 7 and 10): the fused graph replays beside the eager pair
    out["resnet_2bit"] = _fit_resnet16(torch, mx, "float16",
                                       FIT_F16["weights_rtol"], replays)
    emit({"phase": "fit_f16", "config": {
        "transformer": dict(cfg, dtype="float16"),
        "resnet": dict(RESNET, dtype="float16")},
          "train": dict(FIT_BF16["transformer"], resnet=FIT_BF16["resnet"],
                        **FIT_F16), **out})
    return {"transformer": fi, "resnet_2bit": out["resnet_2bit"]["fused"]}


def _fused_arms(name, res, initial, kernel, metric_rtol=1e-5):
    """Checks of one fused arm against its eager twin; the phase line's
    entry for the pair."""
    _fused_arm_checks(name, res, kernel, metric_rtol)
    return {"fused": res["fused"][0], "eager": res["eager"][0],
            "weights": _compare_arms(name, res["fused"][1],
                                     res["eager"][1], initial,
                                     FIT_FUSED["move_l2"])}


def _fused_arm_checks(name, res, kernel, metric_rtol):
    """The fused arm: one capture, every step fused, no host sync and one
    graph launch in a steady step, ``kernel`` recorded in its graph; its
    metric within ``metric_rtol`` of the eager arm's."""
    fi, ei = res["fused"][0], res["eager"][0]
    steps = len(fi["step_ms"])
    check(fi["fused"] and not ei["fused"], "fit_fused %s: fused %s, eager "
          "%s" % (name, fi["fused"], ei["fused"]))
    check(fi["captures"] == 1 and fi["fused_steps"] == steps,
          "fit_fused %s: %d captures, %d of %d steps fused"
          % (name, fi["captures"], fi["fused_steps"], steps))
    steady = fi["host_syncs_per_step"][3:]
    check(not any(steady), "fit_fused %s: host syncs in steady steps %s"
          % (name, steady))
    graphs = fi["runtime_calls_per_step"].get("cudaGraphLaunch")
    check(graphs is None or graphs == 1,
          "fit_fused %s: %s graph launches per steady step" % (name, graphs))
    captured = fi["captured_launches"][0] if fi["captured_launches"] \
        else {}
    if kernel is not None:
        check(captured.get(kernel, 0) > 0 and fi["launches"].get(kernel, 0)
              > 0, "fit_fused %s: %s not in the captured step %s"
              % (name, kernel, captured))
    check(math.isfinite(fi["metric"]) and abs(fi["metric"] - ei["metric"])
          <= metric_rtol * max(1.0, abs(ei["metric"])),
          "fit_fused %s: metric %g fused, %g eager" % (name, fi["metric"],
                                                      ei["metric"]))


# mx.checkpoint through the fused bf16 Module.fit (phase_checkpoint)
CHECKPOINT = dict(
    resnet=dict(batch=128, lr=0.1, momentum=0.9, wd=1e-4, threshold=0.5,
                batches=2, epochs=4, every=2, tag=4),
    transformer=dict(num_layers=2, batch=4, lr=0.05, momentum=0.9,
                     batches=2, epochs=4, every=4, tag=4),
    serve=dict(new=24, lengths=(700, 20, 350, 90, 520, 45, 260, 610)),
    legacy=dict(batch=16))


def _ckpt_fit(torch, mx, mod, it, fit_kw, steps):
    """``mod.fit`` of one checkpoint run: per step the host syncs inside
    ``fit_step``/``update_metric`` and inside the checkpoint tick, the
    tick's ms, and each save the writer commits (its ms and bytes)."""
    import warnings
    from mxnet_tpu_torch.checkpoint import writer as ckw
    step_syncs, tick_syncs, tick_ms, saves = [], [], [], []
    write = ckw.write_with_retry

    def timed_write(state, prefix, tag, **kw):
        t0 = time.perf_counter()
        man = write(state, prefix, tag, **kw)
        saves.append({"tag": int(tag), "bytes": int(man["total_bytes"]),
                      "save_ms": (time.perf_counter() - t0) * 1e3})
        return man

    def counted(fn, into):
        def run(*args, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    into[-1] += sum("synchroniz" in str(w.message)
                                    for w in caught)
        return run

    make = mod._make_checkpointer

    def make_watched(*args):
        mgr = make(*args)
        if mgr is not None:
            tick = counted(mgr.tick, tick_syncs)

            def timed_tick(epoch=None):
                t0 = time.perf_counter()
                tick_syncs.append(0)
                out = tick(epoch=epoch)
                tick_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            mgr.tick = timed_tick
        return mgr

    def begin_step(fn):
        def run(*args, **kw):
            step_syncs.append(0)
            return fn(*args, **kw)
        return run

    mod._make_checkpointer = make_watched
    mod.fit_step = begin_step(counted(mod.fit_step, step_syncs))
    mod.update_metric = counted(mod.update_metric, step_syncs)
    ckw.write_with_retry = timed_write
    try:
        mod.fit(it, **fit_kw)
    finally:
        ckw.write_with_retry = write
        del mod._make_checkpointer, mod.fit_step, mod.update_metric
    torch.cuda.synchronize()
    check(len(step_syncs) == steps, "checkpoint: %d steps ran, not %d"
          % (len(step_syncs), steps))
    return {"step_syncs": step_syncs, "tick_syncs": tick_syncs,
            "tick_ms": tick_ms, "saves": sorted(saves,
                                                key=lambda s: s["tag"])}


def _ckpt_state_equal(torch, name, a, b):
    """Two ``checkpoint.capture`` states equal bit for bit: parameters,
    auxiliary states, optimizer states (f32 masters and momenta),
    residuals and the loss scaler."""
    def leaves(x):
        if isinstance(x, tuple):
            return [y for v in x for y in leaves(v)]
        return [] if x is None else [x]
    pairs = [("%s:%s" % (part, k), a[part][k], b[part][k])
             for part in ("args", "auxs") for k in a[part]]
    for k, st in a["states"].items():
        pairs += [("state:%s" % k, x, y)
                  for x, y in zip(leaves(st), leaves(b["states"][k]))]
    res_a, res_b = (s["extra"].get("residuals", {}) for s in (a, b))
    check(sorted(res_a) == sorted(res_b), "checkpoint %s: residual keys "
          "differ" % name)
    pairs += [("residual:%s" % (k,), res_a[k], res_b[k]) for k in res_a]
    bad = [k for k, x, y in pairs if not torch.equal(x, y)]
    check(not bad, "checkpoint %s: run B differs from run A in %s"
          % (name, bad[:8]))
    check(a["extra"].get("loss_scaler") == b["extra"].get("loss_scaler"),
          "checkpoint %s: loss scaler %s vs %s"
          % (name, a["extra"].get("loss_scaler"),
             b["extra"].get("loss_scaler")))
    masters = sum(1 for st in a["states"].values()
                  if isinstance(st, tuple) and len(st) == 2
                  and st[1].dtype == torch.float32)
    return {"tensors_equal": len(pairs), "f32_masters": masters,
            "residuals": len(res_a),
            "loss_scaler": a["extra"].get("loss_scaler")}


def _ckpt_resume(torch, mx, name, make, batches, fit_kw, tc, prefix,
                 want_captured):
    """Runs A (with ``checkpoint_every``) and B (restored from tag
    ``tc['tag']``) of one model: the checks and figures of phase 37."""
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.checkpoint import writer as ckw
    steps = tc["batches"] * tc["epochs"]
    every, tag = tc["every"], tc["tag"]
    restore_ms = checkpoint.snapshot.RESTORE_MS
    out = {}
    mods = {}
    for run in ("A", "B"):
        mod, kv = make()
        if run == "A":
            blocks0 = (ckw.BLOCK_MS.count, ckw.BLOCK_MS.sum)
            info = _ckpt_fit(torch, mx, mod, batches(), dict(
                fit_kw, kvstore=kv, num_epoch=tc["epochs"],
                checkpoint_every=every, checkpoint_prefix=prefix), steps)
            info["block_ms_histogram_mean"] = \
                (ckw.BLOCK_MS.sum - blocks0[1]) \
                / max(ckw.BLOCK_MS.count - blocks0[0], 1)
            want_tags = list(range(every, steps + 1, every))
            check([s["tag"] for s in info["saves"]] == want_tags,
                  "checkpoint %s: saves %s, not tags %s" % (
                      name, [s["tag"] for s in info["saves"]], want_tags))
        else:
            torch.cuda.synchronize()
            r0 = (restore_ms.count, restore_ms.sum)
            t0 = time.perf_counter()
            man = checkpoint.restore(mod, prefix, tag=tag)
            torch.cuda.synchronize()
            out["restore_ms"] = (time.perf_counter() - t0) * 1e3
            check(restore_ms.count == r0[0] + 1 and man["step"] == tag,
                  "checkpoint %s: restore of tag %d gave step %s"
                  % (name, tag, man["step"]))
            out["restore_ms_histogram"] = restore_ms.sum - r0[1]
            info = _ckpt_fit(torch, mx, mod, batches(), dict(
                fit_kw, kvstore=kv, num_epoch=tc["epochs"],
                begin_epoch=tag // tc["batches"]), steps - tag)
        ff = mod._fused_fit
        check(ff is not None and ff.captures == 1,
              "checkpoint %s run %s: %s captures" % (
                  name, run, None if ff is None else ff.captures))
        captured = (ff.captured_launches(True) or [{}])[0]
        missing = [k for k in want_captured if captured.get(k, 0) < 1]
        check(not missing, "checkpoint %s run %s: the graph records no %s"
              % (name, run, missing))
        info["captured_by_dtype"] = captured
        # steady steps (after the two warm-ups and the capture): the
        # host syncs only in a checkpointing tick
        first = (tag if run == "B" else 0) + 4
        for i, n in enumerate(info["step_syncs"]):
            step = (tag if run == "B" else 0) + i + 1
            check(step < first or n == 0, "checkpoint %s run %s: step %d "
                  "synced the host %d times" % (name, run, step, n))
        for i, n in enumerate(info["tick_syncs"]):
            step = i + 1
            check((n > 0) == (step % every == 0),
                  "checkpoint %s: the tick of step %d synced %d times"
                  % (name, step, n))
        out[run] = info
        mods[run] = mod
    states = {}
    for run, mod in mods.items():
        states[run] = checkpoint.capture(mod)
    out["equal"] = _ckpt_state_equal(torch, name, states["A"], states["B"])
    del states
    # the snapshot's wait: a capture into pinned and into pageable host
    # memory of run A's state, each timed twice
    for pinned in (True, False, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = checkpoint.capture(mods["A"], pinned=pinned)
        ms = (time.perf_counter() - t0) * 1e3
        out.setdefault("capture_ms_%s" % ("pinned" if pinned
                                          else "pageable"), []).append(ms)
        del st
    saves = out["A"]["saves"]
    for s in saves:
        s["mb_per_s"] = s["bytes"] / 1e6 / (s["save_ms"] / 1e3)
    blocks = [ms for i, ms in enumerate(out["A"]["tick_ms"])
              if (i + 1) % every == 0]
    out["summary"] = {
        "bytes_per_tag": saves[-1]["bytes"],
        "block_ms": blocks, "block_ms_max": max(blocks),
        "save_ms": [s["save_ms"] for s in saves],
        "mb_per_s": [s["mb_per_s"] for s in saves],
        "restore_ms": out["restore_ms"],
        "capture_pinned_ms": out["capture_ms_pinned"],
        "capture_pageable_ms": out["capture_ms_pageable"]}
    del mods
    return out


def _ckpt_serve(torch, mx, prefix, np_params, cfg):
    """``DecodeEngine(dtype='bfloat16').reload(prefix)`` serves 8
    requests (a second reload of the same tag while they run) with
    streams equal to an engine given the same weights by
    ``swap_params``; the paged kernels and LayerNorm launch."""
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.decode import DecodeEngine
    from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
    from mxnet_tpu_torch.weights import convert_params
    sc = CHECKPOINT["serve"]
    ctx = mx.gpu(0)
    prompts = _serve_prompts(cfg, SEED + 7, sc["lengths"])
    tag = checkpoint.latest(prefix)["tag"]
    arg_params, _, version = checkpoint.resolve_params(prefix)
    streams, info = {}, {}
    for arm in ("reload", "swap"):
        eng = DecodeEngine(convert_params(np_params, ctx, cfg), cfg, ctx=ctx,
                           **GEOMETRY)
        try:
            if arm == "reload":
                t0 = time.perf_counter()
                check(eng.reload(prefix) == tag, "checkpoint serve: reload "
                      "gave another version")
                info["reload_ms"] = (time.perf_counter() - t0) * 1e3
                reset_counts()
            else:
                eng.swap_params(arg_params, version=version)
            handles = [eng.submit(p, max_new_tokens=sc["new"])
                       for p in prompts]
            if arm == "reload":
                # a reload while the engine is serving keeps it serving
                t0 = time.perf_counter()
                eng.reload(prefix, tag=tag)
                info["reload_while_serving_ms"] = \
                    (time.perf_counter() - t0) * 1e3
            streams[arm] = [h.result(timeout=900) for h in handles]
            st = eng.stats()
            if arm == "reload":
                torch.cuda.synchronize()
                info["launches"] = {k: v for k, v in LAUNCHES.items() if v}
                info["plain_calls"] = {k: v for k, v in PLAIN_CALLS.items()
                                       if v}
                info["steps"] = st["steps"]
                check(st["model_version"] == tag, "checkpoint serve: "
                      "model_version %s" % st["model_version"])
        finally:
            eng.stop()
    check(all(len(s) == sc["new"] for s in streams["reload"]),
          "checkpoint serve: a request finished early")
    check(streams["reload"] == streams["swap"], "checkpoint serve: reload "
          "and swap_params streams differ")
    for k in ("paged_decode_attend", "paged_chunk_prefill_attend",
              "layernorm_fused"):
        check(info["launches"].get(k, 0) > 0, "checkpoint serve: %s not "
              "launched" % k)
    check(not info["plain_calls"], "checkpoint serve: plain versions ran: "
          "%s" % info["plain_calls"])
    info["requests"] = len(prompts)
    return info


def _ckpt_legacy(torch, mx, tmp):
    """An f32 ResNet-50's ``model.save_checkpoint``, then ``Module.load``
    on the card: the inference forward is bit-equal."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.weights import convert_symbol_params
    B = CHECKPOINT["legacy"]["batch"]
    image = RESNET["image_shape"]
    ctx = mx.gpu(0)
    sym = resnet.get_symbol(**RESNET)
    np_args, np_aux = seeded_resnet_params(sym, B, image)
    x, _ = _image_batches(image, B, SEED + 44, RESNET["num_classes"])
    batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx)])
    outs = []
    prefix = os.path.join(tmp, "legacy")
    for load in (False, True):
        if load:
            mod = mx.Module.load(prefix, 1, context=ctx)
        else:
            mod = mx.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", (B,) + tuple(image))],
                 for_training=False)
        if not load:
            args, auxs = convert_symbol_params(
                np_args, np_aux, ctx, sym, data=(B,) + tuple(image),
                softmax_label=(B,))
            mod.set_params(args, auxs, allow_extra=True)
            arg_params, aux_params = mod.get_params()
            mx.model.save_checkpoint(prefix, 1, sym, arg_params, aux_params)
        mod.forward(batch, is_train=False)
        outs.append(mod.get_outputs()[0]._data.clone())
        del mod
    check(torch.equal(outs[0], outs[1]), "checkpoint legacy: Module.load's "
          "forward differs from the saved module's")
    return {"batch": B, "bit_equal": True,
            "params_bytes": os.path.getsize(prefix + "-0001.params")}


def _share_ok(keep, p, sigmas):
    """(keep share, whether it lies within ``sigmas`` binomial standard
    deviations of 1 - p)."""
    n = keep.numel()
    share = float(keep.double().mean())
    return share, abs(share - (1 - p)) <= sigmas * (p * (1 - p) / n) ** 0.5


def phase_dropout(torch, mx, mxk, dev, flush):
    """Dropout's draw and apply on the card (DROPOUT), a captured graph
    of the op replayed with two staged seeds, and the training kernels
    at the shapes fit_lm_dropout gives them that no earlier phase checks
    (bf16 flash at batch 8, bf16 LayerNorm forward and backward at 8192
    rows), each against its plain version."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.cuda_graph import WARMUP, Program
    from mxnet_tpu_torch.ops.nn import (dropout, dropout_apply, dropout_mask,
                                        dropout_scale)
    shape, p, sigmas = DROPOUT["shape"], DROPOUT["p"], DROPOUT["sigmas"]
    bf = torch.bfloat16
    out = {}
    seed = torch.tensor(SEED, dtype=torch.int64)
    keep = mxrandom.keep_mask(seed.to(dev), 3, shape, 1 - p, dev)
    keep_cpu = mxrandom.keep_mask(seed, 3, shape, 1 - p, "cpu")
    check(torch.equal(keep.cpu(), keep_cpu),
          "dropout: the card's draw differs from the CPU's from one seed")
    share, ok = _share_ok(keep, p, sigmas)
    check(ok, "dropout: keep share %g for p %g" % (share, p))
    g = torch.Generator(device="cpu").manual_seed(SEED + 50)
    x = torch.randn(*shape, generator=g).to(dev).to(bf)
    rng = mxrandom.StepRandom(seed.to(dev))
    mask = dropout_mask(x, p, rng=rng)
    scale = dropout_scale(p, bf)
    values = sorted(torch.unique(mask.float()).tolist())
    check(values == [0.0, scale], "dropout: mask values %s, want 0 and %r"
          % (values, scale))
    y = dropout_apply(x, mask)
    y_cpu = dropout_apply(x.cpu(), mask.cpu())
    check(torch.equal(y.cpu().view(torch.int16), y_cpu.view(torch.int16)),
          "dropout: the card's apply differs from the plain version's")
    axes_mask = dropout_mask(x, p, axes=(1,))
    check(tuple(axes_mask.shape) == (shape[0], 1, shape[2])
          and torch.equal(dropout_apply(x, axes_mask) == 0,
                          (axes_mask == 0).expand(shape)),
          "dropout: the axes mask does not broadcast")
    out["keep_share"] = share
    out["scale"] = scale
    # a captured graph of the op: each replay reads the seed staged
    # before it
    staged = torch.zeros((), dtype=torch.int64, device=dev)

    def body():
        return list(dropout(x, p=p, is_train=True,
                            rng=mxrandom.StepRandom(staged)))

    prog = Program(body, dev, "dropout graph", "")
    for _ in range(WARMUP):
        prog.warm_up()
    prog.capture()
    seeds, masks = [], []
    for _ in range(2):
        mxrandom.next_seed(dev, out=staged)
        seeds.append(int(staged.item()))
        masks.append(prog.replay()[1].clone())
    check(seeds[0] != seeds[1] and not torch.equal(masks[0], masks[1]),
          "dropout: two replays drew one mask (seeds %s)" % seeds)
    for s_, m in zip(seeds, masks):
        want = dropout_mask(x, p, rng=mxrandom.StepRandom(torch.tensor(
            s_, dtype=torch.int64, device=dev)))
        check(torch.equal(m, want.expand(shape)),
              "dropout: a replay's mask is not its seed's draw")
        check(_share_ok(m != 0, p, sigmas)[1],
              "dropout: a replay's keep share is out of bounds")
    out["replay_seeds"] = seeds
    del prog, masks
    n = x.numel()
    out["draw_ms"] = time_ms(torch, lambda: dropout_mask(x, p, rng=rng),
                             flush)
    out["apply_ms"] = time_ms(torch, lambda: dropout_apply(x, mask), flush)
    # what one site's draw must write (the bf16 mask) and its apply move
    # (x and the mask read, the output written), over 3.35 TB/s
    out["draw_bound_ms"] = bound(2 * n, 0)[0]
    out["apply_bound_ms"] = bound(6 * n, 0)[0]
    del x, y, mask, axes_mask, keep
    # the kernels at fit_lm_dropout's new shapes
    errs = {}
    B, H, S, D = 8, 16, 1024, 128
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(dev).to(bf)
                   for _ in range(4))
    for what, a, b in _flash_pairs(torch, mxk, q, k, v, do, 1.0 / D ** 0.5):
        okf = close(torch, a, b) if what == "lse" else close_bf16(torch, a, b)
        check(okf, "flash attention bf16 %s at (8, 16, 1024, 128) disagrees "
              "with its plain version (max abs err %g)"
              % (what, max_err(a, b)))
        errs["flash " + what] = max_err(a, b)
    del q, k, v, do
    rows, cols = 8192, 2048
    xs, res = (torch.randn(rows, cols, generator=g).to(dev).to(bf)
               for _ in range(2))
    gamma = (1 + 0.02 * torch.randn(cols, generator=g)).to(dev).to(bf)
    beta = (0.02 * torch.randn(cols, generator=g)).to(dev).to(bf)
    _ln_fwd_hold(torch, mxk, xs, gamma, beta, res, "bf16 8192 x 2048", errs)
    del xs, res
    _ln_bwd_hold(torch, mxk, dev, g, rows, cols, bf, errs)
    out["kernel_errors"] = errs
    emit({"phase": "dropout", "config": DROPOUT, **out,
          "tolerance": "draw and apply bit for bit card against CPU; keep "
                       "share within %g sigma; kernels as their phases"
                       % sigmas})
    return out


class ListBatches:
    """Batches of several sizes from a list of (tokens, targets) numpy
    pairs, the targets flattened to the (B * S,) labels of the LM's
    softmax; describes the first batch's shapes."""

    def __init__(self, mx, batches):
        self.mx, self.batches, self.i = mx, batches, 0

    @property
    def provide_data(self):
        return [self.mx.io.DataDesc("data", self.batches[0][0].shape)]

    @property
    def provide_label(self):
        return [self.mx.io.DataDesc("softmax_label",
                                    (self.batches[0][1].size,))]

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == len(self.batches):
            raise StopIteration
        x, y = self.batches[self.i]
        self.i += 1
        gpu = self.mx.gpu(0)
        return self.mx.io.DataBatch(
            data=[self.mx.nd.array(x, ctx=gpu)],
            label=[self.mx.nd.array(y.reshape(-1), ctx=gpu)], pad=0)

    def reset(self):
        self.i = 0


def phase_fit_lm_dropout(torch, mx, np_params, cfg=FULL):
    """The LM trained as its users train it (FIT_DROPOUT; phase 51).
    Returns the run's launches and each graph's recorded launches, by
    ``name:dtype``."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.kernels import (LAUNCHES_BY_DTYPE, PLAIN_CALLS,
                                         reset_counts)
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    fd = FIT_DROPOUT
    ctx = mx.gpu(0)
    S = cfg["seq_len"]
    pattern = fd["pattern"]
    batches = []
    for i, b in enumerate(pattern):
        x, y = _token_batches(cfg, b, SEED + 60 + i)
        batches.append((x, y))
    mx.random.seed(SEED)
    mod = mx.Module(transformer.get_symbol(dtype="bfloat16",
                                           dropout=fd["dropout"], **cfg),
                    context=ctx)
    mod.bind(data_shapes=[("data", (pattern[0], S))],
             label_shapes=[("softmax_label", (pattern[0] * S,))])
    mod.set_params(convert_params(np_params, ctx, cfg), {})
    sched = mx.lr_scheduler.WarmupScheduler(
        mx.lr_scheduler.CosineScheduler(max_update=len(pattern),
                                        base_lr=fd["lr"]), fd["warmup"])
    metric = mx.metric.create(["perplexity", mx.metric.TopKAccuracy(5)])
    stamps = []

    def per_step(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stamps.append(time.perf_counter())
    mod.fit(ListBatches(mx, batches), num_epoch=1, optimizer="lamb",
            optimizer_params={"learning_rate": fd["lr"], "wd": fd["wd"],
                              "bias_correction": True,
                              "multi_precision": True,
                              "lr_scheduler": sched},
            eval_metric=metric,
            batch_end_callback=[per_step, mx.callback.log_train_metric(1)])
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES_BY_DTYPE.items() if v}
    plain = {k: v for k, v in PLAIN_CALLS.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    fused = mod._fused_fit
    check(fused is not None and fused.launches == len(pattern),
          "fit_lm_dropout: %s of %d steps ran fused"
          % (None if fused is None else fused.launches, len(pattern)))
    check(fused.captures == 2 and len(fused._programs) == 2,
          "fit_lm_dropout: %d captures, %d programs (one per batch shape "
          "wanted, none on the shape's return)"
          % (fused.captures, len(fused._programs)))
    check(not plain, "fit_lm_dropout: plain versions ran: %s" % plain)
    captured = fused.captured_launches(True)
    want = {"%s:bfloat16" % k: n for k, n in TRAIN_LAUNCHES.items()}
    for name in want:
        check(launches.get(name, 0) > 0, "fit_lm_dropout: %s was not "
              "launched" % name)
        for rec in captured:
            check(rec.get(name, 0) == want[name], "fit_lm_dropout: a graph "
                  "records %s %d times, want %d"
                  % (name, rec.get(name, 0), want[name]))
    exe = mod._exec_group._exec
    finite = all(bool(torch.isfinite(exe.arg_dict[n]._data).all())
                 for n in mod._param_names)
    check(finite, "fit_lm_dropout: a weight is not finite")
    values = dict(metric.get_name_value())
    check(all(math.isfinite(v) for v in values.values()),
          "fit_lm_dropout: metrics %s" % values)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    # the steady batch-8 steps: the first graph's replays before and
    # after the batch of 4 (its warm-up steps and capture left out)
    first = 1 + 2
    steady = step_ms[first:pattern.index(4)] \
        + step_ms[len(pattern) - pattern[::-1].index(4):]
    p50 = statistics.median(steady)
    # two more replays of the batch-8 graph: their staged seeds differ,
    # and so do the embedding's masks drawn from them (site 0)
    x8, y8 = batches[0]
    batch = mx.io.DataBatch(data=[mx.nd.array(x8, ctx=ctx)],
                            label=[mx.nd.array(y8.reshape(-1), ctx=ctx)])
    seeds, shares = [], []
    keep = 1 - fd["dropout"]
    masks = []
    for _ in range(2):
        mod.fit_step(batch, metric)
        seeds.append(int(fused._seed.item()))
        m = mxrandom.keep_mask(fused._seed, 0, (pattern[0], S,
                                                cfg["d_model"]), keep, ctx
                               .torch_device)
        shares.append(_share_ok(m, fd["dropout"], DROPOUT["sigmas"]))
        masks.append(m)
    check(fused.captures == 2, "fit_lm_dropout: a replay captured again")
    check(seeds[0] != seeds[1] and not torch.equal(masks[0], masks[1]),
          "fit_lm_dropout: two replays staged one seed %s" % seeds)
    check(all(ok for _, ok in shares), "fit_lm_dropout: keep shares %s"
          % shares)
    del masks
    graph8 = [p.graph for k, p in fused._programs.items()
              if p.feeds["data"].shape[0] == pattern[0]][0]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(fd["replays"]):
        graph8.replay()
    end.record()
    end.synchronize()
    scaler = mod._loss_scaler
    if scaler is not None:
        scaler.publish()
    skips = scaler.skips if scaler is not None else 0
    result = {"steps": len(pattern), "step_ms": step_ms,
              "step_ms_p50": p50,
              "tokens_per_s": pattern[0] * S / (p50 / 1e3),
              "graph_replay_ms": start.elapsed_time(end) / fd["replays"],
              "peak_mem_gb": peak, "captures": fused.captures,
              "metrics": values, "launches": launches,
              "captured_per_graph": captured, "replay_seeds": seeds,
              "keep_shares": [sh for sh, _ in shares],
              "loss_scale_skips": skips}
    del mod, exe, graph8
    gc_collect(torch)
    result["trainstep"] = _trainstep_dropout(torch, mx, np_params, cfg)
    emit({"phase": "fit_lm_dropout", "config": dict(
        cfg, dtype="bfloat16", dropout=fd["dropout"]), "train": fd,
        **result})
    return result


def _trainstep_dropout(torch, mx, np_params, cfg):
    """TrainStep over the LM cut to FIT_DROPOUT's trainstep depth, bf16
    with dropout, Nadam with multi_precision (its fused kind): finite
    outputs every step, the kernels launched, no plain version; step
    p50 and launches per step."""
    from mxnet_tpu_torch.kernels import (LAUNCHES_BY_DTYPE, PLAIN_CALLS,
                                         reset_counts)
    from mxnet_tpu_torch.models import transformer
    tc = FIT_DROPOUT["trainstep"]
    c = dict(cfg, num_layers=tc["num_layers"])
    B, S = tc["batch"], c["seq_len"]
    ctx = mx.gpu(0)
    opt = mx.optimizer.create("nadam", learning_rate=tc["lr"], wd=tc["wd"],
                              multi_precision=True, rescale_grad=1.0 / B)
    ts = mx.parallel.TrainStep(
        transformer.get_symbol(dtype="bfloat16",
                               dropout=FIT_DROPOUT["dropout"], **c), opt,
        data_shapes={"data": (B, S)},
        label_shapes={"softmax_label": (B * S,)}, ctx=ctx)
    ts.init_params(mx.init.Xavier(), arg_params={
        k: v for k, v in np_params.items() if k in ts.params})
    check(ts._kind is not None and ts._kind[0] == "nadam",
          "trainstep: Nadam did not take its fused kind")
    x, y = _token_batches(c, B, SEED + 70)
    batch = {"data": x, "softmax_label": y.reshape(-1)}
    reset_counts()
    stamps = [time.perf_counter()]
    for _ in range(tc["steps"]):
        outs = ts.step(batch)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        check(bool(torch.isfinite(outs[0]).all()),
              "trainstep: a step's output is not finite")
    launches = {k: v for k, v in LAUNCHES_BY_DTYPE.items() if v}
    plain = {k: v for k, v in PLAIN_CALLS.items() if v}
    check(not plain, "trainstep: plain versions ran: %s" % plain)
    for name in TRAIN_LAUNCHES:
        check(launches.get(name + ":bfloat16", 0) > 0,
              "trainstep: %s was not launched in bf16" % name)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    del ts
    gc_collect(torch)
    return {"config": dict(c, dtype="bfloat16"), "optimizer": "nadam",
            "step_ms": step_ms, "step_ms_p50": statistics.median(
                step_ms[1:]),
            "launches_per_step": {k: v / tc["steps"]
                                  for k, v in launches.items()}}


def _kind_graph(torch, mx, kind):
    """One kind's ``bulk_apply`` captured as a CUDA graph over static
    weights, states, gradients and runtime scalars (lr, wd, extras
    staged before each replay), against the optimizer's eager updates of
    the same numpy weights and gradients (FUSED_KINDS's bulk_shapes and
    bulk_steps; Adamax without weight decay, so no element's first
    gradient is 0).  Returns the weights' and states' difference over
    the eager move (relative L2)."""
    from mxnet_tpu_torch import fused_update
    from mxnet_tpu_torch.cuda_graph import WARMUP, Program
    fk = FUSED_KINDS
    ctx = mx.gpu(0)
    dev = ctx.torch_device
    rng = np.random.RandomState(SEED + 90)
    shapes = fk["bulk_shapes"]
    names = ["p%d_weight" % i for i in range(len(shapes))]
    w0 = [(rng.standard_normal(sh) * 0.02).astype(np.float32)
          for sh in shapes]
    grads = [[rng.standard_normal(sh).astype(np.float32) for sh in shapes]
             for _ in range(fk["bulk_steps"])]
    kw = dict(learning_rate=fk["lr"], wd=0.0 if kind == "adamax" else
              fk["wd"], rescale_grad=0.5,
              param_idx2name=dict(enumerate(names)))
    eager_opt, graph_opt = (mx.optimizer.create(kind, **kw)
                            for _ in range(2))
    upd = mx.optimizer.get_updater(eager_opt)
    ew = [mx.nd.array(w.copy(), ctx=ctx) for w in w0]
    for g in grads:
        for i, gi in enumerate(g):
            upd(i, mx.nd.array(gi, ctx=ctx), ew[i])
    n = len(shapes)
    sig = graph_opt._fused_sig()
    k = fused_update.build(sig).n_extra
    weights = [torch.tensor(w, device=dev) for w in w0]
    gbuf = [torch.empty(sh, device=dev) for sh in shapes]
    leaves, tpls = [], []
    for i, w in enumerate(weights):
        lv, tpl = fused_update.flatten_state(
            graph_opt.create_state(i, mx.nd.NDArray(w)))
        leaves.append([x._data for x in lv])
        tpls.append(tpl)
    scalars = torch.zeros((2 + k) * n, device=dev)
    use_wd = tuple(bool(kw["wd"]) for _ in range(n))
    apply = fused_update.bulk_apply(sig)

    def body():
        new_w, new_s = apply(
            weights, gbuf, [fused_update.unflatten(t, lv)
                            for t, lv in zip(tpls, leaves)],
            {"lr": scalars[:n], "wd": scalars[n:2 * n],
             "extra": scalars[2 * n:].view(n, k) if k else None,
             "rescale": 0.5, "use_wd": use_wd})
        with torch.no_grad():
            for w, nw in zip(weights, new_w):
                w.copy_(nw)
            for lv, ns in zip(leaves, new_s):
                for x, v in zip(lv, fused_update.flatten_state(ns)[0]):
                    x.copy_(v)
        return weights

    # warm-up runs and the capture's replay update the tensors: their
    # values are put back before the first counted step
    saved = [t.clone() for t in weights + sum(leaves, [])]
    prog = Program(body, dev, "fused kind %s" % kind, "")
    for _ in range(WARMUP):
        prog.warm_up()
    prog.capture()
    with torch.no_grad():
        for t, v in zip(weights + sum(leaves, []), saved):
            t.copy_(v)
    keys = list(range(n))
    for g in grads:
        lr, wd, extra = graph_opt._fused_runtime(keys)
        host = np.concatenate([lr, wd, extra.reshape(-1)]).astype(np.float32)
        scalars.copy_(torch.from_numpy(host))
        for buf, gi in zip(gbuf, g):
            buf.copy_(torch.from_numpy(gi))
        prog.replay()
    torch.cuda.synchronize()
    diff = sum(float((w - e._data).double().square().sum())
               for w, e in zip(weights, ew))
    move = sum(float((e._data.cpu().double() - torch.from_numpy(w).double())
                     .square().sum()) for e, w in zip(ew, w0))
    sdiff = sum(float((x - y._data).double().square().sum())
                for lv, i in zip(leaves, keys)
                for x, y in zip(lv, fused_update.flatten_state(
                    upd.states[i])[0]))
    snorm = sum(float(y._data.double().square().sum()) for i in keys
                for y in fused_update.flatten_state(upd.states[i])[0])
    rel, srel = (diff / move) ** 0.5, (sdiff / snorm) ** 0.5
    check(move > 0 and rel <= fk["move_l2"] and srel <= fk["move_l2"],
          "fused_kinds %s: the graph's update differs from the eager one by "
          "%g of the move (states %g)" % (kind, rel, srel))
    del prog
    return {"graph_move_rel_l2": rel, "graph_states_rel_l2": srel}


def phase_fused_kinds(torch, mx, np_params, cfg=FULL):
    """LBSGD, Adamax, Nadam and LAMB (FUSED_KINDS): each kind's update
    as a captured graph against the eager updates (``_kind_graph``);
    then the fit_kinds through ``Module.fit``, the fused step (one
    capture, every step fused) against the eager pair from the same
    seeds, weights within move_l2 of the eager arm's move; each arm's
    step p50."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    fk = FUSED_KINDS
    c = dict(cfg, num_layers=fk["num_layers"])
    ctx = mx.gpu(0)
    B, S = fk["batch"], c["seq_len"]
    tokens, targets = _token_batches(c, B * fk["steps"], SEED + 80)
    out = {kind: _kind_graph(torch, mx, kind) for kind in fk["kinds"]}
    for kind in fk["fit_kinds"]:
        arms = {}
        for fused in (True, False):
            mx.random.seed(SEED)
            with contextlib.ExitStack() as stack:
                if not fused:
                    stack.enter_context(fit_fused_off())
                mod = mx.Module(transformer.get_symbol(
                    dropout=FIT_DROPOUT["dropout"], **c), context=ctx)
            mod.bind(data_shapes=[("data", (B, S))],
                     label_shapes=[("softmax_label", (B * S,))])
            mod.set_params(convert_params(np_params, ctx, c), {})
            stamps = []

            def per_step(param):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            stamps.append(time.perf_counter())
            opt = mx.optimizer.create(kind, learning_rate=fk["lr"],
                                      wd=fk["wd"], rescale_grad=1.0 / B)
            mod.fit(FlatLabels(mx, mx.io.NDArrayIter(tokens, targets,
                                                     batch_size=B)),
                    num_epoch=1, optimizer=opt, eval_metric="perplexity",
                    batch_end_callback=per_step)
            ff = mod._fused_fit
            if fused:
                check(ff is not None and ff.captures == 1
                      and ff.launches == fk["steps"],
                      "fused_kinds %s: not every step ran in one captured "
                      "graph" % kind)
            else:
                check(ff is None, "fused_kinds %s: the eager arm fused"
                      % kind)
            step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
            arms[fused] = ({k: v.asnumpy() for k, v in
                            mod.get_params()[0].items()},
                           statistics.median(step_ms[3:]))
            del mod, ff
            gc_collect(torch)
        cmp = _compare_arms("fused_kinds " + kind, arms[True][0],
                            arms[False][0], np_params, fk["move_l2"])
        out[kind].update(cmp, fused_step_ms_p50=arms[True][1],
                         eager_step_ms_p50=arms[False][1])
    emit({"phase": "fused_kinds", "config": c, "train": fk, **out})
    return out


def phase_checkpoint(torch, mx, card=None):
    """Phase 37: mx.checkpoint on the card (see the module docstring);
    ``card`` is phase_device's name and power limit, printed beside the
    figures.  Returns the phase's record."""
    import shutil
    import tempfile
    from mxnet_tpu_torch.models import resnet, transformer
    from mxnet_tpu_torch.weights import convert_params, convert_symbol_params
    ctx = mx.gpu(0)
    tmp = tempfile.mkdtemp(prefix="mx_ckpt_")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        rc = CHECKPOINT["resnet"]
        B = rc["batch"]
        rcfg = dict(RESNET, dtype="bfloat16")
        sym = resnet.get_symbol(**rcfg)
        shapes = dict(data=(B,) + tuple(RESNET["image_shape"]),
                      softmax_label=(B,))
        np_args, np_aux = seeded_resnet_params(sym, B,
                                               RESNET["image_shape"])
        x, y = _image_batches(RESNET["image_shape"], B * rc["batches"],
                              SEED + 45, RESNET["num_classes"])
        opt_params = {"learning_rate": rc["lr"], "momentum": rc["momentum"],
                      "wd": rc["wd"], "multi_precision": True}

        def make_resnet():
            mod = mx.Module(resnet.get_symbol(**rcfg), context=ctx,
                            compression_params={"type": "2bit",
                                                "threshold": rc["threshold"]})
            kv = mx.kv.create("device")
            args, auxs = convert_symbol_params(np_args, np_aux, ctx, sym,
                                               **shapes)
            mod.bind(data_shapes=[("data", shapes["data"])],
                     label_shapes=[("softmax_label", (B,))])
            mod.init_params(arg_params=args, aux_params=auxs)
            mod.init_optimizer(kvstore=kv, optimizer="sgd",
                               optimizer_params=opt_params)
            return mod, kv

        out["resnet_2bit_bf16"] = _ckpt_resume(
            torch, mx, "resnet", make_resnet,
            lambda: mx.io.NDArrayIter(x, y, batch_size=B),
            dict(optimizer="sgd", optimizer_params=opt_params,
                 eval_metric="acc"), rc, os.path.join(tmp, "resnet"),
            ["two_bit_quantize_fused:float32"])
        del x, y, np_args, np_aux

        tc = CHECKPOINT["transformer"]
        cfg = dict(FULL, num_layers=tc["num_layers"])
        np_params = seeded_params(cfg)
        Bt, S = tc["batch"], cfg["seq_len"]
        tokens, targets = _token_batches(cfg, Bt * tc["batches"], SEED + 46)
        lm_params = {"learning_rate": tc["lr"], "momentum": tc["momentum"],
                     "multi_precision": True}

        def make_lm():
            mod = mx.Module(transformer.get_symbol(dtype="bfloat16", **cfg),
                            context=ctx)
            mod.bind(data_shapes=[("data", (Bt, S))],
                     label_shapes=[("softmax_label", (Bt * S,))])
            mod.init_params(arg_params=convert_params(np_params, ctx, cfg),
                            aux_params={})
            mod.init_optimizer(kvstore=None, optimizer="sgd",
                               optimizer_params=lm_params)
            return mod, None

        lm_prefix = os.path.join(tmp, "lm")
        out["transformer_bf16"] = _ckpt_resume(
            torch, mx, "transformer", make_lm,
            lambda: FlatLabels(mx, mx.io.NDArrayIter(tokens, targets,
                                                     batch_size=Bt)),
            dict(optimizer="sgd", optimizer_params=lm_params,
                 eval_metric="perplexity"), tc, lm_prefix,
            ["%s:bfloat16" % k for k in TRAIN_LAUNCHES])
        out["serve"] = _ckpt_serve(torch, mx, lm_prefix, np_params,
                                   dict(cfg, dtype="bfloat16"))
        out["legacy"] = _ckpt_legacy(torch, mx, tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "checkpoint", "card": card, "config": CHECKPOINT,
          "transformer": dict(FULL, num_layers=CHECKPOINT["transformer"][
              "num_layers"], dtype="bfloat16"),
          "resnet": dict(RESNET, dtype="bfloat16"), **out})
    return out


# ----------------------------------------------------------------------
# the rest of the training surface: gradient mirroring,
# CausalSelfAttention, Deconvolution and LeakyReLU, the harnesses
# ----------------------------------------------------------------------
def _mirror_arm(torch, mx, np_params, cfg, mirror, batches):
    """One arm of fit_lm_mirror: Module.fit over ``batches`` with
    MXNET_BACKWARD_DO_MIRROR set to ``mirror``; the run's launches, each
    graph's records, step times, peak memory, replay ms and the final
    weights (device copies)."""
    from mxnet_tpu_torch.kernels import (LAUNCHES_BY_DTYPE, PLAIN_CALLS,
                                         reset_counts)
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.weights import convert_params
    fm = FIT_MIRROR
    ctx = mx.gpu(0)
    S = cfg["seq_len"]
    stamps = []

    def per_step(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    with env_set("MXNET_BACKWARD_DO_MIRROR", "1" if mirror else "0"):
        mx.random.seed(SEED)
        mod = mx.Module(transformer.get_symbol(
            dtype="bfloat16", dropout=fm["dropout"], **cfg), context=ctx)
        mod.bind(data_shapes=[("data", (fm["batch"], S))],
                 label_shapes=[("softmax_label", (fm["batch"] * S,))])
        mod.set_params(convert_params(np_params, ctx, cfg), {})
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stamps.append(time.perf_counter())
        mod.fit(ListBatches(mx, batches), num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": fm["lr"],
                                  "momentum": fm["momentum"],
                                  "multi_precision": True},
                eval_metric="perplexity", batch_end_callback=per_step)
        torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES_BY_DTYPE.items() if v}
    plain = {k: v for k, v in PLAIN_CALLS.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    fused = mod._fused_fit
    check(fused is not None and fused.launches == len(batches),
          "fit_lm_mirror: %s of %d steps ran fused" % (
              None if fused is None else fused.launches, len(batches)))
    check(fused.captures == 1 and len(fused._programs) == 1,
          "fit_lm_mirror: %d captures, %d programs (one wanted)"
          % (fused.captures, len(fused._programs)))
    check([k[-1] for k in fused._programs] == [mirror],
          "fit_lm_mirror: the program's mirror key is not %s" % mirror)
    check(not plain, "fit_lm_mirror: plain versions ran: %s" % plain)
    exe = mod._exec_group._exec
    weights = {n: exe.arg_dict[n]._data.detach().clone()
               for n in mod._param_names}
    check(all(bool(torch.isfinite(w).all()) for w in weights.values()),
          "fit_lm_mirror: a weight is not finite")
    graph = [p.graph for p in fused._programs.values()][0]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(fm["replays"]):
        graph.replay()
    end.record()
    end.synchronize()
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    # the replays: after the warm-up steps and the capture
    steady = step_ms[3:]
    result = {"mirror": mirror, "step_ms": step_ms,
              "step_ms_p50": statistics.median(steady),
              "tokens_per_s": fm["batch"] * S
              / (statistics.median(steady) / 1e3),
              "graph_replay_ms": start.elapsed_time(end) / fm["replays"],
              "peak_mem_gb": peak, "launches": launches,
              "captured_per_step": fused.captured_launches(True)[0]}
    del mod, exe, graph, fused
    gc_collect(torch)
    return result, weights


def _resnet_mirror_arm(torch, mx, mirror):
    """ResNet-50 (224 x 224, f32) through FIT_MIRROR's Module.fit steps
    with MXNET_BACKWARD_DO_MIRROR set to ``mirror``: the moving
    statistics and weights after them (device copies)."""
    from mxnet_tpu_torch.models import resnet
    fm = FIT_MIRROR
    ctx = mx.gpu(0)
    B = fm["resnet_batch"]
    image = RESNET["image_shape"]
    sym = resnet.get_symbol(**RESNET)
    args, auxs = seeded_resnet_params(sym, B, image)
    x, y = _image_batches(image, B, SEED + 80, RESNET["num_classes"])
    batches = [(x, y)] * fm["resnet_steps"]
    with env_set("MXNET_BACKWARD_DO_MIRROR", "1" if mirror else "0"):
        mx.random.seed(SEED)
        mod = mx.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", (B,) + tuple(image))],
                 label_shapes=[("softmax_label", (B,))])
        mod.set_params({k: mx.nd.array(v, ctx=ctx) for k, v in args.items()},
                       {k: mx.nd.array(v, ctx=ctx) for k, v in auxs.items()})
        it = ImageBatches(mx, batches)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": fm["lr_resnet"],
                                  "momentum": 0.9, "wd": 1e-4,
                                  "rescale_grad": 1.0 / B},
                eval_metric="acc")
        torch.cuda.synchronize()
    exe = mod._exec_group._exec
    check(mod._fused_fit is not None
          and mod._fused_fit.launches == len(batches),
          "fit_lm_mirror: the ResNet-50 steps did not run fused")
    out = ({n: a._data.clone() for n, a in exe.aux_dict.items()},
           {n: exe.arg_dict[n]._data.detach().clone()
            for n in mod._param_names})
    del mod, exe
    gc_collect(torch)
    return out


class ImageBatches:
    """Batches from a list of (images, labels) numpy pairs, on the card."""

    def __init__(self, mx, batches):
        self.mx, self.batches, self.i = mx, batches, 0

    @property
    def provide_data(self):
        return [self.mx.io.DataDesc("data", self.batches[0][0].shape)]

    @property
    def provide_label(self):
        return [self.mx.io.DataDesc("softmax_label",
                                    self.batches[0][1].shape)]

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == len(self.batches):
            raise StopIteration
        x, y = self.batches[self.i]
        self.i += 1
        gpu = self.mx.gpu(0)
        return self.mx.io.DataBatch(data=[self.mx.nd.array(x, ctx=gpu)],
                                    label=[self.mx.nd.array(y, ctx=gpu)],
                                    pad=0)

    def reset(self):
        self.i = 0


def _max_diff(torch, a, b):
    """(largest absolute difference, names that differ) of two dicts of
    tensors."""
    worst, names = 0.0, []
    for n, t in a.items():
        if not torch.equal(t, b[n]):
            names.append(n)
            worst = max(worst, max_err(t, b[n]))
    return worst, sorted(names)


def phase_fit_lm_mirror(torch, mx, np_params, cfg=FULL):
    """MXNET_BACKWARD_DO_MIRROR=1 on the card (FIT_MIRROR): the LM at full
    width in bf16 through Module.fit's fused step with and without the
    recompute, from the same weights, batches and seed: one graph each,
    rows 3, 4 and 8 launched in bf16, the mirrored graph recording a
    second forward's launches of rows 3 and 8 (LayerNorm forward 50 and
    flash forward 24 a step, the backward kernels as before), the
    weights after the same steps equal (or the largest difference
    printed with the tensors that differ); step p50, replay ms and peak
    memory of each; then ResNet-50's moving statistics after mirrored
    steps equal to the unmirrored ones (BatchNorm moves once a step).
    Returns the mirrored arm's launches and records."""
    fm = FIT_MIRROR
    batches = [_token_batches(cfg, fm["batch"], SEED + 90 + i)
               for i in range(fm["steps"])]
    plain, w_plain = _mirror_arm(torch, mx, np_params, cfg, False, batches)
    mirrored, w_mirror = _mirror_arm(torch, mx, np_params, cfg, True,
                                     batches)
    for arm, extra in ((plain, 1), (mirrored, 2)):
        rec = arm["captured_per_step"]
        for name, n in TRAIN_LAUNCHES.items():
            key = name + ":bfloat16"
            want = n * (extra if name in ("layernorm_fused",
                                          "flash_attention_fwd") else 1)
            check(arm["launches"].get(key, 0) > 0, "fit_lm_mirror: %s was "
                  "not launched (mirror %s)" % (key, arm["mirror"]))
            check(rec.get(key, 0) == want, "fit_lm_mirror: the graph records "
                  "%s %d times, want %d (mirror %s)"
                  % (key, rec.get(key, 0), want, arm["mirror"]))
    diff, names = _max_diff(torch, w_plain, w_mirror)
    del w_plain, w_mirror
    # bf16 weights: equal, or apart by at most an ulp of each tensor's
    # largest magnitude (a reduction that orders its sums by the run)
    check(diff <= 2.0 ** -7, "fit_lm_mirror: mirrored weights are %g from "
          "the unmirrored ones (%s)" % (diff, names[:5]))
    aux0, args0 = _resnet_mirror_arm(torch, mx, False)
    aux1, args1 = _resnet_mirror_arm(torch, mx, True)
    aux_diff, aux_names = _max_diff(torch, aux0, aux1)
    arg_diff, arg_names = _max_diff(torch, args0, args1)
    check(aux_diff == 0.0, "fit_lm_mirror: ResNet-50's mirrored moving "
          "statistics differ by %g (%s)" % (aux_diff, aux_names[:5]))
    del aux0, aux1, args0, args1
    gc_collect(torch)
    emit({"phase": "fit_lm_mirror", "config": dict(cfg, dtype="bfloat16"),
          "train": fm, "unmirrored": plain, "mirrored": mirrored,
          "weights_bit_equal": not names, "weights_max_abs_diff": diff,
          "weights_differing": names,
          "resnet50_moving_stats_equal": aux_diff == 0.0,
          "resnet50_weights_max_abs_diff": arg_diff,
          "resnet50_weights_differing": arg_names,
          "peak_ratio": mirrored["peak_mem_gb"] / plain["peak_mem_gb"],
          "step_ratio": mirrored["step_ms_p50"] / plain["step_ms_p50"]})
    return mirrored


def _csa_views(qkv, H):
    """The op's q, k and v: the thirds of the last axis, head-major."""
    B, S, d3 = qkv.shape
    return qkv.view(B, S, 3, H, d3 // 3 // H).permute(2, 0, 3, 1, 4) \
        .contiguous().unbind(0)


def _causal_fit(torch, mx, ctx, x, y, params, steps):
    """FullyConnected -> CausalSelfAttention -> FullyConnected through
    Module.fit on ``ctx``: the weights after ``steps`` SGD steps on the
    same batch."""
    c = CAUSAL
    d, H = c["d_model"], c["heads"]
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=3 * d, flatten=False,
                                name="qkv")
    net = mx.sym.contrib.CausalSelfAttention(net, num_heads=H, name="att")
    net = mx.sym.FullyConnected(net, num_hidden=c["classes"], name="head")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.set_params({k: mx.nd.array(v, ctx=ctx) for k, v in params.items()},
                   {})
    batches = [(x, y)] * steps
    it = ImageBatches(mx, batches) if ctx.device_type == "gpu" \
        else mx.io.NDArrayIter(np.concatenate([x] * steps),
                               np.concatenate([y] * steps),
                               batch_size=x.shape[0])
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": c["fit_lr"], "momentum": 0.9},
            eval_metric="acc")
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def phase_causal_attention(torch, mx, mxk, dev, flush):
    """``_contrib_CausalSelfAttention`` on the card (CAUSAL): in each type,
    the op through ``mx.nd`` under autograd, forward and backward, is the
    main path (row 8's forward, dK/dV and dQ launched once each in the
    type, no plain version); the three kernels on the op's views against
    their plain versions (_flash_pairs, each row's own bound); the op end
    to end against autograd through the plain attention; op times beside
    SDPA's on the same views; then Module.fit steps of FullyConnected ->
    op -> FullyConnected, card (fused step, one capture) against CPU.
    Returns the main path's launches by ``name:dtype``."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import (LAUNCHES_BY_DTYPE, PLAIN_CALLS,
                                         reset_counts)
    from mxnet_tpu_torch.kernels.flash_attention import flash_attention_plain
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops.nn import causal_self_attention
    c = CAUSAL
    B, S, d, H = c["batch"], c["seq"], c["d_model"], c["heads"]
    D = d // H
    sc = 1.0 / D ** 0.5
    g = torch.Generator(device="cpu").manual_seed(SEED + 70)
    launches, out = {}, {}
    seconds = {"start": time.perf_counter()}
    for dtype in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype)
        qkv = (torch.randn(B, S, 3 * d, generator=g) * 0.5).to(dev).to(dt)
        dy = torch.randn(B, S, d, generator=g).to(dev).to(dt)
        # the main path: the op as a user calls it
        x = NDArray(qkv.clone())
        x.attach_grad()
        reset_counts()
        with mx.autograd.record():
            y = mx.nd.contrib.CausalSelfAttention(x, num_heads=H)
        y.backward(NDArray(dy))
        torch.cuda.synchronize()
        got = {k: v for k, v in LAUNCHES_BY_DTYPE.items() if v}
        plain = {k: v for k, v in PLAIN_CALLS.items() if v}
        for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                     "flash_attention_bwd_dq"):
            key = "%s:%s" % (name, dtype)
            check(got.get(key, 0) == 1, "causal_attention: %s launched %d "
                  "times" % (key, got.get(key, 0)))
        check(not plain, "causal_attention: plain versions ran: %s" % plain)
        launches.update(got)
        # the kernels on the op's views against their plain versions
        errs = {}
        q, k, v = _csa_views(qkv, H)
        do = dy.view(B, S, H, D).transpose(1, 2).contiguous()
        for what, a, b in _flash_pairs(torch, mxk, q, k, v, do, sc):
            if dtype == "float32" or what == "lse":
                ok = close(torch, a, b)
            elif dtype == "bfloat16":
                ok = close_bf16(torch, a, b)
            else:
                ok = close_f16_flash(torch, a, b)
            check(ok, "causal_attention %s: the kernel's %s disagrees with "
                  "its plain version (max abs err %g)"
                  % (dtype, what, max_err(a, b)))
            errs[what] = max_err(a, b)
        # the op end to end against autograd through the plain attention
        ref_in = qkv.clone().requires_grad_()
        rq, rk, rv = ref_in.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4) \
            .unbind(0)
        ref = flash_attention_plain(rq, rk, rv, scale=sc).transpose(1, 2) \
            .reshape(B, S, d)
        (ref_g,) = torch.autograd.grad(ref, ref_in, dy)
        pairs = (("out", y._data.detach(), ref.detach()),
                 ("d_qkv", x.grad._data, ref_g))
        for what, a, b in pairs:
            if dtype == "float32":
                ok = close(torch, a, b)
                rel = None
            else:
                rel = float((a.float() - b.float()).norm()
                            / b.float().norm())
                ok = rel < c["l2"][dtype]
            check(ok, "causal_attention %s: the op's %s disagrees with "
                  "autograd through the plain attention (max abs err %g, "
                  "relative L2 %s)" % (dtype, what, max_err(a, b), rel))
            errs["op " + what] = max_err(a, b) if rel is None else rel
        del ref_in, ref, ref_g, x, y

        def op_fwd():
            return mxk.flash_attention(*_csa_views(qkv, H), scale=sc)

        xin = qkv.clone().requires_grad_()

        def op_fwd_bwd():
            o = causal_self_attention(xin, num_heads=H)
            return torch.autograd.grad(o, xin, dy)

        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                               scale=sc)
            return torch.autograd.grad(o, (qs, ks, vs), do)

        out[dtype] = {
            "max_errs": errs,
            "op_fwd_ms": time_ms(torch, op_fwd, flush, reps=20),
            "op_fwd_bwd_ms": time_ms(torch, op_fwd_bwd, flush, reps=20),
            "sdpa_fwd_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=sc), flush, reps=20),
            "sdpa_fwd_bwd_ms": time_ms(torch, sdpa_fwd_bwd, flush, reps=20)}
        del qkv, dy, q, k, v, do, xin, qs, ks, vs
        gc_collect(torch)
    # Module.fit, card against CPU
    rng = np.random.RandomState(SEED % 2 ** 31)
    fb, fs = c["fit_batch"], c["fit_seq"]
    x = (rng.randn(fb, fs, d) * 0.5).astype(np.float32)
    y = rng.randint(0, c["classes"], (fb,)).astype(np.float32)
    params = {"qkv_weight": rng.randn(3 * d, d) * d ** -0.5,
              "qkv_bias": np.zeros(3 * d),
              "head_weight": rng.randn(c["classes"], fs * d) * 0.02,
              "head_bias": np.zeros(c["classes"])}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    seconds["types"] = time.perf_counter() - seconds.pop("start")
    t0 = time.perf_counter()
    reset_counts()
    mod, card = _causal_fit(torch, mx, mx.gpu(0), x, y, params,
                            c["fit_steps"])
    torch.cuda.synchronize()
    fit_launches = {k: v for k, v in LAUNCHES_BY_DTYPE.items() if v}
    check(mod._fused_fit is not None and mod._fused_fit.captures == 1,
          "causal_attention: the fit did not capture its step")
    captured = mod._fused_fit.captured_launches()[0]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        check(fit_launches.get(name + ":float32", 0) > 0
              and captured.get(name, 0) == 1,
              "causal_attention: the fit's step does not run %s" % name)
    del mod
    seconds["fit_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, cpu = _causal_fit(torch, mx, mx.cpu(), x, y, params, c["fit_steps"])
    seconds["fit_cpu"] = time.perf_counter() - t0
    fit_l2 = {}
    for name, w in params.items():
        move = float(np.linalg.norm(cpu[name] - w))
        fit_l2[name] = float(np.linalg.norm(card[name] - cpu[name])) / move
        check(move > 0 and fit_l2[name] < c["fit_l2"], "causal_attention: "
              "fit's %s is %g of its move from the CPU's"
              % (name, fit_l2[name]))
    gc_collect(torch)
    emit({"phase": "causal_attention", "config": CAUSAL, **out,
          "launches": launches, "fit_launches": fit_launches,
          "fit_captured_per_step": captured, "fit_diff_over_move": fit_l2,
          "seconds": seconds,
          "tolerance": "kernels as their rows' phases; the op: f32 rtol "
                       "1e-4 / atol 1e-5, 16-bit relative L2 %s; fit %g of "
                       "each weight's move" % (c["l2"], c["fit_l2"])})
    return launches, fit_launches


def close_scaled(torch, a, b, rtol, share):
    """``|a - b| <= rtol * |b| + share * max |b|`` everywhere."""
    a, b = a.float(), b.float()
    lim = rtol * b.abs() + share * float(b.abs().max())
    return bool(((a - b).abs() <= lim).all())


def phase_deconv_leaky(torch, mx, dev, flush):
    """Deconvolution at the DCGAN generator's shapes and every LeakyReLU
    act (DECONV), f32 and bf16, forward and backward, card (cuDNN's
    transposed convolutions, eager elementwise passes) against the CPU
    on the same inputs (f32 within DECONV's rtol and share of the
    largest magnitude, bf16 within close_bf16); their times on the card;
    rrelu's slopes drawn on the card equal the CPU's from one seed, and
    two replays of one captured graph draw two sets."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.cuda_graph import WARMUP, Program
    from mxnet_tpu_torch.ops.nn import deconvolution, leaky_relu, rrelu_slopes
    c = DECONV
    g = torch.Generator(device="cpu").manual_seed(SEED + 75)
    nb = c["cpu_batch"]
    attrs = dict(kernel=c["kernel"], stride=c["stride"], pad=c["pad"],
                 no_bias=True)
    out = {"deconv": [], "leaky": []}

    def hold(dtype, what, a, b):
        ok = close_scaled(torch, a, b, c["f32_rtol"], c["f32_atol_share"]) \
            if dtype == "float32" else close_bf16(torch, a, b)
        check(ok, "deconv_leaky %s %s: the card disagrees with the CPU "
              "(max abs err %g)" % (dtype, what, max_err(a, b)))
        return max_err(a, b)

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        size = c["size"]
        for cin, cout in zip(c["channels"], c["channels"][1:]):
            x = torch.randn(c["batch"], cin, size, size, generator=g).to(dt)
            w = (torch.randn(cin, cout, *c["kernel"], generator=g)
                 * (cin * 4) ** -0.5).to(dt)
            xd, wd = x.to(dev), w.to(dev)
            o = deconvolution(xd, wd, num_filter=cout, **attrs)
            dy = torch.randn(o.shape, generator=g).to(dt)
            dyd = dy.to(dev)
            # the card on the first samples against the CPU
            xs, ws = (t[:nb].clone().requires_grad_() if t is xd
                      else t.clone().requires_grad_() for t in (xd, wd))
            os_ = deconvolution(xs, ws, num_filter=cout, **attrs)
            gx, gw = torch.autograd.grad(os_, (xs, ws), dyd[:nb])
            xc, wc = x[:nb].clone().requires_grad_(), \
                w.clone().requires_grad_()
            oc = deconvolution(xc, wc, num_filter=cout, **attrs)
            gxc, gwc = torch.autograd.grad(oc, (xc, wc), dy[:nb])
            tag = "%dx%dx%d->%d" % (size, size, cin, cout)
            errs = {what: hold(dtype, "%s %s" % (tag, what), a.cpu(), b)
                    for what, a, b in (("out", o[:nb], oc), ("d_data", gx,
                                                              gxc),
                                       ("d_weight", gw, gwc))}
            xr, wr = xd.clone().requires_grad_(), wd.clone().requires_grad_()
            orr = deconvolution(xr, wr, num_filter=cout, **attrs)
            out["deconv"].append({
                "dtype": dtype, "in": [c["batch"], cin, size, size],
                "out": list(o.shape), "max_errs": errs,
                "fwd_ms": time_ms(torch, lambda: deconvolution(
                    xd, wd, num_filter=cout, **attrs), flush, reps=20),
                "bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
                    orr, (xr, wr), dyd, retain_graph=True), flush,
                    reps=20)})
            size *= 2
            del x, w, xd, wd, o, dy, dyd, xs, ws, os_, gx, gw, orr, xr, wr
        shape = c["leaky_shape"]
        x = torch.randn(*shape, generator=g).to(dt)
        dy = torch.randn(*shape, generator=g).to(dt)
        gamma = torch.rand(shape[1], generator=g).to(dt)
        xd, dyd, gd = x.to(dev), dy.to(dev), gamma.to(dev)
        for act in c["acts"]:
            seed = torch.tensor(SEED + 7, dtype=torch.int64)
            kw = dict(act_type=act, is_train=act == "rrelu")
            res = []
            for xx, yy, gg in ((xd[:nb], dyd[:nb], gd), (x[:nb], dy[:nb],
                                                         gamma)):
                xx = xx.clone().requires_grad_()
                gg = gg.clone().requires_grad_()
                o = leaky_relu(xx, gg if act == "prelu" else None,
                               rng=mxrandom.StepRandom(seed.to(xx.device)),
                               **kw)
                leaves = (xx, gg) if act == "prelu" else (xx,)
                res.append((o,) + torch.autograd.grad(o, leaves, yy))
            errs = {what: hold(dtype, "%s %s" % (act, what), a.cpu(), b)
                    for what, a, b in zip(("out", "d_data", "d_gamma"),
                                          *res)}
            seed_dev = seed.to(dev)
            fwd = time_ms(torch, lambda: leaky_relu(
                xd, gd if act == "prelu" else None,
                rng=mxrandom.StepRandom(seed_dev), **kw), flush, reps=20)
            out["leaky"].append({"dtype": dtype, "act": act,
                                 "max_errs": errs, "fwd_ms": fwd})
        del x, dy, xd, dyd
        gc_collect(torch)
    # rrelu: the card's slopes are the CPU's from one seed, and a captured
    # graph draws anew on each replay
    shape = c["leaky_shape"]
    x = torch.randn(*shape, generator=g).to(dev)
    seed = torch.tensor(SEED + 9, dtype=torch.int64)
    card = rrelu_slopes(x, 0.125, 0.334, mxrandom.StepRandom(seed.to(dev)))
    cpu = rrelu_slopes(x[:nb].cpu(), 0.125, 0.334,
                       mxrandom.StepRandom(seed))
    check(torch.equal(card[:nb].cpu(), cpu), "deconv_leaky: rrelu's slopes "
          "on the card differ from the CPU's from one seed")
    check(float(card.min()) >= 0.125 and float(card.max()) < 0.334,
          "deconv_leaky: rrelu's slopes leave [0.125, 0.334)")
    staged = torch.zeros((), dtype=torch.int64, device=dev)

    def body():
        return [leaky_relu(x, act_type="rrelu", is_train=True,
                           rng=mxrandom.StepRandom(staged))]

    prog = Program(body, dev, "rrelu graph", "")
    for _ in range(WARMUP):
        prog.warm_up()
    prog.capture()
    seeds, outs = [], []
    for _ in range(2):
        mxrandom.next_seed(dev, out=staged)
        seeds.append(int(staged.item()))
        outs.append(prog.replay()[0].clone())
    check(seeds[0] != seeds[1] and not torch.equal(outs[0], outs[1]),
          "deconv_leaky: two rrelu replays drew one set of slopes")
    for s_, o in zip(seeds, outs):
        want = leaky_relu(x, act_type="rrelu", is_train=True,
                          rng=mxrandom.StepRandom(torch.tensor(
                              s_, dtype=torch.int64, device=dev)))
        check(torch.equal(o, want), "deconv_leaky: a replay's rrelu is not "
              "its seed's draw")
    out["rrelu_replay_seeds"] = seeds
    del prog, outs, x, card
    gc_collect(torch)
    emit({"phase": "deconv_leaky", "config": DECONV, **out,
          "tolerance": "f32 rtol %g + %g of the largest magnitude, bf16 "
                       "close_bf16; rrelu slopes bit for bit"
                       % (c["f32_rtol"], c["f32_atol_share"])})
    return out


def phase_harness(torch, card):
    """Each port harness (HARNESS_WAVES) in a process of its own on the
    card, a wave's processes at once: exit 0 within its time limit,
    finite final metrics and weights (the image-classification harness's
    own check) or the DCGAN's own checks, the Speedometer's samples/s
    printed beside the card's name."""
    import re
    runs = []
    for wave in HARNESS_WAVES:
        procs = []
        for what, script, args, limit in wave:
            path = os.path.join(HERE, "example", "torch", script)
            procs.append((what, script, args, limit, time.perf_counter(),
                          subprocess.Popen(
                              [sys.executable, path] + args, cwd=HERE,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)))
        for what, script, args, limit, t0, proc in procs:
            try:
                text = proc.communicate(
                    timeout=max(1.0, limit - (time.perf_counter() - t0)))[0]
            except subprocess.TimeoutExpired:
                for p in procs:
                    p[-1].kill()
                    p[-1].communicate()
                check(False, "harness: %s ran past %d s" % (what, limit))
            check(proc.returncode == 0, "harness: %s exited %d: %s"
                  % (what, proc.returncode, text[-3000:]))
            speeds = [float(v) for v in re.findall(
                r"Speed: ([0-9.]+) samples/sec", text)]
            if script.startswith("gan"):
                check("dcgan example OK" in text, "harness: dcgan did not "
                      "pass its checks")
                final = [ln for ln in text.splitlines()
                         if ln.startswith("iter")]
            else:
                final = [ln for ln in text.splitlines()
                         if "final train metrics" in ln]
                check(final and final[-1].endswith("finite True"),
                      "harness: %s ended without finite metrics" % what)
                check(speeds, "harness: %s printed no samples/s" % what)
            runs.append({"run": what, "args": args, "shared_card":
                         len(wave) > 1,
                         "seconds": time.perf_counter() - t0,
                         "samples_per_s": speeds, "last": final[-1:]})
            print("harness %s: samples/s %s on %s" % (what, speeds, card),
                  flush=True)
    emit({"phase": "harness", "card": card, "runs": runs})
    return runs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels as mxk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = phase_device(torch)
    phase_build()
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)     # 256 MB: well past the 50 MB L2
    decode_rows = phase_decode(torch, mxk, dev, flush)
    chunk_rows = phase_chunk(torch, mxk, dev, flush)
    serve_kernels = [decode_rows[0], chunk_rows[0],
                     phase_layernorm(torch, mxk, dev, flush)]
    prefill_kernel, prefill_bf16_kernel, prefill_f16_kernel = \
        phase_prefill(torch, mxk, dev, flush)
    train_kernels = [phase_layernorm_bwd(torch, mxk, dev, flush)] + \
        phase_flash(torch, mxk, dev, flush)
    quant_kernel = phase_quant(torch, mxk, dev, flush)
    fused_kernel = phase_fused_matmul(torch, mxk, dev, flush)
    bf16_kernels = phase_flash_bf16(torch, mxk, dev, flush) + \
        phase_layernorm_bf16(torch, mxk, dev, flush) + \
        [phase_fused_matmul_bf16(torch, mxk, dev, flush)]
    # row 7's f16 form (float16 for rows 7 and 10)
    fused_f16_kernel = phase_fused_matmul_f16(torch, mxk, dev, flush)
    # the bf16 serve step's kernels: rows 1 and 2 and LayerNorm at its rows
    serve_bf16_kernels = [decode_rows[1], chunk_rows[1]] + \
        [k for k in bf16_kernels if "path" in k]
    bf16_kernels = [k for k in bf16_kernels if "path" not in k]
    # the f16 serve step's kernels (rows 1, 2 and 3 at its rows), row 5's
    # f16 form (serve_prefill_f16) and row 8's f16 forward (the draft
    # spans of serve_spec_f16)
    serve_f16_kernels = [decode_rows[2], chunk_rows[2],
                         phase_layernorm_f16(torch, mxk, dev, flush)]
    flash_f16_kernel, *flash_bwd_f16 = phase_flash_f16(torch, mxk, dev,
                                                        flush)
    # the f16 training step's kernels (float16 training): row 4 and row
    # 8's dK/dV and dQ
    train_f16_kernels = [phase_layernorm_bwd_f16(torch, mxk, dev, flush)] \
        + flash_bwd_f16
    phase_dtype_codes(torch, mxk, dev)
    band4d_kernels = phase_fused_band4d(torch, mxk, dev, flush)
    head_dim_times = phase_head_dim(torch, mxk, dev, flush)
    rtc_kernels = phase_rtc(torch, mx, dev, flush)
    phase_dropout(torch, mx, mxk, dev, flush)
    causal_launches, causal_fit = phase_causal_attention(torch, mx, mxk, dev,
                                                         flush)
    phase_deconv_leaky(torch, mx, dev, flush)
    del flush
    sandwich_iters, sandwich_launches = phase_sandwich(torch, mx)
    full = seeded_params(FULL)
    serve_launches, serve_steps, serve_rec = phase_serve(torch, mx, full)
    phase_agreement(torch, mx)
    prefill_launches, prefill_rec = phase_serve_prefill(torch, mx, full)
    _, _, spec_rec = phase_serve_spec(torch, mx, full)
    phase_prefill_agreement(torch, mx)
    serve_bf16_launches, serve_bf16_steps, serve_bf16_rec = \
        phase_serve_bf16(torch, mx, full)
    prefill_bf16_launches, prefill_bf16_rec = \
        phase_serve_prefill_bf16(torch, mx, full)
    _, _, spec_bf16_rec, _ = phase_serve_spec_bf16(torch, mx, full)
    phase_serve_bf16_agreement(torch, mx)
    serve_f16_launches, serve_f16_steps, serve_f16_rec = \
        phase_serve_f16(torch, mx, full)
    prefill_f16_launches, prefill_f16_rec = \
        phase_serve_prefill_f16(torch, mx, full)
    _, _, spec_f16_rec, draft_f16 = phase_serve_spec_f16(torch, mx, full)
    phase_serve_f16_agreement(torch, mx)
    train_launches, train_steps = phase_train(torch, mx, full)
    bf16_launches, bf16_steps = phase_train_bf16(torch, mx, full)
    f16_launches, f16_steps = phase_train_f16(torch, mx, full)
    fit_fused = phase_fit_fused(torch, mx, full)
    fit_bf16 = phase_fit_bf16(torch, mx, full)
    fit_f16 = phase_fit_f16(torch, mx, full, fit_bf16["transformer"])
    lm_dropout = phase_fit_lm_dropout(torch, mx, full)
    lm_mirror = phase_fit_lm_mirror(torch, mx, full)
    phase_fused_kinds(torch, mx, full)
    del full
    phase_train_agreement(torch, mx)
    phase_kvstore(torch, mx)
    resnet_launches, resnet_steps, fit_p50 = phase_train_resnet(torch, mx)
    gluon_launches, gluon_steps = phase_gluon_resnet(torch, mx,
                                                     fit_p50=fit_p50)
    phase_gluon_agreement(torch, mx)
    phase_resnet_agreement(torch, mx)
    nhwc_launches, nhwc_steps = phase_train_resnet_nhwc(torch, mx)
    phase_resnet_nhwc_agreement(torch, mx)
    rbf16_launches, rbf16_steps = phase_train_resnet_bf16(torch, mx)
    rf16_launches, rf16_steps = phase_train_resnet_f16(torch, mx)
    phase_bf16_agreement(torch, mx)
    phase_f16_train_agreement(torch, mx)
    phase_resnet_f16_agreement(torch, mx)
    phase_head_dim_agreement(torch, mx)
    phase_checkpoint(torch, mx, card)
    phase_harness(torch, card)
    # launches: the count of each kernel's main-path run (serve for the
    # serving kernels, the one-shot prefill forward of serve_prefill for
    # the prefill kernel, the transformer's Module.fit for its training
    # kernels, the 2-bit ResNet-50 fit for the quantizer, the fused NHWC
    # ResNet-50 TrainStep arm for the fused kernel); LayerNorm's forward
    # runs on several and carries the train and spec counts beside it,
    # the chunk kernel the spec step's
    # the serving steps run as captured graphs (PR 18): a run's wrapper
    # counts are the engine's warm-up walks and capture, and each step
    # replays what the step graph recorded (launches_per_step, also
    # captured_per_step); graph_launches is that times the steps
    for k in serve_kernels:
        k["launches"] = serve_launches[k["name"]]
        k["launches_per_step"] = k["captured_per_step"] = \
            serve_rec[k["name"]]
        k["graph_launches"] = serve_rec[k["name"]] * serve_steps
        k["spec_launches_per_step"] = spec_rec.get(k["name"], 0)
    serve_kernels[2]["train_launches"] = train_launches["layernorm_fused"]
    prefill_kernel["launches"] = prefill_launches["paged_prefill_attend"]
    prefill_kernel["launches_per_step"] = prefill_kernel[
        "captured_per_step"] = prefill_rec["paged_prefill_attend"]
    # the bf16 instances: serve_bf16's run (rows 1, 2 and 3), the spec
    # step's beside it, and serve_prefill_bf16's prefill forward (row 5)
    for k in serve_bf16_kernels:
        k["launches"] = serve_bf16_launches[k["name"]]
        k["launches_per_step"] = k["captured_per_step"] = \
            serve_bf16_rec[k["name"]]
        k["graph_launches"] = serve_bf16_rec[k["name"]] * serve_bf16_steps
        k["spec_launches_per_step"] = spec_bf16_rec.get(k["name"], 0)
    prefill_bf16_kernel["launches"] = \
        prefill_bf16_launches["paged_prefill_attend"]
    prefill_bf16_kernel["launches_per_step"] = prefill_bf16_kernel[
        "captured_per_step"] = prefill_bf16_rec["paged_prefill_attend"]
    # the f16 instances: serve_f16's run (rows 1, 2 and 3), the spec
    # step's beside it, serve_prefill_f16's prefill forward (row 5) and
    # serve_spec_f16's draft arm (row 8's forward: its warm-up walks and
    # captures launch it, the draft graphs replay it)
    for k in serve_f16_kernels:
        k["launches"] = serve_f16_launches[k["name"]]
        k["launches_per_step"] = k["captured_per_step"] = \
            serve_f16_rec[k["name"]]
        k["graph_launches"] = serve_f16_rec[k["name"]] * serve_f16_steps
        k["spec_launches_per_step"] = spec_f16_rec.get(k["name"], 0)
    prefill_f16_kernel["launches"] = \
        prefill_f16_launches["paged_prefill_attend"]
    prefill_f16_kernel["launches_per_step"] = prefill_f16_kernel[
        "captured_per_step"] = prefill_f16_rec["paged_prefill_attend"]
    flash_f16_kernel["launches"] = draft_f16["launches"].get(
        "flash_attention_fwd", 0)
    flash_f16_kernel["graph_launches"] = draft_f16["draft_flash_launches"]
    flash_f16_kernel["launches_per_proposed_token"] = \
        draft_f16["draft_flash_launches"] / draft_f16["spec_proposed"]
    # the f16 training kernels: fit_f16's fused arm (Module.fit's main
    # path: its warm-up steps and capture launch them, the graph replays
    # what it recorded), train_f16's TrainStep run beside it
    for k in train_f16_kernels:
        key = k["name"] + ":float16"
        k["launches"] = fit_f16["transformer"]["launches_by_dtype"].get(
            key, 0)
        k["captured_per_step"] = fit_f16["transformer"][
            "captured_by_dtype"][0].get(key, 0)
        k["train_f16_launches_per_step"] = f16_launches[k["name"]] \
            / f16_steps
    # row 7's f16 form: train_resnet_f16's fused TrainStep arm (28 a step)
    fused_f16_kernel["launches"] = rf16_launches[fused_f16_kernel["name"]]
    fused_f16_kernel["launches_per_step"] = \
        fused_f16_kernel["launches"] / rf16_steps
    for k in serve_f16_kernels + [prefill_f16_kernel, flash_f16_kernel] \
            + train_f16_kernels + [fused_f16_kernel]:
        check(k["launches"] > 0, "%s (float16) was not launched on its main "
              "path" % k["name"])
    # Module.fit's main path is the fused step (fit_fused): its launches
    # are the two warm-up steps' and the capture's, and the graph
    # replays what the capture recorded (captured_per_step); the eager
    # pair's per-step counts stay beside them (launches_per_step)
    fused_tf, fused_rn = fit_fused["transformer"], fit_fused["resnet_2bit"]
    for arm, names in ((fused_tf, [k["name"] for k in train_kernels]
                        + ["layernorm_fused"]),
                       (fused_rn, [quant_kernel["name"]])):
        for name in names:
            check(arm["launches"].get(name, 0) > 0
                  and arm["captured_launches"][0].get(name, 0) > 0,
                  "fit_fused: %s was not launched on the fused path" % name)
    for k in train_kernels:
        k["launches"] = fused_tf["launches"][k["name"]]
        k["captured_per_step"] = fused_tf["captured_launches"][0][k["name"]]
        k["launches_per_step"] = train_launches[k["name"]] / train_steps
    serve_kernels[2]["fit_fused_captured_per_step"] = \
        fused_tf["captured_launches"][0]["layernorm_fused"]
    quant_kernel["launches"] = fused_rn["launches"][quant_kernel["name"]]
    quant_kernel["captured_per_step"] = \
        fused_rn["captured_launches"][0][quant_kernel["name"]]
    quant_kernel["launches_per_step"] = \
        resnet_launches[quant_kernel["name"]] / resnet_steps
    # row 10: the bf16, f32 and f16 sandwich's timed runs
    for k in band4d_kernels:
        n = sandwich_launches[k["dtype"]]
        check(n > 0, "sandwich: fused_band4d %s was not launched"
              % k["dtype"])
        k["launches"] = n
        k["launches_per_iteration"] = n / sandwich_iters
    quant_kernel["gluon_launches_per_step"] = \
        gluon_launches[quant_kernel["name"]] / gluon_steps
    # bf16 Module.fit (fit_bf16): what each fused graph records
    quant_kernel["fit_bf16_captured_per_step"] = \
        fit_bf16["resnet_2bit"]["captured_by_dtype"][0][
            quant_kernel["name"] + ":float32"]
    quant_kernel["fit_f16_captured_per_step"] = \
        fit_f16["resnet_2bit"]["captured_by_dtype"][0][
            quant_kernel["name"] + ":float32"]
    fused_kernel["launches"] = nhwc_launches[fused_kernel["name"]]
    fused_kernel["launches_per_step"] = fused_kernel["launches"] / nhwc_steps
    # the bf16 forms: launches of the bf16 transformer's TrainStep run
    # (flash, LayerNorm) and of the fused bf16 ResNet-50 arm
    for k in bf16_kernels:
        counts, steps = (rbf16_launches, rbf16_steps) \
            if k["name"] == "fused_scale_relu_matmul" \
            else (bf16_launches, bf16_steps)
        k["launches"] = counts[k["name"]]
        k["launches_per_step"] = counts[k["name"]] / steps
        if k["name"] in TRAIN_LAUNCHES:
            k["fit_bf16_captured_per_step"] = \
                fit_bf16["transformer"]["captured_by_dtype"][0][
                    k["name"] + ":bfloat16"]
            # this slice's main path: the dropout LM's fit (warm-up
            # steps and two captures launch them; each graph records them)
            key = k["name"] + ":bfloat16"
            k["fit_lm_dropout_launches"] = lm_dropout["launches"][key]
            k["fit_lm_dropout_captured_per_step"] = \
                lm_dropout["captured_per_graph"][0][key]
            # MXNET_BACKWARD_DO_MIRROR's graph (fit_lm_mirror's mirrored
            # arm): rows 3 and 8's forwards twice a step
            k["fit_lm_mirror_launches"] = lm_mirror["launches"][key]
            k["fit_lm_mirror_captured_per_step"] = \
                lm_mirror["captured_per_step"][key]
    # row 8 under CausalSelfAttention (causal_attention): the op's
    # forward and backward in each type, and the f32 Module.fit run of
    # FullyConnected -> op -> FullyConnected
    for k in train_kernels + bf16_kernels + train_f16_kernels \
            + [flash_f16_kernel]:
        key = "%s:%s" % (k["name"], k.get("dtype", "float32"))
        if k["name"].startswith("flash_attention"):
            k["causal_attention_launches"] = causal_launches[key]
            check(k["causal_attention_launches"] > 0, "causal_attention: "
                  "%s was not launched" % key)
            if key.endswith(":float32"):
                k["causal_attention_fit_launches"] = causal_fit[key]
    f32_kernels = serve_kernels + [prefill_kernel] + train_kernels + \
        [quant_kernel, fused_kernel]
    for k in f32_kernels:
        k.setdefault("dtype", "float32")
        if k["name"] in head_dim_times:
            k["head_dim_256"] = {key: head_dim_times[k["name"]][key]
                                 for key in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "dtype")
    emit({"kernels": [{**{key: k[key] for key in keys},
                       **{key: k[key] for key in ("launches_per_step",
                                                  "captured_per_step",
                                                  "graph_launches",
                                                  "launches_per_iteration",
                                                  "fit_fused_captured_per_step",
                                                  "fit_bf16_captured_per_step",
                                                  "fit_f16_captured_per_step",
                                                  "fit_lm_dropout_launches",
                                                  "fit_lm_dropout_captured_per_step",
                                                  "fit_lm_mirror_launches",
                                                  "fit_lm_mirror_captured_per_step",
                                                  "causal_attention_launches",
                                                  "causal_attention_fit_launches",
                                                  "train_f16_launches_per_step",
                                                  "train_launches",
                                                  "spec_launches_per_step",
                                                  "launches_per_proposed_token",
                                                  "gluon_launches_per_step",
                                                  "head_dim_256",
                                                  "compile_ms",
                                                  "host_launch_us", "path",
                                                  "f32_instance_ms")
                          if key in k}}
                      for k in f32_kernels + bf16_kernels
                      + serve_bf16_kernels + [prefill_bf16_kernel]
                      + serve_f16_kernels + [prefill_f16_kernel,
                                             flash_f16_kernel]
                      + train_f16_kernels + [fused_f16_kernel] + rtc_kernels
                      + band4d_kernels]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
