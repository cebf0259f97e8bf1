#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--spin-cycles N]

``--spin-cycles`` sets the kernel timer's device spin before each timed
call (default 10^6 cycles, about 0.5 ms); it is there to show that a
reading does not depend on it.

Phases, each of which fails the run (exit code 1, no result line) if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main path from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` and print ``ptxas``'s register / shared-memory
   report; then time an empty kernel of the B1-B4 library under the kernel
   timer below: the floor of one launch, printed on its own line;
3. hold each kernel against its plain PyTorch version at the shapes of the
   ``vusa_edge`` decode step (layer-0 packs of the real model below: wq/wk/wv/wo
   768 -> 768, the LM head 768 -> 32000, the fused MLP 768 / 3072) and at edge
   shapes (sparsity 0 and 0.99, all-zero rows, C % m != 0, odd slot counts,
   and for B1/B3 K = 1000, whose last slice is short, with a = 16 and with
   a = 3, whose chunk starts take narrower copies, and K = 3072, the
   ``fused_mlp=False`` w_down shape), for B in {1, 4, 5, 40} (5 = the rows
   of the batched speculative verify, ``draft_k`` + 1; 40 = the scheduler's
   pool verify, 8 slots x 5, five 8-row batch tiles) and fp32 / bf16
   activations, and for B2/B4 an odd slot count (a = 3), d = 1000 (K and D
   off the slice size) and ff % m != 0; every call's CUDA launches, counted
   by the library, must equal its plan's (B1/B3 ``row_plan``: one launch,
   or two when the plan splits K; B2/B4 ``mlp_plan``: the cluster kernel
   and the ordered window sum): B1/B2 with fp32 and bf16
   values, B3/B4 (the same kernels' int8 and int4 routes) with the int8 and
   int4 packs of the same model.  Tolerance: max |kernel - plain| <= 1e-4 *
   max |plain| for every dtype (bf16 inputs widen to fp32 exactly, int8/int4
   values dequantize to the same fp32 products q * scale, and both sides
   accumulate in fp32, so only the summation order differs).  The first
   and the last row at B = 4, 5 and 40 (rows 0 and 39 of the pool verify)
   must equal B = 1 bitwise.  Each kernel is timed with CUDA events
   (L2 flushed before each launch, as the decode step finds it) beside the
   plain version, one PyTorch library call on the dense (dequantized) fp32
   weights and the least time the card could take (bytes over 3.35 TB/s vs
   fp32 operations over 67 TFLOP/s, H100 SXM data sheet; the bytes are x,
   the output, every pack position, the value bytes of the occupied slots
   only (int4: half a byte) and the quantized packs' fp32 scales);
4. the main path: ``vusa_edge`` at full width (12 layers, d 768, ff 3072,
   vocab 32000), numpy-seeded init, 85 % magnitude pruning,
   ``Engine(packed_weights="all").generate`` with B = 4, prompt 32, 32 new
   tokens, in the eager loop (``fused=False``, as in phases 4-5; phase 7
   runs the CUDA graph).  The launch counters, set to 0 just before and read just after,
   must be exactly 49 * 31 (``vusa_packed_matmul``) and 12 * 31
   (``vusa_fused_mlp_matmul``), all on the float-value route, the CUDA
   launches the B1-B4 library counts for each entry point in that run equal
   to the plan's (``row_plan`` for each projection and the head,
   ``mlp_plan`` for each fused MLP), and the tokens
   finite and in range.  The same weights in fp32: the first decode step's
   packed and dense logits must agree to 1e-2 of the largest logit at full
   depth, and with the depth cut to 2 layers packed and dense greedy tokens
   must be identical.  At full depth free-running fp32 tokens can part at a
   near-tie; their agreement is reported beside a witness that runs no
   kernel of the port: the dense path against itself with every MLP's ff
   lanes permuted (the same function, summed in another order).  bf16's
   token agreement and first-step logit gap are reported too;
5. the quantized main path: the same ``generate`` with
   ``packed_values="int8"`` and ``"int4"``, each counted alone: B3 exactly
   49 * 31 and B4 exactly 12 * 31 launches on that route and none on any
   other, CUDA launches as planned, tokens finite and in range; tok/s, pack bytes per step and byte
   ratio.  In fp32, each quantized engine against the dense engine on
   ``qdq_lm_params`` (the same quantize-dequantize values), decoding from
   one primed cache (the quantized engine prefills dense on the unquantized
   weights): first-step logits within 1e-2 of the largest logit at full
   depth, identical greedy tokens on the 2-layer cut, full-depth token
   agreement reported beside phase 4's witness.  Decode tok/s of the three
   packs taken in turns (reported, not gated);
6. paper workloads, the paper's own A/B comparison at full size: every
   im2col GEMM of ResNet-18 (21, pruned to 85 %) and MobileNetV1 (28,
   75 %) at 224 x 224, B = output pixels, weights ``normal(K, C)`` from a
   numpy seed magnitude-pruned per layer by the quantile rule of
   ``benchmarks/run.py _prune_masks`` (copied here), activations
   ``normal(B, K)`` fp32 from the same generator.  Each model is one
   counted run: all counts set to 0, then per GEMM
   ``ops.apply_packed(x, ops.pack_linear(w, 32, 8, 128))`` (B5,
   ``vusa_spmm`` with ``ncols = C``) and ``ops.matmul`` on x and w
   zero-padded to the reference's tile contract (B6, ``dense_matmul``);
   exactly one counted launch of each per GEMM and none of B1-B4.  A call
   whose plan splits the reduction issues a second CUDA launch, the ordered
   sum of the slices: each library counts the CUDA launches the runtime
   accepts, read before and after each call of the counted run, and each
   GEMM's count must equal its plan's (``tile_plan.cuda_launches``);
   ``cuda_launches_per_call`` is their mean per GEMM.  Each
   output within 1e-4 of the largest |plain| of its plain version, and
   within 1e-3 (of the largest |x @ w|, at least 1) of ``x @ w`` in true
   fp32; bf16 x on three GEMMs per model
   (B5 then rounds its output to bf16, as its plain version does: one bf16
   step, 2**-7 of the value, allowed on top).  Per GEMM, CUDA events with L2
   flushed: kernel, plain version, ``torch.matmul(x, w)`` fp32 as the
   library call, and the bound (bytes over 3.35 TB/s against the kernels'
   TF32 tensor-core operations over 495 TFLOP/s, three per logical fp32
   product, the 3xTF32 split; B5: values, ``row_idx``, x and the (B, C)
   output with 2*B*J*A*C logical operations; B6: the padded operands and
   output with 2*M*N*K; the fp32 67 TFLOP/s bound of earlier runs kept
   beside it as ``bound_fp32_ms``), and each kernel's launch plan (slices
   S, tile BM x BN, stage KS, ``kernels/tile_plan.py``).  Per ResNet-18
   layer group (conv0, layer1-4, fc): B5, B6 and library ms and logical
   TFLOP/s (2*B*K*C over the time).  Per model: the sums, the B5/B6 ratio,
   the packs' compression and virtual growth, beside the cycle simulator's
   VUSA 3x6 (``schedule_widths_fast`` + ``ws_cycles``, as
   ``benchmarks/run.py`` reckons it) and standard 3x6 (``gemm_cycles_standard``) cycles for the
   same masks;
7. graph decode: phase 4's ``generate`` (B = 4, prompt 32, 32 new tokens)
   with ``fused=True``, each decode step a replay of one step captured in
   a CUDA graph, dense and packed with fp32, int8 and int4 values: the
   tokens must equal the eager loop's bitwise, greedy and sampled (the
   engine's seeded Gumbel noise); on the packed routes the graph's
   launches (replays x the wrapper launches captured in one step) must be
   exactly 49 * 31 and 12 * 31 on the route.  Reported: tok/s of graph and
   eager taken in turns, ms per step, and from a ``torch.profiler`` trace
   of 8 replays (device activity) the device's busy time per step (the
   union of its events' intervals) over the step's time between CUDA
   events, the host time outside it, the device events and the B1-B4
   kernels' time per step; the same for 8 eager steps on the fp32 pack.
   One packed step captured in debug mode: its DOT dump's B1-B4 kernel
   nodes must be the step's planned CUDA launches (49 row-packed, 12
   fused-MLP kernels, 61 ordered sums);
8. speculative: full-width ``vusa_edge`` on weights with the tier
   structure of ``tests/test_spec_decode.py`` (a 1 % core and a 14 %
   detail tier), B = 1, ``draft_k`` 4, drafter at 99 % sparsity, 32 new
   tokens, the verifier dense and packed with fp32 and with int8 values:
   speculative tokens (one round a graph replay) must equal plain graph
   decode's bitwise, greedy and sampled.  Reported: acceptance, rounds,
   tok/s in turns, and on the packed routes one drafter step's and one
   5-token verify's device time (B1-B4 kernels and all) from a trace of 3
   of each;
9. scheduler: continuous batching over phase 4's weights, bf16 activations,
   ``max_len`` 256, 8 slots, segments of 8 steps (the pool step, all 8
   rows, captured in a CUDA graph and replayed).  Traffic from a numpy
   seed: 24 requests, prompts of 8-160 tokens (a third behind one shared
   64-token prefix, two repeating an earlier prompt whose length is not a
   multiple of the page, with another seed), 8-64 new tokens, no EOS.
   Gates: the pool step's row i at 8 rows bitwise equal to a B = 1 step on
   the same cache row, dense and packed fp32/int8/int4, slot pool and
   paged pool; under sequential admission (arrivals over 0-0.25 s) every
   completion bitwise equal to one-shot ``generate`` of its prompt at B = 1
   with its seed, dense and fp32 greedy and sampled, int8 greedy, and the
   graph's B1-B4 launches exactly segments x 8 x (49, 12) on the route;
   the paged pool (no prefix cache, no chunking, worst-case arena) bitwise
   equal to the slot pool under batched admission, all arrivals at 0,
   dense and fp32; ``prime_many`` rows against ``prime`` in fp32 within
   1e-3 of the largest logit on a 2-layer cut, the gap at 4, 8 and 12
   layers reported beside a witness with no padding (the same prompt twice
   in a batch of 2): the random deep model amplifies the row count's
   rounding (ROADMAP C6, C9); the paged pool with the
   prefix cache, pages of 16, chunks of 64 and an arena small enough to
   preempt (fp32, arrivals over 0-0.25 s): every request OK with its
   ``max_new`` tokens, the host mirrors equal to the device's tables at
   every sync, prefix hits, copy-on-write copies, prefill chunks and
   preemptions each above 0, its token agreement with the slot pool
   reported.  Reported: ``stats()`` (sustained tok/s, TTFT and ITL p50 /
   p99, slot occupancy, HBM bytes per active request, prefix hit rate),
   the pool step's ms per step beside one-shot ``generate``'s at B = 8
   (dense and fp32, in turns), the pool's memory and the phase's seconds;
10. speculative scheduler: phase 9's pool (8 slots, segments of 8
   rounds) and 24-request traffic under sequential admission (each
   request primed alone at its exact length, on both pools), on phase
   8's tiered weights cut to their first ``SPEC_SCHED_LAYERS`` (6 of 12:
   every layer alike, and at 12 the phase's 24 scheduler runs took 154-181
   s of the script's 1200), bf16 activations, ``max_len`` 272 (a segment of
   rounds writes 8 x 5 rows), ``draft_k`` 4, the drafter at 99 %
   sparsity; the verifier dense and packed with fp32 and int8 values.
   Each round is one replay of the pool's captured speculative round:
   4 drafter steps on every slot, one verify of 8 x 5 rows through
   B1-B4, the accept scan.  Gates, greedy and sampled, slot and paged
   pool (pages of 16, no prefix cache): every completion bitwise the
   plain scheduler's on the same pool and route; paged bitwise the slot
   pool; the pool graph's B1-B4 launches exactly rounds x (4 x (25, 6)
   on the float route + (25, 6) on the verifier's); launch counts set to
   0 before the phase and B1-B4 counted on the float and int8 routes
   after it.  Reported: acceptance, ``stats()`` beside the plain
   scheduler's, ms per pool round (CUDA events, slot and paged) beside a
   plain pool step at the same ``max_len``;
11. failure model: phase 9's model and traffic, fp32 values, sequential
   admission, each fault a run of its own against a clean run: value
   NaNs in the pack (the guard trips in the replayed packed pool graph,
   the pack is quarantined, the pool replays its dense twin, each tripped
   request completes FAILED_FALLBACK_OK with the dense scheduler's tokens,
   bitwise); cache poison of two requests on a dense engine, slot pool and
   paged pool (retried without quarantine, every request's tokens clean);
   a persistent poison (FAILED after one retry); the speculative
   verifier's quarantine (dense, bitwise the dense scheduler at
   ``max_len`` 272); the journal with an unclean close after 5 syncs and
   ``AsyncEngine.recover`` (completions bitwise a crash-free run); the
   watchdog (3 s) on a transient hang (re-queued, tokens bitwise); a hot
   swap through ``AsyncEngine`` to a 90 %-pruned pack and back (wave 1 in
   flight at the swap, nothing dropped, wave 2 bitwise a fresh engine on
   the new pack, the two fingerprints journaled).  Reported: the phase's
   seconds;
12. train: ``vusa_edge`` at full width and depth (12 layers, d 768, ff
   3072, vocab 32000, bf16 activations, remat) trained through the port's
   ``Trainer`` from the numpy-seeded init on the launcher's learnable
   stream (tokens from [0, 256), global batch 8, seq 128), 200 steps at
   lr 1e-3 (warmup 20, cosine), pruning ramped to 0.85 between steps 40
   and 140, masks refreshed every 10 steps, a checkpoint at step 180 under
   ``build/``.  Gates: the mean loss of the last 10 steps at least 1 nat
   below that of the first 10; ``tree_sparsity`` within 0.02 of 0.85;
   a second trainer restored from the step-180 checkpoint and run to the
   end equal to the uninterrupted run bitwise (params, moments, step).
   Reported: ms per step from CUDA events (the step alone, and the whole
   loop iteration with and without the mask-refresh steps; median and
   p90), tokens/s, the trainer's peak memory (above what the earlier
   phases hold), losses, sparsity, checkpoint and restore seconds.  Then
   the trained weights are served: packed with fp32 and int8 values, layer 0's packs and the head through B1-B4 against their
   plain versions at phase 3's tolerance (B = 1, 4, 5, 40, fp32 and bf16
   activations, rows bitwise B = 1); packed and dense greedy tokens equal
   in fp32 on the 2-layer cut (both value routes); reported without a
   gate beside the random-weight numbers of phases 4, 8 and 9: fp32
   full-depth token agreement, B = 1 speculative acceptance with the 99 %
   drafter (fp32 verifier; prompts from phase 8 and from the training
   stream), and ``prime_many`` vs ``prime`` at 2 and 12 layers (C9);
13. families: the decoder-only families at their published widths, each
   drawn on the card from a seed (std over the dims each weight contracts;
   every QKV bias and norm scale drawn too, so a misplaced one shows) and
   pruned to 85 %.  ``qwen2_0_5b`` whole (24 layers, d 896, 14 heads over
   2 KV heads, ff 4864, QKV biases, a tied head of 151936) and
   ``qwen3_8b`` (d 4096, ff 12288, qk norms, an untied head of 151936)
   cut to 2 of its 36 layers: ``Engine(packed_weights="all").generate``,
   B = 4, prompt 32, 32 new tokens, counted in the eager loop (launch
   counts set to 0 just before and read just after: exactly
   ``planned_launches`` x 31, B1 4 a layer plus the untied head, B2 one a
   layer, on the value route, CUDA launches as planned), then the graph
   loop, tokens bitwise the eager loop's and its launches replays x
   captured; fp32 values (both) and int8 (qwen2); layer 0's projections,
   MLP and the head through phase 3's checks and timings at these shapes
   (fp32, int8 and int4 values, the int4 and qwen3's int8 from a repack of
   layer 0), and ``internlm2_1_8b``'s untied head (2048 -> 92672) alone; in
   fp32 the first step's packed and dense logits within 1e-2 of the
   largest, and on a 2-layer cut packed and dense greedy tokens identical.
   ``olmoe_1b_7b`` (d 2048, 64 experts, top-8, ff 1024, vocab 50304, the
   published ``moe_cf`` 1.25) cut to 4 of 16 layers: dense ``generate``
   eager and graph bitwise; stepwise decode against the teacher-forced
   forward at B = 1 in fp32 with a dropless ``moe_cf`` (8.0) within 2e-3
   of the largest logit (``tests/test_models.py``'s check); 8 of phase 9's
   requests under sequential admission on the slot pool, every completion
   bitwise one-shot ``generate`` at B = 1.  ``paligemma_3b`` (MQA, head
   width 256, ff 16384, vocab 257216) cut to 2 of 18 layers, with 256
   seeded patch embeddings: ``generate`` eager and graph bitwise; the
   prefill's logits against the forward's last text logit in fp32 within
   2e-3.  Reported: tok/s and ms per step (graph and eager), peak memory,
   byte ratios, B1-B4 per decode step at these shapes beside the plain
   version, the library call and the bound, the phase's seconds (at most
   200);
14. recurrent and enc-dec families, every width as published, drawn on the
   card from a seed (the zeros leaves from normal(0, 0.5), the ones leaves
   ``A_log``, ``D``, ``lam`` from normal(1, 0.5)), dense (the reference
   packs only the dense family, so no B1-B6 kernel lies on this path):
   ``recurrentgemma_9b`` (d 4096, 16 heads over 1 KV head of 256, ff
   12288, RG-LRU width 4096, vocab 256000, window 2048) cut to 5 of 38
   layers, one scanned group (rglru, rglru, attn) and the two-layer rglru
   tail; ``mamba2_2_7b`` cut to 16 of 64 layers (d 2560, inner 5120, 80
   heads, state 128, chunks of 256, vocab 50280 padded to 50304: no token
   choice reaches a padding id, C17); ``whisper_tiny`` whole (4 + 4
   layers, d 384, 6 heads, ff 1536, vocab 51865, 1500 seeded frames).
   Gates: ``generate`` (B = 4, prompt 32, 32 new tokens, bf16) through the
   CUDA graph bitwise the eager loop, greedy and sampled, tokens finite
   and in range; in fp32 the stepwise decode (a captured step replayed
   with the next token) against the teacher-forced forward within 2e-3 of
   the largest logit over 2,100 positions (recurrentgemma: the 2048-row
   ring wraps and the local mask bites), 600 (mamba2: three SSD chunks of
   256, the last padded) and 32 (whisper, over 1500 frames); for the two
   recurrent families the pool step's rows at 4 slots bitwise B = 1 steps
   and 8 of phase 9's ragged requests through ``Scheduler.run`` on 4
   slots, every completion bitwise one-shot ``generate`` at B = 1.
   Reported: graph and eager tok/s and ms per step in turns, priming
   seconds, peak memory, the scheduler's stats and the pool's ms per
   step, the B1-B6 launch counts of the phase (0), the phase's seconds
   (at most 200);
15. the (data, model) mesh: four ranks (``launch/mesh.spawn``), processes
   that share this card over the gloo backend, built kernels loaded, not
   rebuilt, the world phase 17 runs on next (``world_phases``: one spawn,
   after phase 16; each phase's seconds are its slowest rank's part and
   its gates, phase 17's with its oracles); a 2x2 mesh, its ``model`` sub-mesh (1x2), its ``data``
   sub-mesh (2x1) and a 1x4 mesh over the same ranks, each held against
   the single-device port in this process.  Gates: at 1x2 and 1x4, layer
   0's wq, fused MLP and head of full-width ``vusa_edge`` (phase 4's
   weights, fp32 and int8 values, each rank's windows cut once, the
   250-window head padding to 252 at 1x4), each sharded B1/B3 call and
   each gathered-partial B2/B4 call bitwise its single-device call (the
   tensor-parallel ``generate`` runs are phase 17's: with the dense
   products tensor-parallel, prefill and the ordered sums round apart from
   one device); at 2x1 (a captured step per rank from its embedding rows,
   the embedding's gathers made before and the logits gathered after each
   replay) and 2x2 (its 12-layer run is phase 17's), ``vusa_edge`` drawn
   with the contracted fan-in (C6) and fp32 values gives tokens equal to
   one device's on the 2-layer cut, greedy and sampled, and at 6 layers
   (2x1, ``MESH_DP_LAYERS``) a first-step logit gap within 1e-3 of the largest (each data rank
   prefills its own rows, C9); the scheduler on 2x2 (the 2-layer cut,
   phase 9's 24 requests on 8 slots, sequential admission) completes every
   request bitwise as one device's on the slot pool and on the paged pool
   without the prefix cache, at their staggered arrivals with every rank on
   rank 0's clock, and on the paged pool with the prefix cache (every
   arrival at 0), with prefix hits on the mesh (the rank-aware
   ``BlockAllocator`` matching);
   ``qwen2_0_5b`` at its published widths on 1x4 takes the
   sequence-sharded prefill attention (14 heads over 2 KV heads do not
   divide 4) and pads its 38 ff windows to 40, with a first-step logit
   gap within 1e-3 at 6 of its 24 layers (``MESH_QWEN2_LAYERS``; this cut
   and ``MESH_DP_LAYERS`` keep the phase within its 150 s on a slow host)
   and tokens equal on the 2-layer cut; training full-width ``vusa_edge``
   (batch 8 x 128; its 1x2 run is phase 17's, tensor-parallel):
   on 2x1, each step taken from one device's
   state (lockstep, on two of the ranks; each layer's leaves gathered at
   use, their gradients reduce-scattered in rank order), the loss
   is within 1e-4 relative of one device's step, each rank's updated
   shards (params and both moments) are bitwise one device's step over the
   same batch in two microbatches, the ranks' rows, the global norm (an
   ordered sum of the shards' squares) within 1e-6 of that step's, the
   collectives a step as ``TPPlan.train_collectives`` predicts and the
   FSDP gates (``fsdp_check``) met; a checkpoint written on
   2x2, from the shards one leaf at a time (each leaf gathered whole to
   the first rank's host, written, dropped), restores bitwise on one
   device, its files (every leaf and the manifest) are byte for byte one
   device's save of the gathered tree, no rank's card peak during the
   save passes its state plus the largest leaf, and the writer's host
   peak (``tracemalloc``) stays within that leaf, one shard and 64 KiB.
   Reported, beside the card's name and power limit: ms a step,
   tok/s, collectives and bytes a step a rank, peak memory a rank, the
   phase's seconds (at most 150);
16. leftovers and cost tools (at most 60 s): (a) 2:4 packs
   (``ops.pack_linear_rows_nm``: n 2, block 4, a 16; the slot axis held
   to its bound, 64) of layer 0's wq (768 -> 768) and the head (768 ->
   32000), drawn dense, with fp32, int8 and int4 values, through B1 / B3
   at phase 3's B and activations: kernel vs plain within 1e-4 of the
   largest, the fp32 packs against ``x @ masked`` at rtol / atol 1e-4,
   CUDA launches as ``row_plan`` plans, rows bitwise B = 1; byte ratio,
   jobs and phase 3's timings (the library call on the masked dense
   weight).  (b) the legacy MLP-only pack (``pack_lm_mlps``, m 128, a 16)
   of phase 4's weights in fp32 through ``lm_decode_step_packed``: one
   step counted, B1 exactly 3 launches a layer (36 at 12 layers), B2
   none, CUDA launches as planned; its first-step logits against the
   fused MLP pack (``pack_lm_weights(scope="mlp")``) from one prefill
   within 1e-4 of the largest on the 2-layer cut and 1e-2 at 12 (C6), and
   on the cut greedy tokens identical over 31 steps.  (c) the dry run
   (``launch/dryrun.py``) of ``vusa_edge``'s decode step (B = 4, max_len
   64), prefill (B = 4, 32 tokens) and phase 12's train step (8 x 128)
   on a 1x1 mesh against the same calls on the card: the traced argument
   bytes equal to the tensors' bytes and to the allocator's requested
   bytes for them, the traced ``dot_flops`` equal to ``FlopCounterMode``'s
   count of the real call, the real call's peak above its arguments
   (``max_memory_allocated``) within 0.8-1.25 of the traced
   ``temp_size_in_bytes``; the real call's ms (CUDA events, 5 calls)
   beside ``roofline.analyze_record``'s bound (H100 data-sheet peaks);
17. tensor-parallel dense compute on sharded dense storage and
   tensor-parallel training (at most ``TP_PHASE_LIMIT_S``): phase 15's
   four ranks, on after its part.  (a)
   ``qwen3_8b`` at its full 36 layers and widths, fp32 (the flash
   attention's probabilities too, as phase 13's fp32 gates), dense route,
   drawn with the contracted fan-in (C6) leaf by leaf in chunks
   (``sharded_init``: each rank keeps its shard under the serving
   engine's placement, one device in this process keeps every chunk
   first, then frees it), on a 1x4 mesh, ``generate`` B = 4, prompt 32, 8
   new tokens; gates: first-step logits within 1e-3 of the largest of one
   device's, the first greedy token equal, each rank's peak memory at most
   0.3x one device's (each above what its process held before).  (b)
   ``vusa_edge`` drawn the same way, pruned, at 2 and 12 layers on 1x2
   (the 2x2 mesh's ``model`` sub-mesh), 1x4 and 2x2, dense route and
   packed with fp32 and int8 values (B1-B4: q, k, v and ``wo`` from each
   rank's heads, the MLP and head through the sharded appliers), 8 new
   tokens greedy with fp32 probabilities; at 12 layers also the dense
   route sampled (T = 0.8) on 1x2 and with the engine's default bf16
   probabilities on 1x2 and 1x4; gates: tokens equal one device's at both
   depths, greedy and sampled, first-step logits within 1e-3 of the
   largest (bf16 probabilities: within ``TP_BF16_TOL``, set from the
   readings), the packed runs through B1/B3, the window-partial kernel and
   the ordered sum.  Every run: every rank's tokens and first-step logits
   bitwise rank 0's, each rank's dense bytes the placement arithmetic
   (``dist.tp.placement_bytes``), and its collectives a decode step the
   prediction (``tp_predicted``: on ``model`` 2 a layer plus 2 on either
   route).  Reported: ms a step and tok/s of each mesh and route beside
   one device's, collectives and bytes a step, peak memory, the phase's
   seconds.  (c) tensor-parallel training (``dist.tp.training_plan``),
   fp32 with fp32 attention probabilities, the contracted fan-in, one
   device's oracle beside it: (c1) ``vusa_edge`` at its 12 layers, batch
   8 x 128, remat, on 1x2, 1x4 and 2x2, 3 steps each taken from one
   device's state (as phase 15's 2x1 lockstep; each rank computes one
   device's step beside its own, the state is 2.6 GB): the loss within
   1e-4 relative of one device's step, the global norm within 2e-3, each
   rank's gradient shard within 2e-3 of the largest |g| of one device's
   matching slice, every rank's loss and norm and its data coordinate's
   replicated-leaf gradients bitwise, the collectives a step the plan's
   prediction (``TPPlan.train_collectives``, remat's recompute included),
   the masks refreshed leaf by leaf at step 2 bitwise one device's; then
   20 free-running steps on 1x2 with pruning refreshed at steps 8 and 16
   (each rank drawing only its shards, ``sharded_init`` at the trainer's
   placement): the sparsity at its target, the final loss within 2 % of
   one device's 20-step run (in this process, beside the ranks), and the
   pruned shards served as they are by ``Engine(mesh=1x2,
   packed_weights="all")`` with fp32 values (B = 4, prompt 32, 8 new
   tokens): first-step logits within 1e-3 of the largest of one device's
   engine on the gathered tree, B1/B2 launches as planned (49 B1 calls, 12
   window-partial and 12 ordered-sum calls a step), token agreement
   reported.  (c2) ``qwen3_8b`` at its widths, 4 of its 36 layers
   (``TPT_CUT_WHY``), batch 4 x 128, on 1x4, one step, each rank drawing
   only its shards: the loss and norm as in (c1) against one device's
   step (in this process, before the ranks, then freed), each rank's peak
   (above what its process held before) at most its placement's
   parameters, gradients and both moments plus a quarter of one device's
   peak above its own.  (c3) ``qwen2_0_5b`` at 6 of its 24 layers on 1x4,
   one lockstep step gated as (c1): its 14 heads over 2 kv heads do not
   divide 4, so training takes the sequence-sharded attention under grad.
   Phase 15's 1x2 training moved here: with the products tensor-parallel
   it is one device's within rounding, not bitwise.  (d) expert
   parallelism for the moe family (``dist.tp`` plans with
   ``TPPlan.experts``: a rank stores and runs 16 of the 64 experts on
   1x4), fp32, fp32 attention probabilities, the contracted fan-in, one
   device's oracles first (in this process, then freed; (d3)'s gradients
   handed to the ranks as a ``.npy`` file a leaf, each rank reading its
   slices): (d1)
   ``olmoe_1b_7b`` at its full 16 layers and widths, the published
   ``moe_cf`` 1.25, on 1x4, ``generate`` B = 4, prompt 32, 16 new tokens
   (capacity 1 at the decode steps: drops); gates: layer 0's routing
   integers of the first decode step bitwise one device's, first-step
   logits within 1e-4 of the largest, each rank's peak (draw and run) at
   most 0.3x one device's, every rank's bits rank 0's, the stored bytes
   the placement's, 34 collectives a step; (d2) ``moonshot_v1_16b_a3b``
   (vocab 163840, top-6) at 4 of its 48 layers (``EP_CUT_WHY``), the same
   gates; (d3) ``olmoe``'s training step, 8 x 128, remat, from the draw:
   on 1x4 at 2 layers the loss within 1e-5 relative and each gradient
   shard within 1e-4 of the leaf's largest |g| of one device's step; on
   2x2 at 2 layers (the batch split over ``data``: C16's whole-batch
   routing) at 4 layers (each rank gathering one layer's leaves over
   ``data`` at a time) the norm and shards within C13's 2e-3 and layer 0's
   routing integers one device's rows; the collectives as
   ``TPPlan.train_collectives`` predicts; the 1x4-trained shards served
   on 1x4 give one device's tokens on the gathered tree.  Every training
   part with a ``data`` axis ((c1) on 2x2, (d3), (e2), (f2)) also meets
   the FSDP gates (``FSDP_BOUND_TERMS``, ``fsdp_check``): its gathers over
   ``data`` and their reduce-scatters, counts and bytes, as
   ``TPPlan.fsdp_traffic`` predicts, at most two layers' leaves and the
   top-level leaves gathered at once, and (d3), (e2), (f2) each rank's
   card peak above its state at most the predicted bound.  (e) tensor
   parallelism for the vlm, hybrid and ssm families (``TPPlan.ssm``: a
   rank runs 20 of Mamba-2's 80 SSM heads on 1x4, ``TPPlan.rglru``: 1024
   of the RG-LRU's 4096 channels; paligemma's and recurrentgemma's one kv
   head keeps attention whole), fp32, fp32 attention probabilities, the
   contracted fan-in, one device's oracles first (then freed; (e2)'s
   gradients handed to the ranks through files), its own limit of
   ``TPR_PHASE_LIMIT_S``: (e1) ``paligemma_3b`` whole (18 layers, 256
   seeded stand-in patches, prompt 32, 8 new tokens), ``mamba2_2_7b``
   at 16 of 64 layers (prompt 8, 4 new), ``recurrentgemma_9b`` at 8 of 38
   layers (two groups and the 2-layer RG-LRU tail, ``TPR_CUT_WHY``),
   ``generate`` B = 4 on 1x4; gates: first-step logits within 1e-4 of
   the largest of one device's, tokens equal, every rank's bits rank 0's,
   the stored bytes the placement's, each rank's peak at most 0.3x one
   device's, the collectives a decode step
   ``TPPlan.decode_collectives``'; (e2) one step from the draw
   (``TPR_TRAIN``): paligemma at 2 layers and mamba2 at 4 on 1x4 and
   2x2, 8 x (256 patches +) 128, remat, each the Trainer's step, and
   recurrentgemma at 3 layers on 1x4 and 2x2, the loss and its gradients
   under the plan (summed over ``data`` as the step sums them); gates
   (d3)'s: the loss within 1e-5 relative, each gradient
   shard within 1e-4 (1x4) or C13's 2e-3 (2x2) of the leaf's largest |g|,
   the collectives as ``train_collectives`` (``grad_collectives``)
   predicts; mamba2's 1x4-trained shards served on 1x4 give one device's
   tokens on the gathered tree.  (f) tensor parallelism for the encdec
   family (``whisper_tiny`` whole: 4 + 4 layers at its published widths;
   its 6 heads split on 1x2 and 2x2 and stay whole on 1x4, where the
   encoder's full-mask attention is sequence-sharded, 375 frames a rank),
   fp32, fp32 attention probabilities, the contracted fan-in, 1500 seeded
   stand-in frames, one device's oracles first (then freed; (f2)'s
   gradients handed to the ranks through files), its own limit of
   ``ENC_PHASE_LIMIT_S``: (f1) ``generate`` B = 4 (8 prompt tokens, which
   the prefill drops, C12; 8 new) on 1x2, 1x4 and 2x2; gates: first-step
   logits within 1e-4 of the largest of one device's, tokens equal, every
   rank's bits rank 0's, the stored bytes the placement's, the
   collectives a decode step ``TPPlan.decode_collectives``'; (f2) one
   Trainer step of 4 x 128 tokens over the 1500 frames, remat, from the
   draw on 1x4 and 2x2; gates (e2)'s, the collectives
   ``train_collectives(frames=1500)``'.  Reported beside the
   card: ms a step against one device's, collectives and bytes a step a
   rank, peak memory a rank, each part's seconds;
18. one JSON line of every ported kernel (B1-B4 per decode step at B = 4,
   launches in the counted run and per decode step, the graph run's
   launches, phase 10's speculative pool graph launches, CUDA launches per
   call as counted, and under ``families`` the same per decode step of
   phase 13's qwen2 and qwen3 with their counted launches, and under
   ``mesh_launches_per_step_per_rank`` phase 17's launches a rank; B5/B6
   per ResNet-18 image, MobileNetV1 under ``mobilenetv1``);
19. the card line again and the result line.

TF32 is switched off explicitly: every dense fp32 product here is true fp32.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import faulthandler
import filecmp
import functools
import gc
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pruning import masks_tree, prune_tree  # noqa: E402
from repro_torch.core.simulator import gemm_cycles_standard, ws_cycles  # noqa: E402
from repro_torch.core.vusa import schedule_widths_fast  # noqa: E402
from repro_torch.core.workloads import mobilenetv1_gemms, resnet18_gemms  # noqa: E402
from repro_torch.kernels import build, mlp_plan, ops, ref, row_plan, tile_plan  # noqa: E402
from repro_torch.kernels.dense_matmul import (  # noqa: E402
    cuda_launches as dense_cuda_launches,
    dense_matmul,
    reset_launch_counts as reset_dense_counts,
)
from repro_torch.kernels.vusa_packed import (  # noqa: E402
    cuda_launches as packed_cuda_launches,
    empty_kernel,
    reset_launch_counts,
    vusa_fused_mlp_matmul,
    vusa_fused_mlp_partials,
    vusa_packed_matmul,
    vusa_window_sum,
)
from repro_torch.checkpoint.ckpt import restore, save as ckpt_save  # noqa: E402
from repro_torch.data.pipeline import SyntheticDataset  # noqa: E402
from repro_torch.dist import comm  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    _batch_axes,
    local_shard,
    params_shardings,
    shard_ranges,
    shard_tree,
)
from repro_torch.dist.tp import WholeView, placement_bytes, storage_placements  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, spawn  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from repro_torch.optim import AdamState, adamw_init  # noqa: E402
from repro_torch.kernels.vusa_spmm import (  # noqa: E402
    cuda_launches as spmm_cuda_launches,
    reset_launch_counts as reset_spmm_counts,
    vusa_spmm,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.common import mesh_context, strict_fp32  # noqa: E402
from repro_torch.models.cache import (  # noqa: E402
    PagedLayout,
    bind_slot_pages,
    init_paged_pool,
    paged_view,
    write_prefill_pages,
    write_slots,
)
from repro_torch.optim.adamw import tree_items  # noqa: E402
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig  # noqa: E402
from repro_torch.serve.packed import (  # noqa: E402
    _as_linear,
    _flat_attn,
    _flat_entries,
    lm_decode_step_packed,
    packed_byte_ratios,
    qdq_lm_params,
)
from repro_torch.train import TrainConfig, Trainer, TrainHParams  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
TF32_PASSES = 3  # B5/B6 run three TF32 products per fp32 one (3xTF32)
TOL = 1e-4  # kernel vs plain, of the largest plain output
SPIN_CYCLES = 1_000_000  # the timer's device spin before each timed call (--spin-cycles)
BATCH, PROMPT, MAX_NEW = 4, 32, 32
DEPTH_CUT = 2  # layers of the fp32 token-identity check
FP32_STEP_TOL = 1e-2  # fp32 first-step logits, packed vs dense, of the largest logit
DEVICE = "cuda"
QDTYPES = ("int8", "int4")
DRAFT_K, DRAFT_SPARSITY = 4, 0.99  # the speculative phase's drafter
VERIFY_ROWS = DRAFT_K + 1  # rows of the batched verify: contract 1 is checked there too
PROFILED_STEPS = 8  # decode steps (graph replays) under the profiler per trace
LIBRARY_KERNELS = ("row_packed_kernel", "fused_mlp_kernel", "sum_slices_kernel")
# the scheduler phase: pool geometry, traffic and the paged pool's settings
SCHED_MAX_LEN, SCHED_SLOTS, SCHED_SEGMENT = 256, 8, 8
SCHED_REQUESTS, SCHED_PREFIX, SCHED_PROMPTS, SCHED_NEW = 24, 64, (8, 160), (8, 64)
SCHED_ARRIVALS_S = 0.25  # arrival offsets are drawn over [0, this)
SCHED_PAGE, SCHED_CHUNK, SCHED_ARENA = 16, 64, 48  # the preempting paged run
SCHED_SEED = 3
PRIME_TOL = 1e-3  # prime_many vs prime, fp32 logits, of the largest (2-layer cut)
# the speculative scheduler phase: phase 9's pool and traffic; max_len covers
# the longest request plus a segment of rounds, SCHED_SEGMENT x VERIFY_ROWS rows
POOL_VERIFY_ROWS = SCHED_SLOTS * VERIFY_ROWS  # the pool verify's rows through B1-B4
SPEC_MAX_LEN = 272
# phase 10's depth: its 24 scheduler runs at the model's 12 layers took
# 154-181 s of the script's 1200 on slow hosts; every layer is alike
SPEC_SCHED_LAYERS = 6
WATCHDOG_S = 3.0  # the failure phase's watchdog: well past a sync gap of phase 9's traffic
# the train phase: the launcher's learnable stream, the pruning ramp, the resume point
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_TOKENS = 200, 8, 128, 256
TRAIN_LR, TRAIN_WARMUP = 1e-3, 20
# no global-norm clip: the init's embedding (std 1/sqrt(32000)) gives the first
# norm grads near 4e7, and a clip at 1.0 leaves every other leaf's grads far
# below AdamW's eps (1e-8), so only the embedding would learn
TRAIN_CLIP = float("inf")
TRAIN_PRUNE = (40, 140, 10)  # begin, end, every: the ramp ends at cfg.sparsity
TRAIN_RESUME_AT = 180  # the one checkpoint; a mask-refresh step, so resume is bitwise
TRAIN_LOSS_DROP = 1.0  # nats: mean of the first 10 steps' losses minus the last 10's
TRAIN_SPARSITY_TOL = 0.02
TRAIN_DIR = ROOT / "build" / "train_ckpt"
# paper workloads: (name, GEMMs, pruning rate); the seed of weights and x
PAPER_MODELS = (("resnet18", resnet18_gemms, 0.85), ("mobilenetv1", mobilenetv1_gemms, 0.75))
PAPER_SEED = 0
EXACT_TOL = 1e-3  # kernels vs x @ w in fp32, of the largest |x @ w| (at least 1)
VUSA_NMA = (3, 6, 3)  # the paper's VUSA 3x6: N rows, M SPEs, A MACs
# the families phase: depth cuts (None: full depth), the seed of the weights,
# the std of the drawn biases and norm scales, the fp32 decode / prefill vs
# forward tolerance (of the largest logit, tests/test_models.py's check at
# full width), the MoE scheduler's requests and the phase's time limit
FAM_DEPTH = {"qwen2_0_5b": None, "qwen3_8b": 2, "olmoe_1b_7b": 4, "paligemma_3b": 2}
FAM_CUT_WHY = {  # every cut is of depth, never of a width
    "qwen3_8b": "2 of 36 layers: at 36 the fp32 weights are 33 GB and each stacked MLP leaf "
                "holds 1.8 G entries to sort whole and pack on the host, in a 200 s phase",
    "olmoe_1b_7b": "4 of 16 layers: at 16 the stacked expert leaf holds 2^31 entries, past "
                   "the int32 index range of one pruning sort, and 4 fit the phase's 200 s",
    "paligemma_3b": "2 of 18 layers: the phase's 200 s; its layers are all alike",
}
FAM_SEED = 0
FAM_PERTURB_STD = 0.5
FAM_TF_TOL = 2e-3
FAM_SCHED_REQUESTS = 8
FAM_PHASE_LIMIT_S = 200.0
# the recurrent and enc-dec families phase (14): depth cuts (None: whole), the
# teacher-forced positions of the fp32 decode-vs-forward gate (the ring past
# its 2048 rows; three SSD chunks of 256, the last padded), the scheduler's
# slots and the phase's time limit
REC_ARCHS = ("recurrentgemma_9b", "mamba2_2_7b", "whisper_tiny")
REC_DEPTH = {"recurrentgemma_9b": 5, "mamba2_2_7b": 16, "whisper_tiny": None}
REC_CUT_WHY = {  # every cut is of depth, never of a width
    "recurrentgemma_9b": "5 of 38 layers: one scanned group (rglru, rglru, attn) and the "
                         "two-layer rglru tail, so both code paths and every layer kind run; "
                         "at 38 the fp32 weights are about 42 GB and the 2,100-position "
                         "decode would not fit the phase's 200 s",
    "mamba2_2_7b": "16 of 64 layers: its layers are all alike, and at 64 the 600-position "
                   "teacher forcing and the scheduler took about 35-45 s more of the "
                   "script's 1200; no token choice reaches the 24 padding ids of its "
                   "50304-wide head (C17, repaired), so the range gate holds at any depth",
}
REC_TF_POSITIONS = {"recurrentgemma_9b": 2100, "mamba2_2_7b": 600, "whisper_tiny": MAX_NEW}
REC_SCHED_SLOTS = 4
REC_PHASE_LIMIT_S = 200.0
# the mesh phase (15): its meshes, value routes and temperatures, the logit
# tolerance where prefill or attention runs over other row counts (C9), the
# training runs and the phase's time limit
MESH_DIR = ROOT / "build" / "mesh"
MESH_TP, MESH_DP = ("1x2", "1x4"), ("2x1", "2x2")
# the wrappers' route of each packed value route (bf16 keeps the fp32 params'
# own values)
ROUTE_KIND = {"bf16": "dense", "int8": "int8"}
MESH_TEMPS = (0.0, 0.8)
MESH_LOGIT_TOL = 1e-3  # first-step logits, of the largest: data split and qwen2
# phase 15's depth cuts (every width whole), for the phase's 150 s on a
# slow host: qwen2 (of 24), the 2x1 run beside the 2-layer cut (of 12)
MESH_QWEN2_LAYERS = 6
MESH_DP_LAYERS = 6
# 8 lockstep steps (20 took about 40 s of the script's 1200 on a slow host;
# every step is alike: the same gates each step)
MESH_TRAIN_STEPS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 8, 8, 128
MESH_TRAIN_LAYERS = DEPTH_CUT  # full width; each step gathers a layer's leaves at a time
# the 2x1 lockstep's global norm against the microbatched step's, relative:
# an ordered sum of the shards' squares, not one device's sum over each
# whole leaf (the shards and moments stay bitwise: the clip is off, C10)
MESH_NORM_TOL = 1e-6
MESH_TRAIN_PRUNE = (4, 16, 4)  # begin, end, every
MESH_TRAIN_TOL = 1e-4  # 2x1 loss each step from one device's state, relative
MESH_CKPT_STEPS = 1
# every collective crosses host memory and the ranks share the host's cores
# with this process (PERF.md §5, the mesh)
MESH_PHASE_LIMIT_S = 150.0
# the tensor-parallel phase (17): (a)'s arch and new tokens, (b)'s routes
# (dense, packed fp32 and int8 values) and depths, its full-depth runs
# beyond the greedy fp32-probability grid (mesh, temperature, the flash
# attention's probabilities in bf16, the engine's default) and their
# tolerance, the memory ratio a rank against one device, the entries of a
# drawn chunk and the phase's time limit
TP_DIR = ROOT / "build" / "tp"
TP_ARCH = "qwen3_8b"
TP_NEW = 8
TP_ROUTES = ("dense", "bf16", "int8")
TP_DEPTHS = (DEPTH_CUT, None)
TP_EXTRA = (("1x2", 0.8, False), ("1x2", 0.0, True), ("1x4", 0.0, True))
# first-step logits of the bf16-probability runs, of the largest: about 3x
# the larger of their first readings on the card, 1.15e-4 (1x2) and
# 1.74e-4 (1x4); fp32 probabilities part 4.6e-7 (PERF.md §6)
TP_BF16_TOL = 5e-4
TP_MEM_RATIO = 0.3
TP_DRAW_ENTRIES = 1 << 25
# its part (c), tensor-parallel training: (c1) vusa_edge at 12 layers, batch
# 8 x 128, remat, lockstep steps on 1x2 / 1x4 / 2x2 and the lockstep step
# whose masks are refreshed, the free-running 1x2 run (pruning refreshed at
# steps 8 and 16, the ramp's end), its serving run; (c2) qwen3_8b's depth
# and batch; (c3) qwen2_0_5b's depth.  The gates, written before the first
# timed run: the loss of a step from one device's state within 1e-4
# relative of one device's step, the global norm within 2e-3 (C13 measured
# 1.25e-3 of the global norm from row splits alone), each rank's gradient
# shard within 2e-3 of the largest |g| of one device's matching slice, the
# free run's final loss within 2 % of one device's, the served first-step
# logits within MESH_LOGIT_TOL of the largest
# 3 lockstep steps, the masks refreshed at the last (5 took about 45 s of the
# script's 1200 on a slow host over 1x2, 1x4 and 2x2)
TPT_LOCKSTEP, TPT_REFRESH_AT, TPT_FREE_STEPS = 3, 2, 20
TPT_PRUNE = (4, 16, 8)
TPT_LOSS_TOL, TPT_NORM_TOL, TPT_GRAD_TOL, TPT_FREE_TOL = 1e-4, 2e-3, 2e-3, 0.02
TPT_QWEN3_LAYERS, TPT_QWEN3_BATCH = 4, 4
TPT_QWEN2_LAYERS = 6
TPT_CUT_WHY = {  # every cut is of depth, never of a width
    "qwen3_8b": "4 of 36 layers: one device's Adam state at 36 layers is about 131 GB of fp32, "
                "over the 80 GB card the four ranks share too",
    "qwen2_0_5b": "6 of 24 layers: the phase's time on a slow host, as phase 15's qwen2 run"}
TP_PHASE_LIMIT_S = 240.0
# its part (d), expert parallelism for the moe family (each rank E / tp
# experts): (d1) olmoe at full width and depth (16 layers, the published
# moe_cf 1.25, fp32) on 1x4, generate B = 4, prompt 32, EP_NEW new tokens;
# (d2) moonshot cut in depth (EP_CUT_WHY); (d3) olmoe training at
# EP_TRAIN_LAYERS of 16 (each mesh's depth), batch 8 x 128, remat, one step
# from the drawn state on 1x4 and on 2x2 beside one device's whole-batch
# step at that depth, the 1x4 step's shards then served on 1x4.  The gates,
# written before the first run:
# (d1)/(d2) layer 0's routing integers of the first decode step bitwise one
# device's (B = 4 gives capacity 1: drops on both), first-step logits within
# EP_LOGIT_TOL of the largest, each rank's peak at most TP_MEM_RATIO of one
# device's; (d3) on 1x4 the loss within EP_LOSS_TOL relative and each
# gradient shard within EP_GRAD_TOL of the leaf's largest |g|; on 2x2 (rows
# split over data: the C16 repair) the global norm and each gradient shard
# within C13's TPT_NORM_TOL / TPT_GRAD_TOL and layer 0's routing integers of
# the step one device's rows; the served tokens equal one device's on the
# gathered tree
EP_ARCH, EP_MOONSHOT = "olmoe_1b_7b", "moonshot_v1_16b_a3b"
EP_NEW = 16
EP_LOGIT_TOL, EP_LOSS_TOL, EP_GRAD_TOL = 1e-4, 1e-5, 1e-4
EP_MOONSHOT_LAYERS = 4
EP_TRAIN_LAYERS = {"1x4": 2, "2x2": 4}
EP_CUT_WHY = {
    EP_MOONSHOT: "4 of 48 layers: one device's fp32 tree at 48 layers is about 113 GB, over "
                 "the 80 GB card",
    "training on 1x4": "2 of 16 layers: one device's fp32 parameters, gradients and Adam "
                       "moments at 16 layers are about 111 GB; at 4 one device's gradients "
                       "for the ranks (6.5 GB, written to files beside the 2x2 step's) "
                       "cost about 6 s of the script's 1200, which part (f) needs",
    "training on 2x2": "4 of 16 layers: one device's oracle at 4 (29 GB of fp32 parameters, "
                       "gradients and Adam moments, its gradients then written to files for "
                       "the ranks) and the files' 7.5 GB more to write; each rank gathers one "
                       "layer's leaves at a time over data, where at 4 a step holding its tree "
                       "gathered over data ran the card out of memory"}
# its part (e), tensor parallelism for the vlm and recurrent families (the
# SSM's heads and the RG-LRU's channels split over model): (e1) each arch
# served on 1x4 at its published widths, (layers, prompt, new tokens) as
# TPR_SERVE (None: every layer), generate B = 4, paligemma with 256 seeded
# stand-in patches; (e2) one training step from the drawn state at
# TPR_TRAIN's depths and meshes beside one device's step (its gradients
# handed to the ranks through a file under TPR_DIR, so the card holds none of
# them while phase 17's earlier parts run), the 1x4-trained shards then
# served on 1x4.  The gates, written before the first run: (e1) first-step logits within
# TPR_LOGIT_TOL of the largest of one device's, tokens equal, every rank's
# bits rank 0's, the stored bytes the placement's, each rank's peak at most
# TP_MEM_RATIO of one device's, the collectives a decode step
# TPPlan.decode_collectives'; (e2) (d3)'s: the loss within EP_LOSS_TOL
# relative, each gradient shard within EP_GRAD_TOL of the leaf's largest |g|
# on 1x4 and within C13's TPT_GRAD_TOL on 2x2, the collectives as
# TPPlan.train_collectives (or grad_collectives) predicts; the served tokens
# one device's on the gathered tree.  The part's own time limit
TPR_ARCHS = ("paligemma_3b", "mamba2_2_7b", "recurrentgemma_9b")
TPR_SERVE = {"paligemma_3b": (None, 32, 8), "mamba2_2_7b": (16, 8, 4),
             "recurrentgemma_9b": (8, 8, 4), "whisper_tiny": (None, 8, 8)}  # (f1)'s too
# arch -> (layers, meshes, whole step, leaves not compared): a whole step is
# the Trainer's, else the loss and its gradients under the plan; TPR_SERVED's
# 1x4-trained shards are then served on 1x4
TPR_DIR = TP_DIR / "e2"
TPR_TRAIN = {"paligemma_3b": (2, ("1x4", "2x2"), True, ()),
             "mamba2_2_7b": (4, ("1x4", "2x2"), True, ()),
             "recurrentgemma_9b": (3, ("1x4", "2x2"), False, ("embed", "lm_head"))}
TPR_SERVED = ("mamba2_2_7b",)
TPR_LOGIT_TOL = 1e-4
TPR_CUT_WHY = {  # every cut is of depth, never of a width
    "mamba2_2_7b serving": "16 of 64 layers: its layers are all alike, and at 64 one "
                           "device's and the ranks' draws and 194 collectives a step took "
                           "about 20 s of the script's 1200 on a slow host",
    "recurrentgemma_9b serving": "8 of 38 layers (2 groups and the 2-layer rglru tail): one "
                                 "device's fp32 tree at 38 layers is about 42 GB, beside the "
                                 "ranks' and (d3)'s gradients held for the ranks",
    "paligemma_3b training": "2 of 18 layers: one device's parameters, gradients and Adam "
                             "moments at 18 layers are about 49 GB, and at 2 its 257216-wide "
                             "embedding and head keep a 2x2 rank near 10 GB beside (d3)'s "
                             "gradients held for the ranks",
    "mamba2_2_7b training": "4 of 64 layers: one device's parameters, gradients and Adam "
                            "moments at 64 layers are about 45 GB",
    "recurrentgemma_9b training": "3 of 38 layers (one group), on 1x4 and on 2x2 (a 2x2 rank "
                                  "gathers one layer's leaves at a time over data), the "
                                  "loss and its "
                                  "gradients without the optimizer (the Adam moments, 5.5 GB "
                                  "a rank, and the update are the other archs' steps'), "
                                  "every gradient but the embedding's and the head's (the "
                                  "vocab-parallel loss the other two archs hold) compared: "
                                  "those two are 8.4 GB of one device's 11 GB of gradients "
                                  "handed to the ranks"}
TPR_PHASE_LIMIT_S = 150.0
# the FSDP step's gates on every training part with a data axis (written
# before their first run): its fsdp-gather and reduce-scatter counts
# and bytes as TPPlan.fsdp_traffic predicts; the gathered leaves alive at
# once (comm.GATHERED) at most two layers' plus the top-level leaves'; and
# where one device's oracle measured its peak, the rank's card peak above
# what it held before the step at most FSDP_BOUND_TERMS: its gradient
# shards, three of its largest layer as the compute reads it (the leaves
# gathered twice at a recompute boundary and that layer's whole gradient),
# two of its top-level leaves (gathered, and their whole gradient), and
# one device's activations and temporaries (its peak above its own
# parameters, gradients and moments)
FSDP_BOUND_TERMS = ("grads", "3 x layer", "2 x top", "one device's activations")
# phase 17 part (f): the encdec family on the mesh, whisper_tiny whole (4 + 4
# layers, every width as published), fp32 with fp32 attention probabilities,
# the contracted fan-in, ENC_FRAMES seeded stand-in frames: (f1) generate
# B = 4 (TPR_SERVE's prompt tokens, which the prefill drops, C12, and new
# tokens) on ENC_MESHES; (f2) one Trainer step of ENC_TRAIN_BATCH x TRAIN_SEQ tokens
# over the frames, remat, on ENC_TRAIN_MESHES, one device's gradients handed
# to the ranks as files.  Gates (e)'s; the part's own time limit
ENC_ARCH = "whisper_tiny"
ENC_FRAMES, ENC_TRAIN_BATCH = 1500, 4
ENC_MESHES, ENC_TRAIN_MESHES = ("1x2", "1x4", "2x2"), ("1x4", "2x2")
ENC_DIR = TP_DIR / "f2"
ENC_PHASE_LIMIT_S = 45.0
# the leftovers phase (16): the 2:4 arm's structure and job width, the legacy
# MLP pack's first-step tolerance (of the largest logit) on the 2-layer cut
# and at full depth (C6), the dry run's cells (kind, batch, tokens) and the
# band of the card's peak above the arguments over the trace's temp bytes
NM_SHAPE, NM_A = (2, 4), 16
LEGACY_TOL_CUT, LEGACY_TOL_FULL = 1e-4, 1e-2
COST_CELLS = (("decode", BATCH, 64), ("prefill", BATCH, PROMPT), ("train", TRAIN_BATCH, TRAIN_SEQ))
COST_BAND = (0.8, 1.25)
COST_ITERS = 5
LEFT_PHASE_LIMIT_S = 60.0
# ResNet-18's layer groups by GEMM name (the 1x1 downsample convs in their group)
RESNET18_GROUPS = (("conv0", ("conv0",)),
                   ("layer1", tuple(f"conv{i}" for i in range(1, 5))),
                   ("layer2", tuple(f"conv{i}" for i in range(5, 10))),
                   ("layer3", tuple(f"conv{i}" for i in range(10, 15))),
                   ("layer4", tuple(f"conv{i}" for i in range(15, 20))),
                   ("fc", ("fc",)))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------


class Timer:
    """Device time of one call, averaged over ``iters`` launches, each after
    an L2 flush (a 128 MiB write) and a device-side spin of SPIN_CYCLES
    (about 0.5 ms by default), so the call is enqueued before its start
    event fires (a wrapper's host work is not timed, even on a slow host)
    and finds a cold L2."""

    def __init__(self, iters: int = 20):
        self.iters = iters
        self.flush = torch.empty(32 * 2**20, dtype=torch.float32, device=DEVICE)

    def __call__(self, fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / self.iters


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max(max |want|, 1))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1.0)


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pack_bytes_needed(lin) -> float:
    """Bytes a kernel must read of one pack: every position (idle slots are
    marked there), a value only where the slot is occupied (an idle slot's
    value never reaches the output; int4 holds half a byte per slot), and
    every scale of a quantized pack."""
    nnz = int((lin.positions >= 0).sum())
    per_value = 0.5 if lin.value_dtype == "int4" else lin.values.element_size()
    scales = 0 if lin.scales is None else nbytes(lin.scales)
    return nbytes(lin.positions) + per_value * nnz + scales


def dequantized_dense(lin) -> torch.Tensor:
    """The (k, c) dense fp32 weight a pack holds (quantized values as
    q * scale)."""
    vals = ref.dequantize_values(lin.values, lin.scales, lin.value_dtype)
    return ref.unpack_dense(vals, lin.positions, lin.m)[:, : lin.c].contiguous()


def pack_bytes(packed) -> int:
    """Device bytes of every pack entry: values, positions and scales."""
    return sum(nbytes(*(e[k] for k in ("values", "positions", "scales") if k in e))
               for e in _flat_entries(packed).values())


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def check_cases(name, kern, plain, xs):
    """Kernel vs plain over the activations ``xs``, plus batch invariance:
    the first and the last row at B rows equal to B = 1, bitwise."""
    cases = []
    for x in xs:
        got, want = kern(x), plain(x)
        err, rel = rel_err(got, want)
        if rel > TOL:
            fail(f"{name} x={x.dtype} B={x.shape[0]}: kernel vs plain error {err} ({rel} relative)")
        for row in ((0, x.shape[0] - 1) if x.shape[0] > 1 else ()):
            if not torch.equal(kern(x[row : row + 1].contiguous())[0], got[row]):
                fail(f"{name} x={x.dtype}: row {row} at B={x.shape[0]} differs from B=1")
        cases.append({"B": x.shape[0], "x": dtype_name(x), "max_abs_err": err, "rel_err": rel})
    return cases


def check_packed_matmul(timer, name, lin, xs, time_it):
    """B1 (float values) or B3 (int8/int4 values) at one operand set; returns
    a record (timed at ``xs[-1]``)."""
    rec = {"name": name, "shape": [lin.k, lin.c], "T": lin.values.shape[0], "S": lin.slots,
           "values": dtype_name(lin.values), "value_dtype": lin.value_dtype}
    args = (lin.values, lin.positions, lin.scales)
    kw = {"m": lin.m, "value_dtype": lin.value_dtype}

    def kern(x):
        return vusa_packed_matmul(x, *args, **kw)

    def plain(x):
        return ref.vusa_packed_ref(x, *args, **kw)

    def counted(x):  # the CUDA launches of one call, held against its plan
        c0 = packed_cuda_launches("vusa_packed_matmul")
        y = kern(x)
        got = packed_cuda_launches("vusa_packed_matmul") - c0
        want = row_plan.cuda_launches(row_plan.row_plan(lin.k), x.shape[0], y.shape[1])
        if got != want:
            fail(f"{name} B={x.shape[0]}: {got} CUDA launches, its plan takes {want}")
        return y

    rec["plan"] = row_plan.row_plan(lin.k)._asdict()
    rec["cases"] = check_cases(name, counted, plain, xs)
    if time_it:
        x = xs[-1]
        dense = dequantized_dense(lin)
        if lin.value_dtype == "dense":
            dense = dense.to(lin.values.dtype)
        xd = x.to(dense.dtype)
        nnz = int((lin.positions >= 0).sum())
        dequant_ops = 0 if lin.value_dtype == "dense" else nnz
        out_bytes = x.shape[0] * lin.values.shape[0] * lin.m * 4
        b_ms, b_by = bound_ms(nbytes(x) + pack_bytes_needed(lin) + out_bytes,
                              2 * x.shape[0] * nnz + dequant_ops)
        rec["timing"] = {
            "B": x.shape[0], "x": dtype_name(x), "ms": timer(lambda: kern(x)),
            "plain_ms": timer(lambda: plain(x)),
            "library_ms": timer(lambda: torch.matmul(xd, dense)),
            "library_call": f"torch.matmul(x, W) on the dense {dtype_name(dense)} weight",
            "bound_ms": b_ms, "bound_by": b_by, "nnz": nnz,
        }
    return rec


def check_fused_mlp(timer, name, gate, up, down_t, xs, time_it):
    """B2 (float values) or B4 (int8/int4 values) at one operand set; returns
    a record (timed at ``xs[-1]``)."""
    lins = (gate, up, down_t)
    args = (gate.values, gate.positions, up.values, up.positions, down_t.values,
            down_t.positions, gate.scales, up.scales, down_t.scales)
    kw = {"m": gate.m, "value_dtype": gate.value_dtype}
    rec = {"name": name, "d": gate.k, "ff": gate.c, "T": gate.values.shape[0],
           "S": [lin.slots for lin in lins], "values": dtype_name(gate.values),
           "value_dtype": gate.value_dtype}

    def kern(x):
        return vusa_fused_mlp_matmul(x, *args, **kw)

    def plain(x):
        return ref.vusa_fused_mlp_ref(x, *args, **kw)

    plan = mlp_plan.mlp_plan(gate.k, down_t.k)

    def counted(x):  # the CUDA launches of one call, held against its plan
        c0 = packed_cuda_launches("vusa_fused_mlp_matmul")
        y = kern(x)
        got = packed_cuda_launches("vusa_fused_mlp_matmul") - c0
        want = mlp_plan.cuda_launches(plan, x.shape[0], down_t.k, gate.values.shape[0])
        if got != want:
            fail(f"{name} B={x.shape[0]}: {got} CUDA launches, its plan takes {want}")
        return y

    rec["plan"] = plan._asdict()
    rec["cases"] = check_cases(name, counted, plain, xs)
    if time_it:
        x = xs[-1]
        wg, wu, wd = (dequantized_dense(lin) for lin in lins)
        wd = wd.T.contiguous()
        if gate.value_dtype == "dense":
            wg, wu, wd = (w.to(gate.values.dtype) for w in (wg, wu, wd))
        xd = x.to(wg.dtype)
        silu = torch.nn.functional.silu
        nnz = sum(int((lin.positions >= 0).sum()) for lin in lins)
        dequant_ops = 0 if gate.value_dtype == "dense" else nnz
        packs = sum(pack_bytes_needed(lin) for lin in lins)
        b_ms, b_by = bound_ms(nbytes(x) + packs + x.shape[0] * down_t.k * 4,
                              2 * x.shape[0] * nnz + dequant_ops)
        rec["timing"] = {
            "B": x.shape[0], "x": dtype_name(x), "ms": timer(lambda: kern(x)),
            "plain_ms": timer(lambda: plain(x)),
            "library_ms": timer(lambda: torch.matmul(silu(xd @ wg) * (xd @ wu), wd)),
            "library_call": "dense SwiGLU: three torch.matmul calls + silu",
            "bound_ms": b_ms, "bound_by": b_by, "nnz": nnz,
        }
    return rec


def activations(rng, k):
    """Phase 3's activations of width ``k``: B = 1, ``VERIFY_ROWS`` (the
    batched speculative verify), ``POOL_VERIFY_ROWS`` (the pool verify) and
    ``BATCH``, fp32 and bf16; the last is the main path's (B = 4, bf16)."""
    x1, x4 = (torch.from_numpy(rng.standard_normal((b, k), dtype=np.float32)).to(DEVICE)
              for b in (1, BATCH))
    x5 = torch.cat([x4, x1])
    x40 = torch.from_numpy(rng.standard_normal((POOL_VERIFY_ROWS, k),
                                               dtype=np.float32)).to(DEVICE)
    return [v for x in (x1, x5, x40, x4) for v in (x, x.to(torch.bfloat16))]


def kernel_phase(cfg, packs, rng):
    """Phase 3 over ``packs`` (``{"dense": bf16-path pack, "int8": ...,
    "int4": ...}`` of the model).  Returns (records, per-decode-step totals
    per route: ``{route: {kernel: {...}}}``)."""
    timer = Timer()
    dev = torch.device(DEVICE)

    def xs_for(k):
        return activations(rng, k)

    def bf16_copy(lin):
        return dataclasses.replace(lin, values=lin.values.to(torch.bfloat16))

    def sparse(k, c, s):
        w = rng.standard_normal((k, c), dtype=np.float32)
        return w * (rng.random((k, c)) >= s)

    d, L = cfg.d_model, cfg.n_layers
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    records, step = [], {}
    for route, packed in packs.items():
        tag = "" if route == "dense" else f" {route}"
        mlp = packed["mlp"]
        # main-path shapes, timed: the model's own layer-0 packs and its head
        attn_recs = [check_packed_matmul(timer, f"{n}[layer0]{tag}",
                                         _as_linear(packed["attn"][n], 0), xs_for(d), True)
                     for n in ("wq", "wk", "wv", "wo")]
        head_rec = check_packed_matmul(timer, f"lm_head{tag}", _as_linear(packed["head"]),
                                       xs_for(d), True)
        trio = [_as_linear(mlp[n], 0) for n in ("w_gate", "w_up", "w_down_t")]
        mlp_rec = check_fused_mlp(timer, f"mlp[layer0]{tag}", *trio, xs_for(d), True)
        records += attn_recs + [head_rec, mlp_rec]
        if route == "dense":  # bf16 values at the main-path shapes
            records.append(check_packed_matmul(timer, "wq[layer0] bf16 values",
                                               bf16_copy(_as_linear(packed["attn"]["wq"], 0)),
                                               xs_for(d), False))
            records.append(check_fused_mlp(timer, "mlp[layer0] bf16 values",
                                           *[bf16_copy(lin) for lin in trio], xs_for(d), False))
        # one decode step's worth: each layer's 4 projections + the head; L MLPs
        b_name = "vusa_packed_matmul" if route == "dense" else "vusa_packed_matmul_quantized"
        f_name = "vusa_fused_mlp_matmul" if route == "dense" else "vusa_fused_mlp_matmul_quantized"
        step[route] = {
            b_name: {k: L * sum(r["timing"][k] for r in attn_recs) + head_rec["timing"][k]
                     for k in keys},
            f_name: {k: L * mlp_rec["timing"][k] for k in keys},
        }
        step[route][b_name]["max_abs_err"] = max(
            c["max_abs_err"] for r in attn_recs + [head_rec] for c in r["cases"])
        step[route][f_name]["max_abs_err"] = max(c["max_abs_err"] for c in mlp_rec["cases"])
        step[route][b_name]["bound_by"] = head_rec["timing"]["bound_by"]
        step[route][f_name]["bound_by"] = mlp_rec["timing"]["bound_by"]

    # edge shapes, every route
    zero_rows = sparse(768, 768, 0.85)
    zero_rows[100:300] = 0.0
    zero_rows[:, 200:260] = 0.0
    edges = (("sparsity 0", sparse(768, 768, 0.0), 16),
             ("sparsity 0.99", sparse(768, 768, 0.99), 16),
             ("C % m != 0", sparse(768, 700, 0.85), 16), ("all-zero rows", zero_rows, 16),
             ("odd slot count (a = 3)", sparse(768, 768, 0.85), 3),
             ("K = 1000, a slice off the slice size", sparse(1000, 768, 0.85), 16),
             ("K = 1000, a = 3: unaligned chunk starts", sparse(1000, 768, 0.85), 3),
             ("K = 3072, the w_down shape", sparse(3072, 768, 0.85), 16))
    mlp_edges = []
    for label, s, dm, ff, a in (
            ("mlp sparsity 0", 0.0, 768, 3072, 16), ("mlp sparsity 0.99", 0.99, 768, 3072, 16),
            ("mlp all-zero rows, ff % m != 0", 0.85, 768, 3000, 16),
            ("mlp odd slot count (a = 3)", 0.85, 768, 3072, 3),
            ("mlp d = 1000, slices off the slice size, a = 3", 0.85, 1000, 3072, 3)):
        wg, wu, wd = sparse(dm, ff, s), sparse(dm, ff, s), sparse(ff, dm, s)
        if ff % 128:
            wg[10:300] = 0.0
            wu[:, 40:400] = 0.0
            wd[5:600] = 0.0
        mlp_edges.append((label, wg, wu, wd, a))
    for route in packs:
        vd = {"value_dtype": route, "device": dev}
        tag = "" if route == "dense" else f" {route}"
        for label, w, a in edges:
            records.append(check_packed_matmul(
                timer, label + tag, ops.pack_linear_rows(w, a=a, **vd), xs_for(w.shape[0]),
                False))
        for label, wg, wu, wd, a in mlp_edges:
            records.append(check_fused_mlp(
                timer, label + tag, ops.pack_linear_rows(wg, a=a, **vd),
                ops.pack_linear_rows(wu, a=a, **vd), ops.pack_linear_rows_t(wd, a=a, **vd),
                xs_for(wg.shape[0]), False))
    return records, step


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def prompts_for(cfg):
    return np.random.default_rng(1).integers(1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)


def planned_launches(cfg) -> dict:
    """Wrapper launches of one packed decode step of ``cfg`` (scope
    "all"): four projections a layer plus an untied head (B1/B3), one
    fused MLP a layer (B2/B4): 49 and 12 for ``vusa_edge``."""
    return {"vusa_packed_matmul": 4 * cfg.n_layers + (0 if cfg.tie_embeddings else 1),
            "vusa_fused_mlp_matmul": cfg.n_layers}


def planned_cuda_launches(cfg, packed) -> dict:
    """CUDA launches one decode step at B = ``BATCH`` must issue, by entry
    point: each projection and an untied head by its ``row_plan`` (K
    alone), and each fused MLP by its ``mlp_plan`` (K and D)."""
    def calls(lin):
        return row_plan.cuda_launches(row_plan.row_plan(lin.k), BATCH,
                                      lin.values.shape[0] * lin.m)

    attn = sum(calls(_as_linear(packed["attn"][n], 0)) for n in ("wq", "wk", "wv", "wo"))
    head = 0 if packed["head"] is None else calls(_as_linear(packed["head"]))
    gate, down_t = (_as_linear(packed["mlp"][n], 0) for n in ("w_gate", "w_down_t"))
    mlp = mlp_plan.cuda_launches(mlp_plan.mlp_plan(gate.k, down_t.k), BATCH, down_t.k,
                                 gate.values.shape[0])
    return {"vusa_packed_matmul": cfg.n_layers * attn + head,
            "vusa_fused_mlp_matmul": cfg.n_layers * mlp}


def counted_run(cfg, eng, route):
    """Warm up, set every launch count to 0, run the main path once and read
    the counts: exactly ``planned_launches(cfg)`` per decode step (49 and
    12 for ``vusa_edge``) times 31, all on ``route``, and the CUDA
    launches that the kernel library counts for each entry point equal to
    the plan's (``planned_cuda_launches``).  Returns (generate's result,
    counts on ``route``, CUDA launches per call, peak device bytes)."""
    prompts = prompts_for(cfg)
    eng.generate(prompts, max_new=4)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entries = ("vusa_packed_matmul", "vusa_fused_mlp_matmul")
    cuda0 = {name: packed_cuda_launches(name) for name in entries}
    reset_launch_counts()
    out = eng.generate(prompts, max_new=MAX_NEW)  # <- the counted main-path run
    counts = {"vusa_packed_matmul": dict(vusa_packed_matmul.launches),
              "vusa_fused_mlp_matmul": dict(vusa_fused_mlp_matmul.launches)}
    cuda = {name: packed_cuda_launches(name) - cuda0[name] for name in entries}
    peak = torch.cuda.max_memory_allocated()
    steps = MAX_NEW - 1
    want = {name: {r: n * steps if r == route else 0 for r in counts[name]}
            for name, n in planned_launches(cfg).items()}
    if counts != want:
        fail(f"{route} main path: launch counts {counts} != expected {want}")
    want_cuda = {name: n * steps for name, n in planned_cuda_launches(cfg, eng.packed).items()}
    if cuda != want_cuda:
        fail(f"{route} main path: CUDA launches {cuda} != the plan's {want_cuda}")
    toks = out["tokens"]
    if toks.shape != (BATCH, MAX_NEW) or not out["finite"]:
        fail(f"{route} main path: tokens {toks.shape}, finite={out['finite']}")
    if toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"{route} main path: token ids outside the vocabulary")
    per_call = {name: cuda[name] / counts[name][route] for name in entries}
    return out, {name: c[route] for name, c in counts.items()}, per_call, peak


def first_layers(tree, n: int = DEPTH_CUT):
    """A stacked layer tree cut to its first ``n`` layers."""
    return {k: first_layers(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}


def model_phase(cfg, params, eng):
    prompts = prompts_for(cfg)
    out, counts, per_call, peak = counted_run(cfg, eng, "dense")
    res = {"launches": counts, "cuda_launches_per_call": per_call,
           "main": {"tok_per_s": out["tok_per_s"], "decode_s": out["decode_s"],
                    "prefill_s": out["prefill_s"], "peak_bytes": peak}}

    def run(c, p, packed_weights):
        e = Engine(c, p, ServeConfig(max_len=eng.sc.max_len, packed_weights=packed_weights,
                                     fused=False),
                   device=DEVICE)
        e.generate(prompts, max_new=4)
        return e, e.generate(prompts, max_new=MAX_NEW)

    def first_step_logits(c, e, step_params=None):
        """The first decode step's logits after ``e``'s (dense) prefill:
        through ``e``'s pack if it has one, else dense with ``step_params``
        (default ``e``'s own)."""
        with torch.no_grad():
            nxt, cache = e.prime(prompts)
            if e.packed is not None:
                return lm_decode_step_packed(e.params, e.packed, nxt, cache, c)[0]
            return e.model.decode_step(e.params if step_params is None else step_params,
                                       nxt, cache)[0]

    def agreement(a, b) -> float:
        return float((a["tokens"] == b["tokens"]).mean())

    def permute_ff(p):
        """The same function with every layer's MLP ff lanes permuted: the
        dense path then sums the down projection over ff in another order.
        No kernel of the port runs it; it is the witness of how far fp32
        rounding alone moves this model."""
        perm = torch.from_numpy(np.random.default_rng(2).permutation(cfg.d_ff)).to(DEVICE)
        ffn = p["layers"]["ffn"]
        ffn = {"w_gate": ffn["w_gate"][..., perm], "w_up": ffn["w_up"][..., perm],
               "w_down": ffn["w_down"][:, perm]}
        return {**p, "layers": {**p["layers"], "ffn": ffn}}

    def fp32_study(c, p):
        """Packed vs dense, and the witness (dense vs dense with the ff lanes
        permuted), in fp32: free-running greedy token agreement over
        ``MAX_NEW`` tokens, and the first decode step's logit gap (both
        sides from the same prefill cache and token)."""
        pe, pr = run(c, p, "all")
        de, dr = run(c, p, False)
        we, wr = run(c, permute_ff(p), False)
        if not (pr["finite"] and dr["finite"] and wr["finite"]):
            fail(f"fp32 {c.n_layers}-layer run produced non-finite logits")
        ld = first_step_logits(c, de)
        gap, rel = rel_err(first_step_logits(c, pe), ld)
        wgap, wrel = rel_err(first_step_logits(c, de, we.params), ld)
        return {"layers": c.n_layers, "packed_tok_per_s": pr["tok_per_s"],
                "dense_tok_per_s": dr["tok_per_s"],
                "token_agreement": agreement(pr, dr), "first_step_logit_gap": gap,
                "first_step_logit_gap_rel": rel,
                "witness_token_agreement": agreement(wr, dr),
                "witness_first_step_logit_gap": wgap, "witness_first_step_logit_gap_rel": wrel}

    dense_eng, dense = run(cfg, params, False)
    gap, rel = rel_err(first_step_logits(cfg, eng), first_step_logits(cfg, dense_eng))
    res["bf16"] = {"dense_tok_per_s": dense["tok_per_s"], "token_agreement": agreement(out, dense),
                   "first_step_logit_gap": gap, "first_step_logit_gap_rel": rel}

    # fp32 at full depth: the first step's packed and dense logits must agree
    # closely; free-running tokens are reported beside the witness's, since
    # a near-tie can part them (PERF.md, Open questions)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    res["fp32"] = fp32_study(cfg32, params)
    if res["fp32"]["first_step_logit_gap_rel"] > FP32_STEP_TOL:
        fail(f"fp32 first-step logits: packed vs dense gap {res['fp32']['first_step_logit_gap']} "
             f"({res['fp32']['first_step_logit_gap_rel']} of the largest logit)")

    # fp32 with the depth cut to DEPTH_CUT layers (same width and weights):
    # packed and dense greedy tokens must be identical
    cut = dataclasses.replace(cfg32, n_layers=DEPTH_CUT)
    res["fp32_depth_cut"] = fp32_study(cut, {**params, "layers": first_layers(params["layers"])})
    if res["fp32_depth_cut"]["token_agreement"] != 1.0:
        fail(f"fp32 {DEPTH_CUT}-layer packed and dense greedy tokens differ: "
             f"{res['fp32_depth_cut']['token_agreement']} agree")
    return res


def copy_cache(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}


def quantized_parity(c, p, route, max_len):
    """fp32: the ``route`` packed engine against the dense engine on
    ``qdq_lm_params``, both decoding from the quantized engine's primed
    cache (it prefills dense on the unquantized weights; the oracle would
    prefill on the qdq weights).  First-step logit gap and greedy token
    agreement over ``MAX_NEW`` steps."""
    qe = Engine(c, p, ServeConfig(max_len=max_len, packed_weights="all", packed_values=route,
                                  fused=False),
                device=DEVICE)
    oe = Engine(c, qdq_lm_params(c, p, value_dtype=route),
                ServeConfig(max_len=max_len, fused=False),
                device=DEVICE)
    with torch.no_grad():
        tok, cache = qe.prime(prompts_for(c))
        lq = lm_decode_step_packed(qe.params, qe.packed, tok, copy_cache(cache), c)[0]
        lo = oe.model.decode_step(oe.params, tok, copy_cache(cache))[0]
        tq, okq, _, _ = qe.decode_segment(tok, copy_cache(cache), MAX_NEW)
        to, oko, _, _ = oe.decode_segment(tok, copy_cache(cache), MAX_NEW)
    if not (bool(okq.all()) and bool(oko.all())):
        fail(f"fp32 {c.n_layers}-layer {route} parity run produced non-finite logits")
    gap, rel = rel_err(lq, lo)
    return {"layers": c.n_layers, "first_step_logit_gap": gap, "first_step_logit_gap_rel": rel,
            "token_agreement": float((tq == to).float().mean())}


def quantized_phase(cfg, params, qengs):
    """Phase 5: each quantized route's counted main-path run, and its fp32
    decode parity against ``qdq_lm_params`` at full depth and on the
    2-layer cut."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cut = dataclasses.replace(cfg32, n_layers=DEPTH_CUT)
    cut_params = {**params, "layers": first_layers(params["layers"])}
    res = {}
    for route, e in qengs.items():
        out, counts, per_call, peak = counted_run(cfg, e, route)
        r = {"launches": counts, "cuda_launches_per_call": per_call,
             "tok_per_s": out["tok_per_s"], "decode_s": out["decode_s"],
             "prefill_s": out["prefill_s"], "peak_bytes": peak,
             "pack_bytes_per_step": pack_bytes(e.packed),
             "byte_ratio": packed_byte_ratios(e.packed)["total"]}
        r["fp32"] = quantized_parity(cfg32, params, route, e.sc.max_len)
        if r["fp32"]["first_step_logit_gap_rel"] > FP32_STEP_TOL:
            fail(f"fp32 {route} first-step logits: packed vs qdq dense gap "
                 f"{r['fp32']['first_step_logit_gap']} ({r['fp32']['first_step_logit_gap_rel']} "
                 "of the largest logit)")
        r["fp32_depth_cut"] = quantized_parity(cut, cut_params, route, e.sc.max_len)
        if r["fp32_depth_cut"]["token_agreement"] != 1.0:
            fail(f"fp32 {DEPTH_CUT}-layer {route} packed and qdq dense greedy tokens differ: "
                 f"{r['fp32_depth_cut']['token_agreement']} agree")
        res[route] = r
    return res


def interleaved_tok_per_s(cfg, engines, rounds: int = 2):
    """Decode tok/s of each pack's ``generate``, taken in turns (routes in
    order, then reversed, per round) so that host drift during the call
    falls on every route alike.  Reported, not gated."""
    prompts = prompts_for(cfg)
    order = [*engines, *reversed(engines)]
    out = {route: [] for route in engines}
    for _ in range(rounds):
        for route in order:
            out[route].append(engines[route].generate(prompts, max_new=MAX_NEW)["tok_per_s"])
    return out


# --------------------------------------------------------------------------
# phase 6: paper workloads, block-VUSA (B5) against the dense baseline (B6)
# --------------------------------------------------------------------------


def prune_weights(gemms, rate, rng):
    """Per GEMM a ``normal(K, C)`` weight magnitude-pruned to ``rate`` by the
    quantile rule of ``benchmarks/run.py _prune_masks`` (same draws, same
    masks), as fp32."""
    out = []
    for g in gemms:
        w = rng.normal(size=(g.K, g.C))
        thresh = np.quantile(np.abs(w), rate)
        out.append((w * (np.abs(w) > thresh)).astype(np.float32))
    return out


def tile_pad(d: int) -> int:
    """``d`` zero-padded to the reference's ``dense_matmul`` contract: a
    dimension above 128 must be a multiple of 128."""
    return d if d <= 128 or d % 128 == 0 else -(-d // 128) * 128


def reset_all_launch_counts() -> None:
    reset_launch_counts()
    reset_spmm_counts()
    reset_dense_counts()


def all_launch_counts() -> dict:
    return {"vusa_spmm": vusa_spmm.launches, "dense_matmul": dense_matmul.launches,
            "vusa_packed_matmul": sum(vusa_packed_matmul.launches.values()),
            "vusa_fused_mlp_matmul": sum(vusa_fused_mlp_matmul.launches.values())}


def check_rounded(name, got, want):
    """Kernel vs plain: within TOL of the largest |plain| plus one rounding
    step of the output dtype (bf16: 2**-7 of the value; fp32: none)."""
    step = 2.0**-7 if got.dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs()
    scale = max(float(want.float().abs().max()), 1.0)
    if not bool((err <= TOL * scale + step * want.float().abs()).all()):
        fail(f"{name}: kernel vs plain error {float(err.max())} ({float(err.max()) / scale} "
             "relative)")
    return float(err.max())


def simulator_cycles(gemms, masks) -> dict:
    """VUSA 3x6 cycles (``schedule_widths_fast`` + ``ws_cycles`` per achieved
    window width, as ``benchmarks/run.py _evaluate_model``) and standard 3x6
    cycles (``gemm_cycles_standard``) for the same masks."""
    n, m, a = VUSA_NMA
    vusa = 0
    for g, mask in zip(gemms, masks):
        hist, _ = schedule_widths_fast(mask, n, m, a)
        vusa += sum(int(hist[w]) * ws_cycles(g.B, n, w) for w in range(a, m + 1))
    std = sum(gemm_cycles_standard(g, n, m) for g in gemms)
    return {"vusa_3x6": vusa, "standard_3x6": std, "ratio": vusa / std}


def paper_model(timer, name, gemms, rate):
    """One model of phase 6: the counted run, the checks, the timings."""
    rng = np.random.default_rng(PAPER_SEED)
    ws = prune_weights(gemms, rate, rng)
    xs = [torch.from_numpy(rng.standard_normal((g.B, g.K), dtype=np.float32)).to(DEVICE)
          for g in gemms]
    packs = [ops.pack_linear(w, 32, 8, 128, device=DEVICE) for w in ws]
    dense = [torch.from_numpy(w).to(DEVICE) for w in ws]
    padded = []  # B6 operands at the reference's tile contract (exact: zeros)
    for g, x, w in zip(gemms, xs, dense):
        kp, np_ = tile_pad(g.K), tile_pad(g.C)
        padded.append((F.pad(x, (0, kp - g.K)).contiguous(),
                       F.pad(w, (0, np_ - g.C, 0, kp - g.K)).contiguous()))
    torch.cuda.synchronize()

    reset_all_launch_counts()
    outs, cuda = [], []  # <- the counted run; CUDA launches per call from the libraries
    for x, p, (xp, wp) in zip(xs, packs, padded):
        c0 = spmm_cuda_launches()
        y5 = ops.apply_packed(x, p)
        c1 = dense_cuda_launches()
        y6 = ops.matmul(xp, wp)
        outs.append((y5, y6))
        cuda.append((spmm_cuda_launches() - c0, dense_cuda_launches() - c1))
    torch.cuda.synchronize()
    counts = all_launch_counts()
    want = {"vusa_spmm": len(gemms), "dense_matmul": len(gemms), "vusa_packed_matmul": 0,
            "vusa_fused_mlp_matmul": 0}
    if counts != want:
        fail(f"paper workloads {name}: launch counts {counts} != expected {want}")

    bf16_at = {0, len(gemms) // 2, len(gemms) - 1}
    rows = []
    for i, (g, x, p, w, (xp, wp), (y5, y6), (c5, c6)) in enumerate(
            zip(gemms, xs, packs, dense, padded, outs, cuda)):
        tag = f"paper workloads {name} {g.name}"
        exact = torch.matmul(x, w)
        err5 = check_rounded(f"{tag} vusa_spmm", y5, ops.apply_packed_ref(x, p))
        err6 = check_rounded(f"{tag} dense_matmul", y6, ref.dense_matmul_ref(xp, wp))
        for kname, y in (("vusa_spmm", y5), ("dense_matmul", y6[:, : g.C])):
            e, r = rel_err(y, exact)
            if r > EXACT_TOL:
                fail(f"{tag} {kname} vs x @ w: error {e} ({r} relative)")
        bf16 = {}
        if i in bf16_at:
            xb, xpb, wpb = x.to(torch.bfloat16), xp.to(torch.bfloat16), wp.to(torch.bfloat16)
            bf16 = {"vusa_spmm": check_rounded(f"{tag} vusa_spmm bf16 x", ops.apply_packed(xb, p),
                                               ops.apply_packed_ref(xb, p)),
                    "dense_matmul": check_rounded(f"{tag} dense_matmul bf16",
                                                  ops.matmul(xpb, wpb),
                                                  ref.dense_matmul_ref(xpb, wpb))}
        xk = F.pad(x, (0, p.k_padded - p.k)).contiguous()
        t, j, a, tn = p.values.shape
        flops5 = 2 * g.B * j * a * g.C
        flops6 = 2 * xp.shape[0] * wp.shape[1] * xp.shape[1]
        bytes5 = nbytes(p.values, p.row_idx, xk) + g.B * g.C * 4
        bytes6 = nbytes(xp, wp) + xp.shape[0] * wp.shape[1] * 4
        b5 = bound_ms(bytes5, TF32_PASSES * flops5, TF32_FLOPS)
        b6 = bound_ms(bytes6, TF32_PASSES * flops6, TF32_FLOPS)
        plan5, plan6 = tile_plan.plan(j * a), tile_plan.plan(xp.shape[1])
        for kname, got, want in (
                ("vusa_spmm", c5, tile_plan.cuda_launches(plan5, g.B, g.C)),
                ("dense_matmul", c6, tile_plan.cuda_launches(plan6, xp.shape[0], wp.shape[1]))):
            if got != want:
                fail(f"{tag} {kname}: {got} CUDA launches in the counted run, its plan takes "
                     f"{want}")
        rows.append({
            "gemm": g.name, "B": g.B, "K": g.K, "C": g.C, "k_padded": p.k_padded,
            "T": t, "J": j, "A": a, "compression": p.compression,
            "virtual_growth": p.virtual_growth, "logical_flops": 2 * g.B * g.K * g.C,
            "library_ms": timer(lambda: torch.matmul(x, w)),
            "vusa_spmm": {"ms": timer(lambda: vusa_spmm(xk, p.values, p.row_idx, g.C)),
                          "plain_ms": timer(lambda: ref.vusa_spmm_ref(xk, p.values, p.row_idx,
                                                                      g.C)),
                          "bound_ms": b5[0], "bound_by": b5[1],
                          "bound_fp32_ms": bound_ms(bytes5, flops5)[0], "max_abs_err": err5,
                          "max_abs_err_bf16": bf16.get("vusa_spmm"),
                          "flops": flops5, "plan": plan5._asdict(), "cuda_launches": c5},
            "dense_matmul": {"ms": timer(lambda: ops.matmul(xp, wp)),
                             "plain_ms": timer(lambda: ref.dense_matmul_ref(xp, wp)),
                             "bound_ms": b6[0], "bound_by": b6[1],
                             "bound_fp32_ms": bound_ms(bytes6, flops6)[0], "max_abs_err": err6,
                             "max_abs_err_bf16": bf16.get("dense_matmul"), "flops": flops6,
                             "padded": [xp.shape[0], xp.shape[1], wp.shape[1]],
                             "plan": plan6._asdict(), "cuda_launches": c6},
        })

    def total(kname):
        ks = [r[kname] for r in rows]
        out = {k: sum(r[k] for r in ks)
               for k in ("ms", "plain_ms", "bound_ms", "bound_fp32_ms", "flops")}
        by_ops = sum(r["bound_ms"] for r in ks if r["bound_by"] == "operations")
        out["bound_by"] = "operations" if 2 * by_ops >= out["bound_ms"] else "bytes"
        out["max_abs_err"] = max(r["max_abs_err"] for r in ks)  # fp32 x
        out["max_abs_err_bf16"] = max(r["max_abs_err_bf16"] for r in ks
                                      if r["max_abs_err_bf16"] is not None)
        out["library_ms"] = sum(r["library_ms"] for r in rows)
        out["launches"] = counts[kname]
        out["cuda_launches_per_call"] = sum(r["cuda_launches"] for r in ks) / len(ks)
        return out

    groups = {}
    for gname, members in (RESNET18_GROUPS if name == "resnet18" else ()):
        rs = [r for r in rows if r["gemm"] in members]
        flops = sum(r["logical_flops"] for r in rs)
        groups[gname] = {"gemms": len(rs), "logical_flops": flops}
        for key, ms in (("vusa_spmm", sum(r["vusa_spmm"]["ms"] for r in rs)),
                        ("dense_matmul", sum(r["dense_matmul"]["ms"] for r in rs)),
                        ("library", sum(r["library_ms"] for r in rs))):
            groups[gname][key] = {"ms": ms, "logical_tflop_per_s": flops / ms / 1e9}

    packed_bytes = sum(nbytes(p.values, p.row_idx) for p in packs)
    return {
        "gemms": len(gemms), "rate": rate, "launches": counts,
        "vusa_spmm": total("vusa_spmm"), "dense_matmul": total("dense_matmul"),
        "logical_flops": sum(r["logical_flops"] for r in rows),
        "compression_sum": sum(p.compression for p in packs),
        "byte_ratio": packed_bytes / sum(nbytes(w) for w in dense),
        "virtual_growth_mean": float(np.mean([p.virtual_growth for p in packs])),
        "simulator": simulator_cycles(gemms, [w != 0 for w in ws]),
        "layer_groups": groups, "per_gemm": rows,
    }


def paper_phase():
    """Phase 6 over ``PAPER_MODELS``; returns ``{model: summary}``."""
    timer = Timer()
    return {name: paper_model(timer, name, fn(), rate) for name, fn, rate in PAPER_MODELS}


# --------------------------------------------------------------------------
# phase 7: the decode loop as a CUDA graph; phase 8: speculative decoding
# --------------------------------------------------------------------------


def profile_window(fn) -> dict:
    """``fn()`` under ``torch.profiler`` (device activity only), ended by a
    synchronize: wall ms on the host clock, the device's busy ms (the union
    of the intervals of the trace's device events), their summed ms, and
    the summed ms of the B1-B4 library's kernels; and, outside the
    profiler, ``fn()``'s ms between two CUDA events (``unprofiled_ms``:
    tracing slows the host).  Busy is None when the trace holds no device
    event (then the device time is not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    unprofiled_ms = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_ms": wall_ms, "unprofiled_ms": unprofiled_ms,
            "busy_ms": busy / 1e3 if spans else None,
            "device_sum_ms": sum(b - a for a, b in spans) / 1e3, "device_events": len(spans),
            "library_kernel_ms": sum(e.time_range.elapsed_us() for e in dev
                                     if any(k in e.name for k in LIBRARY_KERNELS)) / 1e3}


def per_step(prof: dict, steps: int) -> dict:
    """A trace's numbers per step, the busy share (busy over wall) and the
    host time outside the device's busy time."""
    busy = prof["busy_ms"]
    out = {k: v / steps for k, v in prof.items() if k.endswith("_ms") and v is not None}
    out["busy_share"] = None if busy is None else busy / prof["wall_ms"]
    out["busy_share_unprofiled"] = None if busy is None else busy / prof["unprofiled_ms"]
    out["host_outside_ms"] = None if busy is None else (prof["wall_ms"] - busy) / steps
    out["device_events"] = prof["device_events"] / steps
    return out


def trace_line(what, tr) -> str:
    """One report line of a ``per_step`` trace."""
    if tr["busy_share"] is None:
        return f"{what}: device time not measured (no device event in the trace)"
    return (f"{what}: {tr['unprofiled_ms']:.4f} ms a step between CUDA events, device busy "
            f"{tr['busy_ms']:.4f} ms ({tr['busy_share_unprofiled']:.4f} of the step; "
            f"{tr['device_events']:.0f} device events, B1-B4 kernels "
            f"{tr['library_kernel_ms']:.4f} ms); under the trace {tr['wall_ms']:.4f} ms a "
            f"step, busy share {tr['busy_share']:.4f}, host outside "
            f"{tr['host_outside_ms']:.4f} ms")


def use(e, **kw):
    """Set ``e``'s per-call serving options (``fused``, ``temperature``,
    ``speculative``); the packs stay."""
    e.sc = dataclasses.replace(e.sc, **kw)
    return e


def graph_phase(cfg, engines):
    """Phase 7 over ``engines`` (``{"dense", "fp32", "int8", "int4"}``): the
    captured step's tokens against the eager loop's, greedy and sampled;
    the graph's launches (replays x the launches captured in one step)
    against the counted run's; tok/s of graph and eager in turns; a
    profiler trace of ``PROFILED_STEPS`` replays (and of as many eager steps
    on the fp32-value pack)."""
    prompts = prompts_for(cfg)
    steps = MAX_NEW - 1
    res = {}
    for route, e in engines.items():
        r = {"tok_per_s": {"graph": [], "eager": []}}
        for temp in (0.0, 1.0):
            g0 = use(e, fused=True, temperature=temp).graph_launches()
            graph = e.generate(prompts, max_new=MAX_NEW)
            g1 = e.graph_launches()
            eager = use(e, fused=False).generate(prompts, max_new=MAX_NEW)
            if temp == 0.0:  # the first turn: graph, eager
                r["tok_per_s"]["graph"].append(graph["tok_per_s"])
                r["tok_per_s"]["eager"].append(eager["tok_per_s"])
            tag = f"graph decode {route} {'sampled' if temp else 'greedy'}"
            if not (graph["finite"] and eager["finite"]):
                fail(f"{tag}: non-finite logits")
            if not np.array_equal(graph["tokens"], eager["tokens"]):
                fail(f"{tag}: graph tokens differ from the eager loop's at "
                     f"{np.argwhere(graph['tokens'] != eager['tokens'])[0].tolist()}")
            if temp == 0.0 and route != "dense":
                vd = "dense" if route == "fp32" else route
                got = {n: {k: v - g0.get(n, {}).get(k, 0) for k, v in c.items()}
                       for n, c in g1.items()}
                want = {name: {k: n * steps if k == vd else 0 for k in got[name]}
                        for name, n in planned_launches(cfg).items()}
                if got != want:
                    fail(f"{tag}: graph launches {got} != expected {want}")
                r["graph_launches"] = {n: c[vd] for n, c in got.items()}
        turns = r["tok_per_s"]  # the second turn, reversed: eager, graph
        turns["eager"].append(use(e, temperature=0.0).generate(prompts, MAX_NEW)["tok_per_s"])
        turns["graph"].append(use(e, fused=True).generate(prompts, MAX_NEW)["tok_per_s"])
        r["ms_per_step"] = {k: [1e3 * BATCH / t for t in v] for k, v in turns.items()}
        with torch.no_grad():
            tok, cache = e.prime(prompts)
            r["trace_graph"] = per_step(profile_window(lambda: use(e, fused=True).decode_segment(
                tok, copy_cache(cache), PROFILED_STEPS)), PROFILED_STEPS)
            if route == "fp32":
                r["graph_structure"] = graph_structure(cfg, e)
                r["trace_eager"] = per_step(profile_window(lambda: use(e, fused=False)
                                                           .decode_segment(tok, copy_cache(cache),
                                                                           PROFILED_STEPS)),
                                            PROFILED_STEPS)
        use(e, fused=False)
        res[route] = r
    return res


def graph_structure(cfg, e) -> dict:
    """One packed decode step (B = ``BATCH``) captured in a CUDA graph in
    debug mode, its DOT dump written to ``chiprun_out/decode_step_graph.dot``
    and read: the graph's nodes and edges, and its kernel nodes of the B1-B4
    library by kernel.  They must be the step's planned CUDA launches
    (``planned_cuda_launches``): 49 row-packed and 12 fused-MLP kernels and
    one ordered sum for each call whose plan takes one, so the capture kept
    every launch of the library, its clusters included (the fused MLP's
    result depends on them, and the graph's tokens equal the eager
    loop's).  The dump shows no edge types: whether the capture kept the
    dependent launches' programmatic edges is not read here."""
    with torch.no_grad():
        tok, cache = e.prime(prompts_for(cfg))
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the dump
        graph.enable_debug_mode()
        with torch.cuda.graph(graph):
            lm_decode_step_packed(e.params, e.packed, tok, cache, cfg)
    path = ROOT / "chiprun_out" / "decode_step_graph.dot"
    path.parent.mkdir(exist_ok=True)
    graph.debug_dump(str(path))
    if not path.exists():
        fail("graph decode: the runtime wrote no DOT dump of the captured step")
    ids = [ln for ln in path.read_text().splitlines() if ln.startswith("| {ID | ")]
    out = {"dot": str(path.relative_to(ROOT)), "nodes": len(ids),
           "edges": path.read_text().count("->"),
           **{k: sum(k in ln for ln in ids) for k in LIBRARY_KERNELS}}
    planned = planned_cuda_launches(cfg, e.packed)
    per_step = planned_launches(cfg)
    want = {"row_packed_kernel": per_step["vusa_packed_matmul"],
            "fused_mlp_kernel": per_step["vusa_fused_mlp_matmul"]}
    want["sum_slices_kernel"] = sum(planned.values()) - sum(want.values())
    if {k: out[k] for k in LIBRARY_KERNELS} != want:
        fail(f"graph decode: the captured step holds library kernels "
             f"{ {k: out[k] for k in LIBRARY_KERNELS} }, the plan takes {want}")
    return out


def tiered(tree):
    """The tier structure of ``tests/test_spec_decode.py::_tiered`` on every
    matrix: the top 1 % of magnitudes kept, the next 14 % scaled by 0.03,
    zeros elsewhere, so a 99 %-sparse drafter keeps exactly the core."""
    if isinstance(tree, dict):
        return {k: tiered(v) for k, v in tree.items()}
    if tree.ndim < 2:
        return tree
    a = tree.abs()
    srt = a.flatten().sort(descending=True).values
    t1, t2 = (srt[max(int(f * a.numel()) - 1, 0)] for f in (0.01, 0.15))
    return torch.where(a >= t1, tree, torch.where(a >= t2, tree * 0.03, torch.zeros_like(tree)))


def spec_phase(cfg, raw, max_len):
    """Phase 8: ``vusa_edge`` at full width on ``tiered`` params (from the
    unpruned init ``raw``), B = 1, the drafter at ``DRAFT_SPARSITY``
    drafting ``DRAFT_K`` tokens a round, the verifier dense and packed
    with fp32 and with int8 values: speculative tokens against plain graph
    decode's, greedy and sampled; acceptance, rounds, tok/s in turns; on
    the packed routes one drafter step's and one verify's device time (a
    trace of 3 of each)."""
    params = tiered(raw)
    prompt = prompts_for(cfg)[:1]
    res, drafter = {}, None
    for route in ("fp32", "int8", "dense"):
        t0 = time.monotonic()
        e = Engine(cfg, params, ServeConfig(
            max_len=max_len, packed_weights=False if route == "dense" else "all",
            packed_values="int8" if route == "int8" else "bf16", speculative=drafter is None,
            draft_k=DRAFT_K, draft_sparsity=DRAFT_SPARSITY), device=DEVICE)
        # the drafter depends on the weights and DRAFT_SPARSITY alone: built
        # by the first engine, handed to the others
        drafter = e.draft_packed if drafter is None else drafter
        e._draft_packed = drafter
        r = {"build_s": time.monotonic() - t0,
             "draft_pack_bytes": pack_bytes(e.draft_packed),
             "verify_pack_bytes": None if e.packed is None else pack_bytes(e.packed),
             "tok_per_s": {"speculative": [], "plain": []}}
        for temp in (0.0, 1.0):
            spec = use(e, speculative=True, temperature=temp).generate(prompt, MAX_NEW)
            plain = use(e, speculative=False).generate(prompt, MAX_NEW)
            tag = f"speculative {route} {'sampled' if temp else 'greedy'}"
            if not (spec["finite"] and plain["finite"]):
                fail(f"{tag}: non-finite logits")
            if not np.array_equal(spec["tokens"], plain["tokens"]):
                fail(f"{tag}: speculative tokens differ from plain decode's at "
                     f"{np.argwhere(spec['tokens'] != plain['tokens'])[0].tolist()}")
            r["sampled" if temp else "greedy"] = {
                k: spec[k] for k in ("spec_rounds", "spec_proposed", "spec_accepted",
                                     "acceptance_rate")}
            if temp == 0.0:  # the first turn: speculative, plain
                r["tok_per_s"]["speculative"].append(spec["tok_per_s"])
                r["tok_per_s"]["plain"].append(plain["tok_per_s"])
        turns = r["tok_per_s"]  # the second turn, reversed: plain, speculative
        turns["plain"].append(use(e, temperature=0.0).generate(prompt, MAX_NEW)["tok_per_s"])
        turns["speculative"].append(use(e, speculative=True).generate(prompt, MAX_NEW)
                                    ["tok_per_s"])
        if e.packed is None:
            res[route] = r
            continue
        with torch.no_grad():
            tok, cache = e.prime(prompt)
            seq = tok.repeat(1, VERIFY_ROWS)
            for name, pk, x in (("drafter_step", e.draft_packed, tok),
                                ("verify", e.packed, seq)):
                r[name] = per_step(profile_window(lambda pk=pk, x=x: [
                    lm_decode_step_packed(e.params, pk, x, c, cfg)
                    for c in [copy_cache(cache)] for _ in range(3)]), 3)
        res[route] = r
    return res



# --------------------------------------------------------------------------
# phase 9: continuous batching, slot pool and paged pool
# --------------------------------------------------------------------------


def sched_traffic(cfg, arrivals: bool) -> list:
    """The phase's requests, from numpy seed ``SCHED_SEED``: prompts of
    ``SCHED_PROMPTS`` tokens, every third behind one shared
    ``SCHED_PREFIX``-token prefix (a system prompt), ``SCHED_NEW`` new
    tokens, no EOS; requests 0 and 1 take a prompt whose length is not a
    page multiple and the most new tokens, and requests 8 and 9 repeat
    them with other seeds (admitted in a later round while 0 and 1 still
    decode, so their tail pages are copied on write).  Arrival offsets
    over ``[0, SCHED_ARRIVALS_S)``, in request order, or all 0."""
    rng = np.random.default_rng(SCHED_SEED)
    prefix = rng.integers(1, cfg.vocab, SCHED_PREFIX)
    lo, hi = SCHED_PROMPTS
    reqs = []
    for i in range(SCHED_REQUESTS):
        n = int(rng.integers(lo, hi + 1))
        if i in (0, 1):
            n += 1 if n % SCHED_PAGE == 0 else 0
        prompt = rng.integers(1, cfg.vocab, n)
        if i % 3 == 2:
            n = max(n, SCHED_PREFIX + 8)
            prompt = np.concatenate([prefix, rng.integers(1, cfg.vocab, n - SCHED_PREFIX)])
        if i in (8, 9):
            prompt = reqs[i - 8].prompt.copy()
        new = SCHED_NEW[1] if i in (0, 1) else int(rng.integers(SCHED_NEW[0], SCHED_NEW[1] + 1))
        reqs.append(Request(prompt=prompt.astype(np.int32), max_new=new, seed=1000 + i))
    offsets = np.sort(rng.uniform(0.0, SCHED_ARRIVALS_S, SCHED_REQUESTS)) if arrivals else None
    return [dataclasses.replace(r, arrival_s=float(offsets[i]) if arrivals else 0.0)
            for i, r in enumerate(reqs)]


def sched_use(e, **kw):
    """``e`` set up for the phase: ``max_len`` 256, the CUDA-graph loop, the
    slot pool unless ``kw`` says otherwise."""
    base = dict(max_len=SCHED_MAX_LEN, fused=True, temperature=0.0, page_size=0,
                prefix_cache=True, prefill_chunk=0, arena_blocks=0)
    return use(e, **{**base, **kw})


def sched_run(e, reqs, admission="batched", on_sync=None):
    """One scheduler over ``e`` serving ``reqs``: (scheduler, completions,
    B1-B4 launches of its pool graph's replays by wrapper and route)."""
    sched = Scheduler(e, slots=SCHED_SLOTS, segment=SCHED_SEGMENT, admission=admission)
    g0 = e.graph_launches()
    done = sched.run([dataclasses.replace(r) for r in reqs], on_sync=on_sync)
    g1 = e.graph_launches()
    got = {n: {k: v - g0.get(n, {}).get(k, 0) for k, v in c.items()} for n, c in g1.items()}
    return sched, done, got


def row_stability(cfg, e, paged: bool) -> None:
    """The pool step at ``SCHED_SLOTS`` rows (``rowwise``, as the scheduler
    runs it) on 8 caches primed from prompts of ragged lengths, row i
    against a B = 1 step on a copy of cache i: bitwise, logits and every
    row; in the slot pool or gathered from a paged pool."""
    rng = np.random.default_rng(SCHED_SEED + 1)
    lens = [int(n) for n in rng.integers(SCHED_PROMPTS[0], SCHED_PROMPTS[1] + 1, SCHED_SLOTS)]
    tag = f"scheduler row stability {'paged' if paged else 'slot'}"
    with torch.no_grad():
        primed = [e.prime(rng.integers(1, cfg.vocab, (1, n)).astype(np.int32)) for n in lens]
        token = torch.cat([t for t, _ in primed])
        ones = [e._logits(token[i : i + 1], copy_cache(c), e.packed)
                for i, (_, c) in enumerate(primed)]
        batched = {k: torch.cat([c[k] for _, c in primed], dim=1) for k in ("k", "v")}
        if paged:
            lay = PagedLayout.build(SCHED_SLOTS, SCHED_MAX_LEN, SCHED_PAGE)
            pst = init_paged_pool(e.model.cache_specs(1, SCHED_MAX_LEN), lay, DEVICE)
            rows = (lay.reserved + np.arange(SCHED_SLOTS * lay.n_pages)).reshape(SCHED_SLOTS, -1)
            write_prefill_pages(pst["arena"], rows, batched)
            bind_slot_pages(pst["table"], pst["pos"], list(range(SCHED_SLOTS)), rows, lens)
            cache = paged_view(pst)
        else:
            cache = e.model.init_slot_cache(SCHED_SLOTS, SCHED_MAX_LEN, device=DEVICE)
            write_slots(cache, list(range(SCHED_SLOTS)), {**batched, "pos": None},
                        e.model.cache_batch_axes(SCHED_MAX_LEN), lens)
        many = e._logits(token, cache, e.packed, rowwise=True)
    for i, one in enumerate(ones):
        if not torch.equal(many[i : i + 1], one):
            fail(f"{tag}: row {i} at {SCHED_SLOTS} rows differs from a B = 1 step by "
                 f"{float((many[i : i + 1].float() - one.float()).abs().max()):.3g}")


def oracle_tokens(e, reqs) -> list:
    """One-shot ``generate`` of each request alone (B = 1) with its seed."""
    out = []
    for r in reqs:
        use(e, seed=r.seed)
        out.append(e.generate(r.prompt[None], max_new=r.max_new)["tokens"][0])
    return out


def prime_gap(cfg, params, reqs, layers: int) -> dict:
    """``prime_many`` (the traffic's first ``SCHED_SLOTS`` prompts in their
    length buckets, as batched admission primes them) against ``prime`` of
    each prompt alone, fp32 logits, at ``layers`` layers: the largest gap
    over the largest |logit|, and whether every row was bitwise equal
    (ROADMAP C9).  Beside it a witness without any padding or masking: each
    prompt primed twice in one batch of 2, row 0 against ``prime``, so only
    the row count differs."""
    c32 = dataclasses.replace(cfg, dtype="float32", n_layers=layers)

    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:layers] for k, v in tree.items()}

    p = {**params, "layers": cut(params["layers"])}
    e = Engine(c32, p, ServeConfig(max_len=SCHED_MAX_LEN), device=DEVICE)
    groups = {}
    for r in reqs[: SCHED_SLOTS]:
        groups.setdefault(e.bucket_len(len(r.prompt)), []).append(r)
    worst, witness, top, bitwise = 0.0, 0.0, 0.0, True

    def prefill(tokens, lengths=None):
        t = torch.as_tensor(tokens, device=DEVICE).long()
        lens = None if lengths is None else torch.tensor(lengths, device=DEVICE)
        return e.model.prefill(e.params, {"tokens": t}, SCHED_MAX_LEN, lengths=lens)[0].float()

    with torch.no_grad():
        for blen, grp in groups.items():
            toks = np.zeros((len(grp), blen), np.int32)
            for j, r in enumerate(grp):
                toks[j, : len(r.prompt)] = r.prompt
            many = prefill(toks, [len(r.prompt) for r in grp])
            for j, r in enumerate(grp):
                one = prefill(r.prompt[None])[0]
                two = prefill(np.stack([r.prompt, r.prompt]))[0]
                worst = max(worst, float((many[j] - one).abs().max()))
                witness = max(witness, float((two - one).abs().max()))
                top = max(top, float(one.abs().max()))
                bitwise &= torch.equal(many[j], one)
    return {"layers": layers, "max_abs_gap": worst, "max_abs_logit": top,
            "gap_rel": worst / max(top, 1.0), "bitwise": bitwise,
            "witness_b2_gap_rel": witness / max(top, 1.0)}


def pool_ms_per_step(e, segments: int = 3, slots: int = SCHED_SLOTS) -> float:
    """Device-clock ms of one pool step (a speculative round on a
    speculative engine) at ``slots`` slots, every slot free (a step does
    the same work at any position): ``segments`` segments of replays of the
    captured step, between CUDA events."""
    sched = Scheduler(e, slots=slots, segment=SCHED_SEGMENT)
    e.prepare_pool(sched._pool)
    e.pool_segment(sched._pool)  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(segments):
        e.pool_segment(sched._pool)
    end.record()
    torch.cuda.synchronize()
    e.release_pool(sched._pool)
    return start.elapsed_time(end) / (segments * SCHED_SEGMENT)


def sched_stats(sched) -> dict:
    keys = ("requests", "decoded_tokens", "segments", "sustained_tok_per_s", "tok_per_s",
            "decode_s", "admit_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s",
            "latency_p50_s", "latency_p99_s", "slot_occupancy", "hbm_bytes_per_active_request",
            "kv_pool_bytes", "prefix_lookups", "prefix_hits", "prefix_hit_rate", "cow_copies",
            "prefill_chunks", "preempted", "cache_evictions", "failed", "timed_out")
    st = sched.stats()
    return {k: st[k] for k in keys}


def same_tokens(a, b) -> float:
    """Share of requests whose token streams are equal."""
    return sum(np.array_equal(a[rid].tokens, b[rid].tokens) for rid in a) / len(a)


def scheduler_phase(cfg, params, engines) -> dict:
    """Phase 9 over ``engines`` (``{"dense", "fp32", "int8", "int4"}``, the
    packs of phases 4-7, set to ``max_len`` 256 here)."""
    t_phase = time.monotonic()
    res = {"row_stability": {}, "sequential": {}, "paged_vs_slot": {}}
    for route, e in engines.items():
        sched_use(e)
        for paged in (False, True):
            row_stability(cfg, e, paged)
        res["row_stability"][route] = "bitwise (slot and paged)"
    timed = sched_traffic(cfg, arrivals=True)
    at_zero = sched_traffic(cfg, arrivals=False)
    for route, temps in (("dense", (0.0, 1.0)), ("fp32", (0.0, 1.0)), ("int8", (0.0,))):
        e = engines[route]
        for temp in temps:
            tag = f"scheduler sequential {route} {'sampled' if temp else 'greedy'}"
            sched, done, launches = sched_run(sched_use(e, temperature=temp), timed, "sequential")
            want = oracle_tokens(sched_use(e, temperature=temp), timed)
            for rid, w in enumerate(want):
                if done[rid].status.value != "OK" or not np.array_equal(done[rid].tokens, w):
                    fail(f"{tag}: request {rid} ({done[rid].status.value}) differs from one-shot "
                         f"generate at B = 1")
            st = sched_stats(sched)
            if e.packed is not None:
                vd = "dense" if route == "fp32" else route
                steps = st["segments"] * SCHED_SEGMENT
                want_l = {name: {k: n * steps if k == vd else 0 for k in launches[name]}
                          for name, n in planned_launches(cfg).items()}
                if launches != want_l:
                    fail(f"{tag}: pool graph launches {launches} != expected {want_l}")
                st["graph_launches"] = {n: c[vd] for n, c in launches.items()}
            res["sequential"][f"{route} {'sampled' if temp else 'greedy'}"] = st
    for route in ("dense", "fp32"):
        e = engines[route]
        ss, slot, _ = sched_run(sched_use(e), at_zero, "batched")
        sp, paged, _ = sched_run(sched_use(e, page_size=SCHED_PAGE, prefix_cache=False), at_zero)
        if not sp.paged or same_tokens(slot, paged) != 1.0:
            fail(f"scheduler paged {route}: the paged pool's tokens differ from the slot pool's "
                 f"under batched admission ({same_tokens(slot, paged):.4f} equal)")
        res["paged_vs_slot"][route] = {"slot": sched_stats(ss), "paged": sched_stats(sp)}
    res["prime_many_vs_prime"] = [prime_gap(cfg, params, timed, n)
                                  for n in (DEPTH_CUT, 4, 8, cfg.n_layers)]
    cut = res["prime_many_vs_prime"][0]
    if cut["gap_rel"] > PRIME_TOL:
        fail(f"scheduler prime_many vs prime ({cut['layers']} layers, fp32): gap "
             f"{cut['gap_rel']:.3g} of the largest logit > {PRIME_TOL}")
    e = engines["fp32"]
    syncs = []

    def check_mirror(s):
        syncs.append(s.verify_paged_mirror())

    ss, slot, _ = sched_run(sched_use(e), timed, "batched")
    sp, paged, _ = sched_run(sched_use(e, page_size=SCHED_PAGE, prefill_chunk=SCHED_CHUNK,
                                      arena_blocks=SCHED_ARENA), timed, on_sync=check_mirror)
    st = sched_stats(sp)
    bad = [rid for rid, c in paged.items()
           if c.status.value != "OK" or len(c.tokens) != timed[rid].max_new]
    if bad:
        fail(f"scheduler paged prefix/chunk/preempt: requests {bad} did not complete OK")
    for k in ("prefix_hits", "cow_copies", "prefill_chunks", "preempted"):
        if not st[k] > 0:
            fail(f"scheduler paged prefix/chunk/preempt: {k} = {st[k]}, the mechanism never fired")
    res["traffic"] = {"slot_batched": sched_stats(ss), "paged": st,
                      "mirror_checks": len(syncs), "token_agreement": same_tokens(slot, paged),
                      "arena_blocks": SCHED_ARENA}
    timing = {}
    prompts8 = np.random.default_rng(SCHED_SEED + 2).integers(
        1, cfg.vocab, (SCHED_SLOTS, PROMPT)).astype(np.int32)
    for route in ("dense", "fp32"):
        e = sched_use(engines[route])
        turns = {"pool": [], "generate_b8": []}
        for order in (("pool", "generate_b8"), ("generate_b8", "pool")):
            for what in order:
                if what == "pool":
                    turns[what].append(pool_ms_per_step(e))
                else:
                    out = e.generate(prompts8, max_new=MAX_NEW)
                    turns[what].append(1e3 * out["decode_s"] / (MAX_NEW - 1))
        timing[route] = turns
    res["ms_per_step"] = timing
    res["noise_table_bytes"] = SCHED_SLOTS * SCHED_MAX_LEN * cfg.padded_vocab * 4
    res["seconds"] = time.monotonic() - t_phase
    return res


# --------------------------------------------------------------------------
# phase 10: the scheduler's speculative rounds, slot pool and paged pool
# --------------------------------------------------------------------------


def spec_sched_phase(cfg, raw) -> dict:
    """Phase 10: phase 9's pool (8 slots, segments of 8) and 24-request
    traffic under sequential admission, on phase 8's tiered weights, bf16
    activations, ``max_len`` ``SPEC_MAX_LEN``; the verifier dense and packed
    with fp32 and int8 values, the drafter at ``DRAFT_SPARSITY``.  Per
    route, pool (slot, paged) and temperature: the speculative scheduler
    against the plain one on the same engine, bitwise; paged against the
    slot pool, bitwise; the speculative pool graph's B1-B4 launches against
    rounds x (draft_k x ``planned_launches`` on the float route + the same on
    the verifier's), on the first ``SPEC_SCHED_LAYERS`` layers.  Reported:
    acceptance, ``stats()``, ms per pool round."""
    t_phase = time.monotonic()
    params = tiered(raw)
    params = {**params, "layers": first_layers(params["layers"], SPEC_SCHED_LAYERS)}
    cfg = dataclasses.replace(cfg, n_layers=SPEC_SCHED_LAYERS)
    timed = sched_traffic(cfg, arrivals=True)
    per = planned_launches(cfg)
    res, drafter = {"runs": {}, "ms_per_round": {}, "graph_launches": {}}, None
    reset_launch_counts()
    for route in ("fp32", "int8", "dense"):
        e = Engine(cfg, params, ServeConfig(
            max_len=SPEC_MAX_LEN, packed_weights=False if route == "dense" else "all",
            packed_values="int8" if route == "int8" else "bf16", speculative=True,
            draft_k=DRAFT_K, draft_sparsity=DRAFT_SPARSITY), device=DEVICE)
        drafter = e.draft_packed if drafter is None else drafter
        e._draft_packed = drafter  # the drafter depends on the weights alone
        vd = {"fp32": "dense", "int8": "int8", "dense": None}[route]
        for temp in (0.0, 1.0):
            tag = f"speculative scheduler {route} {'sampled' if temp else 'greedy'}"
            got = {}
            for paged in (False, True):
                pool = "paged" if paged else "slot"
                kw = dict(max_len=SPEC_MAX_LEN, temperature=temp,
                          page_size=SCHED_PAGE if paged else 0, prefix_cache=False)
                sp, spec, launches = sched_run(sched_use(e, speculative=True, **kw), timed,
                                               "sequential")
                spl, plain, _ = sched_run(sched_use(e, speculative=False, **kw), timed,
                                          "sequential")
                for rid, c in spec.items():
                    if c.status.value != "OK" or not np.array_equal(c.tokens,
                                                                    plain[rid].tokens):
                        fail(f"{tag} {pool}: request {rid} ({c.status.value}) differs from the "
                             "plain scheduler's")
                rounds = sp.stats()["segments"] * SCHED_SEGMENT
                want_l = {}
                for name, n in per.items():
                    want_l[name] = {"dense": rounds * DRAFT_K * n}
                    if vd is not None:
                        want_l[name][vd] = want_l[name].get(vd, 0) + rounds * n
                got_l = {name: {k: v for k, v in c.items() if v}
                         for name, c in launches.items()}
                if got_l != want_l:
                    fail(f"{tag} {pool}: pool graph launches {got_l} != expected {want_l}")
                res["graph_launches"][f"{route} {pool} {'sampled' if temp else 'greedy'}"] = got_l
                st, stp = sched_stats(sp), sched_stats(spl)
                st.update({k: sp.stats()[k] for k in ("acceptance_rate", "spec_proposed",
                                                      "spec_accepted")})
                st["rounds"] = rounds
                res["runs"][f"{route} {pool} {'sampled' if temp else 'greedy'}"] = {
                    "speculative": st, "plain": stp}
                got[pool] = spec
            if same_tokens(got["slot"], got["paged"]) != 1.0:
                fail(f"{tag}: the paged pool's tokens differ from the slot pool's")
        res["ms_per_round"][route] = {
            "slot": pool_ms_per_step(sched_use(e, speculative=True, max_len=SPEC_MAX_LEN)),
            "paged": pool_ms_per_step(sched_use(e, speculative=True, max_len=SPEC_MAX_LEN,
                                                page_size=SCHED_PAGE)),
            "plain_pool_step": pool_ms_per_step(sched_use(e, speculative=False,
                                                          max_len=SPEC_MAX_LEN))}
    res["launches"] = {"vusa_packed_matmul": dict(vusa_packed_matmul.launches),
                       "vusa_fused_mlp_matmul": dict(vusa_fused_mlp_matmul.launches)}
    for name, c in res["launches"].items():
        for route in ("dense", "int8"):
            if not c.get(route):
                fail(f"speculative scheduler: {name} never launched on the {route} route")
    res["seconds"] = time.monotonic() - t_phase
    return res


# --------------------------------------------------------------------------
# phase 11: the failure model
# --------------------------------------------------------------------------


def failure_phase(cfg, params, raw) -> dict:
    """Phase 11 over phase 9's model (fp32 values) and traffic, sequential
    admission, each fault a run of its own: value NaNs in the pack, cache
    poison (slot pool and paged), a persistent poison, the speculative
    verifier's quarantine, the journal with an unclean close and
    ``AsyncEngine.recover``, the watchdog on a transient hang, and a hot
    swap through ``AsyncEngine``; each against a clean run, bitwise."""
    from repro_torch.checkpoint.ckpt import read_records
    from repro_torch.serve import AsyncEngine, FaultConfig, Journal, JournalTap, replay
    from repro_torch.serve.packed import pack_fingerprint

    t_phase = time.monotonic()
    timed = sched_traffic(cfg, arrivals=True)
    out_dir = ROOT / "build" / "journals"  # gitignored, made at run time
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}

    def engine(route="fp32", p=params, max_len=SCHED_MAX_LEN, **kw):
        return Engine(cfg, p, ServeConfig(max_len=max_len, packed_weights=False if route ==
                                          "dense" else "all", **kw), device=DEVICE)

    def run(e, reqs=timed, **kw):
        sched = Scheduler(e, slots=SCHED_SLOTS, segment=SCHED_SEGMENT, admission="sequential",
                          **kw)
        return sched, sched.run([dataclasses.replace(r) for r in reqs])

    def same(tag, got, want, statuses=("OK",)):
        for rid, w in want.items():
            c = got[rid]
            if c.status.value not in statuses or not np.array_equal(c.tokens, w.tokens):
                fail(f"failure {tag}: request {rid} ({c.status.value}) differs from the clean run")

    def counters(sched):
        st = sched.stats()
        return {k: st[k] for k in ("fallback", "failed", "quarantined", "preempted", "stalled")}

    _, clean_dense = run(engine("dense"))
    fp32 = engine()
    _, clean_fp32 = run(fp32)

    # value NaNs: the guard trips in the replayed packed pool graph
    e = engine(faults=FaultConfig(pack_value_nans=2))
    sched, done = run(e)
    g_packed = e._graphs[e._pool_key(sched._pool, False)]
    g_dense = e._graphs[e._pool_key(sched._pool, True)]
    tripped = [rid for rid, c in done.items() if c.status.value == "FAILED_FALLBACK_OK"]
    if not (e.quarantined and tripped and g_packed.replays > 0 and g_dense.replays > 0):
        fail(f"failure value NaNs: quarantined {e.quarantined}, tripped {tripped}, replays "
             f"packed {g_packed.replays} dense {g_dense.replays}")
    same("value NaNs", done, clean_dense, ("OK", "FAILED_FALLBACK_OK"))
    res["value_nans"] = {**counters(sched), "tripped": len(tripped),
                         "packed_replays": g_packed.replays, "dense_replays": g_dense.replays}

    # cache poison on a dense engine, slot pool and paged pool; persistent
    poisoned = (3, 11)
    for name, kw, once in (("cache_poison_slot", {}, True),
                           ("cache_poison_paged", {"page_size": SCHED_PAGE,
                                                   "prefix_cache": False}, True),
                           ("persistent_poison", {}, False)):
        e = engine("dense", faults=FaultConfig(cache_nan_rids=poisoned, cache_nan_once=once),
                   **kw)
        sched, done = run(e)
        want = "FAILED_FALLBACK_OK" if once else "FAILED"
        for rid in poisoned:
            if done[rid].status.value != want:
                fail(f"failure {name}: request {rid} {done[rid].status.value}, not {want}")
        same(name, {r: c for r, c in done.items() if r not in poisoned or once},
             {r: c for r, c in clean_dense.items() if r not in poisoned or once},
             ("OK", "FAILED_FALLBACK_OK"))
        res[name] = counters(sched)
        if e.quarantined or res[name]["fallback"] != len(poisoned):
            fail(f"failure {name}: {res[name]}")

    # the speculative verifier's quarantine falls back dense
    e = engine(max_len=SPEC_MAX_LEN, speculative=True, draft_k=DRAFT_K,
               draft_sparsity=DRAFT_SPARSITY, faults=FaultConfig(pack_value_nans=2))
    sched, done = run(e)
    _, clean_272 = run(engine("dense", max_len=SPEC_MAX_LEN))
    if not e.quarantined:
        fail("failure speculative quarantine: the pack was not quarantined")
    same("speculative quarantine", done, clean_272, ("OK", "FAILED_FALLBACK_OK"))
    res["spec_quarantine"] = counters(sched)

    # the journal: an unclean close mid-run, then AsyncEngine.recover
    path = out_dir / "failure_journal"
    if path.exists():
        path.unlink()
    journal = Journal(path)
    tap = JournalTap(journal)
    sched = Scheduler(fp32, slots=SCHED_SLOTS, segment=SCHED_SEGMENT, admission="sequential")
    for r in timed:
        tap.note_submit(sched.submit(dataclasses.replace(r)), r)
    journal.sync()

    class Crash(RuntimeError):
        pass

    syncs = []

    def crash(s):
        syncs.append(1)
        if len(syncs) > 5:
            raise Crash()
        tap.on_sync(s)

    try:
        sched.run(on_sync=crash)
        fail("failure journal: the run did not reach its crash point")
    except Crash:
        pass
    journal._fh.close()  # no close marker, no sync: the journal reads as a crash
    mid = replay(path)

    async def recover():
        eng = AsyncEngine.recover(path, Scheduler(fp32, slots=SCHED_SLOTS,
                                                  segment=SCHED_SEGMENT,
                                                  admission="sequential"))
        async with eng:
            return {rid: await eng.stream_for(rid).completion() for rid in range(len(timed))}

    done = run_async("failure journal recovery", recover)
    same("journal recovery", done, clean_fp32)
    final = replay(path)
    if not (final.closed and not final.pending and mid.pending and mid.completed):
        fail(f"failure journal: mid pending {len(mid.pending)} completed "
             f"{len(mid.completed)}; final closed {final.closed} pending {len(final.pending)}")
    res["journal"] = {"proven_before_recovery": len(mid.completed),
                      "recovered": len(mid.pending), "bytes": path.stat().st_size}

    # the watchdog on a transient hang
    hang = 5
    fp32.sc.faults = FaultConfig(decode_hang_rids=(hang,))
    sched = Scheduler(fp32, slots=SCHED_SLOTS, segment=SCHED_SEGMENT, admission="sequential")

    async def watched():
        async with AsyncEngine(sched, watchdog_s=WATCHDOG_S) as eng:
            streams = [eng.submit(dataclasses.replace(r), rid=i) for i, r in enumerate(timed)]
            return {i: await s.completion() for i, s in enumerate(streams)}

    t0 = time.monotonic()
    done = run_async("failure watchdog", watched)
    fp32.sc.faults = None
    same("watchdog", done, clean_fp32)
    if hang not in sched._stall_retried:
        fail("failure watchdog: the hang never fired")
    res["watchdog"] = {"seconds": time.monotonic() - t0, "watchdog_s": WATCHDOG_S,
                       "requeued": len(sched._stall_retried)}

    # the hot swap: wave 1 in flight at the swap, wave 2 on the new pack,
    # wave 3 after swapping back
    p90 = prune_tree(raw, 0.90)
    fresh = engine(p=p90)
    waves = [[dataclasses.replace(r, arrival_s=0.0) for r in timed[j : j + 8]]
             for j in (0, 8, 16)]
    _, want2 = run(fresh, waves[1])
    fp0 = pack_fingerprint(fp32.packed)
    path = out_dir / "swap_journal"
    if path.exists():
        path.unlink()

    async def swap():
        async with AsyncEngine(Scheduler(fp32, slots=SCHED_SLOTS, segment=SCHED_SEGMENT,
                                         admission="sequential"),
                               journal=Journal(path)) as eng:
            s1 = [eng.submit(r, rid=i) for i, r in enumerate(waves[0])]
            for s in s1:  # every request of wave 1 is in flight (8 slots)
                await s.__anext__()
            ok1 = await eng.hot_swap(p90)
            s2 = [eng.submit(r, rid=8 + i) for i, r in enumerate(waves[1])]
            c2 = [await s.completion() for s in s2]
            ok2 = await eng.hot_swap(params)
            s3 = [eng.submit(r, rid=16 + i) for i, r in enumerate(waves[2])]
            return ok1, ok2, [await s.completion() for s in s1], c2, [
                await s.completion() for s in s3]

    ok1, ok2, c1, c2, c3 = run_async("failure hot swap", swap)
    same("hot swap wave 1", dict(enumerate(c1)), {i: clean_fp32[i] for i in range(8)})
    same("hot swap wave 2 (new pack)", dict(enumerate(c2)), want2)
    same("hot swap wave 3", {16 + i: c for i, c in enumerate(c3)},
         {i: clean_fp32[i] for i in range(16, 24)})
    records = [json.loads(p) for p in read_records(path)[0]]
    fps = [r["fp"] for r in records if r.get("t") == "swap"]
    if not (ok1 and ok2 and fps == [pack_fingerprint(fresh.packed), fp0] and fps[0] != fp0):
        fail(f"failure hot swap: swapped {ok1} {ok2}, journaled fingerprints {fps}")
    state = replay(path)
    if not (state.closed and sorted(state.completed) == list(range(24))):
        fail(f"failure hot swap: the journal proves {len(state.completed)} of 24 completions")
    res["hot_swap"] = {"fingerprints": fps, "dropped": 0}
    res["seconds"] = time.monotonic() - t_phase
    return res


# --------------------------------------------------------------------------
# phase 12: training on the card, then the trained weights served
# --------------------------------------------------------------------------


def train_config(ckpt_dir: Path) -> TrainConfig:
    begin, end, every = TRAIN_PRUNE
    return TrainConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       prune_begin=begin, prune_end=end, prune_every=every,
                       ckpt_dir=str(ckpt_dir), ckpt_every=TRAIN_RESUME_AT, log_every=50,
                       token_range=TRAIN_TOKENS,
                       hp=TrainHParams(lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                       total_steps=TRAIN_STEPS, max_grad_norm=TRAIN_CLIP))


def stats_ms(xs) -> dict:
    return ({"median": float(np.median(xs)), "p90": float(np.percentile(xs, 90)),
             "n": len(xs)} if xs else {"n": 0})


def timed_train(cfg, tc) -> tuple:
    """Train with CUDA events around each call of the trainer's step: the
    step alone (start to end) and the whole loop iteration (one start to
    the next: mask refresh, checkpoint snapshot, data and host work
    included).  Returns (the trainer's result, per-step losses, step ms,
    iteration ms, wall seconds, peak device bytes above those held before)."""
    tr = Trainer(cfg, tc, device=DEVICE)
    inner, marks = tr.step_fn, []

    def step(params, opt, batch):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = inner(params, opt, batch)
        end.record()
        marks.append((start, end, out[2]["loss"]))
        return out

    tr.step_fn = step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    out = tr.train()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses = [float(m[2]) for m in marks]
    step_ms = [a.elapsed_time(b) for a, b, _ in marks]
    iter_ms = [a[0].elapsed_time(b[0]) for a, b in zip(marks, marks[1:])]
    return out, losses, step_ms, iter_ms, wall, torch.cuda.max_memory_allocated() - held


def same_state(a: dict, b: dict) -> bool:
    """Params, both moments and the step count equal bitwise."""
    def leaves(o):
        return [t for _, t in tree_items({"p": o["params"], "mu": o["opt"].mu,
                                          "nu": o["opt"].nu})] + [o["opt"].step]

    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def trained_kernel_checks(cfg, engines) -> list:
    """Layer 0's trained packs and the head through B1-B4 against their
    plain versions, phase 3's tolerance and row checks (untimed)."""
    rng = np.random.default_rng(5)
    d = cfg.d_model

    def xs():
        x4 = torch.from_numpy(rng.standard_normal((BATCH, d), dtype=np.float32)).to(DEVICE)
        x40 = torch.from_numpy(rng.standard_normal((POOL_VERIFY_ROWS, d),
                                                   dtype=np.float32)).to(DEVICE)
        return [v for x in (x4[:1], torch.cat([x4, x4[:1]]), x40, x4)
                for v in (x, x.to(torch.bfloat16))]

    records = []
    for route, e in engines.items():
        packed = e.packed
        for n in ("wq", "wk", "wv", "wo"):
            records.append(check_packed_matmul(None, f"trained {n}[layer0] {route}",
                                               _as_linear(packed["attn"][n], 0), xs(), False))
        records.append(check_packed_matmul(None, f"trained lm_head {route}",
                                           _as_linear(packed["head"]), xs(), False))
        trio = [_as_linear(packed["mlp"][n], 0) for n in ("w_gate", "w_up", "w_down_t")]
        records.append(check_fused_mlp(None, f"trained mlp[layer0] {route}", *trio, xs(), False))
    return records


def train_phase(cfg, rand) -> dict:
    """Phase 12.  ``rand`` holds the random-weight numbers the trained ones
    are reported beside (phases 4, 8 and 9)."""
    t_phase = time.monotonic()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out, losses, step_ms, iter_ms, wall, peak = timed_train(cfg, train_config(TRAIN_DIR / "a"))
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"train: {len(losses)} steps run, finite losses {np.isfinite(losses).all()}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if first - last < TRAIN_LOSS_DROP:
        fail(f"train: the loss fell {first - last:.4f} nats ({first:.4f} -> {last:.4f}), "
             f"less than {TRAIN_LOSS_DROP}")
    if abs(out["sparsity"] - cfg.sparsity) > TRAIN_SPARSITY_TOL:
        fail(f"train: sparsity {out['sparsity']:.4f}, target {cfg.sparsity}")
    begin, _, every = TRAIN_PRUNE
    refresh = {k for k in range(TRAIN_STEPS) if k >= begin and k % every == 0}
    ckpt = {TRAIN_RESUME_AT - 1}
    res = {"steps": TRAIN_STEPS, "loss_first10": first, "loss_last10": last,
           "loss_first": losses[0], "loss_last": losses[-1], "sparsity": out["sparsity"],
           "losses_every_10": losses[::10], "wall_s": wall, "peak_bytes": peak,
           "ms_per_step": {
               "step": stats_ms(step_ms),
               "iteration": stats_ms([t for k, t in enumerate(iter_ms) if k not in ckpt]),
               "iteration_no_refresh": stats_ms([t for k, t in enumerate(iter_ms)
                                                 if k not in ckpt | refresh]),
               "iteration_refresh": stats_ms([t for k, t in enumerate(iter_ms)
                                              if k in refresh - ckpt]),
               "iteration_checkpoint": stats_ms([iter_ms[k] for k in ckpt])}}
    res["tok_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (
        res["ms_per_step"]["iteration_no_refresh"]["median"] / 1e3)

    # resume on the card: a second trainer restores the TRAIN_RESUME_AT checkpoint
    # and runs to the end; it must equal the uninterrupted run bitwise
    src = TRAIN_DIR / "a" / f"step_{TRAIN_RESUME_AT:08d}"
    if not (src / "manifest.json").exists():
        fail(f"train: no checkpoint at step {TRAIN_RESUME_AT}")
    shutil.copytree(src, TRAIN_DIR / "b" / src.name)
    t0 = time.monotonic()
    resumed = Trainer(cfg, train_config(TRAIN_DIR / "b"), device=DEVICE).train()
    res["resume_s"] = time.monotonic() - t0
    if resumed["steps_run"] != TRAIN_STEPS - TRAIN_RESUME_AT:
        fail(f"train resume: {resumed['steps_run']} steps run after the restore")
    if not same_state(out, resumed):
        fail("train resume: the resumed run's params / optimizer state differ from the "
             "uninterrupted run's")
    res["resume_bitwise"] = True
    del resumed
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # serve the trained weights
    params = out["params"]
    del out
    max_len = PROMPT + MAX_NEW + 8
    t0 = time.monotonic()
    engines = {route: Engine(cfg, params, ServeConfig(
        max_len=max_len, packed_weights="all", fused=False,
        packed_values="bf16" if route == "fp32" else route), device=DEVICE)
        for route in ("fp32", "int8")}
    res["pack_s"] = time.monotonic() - t0
    res["kernel_checks"] = trained_kernel_checks(cfg, engines)
    res["pack_bytes"] = {r: pack_bytes(e.packed) for r, e in engines.items()}
    res["byte_ratio"] = {r: packed_byte_ratios(e.packed)["total"] for r, e in engines.items()}
    del engines

    prompts = prompts_for(cfg)
    stream = np.random.default_rng(1).integers(0, TRAIN_TOKENS, (BATCH, PROMPT)).astype(np.int32)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cut_params = {**params, "layers": first_layers(params["layers"])}
    res["tokens"] = {}
    cut = dataclasses.replace(cfg32, n_layers=DEPTH_CUT)
    for name, c, p in (("fp32_depth_cut", cut, cut_params), ("fp32", cfg32, params)):
        dense = Engine(c, p, ServeConfig(max_len=max_len, fused=False), device=DEVICE)
        pk = Engine(c, p, ServeConfig(max_len=max_len, packed_weights="all", fused=False),
                    device=DEVICE)
        agree = {}
        for label, pr in (("phase4_prompts", prompts), ("stream_prompts", stream)):
            a, b = pk.generate(pr, MAX_NEW), dense.generate(pr, MAX_NEW)
            if not (a["finite"] and b["finite"]):
                fail(f"train serve {name}: non-finite logits")
            agree[label] = float((a["tokens"] == b["tokens"]).mean())
        res["tokens"][name] = agree
        del dense, pk
    if min(res["tokens"]["fp32_depth_cut"].values()) != 1.0:
        fail(f"train serve: {DEPTH_CUT}-layer fp32 packed and dense greedy tokens differ on "
             f"the trained weights: {res['tokens']['fp32_depth_cut']}")
    # int8 values against the dense path on the same quantize-dequantize
    # weights, from one primed cache (phase 5's comparison)
    res["tokens"]["int8_depth_cut"] = quantized_parity(cut, cut_params, "int8", max_len)
    if res["tokens"]["int8_depth_cut"]["token_agreement"] != 1.0:
        fail(f"train serve: {DEPTH_CUT}-layer int8 packed and qdq dense greedy tokens differ "
             f"on the trained weights: {res['tokens']['int8_depth_cut']}")

    spec = Engine(cfg, params, ServeConfig(max_len=max_len, packed_weights="all",
                                           speculative=True, draft_k=DRAFT_K,
                                           draft_sparsity=DRAFT_SPARSITY), device=DEVICE)
    res["speculative"] = {}
    for label, pr in (("phase8_prompt", prompts[:1]), ("stream_prompt", stream[:1])):
        r = spec.generate(pr, MAX_NEW)
        plain = use(spec, speculative=False).generate(pr, MAX_NEW)
        use(spec, speculative=True)
        if not np.array_equal(r["tokens"], plain["tokens"]):
            fail(f"train serve: speculative tokens differ from plain decode's ({label})")
        res["speculative"][label] = {k: r[k] for k in ("spec_rounds", "spec_proposed",
                                                       "spec_accepted", "acceptance_rate")}
    del spec
    reqs = sched_traffic(cfg, False)
    res["prime_many_vs_prime"] = [prime_gap(cfg, params, reqs, n)
                                  for n in (DEPTH_CUT, cfg.n_layers)]
    res["random_weights"] = rand
    res["seconds"] = time.monotonic() - t_phase
    return res


def print_train(cfg, train: dict, card: str) -> None:
    """Phase 12's lines."""
    rand = train["random_weights"]
    ms = train["ms_per_step"]
    print(f"train vusa_edge (12 layers, d 768, bf16, remat; batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, tokens from [0, {TRAIN_TOKENS}), {TRAIN_STEPS} steps, lr {TRAIN_LR}): "
          f"loss {train['loss_first10']:.4f} (first 10 steps) -> {train['loss_last10']:.4f} "
          f"(last 10), sparsity {train['sparsity']:.4f}; ms per step (CUDA events, median / "
          f"p90): step {ms['step']['median']:.3f} / {ms['step']['p90']:.3f}, iteration "
          f"{ms['iteration']['median']:.3f} / {ms['iteration']['p90']:.3f}, without the "
          f"mask-refresh steps {ms['iteration_no_refresh']['median']:.3f} / "
          f"{ms['iteration_no_refresh']['p90']:.3f}, refresh steps "
          f"{ms['iteration_refresh']['median']:.3f} / {ms['iteration_refresh']['p90']:.3f}, the "
          f"checkpoint step {ms['iteration_checkpoint']['median']:.3f}; "
          f"{train['tok_per_s']:.1f} tokens/s; trainer peak memory {train['peak_bytes']} bytes; "
          f"{train['wall_s']:.1f} s of training; resumed from step {TRAIN_RESUME_AT} bitwise "
          f"the uninterrupted run ({train['resume_s']:.1f} s) ({card})", flush=True)
    for r in train["kernel_checks"]:
        print(f"train kernel check {r['name']}: ok, worst error "
              f"{max(c['rel_err'] for c in r['cases']):.3g} of max |plain|", flush=True)
    sp = train["speculative"]
    pg = {g["layers"]: g for g in train["prime_many_vs_prime"]}
    pr = {g["layers"]: g for g in rand["prime_many_vs_prime"]}
    print(f"train serve (trained weights; random-weight numbers in brackets): packs "
          f"{train['pack_bytes']} bytes, byte ratio {train['byte_ratio']}; fp32 packed vs dense "
          f"token agreement {DEPTH_CUT} layers {train['tokens']['fp32_depth_cut']}, "
          f"{cfg.n_layers} layers {train['tokens']['fp32']} [{rand['fp32_token_agreement']:.4f}]"
          f"; int8 vs qdq dense {DEPTH_CUT} layers "
          f"{train['tokens']['int8_depth_cut']['token_agreement']:.4f}; speculative B=1 greedy "
          f"acceptance (99 % drafter, fp32 verifier) phase 8's prompt "
          f"{sp['phase8_prompt']['acceptance_rate']:.4f}, a training-stream prompt "
          f"{sp['stream_prompt']['acceptance_rate']:.4f} "
          f"[{rand['spec_acceptance_fp32_greedy']:.4f}, tiered random weights]; prime_many vs "
          f"prime fp32 gap {DEPTH_CUT} layers {pg[DEPTH_CUT]['gap_rel']:.3g} "
          f"[{pr[DEPTH_CUT]['gap_rel']:.3g}], {cfg.n_layers} layers "
          f"{pg[cfg.n_layers]['gap_rel']:.3g} [{pr[cfg.n_layers]['gap_rel']:.3g}] of the largest "
          f"logit; phase {train['seconds']:.1f}s ({card})", flush=True)


# --------------------------------------------------------------------------
# phase 13: the decoder-only families at their own widths
# --------------------------------------------------------------------------


def family_cfg(arch):
    """``arch``'s published config at ``FAM_DEPTH[arch]`` layers (None: full
    depth); every width as published."""
    cfg = get_config(arch)
    depth = FAM_DEPTH[arch]
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def fan_in(name: str, shape) -> int:
    """The size of the dims a weight contracts over: d_model for wq/wk/wv
    (d, heads, hd), heads x hd for wo (heads, hd, d), else ``shape[-2]``
    (the leading layer axis aside)."""
    if name in ("wq", "wk", "wv"):
        return shape[-3]
    if name == "wo":
        return shape[-3] * shape[-2]
    return shape[-2] if len(shape) >= 2 else shape[-1]


def device_init(cfg) -> dict:
    """Random parameters of ``cfg`` drawn on the card, from a generator
    seeded by ``numpy.random.default_rng(FAM_SEED)`` (drawing billions of
    entries with numpy on the host would take minutes), each weight with
    std ``scale / sqrt(fan_in)`` over the dims it contracts (``fan_in``).
    The port's init takes ``shape[-2]`` for every leaf, as the reference
    does, which makes the 3-D attention weights 4-30x too large at these
    widths; the random deep model then amplifies fp32 rounding until
    packed and dense logits part (ROADMAP C6;
    ``scripts/init_rule_gap.py``).  The leaves the init sets to zero, the
    QKV biases and the norm scales, are drawn from normal(0,
    ``FAM_PERTURB_STD``) instead, so a missing or misplaced bias or norm
    changes the logits.  The leaves the init sets to one (the SSM's
    ``A_log`` and ``D``, the RG-LRU's ``lam``) are drawn from normal(1,
    ``FAM_PERTURB_STD``): a weight's std would put them near 0."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(int(np.random.default_rng(FAM_SEED).integers(2**62)))

    def build(tree):
        out = {}
        for name, spec in tree.items():
            if isinstance(spec, dict):
                out[name] = build(spec)
                continue
            std = (FAM_PERTURB_STD if spec.init in ("zeros", "ones")
                   else spec.scale / math.sqrt(max(fan_in(name, spec.shape), 1)))
            out[name] = torch.randn(spec.shape, generator=gen, device=DEVICE) * std
            if spec.init == "ones":
                out[name] += 1.0
        return out

    return build(build_model(cfg).specs())


def step_totals(recs: dict, n_layers: int, head) -> dict:
    """One decode step's kernel times from the timed layer-0 records: the
    four projections ``n_layers`` times plus the head record (or none), and
    the MLP ``n_layers`` times; the worst error over the records' cases."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    proj = [recs[n] for n in ("wq", "wk", "wv", "wo")]
    out = {"vusa_packed_matmul": {k: n_layers * sum(r["timing"][k] for r in proj)
                                  + (head["timing"][k] if head else 0.0) for k in keys},
           "vusa_fused_mlp_matmul": {k: n_layers * recs["mlp"]["timing"][k] for k in keys}}
    out["vusa_packed_matmul"]["max_abs_err"] = max(
        c["max_abs_err"] for r in proj + ([head] if head else []) for c in r["cases"])
    out["vusa_fused_mlp_matmul"]["max_abs_err"] = max(c["max_abs_err"]
                                                      for c in recs["mlp"]["cases"])
    out["vusa_packed_matmul"]["bound_by"] = (head or recs["wq"])["timing"]["bound_by"]
    out["vusa_fused_mlp_matmul"]["bound_by"] = recs["mlp"]["timing"]["bound_by"]
    return out


def layer0_records(timer, rng, arch, lins: dict, tag: str) -> dict:
    """Phase 3's checks and timings of one value route's layer-0 packs
    (``lins``: wq, wk, wv, wo and the fused MLP trio)."""
    recs = {n: check_packed_matmul(timer, f"{arch} {n}[layer0]{tag}", lins[n],
                                   activations(rng, lins[n].k), True)
            for n in ("wq", "wk", "wv", "wo")}
    gate, up, down_t = lins["mlp"]
    recs["mlp"] = check_fused_mlp(timer, f"{arch} mlp[layer0]{tag}", gate, up, down_t,
                                  activations(rng, gate.k), True)
    return recs


def layer0_packs(params, value_dtype: str) -> dict:
    """Layer 0's projections and MLP trio of ``params`` packed with
    ``value_dtype`` values (the engine's geometry: windows of 128, a = 16)."""
    attn, ffn = params["layers"]["attn"], params["layers"]["ffn"]
    names = ("wq", "wk", "wv", "wo")
    mats = [_flat_attn(attn[n][:1], n)[0] for n in names]
    mats += [ffn["w_gate"][0], ffn["w_up"][0], ffn["w_down"][0].T]
    lins = ops.pack_linear_rows_many([m.detach().float().cpu().numpy() for m in mats],
                                     dtype=torch.float32, device=DEVICE,
                                     value_dtype=value_dtype, dense_itemsize=4)
    return {**dict(zip(names, lins)), "mlp": tuple(lins[4:])}


def engine_layer0(eng) -> dict:
    """An engine's own layer-0 packs (the linears its decode step runs)."""
    attn, mlp = eng.packed["attn"], eng.packed["mlp"]
    return {**{n: _as_linear(attn[n], 0) for n in ("wq", "wk", "wv", "wo")},
            "mlp": tuple(_as_linear(mlp[n], 0) for n in ("w_gate", "w_up", "w_down_t"))}


def graph_vs_eager(tag, eng, eager, prompts, extras=None, counted=None) -> dict:
    """The engine's CUDA-graph ``generate`` against its eager run
    ``eager``: tokens bitwise; with ``counted`` (the wrapper launches of one
    step on a route) the graph's launches, replays x captured, exactly 31
    steps of them.  Returns the graph run's tok/s and ms per step."""
    g0 = eng.graph_launches()
    use(eng, fused=True)
    out = eng.generate(prompts, max_new=MAX_NEW, extras=extras)
    use(eng, fused=False)
    if not np.array_equal(out["tokens"], eager["tokens"]) or not out["finite"]:
        fail(f"{tag}: graph tokens differ from the eager loop's (finite={out['finite']})")
    if counted is not None:
        route, per = counted
        g1 = eng.graph_launches()
        got = {n: {k: v - g0.get(n, {}).get(k, 0) for k, v in c.items()} for n, c in g1.items()}
        want = {n: {k: per[n] * (MAX_NEW - 1) if k == route else 0 for k in got[n]}
                for n in got}
        if got != want:
            fail(f"{tag}: graph launches {got} != expected {want}")
    return {"tok_per_s": out["tok_per_s"], "ms_per_step": 1e3 * out["decode_s"] / (MAX_NEW - 1)}


def fp32_checks(tag, cfg, params, packed, prompts, max_len) -> dict:
    """fp32 activations: the first decode step's packed (``packed``) and
    dense logits from one prefill, within ``FP32_STEP_TOL`` of the largest
    logit; and greedy tokens of packed and dense ``generate`` identical
    when the model has ``DEPTH_CUT`` layers (the caller cuts it)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dense = Engine(cfg32, params, ServeConfig(max_len=max_len, fused=False), device=DEVICE)
    with torch.no_grad():
        nxt, cache = dense.prime(prompts)
        lp = lm_decode_step_packed(dense.params, packed, nxt, copy_cache(cache), cfg32)[0]
        ld = dense.model.decode_step(dense.params, nxt, copy_cache(cache))[0]
    gap, rel = rel_err(lp, ld)
    if rel > FP32_STEP_TOL:
        fail(f"{tag} fp32 first-step logits: packed vs dense gap {gap} ({rel} of the largest)")
    res = {"layers": cfg.n_layers, "first_step_logit_gap": gap, "first_step_logit_gap_rel": rel}
    if cfg.n_layers == DEPTH_CUT:
        pe = Engine(cfg32, params, ServeConfig(max_len=max_len, fused=False), device=DEVICE)
        pe._packed = packed  # the same pack: it holds the fp32 params' values
        a, b = (e.generate(prompts, max_new=MAX_NEW)["tokens"] for e in (pe, dense))
        res["token_agreement"] = float((a == b).mean())
        if res["token_agreement"] != 1.0:
            fail(f"{tag} fp32 {DEPTH_CUT}-layer packed and dense greedy tokens differ: "
                 f"{res['token_agreement']} agree")
    return res


def dense_family_run(timer, rng, arch, value_routes) -> dict:
    """One dense-family config: init on the card, 85 % pruning, a pack per
    value route; per route the counted eager ``generate`` (B = 4, prompt
    32, 32 new tokens, launches exactly ``planned_launches`` x 31 on the
    route, CUDA launches as planned) and the graph loop bitwise equal to it
    (graph launches as planned); layer 0's packs through phase 3's kernel
    checks and timings on every route (int4 from a repack of layer 0); the
    fp32 first-step gap and, on ``DEPTH_CUT`` layers, fp32 token identity
    (a cut of the model when it is deeper)."""
    t0 = time.monotonic()
    cfg = family_cfg(arch)
    params = prune_tree(device_init(cfg), cfg.sparsity)
    res = {"layers": cfg.n_layers, "routes": {}, "records": {}}
    prompts = prompts_for(cfg)
    max_len = PROMPT + MAX_NEW + 8
    per = planned_launches(cfg)
    engines = {}
    for route in value_routes:
        t1 = time.monotonic()
        eng = Engine(cfg, params, ServeConfig(max_len=max_len, packed_weights="all",
                                              packed_values=route, fused=False), device=DEVICE)
        vd = "dense" if route == "bf16" else route
        out, counts, per_call, peak = counted_run(cfg, eng, vd)
        r = {"launches": counts, "cuda_launches_per_call": per_call,
             "eager": {"tok_per_s": out["tok_per_s"],
                       "ms_per_step": 1e3 * out["decode_s"] / (MAX_NEW - 1)},
             "peak_bytes": peak, "byte_ratio": packed_byte_ratios(eng.packed)["total"],
             "pack_bytes_per_step": pack_bytes(eng.packed)}
        r["graph"] = graph_vs_eager(f"{arch} {route}", eng, out, prompts, counted=(vd, per))
        r["pack_s"] = time.monotonic() - t1
        res["routes"][route] = r
        engines[route] = eng
    head = None
    main = engines[value_routes[0]]
    if main.packed["head"] is not None:
        head = check_packed_matmul(timer, f"{arch} lm_head", _as_linear(main.packed["head"]),
                                   activations(rng, cfg.d_model), True)
        res["records"]["lm_head"] = head
    timed = {}
    for route in ("bf16", "int8", "int4"):
        lins = engine_layer0(engines[route]) if route in engines else layer0_packs(params, route)
        recs = layer0_records(timer, rng, arch, lins, "" if route == "bf16" else f" {route}")
        res["records"].update({f"{n} {route}": v for n, v in recs.items()})
        timed[route] = step_totals(recs, cfg.n_layers, head if route == "bf16" else None)
    res["step"] = timed
    res["fp32"] = fp32_checks(arch, cfg, params, main.packed, prompts, max_len)
    if cfg.n_layers != DEPTH_CUT:
        cut = dataclasses.replace(cfg, n_layers=DEPTH_CUT)
        cparams = {**params, "layers": first_layers(params["layers"])}
        ce = Engine(cut, cparams, ServeConfig(max_len=max_len, packed_weights="all",
                                              fused=False), device=DEVICE)
        res["fp32_depth_cut"] = fp32_checks(arch, cut, cparams, ce.packed, prompts, max_len)
    res["seconds"] = time.monotonic() - t0
    return res


def head_run(timer, rng, arch) -> dict:
    """An untied head of ``arch`` alone (K = d_model, C = the padded
    vocabulary), drawn on the card, pruned to 85 %, packed and held as phase
    3 holds a kernel."""
    cfg = get_config(arch)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(int(np.random.default_rng(FAM_SEED).integers(2**62)))
    w = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen, device=DEVICE)
    w = prune_tree({"lm_head": w / math.sqrt(cfg.d_model)}, cfg.sparsity)["lm_head"]
    (lin,) = ops.pack_linear_rows_many([w.cpu().numpy()], dtype=torch.float32, device=DEVICE,
                                       dense_itemsize=4)
    return check_packed_matmul(timer, f"{arch} lm_head", lin, activations(rng, cfg.d_model),
                               True)


@contextlib.contextmanager
def fp32_probs():
    """The flash attention's probabilities in fp32 (``layers.FLAGS``), as
    the reference's model tests pin them, inside the block."""
    prev = model_layers.FLAGS["attn_bf16_probs"]
    model_layers.FLAGS["attn_bf16_probs"] = False
    try:
        yield
    finally:
        model_layers.FLAGS["attn_bf16_probs"] = prev


def moe_run() -> dict:
    """``olmoe_1b_7b`` at full width, ``FAM_DEPTH`` layers, the published
    ``moe_cf``: dense ``generate`` eager and graph bitwise; stepwise decode
    against the teacher-forced forward at B = 1 in fp32 with a dropless
    ``moe_cf`` (``n_experts / top_k``), within ``FAM_TF_TOL``; a
    sequential-admission scheduler run on the slot pool, every completion
    bitwise one-shot ``generate`` at B = 1 (the pool step routes each slot
    alone)."""
    t0 = time.monotonic()
    arch = "olmoe_1b_7b"
    cfg = family_cfg(arch)
    params = prune_tree(device_init(cfg), cfg.sparsity)
    prompts = prompts_for(cfg)
    eng = Engine(cfg, params, ServeConfig(max_len=SCHED_MAX_LEN, fused=False), device=DEVICE)
    eng.generate(prompts, max_new=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager = eng.generate(prompts, max_new=MAX_NEW)
    peak = torch.cuda.max_memory_allocated()
    res = {"layers": cfg.n_layers, "moe_cf": cfg.moe_cf, "peak_bytes": peak,
           "eager": {"tok_per_s": eager["tok_per_s"],
                     "ms_per_step": 1e3 * eager["decode_s"] / (MAX_NEW - 1)}}
    res["graph"] = graph_vs_eager(arch, eng, eager, prompts)

    tf_cfg = dataclasses.replace(cfg, dtype="float32", moe_cf=cfg.n_experts / cfg.top_k)
    model = build_model(tf_cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, cfg.vocab, (1, 12))).to(DEVICE)
    with torch.no_grad(), fp32_probs():
        tf, _ = model(params, {"tokens": toks})
        cache = model.init_cache(1, 16, device=DEVICE)
        dec = torch.cat([model.decode_step(params, toks[:, t : t + 1], cache)[0]
                         for t in range(toks.shape[1])], dim=1)
    gap, rel = rel_err(dec, tf)
    if rel > FAM_TF_TOL:
        fail(f"{arch} decode vs teacher forcing (fp32, dropless): gap {gap} ({rel} of the largest)")
    res["decode_vs_teacher_forcing"] = {"moe_cf": tf_cfg.moe_cf, "gap": gap, "gap_rel": rel}

    reqs = sched_traffic(cfg, arrivals=False)[:FAM_SCHED_REQUESTS]
    use(eng, fused=True)
    sched, done, _ = sched_run(eng, reqs, admission="sequential")
    if any(c.status.value != "OK" for c in done.values()):
        fail(f"{arch} scheduler: {[c.status.value for c in done.values()]}")
    want = oracle_tokens(eng, reqs)
    for rid, w in enumerate(want):
        if not np.array_equal(done[rid].tokens, w):
            fail(f"{arch} scheduler: request {rid}'s tokens differ from one-shot generate")
    res["scheduler"] = sched_stats(sched)
    res["seconds"] = time.monotonic() - t0
    return res


def vlm_run() -> dict:
    """``paligemma_3b`` at full width, ``FAM_DEPTH`` layers: ``generate``
    with 256 seeded patch embeddings (normal, std 0.02, as the training
    pipeline makes them), eager and graph bitwise; the prefill's logits
    against the forward's last text logit in fp32, within ``FAM_TF_TOL``."""
    t0 = time.monotonic()
    arch = "paligemma_3b"
    cfg = family_cfg(arch)
    params = prune_tree(device_init(cfg), cfg.sparsity)
    prompts = prompts_for(cfg)
    patches = np.random.default_rng(3).normal(0, 0.02, (BATCH, cfg.patch_tokens, cfg.d_model))
    extras = {"patches": patches.astype(np.float32)}
    max_len = cfg.patch_tokens + PROMPT + MAX_NEW + 8
    eng = Engine(cfg, params, ServeConfig(max_len=max_len, fused=False), device=DEVICE)
    eng.generate(prompts, max_new=4, extras=extras)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager = eng.generate(prompts, max_new=MAX_NEW, extras=extras)
    res = {"layers": cfg.n_layers, "patch_tokens": cfg.patch_tokens,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "eager": {"tok_per_s": eager["tok_per_s"],
                     "ms_per_step": 1e3 * eager["decode_s"] / (MAX_NEW - 1)}}
    res["graph"] = graph_vs_eager(arch, eng, eager, prompts, extras)

    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    batch = {"tokens": torch.from_numpy(prompts[:1]).long().to(DEVICE),
             "patches": torch.from_numpy(extras["patches"][:1]).to(DEVICE)}
    with torch.no_grad(), fp32_probs():
        pf, _ = model.prefill(params, batch, max_len)
        tf, _ = model(params, batch)
    gap, rel = rel_err(pf, tf[:, -1])
    if rel > FAM_TF_TOL:
        fail(f"{arch} prefill vs forward (fp32): gap {gap} ({rel} of the largest)")
    res["prefill_vs_forward"] = {"gap": gap, "gap_rel": rel}
    res["seconds"] = time.monotonic() - t0
    return res


def release() -> None:
    """Give the card's memory back between the phase's models."""
    gc.collect()
    torch.cuda.empty_cache()


def families_phase() -> dict:
    """Phase 13 (module docstring).  Fails past ``FAM_PHASE_LIMIT_S``."""
    t0 = time.monotonic()
    print("families: depth cuts: " + "; ".join(f"{a} {w}" for a, w in FAM_CUT_WHY.items())
          + "; qwen2_0_5b whole (24 layers)", flush=True)
    timer, rng = Timer(), np.random.default_rng(13)
    res = {"qwen2_0_5b": dense_family_run(timer, rng, "qwen2_0_5b", ("bf16", "int8"))}
    release()
    res["qwen3_8b"] = dense_family_run(timer, rng, "qwen3_8b", ("bf16",))
    release()
    res["internlm2_1_8b"] = {"lm_head": head_run(timer, rng, "internlm2_1_8b")}
    release()
    res["olmoe_1b_7b"] = moe_run()
    release()
    res["paligemma_3b"] = vlm_run()
    release()
    res["seconds"] = time.monotonic() - t0
    if res["seconds"] > FAM_PHASE_LIMIT_S:
        fail(f"families phase took {res['seconds']:.1f}s, over its {FAM_PHASE_LIMIT_S:.0f}s")
    return res


def print_families(fam: dict, card: str) -> None:
    for arch in ("qwen2_0_5b", "qwen3_8b"):
        r = fam[arch]
        for route, x in r["routes"].items():
            print(f"families {arch} ({r['layers']} layers) {route} values: launches "
                  f"{x['launches']} over {MAX_NEW - 1} steps (as planned), CUDA launches per "
                  f"call {x['cuda_launches_per_call']}; graph tokens equal eager; graph "
                  f"{x['graph']['tok_per_s']:.1f} tok/s ({x['graph']['ms_per_step']:.4f} ms a "
                  f"step), eager {x['eager']['tok_per_s']:.1f} tok/s "
                  f"({x['eager']['ms_per_step']:.4f}); peak memory {x['peak_bytes']} bytes; "
                  f"byte ratio {x['byte_ratio']:.4f}; built and run in {x['pack_s']:.1f}s",
                  flush=True)
        for what in ("fp32", "fp32_depth_cut"):
            if what in r:
                print(f"families {arch} {what}: {r[what]}", flush=True)
        for route, st in r["step"].items():
            print(f"families {arch} one decode step, {route} values, B={BATCH} bf16: " + "; ".join(
                f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, library {v['library_ms']:.4f}, "
                f"bound {v['bound_ms']:.4f} by {v['bound_by']})" for k, v in st.items()),
                flush=True)
    for arch in ("qwen2_0_5b", "qwen3_8b", "internlm2_1_8b"):
        recs = fam[arch]["records"] if "records" in fam[arch] else fam[arch]
        for r in recs.values():
            worst = max(c["rel_err"] for c in r["cases"])
            t = r["timing"]
            print(f"families kernel check {r['name']} {r['shape'] if 'shape' in r else r['d']}: "
                  f"ok, worst error {worst:.3g}; B={t['B']} {t['x']}: {t['ms']:.4f} ms (plain "
                  f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} "
                  f"by {t['bound_by']})", flush=True)
    m = fam["olmoe_1b_7b"]
    st, tf = m["scheduler"], m["decode_vs_teacher_forcing"]
    print(f"families olmoe_1b_7b ({m['layers']} layers, moe_cf {m['moe_cf']}): graph tokens "
          f"equal eager; graph {m['graph']['tok_per_s']:.1f} tok/s "
          f"({m['graph']['ms_per_step']:.4f} ms a step), eager {m['eager']['tok_per_s']:.1f}; "
          f"peak memory {m['peak_bytes']} bytes; decode vs teacher forcing (fp32, moe_cf "
          f"{tf['moe_cf']}) {tf['gap_rel']:.3g}"
          f" of the largest logit; scheduler ({FAM_SCHED_REQUESTS} requests, sequential, slot "
          f"pool) every completion equals one-shot generate, {st['sustained_tok_per_s']:.1f} "
          f"sustained tok/s, TTFT p50 {st['ttft_p50_s'] * 1e3:.1f} ms, ITL p50 "
          f"{st['itl_p50_s'] * 1e3:.1f} ms; {m['seconds']:.1f}s", flush=True)
    v = fam["paligemma_3b"]
    g = v["graph"]
    print(f"families paligemma_3b ({v['layers']} layers, {v['patch_tokens']} patches): graph "
          f"tokens equal eager; graph {g['tok_per_s']:.1f} tok/s ({g['ms_per_step']:.4f} ms "
          f"a step), eager {v['eager']['tok_per_s']:.1f}; peak memory {v['peak_bytes']} bytes; "
          f"prefill vs forward (fp32) {v['prefill_vs_forward']['gap_rel']:.3g} of the largest "
          f"logit; {v['seconds']:.1f}s", flush=True)
    print(f"families phase {fam['seconds']:.1f}s (limit {FAM_PHASE_LIMIT_S:.0f}s; depth cuts "
          f"{ {a: d for a, d in FAM_DEPTH.items() if d} } layers, every width as published) "
          f"({card})", flush=True)


# --------------------------------------------------------------------------
# phase 14: the recurrent and encoder-decoder families
# --------------------------------------------------------------------------


def rec_cfg(arch):
    """``arch``'s published config at ``REC_DEPTH[arch]`` layers (None:
    whole); every width as published."""
    cfg = get_config(arch)
    depth = REC_DEPTH[arch]
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def rec_frames(cfg, b: int):
    """The encdec family's seeded stand-in frames (B, enc_frames, d), normal
    with std 0.02 as the training pipeline makes them; None for others."""
    if cfg.family != "encdec":
        return None
    rng = np.random.default_rng(3)
    return {"frames": rng.normal(0, 0.02, (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)}


def rec_generate_gates(arch, cfg, eng, prompts, extras) -> dict:
    """Gate 1: ``generate`` (B = 4, prompt 32, 32 new tokens) through the
    CUDA graph equals the eager loop bitwise, greedy and sampled, every
    token finite and in range; then graph and eager tok/s in turns (greedy,
    two turns each) and the eager run's peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for temp in (0.0, 1.0):
        use(eng, temperature=temp, fused=False)
        eager = eng.generate(prompts, max_new=MAX_NEW, extras=extras)
        use(eng, fused=True)
        graph = eng.generate(prompts, max_new=MAX_NEW, extras=extras)
        toks = graph["tokens"]
        if not (graph["finite"] and eager["finite"]) or toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"{arch} generate (T={temp}): non-finite logits or tokens out of range")
        if not np.array_equal(toks, eager["tokens"]):
            fail(f"{arch} generate (T={temp}): graph tokens differ from the eager loop's")
    res = {"peak_bytes": torch.cuda.max_memory_allocated(),
           "tok_per_s": {"eager": [], "graph": []}, "ms_per_step": {"eager": [], "graph": []},
           "prefill_s": {"eager": [], "graph": []}}
    use(eng, temperature=0.0)
    for _ in range(2):
        for mode in ("eager", "graph"):
            use(eng, fused=mode == "graph")
            out = eng.generate(prompts, max_new=MAX_NEW, extras=extras)
            res["tok_per_s"][mode].append(out["tok_per_s"])
            res["ms_per_step"][mode].append(1e3 * out["decode_s"] / (MAX_NEW - 1))
            res["prefill_s"][mode].append(out["prefill_s"])
    return res


def capture(body):
    """``body`` run once on a side stream (the warm-up), then captured in a
    CUDA graph; returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph.replay


def rec_teacher_forcing(arch, cfg, params) -> dict:
    """Gate 2, fp32 (flash probabilities in fp32, as the reference's model
    tests pin them): B = 1 stepwise decode of ``REC_TF_POSITIONS[arch]``
    seeded tokens, each step replayed from a captured decode step fed the
    next token, against the teacher-forced forward's logits at the same
    position, within ``FAM_TF_TOL`` of the largest logit.  The hybrid's ring
    is ``min(window, max_len)`` = 2048 rows, so 2,100 positions wrap it;
    mamba2's 600 cross three SSD chunks of 256; whisper decodes from its
    prefill over 1,500 frames."""
    n = REC_TF_POSITIONS[arch]
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    toks = torch.from_numpy(np.random.default_rng(4).integers(1, cfg.vocab, (1, n))).to(DEVICE)
    batch = {"tokens": toks}
    extras = rec_frames(cfg, 1)
    if extras:
        batch["frames"] = torch.from_numpy(extras["frames"]).to(DEVICE)
    with torch.no_grad(), fp32_probs():
        tf = model(params, batch)[0][0]  # (n, V)
        if extras:
            cache = model.prefill(params, batch, n)[1]
        else:
            cache = model.init_cache(1, n, device=DEVICE)
        start = copy_cache(cache)
        tok = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
        out = torch.zeros((1, 1, tf.shape[-1]), dtype=torch.float32, device=DEVICE)

        def body():
            out.copy_(model.decode_step(params, tok, cache)[0])

        replay = capture(body)
        for name, leaf in cache.items():  # the warm-up stepped the cache
            leaf.copy_(start[name])
        gaps = torch.zeros(n, device=DEVICE)
        for t in range(n):
            tok.copy_(toks[:, t : t + 1])
            replay()
            gaps[t] = (out[0, 0] - tf[t]).abs().max()
        top = float(tf.abs().max())
    del replay
    gap = float(gaps.max())
    rel = gap / max(top, 1.0)
    if rel > FAM_TF_TOL:
        fail(f"{arch} decode vs teacher-forced forward (fp32, {n} positions): gap {gap} "
             f"({rel} of the largest logit), worst at position {int(gaps.argmax())}")
    return {"positions": n, "gap": gap, "gap_rel": rel, "max_abs_logit": top}


def rec_scheduler(arch, cfg, params) -> dict:
    """Gate 3: the pool step's rows at ``REC_SCHED_SLOTS`` slots bitwise B =
    1 steps on caches primed at ragged lengths; then 8 of phase 9's ragged
    requests through ``Scheduler.run`` on ``REC_SCHED_SLOTS`` slots (bf16
    activations, greedy, the graph loop), every completion bitwise one-shot
    ``generate`` at B = 1.  Reported: the run's stats and the pool's ms per
    step."""
    eng = Engine(cfg, params, ServeConfig(max_len=SCHED_MAX_LEN), device=DEVICE)
    rng = np.random.default_rng(SCHED_SEED + 2)
    lens = [int(x) for x in rng.integers(SCHED_PROMPTS[0], SCHED_PROMPTS[1] + 1,
                                         REC_SCHED_SLOTS)]
    axes = eng.model.cache_batch_axes(SCHED_MAX_LEN)
    with torch.no_grad():
        primed = [eng.prime(rng.integers(1, cfg.vocab, (1, k)).astype(np.int32)) for k in lens]
        token = torch.cat([t for t, _ in primed])
        ones = [eng._logits(token[i : i + 1], copy_cache(c), None) for i, (_, c) in
                enumerate(primed)]
        pool = eng.model.init_slot_cache(REC_SCHED_SLOTS, SCHED_MAX_LEN, device=DEVICE)
        for i, (_, c) in enumerate(primed):
            write_slots(pool, [i], c, axes, [lens[i]])
        many = eng._logits(token, pool, None, rowwise=True)
    for i, one in enumerate(ones):
        if not torch.equal(many[i : i + 1], one):
            fail(f"{arch} pool step: row {i} at {REC_SCHED_SLOTS} rows differs from a B = 1 step")
    reqs = sched_traffic(cfg, arrivals=False)[:FAM_SCHED_REQUESTS]
    sched = Scheduler(eng, slots=REC_SCHED_SLOTS, segment=SCHED_SEGMENT, admission="sequential")
    done = sched.run([dataclasses.replace(r) for r in reqs])
    if any(c.status.value != "OK" for c in done.values()):
        fail(f"{arch} scheduler: {[c.status.value for c in done.values()]}")
    for rid, w in enumerate(oracle_tokens(eng, reqs)):
        if not np.array_equal(done[rid].tokens, w):
            fail(f"{arch} scheduler: request {rid}'s tokens differ from one-shot generate")
    use(eng, seed=0)
    return {**sched_stats(sched), "pool_ms_per_step": pool_ms_per_step(
        eng, slots=REC_SCHED_SLOTS)}


def rec_run(arch) -> dict:
    """One family of phase 14 (module docstring): weights drawn on the card,
    the three gates (the scheduler's for the recurrent families only)."""
    t0 = time.monotonic()
    cfg = rec_cfg(arch)
    params = device_init(cfg)
    n_params = sum(v.numel() for _, v in tree_items(params))
    prompts = prompts_for(cfg)
    extras = rec_frames(cfg, BATCH)
    eng = Engine(cfg, params, ServeConfig(max_len=PROMPT + MAX_NEW + 8), device=DEVICE)
    res = {"layers": cfg.n_layers, "params": n_params,
           "generate": rec_generate_gates(arch, cfg, eng, prompts, extras)}
    del eng
    release()
    res["decode_vs_forward"] = rec_teacher_forcing(arch, cfg, params)
    release()
    if cfg.family != "encdec":
        res["scheduler"] = rec_scheduler(arch, cfg, params)
    res["seconds"] = time.monotonic() - t0
    return res


def recurrent_phase() -> dict:
    """Phase 14 (module docstring).  Fails past ``REC_PHASE_LIMIT_S``."""
    t0 = time.monotonic()
    print("recurrent families: depth cuts: " + "; ".join(
        f"{a} {w}" for a, w in REC_CUT_WHY.items()) + "; whisper_tiny whole",
        flush=True)
    reset_all_launch_counts()
    res = {}
    for arch in REC_ARCHS:
        res[arch] = rec_run(arch)
        release()
    res["kernel_launches"] = all_launch_counts()  # the reference packs only the dense family
    res["seconds"] = time.monotonic() - t0
    if res["seconds"] > REC_PHASE_LIMIT_S:
        fail(f"recurrent families phase took {res['seconds']:.1f}s, over its "
             f"{REC_PHASE_LIMIT_S:.0f}s")
    return res


def print_recurrent(rec: dict, card: str) -> None:
    for arch in REC_ARCHS:
        r = rec[arch]
        g, tf = r["generate"], r["decode_vs_forward"]
        line = (f"recurrent families {arch} ({r['layers']} layers, {r['params']} params): "
                f"graph tokens equal eager (greedy and sampled, B={BATCH}, prompt {PROMPT}, "
                f"{MAX_NEW} new, bf16); tok/s in turns graph {g['tok_per_s']['graph']}, eager "
                f"{g['tok_per_s']['eager']}; ms per step graph {g['ms_per_step']['graph']}, "
                f"eager {g['ms_per_step']['eager']}; prefill s graph {g['prefill_s']['graph']}, "
                f"eager {g['prefill_s']['eager']}; peak memory {g['peak_bytes']} bytes; decode "
                f"vs forward (fp32, {tf['positions']} positions) {tf['gap_rel']:.3g} of the "
                f"largest logit")
        if "scheduler" in r:
            st = r["scheduler"]
            line += (f"; scheduler ({FAM_SCHED_REQUESTS} requests, {REC_SCHED_SLOTS} slots, "
                     f"sequential) every completion equals one-shot generate, pool rows "
                     f"bitwise B = 1, {st['sustained_tok_per_s']:.1f} sustained tok/s, TTFT "
                     f"p50 {st['ttft_p50_s'] * 1e3:.1f} ms, ITL p50 "
                     f"{st['itl_p50_s'] * 1e3:.1f} ms, admission {st['admit_s']:.3f} s, "
                     f"decode {st['decode_s']:.3f} s, pool step "
                     f"{st['pool_ms_per_step']:.4f} ms")
        print(line + f"; {r['seconds']:.1f}s", flush=True)
    print(f"recurrent families phase {rec['seconds']:.1f}s (limit {REC_PHASE_LIMIT_S:.0f}s); "
          f"B1-B6 launches in the phase {rec['kernel_launches']} (none lies on these "
          f"families' path) ({card})", flush=True)


# --------------------------------------------------------------------------
# phase 15: the (data, model) mesh
# --------------------------------------------------------------------------


def mesh_cfg(arch: str, layers=None, dtype: str = "float32"):
    """``arch``'s published config, cut to ``layers`` (None: whole), in
    ``dtype`` activations: fp32 where the data split and the
    sequence-sharded attention are held against one device within a
    tolerance, as phase 13 holds its fp32 gates (in bf16 a prefill over
    another row count rounds every product anew)."""
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def mesh_log(what: str, t0: float) -> None:
    print(f"mesh phase: {what} at {time.monotonic() - t0:.1f}s", flush=True)


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def tree_digest(tree) -> str:
    """``digest`` of every leaf of ``tree`` in sorted key order, one leaf at
    a time."""
    h = hashlib.sha256()
    for _, t in tree_items(tree):
        if t is not None:
            h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mesh_engine(cfg, params, mesh, route: str = "bf16", max_len: int = PROMPT + MAX_NEW + 8,
                **kw):
    return Engine(cfg, params, ServeConfig(max_len=max_len, packed_weights="all",
                                           packed_values=route, **kw), device=DEVICE, mesh=mesh)


def mesh_counts() -> dict:
    return {"vusa_packed_matmul": dict(vusa_packed_matmul.launches),
            "vusa_fused_mlp_matmul": dict(vusa_fused_mlp_matmul.launches),
            "vusa_fused_mlp_partials": dict(vusa_fused_mlp_partials.launches),
            "vusa_window_sum": dict(vusa_window_sum.launches)}


def recorded_generate(eng, prompts, temperature: float) -> dict:
    """``generate`` (B = 4, ``MAX_NEW`` new tokens) on ``eng`` with each
    eager decode step's fp32 logits (this rank's rows) recorded where the
    step chooses its tokens (``Engine._emit``): the tokens, a digest of
    each step's logits, the wrapper launches, collectives and bytes of the
    call on this rank, its decode time and peak memory.  (A step captured
    whole in a CUDA graph records nothing per replay: there the tokens
    are the check.)"""
    use(eng, temperature=temperature)
    steps = []
    eng._emit = lambda st, lg: (steps.append(lg.clone()), Engine._emit(eng, st, lg))
    reset_all_launch_counts()
    comm.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = eng.generate(prompts, max_new=MAX_NEW)
    del eng._emit
    n = MAX_NEW - 1
    return {"tokens": out["tokens"], "digests": [digest(s) for s in steps],
            "launches": mesh_counts(),
            "collectives_per_step": comm.STATS["collectives"] / n,
            "bytes_per_step": comm.STATS["bytes"] / n, "ms_per_step": 1e3 * out["decode_s"] / n,
            "tok_per_s": out["tok_per_s"], "peak_bytes": torch.cuda.max_memory_allocated()}


def first_step_logits(eng, prompts) -> torch.Tensor:
    """The whole fp32 logits of the first decode step after the prefill, on
    a data axis from each rank's rows gathered (the step ``generate``
    takes)."""
    rows = eng._rows(len(prompts))
    split = rows is not None
    with torch.no_grad():
        nxt, cache = eng.prime(prompts[rows] if split else prompts, split=split)
        lg = eng._logits(nxt, cache, eng._route_pack(), split=split)[:, -1].float()
    return eng._whole(lg, rows).cpu()


def whole_packs(params, rng) -> dict:
    """Layer 0's wq, fused MLP trio and the LM head of ``params``, whole
    packs on this rank, fp32 and int8 values, with a B = 4 input each."""
    lp = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    wq = params["layers"]["attn"]["wq"][0]
    wq = wq.reshape(wq.shape[0], -1)
    out = {}
    for route in ("dense", "int8"):
        x = torch.from_numpy(rng.standard_normal((BATCH, wq.shape[0])).astype(np.float32))
        out[route] = {"x": x.to(DEVICE), "wq": ops.pack_linear_rows(wq, value_dtype=route),
                      "head": ops.pack_linear_rows(params["lm_head"], value_dtype=route),
                      "mlp": [ops.pack_linear_rows(lp[n], value_dtype=route)
                              for n in ("w_gate", "w_up")]
                      + [ops.pack_linear_rows_t(lp["w_down"], value_dtype=route)]}
    return out


def call_checks(packs: dict, mesh) -> dict:
    """Each sharded B1/B3 call (column windows gathered) and each
    gathered-partial B2/B4 call on this rank's windows of ``whole_packs``'
    packs bitwise the single-device call on the whole pack."""
    out = {}
    for route, pk in packs.items():
        x = pk["x"]
        local = {name: ops.local_windows(pk[name], mesh) for name in ("wq", "head")}
        mlp = [ops.local_windows(q, mesh) for q in pk["mlp"]]
        out[route] = {
            name: torch.equal(ops.apply_row_packed_sharded(x, q, mesh),
                              ops.apply_row_packed(x, pk[name])) for name, q in local.items()}
        out[route]["mlp"] = torch.equal(ops.apply_fused_mlp_sharded(x, *mlp, mesh),
                                        ops.apply_fused_mlp(x, *pk["mlp"]))
        out[route]["head_windows"] = local["head"].values.shape[0]
    return out


def mesh_sched_runs(e) -> dict:
    """Phase 9's traffic under sequential admission on ``e``: the slot pool
    and the paged pool without the prefix cache (pages of ``SCHED_PAGE``)
    at its staggered arrivals (every rank reads rank 0's clock, C15), and
    the paged pool with the prefix cache with every arrival at 0, so which
    prompts hit the cache is the queue's order alone.  Tokens by request
    and the runs' stats."""
    out = {}
    for what, kw, arrivals in (
            ("slot", {}, True), ("paged", {"page_size": SCHED_PAGE, "prefix_cache": False}, True),
            ("paged_prefix", {"page_size": SCHED_PAGE}, False)):
        reqs = sched_traffic(e.cfg, arrivals=arrivals)
        sched_use(e, **kw)
        comm.reset_stats()
        t0 = time.monotonic()
        sched = Scheduler(e, slots=SCHED_SLOTS, segment=SCHED_SEGMENT, admission="sequential")
        done = sched.run([dataclasses.replace(r) for r in reqs])
        st = sched_stats(sched)
        out[what] = {"tokens": [done[i].tokens.tolist() for i in sorted(done)],
                     "ok": all(c.status.value == "OK" for c in done.values()),
                     "seconds": time.monotonic() - t0, "collectives": comm.STATS["collectives"],
                     "bytes": comm.STATS["bytes"], **{k: st[k] for k in (
                         "sustained_tok_per_s", "decoded_tokens", "prefix_hits",
                         "prefix_hit_rate")}}
    return out


def mesh_train_config(steps: int, ckpt_dir=None) -> TrainConfig:
    begin, end, every = MESH_TRAIN_PRUNE
    return TrainConfig(steps=steps, global_batch=MESH_TRAIN_BATCH, seq_len=MESH_TRAIN_SEQ,
                       prune_begin=begin, prune_end=end, prune_every=every,
                       ckpt_dir=None if ckpt_dir is None else str(ckpt_dir), ckpt_every=steps,
                       log_every=1, token_range=TRAIN_TOKENS,
                       hp=TrainHParams(lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=steps,
                                       max_grad_norm=TRAIN_CLIP))


def mesh_train(cfg, mesh, steps: int, ckpt_dir: Path) -> dict:
    """``steps`` of the trainer on ``mesh``, its checkpoint written from the
    shards into ``ckpt_dir`` at the last step: per-step losses, per-step
    time, collectives and bytes a step on this rank, peak memory, and of
    the save this rank's card peak above what it held before (its state)
    and, on the writer, the host peak (``tracemalloc``: the numpy leaf and
    the read-back buffer) beside the largest leaf and shard; on the lead,
    digests of the final params (their zeros are the pruning masks) and
    moments, read from ``train()``'s views."""
    import tracemalloc

    comm.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, mesh_train_config(steps, ckpt_dir), device=DEVICE, mesh=mesh)
    save, box = tr._save, {}

    def measured(step, params, opt):  # the save alone: its card and host peaks
        torch.cuda.synchronize()
        box["peak_before"] = torch.cuda.max_memory_allocated()
        box["held"] = torch.cuda.memory_allocated()
        box["shard"] = max(t.numel() * t.element_size() for _, t in tree_items(params))
        torch.cuda.reset_peak_memory_stats()
        tracemalloc.start()
        save(step, params, opt)
        box["host_peak"] = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        torch.cuda.synchronize()
        box["save_peak"] = torch.cuda.max_memory_allocated() - box["held"]

    tr._save = measured
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.monotonic()
        out = tr.train()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    lead = not any(mesh.get_coordinate())
    whole = lead_tree({"params": out["params"], "mu": out["opt"].mu, "nu": out["opt"].nu}, lead)
    rec = {"losses": [r["loss"] for r in tr.metrics_log], "sparsity": out["sparsity"],
           "ms_per_step": 1e3 * wall / steps,
           "collectives_per_step": comm.STATS["collectives"] / steps,
           "bytes_per_step": comm.STATS["bytes"] / steps,
           "peak_bytes": max(torch.cuda.max_memory_allocated(), box["peak_before"]),
           "save": {k: box[k] for k in ("held", "save_peak", "host_peak", "shard")}}
    if lead:
        rec["params"] = tree_digest(whole["params"])
        rec["moments"] = tree_digest({"mu": whole["mu"], "nu": whole["nu"]})
        rec["save"]["leaf"] = max(t.numel() * t.element_size()
                                  for _, t in tree_items(whole["params"]))
    return rec


def mesh_lockstep(cfg, mesh, steps: int) -> dict:
    """The data-parallel step held against one device's in lockstep, for
    ``steps`` steps of the phase's stream (no pruning): each step the mesh
    step starts from this rank's shards of the single-device state and
    its rows of the batch, and the single-device step then advances that
    state, so the two steps are compared, not two trajectories (a
    free-running data-parallel run parts at its first update, where
    Adam's first step is the sign of every gradient: PERF.md §6).  Beside
    them, one device takes the same step with the batch in two
    microbatches (``TrainHParams.microbatches``), each data rank's rows:
    the mesh's arithmetic (each half's gradients, their sum, halved), on
    one device, with no collective.  Returns the losses of the mesh step
    and of one device's whole-batch step, whether this rank's updated
    shards (params and both moments) equal the microbatched step's
    bitwise (each layer's leaves gathered at use, their gradients
    reduce-scattered in rank order), the mesh step's global-norm gap to
    the microbatched step's (an ordered sum of the shards' squares), the
    global-norm gap between the microbatched and the whole-batch step (the
    card's own split-batch rounding, ``scripts/grad_split.py``), the mesh
    step's ms, collectives and bytes a step beside the plan's prediction,
    and its FSDP record (``fsdp_step``) a step."""
    tc = dataclasses.replace(mesh_train_config(steps), prune_begin=steps + 1)
    one = Trainer(cfg, tc, device=DEVICE)
    dp = Trainer(cfg, tc, device=DEVICE, mesh=mesh)
    halves = Trainer(cfg, dataclasses.replace(tc, hp=dataclasses.replace(tc.hp, microbatches=2)),
                     device=DEVICE)
    params, opt = one.init_state()
    data = iter(SyntheticDataset(cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
                                 token_range=tc.token_range))
    shard = functools.partial(shard_tree, placements=dp.p_shard, mesh=mesh)

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else None if v is None else v.clone()
                for k, v in tree.items()}

    def equal(a, b) -> bool:
        return all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))

    out = {k: [] for k in ("losses", "dp_losses", "bitwise", "split_gnorm_gaps", "norm_gaps",
                           "fsdp")}
    ms = []
    comm.reset_stats()
    for _ in range(steps):
        host = next(data)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
        rows = {k: torch.from_numpy(v[dp.rows]).to(DEVICE) for k, v in host.items()}
        state = AdamState(opt.step.clone(), shard(opt.mu), shard(opt.nu))
        sh = shard(params)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        (new, new_state, m_dp), fsdp = fsdp_step(dp, cfg, sh, lambda: dp.step_fn(sh, state,
                                                                                 rows))
        ms.append(1e3 * (time.monotonic() - t0))
        out["fsdp"].append(fsdp)
        acc, acc_opt, m_acc = halves.step_fn(
            clone(params), AdamState(opt.step.clone(), clone(opt.mu), clone(opt.nu)), batch)
        params, opt, m_one = one.step_fn(params, opt, batch)
        out["bitwise"].append(equal(new, shard(acc)) and equal(new_state.mu, shard(acc_opt.mu))
                              and equal(new_state.nu, shard(acc_opt.nu)))
        out["norm_gaps"].append(abs(float(m_dp["gnorm"]) / float(m_acc["gnorm"]) - 1))
        out["split_gnorm_gaps"].append(abs(float(m_acc["gnorm"]) / float(m_one["gnorm"]) - 1))
        out["losses"].append(float(m_one["loss"]))
        out["dp_losses"].append(float(m_dp["loss"]))
        del new, new_state, acc, acc_opt, sh
    return {**out, "ms_per_step": float(np.median(ms)),
            "collectives_per_step": comm.STATS["collectives"] / steps,
            "predicted": dp.plan.train_collectives(cfg, tc.seq_len, split=True),
            "bytes_per_step": comm.STATS["bytes"] / steps}


def mesh_rank(mesh, device, prompts) -> dict:
    """One rank of phase 15's 2x2 world: every case on this rank.  The 1x2
    runs take the mesh's ``model`` sub-mesh, the 2x1 runs its ``data``
    sub-mesh, and a 1x4 mesh over the same four ranks the tensor-parallel
    runs at four.  Of the two 1x2 meshes (one a data coordinate), each
    serves one value route and the first alone runs the rest; of the two
    2x1 meshes, the first alone runs: the second would repeat its work.
    Training runs the 2x1 lockstep on ranks 2 and 3, the ``data`` sub-mesh
    of the transposed 2x2 mesh (ranks [[0, 2], [1, 3]]; the 1x2 trainer is
    phase 17's), then one step on 2x2 to a checkpoint."""
    t_rank = time.monotonic()
    log = (lambda what: mesh_log(f"rank 0 {what}", t_rank)) if not any(
        mesh.get_coordinate()) else (lambda what: None)
    transposed = DeviceMesh(device.type, torch.arange(4).reshape(2, 2).T,
                            mesh_dim_names=mesh.mesh_dim_names)
    meshes = {"1x2": mesh["model"], "1x4": make_local_mesh(1, 4), "2x1": mesh["data"],
              "2x2": mesh}
    cfg = get_config("vusa_edge")
    out = {"calls": {}, "dp": {}, "sched": None}
    # the sharded kernel calls on phase 4's weights, bitwise (the
    # tensor-parallel runs are phase 17's)
    params = prune_tree(build_model(cfg).init(0, device=DEVICE), cfg.sparsity)
    packs = whole_packs(params, np.random.default_rng(7))
    log("params")
    group = comm.axis_index(mesh, "data")  # this rank's 1x2 mesh
    lead_2x1 = comm.axis_index(mesh, "model") == 0  # this rank's 2x1 mesh is the first
    for name in MESH_TP:
        if name == "1x4" or group == 0:
            out["calls"][name] = call_checks(packs, meshes[name])
        log(f"{name} kernel calls")
    del params, packs
    release()
    # data parallelism: the contracted fan-in (C6), 2 layers and
    # MESH_DP_LAYERS (2x2 at 12 is phase 17's: the same engine, packed fp32,
    # and the same gate)
    for layers in (DEPTH_CUT, MESH_DP_LAYERS):
        dcfg = mesh_cfg("vusa_edge", layers)
        p = prune_tree(device_init(dcfg), dcfg.sparsity)
        names = MESH_DP if layers == DEPTH_CUT else ("2x1",)
        for name in [n for n in names if lead_2x1 or n == "2x2"]:
            eng = mesh_engine(dcfg, p, meshes[name], fused=True)
            rec = {"first": first_step_logits(eng, prompts)}
            for temp in (MESH_TEMPS if layers == DEPTH_CUT else (0.0,)):
                rec[temp] = recorded_generate(eng, prompts, temp)
            out["dp"][(name, dcfg.n_layers)] = rec
            log(f"{name} {dcfg.n_layers} layers")
            del eng
            release()
        if layers == DEPTH_CUT:  # the scheduler on 2x2 over the 2-layer cut
            out["sched"] = mesh_sched_runs(mesh_engine(dcfg, p, mesh, max_len=SCHED_MAX_LEN))
            log("scheduler")
        del p
        release()
    # qwen2 at its published widths on 1x4: sequence-sharded prefill attention
    out["qwen2"] = {}
    for layers in (MESH_QWEN2_LAYERS, DEPTH_CUT):
        qcfg = mesh_cfg("qwen2_0_5b", layers)
        p = prune_tree(device_init(qcfg), qcfg.sparsity)
        eng = mesh_engine(qcfg, p, meshes["1x4"])
        calls = model_layers._maybe_seq_sharded_attention.calls
        rec = {"first": first_step_logits(eng, prompts),
               "seq_shard_calls": model_layers._maybe_seq_sharded_attention.calls - calls,
               "ff_windows": eng.packed["mlp"]["w_gate"]["values"].shape[1]}
        if layers == DEPTH_CUT:
            rec["tokens"] = recorded_generate(eng, prompts, 0.0)["tokens"]
        out["qwen2"][qcfg.n_layers] = rec
        log(f"qwen2 {qcfg.n_layers} layers")
        del eng, p
        release()
    # training at full width cut to MESH_TRAIN_LAYERS: 2x1 in lockstep
    # (ranks 2, 3; the 1x2 trainer is tensor-parallel, phase 17's), a
    # checkpoint written on 2x2
    tcfg = mesh_cfg("vusa_edge", MESH_TRAIN_LAYERS, get_config("vusa_edge").dtype)
    out["train"] = {}
    if group != 0:
        out["train"]["2x1"] = mesh_lockstep(tcfg, transposed["data"], MESH_TRAIN_STEPS)
    log("train 2x1 lockstep (ranks 2, 3)")
    out["train"]["2x2"] = mesh_train(tcfg, mesh, MESH_CKPT_STEPS, MESH_DIR / "ckpt")
    log("train 2x2")
    out["seconds"] = time.monotonic() - t_rank
    return out


def mesh_references(prompts) -> dict:
    """The single-device port's results of every case of ``mesh_rank``,
    on this process's card."""
    ref = {"dp": {}, "qwen2": {}}
    for layers in (DEPTH_CUT, MESH_DP_LAYERS):
        dcfg = mesh_cfg("vusa_edge", layers)
        p = prune_tree(device_init(dcfg), dcfg.sparsity)
        eng = mesh_engine(dcfg, p, None, fused=True)
        rec = {"first": first_step_logits(eng, prompts)}
        for temp in (MESH_TEMPS if layers == DEPTH_CUT else (0.0,)):
            rec[temp] = recorded_generate(eng, prompts, temp)
        ref["dp"][dcfg.n_layers] = rec
        del eng
        if layers == DEPTH_CUT:
            ref["sched"] = mesh_sched_runs(mesh_engine(dcfg, p, None, max_len=SCHED_MAX_LEN))
        del p
        release()
    for layers in (MESH_QWEN2_LAYERS, DEPTH_CUT):
        qcfg = mesh_cfg("qwen2_0_5b", layers)
        p = prune_tree(device_init(qcfg), qcfg.sparsity)
        eng = mesh_engine(qcfg, p, None)
        rec = {"first": first_step_logits(eng, prompts),
               "ff_windows": eng.packed["mlp"]["w_gate"]["values"].shape[1]}
        if layers == DEPTH_CUT:
            rec["tokens"] = recorded_generate(eng, prompts, 0.0)["tokens"]
        ref["qwen2"][qcfg.n_layers] = rec
        del eng, p
        release()
    return ref


def gap_rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def mesh_gates(ranks: list, ref: dict, t_ref: float) -> dict:
    """Phase 15's gates (module docstring) over every rank's ``mesh_rank``
    record beside this process's references (``mesh_references``, which
    took ``t_ref`` s); the phase's seconds are its slowest rank's part
    and the gates'.  Fails past ``MESH_PHASE_LIMIT_S``."""
    t_phase = time.monotonic()
    res = {"dp": {}, "calls": ranks[0]["calls"], "sched": {}, "qwen2": {},
           "train": {}, "reference_s": t_ref, "ranks_s": max(r["seconds"] for r in ranks),
           "rank_seconds": [r["seconds"] for r in ranks]}
    for i, r in enumerate(ranks):  # every sharded call bitwise its single-device call
        for name, routes in r["calls"].items():
            for route, c in routes.items():
                if not (c["wq"] and c["head"] and c["mlp"]):
                    fail(f"mesh {name} rank {i} {route}: a sharded kernel call is not bitwise "
                         f"its single-device call: {c}")
    # data parallelism: tokens on the depth cut, the first-step gap at full depth
    for (name, layers), got in ranks[0]["dp"].items():
        want = ref["dp"][layers]
        gap = gap_rel(got["first"], want["first"])
        rec = {"first_step_gap_rel": gap}
        for temp in (MESH_TEMPS if layers == DEPTH_CUT else (0.0,)):
            agree = float(np.mean(got[temp]["tokens"] == want[temp]["tokens"]))
            rec[f"token_agreement T={temp}"] = agree
            if layers == DEPTH_CUT and agree != 1.0:
                fail(f"mesh {name} {layers} layers T={temp}: tokens differ from one device's")
            rec.update({f"{k} T={temp}": got[temp][k] for k in (
                "collectives_per_step", "bytes_per_step", "ms_per_step", "tok_per_s",
                "peak_bytes")})
        if gap > MESH_LOGIT_TOL:
            fail(f"mesh {name} {layers} layers: first-step logit gap {gap:.3g} of the largest "
                 f"> {MESH_LOGIT_TOL}")
        res["dp"][f"{name} {layers} layers"] = rec
    # the scheduler on 2x2, sequential admission: bitwise slot and paged
    for what, got in ranks[0]["sched"].items():
        want = ref["sched"][what]
        same = got["tokens"] == want["tokens"]
        if not (same and got["ok"]):
            fail(f"mesh 2x2 scheduler {what}: completions differ from the single-device "
                 "scheduler's")
        if what == "paged_prefix" and not got["prefix_hits"]:
            fail("mesh 2x2 scheduler paged_prefix: no prompt hit the prefix cache")
        res["sched"][what] = {**{k: v for k, v in got.items() if k != "tokens"},
                              "tokens_equal": same,
                              "single_sustained_tok_per_s": want["sustained_tok_per_s"]}
    # qwen2 on 1x4: sequence-sharded prefill, padded ff windows, logits and tokens
    for layers, got in ranks[0]["qwen2"].items():
        want = ref["qwen2"][layers]
        gap = gap_rel(got["first"], want["first"])
        if got["seq_shard_calls"] == 0:
            fail("qwen2 on 1x4: the sequence-sharded attention did not run")
        if got["ff_windows"] * 4 != -(-want["ff_windows"] // 4) * 4:
            fail(f"qwen2 on 1x4: {got['ff_windows']} ff windows a rank for {want['ff_windows']}")
        if gap > MESH_LOGIT_TOL:
            fail(f"qwen2 on 1x4, {layers} layers: first-step logit gap {gap:.3g} > "
                 f"{MESH_LOGIT_TOL}")
        rec = {"first_step_gap_rel": gap, "seq_shard_calls": got["seq_shard_calls"],
               "ff_windows": f"{want['ff_windows']} -> {got['ff_windows'] * 4}"}
        if "tokens" in got:
            if not np.array_equal(got["tokens"], want["tokens"]):
                fail(f"qwen2 on 1x4, {layers} layers: tokens differ from one device's")
            rec["tokens_equal"] = True
        res["qwen2"][layers] = rec
    # training (1x2 is tensor-parallel: phase 17 holds it against one device)
    tr = {k: v for k, v in ranks[0]["train"].items() if k != "2x1"}
    lock = [r["train"]["2x1"] for r in ranks if "2x1" in r["train"]]
    if len(lock) != 2:
        fail(f"mesh 2x1 training ran on {len(lock)} ranks, not 2")

    def rel_gap(key):
        want = np.asarray(lock[0][key])
        return max(float(np.max(np.abs(np.asarray(r["dp_" + key]) - want) / np.abs(want)))
                   for r in lock)

    rel = rel_gap("losses")
    if rel > MESH_TRAIN_TOL:
        fail(f"mesh 2x1 training: a step's loss {rel:.3g} relative from one device's step from "
             f"the same state > {MESH_TRAIN_TOL}")
    if not all(all(r["bitwise"]) for r in lock):
        fail("mesh 2x1 training: a rank's updated shards differ from one device's step over "
             f"the same two halves of the batch: {[r['bitwise'] for r in lock]}")
    norm_gap = max(max(r["norm_gaps"]) for r in lock)
    if norm_gap > MESH_NORM_TOL:
        fail(f"mesh 2x1 training: the global norm {norm_gap:.3g} relative from the "
             f"microbatched step's > {MESH_NORM_TOL}")
    for i, r in enumerate(lock):
        if r["collectives_per_step"] != r["predicted"]:
            fail(f"mesh 2x1 training: rank {i} made {r['collectives_per_step']} collectives a "
                 f"step, predicted {r['predicted']}")
        r["fsdp_report"] = [fsdp_check(f"mesh 2x1 training: rank {i}", f) for f in r["fsdp"]]
    split_gap = max(lock[0]["split_gnorm_gaps"])
    like = build_model(mesh_cfg("vusa_edge", MESH_TRAIN_LAYERS)).init(0, device=DEVICE)
    got = restore(MESH_DIR / "ckpt", MESH_CKPT_STEPS, {"params": like, "opt": adamw_init(like)})
    if tree_digest(got["params"]) != tr["2x2"]["params"] or tree_digest(
            {"mu": got["opt"].mu, "nu": got["opt"].nu}) != tr["2x2"]["moments"]:
        fail("the checkpoint written on 2x2 does not restore bitwise on one device")
    # the checkpoint written from the shards, leaf by leaf: one device's files
    # (its leaves are the gathered tree's bits, the digests say: one device's
    # save of them is the restored tree's save)
    ckpt_save(MESH_DIR / "ckpt_one", MESH_CKPT_STEPS, got)
    step_dir = f"step_{MESH_CKPT_STEPS:08d}"
    mine, one = MESH_DIR / "ckpt" / step_dir, MESH_DIR / "ckpt_one" / step_dir
    names = sorted(f.name for f in one.iterdir())
    same, _, _ = filecmp.cmpfiles(mine, one, names, shallow=False)
    if sorted(f.name for f in mine.iterdir()) != names or len(same) != len(names):
        fail(f"the checkpoint written on 2x2 from shards differs from one device's save of the "
             f"gathered tree: {len(same)} of {len(names)} files equal")
    saves = [r["train"]["2x2"]["save"] for r in ranks]
    leaf = tr["2x2"]["save"]["leaf"]
    for i, sv in enumerate(saves):
        if sv["save_peak"] > leaf:
            fail(f"mesh 2x2 checkpoint: rank {i}'s card peak during the save is its state "
                 f"{sv['held']} + {sv['save_peak']} bytes, above the largest leaf's {leaf}")
    host = tr["2x2"]["save"]
    if host["host_peak"] > leaf + host["shard"] + (64 << 10):
        fail(f"mesh 2x2 checkpoint: the writer's host peak {host['host_peak']} bytes is above "
             f"the largest leaf {leaf} + a shard {host['shard']} + 64 KiB")
    res["train"] = {name: {k: v for k, v in r.items() if k not in ("params", "moments")}
                    for name, r in tr.items()}
    res["train"]["2x2"]["checkpoint"] = {
        "files_equal_one_device": f"{len(same)} of {len(names)}", "largest_leaf": leaf,
        "card_peak_above_state_per_rank": [sv["save_peak"] for sv in saves],
        "writer_host_peak": host["host_peak"]}
    res["train"]["2x1"] = {k: v for k, v in lock[0].items() if k not in (
        "losses", "dp_losses", "bitwise", "split_gnorm_gaps", "norm_gaps", "fsdp",
        "fsdp_report")}
    res["train"]["2x1_lockstep"] = {
        "loss_gap_rel": rel, "shards_bitwise_microbatched": True,
        "gnorm_gap_rel_microbatched": norm_gap,
        "fsdp_per_rank": [r["fsdp_report"][0] for r in lock],
        "microbatched_vs_whole_gnorm_gap_rel": split_gap}
    del got, like
    release()
    res["seconds"] = res["ranks_s"] + time.monotonic() - t_phase
    if res["seconds"] > MESH_PHASE_LIMIT_S:
        fail(f"mesh phase took {res['seconds']:.1f}s, over its {MESH_PHASE_LIMIT_S:.0f}s")
    return res


def print_mesh(m: dict, card: str) -> None:
    print(f"mesh: the ranks of every mesh are processes sharing this one card over gloo, their "
          f"collectives staged through host memory: the times below are not multi-GPU speeds "
          f"({card})", flush=True)
    for name, routes in m["calls"].items():
        windows = routes["dense"]["head_windows"]
        print(f"mesh {name}: layer 0's wq, fused MLP and the LM head ({windows} head windows a "
              "rank), each sharded call bitwise its single-device call, fp32 and int8 values",
              flush=True)
    for key, r in m["dp"].items():
        print(f"mesh {key} (vusa_edge, contracted fan-in, fp32 values): {r} ({card})",
              flush=True)
    for what, r in m["sched"].items():
        when = ("every arrival at 0" if what == "paged_prefix"
                else "staggered arrivals on rank 0's clock")
        print(f"mesh 2x2 scheduler {what} ({DEPTH_CUT} layers, {SCHED_REQUESTS} requests at "
              f"{when}, {SCHED_SLOTS} slots, sequential admission): {r} ({card})", flush=True)
    for layers, r in m["qwen2"].items():
        print(f"mesh 1x4 qwen2_0_5b {layers} layers (published widths): {r}", flush=True)
    for name, r in m["train"].items():
        print(f"mesh train {name} (vusa_edge, {MESH_TRAIN_LAYERS} layers, full width): {r} "
              f"({card})", flush=True)
    print(f"mesh phase {m['seconds']:.1f}s (limit {MESH_PHASE_LIMIT_S:.0f}s; the slowest "
          f"rank's part of the shared world {m['ranks_s']:.1f}s, single-device references "
          f"{m['reference_s']:.1f}s beside it)", flush=True)


def run_async(what: str, coro_fn, timeout: float = 300.0):
    """``asyncio.run(coro_fn())`` on a daemon thread: a run with no result
    in ``timeout`` s fails the phase and ends the process at once (a hung
    worker thread must not hold the exit); an exception fails it too."""
    box = {}

    def target():
        try:
            box["out"] = asyncio.run(coro_fn())
        except BaseException as exc:  # handed to the main thread's fail()
            box["err"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        print(f"chip_smoke: FAILED: {what}: no result in {timeout:.0f} s", file=sys.stderr,
              flush=True)
        os._exit(1)
    if "err" in box:
        fail(f"{what}: {box['err']!r}")
    return box["out"]


# --------------------------------------------------------------------------
# phase 17: tensor-parallel dense compute on sharded dense storage
# --------------------------------------------------------------------------


def draw_put(leaf, chunk, starts: tuple, ranges: list) -> None:
    """The part of ``chunk`` (a drawn piece of a whole leaf beginning at
    ``starts`` on its leading dims, whole on the rest) inside this rank's
    shard ``ranges`` (``shard_ranges``), written into ``leaf`` (the shard)."""
    part, dst = chunk, []
    for dim, (s, k) in enumerate(ranges):
        c0 = starts[dim] if dim < len(starts) else 0
        a, b = max(c0, s), min(c0 + chunk.shape[dim], s + k)
        if a >= b:
            return
        part = part.narrow(dim, a - c0, b - a)
        dst.append(slice(a - s, b - s))
    leaf[tuple(dst)] = part


def sharded_init(cfg, mesh=None, placements=None) -> dict:
    """``device_init``'s draw (the contracted fan-in, the zeros and ones
    leaves perturbed), leaf by leaf in tree order, each leaf in chunks of
    dim 0 (a layer of a stacked leaf, ``TP_DRAW_ENTRIES`` entries of a
    matrix; a layer above that in chunks of its dim 1, ``draw_put``),
    every rank drawing every chunk from the same generator and
    keeping its shard under ``placements`` (default: the serving engine's,
    ``dist.tp.storage_placements``); with no mesh, every chunk.  So a rank
    never holds a leaf whole, and the ranks' shards cut one device's tree."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(int(np.random.default_rng(FAM_SEED).integers(2**62)))
    specs = build_model(cfg).specs()
    if mesh is None:
        placements = None
    elif placements is None:
        placements = storage_placements(specs, mesh)

    def build(tree, pls):
        out = {}
        for name, spec in tree.items():
            if isinstance(spec, dict):
                out[name] = build(spec, None if pls is None else pls[name])
                continue
            shape = spec.shape
            std = (FAM_PERTURB_STD if spec.init in ("zeros", "ones")
                   else spec.scale / math.sqrt(max(fan_in(name, shape), 1)))
            ranges = shard_ranges(shape, () if pls is None else pls[name], mesh)
            leaf = torch.empty([n for _, n in ranges], device=DEVICE)
            inner = math.prod(shape[1:])
            step = 1 if len(shape) >= 3 else max(1, TP_DRAW_ENTRIES // max(inner, 1))
            # a layer of a stacked leaf above TP_DRAW_ENTRIES (the experts'
            # (E, d, ff)) in chunks of its dim 1 too
            sub = (max(1, TP_DRAW_ENTRIES // math.prod(shape[2:]))
                   if len(shape) >= 3 and inner > TP_DRAW_ENTRIES else None)
            for r0 in range(0, shape[0], step):
                r1 = min(r0 + step, shape[0])
                for j0 in range(0, shape[1], sub) if sub else (None,):
                    span = (r1 - r0,) + ((min(j0 + sub, shape[1]) - j0,) if sub else ())
                    chunk = torch.randn(span + tuple(shape[len(span):]), generator=gen,
                                        device=DEVICE).mul_(std)
                    if spec.init == "ones":
                        chunk += 1.0
                    draw_put(leaf, chunk, (r0,) + ((j0,) if sub else ()), ranges)
                    del chunk
            out[name] = leaf
        return out

    return build(specs, placements)


def tp_predicted(route: str, dp: int, tp: int, layers: int, rows_split: bool) -> int:
    """Collectives a decode step makes on a rank: on ``model`` two ordered
    sums a layer on either route (``wo`` on the rank's heads, dense or
    packed from its heads' rows; ``w_down`` or the packed MLP's window
    partials), plus the embedding's sum and the head's gather; on ``data``
    the embedding's two gathers (every rank's tokens, the looked-up
    columns), the logits' rows gather when the rows split, and on the dense
    route each layer's leaves (one gather) and the LM head's."""
    n = 0
    if tp > 1:
        n += 2 * layers + 2
    if dp > 1:
        n += 2 + int(rows_split) + ((layers + 1) if route == "dense" else 0)
    return n


def tp_engine(cfg, params, mesh, route: str, new: int):
    kw = {} if route == "dense" else {"packed_weights": "all", "packed_values": route}
    return Engine(cfg, params, ServeConfig(max_len=PROMPT + new + 8, fused=False, **kw),
                  device=DEVICE, mesh=mesh)


def tp_run(eng, prompts, new: int, temp: float = 0.0) -> dict:
    """``generate`` of ``new`` tokens at ``temp`` on ``eng`` beside the first
    decode step's whole logits (``first_step_logits``): the tokens and
    their digest, the logits' digest, and of the decode steps alone
    (``decode_segment``) the collectives and bytes a step on this rank, the
    B1-B4 launches, ms a step and tok/s; the dense bytes this rank stores
    and their placement arithmetic."""
    use(eng, temperature=temp)
    first = first_step_logits(eng, prompts)
    box, inner = {}, eng.decode_segment

    def counted(*args, **kw):
        comm.reset_stats()
        reset_all_launch_counts()
        out = inner(*args, **kw)
        box.update(collectives=comm.STATS["collectives"], bytes=comm.STATS["bytes"],
                   launches=mesh_counts())
        return out

    eng.decode_segment = counted
    out = eng.generate(prompts, max_new=new)
    del eng.decode_segment
    steps = new - 1
    specs = build_model(eng.cfg).specs()
    placements = (storage_placements(specs, None) if eng.plan is None
                  else eng.plan.placements)
    return {"tokens": out["tokens"], "first": first, "digest": digest(
                first, torch.from_numpy(out["tokens"])),
            "collectives_per_step": box["collectives"] / steps,
            "bytes_per_step": box["bytes"] / steps, "launches": box["launches"],
            "ms_per_step": 1e3 * out["decode_s"] / steps, "tok_per_s": out["tok_per_s"],
            "dense_bytes": eng.dense_param_bytes,
            "dense_bytes_want": placement_bytes(specs, placements, eng.mesh)}


def tp_runs(meshes: dict, layers) -> list:
    """(b)'s runs at depth ``layers`` on ``meshes`` (``{"1x1": None}``: one
    device), each (mesh, route, temperature, bf16 probabilities): greedy
    with fp32 probabilities on every route, and at full depth the dense
    route's ``TP_EXTRA`` (one device once a setting)."""
    out = [(name, route, 0.0, False) for name in meshes for route in TP_ROUTES]
    if layers is None:
        out += (sorted({("1x1", "dense", t, b) for _, t, b in TP_EXTRA}) if "1x1" in meshes
                else [(n, "dense", t, b) for n, t, b in TP_EXTRA if n in meshes])
    return out


def tp_label(key: tuple) -> str:
    name, layers, route, temp, bf16 = key
    return (f"{name} {layers} layers {route}" + (f" T={temp}" if temp else "")
            + (" bf16 probabilities" if bf16 else ""))


def tp_cases(meshes: dict, prompts, lead: bool) -> dict:
    """(b): ``vusa_edge`` drawn with the contracted fan-in, pruned, on every
    mesh of ``meshes`` (``{"1x1": None}``: one device) at each depth, each
    run of ``tp_runs``, the flash attention's probabilities in fp32 but
    where a run asks for bf16.  ``lead``: this rank keeps every run's
    first-step logits (the others their digests)."""
    out = {}
    for layers in TP_DEPTHS:
        cfg = mesh_cfg("vusa_edge", layers)
        params = prune_tree(device_init(cfg), cfg.sparsity)
        for name, route, temp, bf16 in tp_runs(meshes, layers):
            with contextlib.nullcontext() if bf16 else fp32_probs():
                t0 = time.monotonic()
                eng = tp_engine(cfg, params, meshes[name], route, TP_NEW)
                build_s = time.monotonic() - t0
                rec = tp_run(eng, prompts, TP_NEW, temp)
            rec["build_s"] = build_s
            if not lead:
                del rec["first"]
            out[(name, cfg.n_layers, route, temp, bf16)] = rec
            del eng
            release()
        del params
        release()
    return out


def tp_qwen3(mesh, prompts) -> dict:
    """(a): ``qwen3_8b`` at 36 layers, fp32, dense route, on ``mesh`` (None:
    one device): the draw (``sharded_init``), the engine, the run and the
    peak memory of all of it, above what the process held before (this
    process keeps earlier phases' tensors); the whole logits only with no
    mesh or on the lead rank."""
    cfg = mesh_cfg(TP_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    params = sharded_init(cfg, mesh)
    draw_s = time.monotonic() - t0
    eng = tp_engine(cfg, params, mesh, "dense", TP_NEW)
    del params
    rec = tp_run(eng, prompts, TP_NEW)
    torch.cuda.synchronize()
    rec.update(peak_bytes=torch.cuda.max_memory_allocated() - held, draw_s=draw_s)
    del eng
    release()
    return rec


def tpt_config(steps: int, batch: int = TRAIN_BATCH, prune=None) -> TrainConfig:
    """(c)'s training run: phase 12's stream, lr and warmup over the free
    run's ``TPT_FREE_STEPS`` (so a lockstep step takes the free run's lr),
    no clip (C10), pruning on ``prune`` (begin, end, every) or none."""
    begin, end, every = prune or (steps + 1, steps + 1, 1)
    return TrainConfig(steps=steps, global_batch=batch, seq_len=TRAIN_SEQ, prune_begin=begin,
                       prune_end=end, prune_every=every, log_every=1, token_range=TRAIN_TOKENS,
                       hp=TrainHParams(lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                       total_steps=TPT_FREE_STEPS, max_grad_norm=TRAIN_CLIP))


def tpt_batches(cfg, tc, rows=None):
    """(c)'s batches on the card, whole and this rank's rows (``rows``)."""
    for host in SyntheticDataset(cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
                                 token_range=tc.token_range):
        whole = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
        yield whole, whole if rows is None else {k: v[rows] for k, v in whole.items()}


def fsdp_terms(tr, shards: dict) -> dict:
    """The terms of a rank's FSDP gates (``FSDP_BOUND_TERMS``) from its
    shards under the trainer's placements: ``grads`` its gradient shards'
    bytes (fp32, its parameters' shapes), ``layer`` the largest layer's
    leaves as the compute reads them (whole over ``data``, and an attention
    leaf whole over ``model`` where the heads do not split), ``layer_data``
    its leaves gathered over ``data`` alone (what ``comm.GATHERED``
    counts), ``top`` the top-level leaves gathered over ``data``."""
    sizes = comm.mesh_shape(tr.mesh)
    dp, tp = sizes.get("data", 1), sizes.get("model", 1)
    read, data, top, grads = {}, {}, 0, 0
    for (path, t), (_, pl) in zip(tree_items(shards), tree_items(tr.p_shard)):
        grads += t.numel() * 4
        if path[0] in ("layers", "enc_layers", "dec_layers", "groups", "tail"):
            key = path[:2] if path[0] in ("groups", "tail") else path[:1]
            n = t.numel() * t.element_size() // (t.shape[0] if path[0] != "tail" else 1)
            whole_model = ("model" in pl and not tr.plan.heads
                           and any(path[:len(a)] == a for a in tr.plan.attn))
            read[key] = read.get(key, 0) + (n * (dp if "data" in pl else 1)
                                            * (tp if whole_model else 1))
            data[key] = data.get(key, 0) + (n * dp if "data" in pl else 0)
        elif "data" in pl:
            top += t.numel() * t.element_size() * dp
    return {"grads": grads, "layer": max(read.values(), default=0),
            "layer_data": max(data.values(), default=0), "top": top}


def fsdp_step(tr, cfg, shards: dict, run, microbatches: int = 1):
    """``run()``, one training step (or its loss and gradients) of this
    rank, measured for the FSDP gates: its card peak above what the process
    held before it, the peak of the leaves gathered over ``data`` alive at
    once (``comm.GATHERED``), its ``fsdp-gather`` and ``reduce-scatter``
    counts and bytes beside ``TPPlan.fsdp_traffic``'s, and
    ``fsdp_terms``.  Returns (``run()``'s result, the record)."""
    kinds = ("fsdp-gather", "reduce-scatter")
    rec = fsdp_terms(tr, shards)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = {k: dict(comm.STATS["by_type"].get(k, {"count": 0, "bytes": 0})) for k in kinds}
    comm.reset_gathered()
    out = run()
    torch.cuda.synchronize()
    rec["peak_above_held"] = torch.cuda.max_memory_allocated() - held
    rec["gathered_peak"] = comm.GATHERED["peak"]
    after = comm.STATS["by_type"]
    rec["traffic"] = {k: {f: after.get(k, {"count": 0, "bytes": 0})[f] - before[k][f]
                          for f in ("count", "bytes")} for k in kinds}
    rec["traffic_want"] = tr.plan.fsdp_traffic(cfg, microbatches, split=tr.rows is not None)
    return out, rec


def fsdp_check(what: str, rec: dict, act_one=None) -> dict:
    """The FSDP gates of one rank's ``fsdp_step`` record (fails on a
    miss): its traffic as predicted, the gathered leaves' peak at most two
    layers' plus the top-level leaves', and with ``act_one`` (one device's
    activations and temporaries, bytes) its card peak at most the
    predicted bound (``FSDP_BOUND_TERMS``).  Returns the report."""
    if rec["traffic"] != rec["traffic_want"]:
        fail(f"{what}: FSDP traffic {rec['traffic']}, predicted {rec['traffic_want']}")
    gathered_bound = 2 * rec["layer_data"] + rec["top"]
    if rec["gathered_peak"] > gathered_bound:
        fail(f"{what}: {rec['gathered_peak']} bytes gathered over data alive at once, above two "
             f"layers' and the top-level leaves' {gathered_bound}")
    out = {k: rec[k] for k in ("peak_above_held", "gathered_peak", "grads", "layer", "top",
                               "traffic")}
    out["gathered_bound"] = gathered_bound
    if act_one is not None:
        bound = rec["grads"] + 3 * rec["layer"] + 2 * rec["top"] + max(int(act_one), 0)
        out.update(bound=bound, one_device_activations=max(int(act_one), 0))
        if rec["peak_above_held"] > bound:
            fail(f"{what}: card peak {rec['peak_above_held']} bytes above the state, over the "
                 f"predicted {bound} ({' + '.join(FSDP_BOUND_TERMS)})")
    return out


def tpt_lockstep(cfg, mesh, steps: int, refresh_at: int) -> dict:
    """(c1)/(c3): ``steps`` tensor-parallel steps on ``mesh``, each from this
    rank's shards of one device's state (``device_init``'s weights, as
    phase 15's 2x1 lockstep takes each step from it), beside one device's
    step, which then advances the state: per step the loss's and the norm's
    gaps (relative), the largest gap of a gradient shard (of the largest
    |g| of one device's matching slice), digests of the loss and norm and
    of the replicated leaves' gradients (every rank, and every rank of one
    data coordinate, must match), the collectives against the plan's
    prediction, ms of both steps; at step ``refresh_at`` whether the masks
    refreshed leaf by leaf from the shards are one device's, bitwise."""
    tc = tpt_config(steps)
    one = Trainer(cfg, tc, device=DEVICE)
    tp = Trainer(cfg, tc, device=DEVICE, mesh=mesh)
    params = device_init(cfg)
    opt = adamw_init(params)
    shard = functools.partial(shard_tree, placements=tp.p_shard, mesh=mesh)
    spec = [pl for _, pl in tree_items(tp.p_shard)]
    rec = {k: [] for k in ("loss_gaps", "norm_gaps", "grad_gaps", "ms", "one_ms",
                           "collectives", "bytes", "same", "replicated", "fsdp")}
    for k, (batch, rows) in zip(range(steps), tpt_batches(cfg, tc, tp.rows)):
        sh = shard(params)
        if k == refresh_at:
            got = tp.refresh_masks(sh, cfg.sparsity)
            want = shard(masks_tree(params, cfg.sparsity))
            rec["masks_equal"] = all((a is None and b is None) or torch.equal(a, b) for (
                _, a), (_, b) in zip(tree_items(got), tree_items(want)))
            del got, want
        state = AdamState(opt.step.clone(), shard(opt.mu), shard(opt.nu))
        comm.reset_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        (_, _, got), fsdp = fsdp_step(tp, cfg, sh, lambda: tp.step_fn(sh, state, rows,
                                                                      return_grads=True))
        rec["ms"].append(1e3 * (time.monotonic() - t0))
        rec["fsdp"].append(fsdp)
        rec["collectives"].append(comm.STATS["collectives"])
        rec["bytes"].append(comm.STATS["bytes"])
        t0 = time.monotonic()
        params, opt, want = one.step_fn(params, opt, batch, return_grads=True)
        torch.cuda.synchronize()
        rec["one_ms"].append(1e3 * (time.monotonic() - t0))
        rec["loss_gaps"].append(abs(float(got["loss"]) / float(want["loss"]) - 1))
        rec["norm_gaps"].append(abs(float(got["gnorm"]) / float(want["gnorm"]) - 1))
        rec["grad_gaps"].append(max(
            gap_rel(g, local_shard(w, pl, mesh)) for g, w, pl in zip(got["grads"],
                                                                     want["grads"], spec)))
        rec["same"].append(digest(torch.stack([got["loss"].float(), got["gnorm"].float()])))
        rec["replicated"].append(digest(*(g for g, pl in zip(got["grads"], spec)
                                          if "model" not in pl)))
        del sh, state, got, want
    rec.update(predicted=tp.plan.train_collectives(cfg, tc.seq_len, split=tp.rows is not None),
               data_rank=comm.axis_index(mesh, "data"))
    del params, opt
    release()
    return rec


def tpt_free(cfg, mesh) -> dict:
    """(c1)'s free run: ``TPT_FREE_STEPS`` steps of the trainer on ``mesh``
    (None: one device), pruning refreshed twice (``TPT_PRUNE``), from
    ``sharded_init``'s weights at the trainer's placement (a rank draws
    only its shards): losses, sparsity, ms a step, collectives and
    bytes a step on this rank, peak memory above what the process held
    before, and the trainer's output (this rank's ``shards`` and the
    gathered tree)."""
    tr = Trainer(cfg, tpt_config(TPT_FREE_STEPS, prune=TPT_PRUNE), device=DEVICE, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = sharded_init(cfg, mesh, tr.p_shard)
    tr.init_state = lambda: (params, adamw_init(params))
    comm.reset_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.monotonic()
        out = tr.train()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    del params, tr.init_state
    return {"losses": [r["loss"] for r in tr.metrics_log], "final_loss": out["final_loss"],
            "sparsity": out["sparsity"], "ms_per_step": 1e3 * wall / TPT_FREE_STEPS,
            "collectives_per_step": comm.STATS["collectives"] / TPT_FREE_STEPS,
            "bytes_per_step": comm.STATS["bytes"] / TPT_FREE_STEPS,
            "peak_bytes": torch.cuda.max_memory_allocated() - held, "out": out}


def tpt_serve(cfg, mesh, out: dict, prompts, lead: bool) -> dict:
    """(c1)'s serving run: the free run's pruned shards straight into
    ``Engine(mesh=)``, packed with fp32 values (B1/B2: attention packed from
    each rank's heads, MLP and head through the sharded appliers), and on
    the lead rank one device's engine on the gathered tree beside it
    (``tp_run`` each: B = 4, prompt 32, ``TP_NEW`` new tokens)."""
    eng = tp_engine(cfg, out["shards"], mesh, "bf16", TP_NEW)
    rec = {"tp": tp_run(eng, prompts, TP_NEW)}
    del eng
    release()
    whole = lead_tree(out["params"], lead)  # the trainer's view: every rank reads
    if lead:
        one = tp_engine(cfg, whole, None, "bf16", TP_NEW)
        rec["one"] = tp_run(one, prompts, TP_NEW)
        del one
        release()
    return rec


def tpt_qwen3(mesh) -> dict:
    """(c2): one step of ``qwen3_8b`` at its widths, ``TPT_QWEN3_LAYERS``
    layers, fp32, batch ``TPT_QWEN3_BATCH`` x 128, on ``mesh`` (None: one
    device), each rank drawing only its shards leaf by leaf: the loss, the
    norm, ms, collectives and bytes, the bytes of params, grads and both
    moments the placement holds, and the peak memory of draw and step
    above what the process held before."""
    cfg = mesh_cfg("qwen3_8b", TPT_QWEN3_LAYERS)
    tr = Trainer(cfg, tpt_config(1, batch=TPT_QWEN3_BATCH), device=DEVICE, mesh=mesh)
    specs = build_model(cfg).specs()
    _, rows = next(tpt_batches(cfg, tr.tc, tr.rows))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    params = sharded_init(cfg, mesh, tr.p_shard)
    draw_s = time.monotonic() - t0
    opt = adamw_init(params)
    comm.reset_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, _, m = tr.step_fn(params, opt, rows)
    torch.cuda.synchronize()
    rec = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
           "ms": 1e3 * (time.monotonic() - t0), "draw_s": draw_s,
           "collectives": comm.STATS["collectives"], "bytes": comm.STATS["bytes"],
           "peak_bytes": torch.cuda.max_memory_allocated() - held,
           "state_bytes": 4 * placement_bytes(specs, params_shardings(specs, mesh), mesh),
           "same": digest(torch.stack([m["loss"].float(), m["gnorm"].float()]))}
    if tr.plan is not None:
        rec["predicted"] = tr.plan.train_collectives(cfg, TRAIN_SEQ)
    del params, opt, m
    release()
    return rec


def tpt_rank(mesh, one_by_four, prompts) -> dict:
    """Part (c) on one rank of phase 17's 2x2 world, fp32 attention
    probabilities.  The 2x2 mesh's two ``model`` sub-meshes (1x2) take
    (c1)'s two 1x2 runs at once: the first data coordinate (ranks 0, 1)
    the lockstep, the second (ranks 2, 3) the free run and its serving.
    Then every rank: (c1)'s lockstep on 1x4 and 2x2, (c2) ``qwen3_8b`` on
    1x4, (c3) ``qwen2_0_5b`` on 1x4."""
    t0 = time.monotonic()
    group = comm.axis_index(mesh, "data")
    cfg = mesh_cfg("vusa_edge")
    out = {"lockstep": {}, "seconds": {}}

    def part(name, fn, *args):
        t = time.monotonic()
        got = fn(*args)
        out["seconds"][name] = time.monotonic() - t
        return got

    if group == 0:
        out["lockstep"]["1x2"] = part("lockstep 1x2", tpt_lockstep, cfg, mesh["model"],
                                      TPT_LOCKSTEP, TPT_REFRESH_AT)
    else:
        free = part("free", tpt_free, cfg, mesh["model"])
        trained = free.pop("out")
        out["free"] = free
        out["serve"] = part("serve", tpt_serve, cfg, mesh["model"], trained, prompts,
                            comm.axis_index(mesh, "model") == 0)
        del trained
    for name, m in (("1x4", one_by_four), ("2x2", mesh)):
        out["lockstep"][name] = part(f"lockstep {name}", tpt_lockstep, cfg, m, TPT_LOCKSTEP,
                                     TPT_REFRESH_AT)
    out["qwen3"] = part("qwen3", tpt_qwen3, one_by_four)
    calls = model_layers._maybe_seq_sharded_attention.calls
    out["qwen2"] = part("qwen2", tpt_lockstep, mesh_cfg("qwen2_0_5b", TPT_QWEN2_LAYERS),
                        one_by_four, 1, 0)
    out["qwen2"]["seq_shard_calls"] = model_layers._maybe_seq_sharded_attention.calls - calls
    out["seconds"]["all"] = time.monotonic() - t0
    return out


def ep_routing(fn):
    """``fn()`` with ``layers.moe.trace`` on: its result and every routed
    call's integers, on the host."""
    model_layers.moe.trace = []
    try:
        out = fn()
        return out, [{k: v.cpu().numpy() for k, v in t.items()}
                     for t in model_layers.moe.trace]
    finally:
        model_layers.moe.trace = None


def ep_serve(cfg, mesh) -> dict:
    """(d1)/(d2): ``cfg`` drawn with the contracted fan-in (``sharded_init``:
    on a mesh this rank's shards, the experts split over ``model``), served
    dense on ``mesh`` (None: one device), ``tp_run``'s record and layer 0's
    routing integers of the first decode step, with the peak memory of draw
    and run above what the process held before."""
    prompts = prompts_for(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    params = sharded_init(cfg, mesh)
    draw_s = time.monotonic() - t0
    eng = tp_engine(cfg, params, mesh, "dense", EP_NEW)
    del params
    rec, routing = ep_routing(lambda: tp_run(eng, prompts, EP_NEW))
    torch.cuda.synchronize()
    rec.update(peak_bytes=torch.cuda.max_memory_allocated() - held, draw_s=draw_s,
               routing=routing[cfg.n_layers])  # the prefill's layers come first
    del eng
    release()
    return rec


def ep_train_oracle(layers: int) -> dict:
    """(d3)'s one device: one step of olmoe at ``layers`` from
    ``sharded_init``'s whole draw on the first batch: the loss, the norm,
    every gradient whole in a file for the ranks (``save_grads``) and each
    one's largest |g|, layer 0's routing integers, ms and the peak above
    what the process held before."""
    cfg = mesh_cfg(EP_ARCH, layers)
    tr = Trainer(cfg, tpt_config(1), device=DEVICE)
    batch, _ = next(tpt_batches(cfg, tr.tc))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = sharded_init(cfg)
    paths = [p for p, _ in tree_items(params)]
    opt = adamw_init(params)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    (_, _, m), routing = ep_routing(lambda: tr.step_fn(params, opt, batch, return_grads=True))
    torch.cuda.synchronize()
    rec = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
           "ms": 1e3 * (time.monotonic() - t0),
           "peak_bytes": torch.cuda.max_memory_allocated() - held, "routing": routing[0],
           "path": str(TP_DIR / "d3" / str(layers)),
           "tree_bytes": sum(t.numel() * t.element_size() for _, t in tree_items(params))}
    # its activations and temporaries: the peak above its parameters, both
    # moments and its gradients
    rec["activations"] = rec["peak_bytes"] - 4 * rec["tree_bytes"]
    rec["gmax"] = save_grads(Path(rec["path"]), paths, m["grads"])
    del params, opt, m
    release()
    return rec


def ep_train(cfg, mesh, path: str, gmax: dict) -> tuple:
    """(d3) on one rank: one step of the trainer on ``mesh`` from this
    rank's shards of the draw (``sharded_init`` at the trainer's
    placement) on its rows of the first batch, beside one device's
    gradients (the files under ``path``, ``grad_gaps``): the loss, norm, the largest
    gradient-shard gap (of the leaf's largest |g|, ``gmax``), collectives
    and the plan's prediction, bytes, ms, layer 0's routing integers and
    this rank's rows; and the updated shards."""
    tr = Trainer(cfg, tpt_config(1), device=DEVICE, mesh=mesh)
    _, rows = next(tpt_batches(cfg, tr.tc, tr.rows))
    shards = sharded_init(cfg, mesh, tr.p_shard)
    opt = adamw_init(shards)
    comm.reset_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ((shards, opt, m), routing), fsdp = fsdp_step(tr, cfg, shards, lambda: ep_routing(
        lambda: tr.step_fn(shards, opt, rows, return_grads=True)))
    ms = 1e3 * (time.monotonic() - t0)
    rec = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]), "ms": ms,
           "collectives": comm.STATS["collectives"], "bytes": comm.STATS["bytes"],
           "predicted": tr.plan.train_collectives(cfg, TRAIN_SEQ, split=tr.rows is not None),
           "routing": routing[0], "rows": None if tr.rows is None else (tr.rows.start,
                                                                        tr.rows.stop),
           "experts": tr.plan.experts, "fsdp": fsdp}
    gaps = grad_gaps(path, tr.p_shard, m["grads"], gmax, mesh)
    rec["grad_gap"] = max(gaps.values())
    rec["grad_gap_leaf"] = max(gaps, key=gaps.get)
    del opt, m
    release()
    return rec, shards


def ep_rank(mesh, one_by_four, ep_ref: dict) -> dict:
    """Part (d) on one rank of phase 17's 2x2 world, fp32 attention
    probabilities: (d1) olmoe at 16 layers and (d2) moonshot at
    ``EP_MOONSHOT_LAYERS`` served on 1x4; (d3) olmoe's training step on 1x4,
    its shards served on 1x4 beside one device's engine on the gathered
    tree (on the lead rank), then its step on 2x2; ``ep_ref``: one
    device's gradients and their largest |g| for each mesh's depth."""
    t0 = time.monotonic()
    lead = not any(mesh.get_coordinate())
    out = {"seconds": {}}

    def part(name, fn, *args):
        t = time.monotonic()
        got = fn(*args)
        out["seconds"][name] = time.monotonic() - t
        return got

    out["olmoe"] = part("d1", ep_serve, mesh_cfg(EP_ARCH), one_by_four)
    out["moonshot"] = part("d2", ep_serve, mesh_cfg(EP_MOONSHOT, EP_MOONSHOT_LAYERS),
                           one_by_four)
    cfg = mesh_cfg(EP_ARCH, EP_TRAIN_LAYERS["1x4"])
    t = time.monotonic()
    out["train_1x4"], shards = ep_train(cfg, one_by_four, *ep_ref["1x4"])
    out["seconds"]["d3 1x4"] = time.monotonic() - t
    t = time.monotonic()
    eng = tp_engine(cfg, shards, one_by_four, "dense", EP_NEW)
    out["served"] = tp_run(eng, prompts_for(cfg), EP_NEW)
    del eng
    whole = lead_tree(WholeView(shards, params_shardings(build_model(cfg).specs(), one_by_four),
                                one_by_four), lead)
    del shards
    release()
    if lead:
        eng = tp_engine(cfg, whole, None, "dense", EP_NEW)
        out["served_one"] = tp_run(eng, prompts_for(cfg), EP_NEW)
        del eng
    del whole
    release()
    out["seconds"]["d3 serve"] = time.monotonic() - t
    t = time.monotonic()
    out["train_2x2"], shards = ep_train(mesh_cfg(EP_ARCH, EP_TRAIN_LAYERS["2x2"]), mesh,
                                        *ep_ref["2x2"])
    del shards
    release()
    out["seconds"]["d3 2x2"] = time.monotonic() - t
    out["seconds"]["all"] = time.monotonic() - t0
    return out


def ep_oracles() -> dict:
    """Part (d)'s one device, before the ranks use the card: (d1) and (d2)
    served and freed, (d3)'s step (its gradients written to files for the
    ranks)."""
    t0 = time.monotonic()
    with fp32_probs():
        out = {"olmoe": ep_serve(mesh_cfg(EP_ARCH), None)}
        out["moonshot"] = ep_serve(mesh_cfg(EP_MOONSHOT, EP_MOONSHOT_LAYERS), None)
        steps = {n: ep_train_oracle(n) for n in sorted(set(EP_TRAIN_LAYERS.values()))}
        out["train"] = {name: steps[n] for name, n in EP_TRAIN_LAYERS.items()}
    out["seconds"] = time.monotonic() - t0
    return out


def ep_gates(ranks: list, oracle: dict) -> dict:
    """Part (d)'s gates over every rank's ``ep_rank`` record beside one
    device's (``ep_oracles``); returns the part's report."""
    res = {"seconds": [r["seconds"] for r in ranks], "oracle_s": oracle["seconds"]}
    for name, arch in (("olmoe", EP_ARCH), ("moonshot", EP_MOONSHOT)):
        want, got = oracle[name], ranks[0][name]
        what = f"ep {arch} on 1x4"
        gap = gap_rel(got["first"], want["first"])
        if gap > EP_LOGIT_TOL:
            fail(f"{what}: first-step logit gap {gap:.3g} of the largest > {EP_LOGIT_TOL}")
        for i, r in enumerate(x[name] for x in ranks):
            for k in ("eids", "pos", "dropped"):
                if not np.array_equal(r["routing"][k], want["routing"][k]):
                    fail(f"{what}: rank {i}'s layer-0 routing {k} of the first decode step "
                         "differs from one device's")
            if r["digest"] != got["digest"]:
                fail(f"{what}: rank {i}'s tokens or logits differ from rank 0's")
            if r["dense_bytes"] != r["dense_bytes_want"]:
                fail(f"{what}: rank {i} stores {r['dense_bytes']} bytes, the placement says "
                     f"{r['dense_bytes_want']}")
        ratios = [x[name]["peak_bytes"] / want["peak_bytes"] for x in ranks]
        if max(ratios) > TP_MEM_RATIO:
            fail(f"{what}: a rank's peak memory is {max(ratios):.3f}x one device's > "
                 f"{TP_MEM_RATIO}")
        cfg = mesh_cfg(arch, None if name == "olmoe" else EP_MOONSHOT_LAYERS)
        predicted = tp_predicted("dense", 1, 4, cfg.n_layers, False)
        if got["collectives_per_step"] != predicted:
            fail(f"{what}: {got['collectives_per_step']} collectives a decode step, predicted "
                 f"{predicted}")
        res[name] = {
            "layers": cfg.n_layers, "first_step_gap_rel": gap,
            "token_agreement": float(np.mean(got["tokens"] == want["tokens"])),
            "dropped_first_step_layer0": int(want["routing"]["dropped"].sum()),
            "assignments_first_step_layer0": int(want["routing"]["dropped"].size),
            "peak_ratio_per_rank": ratios, "collectives_predicted": predicted,
            "one_device": {k: want[k] for k in ("ms_per_step", "tok_per_s", "peak_bytes",
                                                "dense_bytes", "draw_s")},
            **{k: got[k] for k in ("ms_per_step", "tok_per_s", "collectives_per_step",
                                   "bytes_per_step", "peak_bytes", "dense_bytes", "draw_s")}}
    for key, mesh_name in (("train_1x4", "1x4"), ("train_2x2", "2x2")):
        t = oracle["train"][mesh_name]
        loss_tol, grad_tol = ((EP_LOSS_TOL, EP_GRAD_TOL) if mesh_name == "1x4"
                              else (TPT_LOSS_TOL, TPT_GRAD_TOL))
        recs = [r[key] for r in ranks]
        for i, r in enumerate(recs):
            what = f"ep train olmoe {mesh_name}: rank {i}"
            loss_gap, norm_gap = abs(r["loss"] / t["loss"] - 1), abs(r["gnorm"] / t["gnorm"] - 1)
            if loss_gap > loss_tol or r["grad_gap"] > grad_tol or (
                    mesh_name == "2x2" and norm_gap > TPT_NORM_TOL):
                fail(f"{what}: loss gap {loss_gap:.3g} (limit {loss_tol}), norm gap "
                     f"{norm_gap:.3g}, gradient-shard gap {r['grad_gap']:.3g} at "
                     f"{r['grad_gap_leaf']} (limit {grad_tol})")
            if r["collectives"] != r["predicted"] or not r["experts"]:
                fail(f"{what}: {r['collectives']} collectives, predicted {r['predicted']}, "
                     f"experts split {r['experts']}")
            r["fsdp_report"] = fsdp_check(what, r["fsdp"], t["activations"])
            want = t["routing"]
            for k in ("eids", "pos", "dropped"):
                w = want[k]
                if r["rows"] is not None:
                    w = w.reshape(TRAIN_BATCH, -1)[r["rows"][0]:r["rows"][1]].reshape(-1)
                if not np.array_equal(r["routing"][k], w):
                    fail(f"{what}: layer-0 routing {k} differs from one device's whole-batch "
                         "step's rows")
        res[key] = {"loss_gap_max": max(abs(r["loss"] / t["loss"] - 1) for r in recs),
                    "norm_gap_max": max(abs(r["gnorm"] / t["gnorm"] - 1) for r in recs),
                    "grad_gap_max": max(r["grad_gap"] for r in recs),
                    "grad_gap_leaf": recs[0]["grad_gap_leaf"],
                    "dropped_layer0": int(t["routing"]["dropped"].sum()),
                    "layers": EP_TRAIN_LAYERS[mesh_name],
                    "one_device": {k: t[k] for k in ("loss", "gnorm", "ms", "peak_bytes",
                                                     "tree_bytes", "activations")},
                    "fsdp_per_rank": [r["fsdp_report"] for r in recs],
                    **{k: recs[0][k] for k in ("collectives", "predicted", "bytes", "ms")}}
    served, one = ranks[0]["served"], ranks[0]["served_one"]
    if not np.array_equal(served["tokens"], one["tokens"]):
        fail("ep train olmoe 1x4: the trained shards served on 1x4 give tokens other than one "
             "device's on the gathered tree")
    res["served"] = {"first_step_gap_rel": gap_rel(served["first"], one["first"]),
                     "token_agreement": float(np.mean(served["tokens"] == one["tokens"])),
                     **{k: served[k] for k in ("ms_per_step", "collectives_per_step")},
                     "one_device_ms_per_step": one["ms_per_step"]}
    return res


def fsdp_line(reports: list) -> str:
    """One line of the ranks' FSDP reports (``fsdp_check``)."""
    peak = max(r["peak_above_held"] for r in reports)
    line = (f"FSDP: a rank's card peak above its state {peak} bytes"
            + (f" (predicted bound {max(r['bound'] for r in reports)})"
               if "bound" in reports[0] else "")
            + f", gathered over data alive at once {max(r['gathered_peak'] for r in reports)} "
            f"(bound {reports[0]['gathered_bound']}), fsdp-gather "
            f"{reports[0]['traffic']['fsdp-gather']} reduce-scatter "
            f"{reports[0]['traffic']['reduce-scatter']} a rank as predicted")
    return line


def print_ep(e: dict, card: str) -> None:
    print("ep: cuts of depth, never of a width: " + "; ".join(
        f"{k} {v}" for k, v in EP_CUT_WHY.items()), flush=True)
    for name, arch in (("olmoe", EP_ARCH), ("moonshot", EP_MOONSHOT)):
        r = e[name]
        print(f"ep {arch} ({r['layers']} layers, fp32, moe_cf 1.25, dense, B={BATCH}, prompt "
              f"{PROMPT}, {EP_NEW} new) on 1x4, experts split 4 ways: first-step logit gap "
              f"{r['first_step_gap_rel']:.3g} of the largest, token agreement "
              f"{r['token_agreement']:.3f}, layer 0 first decode step dropped "
              f"{r['dropped_first_step_layer0']} of {r['assignments_first_step_layer0']} "
              f"assignments (routing bitwise one device's), peak a rank {r['peak_bytes']} "
              f"bytes ({max(r['peak_ratio_per_rank']):.3f}x one device's "
              f"{r['one_device']['peak_bytes']}), bytes stored a rank {r['dense_bytes']} (one "
              f"device {r['one_device']['dense_bytes']}), {r['collectives_per_step']:.0f} "
              f"collectives a step (predicted {r['collectives_predicted']}), "
              f"{r['bytes_per_step']:.0f} bytes a step a rank, {r['ms_per_step']:.2f} ms a step "
              f"(one device {r['one_device']['ms_per_step']:.2f}) ({card})", flush=True)
    for key in ("train_1x4", "train_2x2"):
        r = e[key]
        print(f"ep train olmoe ({r['layers']} of 16 layers, fp32, remat, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, one step from the draw) on {key[-3:]}: gaps loss "
              f"{r['loss_gap_max']:.3g} norm {r['norm_gap_max']:.3g} gradient shard "
              f"{r['grad_gap_max']:.3g} (largest at {r['grad_gap_leaf']}), layer 0 routing "
              f"bitwise one device's whole-batch step ({r['dropped_layer0']} assignments "
              f"dropped), {r['collectives']} collectives (predicted {r['predicted']}), "
              f"{r['bytes']} bytes, {r['ms']:.1f} ms (one device {r['one_device']['ms']:.1f}); "
              f"{fsdp_line(r['fsdp_per_rank'])} ({card})", flush=True)
    s = e["served"]
    print(f"ep train olmoe 1x4 shards served on 1x4: first-step gap "
          f"{s['first_step_gap_rel']:.3g}, token agreement {s['token_agreement']:.3f} with one "
          f"device on the gathered tree, {s['collectives_per_step']:.0f} collectives a step, "
          f"{s['ms_per_step']:.2f} ms a step (one device {s['one_device_ms_per_step']:.2f}) "
          f"({card})", flush=True)


def tpr_inputs(cfg, prompt: int):
    """(e1)'s and (f1)'s prompts (B = 4, ``prompt`` tokens) and the vlm
    family's seeded stand-in patches or the encdec family's
    ``ENC_FRAMES`` stand-in frames (normal, std 0.02, as the data pipeline
    makes them)."""
    rng = np.random.default_rng(FAM_SEED)
    prompts = rng.integers(1, cfg.vocab, size=(BATCH, prompt)).astype(np.int32)
    if cfg.family == "vlm":
        patches = rng.normal(0, 0.02, (BATCH, cfg.patch_tokens, cfg.d_model))
        return prompts, {"patches": patches.astype(np.float32)}
    if cfg.family == "encdec":
        frames = rng.normal(0, 0.02, (BATCH, ENC_FRAMES, cfg.d_model))
        return prompts, {"frames": frames.astype(np.float32)}
    return prompts, None


def tpr_serve(arch: str, mesh) -> dict:
    """(e1) on one rank (``mesh`` None: one device): ``arch`` drawn with the
    contracted fan-in (``sharded_init``: on a mesh this rank's shards),
    served dense, ``generate`` B = 4: the tokens, the first decode step's
    whole logits and the digest of both, the collectives and bytes a decode
    step beside ``TPPlan.decode_collectives``, ms a step, the dense bytes
    stored beside the placement's, the peak of draw and run above what the
    process held before."""
    layers, prompt, new = TPR_SERVE[arch]
    cfg = mesh_cfg(arch, layers)
    prompts, extras = tpr_inputs(cfg, prompt)
    patches = cfg.patch_tokens if cfg.family == "vlm" else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    params = sharded_init(cfg, mesh)
    draw_s = time.monotonic() - t0
    eng = Engine(cfg, params, ServeConfig(max_len=patches + prompt + new + 8, fused=False),
                 device=DEVICE, mesh=mesh)
    del params
    seen, box, choose, segment = [], {}, eng._choose, eng.decode_segment

    def keep(logits, *a):
        if not seen:
            seen.append(logits.float().cpu())
        return choose(logits, *a)

    def counted(*a, **kw):
        comm.reset_stats()
        out = segment(*a, **kw)
        box.update(collectives=comm.STATS["collectives"], bytes=comm.STATS["bytes"])
        return out

    eng._choose, eng.decode_segment = keep, counted
    out = eng.generate(prompts, max_new=new, extras=extras)
    torch.cuda.synchronize()
    specs = build_model(cfg).specs()
    steps = new - 1
    rec = {"tokens": out["tokens"], "first": seen[0],
           "digest": digest(seen[0], torch.from_numpy(out["tokens"])),
           "collectives_per_step": box["collectives"] / steps,
           "bytes_per_step": box["bytes"] / steps, "ms_per_step": 1e3 * out["decode_s"] / steps,
           "prefill_s": out["prefill_s"], "tok_per_s": out["tok_per_s"],
           "dense_bytes": eng.dense_param_bytes,
           "dense_bytes_want": placement_bytes(
               specs, storage_placements(specs, None) if eng.plan is None
               else eng.plan.placements, eng.mesh),
           "predicted": None if eng.plan is None else eng.plan.decode_collectives(
               cfg, eng._rows(BATCH) is not None),
           "split": None if eng.plan is None else {
               k: getattr(eng.plan, k) for k in ("heads", "ff", "vocab", "ssm", "rglru")},
           "peak_bytes": torch.cuda.max_memory_allocated() - held, "draw_s": draw_s,
           "layers": cfg.n_layers}
    del eng
    release()
    return rec


def tpr_config(cfg) -> TrainConfig:
    """(e2)'s one step: (c)'s batch, lr and stream; the vlm family's
    sequence holds its patch prefix and ``TRAIN_SEQ`` text tokens."""
    tc = tpt_config(1)
    return dataclasses.replace(tc, seq_len=(cfg.patch_tokens if cfg.family == "vlm" else 0)
                               + TRAIN_SEQ)


def tpr_grads(tr, params: dict, batch: dict) -> tuple:
    """The trainer's loss of ``batch`` (this rank's rows) and its fp32
    gradients (``tree_items`` order) under its plan, without the optimizer,
    as ``train/step.py``'s sharded step takes them: each layer's leaves
    gathered over ``data`` at use, their gradients reduce-scattered where
    the rows split, then the loss and the gradients of the leaves no
    ``data`` dim holds summed over the data ranks in rank order and
    divided by their count (one ``comm.sum_in_rank_order``)."""
    paths, leaves = zip(*tree_items(params))
    live = [t.detach().requires_grad_(True) for t in leaves]
    tree: dict = {}
    for path, t in zip(paths, live):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    axes = _batch_axes(tr.mesh)
    with mesh_context(tr.mesh, tr.plan, None if tr.rows is None else (tr.mesh, axes)):
        loss = tr.model.loss(tree, batch)
    grads = [g.float() for g in torch.autograd.grad(loss, live)]
    loss = loss.detach()
    if tr.rows is not None:
        n = math.prod(comm.axis_size(tr.mesh, a) for a in axes)
        rest = [i for i, (_, pl) in enumerate(tree_items(tr.p_shard)) if "data" not in pl]
        total = comm.sum_in_rank_order(torch.cat([loss.reshape(1)] + [grads[i].reshape(-1)
                                                                      for i in rest]),
                                       tr.mesh, axes) / n
        loss, off = total[0], 1
        for i in rest:
            grads[i] = total[off:off + grads[i].numel()].view_as(grads[i])
            off += grads[i].numel()
    return loss, grads


GRAD_WRITES: list = []  # threads writing one device's gradients (``save_grads``)


def save_grads(path: Path, paths: list, grads: list, skip=()) -> dict:
    """One device's gradients for the ranks: a ``.npy`` file a leaf under
    ``path`` (never held on the card for them: CUDA IPC slowed phase 15 2x
    and lost a rank, and its producer warned at exit), every leaf's but
    those under ``skip``, written from host copies by a thread while the
    next oracle runs (``wait_grads`` joins it before the ranks read);
    returns each leaf's largest |g|."""
    path.mkdir(parents=True, exist_ok=True)
    gmax, host = {}, []
    for p, g in zip(paths, grads):
        if p[0] not in skip:
            gmax[p] = float(g.abs().max())
            host.append((path / f"{'__'.join(p)}.npy", g.cpu().numpy()))

    def write():
        for f, a in host:
            np.save(f, a)

    GRAD_WRITES.append(threading.Thread(target=write))
    GRAD_WRITES[-1].start()
    return gmax


def wait_grads() -> None:
    """Every ``save_grads`` file written."""
    while GRAD_WRITES:
        GRAD_WRITES.pop().join()


def grad_gaps(path, placements: dict, got: list, gmax: dict, mesh) -> dict:
    """Each gradient shard ``got`` (``tree_items`` order of
    ``placements``) of a leaf in ``gmax`` against this rank's slice of one
    device's file under ``path`` (read memory-mapped, the slice alone to
    the card): the largest gap of the leaf's largest |g|, by leaf."""
    gaps = {}
    for (leaf, pl), g in zip(tree_items(placements), got):
        if leaf in gmax:
            whole = np.load(Path(path) / f"{'__'.join(leaf)}.npy", mmap_mode="r")
            cut = tuple(slice(s, s + n) for s, n in shard_ranges(whole.shape, pl, mesh))
            w = torch.from_numpy(np.array(whole[cut])).to(DEVICE)
            gaps["/".join(leaf)] = float((g - w).abs().max()) / max(gmax[leaf], 1e-30)
            del whole, w
    return gaps


def lead_tree(view, lead: bool) -> dict:
    """The whole tree of ``view`` (a ``WholeView`` of a mesh's shards, or a
    dict of them), every leaf read on every rank in sorted key order and
    kept by the ``lead`` rank alone: one leaf whole at a time off the
    lead, {} there."""
    whole: dict = {}
    for path, w in tree_items(view):
        if lead:
            node = whole
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = w
        del w
    return whole


def tpr_train_oracle(arch: str) -> dict:
    """(e2)'s one device: ``arch`` at its training depth from
    ``sharded_init``'s whole draw, the first batch: the Trainer's step (or
    the loss and gradients alone, ``TPR_TRAIN``): the loss, ms, the peak
    above what the process held before, each compared gradient's largest
    |g| and the directory holding them whole (a ``.npy`` file a leaf, read
    by the ranks memory-mapped, each its own slices)."""
    layers, _, whole_step, skip = TPR_TRAIN[arch]
    cfg = mesh_cfg(arch, layers)
    tr = Trainer(cfg, tpr_config(cfg), device=DEVICE)
    batch, _ = next(tpt_batches(cfg, tr.tc))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = sharded_init(cfg)
    paths = [p for p, _ in tree_items(params)]
    t0 = time.monotonic()
    if whole_step:
        m = tr.step_fn(params, adamw_init(params), batch, return_grads=True)[2]
        loss, grads = m.pop("loss"), m.pop("grads")
    else:
        loss, grads = tpr_grads(tr, params, batch)
    torch.cuda.synchronize()
    rec = {"loss": float(loss), "ms": 1e3 * (time.monotonic() - t0),
           "peak_bytes": torch.cuda.max_memory_allocated() - held, "layers": layers,
           "path": str(TPR_DIR / arch),
           "tree_bytes": sum(t.numel() * t.element_size() for _, t in tree_items(params))}
    # its activations and temporaries: the peak above its parameters and
    # gradients (and both moments, a whole step's)
    rec["activations"] = rec["peak_bytes"] - (4 if whole_step else 2) * rec["tree_bytes"]
    rec["gmax"] = save_grads(TPR_DIR / arch, paths, grads, skip)
    del params, grads
    release()
    return rec


def tpr_train(arch: str, mesh, path: str, gmax: dict) -> tuple:
    """(e2) on one rank: ``arch``'s step on ``mesh`` from this rank's shards
    of the draw on its rows of the first batch, beside one device's
    gradients (the directory ``path``, each leaf's file read memory-mapped:
    this rank's slice of it, to the card): the loss, the largest
    gradient-shard gap (of the leaf's largest |g|) and its leaf, the
    collectives beside the plan's prediction, bytes and ms; and the updated
    shards (a whole step's) or None."""
    layers, _, whole_step, _ = TPR_TRAIN[arch]
    cfg = mesh_cfg(arch, layers)
    tr = Trainer(cfg, tpr_config(cfg), device=DEVICE, mesh=mesh)
    _, rows = next(tpt_batches(cfg, tr.tc, tr.rows))
    shards = sharded_init(cfg, mesh, tr.p_shard)
    split = tr.rows is not None
    comm.reset_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    if whole_step:
        opt = adamw_init(shards)
        (shards, _, m), fsdp = fsdp_step(tr, cfg, shards, lambda: tr.step_fn(
            shards, opt, rows, return_grads=True))
        del opt
        loss, got = m["loss"], m["grads"]
        predicted = tr.plan.train_collectives(cfg, tr.tc.seq_len, split=split)
    else:
        (loss, got), fsdp = fsdp_step(tr, cfg, shards, lambda: tpr_grads(tr, shards, rows))
        # and the data ranks' sum of the loss and the leaves off data: one
        # all-reduce over one axis of two
        predicted = tr.plan.grad_collectives(cfg, tr.tc.seq_len, split=split) + int(split)
        shards = None
    rec = {"loss": float(loss), "ms": 1e3 * (time.monotonic() - t0),
           "collectives": comm.STATS["collectives"], "bytes": comm.STATS["bytes"],
           "predicted": predicted, "whole_step": whole_step, "fsdp": fsdp,
           "split": {k: getattr(tr.plan, k) for k in ("heads", "ff", "vocab", "ssm", "rglru")}}
    gaps = grad_gaps(path, tr.p_shard, got, gmax, mesh)
    rec["grad_gap"] = max(gaps.values())
    rec["compared"] = len(gaps)
    rec["grad_gap_leaf"] = max(gaps, key=gaps.get)
    del got
    release()
    return rec, shards


def tpr_trained_serve(arch: str, mesh, shards: dict, lead: bool) -> dict:
    """(e2)'s trained shards served on ``mesh`` (``generate`` B = 4, 8
    prompt and 4 new tokens), and on the lead rank one device's engine on
    the tree gathered leaf by leaf: both runs' tokens and first-step
    logits."""
    cfg = mesh_cfg(arch, TPR_TRAIN[arch][0])
    prompts, extras = tpr_inputs(cfg, 8)
    patches = cfg.patch_tokens if cfg.family == "vlm" else 0
    sc = ServeConfig(max_len=patches + 8 + 4 + 8, fused=False)

    def run(params, m):
        eng = Engine(cfg, params, sc, device=DEVICE, mesh=m)
        seen, choose = [], eng._choose

        def keep(logits, *a):
            if not seen:
                seen.append(logits.float().cpu())
            return choose(logits, *a)

        eng._choose = keep
        out = eng.generate(prompts, max_new=4, extras=extras)
        return {"tokens": out["tokens"], "first": seen[0],
                "ms_per_step": 1e3 * out["decode_s"] / 3}

    out = {"served": run(shards, mesh)}
    whole = lead_tree(WholeView(shards, params_shardings(build_model(cfg).specs(), mesh), mesh),
                      lead)
    if lead:
        out["one"] = run(whole, None)
    del whole
    release()
    return out


def tpr_rank(mesh, one_by_four, tpr_ref: dict) -> dict:
    """Part (e) on one rank of phase 17's 2x2 world, fp32 attention
    probabilities: (e1) each of ``TPR_ARCHS`` served on 1x4; (e2) each
    training step of ``TPR_TRAIN`` on its meshes (``tpr_ref``: the files of
    one device's gradients and their largest |g| by arch), ``TPR_SERVED``'s
    1x4 shards served on 1x4."""
    t0 = time.monotonic()
    lead = not any(mesh.get_coordinate())
    meshes = {"1x4": one_by_four, "2x2": mesh}
    out = {"seconds": {}, "serve": {}, "train": {}, "served": {}}
    for arch in TPR_ARCHS:
        t = time.monotonic()
        out["serve"][arch] = tpr_serve(arch, one_by_four)
        if not lead:
            del out["serve"][arch]["first"]
        out["seconds"][f"e1 {arch}"] = time.monotonic() - t
    for arch in TPR_ARCHS:
        for name in TPR_TRAIN[arch][1]:
            t = time.monotonic()
            out["train"][(arch, name)], shards = tpr_train(arch, meshes[name], *tpr_ref[arch])
            if arch in TPR_SERVED and name == "1x4":
                out["served"][arch] = tpr_trained_serve(arch, one_by_four, shards, lead)
            del shards
            release()
            out["seconds"][f"e2 {arch} {name}"] = time.monotonic() - t
    out["seconds"]["all"] = time.monotonic() - t0
    return out


def tpr_oracles() -> dict:
    """Part (e)'s one device, before the ranks use the card: (e1) served
    and freed, (e2)'s steps (their gradients written to files for the
    ranks)."""
    t0 = time.monotonic()
    with fp32_probs():
        out = {"serve": {arch: tpr_serve(arch, None) for arch in TPR_ARCHS}}
        out["train"] = {arch: tpr_train_oracle(arch) for arch in TPR_ARCHS}
    out["seconds"] = time.monotonic() - t0
    return out


def tpr_gates(ranks: list, oracle: dict) -> dict:
    """Part (e)'s gates over every rank's ``tpr_rank`` record beside one
    device's (``tpr_oracles``); returns the part's report.  Fails past
    ``TPR_PHASE_LIMIT_S`` (its oracles, the slowest rank's part, the
    gates)."""
    t_gates = time.monotonic()
    res = {"seconds": [r["seconds"] for r in ranks], "oracle_s": oracle["seconds"],
           "ranks_s": max(r["seconds"]["all"] for r in ranks), "serve": {}, "train": {},
           "served": {}}
    for arch in TPR_ARCHS:
        want, got = oracle["serve"][arch], ranks[0]["serve"][arch]
        what = f"tp {arch} on 1x4"
        gap = gap_rel(got["first"], want["first"])
        if gap > TPR_LOGIT_TOL:
            fail(f"{what}: first-step logit gap {gap:.3g} of the largest > {TPR_LOGIT_TOL}")
        if not np.array_equal(got["tokens"], want["tokens"]):
            fail(f"{what}: tokens differ from one device's")
        for i, r in enumerate(x["serve"][arch] for x in ranks):
            if r["digest"] != got["digest"]:
                fail(f"{what}: rank {i}'s tokens or logits differ from rank 0's")
            if r["dense_bytes"] != r["dense_bytes_want"]:
                fail(f"{what}: rank {i} stores {r['dense_bytes']} bytes, the placement says "
                     f"{r['dense_bytes_want']}")
            if r["collectives_per_step"] != r["predicted"]:
                fail(f"{what}: rank {i} made {r['collectives_per_step']} collectives a decode "
                     f"step, predicted {r['predicted']}")
        ratios = [x["serve"][arch]["peak_bytes"] / want["peak_bytes"] for x in ranks]
        if max(ratios) > TP_MEM_RATIO:
            fail(f"{what}: a rank's peak memory is {max(ratios):.3f}x one device's > "
                 f"{TP_MEM_RATIO}")
        res["serve"][arch] = {
            "layers": got["layers"], "first_step_gap_rel": gap,
            "token_agreement": float(np.mean(got["tokens"] == want["tokens"])),
            "peak_ratio_per_rank": ratios, "split": got["split"],
            "dense_bytes_ratio": got["dense_bytes"] / want["dense_bytes"],
            "one_device": {k: want[k] for k in ("ms_per_step", "tok_per_s", "peak_bytes",
                                                "dense_bytes", "draw_s", "prefill_s")},
            **{k: got[k] for k in ("ms_per_step", "tok_per_s", "collectives_per_step",
                                   "predicted", "bytes_per_step", "peak_bytes", "dense_bytes",
                                   "draw_s", "prefill_s")}}
    for (arch, name), lead in ranks[0]["train"].items():
        t = oracle["train"][arch]
        grad_tol = EP_GRAD_TOL if name == "1x4" else TPT_GRAD_TOL
        recs = [r["train"][(arch, name)] for r in ranks]
        for i, r in enumerate(recs):
            what = f"tp train {arch} {name}: rank {i}"
            loss_gap = abs(r["loss"] / t["loss"] - 1)
            if loss_gap > EP_LOSS_TOL or r["grad_gap"] > grad_tol:
                fail(f"{what}: loss gap {loss_gap:.3g} (limit {EP_LOSS_TOL}), gradient-shard "
                     f"gap {r['grad_gap']:.3g} at {r['grad_gap_leaf']} (limit {grad_tol})")
            if r["collectives"] != r["predicted"]:
                fail(f"{what}: {r['collectives']} collectives, predicted {r['predicted']}")
            r["fsdp_report"] = fsdp_check(what, r["fsdp"], t["activations"])
        res["train"][f"{arch} {name}"] = {
            "loss_gap_max": max(abs(r["loss"] / t["loss"] - 1) for r in recs),
            "grad_gap_max": max(r["grad_gap"] for r in recs), "layers": t["layers"],
            "grad_gap_leaf": max(recs, key=lambda r: r["grad_gap"])["grad_gap_leaf"],
            "one_device": {k: t[k] for k in ("loss", "ms", "peak_bytes", "tree_bytes",
                                             "activations")},
            "fsdp_per_rank": [r["fsdp_report"] for r in recs],
            **{k: lead[k] for k in ("collectives", "predicted", "bytes", "ms", "whole_step",
                                    "split", "compared")}}
    for arch, s in ranks[0]["served"].items():
        if not np.array_equal(s["served"]["tokens"], s["one"]["tokens"]):
            fail(f"tp train {arch} 1x4: the trained shards served on 1x4 give tokens other "
                 "than one device's on the gathered tree")
        res["served"][arch] = {
            "first_step_gap_rel": gap_rel(s["served"]["first"], s["one"]["first"]),
            "token_agreement": float(np.mean(s["served"]["tokens"] == s["one"]["tokens"])),
            "ms_per_step": s["served"]["ms_per_step"],
            "one_device_ms_per_step": s["one"]["ms_per_step"]}
    res["part_s"] = oracle["seconds"] + res["ranks_s"] + time.monotonic() - t_gates
    if res["part_s"] > TPR_PHASE_LIMIT_S:
        fail(f"tensor-parallel part (e) took {res['part_s']:.1f}s, over its "
             f"{TPR_PHASE_LIMIT_S:.0f}s")
    return res


def print_tpr(e: dict, card: str) -> None:
    print("tp (e): cuts of depth, never of a width: " + "; ".join(
        f"{k} {v}" for k, v in TPR_CUT_WHY.items()), flush=True)
    for arch, r in e["serve"].items():
        _, prompt, new = TPR_SERVE[arch]
        print(f"tp {arch} ({r['layers']} layers, fp32, dense, B={BATCH}, prompt {prompt}, {new} "
              f"new) on 1x4, splits {r['split']}: first-step logit gap "
              f"{r['first_step_gap_rel']:.3g} of the largest, token agreement "
              f"{r['token_agreement']:.3f}, peak a rank {r['peak_bytes']} bytes "
              f"({max(r['peak_ratio_per_rank']):.3f}x one device's "
              f"{r['one_device']['peak_bytes']}), bytes stored a rank {r['dense_bytes']} "
              f"({r['dense_bytes_ratio']:.4f} of one device's), {r['collectives_per_step']:.0f} "
              f"collectives a step (predicted {r['predicted']}), {r['bytes_per_step']:.0f} bytes "
              f"a step a rank, {r['ms_per_step']:.2f} ms a step (one device "
              f"{r['one_device']['ms_per_step']:.2f}), prefill {r['prefill_s']:.2f}s (one "
              f"device {r['one_device']['prefill_s']:.2f}s) ({card})", flush=True)
    for key, r in e["train"].items():
        kind = "one step" if r["whole_step"] else "the loss and gradients"
        print(f"tp train {key} ({r['layers']} layers, fp32, remat, batch {TRAIN_BATCH}, {kind} "
              f"from the draw): gaps loss {r['loss_gap_max']:.3g} gradient shard "
              f"{r['grad_gap_max']:.3g} (largest at {r['grad_gap_leaf']}; {r['compared']} leaves "
              f"compared), {r['collectives']} "
              f"collectives (predicted {r['predicted']}), {r['bytes']} bytes, {r['ms']:.1f} ms "
              f"(one device {r['one_device']['ms']:.1f}); {fsdp_line(r['fsdp_per_rank'])} "
              f"({card})", flush=True)
    for arch, s in e["served"].items():
        print(f"tp train {arch} 1x4 shards served on 1x4: first-step gap "
              f"{s['first_step_gap_rel']:.3g}, token agreement {s['token_agreement']:.3f} with "
              f"one device on the gathered tree, {s['ms_per_step']:.2f} ms a step (one device "
              f"{s['one_device_ms_per_step']:.2f}) ({card})", flush=True)
    print(f"tensor-parallel part (e) {e['part_s']:.1f}s (limit {TPR_PHASE_LIMIT_S:.0f}s; "
          f"oracles {e['oracle_s']:.1f}s, the slowest rank {e['ranks_s']:.1f}s, by part "
          f"{tpt_part_seconds(e)})", flush=True)


def enc_batch(cfg, tc, rows=None) -> tuple:
    """(f2)'s batch: the stream's first ``tc.global_batch`` x
    ``TRAIN_SEQ`` tokens over ``ENC_FRAMES`` seeded stand-in frames
    (normal, std 0.02, as the pipeline draws its own), on the card, whole
    and this rank's rows (``rows``)."""
    whole, _ = next(tpt_batches(cfg, tc))
    frames = np.random.default_rng(FAM_SEED + 1).normal(
        0, 0.02, (tc.global_batch, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    whole["frames"] = torch.from_numpy(frames).to(DEVICE)
    return whole, whole if rows is None else {k: v[rows] for k, v in whole.items()}


def enc_train_oracle() -> dict:
    """(f2)'s one device: the Trainer's step of whisper from
    ``sharded_init``'s whole draw on ``enc_batch``: the loss, ms, the peak
    above what the process held before, every gradient in a file for the
    ranks and its largest |g|."""
    cfg = mesh_cfg(ENC_ARCH)
    tr = Trainer(cfg, tpt_config(1, ENC_TRAIN_BATCH), device=DEVICE)
    batch, _ = enc_batch(cfg, tr.tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = sharded_init(cfg)
    paths = [p for p, _ in tree_items(params)]
    t0 = time.monotonic()
    m = tr.step_fn(params, adamw_init(params), batch, return_grads=True)[2]
    torch.cuda.synchronize()
    rec = {"loss": float(m["loss"]), "ms": 1e3 * (time.monotonic() - t0),
           "peak_bytes": torch.cuda.max_memory_allocated() - held, "path": str(ENC_DIR),
           "tree_bytes": sum(t.numel() * t.element_size() for _, t in tree_items(params))}
    # its activations and temporaries: the peak above its parameters, both
    # moments and its gradients
    rec["activations"] = rec["peak_bytes"] - 4 * rec["tree_bytes"]
    rec["gmax"] = save_grads(ENC_DIR, paths, m["grads"])
    del params, m
    release()
    return rec


def enc_train(mesh, path: str, gmax: dict) -> dict:
    """(f2) on one rank: the Trainer's step of whisper on ``mesh`` from this
    rank's shards of the draw on its rows of ``enc_batch``, beside one
    device's gradients (the files under ``path``): the loss, the largest
    gradient-shard gap and its leaf, the collectives beside
    ``train_collectives``' (``ENC_FRAMES`` encoder frames), bytes, ms."""
    cfg = mesh_cfg(ENC_ARCH)
    tr = Trainer(cfg, tpt_config(1, ENC_TRAIN_BATCH), device=DEVICE, mesh=mesh)
    _, rows = enc_batch(cfg, tr.tc, tr.rows)
    shards = sharded_init(cfg, mesh, tr.p_shard)
    opt = adamw_init(shards)
    comm.reset_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    (_, _, m), fsdp = fsdp_step(tr, cfg, shards, lambda: tr.step_fn(shards, opt, rows,
                                                                   return_grads=True))
    rec = {"loss": float(m["loss"]), "ms": 1e3 * (time.monotonic() - t0),
           "collectives": comm.STATS["collectives"], "bytes": comm.STATS["bytes"],
           "predicted": tr.plan.train_collectives(cfg, TRAIN_SEQ, split=tr.rows is not None,
                                                  frames=ENC_FRAMES),
           "split": {k: getattr(tr.plan, k) for k in ("heads", "ff", "vocab")}, "fsdp": fsdp}
    gaps = grad_gaps(path, tr.p_shard, m["grads"], gmax, mesh)
    rec.update(grad_gap=max(gaps.values()), grad_gap_leaf=max(gaps, key=gaps.get),
               compared=len(gaps))
    del shards, opt, m
    release()
    return rec


def enc_rank(mesh, one_by_four, enc_ref: tuple) -> dict:
    """Part (f) on one rank of phase 17's 2x2 world, fp32 attention
    probabilities: (f1) whisper served on 1x2 (the 2x2 mesh's ``model``
    sub-mesh), 1x4 and 2x2; (f2) its training step on 1x4 and 2x2
    (``enc_ref``: the files of one device's gradients and their largest
    |g|)."""
    t0 = time.monotonic()
    lead = not any(mesh.get_coordinate())
    meshes = {"1x2": mesh["model"], "1x4": one_by_four, "2x2": mesh}
    out = {"seconds": {}, "serve": {}, "train": {}}
    with fp32_probs():
        for name in ENC_MESHES:
            t = time.monotonic()
            out["serve"][name] = tpr_serve(ENC_ARCH, meshes[name])
            if not lead:
                del out["serve"][name]["first"]
            out["seconds"][f"f1 {name}"] = time.monotonic() - t
        for name in ENC_TRAIN_MESHES:
            t = time.monotonic()
            out["train"][name] = enc_train(meshes[name], *enc_ref)
            out["seconds"][f"f2 {name}"] = time.monotonic() - t
    out["seconds"]["all"] = time.monotonic() - t0
    return out


def enc_oracles() -> dict:
    """Part (f)'s one device, before the ranks use the card: (f1) served
    and freed, (f2)'s step (its gradients written to files)."""
    t0 = time.monotonic()
    with fp32_probs():
        out = {"serve": tpr_serve(ENC_ARCH, None), "train": enc_train_oracle()}
    out["seconds"] = time.monotonic() - t0
    return out


def enc_gates(ranks: list, oracle: dict) -> dict:
    """Part (f)'s gates over every rank's ``enc_rank`` record beside one
    device's (``enc_oracles``); returns the part's report.  Fails past
    ``ENC_PHASE_LIMIT_S`` (its oracles, the slowest rank's part, the
    gates)."""
    t_gates = time.monotonic()
    res = {"seconds": [r["seconds"] for r in ranks], "oracle_s": oracle["seconds"],
           "ranks_s": max(r["seconds"]["all"] for r in ranks), "serve": {}, "train": {}}
    want = oracle["serve"]
    for name in ENC_MESHES:
        got, what = ranks[0]["serve"][name], f"tp {ENC_ARCH} on {name}"
        gap = gap_rel(got["first"], want["first"])
        if gap > TPR_LOGIT_TOL:
            fail(f"{what}: first-step logit gap {gap:.3g} of the largest > {TPR_LOGIT_TOL}")
        if not np.array_equal(got["tokens"], want["tokens"]):
            fail(f"{what}: tokens differ from one device's")
        for i, r in enumerate(x["serve"][name] for x in ranks):
            if r["digest"] != got["digest"]:
                fail(f"{what}: rank {i}'s tokens or logits differ from rank 0's")
            if r["dense_bytes"] != r["dense_bytes_want"]:
                fail(f"{what}: rank {i} stores {r['dense_bytes']} bytes, the placement says "
                     f"{r['dense_bytes_want']}")
            if r["collectives_per_step"] != r["predicted"]:
                fail(f"{what}: rank {i} made {r['collectives_per_step']} collectives a decode "
                     f"step, predicted {r['predicted']}")
        res["serve"][name] = {
            "first_step_gap_rel": gap, "split": got["split"],
            "token_agreement": float(np.mean(got["tokens"] == want["tokens"])),
            "peak_ratio_per_rank": [x["serve"][name]["peak_bytes"] / want["peak_bytes"]
                                    for x in ranks],
            "dense_bytes_ratio": got["dense_bytes"] / want["dense_bytes"],
            "one_device": {k: want[k] for k in ("ms_per_step", "tok_per_s", "peak_bytes",
                                                "dense_bytes", "prefill_s")},
            **{k: got[k] for k in ("ms_per_step", "tok_per_s", "collectives_per_step",
                                   "predicted", "bytes_per_step", "peak_bytes", "dense_bytes",
                                   "prefill_s")}}
    t = oracle["train"]
    for name in ENC_TRAIN_MESHES:
        grad_tol = EP_GRAD_TOL if name == "1x4" else TPT_GRAD_TOL
        recs = [r["train"][name] for r in ranks]
        for i, r in enumerate(recs):
            what = f"tp train {ENC_ARCH} {name}: rank {i}"
            loss_gap = abs(r["loss"] / t["loss"] - 1)
            if loss_gap > EP_LOSS_TOL or r["grad_gap"] > grad_tol:
                fail(f"{what}: loss gap {loss_gap:.3g} (limit {EP_LOSS_TOL}), gradient-shard "
                     f"gap {r['grad_gap']:.3g} at {r['grad_gap_leaf']} (limit {grad_tol})")
            if r["collectives"] != r["predicted"]:
                fail(f"{what}: {r['collectives']} collectives, predicted {r['predicted']}")
            r["fsdp_report"] = fsdp_check(what, r["fsdp"], t["activations"])
        res["train"][name] = {
            "loss_gap_max": max(abs(r["loss"] / t["loss"] - 1) for r in recs),
            "grad_gap_max": max(r["grad_gap"] for r in recs),
            "grad_gap_leaf": max(recs, key=lambda r: r["grad_gap"])["grad_gap_leaf"],
            "one_device": {k: t[k] for k in ("loss", "ms", "peak_bytes", "tree_bytes",
                                             "activations")},
            "fsdp_per_rank": [r["fsdp_report"] for r in recs],
            **{k: recs[0][k] for k in ("collectives", "predicted", "bytes", "ms", "split",
                                       "compared")}}
    res["part_s"] = oracle["seconds"] + res["ranks_s"] + time.monotonic() - t_gates
    if res["part_s"] > ENC_PHASE_LIMIT_S:
        fail(f"tensor-parallel part (f) took {res['part_s']:.1f}s, over its "
             f"{ENC_PHASE_LIMIT_S:.0f}s")
    return res


def print_enc(f: dict, card: str) -> None:
    _, prompt, new = TPR_SERVE[ENC_ARCH]
    for name, r in f["serve"].items():
        print(f"tp {ENC_ARCH} (4 + 4 layers, fp32, dense, B={BATCH}, {ENC_FRAMES} frames, "
              f"prompt {prompt} dropped, {new} new) on {name}, splits {r['split']}: first-step "
              f"logit gap {r['first_step_gap_rel']:.3g} of the largest, token agreement "
              f"{r['token_agreement']:.3f}, bytes stored a rank {r['dense_bytes']} "
              f"({r['dense_bytes_ratio']:.4f} of one device's), peak a rank {r['peak_bytes']} "
              f"bytes ({max(r['peak_ratio_per_rank']):.3f}x one device's "
              f"{r['one_device']['peak_bytes']}), {r['collectives_per_step']:.0f} collectives a "
              f"step (predicted {r['predicted']}), {r['bytes_per_step']:.0f} bytes a step a "
              f"rank, {r['ms_per_step']:.2f} ms a step (one device "
              f"{r['one_device']['ms_per_step']:.2f}), prefill {r['prefill_s']:.2f}s (one "
              f"device {r['one_device']['prefill_s']:.2f}s) ({card})", flush=True)
    for name, r in f["train"].items():
        print(f"tp train {ENC_ARCH} {name} (4 + 4 layers, fp32, remat, batch {ENC_TRAIN_BATCH} "
              f"x {TRAIN_SEQ} tokens over {ENC_FRAMES} frames, one step from the draw), splits "
              f"{r['split']}: gaps loss {r['loss_gap_max']:.3g} gradient shard "
              f"{r['grad_gap_max']:.3g} (largest at {r['grad_gap_leaf']}; {r['compared']} "
              f"leaves compared), {r['collectives']} collectives (predicted {r['predicted']}), "
              f"{r['bytes']} bytes, {r['ms']:.1f} ms (one device {r['one_device']['ms']:.1f}); "
              f"{fsdp_line(r['fsdp_per_rank'])} ({card})", flush=True)
    print(f"tensor-parallel part (f) {f['part_s']:.1f}s (limit {ENC_PHASE_LIMIT_S:.0f}s; "
          f"oracles {f['oracle_s']:.1f}s, the slowest rank {f['ranks_s']:.1f}s, by part "
          f"{tpt_part_seconds(f)})", flush=True)


def tp_rank(mesh, device, qprompts, prompts, ep_ref, tpr_ref, enc_ref) -> dict:
    """One rank of phase 17's 2x2 world: (a) on a 1x4 mesh over the four
    ranks, then (b) on the 2x2 mesh's ``model`` sub-mesh (1x2; the two data
    coordinates run the same case), a 1x4 mesh and the 2x2 mesh, then (c)
    (``tpt_rank``) and (d) (``ep_rank``, one device's gradients of (d3)
    in the files of ``ep_ref``), then (e) (``tpr_rank``, its gradients in
    ``tpr_ref``) and (f) (``enc_rank``, its gradients in ``enc_ref``), (e)
    and (f) timed apart."""
    t0 = time.monotonic()
    lead = not any(mesh.get_coordinate())
    one_by_four = make_local_mesh(1, 4)
    with fp32_probs():
        out = {"qwen3": tp_qwen3(one_by_four, qprompts)}
    if not lead:
        del out["qwen3"]["first"]
    out["edge"] = tp_cases({"1x2": mesh["model"], "1x4": one_by_four, "2x2": mesh}, prompts,
                           lead)
    t1 = time.monotonic()
    with fp32_probs():
        out["train"] = tpt_rank(mesh, one_by_four, prompts)
        out["ep"] = ep_rank(mesh, one_by_four, ep_ref)
        out["ab_seconds"] = t1 - t0
        out["seconds"] = time.monotonic() - t0
        out["rec"] = tpr_rank(mesh, one_by_four, tpr_ref)
        out["enc"] = enc_rank(mesh, one_by_four, enc_ref)
    return out


def tp_oracles(qprompts) -> dict:
    """Phase 17's oracles that hold a whole model, (a)'s and (c2)'s: they
    run, and free it, before the ranks use the card."""
    t0 = time.monotonic()
    with fp32_probs():
        out = {"a": tp_qwen3(None, qprompts)}
        release()
        out["c2"] = tpt_qwen3(None)
    release()
    out["seconds"] = time.monotonic() - t0
    return out


def tp_references(prompts) -> dict:
    """Phase 17's single-device references beside the ranks: (b)'s runs
    and (c1)'s free run."""
    t0 = time.monotonic()
    out = {"b": tp_cases({"1x1": None}, prompts, True)}
    with fp32_probs():
        out["free"] = tpt_free(mesh_cfg("vusa_edge"), None)
    del out["free"]["out"]
    out["seconds"] = time.monotonic() - t0
    return out


def world_rank(mesh, device, prompts, qprompts, ep_ref, tpr_ref, enc_ref) -> dict:
    """One rank of the world phases 15 and 17 share: ``mesh_rank``, then
    ``tp_rank``."""
    return {"mesh": mesh_rank(mesh, device, prompts),
            "tp": tp_rank(mesh, device, qprompts, prompts, ep_ref, tpr_ref, enc_ref)}


def world_phases() -> tuple:
    """Phases 15 and 17 on one spawned world of four ranks sharing the card
    (one spawn, not two: the script's time).  Phase 17's whole-model
    oracles run first; then the ranks run phase 15's part and phase 17's
    while this process computes both phases' single-device references;
    then each phase's gates.  Returns (phase 15's report, phase 17's)."""
    release()
    prompts = prompts_for(get_config("vusa_edge"))
    qprompts = prompts_for(mesh_cfg(TP_ARCH))
    for d in (MESH_DIR, TP_DIR):
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
    oracles = tp_oracles(qprompts)
    oracles["ep"] = ep_oracles()
    oracles["seconds"] += oracles["ep"]["seconds"]
    oracles["rec"] = tpr_oracles()  # part (e)'s, timed apart
    oracles["enc"] = enc_oracles()  # part (f)'s, timed apart
    # one device's gradients of (d3), (e2) and (f2) wait in files
    ep_ref = {k: (v["path"], v["gmax"]) for k, v in oracles["ep"]["train"].items()}
    tpr_ref = {k: (v["path"], v["gmax"]) for k, v in oracles["rec"]["train"].items()}
    enc_ref = (oracles["enc"]["train"]["path"], oracles["enc"]["train"]["gmax"])
    wait_grads()
    box: dict = {}

    def run_ranks():
        t0 = time.monotonic()
        try:
            box["ranks"] = spawn(world_rank, 2, 2, "gloo", DEVICE, str(TP_DIR / "rendezvous"),
                                 args=(prompts, qprompts, ep_ref, tpr_ref, enc_ref),
                                 timeout_s=TP_PHASE_LIMIT_S)
        except BaseException as e:  # re-raised below, in the phase's thread
            box["error"] = e
        box["seconds"] = time.monotonic() - t0

    worker = threading.Thread(target=run_ranks)
    worker.start()
    t0 = time.monotonic()
    mesh_ref = mesh_references(prompts)
    t_mesh_ref = time.monotonic() - t0
    tp_ref = tp_references(prompts)
    worker.join()
    del ep_ref, tpr_ref, enc_ref
    release()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    mesh = mesh_gates([r["mesh"] for r in ranks], mesh_ref, t_mesh_ref)
    tp = tp_gates([r["tp"] for r in ranks], oracles, tp_ref)
    tp["world_s"] = box["seconds"]
    return mesh, tp


def tp_gates(ranks: list, oracles: dict, refs: dict) -> dict:
    """Phase 17's gates (module docstring) over every rank's ``tp_rank``
    record beside the oracles (``tp_oracles``) and references
    (``tp_references``) of this process; the phase's seconds are the
    oracles', the slowest rank's part and the gates'.  Fails past
    ``TP_PHASE_LIMIT_S``."""
    t_phase = time.monotonic()
    oracle, ref = oracles["a"], refs["b"]
    res = {"qwen3": {}, "edge": {}, "oracle_s": oracles["seconds"],
           "reference_s": refs["seconds"], "ranks_s": max(r["seconds"] for r in ranks),
           "rank_seconds": [r["seconds"] for r in ranks],
           "rank_ab_seconds": [r["ab_seconds"] for r in ranks]}
    # (a) qwen3_8b at 36 layers on 1x4 against one device
    got = ranks[0]["qwen3"]
    gap = gap_rel(got["first"], oracle["first"])
    print(f"tp qwen3_8b on 1x4: first-step gap {gap:.4g}, first tokens "
          f"{got['tokens'][:, 0].tolist()} / {oracle['tokens'][:, 0].tolist()}, peak bytes "
          f"{[r['qwen3']['peak_bytes'] for r in ranks]} / {oracle['peak_bytes']}", flush=True)
    if gap > MESH_LOGIT_TOL:
        fail(f"qwen3_8b on 1x4: first-step logit gap {gap:.3g} of the largest > {MESH_LOGIT_TOL}")
    if not np.array_equal(got["tokens"][:, 0], oracle["tokens"][:, 0]):
        fail("qwen3_8b on 1x4: the first greedy token differs from one device's")
    ratios = [r["qwen3"]["peak_bytes"] / oracle["peak_bytes"] for r in ranks]
    if max(ratios) > TP_MEM_RATIO:
        fail(f"qwen3_8b on 1x4: a rank's peak memory is {max(ratios):.3f}x one device's "
             f"> {TP_MEM_RATIO}")
    res["qwen3"] = {
        "first_step_gap_rel": gap, "token_agreement": float(np.mean(
            got["tokens"] == oracle["tokens"])), "peak_ratio_per_rank": ratios,
        "oracle": {k: oracle[k] for k in ("ms_per_step", "tok_per_s", "peak_bytes",
                                          "dense_bytes", "draw_s")},
        **{k: got[k] for k in ("ms_per_step", "tok_per_s", "collectives_per_step",
                               "bytes_per_step", "peak_bytes", "dense_bytes", "draw_s")},
        "layers": mesh_cfg(TP_ARCH).n_layers,
        "collectives_predicted": tp_predicted("dense", 1, 4, mesh_cfg(TP_ARCH).n_layers, False)}
    # (b) vusa_edge on 1x2, 1x4 and 2x2 against one device
    dims = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
    for key in sorted(ranks[0]["edge"]):
        name, layers, route, temp, bf16 = key
        want, got = ref[("1x1",) + key[1:]], ranks[0]["edge"][key]
        gap, what = gap_rel(got["first"], want["first"]), f"vusa_edge on {tp_label(key)}"
        if not bf16 and not np.array_equal(got["tokens"], want["tokens"]):
            fail(f"{what}: tokens differ from one device's")
        tol = TP_BF16_TOL if bf16 else MESH_LOGIT_TOL
        if gap > tol:
            fail(f"{what}: first-step logit gap {gap:.3g} of the largest > {tol}")
        dp, tp = dims[name]
        predicted = tp_predicted(route, dp, tp, layers, BATCH % dp == 0 and dp > 1)
        res["edge"][tp_label(key)] = {
            "first_step_gap_rel": gap,
            "token_agreement": float(np.mean(got["tokens"] == want["tokens"])),
            "collectives_predicted": predicted, "single_ms_per_step": want["ms_per_step"],
            **{k: got[k] for k in ("ms_per_step", "tok_per_s", "collectives_per_step",
                                   "bytes_per_step", "dense_bytes", "launches", "build_s")}}
        if route != "dense":
            c, kind = got["launches"], ROUTE_KIND[route]
            if min(c["vusa_packed_matmul"][kind], c["vusa_fused_mlp_partials"][kind],
                   c["vusa_window_sum"]["dense"]) == 0 or sum(
                       c["vusa_fused_mlp_matmul"].values()):
                fail(f"{what}: the sharded path did not go through its kernels: {c}")
    # every rank: the same bits, its storage, its collectives
    for i, r in enumerate(ranks):
        runs = [("qwen3_8b 1x4", r["qwen3"], ranks[0]["qwen3"],
                 res["qwen3"]["collectives_predicted"])]
        runs += [(f"vusa_edge {tp_label(k)}", v, ranks[0]["edge"][k],
                  res["edge"][tp_label(k)]["collectives_predicted"])
                 for k, v in r["edge"].items()]
        for what, rec, lead, predicted in runs:
            if rec["digest"] != lead["digest"]:
                fail(f"{what}: rank {i}'s tokens or logits differ from rank 0's")
            if rec["dense_bytes"] != rec["dense_bytes_want"]:
                fail(f"{what}: rank {i} stores {rec['dense_bytes']} dense bytes, the placement "
                     f"says {rec['dense_bytes_want']}")
            if rec["collectives_per_step"] != predicted:
                fail(f"{what}: rank {i} made {rec['collectives_per_step']} collectives a "
                     f"decode step, predicted {predicted}")
    res["train"] = tpt_gates([r["train"] for r in ranks], oracles["c2"], refs["free"])
    res["ep"] = ep_gates([r["ep"] for r in ranks], oracles["ep"])
    res["seconds"] = oracles["seconds"] + res["ranks_s"] + time.monotonic() - t_phase
    if res["seconds"] > TP_PHASE_LIMIT_S:
        fail(f"tensor-parallel phase took {res['seconds']:.1f}s, over its "
             f"{TP_PHASE_LIMIT_S:.0f}s")
    res["rec"] = tpr_gates([r["rec"] for r in ranks], oracles["rec"])
    res["enc"] = enc_gates([r["enc"] for r in ranks], oracles["enc"])
    return res


def tpt_gates(ranks: list, q_oracle: dict, free_ref: dict) -> dict:
    """Part (c)'s gates over every rank's ``tpt_rank`` record, beside one
    device's (c2) step and (c1) free run from this process; returns the
    part's report."""
    res = {"lockstep": {}, "seconds": [r["seconds"] for r in ranks]}

    def lockstep(what, recs):
        """(c1)/(c3)'s gates over the ranks' lockstep records ``recs``."""
        for i, r in enumerate(recs):
            worst = {k: max(r[k]) for k in ("loss_gaps", "norm_gaps", "grad_gaps")}
            for key, tol in (("loss_gaps", TPT_LOSS_TOL), ("norm_gaps", TPT_NORM_TOL),
                             ("grad_gaps", TPT_GRAD_TOL)):
                if worst[key] > tol:
                    fail(f"tp train {what}: rank {i}'s {key[:-5]} gap {worst[key]:.3g} from "
                         f"one device's step > {tol}")
            if any(c != r["predicted"] for c in r["collectives"]):
                fail(f"tp train {what}: rank {i} made {r['collectives']} collectives a step, "
                     f"predicted {r['predicted']}")
            r["fsdp_report"] = [fsdp_check(f"tp train {what}: rank {i}", f) for f in r["fsdp"]]
            if not r.get("masks_equal"):
                fail(f"tp train {what}: rank {i}'s masks refreshed leaf by leaf differ from "
                     "one device's")
            if r["same"] != recs[0]["same"]:
                fail(f"tp train {what}: rank {i}'s loss or norm differs from rank 0's")
            lead = next(x for x in recs if x["data_rank"] == r["data_rank"])
            if r["replicated"] != lead["replicated"]:
                fail(f"tp train {what}: rank {i}'s replicated gradients differ from its data "
                     "coordinate's first rank's")
        r = recs[0]
        return {"loss_gap_max": max(max(x["loss_gaps"]) for x in recs),
                "norm_gap_max": max(max(x["norm_gaps"]) for x in recs),
                "grad_gap_max": max(max(x["grad_gaps"]) for x in recs),
                "collectives_per_step": r["collectives"][0], "predicted": r["predicted"],
                "fsdp_per_rank": [x["fsdp_report"][0] for x in recs],
                "bytes_per_step": float(np.mean(r["bytes"])),
                "ms_per_step": float(np.median(r["ms"])),
                "one_device_ms_per_step": float(np.median(r["one_ms"])), "ranks": len(recs)}

    for name in ("1x2", "1x4", "2x2"):
        res["lockstep"][name] = lockstep(f"vusa_edge {name}", [
            r["lockstep"][name] for r in ranks if name in r["lockstep"]])
    # (c3) qwen2 on 1x4: sequence-sharded attention under grad
    res["qwen2"] = lockstep("qwen2_0_5b 1x4", [r["qwen2"] for r in ranks])
    if min(r["qwen2"]["seq_shard_calls"] for r in ranks) == 0:
        fail("tp train qwen2_0_5b 1x4: the sequence-sharded attention did not run")
    res["qwen2"]["seq_shard_calls"] = ranks[0]["qwen2"]["seq_shard_calls"]
    # (c2) qwen3 on 1x4 against one device's step; each rank's peak within
    # its placement's params, grads and moments plus a quarter of one
    # device's activations (its peak less its own params, grads, moments)
    act = q_oracle["peak_bytes"] - q_oracle["state_bytes"]
    for i, r in enumerate(x["qwen3"] for x in ranks):
        loss_gap = abs(r["loss"] / q_oracle["loss"] - 1)
        norm_gap = abs(r["gnorm"] / q_oracle["gnorm"] - 1)
        bound = r["state_bytes"] + act / 4
        if loss_gap > TPT_LOSS_TOL or norm_gap > TPT_NORM_TOL:
            fail(f"tp train qwen3_8b 1x4: rank {i}'s loss gap {loss_gap:.3g} or norm gap "
                 f"{norm_gap:.3g} from one device's step over {TPT_LOSS_TOL} / {TPT_NORM_TOL}")
        if r["peak_bytes"] > bound:
            fail(f"tp train qwen3_8b 1x4: rank {i} peaked at {r['peak_bytes']} bytes, over "
                 f"the bound {bound:.0f} ({r['state_bytes']} of state + {act / 4:.0f})")
        if r["collectives"] != r["predicted"] or r["same"] != ranks[0]["qwen3"]["same"]:
            fail(f"tp train qwen3_8b 1x4: rank {i} made {r['collectives']} collectives "
                 f"(predicted {r['predicted']}) or its loss and norm differ from rank 0's")
    q = ranks[0]["qwen3"]
    res["qwen3"] = {
        "layers": TPT_QWEN3_LAYERS, "cut": TPT_CUT_WHY["qwen3_8b"],
        "loss_gap": abs(q["loss"] / q_oracle["loss"] - 1),
        "norm_gap": abs(q["gnorm"] / q_oracle["gnorm"] - 1),
        "peak_bytes_per_rank": [x["qwen3"]["peak_bytes"] for x in ranks],
        "bound_bytes": q["state_bytes"] + act / 4, "state_bytes_per_rank": q["state_bytes"],
        "one_device": {k: q_oracle[k] for k in ("peak_bytes", "state_bytes", "ms", "draw_s")},
        "peak_ratio": max(x["qwen3"]["peak_bytes"] for x in ranks) / q_oracle["peak_bytes"],
        **{k: q[k] for k in ("ms", "collectives", "predicted", "bytes", "draw_s")}}
    # (c1) the free run on 1x2 and its shards served on the same mesh
    free = [r["free"] for r in ranks if "free" in r]
    cfg = mesh_cfg("vusa_edge")
    for i, r in enumerate(free):
        if abs(r["sparsity"] - cfg.sparsity) > TRAIN_SPARSITY_TOL:
            fail(f"tp train 1x2 free run: rank {i}'s sparsity {r['sparsity']:.4f}, target "
                 f"{cfg.sparsity}")
        gap = abs(r["final_loss"] / free_ref["final_loss"] - 1)
        if gap > TPT_FREE_TOL:
            fail(f"tp train 1x2 free run: final loss {r['final_loss']:.5f} is {gap:.3g} from "
                 f"one device's {free_ref['final_loss']:.5f} > {TPT_FREE_TOL}")
    serve = [r["serve"] for r in ranks if "serve" in r]
    one = serve[0]["one"]
    n, layers = TP_NEW - 1, cfg.n_layers
    planned = {"vusa_packed_matmul": (4 * layers + 1) * n, "vusa_fused_mlp_partials": layers * n,
               "vusa_window_sum": layers * n, "vusa_fused_mlp_matmul": 0}
    for i, r in enumerate(x["tp"] for x in serve):
        got = {w: sum(c.values()) for w, c in r["launches"].items()}
        if got != planned:
            fail(f"tp train 1x2 serving: its rank {i}'s B1/B2 launches {got}, planned "
                 f"{planned}")
        if r["digest"] != serve[0]["tp"]["digest"]:
            fail(f"tp train 1x2 serving: its rank {i}'s tokens or logits differ from its rank "
                 "0's")
        if r["collectives_per_step"] != tp_predicted("bf16", 1, 2, layers, False):
            fail(f"tp train 1x2 serving: its rank {i} made {r['collectives_per_step']} "
                 "collectives a decode step")
    tp0 = serve[0]["tp"]
    gap = gap_rel(tp0["first"], one["first"])
    if gap > MESH_LOGIT_TOL:
        fail(f"tp train 1x2 serving: first-step logit gap {gap:.3g} of the largest > "
             f"{MESH_LOGIT_TOL}")
    res["free"] = {"final_loss": free[0]["final_loss"], "one_device_final_loss":
                   free_ref["final_loss"], "sparsity": free[0]["sparsity"],
                   "final_loss_gap": abs(free[0]["final_loss"] / free_ref["final_loss"] - 1),
                   **{k: free[0][k] for k in ("ms_per_step", "collectives_per_step",
                                              "bytes_per_step", "peak_bytes")},
                   "one_device": {k: free_ref[k] for k in ("ms_per_step", "peak_bytes")}}
    res["serve"] = {"first_step_gap_rel": gap, "token_agreement": float(np.mean(
        tp0["tokens"] == one["tokens"])), "launches": tp0["launches"], "planned": planned,
        **{k: tp0[k] for k in ("collectives_per_step", "bytes_per_step", "ms_per_step",
                               "tok_per_s")},
        "one_device_ms_per_step": one["ms_per_step"]}
    return res


def tpt_part_seconds(c: dict) -> dict:
    """Part (c)'s seconds by part, the slowest rank's of each."""
    names = sorted({k for r in c["seconds"] for k in r})
    return {k: round(max(r.get(k, 0.0) for r in c["seconds"]), 1) for k in names}


def print_tp(t: dict, card: str) -> None:
    q = t["qwen3"]
    print(f"tp: the ranks are processes sharing this one card over gloo, their collectives "
          f"staged through host memory: the times below are not multi-GPU speeds ({card})",
          flush=True)
    print(f"tp qwen3_8b ({q['layers']} layers, fp32, dense route, B={BATCH}, prompt {PROMPT}, "
          f"{TP_NEW} new) "
          f"on 1x4: first-step logit gap {q['first_step_gap_rel']:.3g} of the largest, token "
          f"agreement {q['token_agreement']:.3f}, peak memory a rank {q['peak_bytes']} bytes "
          f"({max(q['peak_ratio_per_rank']):.3f}x one device's {q['oracle']['peak_bytes']}), "
          f"dense bytes a rank {q['dense_bytes']} (one device {q['oracle']['dense_bytes']}), "
          f"{q['collectives_per_step']:.0f} collectives a step (predicted "
          f"{q['collectives_predicted']}), {q['ms_per_step']:.2f} ms a step, "
          f"{q['tok_per_s']:.1f} tok/s; one device {q['oracle']['ms_per_step']:.2f} ms a step, "
          f"{q['oracle']['tok_per_s']:.1f} tok/s ({card})", flush=True)
    for key, r in t["edge"].items():
        print(f"tp vusa_edge {key} (B={BATCH}, eager): gap {r['first_step_gap_rel']:.3g}, "
              f"token agreement {r['token_agreement']:.3f}, {r['collectives_per_step']:.0f} "
              f"collectives a step (predicted {r['collectives_predicted']}), "
              f"{r['bytes_per_step']:.0f} bytes a step, {r['ms_per_step']:.2f} ms a step "
              f"(one device {r['single_ms_per_step']:.2f}), {r['tok_per_s']:.1f} tok/s, "
              f"dense bytes a rank {r['dense_bytes']}, engine build {r['build_s']:.2f}s "
              f"({card})", flush=True)
    c = t["train"]
    for name, r in c["lockstep"].items():
        print(f"tp train vusa_edge {name} ({mesh_cfg('vusa_edge').n_layers} layers, fp32, "
              f"remat, batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, {TPT_LOCKSTEP} steps from one device's state): gaps loss "
              f"{r['loss_gap_max']:.3g} norm {r['norm_gap_max']:.3g} grad shard "
              f"{r['grad_gap_max']:.3g}, {r['collectives_per_step']} collectives a step "
              f"(predicted {r['predicted']}), {r['bytes_per_step']:.0f} bytes a step a rank, "
              f"{r['ms_per_step']:.1f} ms a step (one device beside it "
              f"{r['one_device_ms_per_step']:.1f}) ({card})", flush=True)
    q = c["qwen3"]
    print(f"tp train qwen3_8b ({q['layers']} of 36 layers, fp32, batch {TPT_QWEN3_BATCH} x "
          f"{TRAIN_SEQ}) on 1x4: gaps loss {q['loss_gap']:.3g} norm {q['norm_gap']:.3g}, peak "
          f"a rank {max(q['peak_bytes_per_rank'])} bytes (bound {q['bound_bytes']:.0f}, "
          f"{q['peak_ratio']:.3f}x one device's {q['one_device']['peak_bytes']}), "
          f"{q['collectives']} collectives (predicted {q['predicted']}), {q['bytes']} bytes, "
          f"{q['ms']:.1f} ms a step (one device {q['one_device']['ms']:.1f}) ({card})",
          flush=True)
    q = c["qwen2"]
    print(f"tp train qwen2_0_5b ({TPT_QWEN2_LAYERS} of 24 layers, fp32) on 1x4, sequence-"
          f"sharded attention ({q['seq_shard_calls']} calls): gaps loss {q['loss_gap_max']:.3g} "
          f"norm {q['norm_gap_max']:.3g} grad shard {q['grad_gap_max']:.3g}, "
          f"{q['collectives_per_step']} collectives (predicted {q['predicted']}), "
          f"{q['ms_per_step']:.1f} ms a step (one device {q['one_device_ms_per_step']:.1f}) "
          f"({card})", flush=True)
    f, sv = c["free"], c["serve"]
    print(f"tp train vusa_edge 1x2 free run ({TPT_FREE_STEPS} steps, pruned at {TPT_PRUNE}): "
          f"final loss {f['final_loss']:.5f} (one device {f['one_device_final_loss']:.5f}, "
          f"gap {f['final_loss_gap']:.3g}), sparsity {f['sparsity']:.4f}, "
          f"{f['ms_per_step']:.1f} ms a step (one device {f['one_device']['ms_per_step']:.1f}),"
          f" {f['collectives_per_step']:.0f} collectives and {f['bytes_per_step']:.0f} bytes a "
          f"step a rank, peak a rank {f['peak_bytes']} (one device "
          f"{f['one_device']['peak_bytes']}); served on 1x2 through B1/B2 (fp32 values): "
          f"first-step gap {sv['first_step_gap_rel']:.3g}, token agreement "
          f"{sv['token_agreement']:.3f}, launches {sv['launches']}, "
          f"{sv['ms_per_step']:.1f} ms a decode step (one device "
          f"{sv['one_device_ms_per_step']:.1f}) ({card})", flush=True)
    print_ep(t["ep"], card)
    print_tpr(t["rec"], card)
    print_enc(t["enc"], card)
    print(f"tensor-parallel phase {t['seconds']:.1f}s (limit {TP_PHASE_LIMIT_S:.0f}s; oracles "
          f"{t['oracle_s']:.1f}s, of them (d)'s {t['ep']['oracle_s']:.1f}s, the slowest rank's "
          f"part of the shared world {t['ranks_s']:.1f}s, of it (a)-(b) "
          f"{max(t['rank_ab_seconds']):.1f}s, (c) by part {tpt_part_seconds(c)}, (d) by part "
          f"{tpt_part_seconds(t['ep'])}; single-device references {t['reference_s']:.1f}s "
          f"beside it; the world with phase 15 {t['world_s']:.1f}s)", flush=True)


# --------------------------------------------------------------------------
# phase 16: the leftovers and cost tools
# --------------------------------------------------------------------------


def nm_phase(raw, rng) -> list:
    """Phase 16a: 2:4 packs (``ops.pack_linear_rows_nm``) of layer 0's wq
    and the head, drawn dense, with fp32, int8 and int4 values, through B1
    and B3 with phase 3's checks (kernel vs plain, CUDA launches as
    ``row_plan`` plans, rows bitwise B = 1) and timings; the fp32 packs
    also against ``x @ masked`` at rtol / atol 1e-4 (``benchmarks/run.py``'s
    check)."""
    from repro_torch.core.packing import nm_mask

    timer = Timer()
    n, block = NM_SHAPE
    mats = {"wq": raw["layers"]["attn"]["wq"][0].flatten(1),
            "head": raw["lm_head"]}
    records = []
    for name, w in mats.items():
        host = w.detach().float().cpu().numpy()
        masked = torch.from_numpy(np.where(nm_mask(host, n, block), host, 0)).to(DEVICE)
        xs = activations(rng, w.shape[0])
        for vdt in ("dense",) + QDTYPES:
            lin = ops.pack_linear_rows_nm(w, n=n, block=block, a=NM_A, value_dtype=vdt)
            if lin.slots != ops.nm_slot_bound(n, block, lin.m, NM_A):
                fail(f"2:4 {name} {vdt}: {lin.slots} slots, not the bound")
            rec = check_packed_matmul(timer, f"2:4 {name} {vdt}", lin, xs, time_it=True)
            if vdt == "dense":
                for x in xs:
                    got = vusa_packed_matmul(x, lin.values, lin.positions, m=lin.m)[:, : lin.c]
                    want = x.float() @ masked
                    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                        fail(f"2:4 {name} x={x.dtype} B={x.shape[0]}: kernel vs x @ masked "
                             f"{float((got - want).abs().max())}")
            rec.update(byte_ratio=lin.byte_ratio, jobs=lin.slots // lin.a,
                       nnz_per_row_window=int((lin.positions >= 0).sum(-1).max()))
            records.append(rec)
    return records


def greedy_packed(cfg, params, packed, tok, cache, steps: int) -> torch.Tensor:
    """``steps`` greedy tokens through ``lm_decode_step_packed`` from a
    primed ``(tok, cache)``."""
    out = [tok]
    for _ in range(steps):
        logits, cache = lm_decode_step_packed(params, packed, out[-1], cache, cfg)
        out.append(torch.argmax(logits[:, -1].float(), dim=-1)[:, None])
    return torch.cat(out, 1)


def legacy_phase(cfg, params) -> dict:
    """Phase 16b: the legacy MLP-only pack (``pack_lm_mlps``) in fp32 against
    the fused MLP pack (``pack_lm_weights(scope="mlp")``) of the same
    weights, both from one dense prefill: one decode step counted (B1
    exactly 3 a layer and as ``row_plan`` plans, B2 none), the first
    step's logits within ``LEGACY_TOL_FULL`` of the largest at full depth
    and ``LEGACY_TOL_CUT`` on the 2-layer cut, and greedy tokens identical
    on the cut."""
    from repro_torch.serve.packed import pack_lm_mlps, pack_lm_weights

    out = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tokens = torch.from_numpy(prompts_for(cfg)).long().to(DEVICE)
    for layers in (cfg.n_layers, DEPTH_CUT):
        c = dataclasses.replace(cfg32, n_layers=layers)
        p = params if layers == cfg.n_layers else {**params,
                                                  "layers": first_layers(params["layers"])}
        t0 = time.monotonic()
        flat = pack_lm_mlps(c, p, m=128, a=16)
        fused = pack_lm_weights(c, p, scope="mlp")
        pack_s = time.monotonic() - t0
        with torch.no_grad():
            logits, cache = build_model(c).prefill(p, {"tokens": tokens}, PROMPT + MAX_NEW)
            tok = torch.argmax(logits.float(), dim=-1)[:, None]
            cuda0 = packed_cuda_launches("vusa_packed_matmul")
            reset_launch_counts()
            lf = lm_decode_step_packed(p, flat, tok, copy_cache(cache), c)[0]
            counts = {"vusa_packed_matmul": dict(vusa_packed_matmul.launches),
                      "vusa_fused_mlp_matmul": dict(vusa_fused_mlp_matmul.launches)}
            cuda = packed_cuda_launches("vusa_packed_matmul") - cuda0
            want = {name: {r: (3 * layers if name == "vusa_packed_matmul" and r == "dense" else 0)
                           for r in counts[name]} for name in counts}
            if counts != want:
                fail(f"legacy MLP pack, {layers} layers: launches {counts} != {want}")
            plan = layers * sum(row_plan.cuda_launches(
                row_plan.row_plan(flat[n]["k"]), BATCH, flat[n]["values"].shape[1] * 128)
                for n in ("w_gate", "w_up", "w_down"))
            if cuda != plan:
                fail(f"legacy MLP pack, {layers} layers: {cuda} CUDA launches, the plan {plan}")
            lu = lm_decode_step_packed(p, fused, tok, copy_cache(cache), c)[0]
            gap, rel = rel_err(lf, lu)
            if rel > (LEGACY_TOL_FULL if layers == cfg.n_layers else LEGACY_TOL_CUT):
                fail(f"legacy vs fused MLP pack, {layers} layers, fp32: first-step gap {gap} "
                     f"({rel} of the largest logit)")
            rec = {"layers": layers, "launches": counts, "cuda_launches": cuda,
                   "first_step_logit_gap": gap, "first_step_logit_gap_rel": rel,
                   "pack_s": pack_s, "byte_ratio": packed_byte_ratios(flat)["total"],
                   "fused_byte_ratio": packed_byte_ratios(fused)["total"]}
            if layers == DEPTH_CUT:
                runs = {}
                for what, pk in (("legacy", flat), ("fused", fused)):
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    runs[what] = greedy_packed(c, p, pk, tok, copy_cache(cache), MAX_NEW - 1)
                    torch.cuda.synchronize()
                    rec[f"{what}_ms_per_step"] = 1e3 * (time.monotonic() - t0) / (MAX_NEW - 1)
                if not torch.equal(runs["legacy"], runs["fused"]):
                    fail(f"legacy vs fused MLP pack, {DEPTH_CUT} layers: greedy tokens differ, "
                         f"{float((runs['legacy'] == runs['fused']).float().mean())} agree")
                rec["greedy_tokens_equal"] = True
        out[layers] = rec
        release()
    return out


def requested_bytes(key: str = "current") -> int:
    stats = torch.cuda.memory_stats()
    name = f"requested_bytes.all.{key}"
    if name not in stats:
        fail(f"torch.cuda.memory_stats() has no {name!r}")
    return stats[name]


def cost_phase(cfg) -> dict:
    """Phase 16c: ``launch/dryrun.py``'s trace of ``vusa_edge``'s decode
    step, prefill and train step on a 1x1 mesh (``COST_CELLS``) against the
    same step run for real on the card: argument bytes equal to the bytes
    the card holds for them (the allocator's requested bytes) and the
    traced ``dot_flops`` equal to ``FlopCounterMode``'s count of the real
    call, exactly; the real call's peak above its arguments over the
    trace's ``temp_size_in_bytes`` inside ``COST_BAND``; the real call's
    time (CUDA events, the mean of ``COST_ITERS`` calls after a warm-up)
    beside ``roofline.analyze_record``'s bound (H100 data-sheet peaks)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, roofline

    out = {}
    for kind, b, s in COST_CELLS:
        t0 = time.monotonic()
        with dryrun.fake_world(1):
            mesh = make_local_mesh(1, 1)
            rec = dryrun.trace_step(cfg, kind, b, s, mesh)
        trace_s = time.monotonic() - t0
        release()
        torch.cuda.synchronize()
        r0 = requested_bytes()
        run, args = dryrun.build_step(cfg, kind, b, s, None, device=DEVICE, seed=0)
        torch.cuda.synchronize()
        held, real = requested_bytes() - r0, dryrun.tree_bytes(args)
        traced = rec["memory"]["argument_size_in_bytes"]
        if not traced == real == held:
            fail(f"cost {kind}: argument bytes traced {traced}, tensors {real}, allocated {held}")
        run()  # warm-up: cuBLAS workspaces, the allocator's pools
        torch.cuda.synchronize()
        with FlopCounterMode(display=False) as fc:
            run()
        if fc.get_total_flops() != rec["weighted"]["dot_flops"]:
            fail(f"cost {kind}: traced dot_flops {rec['weighted']['dot_flops']}, "
                 f"FlopCounterMode of the real call {fc.get_total_flops()}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base, base_req = torch.cuda.memory_allocated(), requested_bytes()
        res = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        peak_req = requested_bytes("peak") - base_req
        del res
        temp = rec["memory"]["temp_size_in_bytes"]
        if not COST_BAND[0] <= peak / temp <= COST_BAND[1]:
            fail(f"cost {kind}: peak above the arguments {peak} bytes, the trace's temp {temp}: "
                 f"ratio {peak / temp} outside {COST_BAND}")
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(COST_ITERS)]
        for start, end in events:
            start.record()
            run()
            end.record()
        torch.cuda.synchronize()
        ms = sum(st.elapsed_time(en) for st, en in events) / COST_ITERS
        row = roofline.analyze_record({**rec, "arch": "vusa_edge", "shape": kind, "n_devices": 1},
                                      shape=ShapeConfig(kind, s, b, kind))
        out[kind] = {"batch": b, "seq": s, "trace_s": trace_s, "argument_bytes": real,
                     "dot_flops": rec["weighted"]["dot_flops"], "bytes": rec["weighted"]["bytes"],
                     "transcendentals": rec["weighted"]["transcendentals"],
                     "temp_bytes": temp, "peak_bytes": peak, "peak_requested_bytes": peak_req,
                     "peak_over_temp": peak / temp, "ms": ms, "bound_ms": 1e3 * row["bound_s"],
                     "bound_by": row["dominant"], "roofline_frac": 1e3 * row["bound_s"] / ms,
                     "model_flops": row["model_flops_dev"]}
        del run, args
        release()
    return out


def leftovers_phase(raw, params, cfg) -> dict:
    """Phase 16 (module docstring).  Fails past ``LEFT_PHASE_LIMIT_S``."""
    t0 = time.monotonic()
    res = {"nm": nm_phase(raw, np.random.default_rng(16)), "legacy_mlp": legacy_phase(cfg, params),
           "cost": cost_phase(cfg)}
    res["seconds"] = time.monotonic() - t0
    if res["seconds"] > LEFT_PHASE_LIMIT_S:
        fail(f"leftovers phase took {res['seconds']:.1f}s, over its {LEFT_PHASE_LIMIT_S:.0f}s")
    return res


def print_leftovers(lo: dict, card: str) -> None:
    for r in lo["nm"]:
        t = r["timing"]
        worst = max(c["rel_err"] for c in r["cases"])
        print(f"2:4 pack {r['name']} ({r['shape'][0]} -> {r['shape'][1]}): ok, worst error "
              f"{worst:.3g} of max |plain|, byte ratio {r['byte_ratio']:.4f}, {r['jobs']} jobs; "
              f"B={t['B']} {t['x']}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library on "
              f"the masked weight {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} by "
              f"{t['bound_by']}) ({card})", flush=True)
    for layers, r in lo["legacy_mlp"].items():
        line = (f"legacy MLP pack, {layers} layers, fp32: {r['launches']['vusa_packed_matmul']} "
                f"B1 launches a step (3 a layer), B2 "
                f"{r['launches']['vusa_fused_mlp_matmul']}, CUDA launches {r['cuda_launches']}; "
                f"first-step logits vs the fused MLP pack {r['first_step_logit_gap']:.4g} "
                f"({r['first_step_logit_gap_rel']:.3g} of the largest); byte ratio "
                f"{r['byte_ratio']:.4f} (fused {r['fused_byte_ratio']:.4f})")
        if "greedy_tokens_equal" in r:
            line += (f"; greedy tokens identical; ms a step legacy {r['legacy_ms_per_step']:.3f}"
                     f", fused {r['fused_ms_per_step']:.3f}")
        print(line + f" ({card})", flush=True)
    for kind, r in lo["cost"].items():
        print(f"dry run vs card, vusa_edge {kind} B={r['batch']} S={r['seq']}: argument bytes "
              f"{r['argument_bytes']} and dot_flops {r['dot_flops']} equal; peak above the "
              f"arguments {r['peak_bytes']} vs traced temp {r['temp_bytes']} "
              f"({r['peak_over_temp']:.4f}); {r['ms']:.4f} ms against the roofline bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} (H100 data-sheet peaks): fraction "
              f"{r['roofline_frac']:.4f}; traced in {r['trace_s']:.1f}s ({card})", flush=True)
    print(f"leftovers phase {lo['seconds']:.1f}s (limit {LEFT_PHASE_LIMIT_S:.0f}s) ({card})",
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    faulthandler.enable()  # a crash in native code prints the Python stack
    strict_fp32()  # TF32 off: dense fp32 products are true fp32
    t_start = time.monotonic()
    card = card_line()
    print(card, flush=True)

    t0 = time.monotonic()
    reports = build.build(force=True)
    for name, rep in reports.items():
        print(f"--- ptxas report: {name}.cu ---\n{rep.strip()}", flush=True)
    print(f"built {list(reports)} in {time.monotonic() - t0:.1f}s", flush=True)

    cfg = get_config("vusa_edge")
    t0 = time.monotonic()
    raw = build_model(cfg).init(0, device=DEVICE)  # unpruned: phase 8 tiers it
    params = prune_tree(raw, cfg.sparsity)
    max_len = PROMPT + MAX_NEW + 8
    # fused=False: the counted runs and the phases before 7 take the eager loop
    eng = Engine(cfg, params, ServeConfig(max_len=max_len, packed_weights="all", fused=False),
                 device=DEVICE)
    qengs = {route: Engine(cfg, params, ServeConfig(max_len=max_len, packed_weights="all",
                                                    fused=False,
                                                    packed_values=route), device=DEVICE)
             for route in QDTYPES}
    engines = {"dense": eng, **qengs}
    ratios = {route: packed_byte_ratios(e.packed) for route, e in engines.items()}
    sizes = {route: pack_bytes(e.packed) for route, e in engines.items()}
    print(f"vusa_edge init+prune+pack (3 packs) {time.monotonic() - t0:.1f}s; pack bytes per "
          "decode step (byte ratio vs dense fp32): " + ", ".join(
              f"{'fp32' if r == 'dense' else r} values {sizes[r]} ({ratios[r]['total']:.4f})"
              for r in engines), flush=True)

    floor_ms = Timer()(lambda: empty_kernel(DEVICE))
    print(f"launch floor: an empty kernel takes {floor_ms:.4f} ms under the kernel timer (L2 "
          f"flushed, device spin of {SPIN_CYCLES} cycles, CUDA events)", flush=True)
    records, step = kernel_phase(cfg, {r: e.packed for r, e in engines.items()},
                                 np.random.default_rng(0))
    for r in records:
        worst = max(c["rel_err"] for c in r["cases"])
        line = f"kernel check {r['name']}: ok, worst error {worst:.3g} of max |plain|"
        if "timing" in r:
            t = r["timing"]
            line += (f"; B={t['B']} {t['x']}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
                     f"library {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']})")
        print(line, flush=True)

    res = model_phase(cfg, params, eng)
    main_, b16, f32 = res["main"], res["bf16"], res["fp32"]
    print(f"main path: launches {res['launches']} over {MAX_NEW - 1} decode steps, CUDA launches "
          f"per call {res['cuda_launches_per_call']} (counted, equal to the plan); bf16 packed "
          f"{main_['tok_per_s']:.1f} tok/s (decode {main_['decode_s']:.4f} s, prefill "
          f"{main_['prefill_s']:.4f} s, peak memory {main_['peak_bytes']} bytes), dense "
          f"{b16['dense_tok_per_s']:.1f} tok/s, token agreement {b16['token_agreement']:.4f}, "
          f"first-step logit gap {b16['first_step_logit_gap']:.4g} "
          f"({b16['first_step_logit_gap_rel']:.3g} of max)", flush=True)
    for r in (f32, res["fp32_depth_cut"]):
        print(f"fp32 {r['layers']} layers: packed {r['packed_tok_per_s']:.1f} tok/s, dense "
              f"{r['dense_tok_per_s']:.1f} tok/s; packed vs dense: token agreement "
              f"{r['token_agreement']:.4f}, first-step logit gap {r['first_step_logit_gap']:.4g} "
              f"({r['first_step_logit_gap_rel']:.3g} of max); witness (dense, ff lanes "
              f"permuted) vs dense: token agreement {r['witness_token_agreement']:.4f}, "
              f"first-step logit gap {r['witness_first_step_logit_gap']:.4g} "
              f"({r['witness_first_step_logit_gap_rel']:.3g} of max)", flush=True)

    quant = quantized_phase(cfg, params, qengs)
    for route, q in quant.items():
        print(f"{route} main path: launches {q['launches']} over {MAX_NEW - 1} decode steps, "
              f"CUDA launches per call {q['cuda_launches_per_call']} (counted); "
              f"{q['tok_per_s']:.1f} tok/s (fp32-value pack {main_['tok_per_s']:.1f}, dense "
              f"{b16['dense_tok_per_s']:.1f}; decode {q['decode_s']:.4f} s, peak memory "
              f"{q['peak_bytes']} bytes); pack bytes per step {q['pack_bytes_per_step']}, byte "
              f"ratio {q['byte_ratio']:.4f}", flush=True)
        for r in (q["fp32"], q["fp32_depth_cut"]):
            witness = (f32 if r["layers"] == cfg.n_layers else res["fp32_depth_cut"])
            print(f"fp32 {r['layers']} layers, {route} packed vs dense on qdq params from one "
                  f"primed cache: token agreement {r['token_agreement']:.4f}, first-step logit "
                  f"gap {r['first_step_logit_gap']:.4g} ({r['first_step_logit_gap_rel']:.3g} of "
                  f"max); witness token agreement {witness['witness_token_agreement']:.4f}",
                  flush=True)

    turns = interleaved_tok_per_s(cfg, engines)
    print("decode tok/s taken in turns (B=4, bf16 activations): " + "; ".join(
        f"{'fp32' if r == 'dense' else r} values {sorted(v)}" for r, v in turns.items()),
        flush=True)

    t0 = time.monotonic()
    paper = paper_phase()
    for name, m in paper.items():
        b5, b6, sim = m["vusa_spmm"], m["dense_matmul"], m["simulator"]
        print(f"paper workloads {name} ({m['gemms']} GEMMs, {m['rate']:.0%} pruned, one image): "
              f"launches {m['launches']}; B5 vusa_spmm {b5['ms']:.4f} ms, B6 dense_matmul "
              f"{b6['ms']:.4f} ms, B5/B6 {b5['ms'] / b6['ms']:.4f}; plain {b5['plain_ms']:.4f} / "
              f"{b6['plain_ms']:.4f} ms, library torch.matmul fp32 {b5['library_ms']:.4f} ms, "
              f"bound {b5['bound_ms']:.4f} / {b6['bound_ms']:.4f} ms by {b5['bound_by']} / "
              f"{b6['bound_by']} (3xTF32; fp32 at 67 TFLOP/s {b5['bound_fp32_ms']:.4f} / "
              f"{b6['bound_fp32_ms']:.4f}); CUDA launches per call "
              f"{b5['cuda_launches_per_call']:.4f} / {b6['cuda_launches_per_call']:.4f}; fp32 "
              f"operations B5 {b5['flops']} B6 {b6['flops']} logical {m['logical_flops']}; "
              f"sum of compression {m['compression_sum']:.4f}, packed / dense bytes "
              f"{m['byte_ratio']:.4f}, mean virtual growth {m['virtual_growth_mean']:.4f}; "
              f"simulator VUSA 3x6 {sim['vusa_3x6']} cycles, standard 3x6 "
              f"{sim['standard_3x6']}, VUSA / standard {sim['ratio']:.4f}",
              flush=True)
        for gname, grp in m["layer_groups"].items():
            print(f"paper workloads {name} {gname} ({grp['gemms']} GEMMs): " + ", ".join(
                f"{key} {grp[key]['ms']:.4f} ms ({grp[key]['logical_tflop_per_s']:.2f} logical "
                "TFLOP/s)" for key in ("vusa_spmm", "dense_matmul", "library")), flush=True)
    print(f"paper workloads phase {time.monotonic() - t0:.1f}s", flush=True)

    t0 = time.monotonic()
    dense_eng = Engine(cfg, params, ServeConfig(max_len=max_len, fused=False), device=DEVICE)
    graph = graph_phase(cfg, {"dense": dense_eng, "fp32": eng, **qengs})
    for route, g in graph.items():
        line = (f"graph decode {route}: graph tokens equal the eager loop's (greedy and "
                f"sampled); tok/s in turns graph {g['tok_per_s']['graph']}, eager "
                f"{g['tok_per_s']['eager']}; ms per step graph "
                f"{min(g['ms_per_step']['graph']):.4f}, eager "
                f"{min(g['ms_per_step']['eager']):.4f} (the better of 2)")
        if "graph_launches" in g:
            line += f"; graph launches {g['graph_launches']} (replays x captured)"
        print(line, flush=True)
        print(trace_line(f"graph decode {route}, {PROFILED_STEPS} replays", g["trace_graph"]),
              flush=True)
        if "graph_structure" in g:
            print(f"graph decode {route}, one step captured in debug mode: "
                  f"{g['graph_structure']}", flush=True)
        if "trace_eager" in g:
            print(trace_line(f"graph decode {route}, {PROFILED_STEPS} eager steps",
                             g["trace_eager"]), flush=True)
    print(f"graph decode phase {time.monotonic() - t0:.1f}s", flush=True)

    t0 = time.monotonic()
    spec = spec_phase(cfg, raw, max_len)
    for route, r in spec.items():
        g = r["greedy"]
        line = (f"speculative {route} (B=1, k={DRAFT_K}, drafter {DRAFT_SPARSITY:.0%} sparse, "
                f"{r['draft_pack_bytes']} pack bytes vs the verifier's {r['verify_pack_bytes']}): "
                f"tokens equal plain graph decode's (greedy and sampled); greedy acceptance "
                f"{g['acceptance_rate']:.4f} over {g['spec_rounds']} rounds "
                f"({g['spec_accepted']}/{g['spec_proposed']}), sampled "
                f"{r['sampled']['acceptance_rate']:.4f}; tok/s in turns speculative "
                f"{r['tok_per_s']['speculative']}, plain {r['tok_per_s']['plain']}; built in "
                f"{r['build_s']:.1f}s")
        if "verify" in r:
            d, v = r["drafter_step"], r["verify"]
            line += (f"; drafter step {d['library_kernel_ms']:.4f} ms in B1-B4 kernels "
                     f"({d['device_sum_ms']:.4f} ms all device), verify of {VERIFY_ROWS} tokens "
                     f"{v['library_kernel_ms']:.4f} ms ({v['device_sum_ms']:.4f} ms)")
        print(line, flush=True)
    print(f"speculative phase {time.monotonic() - t0:.1f}s", flush=True)

    sched = scheduler_phase(cfg, params, {"dense": dense_eng, "fp32": eng, **qengs})
    print(f"scheduler ({SCHED_SLOTS} slots, segments of {SCHED_SEGMENT}, max_len "
          f"{SCHED_MAX_LEN}, {SCHED_REQUESTS} requests): the pool step's rows equal B = 1 steps "
          f"bitwise on every route, slot and paged: {sched['row_stability']}", flush=True)
    for what, st in sched["sequential"].items():
        print(f"scheduler sequential admission {what}: every completion equals one-shot "
              f"generate at B = 1; {st['segments']} segments, "
              f"{st['sustained_tok_per_s']:.1f} sustained tok/s, TTFT p50 "
              f"{st['ttft_p50_s'] * 1e3:.1f} ms p99 {st['ttft_p99_s'] * 1e3:.1f} ms, ITL p50 "
              f"{st['itl_p50_s'] * 1e3:.1f} ms p99 {st['itl_p99_s'] * 1e3:.1f} ms, occupancy "
              f"{st['slot_occupancy']:.4f}" + (f", graph launches {st['graph_launches']}"
                                               if "graph_launches" in st else ""), flush=True)
    for route, r in sched["paged_vs_slot"].items():
        print(f"scheduler paged (no prefix cache, no chunks, worst-case arena) {route}: tokens "
              f"equal the slot pool's under batched admission, all arrivals at 0 (slot "
              f"{r['slot']['sustained_tok_per_s']:.1f} / paged "
              f"{r['paged']['sustained_tok_per_s']:.1f} sustained tok/s)", flush=True)
    for g in sched["prime_many_vs_prime"]:
        print(f"scheduler prime_many vs prime, fp32, {g['layers']} layers: gap "
              f"{g['max_abs_gap']:.4g} ({g['gap_rel']:.3g} of the largest logit), bitwise "
              f"{g['bitwise']}; witness, the same prompt twice in a batch of 2 without padding: "
              f"{g['witness_b2_gap_rel']:.3g} of the largest logit", flush=True)
    tr = sched["traffic"]
    for what in ("slot_batched", "paged"):
        st = tr[what]
        print(f"scheduler traffic fp32 {what}: {st['sustained_tok_per_s']:.1f} sustained tok/s "
              f"({st['decoded_tokens']} tokens, decode {st['decode_s']:.3f} s, admission "
              f"{st['admit_s']:.3f} s), TTFT p50 {st['ttft_p50_s'] * 1e3:.1f} ms p99 "
              f"{st['ttft_p99_s'] * 1e3:.1f} ms, ITL p50 {st['itl_p50_s'] * 1e3:.1f} ms p99 "
              f"{st['itl_p99_s'] * 1e3:.1f} ms, occupancy {st['slot_occupancy']:.4f}, HBM bytes "
              f"per active request {st['hbm_bytes_per_active_request']:.0f} (pool "
              f"{st['kv_pool_bytes']:.0f}), prefix hit rate {st['prefix_hit_rate']:.4f}, hits "
              f"{st['prefix_hits']:.0f}, COW {st['cow_copies']:.0f}, chunks "
              f"{st['prefill_chunks']}, preempted {st['preempted']}", flush=True)
    print(f"scheduler traffic: paged (prefix cache, pages of {SCHED_PAGE}, chunks of "
          f"{SCHED_CHUNK}, arena of {tr['arena_blocks']} blocks) all OK, host mirrors equal the "
          f"device's at {tr['mirror_checks']} syncs; token agreement with the slot pool "
          f"{tr['token_agreement']:.4f}", flush=True)
    for route, t in sched["ms_per_step"].items():
        print(f"scheduler ms per step {route} (in turns): pool step at {SCHED_SLOTS} rows "
              f"{t['pool']}, one-shot generate at B = {SCHED_SLOTS} {t['generate_b8']}",
              flush=True)
    print(f"scheduler memory: noise table {sched['noise_table_bytes']} bytes, slot pool KV "
          f"{sched['paged_vs_slot']['fp32']['slot']['kv_pool_bytes']:.0f} bytes; phase "
          f"{sched['seconds']:.1f}s ({card})", flush=True)

    t0 = time.monotonic()
    sspec = spec_sched_phase(cfg, raw)
    for what, r in sspec["runs"].items():
        sp, pl = r["speculative"], r["plain"]
        print(f"speculative scheduler {what}: every completion equals the plain scheduler's "
              f"(and paged the slot pool's); acceptance {sp['acceptance_rate']:.4f} "
              f"({sp['spec_accepted']}/{sp['spec_proposed']}) over {sp['rounds']} rounds; "
              f"sustained tok/s {sp['sustained_tok_per_s']:.1f} (plain {pl['sustained_tok_per_s']:.1f}"
              f"), decode {sp['decode_s']:.3f} s (plain {pl['decode_s']:.3f}), TTFT p50 "
              f"{sp['ttft_p50_s'] * 1e3:.1f} ms (plain {pl['ttft_p50_s'] * 1e3:.1f}), ITL p50 "
              f"{sp['itl_p50_s'] * 1e3:.1f} ms p99 {sp['itl_p99_s'] * 1e3:.1f} (plain "
              f"{pl['itl_p50_s'] * 1e3:.1f} / {pl['itl_p99_s'] * 1e3:.1f}); graph launches "
              f"{sspec['graph_launches'][what]}", flush=True)
    for route, t in sspec["ms_per_round"].items():
        print(f"speculative scheduler ms per pool round {route}: slot {t['slot']:.4f}, paged "
              f"{t['paged']:.4f} (a plain pool step {t['plain_pool_step']:.4f}) at "
              f"{SCHED_SLOTS} slots, a verify of {POOL_VERIFY_ROWS} rows", flush=True)
    print(f"speculative scheduler phase {time.monotonic() - t0:.1f}s ({SPEC_SCHED_LAYERS} of "
          f"{cfg.n_layers} layers) ({card})", flush=True)

    fails = failure_phase(cfg, params, raw)
    for what, r in fails.items():
        if what != "seconds":
            print(f"failure model {what}: {r}", flush=True)
    print(f"failure model phase {fails['seconds']:.1f}s: value NaNs quarantined with dense "
          f"fallback, cache poison retried (slot, paged), persistent poison FAILED, "
          f"speculative quarantine dense, journal recovery, watchdog re-queue and hot swap "
          f"bitwise ({card})", flush=True)

    rand = {"fp32_token_agreement": res["fp32"]["token_agreement"],
            "spec_acceptance_fp32_greedy": spec["fp32"]["greedy"]["acceptance_rate"],
            "prime_many_vs_prime": [g for g in sched["prime_many_vs_prime"]
                                    if g["layers"] in (DEPTH_CUT, cfg.n_layers)]}
    train = train_phase(cfg, rand)
    print_train(cfg, train, card)

    fam = families_phase()
    print_families(fam, card)

    rec = recurrent_phase()
    print_recurrent(rec, card)

    left = leftovers_phase(raw, params, cfg)
    print_leftovers(left, card)

    mesh, tpp = world_phases()
    print_mesh(mesh, card)
    print_tp(tpp, card)

    replaces = {"vusa_packed_matmul": "src/repro/kernels/vusa_packed.py:129",
                "vusa_fused_mlp_matmul": "src/repro/kernels/vusa_packed.py:256",
                "vusa_packed_matmul_quantized": "src/repro/kernels/vusa_packed.py:142",
                "vusa_fused_mlp_matmul_quantized": "src/repro/kernels/vusa_packed.py:294"}
    launches = {"dense": res["launches"], **{r: q["launches"] for r, q in quant.items()}}
    cuda_per_call = {"dense": res["cuda_launches_per_call"],
                     **{r: q["cuda_launches_per_call"] for r, q in quant.items()}}

    def entry(name, route):
        wrapper = name.removesuffix("_quantized")
        st = step[route][name]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/vusa_packed.cu",
                "replaces": replaces[name], "launches": launches[route][wrapper],
                "launches_per_step": launches[route][wrapper] / (MAX_NEW - 1),
                "graph_launches": graph["fp32" if route == "dense" else route][
                    "graph_launches"][wrapper],
                "spec_pool_graph_launches": sum(
                    c[wrapper].get(route, 0) for c in sspec["graph_launches"].values()),
                "cuda_launches_per_call": cuda_per_call[route][wrapper],
                "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
                "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
                "library_ms": st["library_ms"]}

    def families(name, route):
        """The record's kernel per decode step of phase 13's dense configs
        on ``route`` (``bf16`` = fp32 values), with the counted launches
        where the phase served that route."""
        wrapper = name.removesuffix("_quantized")
        out = {}
        for arch in ("qwen2_0_5b", "qwen3_8b"):
            r = fam[arch]
            out[arch] = {"layers": r["layers"], **r["step"][route][wrapper]}
            if route in r["routes"]:
                out[arch]["launches"] = r["routes"][route]["launches"][wrapper]
        return out

    kernels = [entry("vusa_packed_matmul", "dense"), entry("vusa_fused_mlp_matmul", "dense")]
    for k in kernels:
        k["families"] = families(k["name"], "bf16")
    for name in ("vusa_packed_matmul_quantized", "vusa_fused_mlp_matmul_quantized"):
        k = entry(name, "int8")
        k["value_dtype"] = "int8"
        k["families"] = families(name, "int8")
        k["int4"] = {key: v for key, v in entry(name, "int4").items()
                     if key not in ("name", "route", "source", "replaces")}
        k["int4"]["families"] = families(name, "int4")
        kernels.append(k)
    def mesh_launches(name, route):
        """Phase 17's launches a decode step on each rank of the
        tensor-parallel meshes (full depth, greedy): B1/B3 per sharded call,
        B2/B4 as the window-partial kernel and the ordered sum."""
        kind, out = ROUTE_KIND[route], {}
        for m in ("1x2", "1x4", "2x2"):
            c = tpp["edge"][f"{m} {cfg.n_layers} layers {route}"]["launches"]
            wrappers = (("vusa_packed_matmul",) if name.startswith("vusa_packed_matmul")
                        else ("vusa_fused_mlp_partials", "vusa_window_sum"))
            out[m] = {w: c[w]["dense" if w == "vusa_window_sum" else kind] / (TP_NEW - 1)
                      for w in wrappers}
        return out

    for k, route in zip(kernels, ("bf16", "bf16", "int8", "int8")):
        k["mesh_launches_per_step_per_rank"] = mesh_launches(k["name"], route)
    keys = ("launches", "cuda_launches_per_call", "max_abs_err", "max_abs_err_bf16", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, replaced in (("vusa_spmm", "src/repro/kernels/vusa_spmm.py:34"),
                           ("dense_matmul", "src/repro/kernels/dense_matmul.py:21")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": replaced,
                        **{k: paper["resnet18"][name][k] for k in keys},
                        "mobilenetv1": {k: paper["mobilenetv1"][name][k] for k in keys}})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "timer_spin_cycles": SPIN_CYCLES, "launch_floor_ms": floor_ms,
         "kernels": kernels,
         "kernels_note": "ms, plain_ms, library_ms and "
         "bound_ms summed over one decode step (48 projections + head; 12 MLPs) at B=4, bf16 "
         "activations; B1/B2 with fp32 values, B3/B4 int8 at top level and int4 under 'int4'; "
         "B1-B4's cuda_launches_per_call counted by the vusa_packed library over the counted "
         "main-path run, per wrapper call; B1-B4's graph_launches the launches of phase 7's "
         "greedy graph run: replays x the launches captured in one step; "
         "spec_pool_graph_launches the launches of phase 10's speculative pool graphs on the "
         "record's value route (replays x captured, summed over its runs; the drafter's and "
         "fp32 verifiers' on the float route, int8 verifiers' on int8; int4 is not a verifier "
         "route there); "
         "vusa_spmm/dense_matmul summed over the 21 GEMMs of one ResNet-18 image (MobileNetV1's "
         "28 under 'mobilenetv1'), their cuda_launches_per_call the mean over those GEMMs of the "
         "CUDA launches each library counted in the counted run (2 where the plan splits the "
         "reduction), their bound_ms with TF32 tensor-core operations over 495 TFLOP/s, three "
         "per logical fp32 product (3xTF32); B1-B4's 'families' per decode step of phase 13's "
         "qwen2_0_5b (24 layers) and qwen3_8b (2 layers) from layer 0's timed packs x layers "
         "(+ qwen3's head on the fp32 route), launches from the phase's counted runs; "
         "B1-B4's mesh_launches_per_step_per_rank the launches a decode step on each rank of "
         "phase 17's 1x2, 1x4 and 2x2 meshes at 12 layers (B2/B4 as the window-partial kernel "
         "and the ordered sum of the gathered partials)",
         "records": records, "model": res, "quantized": quant, "tok_per_s_in_turns": turns,
         "paper_workloads": paper, "graph_decode": graph, "speculative": spec,
         "scheduler": sched, "speculative_scheduler": sspec, "failure_model": fails,
         "train": train, "families": fam, "recurrent_families": rec, "mesh": mesh,
         "tensor_parallel": tpp, "leftovers": left,
         "pack_bytes_per_step": sizes, "byte_ratios": ratios,
         "seconds": time.monotonic() - t_start}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port.")
    ap.add_argument("--spin-cycles", type=int, default=SPIN_CYCLES,
                    help="the kernel timer's device spin before each timed call, in cycles")
    SPIN_CYCLES = ap.parse_args().spin_cycles
    main()
