#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds, serves and trains on the
card.

    python3 chip_smoke.py
    python3 chip_smoke.py --mpmd-only    # phases 15 (three runs) and 16
    python3 chip_smoke.py --dp-only      # phases 19, 28, 29 and 30 alone
    python3 chip_smoke.py --tensor-only  # phases 29 and 30 alone

Run from the root of the repository on a machine with one NVIDIA card
(an H100 is what the numbers are for).  It imports nothing of JAX or of
the JAX package, and in phases:

  1. prints the card (nvidia-smi's name and power limit, torch's name
     and device count);
  2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/
     csrc`` (one nvcc per source, all seven at once), with ptxas's
     registers and shared memory, and for the three bf16 tensor-core
     kernels (``flash_fwd_mma_kernel``, ``flash_bwd_dq_mma_kernel``,
     ``flash_bwd_dkv_mma_kernel``), the scans' decode, scores and
     chunked kernels and the scans' backward (stepwise and chunked)
     their registers, spills and static and dynamic shared memory;
  3. holds each kernel against its plain PyTorch version on the card
     (TF32 off for the plain versions): the flash forward at the serving
     paths' decode and prefill shapes (granite-8b's attention, head_dim
     128, and zamba2-1.2b's shared block, head_dim 64), the training
     shapes (the tick's batch of 8 rows, an IR round's microbatch of
     one row), the repository's kernel test cases in fp32 and in bf16, a
     long causal case and the packed-row edges of the bf16 kernel (G in
     {1, 2, 4, 8} with sq G off the 16- and 64-row blocks, kv_len off
     the 64-key tile, q_offset > 0 causal and not, head_dim 16 to 128,
     sq != sk) (2e-5 in fp32 on the FMA kernel, 2e-2 in bf16 on the
     tensor-core kernel, each launch counted by its variant); the paged
     rows of both forward kernels (the decode wave: R in {1, 3, 8} rows
     at lengths 1, 17 and 64, two rows on one trash page, d 128 and 64,
     fp32 and bf16, one launch a call); the flash
     backward (dq, dk/dv) at the training shapes, the repository's
     backward test case, a non-causal GQA case with masked keys, the
     same packed-row edges and the dk/dv kernel's own edges in bf16
     (atol 2e-5 / rtol 1e-3 in fp32, 2e-2 in bf16, both kernels on the
     tensor cores in bf16; dk and dv exactly zero past kv_len, and a
     rerun into NaN-filled outputs repeating the first bit for bit); the
     fused update on a ragged group of tensors, with and without the
     prediction and with bf16 gradients (1e-6 in fp32, 2e-2 in bf16),
     and (in phase 8) on the training path's two groups, a full-width
     stage and the outer tree; the two scans (``rwkv6_scan``,
     ``mamba2_scan``) in fp32 and bf16 at decode (s = 1, nonzero S0; the
     decode kernels), prefill (s = 12) and ragged (s = 37) (the stepwise
     kernels), s = 2048, 64, 65 and 200 with b 2 and exact-zero decays
     (the chunked kernels), mamba2 with g > 1, and rwkv6's decode wave
     (b 8, fp32 and bf16, S0 gathered from nonzero page states with two
     rows on one trash page, S_T scattered back), with the decays the
     models draw (down to ~1e-29 and ~1e-5): y and S_T (2e-5 in fp32;
     2e-2 on rwkv6's bf16 y), each call checked to launch the variant its
     length routes it to, and each also with S_T written over S0 in
     place, as the models call them;
  4. holds the port's models on the card against the same models on the
     CPU at the smoke size in fp32: granite serving (prefill, decode,
     engine tokens), rwkv6 and zamba2 serving (prefill and decode
     steps: logits and every state and KV leaf, 1e-4), and 2(S-1)+3
     streaming SpecTrain ticks on 4 stages (losses and every parameter,
     momentum and prediction leaf), and the pipelined ``ServeEngine``
     (granite and rwkv6, pipe 2: equal tokens, a clean request trace,
     one kernel a layer for each wave and prefill lane), each on the
     fp32 FMA attention kernels only (no tensor-core launch);
  5. drives the serving path, ``repro_torch.launch.serve.main``, on the
     full-width, full-depth rwkv6-7b (32 layers), zamba2-1.2b (38
     layers) and granite-8b (36 layers) in bf16 with random weights, one
     model at a time, and checks every admissible request got its
     tokens, the logits were finite and each kernel ran exactly as often
     as the path needs: per prefill and decode call 32 ``rwkv6_scan``;
     38 ``mamba2_scan`` and 2 ``flash_fwd`` (zamba2's shared attention);
     36 ``flash_fwd``; and nothing else; every ``flash_fwd`` on the
     bf16 tensor-core kernel, every decode step's scan on the decode
     kernel, no scan on the chunked kernels;
  6. profiles a few full-width decode steps of each of the three models
     (wall per step, device busy share, device time per kernel);
  7. drives the training path, ``repro_torch.launch.train.main``, on
     full-width granite-8b cut to 8 layers in 4 stages, bf16 compute,
     SpecTrain, 10 ticks; checks the losses are finite, the loss turns
     valid at tick S-1, stage 0's weights hold until tick 2(S-1) and
     move after it, and each tick launches exactly 2L flash forwards, L
     of each backward kernel and S+1 fused updates, every forward, dq
     and dk/dv on the tensor-core kernels; profiles one tick and checks the
     profile shows the same kernels;
  8. times every kernel at its main path's shapes beside its bound, its
     plain version and a library yardstick the port never calls
     (``scaled_dot_product_attention`` forward and backward, with the
     device kernels its backend ran; ``torch.optim.SGD(fused=True)``;
     none computes either recurrence): the flash forward at decode and
     prefill n = 12 of both serving models, causal 2048 and the training
     shape, the backward kernels at the training shape, the scans at
     decode (beside a copy of the same 1 MB state), prefill and s = 2048,
     each variant its own row, and the decode wave's paged call (R 8,
     ragged lengths) beside SDPA with a boolean key mask;
  9. (run after phase 6) drives ``repro_torch.launch.serve.main`` on
     full rwkv6-7b and zamba2-1.2b with long prompts (3 requests,
     1024-2048 tokens, generation 1-4): every request served with finite
     logits, every prefill's scans on the chunked kernels (32 or 38 per
     call) and every decode step's on the decode kernels, each request's
     time to first token, and one prefill of the longest prompt timed
     and profiled (wall, device busy, the scans' share).

The paper's evaluation adds three phases:

 10. (after phase 4) the simulator (``repro_torch.core.simulator``) on
     the card against the CPU, 10 steps of each of the four schemes for
     ``make_mlp_staged`` (4 stages, Fig. 8's RMSEs on) and for
     ``staged_from_model`` (the 4-layer smoke granite on 2 stages, fp32
     flash kernels): every metric and the final parameters within the
     CPU parity tests' rtol 1e-5 / atol 1e-6, N + 1 ``fused_update``
     launches a step; and checkpoint and exact resume through
     ``repro_torch.launch.train.main`` (4 layers, pipe 2, spectrain and
     pipedream): 6 ticks against 3, ``--resume auto`` and 3 more, the
     final checkpoints bit-equal;
 11. (after phase 7) the four schemes on the full-width, full-depth
     snn-paper (32 FC layers of 2048, input 3072, 10 classes, 4 stages,
     140,597,258 parameters, 8 versions held), batch 128 of the
     synthetic teacher task, 600 steps each at lr 0.01, then spectrain's
     first 150 steps again with Fig. 8's RMSEs at s = 1, 2, 3 (the
     same losses, step for step): ms per step (the median
     of the steady steps), device busy and idle share under
     ``torch.profiler``, final loss, held-out loss and accuracy, peak
     memory, exactly 5 ``fused_update`` launches a step (and nothing
     else), finite and falling losses, each scheme past the label
     prior (final loss below its entropy, held-out accuracy above the
     majority share), RMSE(pred) < RMSE(stale) at every s; the Table 1
     ordering printed against the JAX test's bounds; the kernel held
     against its plain version at the simulator's two groups (a stage
     tree, the outer tree) with the simulator's arguments, then timed
     beside ``torch.optim.SGD(fused=True)``;
 12. ``repro_torch.bench.rmse`` and ``.convergence`` on the card at
     their default (the JAX scripts') sizes.

The pipelined engine adds one phase:

 13. (after phase 6) ``repro_torch.launch.serve.main --engine
     pipelined`` on full-width granite-8b and rwkv6-7b at half depth
     (18 and 16 layers, ``PIPE_DEPTH``; pipe 4, 8 slots and pages, 2
     prefill lanes, bf16) over one Poisson
     trace of 24 requests (rate 2.0, prompts 2-12, generation 8-24),
     then ``SimpleEngine`` with the same weights on the same trace:
     every admissible request gets its tokens, live rows' logits
     finite, the request trace verifies, each request's first token
     equals ``SimpleEngine``'s, every round launches exactly L
     ``flash_fwd`` or ``rwkv6_scan`` for its wave and L a prefill lane
     (bf16 attention on the tensor cores, the wave's scans on the decode
     kernel); one full-width wave (8 live rows) against SimpleEngine's
     decode step taken row by row from the same page states, logits and
     each row's state after it, within ``WAVE_STEP_FACTOR`` times the
     steps' own distance from the same steps in fp32, and the engine's
     round from those states emitting the wave's argmax and leaving its
     pages; tok/s over ``run()``'s wall after warm-up for both engines
     (a second pipelined run of the trace, its tokens equal to the
     first's), p50/p99 and rounds beside ``SimpleEngine``'s, one steady
     decode round profiled (wall, busy, idle, kernels), the page writes
     and the rwkv6 state gather/scatter timed alone, peak memory.

The planner and the round schedules add two phases:

 14. (after phase 4) three IR rounds of gpipe, 1f1b, 2bw (spectrain,
     pipedream) and interleaved v2 through ``make_ir_state`` /
     ``make_ir_train_step`` on the card against the CPU (2 stages of a
     5-layer smoke granite in fp32, a ragged dp split): losses to rtol
     1e-5, every params, momentum and 2bw stash leaf to rtol 1e-4 / atol
     1e-5, on the fp32 FMA kernels only;
 15. (``ir_schedules``, after phase 7) ``fused_update`` at the IR
     update's full-width groups (a chunk tree of 1 and 2 layers, the
     outer tree; fp32 g, no ŵ), one launch each against its plain
     version; then ``repro_torch.launch.train.main`` on full-width
     granite-8b, 4 stages, batch 8 x 512, bf16, under gpipe, 1f1b, 2bw
     (spectrain, pipedream), interleaved (``--virtual-stages 2``, 8
     chunks of one layer) and 1f1b on 7 layers (the dp plan's (2, 2, 1,
     2), regrouped from the model's uniform (2, 2, 2, 1)), 4 rounds
     each: the dp plan printed and verified before the first round,
     finite losses,
     exactly 2·L·M ``flash_fwd``, L·M of each backward kernel and C + 1
     ``fused_update`` launches a round (M = 8 microbatches, C chunks),
     every attention launch on the tensor cores; a round's wall (median
     of the unprofiled steady rounds), tokens/s, one profiled round
     (busy, idle, kernels, ``fused_update`` ms), peak memory, and for
     2bw the stash copy's ms (CUDA events).

Stage-local (MPMD) execution adds two phases, each run through the
launchers with one process per stage (``launch/mesh.py``), the 4 ranks
sharing the one card over gloo through pinned host buffers:

 16. (``mpmd_train``, after phase 15, the SPMD states freed first)
     ``repro_torch.launch.train.main --execution mpmd``'s rank loop on
     the same full-width granite-8b, 8 layers, 4 stages, batch 8 x 512,
     bf16, dp plan, from the same seed, under 1f1b, 2bw and interleaved
     v2 (spectrain), 4 rounds each, all in one spawn of the four ranks
     (and phase 18's traced run after them): the losses and an exact
     digest of
     every params, momentum and 2bw stash leaf (integer reductions of
     its bits, taken on the card in each rank) against phase 15's SPMD
     rounds (the leaves bit-equal counted; a leaf that is not is named
     and held to rtol 1e-4 / atol 1e-5 on a strided sample); each
     rank's launches a round exactly its chunks' share, summing to the
     SPMD round's (2·L·M ``flash_fwd``, L·M of each backward kernel)
     and C + 2 ``fused_update`` (the outer leaves live on ranks 0 and
     3); each rank's payloads a round equal to the device streams'
     prediction in count and bytes; the round wall (median of the
     unprofiled steady rounds on rank 0, after a barrier), each rank's
     device busy time and kernels in one profiled round, its peak memory
     and its time in the transport;
 17. (``mpmd_serve``, after phase 13) ``repro_torch.launch.serve.main
     --execution mpmd`` on granite-8b and rwkv6-7b with phase 13's
     depth, flags and trace: every request's tokens against the scan backend's
     from phase 13 (the first difference printed if any), the ranks'
     launches summing to phase 13's run without its warm-up round,
     tok/s over ``run()`` after warm-up and a steady round's wall.

The pipeline tracer (``repro_torch.obs``) adds one phase:

 18. (``trace``, after phase 16) ``repro_torch.launch.train.main
     --trace`` on the round-schedule configuration of phase 15 (same
     seed), 1f1b (scan backend) and interleaved v2, each run untraced
     and then traced for 4 rounds: losses and the digest of every leaf
     bit-equal between the two, the launches a round unchanged; every
     round filed with 2·C·M marks (64 / 128, CUDA events) and none
     dropped (the launcher's ``# trace rounds`` line); the written trace
     valid, with 2·2·C·M span events in 4 device lanes and every
     measured span positive; the events' mean sum a round between phase
     15's profiled busy less its ``fused_update`` time and the traced
     round's mean wall; the drift report printed; the traced and
     untraced round walls (median of rounds 1-3) printed, not gated,
     and the overhead measured apart: 10 pairs of an untraced and a
     traced 1f1b round on one state, alternating which runs first.
     Then ``--execution mpmd --trace`` under 1f1b (4 ranks on the
     card, run in phase 16's spawn of the ranks, after its three runs):
     every rank's leaves and the losses bit-equal to phase 16's
     untraced run, launches and payloads a round unchanged and no
     control message, one measured lane per rank with every event, the
     trace valid (also through ``python -m repro_torch.obs.perfetto``).
     Then the stream tick traced (``probe_stage_costs`` on the card:
     positive stage costs; the attributed spans valid), and
     ``python -m repro_torch.bench.trace_overhead``'s rows on the card.

The data-parallel baseline (the data axis as all-reducing replicas)
adds one phase:

 19. (``dp_train``, after phase 18, the SPMD and MPMD states freed)
     first ``fused_update`` with no ŵ at the data-parallel update's
     group (the outer tree and 8 full-width layers, 2,147,553,280
     elements) and at a stage tree, each against its plain version and
     timed beside ``torch.optim.SGD(fused=True, momentum=γ,
     dampening=γ)``, the same function after its first step; then
     ``repro_torch.launch.train.main --mode sync --pipe 1`` on full-width
     granite-8b, 2 layers, batch 8 x 512, bf16, seed 0, uniform data, 3
     steps: once in this process (``--data 1``, the reference), then
     with ``--data 2`` (2 replicas sharing the card over gloo through
     pinned host buffers; NCCL with a card each) and, on a machine of 4
     cards, ``--data 4`` (on fewer cards its memory is reckoned from the
     measured peak and printed, not run), both with ZeRO-1 momentum:
     a reduce-scatter and an all-gather a step, their calls and bytes
     exact, each replica holding its pieces' bytes of momentum; every
     replica's params bit-equal to replica 0's and the replicas'
     momentum pieces, their digests combined, the whole leaves', after
     every step (exact digests);
     the replicas bit-equal to ``SyncPodDP`` run in this process on the
     same row blocks (the same GEMM shapes; at N > 2 the ring sums in
     another order, so within rtol 1e-4 / atol 1e-5 there); against the
     one process on the whole batch, the mean losses and a strided
     sample of every params leaf within rtol 1e-4 / atol 1e-5, and of
     every momentum leaf within 2e-2 of the leaf's scale (the bf16
     GEMMs round otherwise at 4,096 rows than at 2,048, and momentum
     holds the gradients; the excess over rtol 1e-4 printed); each
     replica's launches a
     step exactly L ``flash_fwd`` (tensor cores), L dq, L dk/dv and one
     ``fused_update``, and its all-reduce a step exactly 4 B x the
     parameter count in ``ceil(bytes / BUCKET_BYTES)`` calls; the step
     wall (replica 0, median of the unprofiled steady steps) and
     tokens/s, each replica's busy time in one profiled step, the
     all-reduce's host time and the peaks, beside phase 16's MPMD 1f1b
     round and the P40 timeline model's Data-P / Model-P ratio
     (``bench/_timeline.py``, the paper's platform, labelled so).  Then
     ``SyncPodDP`` and ``AsyncPodDP`` (predict on, off) on full-width
     granite-8b at 2 layers, 2 pods, ``model.loss``, 3 steps: finite
     losses and exact launches; and the tests' toy problem card against
     CPU within 1e-5.  ``--dp-only`` runs this phase alone (on four
     cards: ``--data 2`` and ``--data 4`` over NCCL, the
     interconnect printed by ``nvidia-smi topo -m``).

The MoE and dense code models (deepseek-moe-16b, grok-1-314b;
granite-20b, 48 heads over one KV head, G 48; starcoder2-15b, G 12) add
four phases:

 20. (in phase 3) the flash forward, dq and dk/dv and the paged wave at
     G 12 and 48, head_dim 128, fp32 (2e-5) and bf16 (2e-2, tensor
     cores): decode ``[1, 1, 48, 128]`` over 64 keys, prefill n = 12,
     the tick's ``[8, 512, 48, 128]`` against k/v with 1 and 4 KV heads,
     an IR microbatch of one row, the waves (R 8, ragged), and the
     packed-row edges (``WIDE_EDGES``); bf16 dk and dv at G 48 held
     normwise (``compare_bwd``); and in phase 8 the forward and both
     backward kernels timed at these shapes beside SDPA and the bound;
 21. (after phase 4's training check) the four archs on the card
     against the CPU at the smoke size in fp32 (the code models at
     their 48 heads): prefill and decode logits and cache (1e-4),
     SimpleEngine's tokens equal; for the MoE models 2(S-1)+3 SpecTrain
     ticks on 4 stages, losses and aux losses (rel 1e-5) and every
     params, momentum and prediction leaf (rtol 1e-4 / atol 1e-5);
 22. (after phase 17) ``repro_torch.launch.serve.main`` in bf16 from
     seed 0: deepseek-moe-16b (28 layers) and granite-20b (52) through
     SimpleEngine and the pipelined engine (pipe 4), starcoder2-15b
     (40) through SimpleEngine, grok-1-314b at 4 of its 64 layers
     through SimpleEngine with every logit inside its softcap (30):
     each checked as phases 5 and 13 check theirs (every request's
     tokens, finite logits, one tensor-core ``flash_fwd`` a layer a
     call or a wave or lane, nothing else); deepseek's and granite-20b's
     decode steps profiled as in phase 6;
 23. (after phase 7) ``repro_torch.launch.train.main`` on full-width
     deepseek-moe-16b (2,770,880,512 parameters) and granite-20b
     (2,120,331,264) at 4 layers in 4 stages, phase 7's flags: every
     tick exactly 2L ``flash_fwd``, L dq, L dk/dv, S+1 ``fused_update``,
     finite losses and (MoE) aux losses, each stage's router momentum
     zero before its first valid backward and non-zero at the end; the
     tick's wall, busy, tokens/s and peak; then one full-width
     deepseek MoE layer at the tick's shape timed step by step
     (routing, dispatch, expert GEMMs, gather, shared experts) and
     whole (forward, forward + backward).

Multi-head latent attention (minicpm3-4b: 40 heads at G = 1, q.k width
64 + 32, v width 64, tied embeddings) adds one phase:

 24. (after phase 3's backward checks) the forward, the paged wave, dq
     and dk/dv at the width pair (96, 64) against their plain versions
     (2e-5 fp32 on the FMA kernels, 2e-2 bf16 on the tensor cores):
     decode ``[1, 1, 40, 96|64]`` over 64 keys, prefill n = 12, the
     wave (R 8, ragged, identity pages), the tick's ``[8, 512, 40,
     96|64]`` and bf16 edges; every wrapper raising ``ValueError`` on
     a pair with no kernel, launching nothing; (after phase 22)
     ``repro_torch.launch.serve.main`` on minicpm3-4b (bf16) through
     SimpleEngine at full depth (62 layers), the pipelined engine and
     ``--execution mpmd`` at 16, checked as phases 5,
     13 and 17 check theirs
     (exact launches, MPMD tokens equal to the scan backend's), one
     decode step profiled; (after phase 23) ``launch.train.main`` on 8
     of its 62 layers in 4 stages (689,377,280 parameters), phase 7's
     checks; and (in phase 8) the four kernels timed at these shapes
     beside their bounds, plain versions and SDPA.

The encoder-decoder models (whisper-base, 1500 audio frames; the
paper's transformer-paper, 20 source tokens; 6 + 6 layers, d 512, 8
heads of 64) and the vision frontend (pixtral-12b: 40 layers, d 5120,
32 heads over 8 of 128, 256 patches) add one phase:

 25. (after phase 24's kernel checks) the forward, dq and dk/dv against
     their plain versions (2e-5 fp32 on the FMA kernels, 2e-2 bf16 on
     the tensor cores) at whisper's causal encoder (``[2, 1500, 8,
     64]``, a ragged last key tile), its cross-attention (448 text
     positions against 1500 frames, no mask), its decode step's cross
     call (one query against 1500), transformer-paper's (64 against
     20) and pixtral's prefill of 256 patches and 8 tokens; (after
     phase 21) both enc-dec models at full width in fp32: ``encode``,
     ``encdec_prefill_cache`` and 32 decode steps held to ``forward``'s
     logits (2e-3, JAX's test), one ``loss`` -> backward -> SGD step on
     the card against the CPU at b = 2 with exact launches; (after
     phase 24's serving) ``repro_torch.launch.serve.main`` on whisper-
     base (SimpleEngine, 24 requests, one decode step profiled) and on
     full pixtral-12b through SimpleEngine (a decode step profiled) and
     the pipelined engine, checked as phases 5 and 13 check theirs;
     (after phase 24's training) pixtral's forward with 256 patches at
     2 of its layers, card against CPU in fp32, and
     ``launch.train.main`` on 4 of its 40 layers in 4 stages, phase 7's
     checks; and (in phase 8) the forward at these shapes and dq and
     dk/dv at whisper's cross and encoder shapes timed beside their
     bounds, plain versions and SDPA.

Training the SSM families (rwkv6-7b; zamba2-1.2b, Mamba-2 with a tied
shared attention block a stage) adds one phase, with the scans'
backward kernels (``csrc/rwkv6_scan_bwd.cu``, ``csrc/mamba2_scan_bwd.cu``:
the stepwise kernels at s < 64, the chunked tensor-core ones at s >= 64):

 26. (after phase 3's scan checks) each backward against its plain
     version (the backward formulas) and against autograd of the plain
     forward, every output elementwise within 1e-5 (fp32 inputs) or
     2e-2 (bf16) of its largest magnitude, at full width (rwkv6-7b's 64
     heads of 64; zamba2's 64 heads, p 64, n 64, one B/C group) at the
     training tick's ``[8, 512]``, the rounds' ``[1, 512]``, s = 64, 100
     (a partial last chunk) and 2048 on the chunked kernels and s = 1,
     12, 63 on the stepwise ones, fp32 and bf16, the other head sizes
     and mamba2 with g > 1 on both, decays from exact 0 to 1, nonzero S0
     and dS_T; every call twice, bit-equal, on its variant (counted);
     every call again through ``ops`` under autograd, the kernel's
     gradient bit for bit; (after phase 4's training check) the
     smoke-size stream tick
     (2(S-1)+3 ticks) and a 1f1b round of both families, card against
     CPU in fp32 (``ssm_train_check``: rwkv6 held tick by tick and to
     its own sensitivity, zamba2's stages each firing the shared block);
     (after phase 25's training) ``launch.train.main`` on rwkv6-7b at 8
     of 32 layers in 4 stages and zamba2-1.2b at all 38 in 2 (each
     stage's shared block fires once), bf16, 8 x 512, 10 spectrain
     ticks: finite losses valid from tick S-1, exact launches a tick (2L
     scans, all chunked, L backward, all chunked, S+1 updates; zamba2's
     4 flash forwards and 2 of each backward kernel, all tensor-core),
     one tick profiled (each backward's three kernels counted and
     timed), wall, busy, tokens/s and peak; rwkv6-7b on 1f1b, 4 rounds
     of 8 microbatches (128 scans, 64 backward, 5 updates a round); and
     (in phase 8) both backward timed at the tick's ``[8, 512]`` and the
     rounds' ``[1, 512]`` beside their bounds and plain versions (no
     PyTorch call computes either).

Cost accounting (the dry-run and its op counter) adds one phase:

 27. (``cost_accounting``, after phase 7) for the three training
     configurations above (full-width granite-8b at 8 layers in 4
     stages, rwkv6-7b at 8 in 4, zamba2-1.2b at 38 in 2; bf16, 8 x 512,
     spectrain, one tick a step) the dry-run's ``build_cell`` on the
     meta device, then the same tick built on the card by
     ``dryrun.make_train_step`` from a random init, a tick of warm-up
     and one tick under ``runtime.op_cost.CostCounter``: each kernel's
     counted calls equal to the launch counters of that tick and to the
     meta count; the FLOPs, bytes and transcendentals of the two counts
     within 1e-3 of each other, every op that differs named; the counted
     arguments + temporaries within 15% of ``max_memory_allocated``
     (after ``reset_peak_memory_stats``); ``model_flops`` (6 N T), the
     counted FLOPs, ``useful_flops_ratio``, the wall of 3 uncounted ticks
     (CUDA events) and MFU (``model_flops`` over wall x 989 TFLOP/s),
     beside the card's name and power limit.  Then the library modules on
     the card: ``optim.adam`` (an update with weight decay, and predict)
     on a full-width granite-8b stage tree, against the CPU within 1e-6
     on the first 2^20 elements of every leaf;
     ``optim.compression``'s ``topk_compress`` (3 steps of error
     feedback: the kept magnitudes, sent + residual and the stats bit for
     bit, kept positions apart only at ties with the k-th magnitude) and
     ``int8_round`` (from given draws, bit for bit) against the CPU; and a ``runtime.fault_tolerance.RestartManager`` run of the
     smoke granite (4 layers, pipe 2, fp32) crashed at tick 7 and
     restored from its tick-5 checkpoint, bit-equal to the uninterrupted
     run.

The data axis under the pipelines (the JAX package's GSPMD hybrid) adds
one phase:

 28. (``data_pipe``, after phase 19, whose sync ``--data 2`` run is now
     at the same 4 layers) ``launch.train.main`` on full-width granite-8b
     at 2 layers in 2 stages a replica, bf16, 8 x 512, 3 steps: the
     spectrain tick and the 1f1b round (4 microbatches), each once in
     one process and once with ``--data 2`` (the replicas share the card
     over gloo-host; ``--data 4`` on the tick over NCCL where there are 4
     cards): per replica and step the exact launches (8 / 4 / 4 / 3 a
     tick, 32 / 16 / 16 / 3 a round, every attention launch on the
     tensor cores), ZeRO-1's traffic a tick or a round exact (a
     reduce-scatter of the fp32 gradient, all-gathers of the weights
     and, on the spectrain tick, of ŵ; ``runtime.sharding.
     shard_buckets``) and nothing else sent, each replica's momentum its
     pieces' bytes and its peak at least 80% of the momentum it no
     longer holds below the one process's, the replicas' params and
     ``pred`` bit-equal and their momentum pieces combining into whole
     leaves after every step, the mean loss within bf16's unit roundoff
     (2^-8, relative) of the one process's; the step wall, the
     reduce-scatter's and the all-gathers' host seconds and the idle
     share.  Before the runs, ``fused_update`` on ZeRO-1 pieces: a stage
     tree cut at odd offsets into pieces that span leaves, one launch a
     piece, max |d| 0 against the plain version.

The tensor axis (Megatron-style heads, KV heads, MLP and vocabulary
sharding) adds one phase, and phase 3 holds the attention kernels at a
tensor rank's shapes (granite-8b's 16 of 32 heads over 4 of 8, granite-
20b's 24 of 48 over its one KV head), fp32 and bf16, forward and
backward:

 29. (``tensor_train``, after phase 28) ``launch.train.main --tensor 2``'s
     ranks on full-width granite-8b at 4 layers in 2 stages, bf16, 8 x
     512, spectrain, 3 ticks, the two tensor ranks sharing the card over
     gloo-host: per rank and tick the exact launches (8 / 4 / 4 / 3, at
     16 query heads over 4 KV heads), the tensor all-reduces exact (6L
     + 3 of the activations, 3 of the loss's [8, 512] fp32 terms), the
     ranks' losses equal and within 2^-8 of the one-process tick (run
     first, in this process); then an fp32 pair (2 layers, 4 x 256,
     TF32 off), one process and ``--tensor 2``, losses within rtol 1e-4
     / atol 1e-5; the tick's wall, busy, idle share, peak and
     all-reduce seconds per rank; with four cards also ``--tensor 4`` and
     ``--data 2 --tensor 2`` over NCCL (launches exact, the tick's wall
     and collectives' seconds).

The tensor axis for the MoE, state-space and MLA decoders adds one
phase, and phases 3, 8 and 26 hold the kernels at a rank's shapes
(the flash kernels at deepseek-moe-16b's 8 of 16 heads of 128,
zamba2-1.2b's shared block's 16 of 32 of 64 and minicpm3-4b's 20 of 40
at (96, 64), [4, 256]; both scans and their backward at 32 of 64 heads,
[4, 256]), fp32 and bf16, timed in bf16:

 30. (``tensor_train``, in phase 29's spawn of the two ranks, after its
     runs) ``--tensor 2`` on deepseek-moe-16b (2 layers: 32 of 64 routed
     experts and a rank's columns of the 2 shared experts a rank),
     rwkv6-7b (2 layers, 32 of 64 heads), zamba2-1.2b (20 layers, so
     that each of the 2 stages fires its shared block once; 32 of 64
     mamba2 heads) and minicpm3-4b (2 layers, 20 of 40 MLA heads), each
     in 2 stages at full width, bf16, 4 x 256, spectrain, 3 ticks: per
     rank and tick the exact launches (the one process's at the rank's
     heads; attention on the tensor cores, the scans on the chunked
     kernels), the tensor all-reduces and their bytes exact, the ranks'
     losses equal and within 2^-8 of the one-process tick, the tick's
     wall, busy, idle share, peak and all-reduce seconds per rank; with
     four cards also each at ``--tensor 4`` over NCCL.  grok-1-314b is
     held on the CPU only: one full-width layer needs >= 77 GB of fp32
     state.  The run ends with each phase's seconds.

It prints the kernels' JSON line before its last line, which is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line, as does a machine without a card or a directory without the
repository's ``src/``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "granite-8b"
SSM_ARCHS = ("rwkv6-7b", "zamba2-1.2b")
# zamba2-1.2b's shared attention block: heads, KV heads, head_dim
ZAMBA2_ATTN = (32, 32, 64)
TIMEOUT_S = 60

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# fp32 FLOP/s outside the tensor cores (the kernel's fp32 path)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def bound_of(flops, nbytes, peak: str):
    """(least ms, what bounds it) of work a kernel module's ``cost()``
    gives: the larger of its bytes over HBM_BPS and its FLOPs over the
    peak ``PEAK_FLOPS[peak]`` of their type."""
    t_b = nbytes / HBM_BPS * 1e3
    t_f = flops / PEAK_FLOPS[peak] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# the backward's (atol, rtol): tests/test_kernels.py::test_flash_bwd's in
# fp32, the kernel tolerance in bf16
BWD_TOL = {"float32": (2e-5, 1e-3), "bfloat16": (2e-2, 2e-2)}
FU_TOL = {"float32": 1e-6, "bfloat16": 2e-2}

# the training path: full-width granite-8b, 8 layers in 4 stages
TRAIN_LAYERS, TRAIN_STAGES, TRAIN_STEPS = 8, 4, 10
TRAIN_BATCH, TRAIN_SEQ = 8, 512
# the IR rounds: the launcher's round-size rule splits the batch into
# IR_ROUND microbatches of IR_MB_ROWS rows
IR_ROUND = 8
IR_MB_ROWS = TRAIN_BATCH // IR_ROUND
TRAIN_ARGV = ["--arch", ARCH, "--layers", str(TRAIN_LAYERS),
              "--pipe", str(TRAIN_STAGES), "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--dtype", "bfloat16",
              "--mode", "spectrain", "--data-kind", "uniform",
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]

# tests/test_kernels.py's FLASH_CASES: b, H, KV, sq, sk, d, causal, dtype
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, True, "float32"),
    (1, 8, 2, 256, 256, 128, True, "float32"),
    (2, 4, 1, 128, 256, 64, False, "float32"),
    (1, 4, 4, 128, 128, 64, True, "bfloat16"),
    (1, 2, 2, 512, 512, 32, True, "float32"),
]


# the bf16 tensor-core kernels' packed-row edges: name, b, sq, sk, H, KV,
# d, causal, q_offset, kv_len (G = H / KV; 16- and 64-row blocks, 64-key
# tiles)
MMA_EDGES = [
    ("G1 37 rows", 2, 37, 37, 8, 8, 64, True, 0, 37),
    ("G2 42 rows offset 29", 1, 21, 50, 8, 4, 32, True, 29, 50),
    ("G4 52 rows kv_len 77", 2, 13, 100, 16, 4, 128, False, 0, 77),
    ("G8 24 rows offset 60", 1, 3, 70, 32, 4, 16, True, 60, 63),
    ("G8 16 rows one warp", 1, 2, 64, 16, 2, 64, False, 10, 12),
    ("G8 decode 3 key tiles", 1, 1, 200, 8, 1, 128, False, 130, 131),
    ("G2 200 rows offset 200", 2, 100, 300, 4, 2, 32, True, 200, 300),
    ("G1 d16 70 rows", 1, 70, 70, 2, 2, 16, True, 0, 70),
    ("G1 65 rows, row 64 opens a key tile", 1, 65, 65, 4, 4, 64, True, 0,
     65),
]

# the bf16 dk/dv kernel's own edges (64-key blocks over 64-row packed
# tiles), in the same form: a key block whose first key is the position
# of a row tile's first row; G 4 with the first row to see a block mid-
# tile; kv_len mid-block with sk > kv_len; sq 1 with G 8
DKV_EDGES = [
    ("G1 key block 1 at row tile 1", 1, 192, 192, 2, 2, 64, True, 0, 192),
    ("G4 first visible row mid-tile", 1, 40, 120, 8, 2, 128, True, 50,
     120),
    ("G2 kv_len 100 of sk 160", 2, 70, 160, 4, 2, 64, False, 0, 100),
    ("G8 sq 1", 2, 1, 90, 16, 2, 128, True, 70, 71),
]


# the dense code models' attention: granite-20b's 48 heads over one KV
# head (MQA, G 48) and starcoder2-15b's 48 over 4 (G 12), head_dim 128;
# neither G divides the tensor-core kernels' 16- or 64-row blocks
WIDE_GQA = (("G48", (48, 1, 128)), ("G12", (48, 4, 128)))
# their packed-row edges (bf16), in MMA_EDGES' form: a block boundary
# inside one query's heads, sq G on and off the 16- and 64-row blocks,
# q_offset > 0, kv_len off the 64-key tile
WIDE_EDGES = [
    ("G12 decode 12 rows one warp", 1, 1, 90, 48, 4, 128, False, 80, 81),
    ("G48 decode 48 of 64 rows kv_len 3", 1, 1, 64, 48, 1, 128, False, 2,
     3),
    ("G12 60 rows offset 15", 1, 5, 20, 48, 4, 128, True, 15, 20),
    ("G48 144 rows offset 70 kv_len 73", 2, 3, 75, 48, 1, 128, True, 70,
     73),
    ("G12 132 rows offset 40 d64", 2, 11, 51, 48, 4, 64, True, 40, 51),
    ("G48 576 rows kv_len 100 of 120", 1, 12, 120, 48, 1, 128, False, 0,
     100),
]


# the tensor axis's attention (phase 29's path at --tensor 2): granite-8b's
# 32 / 8 heads become 16 / 4 a rank (G 4), granite-20b's 48 / 1 become 24
# over its one replicated KV head (G 24)
TP_GQA = (("TP2 G4", (16, 4, 128)), ("TP2 G24", (24, 1, 128)))
# phase 30's ranks at --tensor 2 on [4, 256] (TP_ROWS x TP_SEQ):
# deepseek-moe-16b's 16 / 16 heads of 128 become 8 / 8, zamba2-1.2b's
# shared block's 32 / 32 of 64 become 16 / 16, minicpm3-4b's 40 at (96,
# 64) become 20 (all G 1); (tag, (H, KV, q.k width), v width)
TP_ROWS, TP_SEQ = 4, 256
TP_RANK_ATTN = (("TP2 deepseek", (8, 8, 128), None),
                ("TP2 zamba2", (16, 16, 64), None),
                ("TP2 MLA", (20, 20, 96), 64))
# and the scans at a rank's 32 of 64 heads (rwkv6-7b's, zamba2-1.2b's)
TP_SCAN = ("tensor rank b4 s=256 h32", TP_ROWS, TP_SEQ, 32, 64)


def wide_cases(kind: str) -> list:
    """The G 12 and 48 calls of the code models' paths, fp32 and bf16:
    ``"fwd"`` decode over 64 keys and prefill n = 12 (serving), the tick's
    [8, 512] and an IR microbatch's [1, 512] causal (training);
    ``"bwd"`` prefill n = 12 and the training shapes; then the packed-row
    edges in bf16."""
    cases = []
    for tag, heads in WIDE_GQA:
        for dt in ("float32", "bfloat16"):
            if kind == "fwd":
                cases.append(Case(f"{tag} decode kv_len=64 {dt}", 1, 1, 64,
                                  *heads, dt, False, 63, 64))
            cases.append(Case(f"{tag} prefill n=12 {dt}", 1, 12, 12,
                              *heads, dt, True))
            cases.append(Case(f"{tag} train b8 512 causal {dt}",
                              TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, *heads, dt,
                              True))
            cases.append(Case(f"{tag} train IR microbatch b1 512 causal "
                              f"{dt}", IR_MB_ROWS, TRAIN_SEQ, TRAIN_SEQ,
                              *heads, dt, True))
    for name, b, sq, sk, H, KV, d, causal, off, kv_len in WIDE_EDGES:
        cases.append(Case(f"edge {name} bfloat16", b, sq, sk, H, KV, d,
                          "bfloat16", causal, off, kv_len))
    for tag, heads in TP_GQA:          # the training shapes a tensor rank
        for dt in ("float32", "bfloat16"):
            cases.append(Case(f"{tag} train b8 512 causal {dt}",
                              TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, *heads, dt,
                              True))
    for tag, heads, dv in TP_RANK_ATTN:
        for dt in ("float32", "bfloat16"):
            cases.append(Case(f"{tag} train b{TP_ROWS} {TP_SEQ} causal {dt}",
                              TP_ROWS, TP_SEQ, TP_SEQ, *heads, dt, True,
                              dv=dv))
    if kind == "bwd":
        cases = [BwdCase(c.name, c.b, c.sq, c.sk, c.H, c.KV, c.d, c.dtype,
                         c.causal, c.q_offset, c.kv_len, dv=c.dv)
                 for c in cases]
        for c in cases:      # G 48's and G 24's sums of 288 rows or more
            c.dkv_normwise = (c.dtype == "bfloat16"
                              and c.name.startswith(("G48", "TP2 G24")))
    return cases


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


_T0 = [None]       # the run's start (set by run()), for phase times


# torch.profiler keeps only the device records that fall inside its
# capture window on the host's clock; a record converted from the card's
# clock to just past the window's edge is lost.  Every profile waits this
# long after it starts and, the card synchronized, before it stops
PROFILE_SETTLE_S = 0.02


def device_profile():
    """A torch.profiler context over the card's activity alone: the host
    op events are not read, and recording them costs seconds a phase.
    It settles for ``PROFILE_SETTLE_S`` at both ends of its window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    class _Settled(profile):
        def __enter__(self):
            super().__enter__()
            time.sleep(PROFILE_SETTLE_S)
            return self

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            time.sleep(PROFILE_SETTLE_S)
            return super().__exit__(*exc)

    return _Settled(activities=[ProfilerActivity.CUDA])


@dataclasses.dataclass
class KernelSum:
    """One kernel name's device time in a profile, under the names
    ``key_averages()`` gives them (times in µs)."""
    key: str
    count: int
    self_device_time_total: float


def device_kernels(prof) -> list:
    """A :func:`device_profile`'s device events (kernels, copies, fills)
    summed by name, read from the raw kineto events: ``key_averages()``
    first builds the whole event tree, ~2.5 s for a round's 16k
    kernels."""
    from torch.autograd import DeviceType
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            n_us = by.setdefault(e.name(), [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.duration_ns() / 1e3
    return [KernelSum(k, n, us) for k, (n, us) in by.items()]


class StepProfile:
    """One profiled step of a training loop, driven from its ``on_step``
    hook (called with the card synchronized): the profile starts after
    step ``first - 1`` and stops after step ``first``.  A profile short of
    the step's exact kernel counts ``want`` (records lost) is taken again
    on the next step, up to step ``last``; an excess fails at once.
    ``steps`` lists every profiled step, for the wall to leave out."""

    def __init__(self, what: str, want: dict, first: int, last: int,
                 symbols=None):
        self.what, self.want, self.first, self.last = what, want, first, last
        self.symbols = KERNEL_SYMBOL if symbols is None else symbols
        self.prof, self.kern, self.at, self.steps = None, None, None, []

    def hook(self, s: int) -> None:
        self.stop(s)
        self.start(s)

    def stop(self, s: int) -> None:
        """Stop a running profile after step ``s`` and keep it if it is
        complete (the first half of :meth:`hook`)."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            kern, self.prof = device_kernels(self.prof), None
            self.steps.append(s)
            seen = {n: sum(e.count for e in kern
                           if self.symbols[n] in e.key) for n in self.want}
            check(all(seen[n] <= self.want[n] for n in self.want),
                  f"{self.what}: the profiled step {s} shows {seen} "
                  f"kernels, expected {self.want}")
            if seen == self.want:
                self.kern, self.at = kern, s
            else:
                print(f"  profile of step {s} incomplete: {seen} kernels, "
                      f"expected {self.want} (records lost)"
                      + ("; again" if s < self.last else ""))

    def start(self, s: int) -> None:
        """Start the profile of step ``s + 1`` if one is still wanted
        (the second half of :meth:`hook`)."""
        if self.kern is None and self.first <= s + 1 <= self.last:
            self.prof = device_profile()
            self.prof.__enter__()

    def result(self) -> list:
        """The complete profile's kernels; fails if every try came up
        short."""
        check(self.kern is not None, f"{self.what}: every profile of "
              f"steps {self.steps} came up short of {self.want}")
        return self.kern


_PHASES = []       # (name, start) of every phase, for their seconds


def phase(name: str) -> None:
    now = time.perf_counter()
    _PHASES.append((name, now))
    at = ("" if _T0[0] is None else f"  [{now - _T0[0]:.1f} s]")
    print(f"\n== {name}{at}", flush=True)


def print_phase_seconds() -> None:
    """Each phase's seconds, from its start to the next one's (the last
    to now), the longest first, and the run's total."""
    now = time.perf_counter()
    ends = [t for _, t in _PHASES[1:]] + [now]
    rows = sorted(((end - t, name) for (name, t), end in
                   zip(_PHASES, ends)), reverse=True)
    print("phase seconds, longest first: " + "; ".join(
        f"{d:.1f} {name[:70]}" for d, name in rows))
    if _T0[0] is not None:
        print(f"run total {now - _T0[0]:.1f} s")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device, copy=True)


# ---------------------------------------------------------------------------
# shapes: one flash call, its plain-version check, its bound


class Case:
    """One flash forward call: q [b, sq, H, d]; k [b, sk, KV, d], v
    [b, sk, KV, dv] (dv = d but for multi-head latent attention) with the
    first ``kv_len`` keys visible, queries at ``q_offset + i``."""

    def __init__(self, name, b, sq, sk, H, KV, d, dtype, causal,
                 q_offset=0, kv_len=None, dv=None):
        self.name, self.b, self.sq, self.sk = name, b, sq, sk
        self.H, self.KV, self.d, self.dtype = H, KV, d, dtype
        self.dv = d if dv is None else dv
        self.causal, self.q_offset = causal, q_offset
        self.kv_len = sk if kv_len is None else kv_len

    def tensors(self, torch, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dt = getattr(torch, self.dtype)
        mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dt)
        return (mk(self.b, self.sq, self.H, self.d),
                mk(self.b, self.sk, self.KV, self.d),
                mk(self.b, self.sk, self.KV, self.dv))

    def kw(self):
        return dict(causal=self.causal, q_offset=self.q_offset,
                    kv_len=self.kv_len)

    def pairs(self) -> int:
        """(query, key) pairs the masks leave, i.e. the work needed."""
        from repro_torch.kernels import flash_attention as fa
        return fa.pairs(self.sq, self.kv_len, self.causal, self.q_offset)

    def cost(self, which: str):
        """(FLOPs, bytes) of one ``which`` kernel call (``"fwd"``, ``"dq"``
        or ``"dkv"``): ``flash_attention.cost``, the formula the cost
        counter records."""
        from repro_torch.kernels import flash_attention as fa
        return fa.cost(which, self.b, self.sq, self.H, self.KV, self.d,
                       self.dv, kv_len=self.kv_len, causal=self.causal,
                       q_offset=self.q_offset,
                       el=2 if self.dtype == "bfloat16" else 4)

    def bound(self):
        """(least ms, what bounds it): inputs read once, outputs written
        once, over HBM; QK^T (2 d) and PV (2 dv) FLOPs a pair over the
        peak for the type (``flash_attention.cost("fwd", ...)``)."""
        return bound_of(*self.cost("fwd"), self.dtype)


def compare(torch, fa, ref, case: Case, seed=0):
    """Kernel against the plain version on the same card inputs; returns
    (max |d o|, max |d lse|)."""
    q, k, v = case.tensors(torch, seed)
    before = (fa.launches, fa.launches_mma)
    o, lse = fa.flash_fwd(q, k, v, **case.kw())
    torch.cuda.synchronize()
    mma = int(case.dtype == "bfloat16")
    check((fa.launches, fa.launches_mma) == (before[0] + 1, before[1] + mma),
          f"{case.name}: the {case.dtype} call did not launch the "
          f"{'tensor-core' if mma else 'FMA'} kernel once")
    o_r, lse_r = ref.flash_fwd_ref(q, k, v, **case.kw())
    tol = TOL[case.dtype]
    for got, want, nm in ((o.float(), o_r.float(), "o"),
                          (lse, lse_r, "lse")):
        check(bool(torch.isfinite(got).all()), f"{case.name}: {nm} not "
              f"finite")
        ok = torch.allclose(got, want, atol=tol, rtol=tol)
        check(ok, f"{case.name}: {nm} max |d| "
              f"{float((got - want).abs().max()):.3e} beyond {tol}")
    return (float((o.float() - o_r.float()).abs().max()),
            float((lse - lse_r).abs().max()))


def time_ms(torch, fn, iters: int):
    """(device ms, wall ms) per call.  Wall: host clock around ``iters``
    calls and a synchronise, which a small kernel's Python wrapper can
    dominate.  Device: CUDA events around ``iters`` calls queued behind
    a spin kernel that outlasts their enqueue, so the card runs them
    back to back and the events see only device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / iters
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # spin for 1.5x the enqueue time plus 5 ms, at <= 2e6 cycles per ms
    torch.cuda._sleep(int((1.5 * wall_ms * iters + 5.0) * 2e6))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters, wall_ms


def sdpa_fn(torch, case: Case, q, k, v):
    """One library call computing the same attention (layout [b, H, s, d];
    GQA through ``enable_gqa``)."""
    import torch.nn.functional as F
    qt = q.transpose(1, 2)
    kt = k[:, :case.kv_len].transpose(1, 2)
    vt = v[:, :case.kv_len].transpose(1, 2)
    # decode: one query against kv_len keys, no mask; prefill: causal
    # with queries and keys aligned at 0 (sq == kv_len, q_offset == 0)
    causal = case.causal and case.sq > 1
    if causal:
        check(case.q_offset == 0 and case.sq == case.kv_len,
              f"{case.name}: SDPA's causal mask is top-left aligned")
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def library_kernels(torch, fn) -> list:
    """Which backend one call of SDPA ran, from torch.profiler: the aten
    attention ops it dispatched to (``aten::_scaled_dot_product_
    {flash,efficient,cudnn}_attention...``) and the device kernels the
    profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = {e.key for e in events if e.device_type == DeviceType.CPU
           and re.search(r"_attention|_sdpa|scaled_dot", e.key)}
    kernels = {e.key[:96] for e in events
               if e.device_type == DeviceType.CUDA}
    return sorted(ops) + sorted(kernels)


def sdpa_flags(torch) -> str:
    """The SDPA backends torch.backends.cuda leaves enabled."""
    b = torch.backends.cuda
    flags = {"flash": b.flash_sdp_enabled(),
             "mem_efficient": b.mem_efficient_sdp_enabled(),
             "math": b.math_sdp_enabled()}
    if hasattr(b, "cudnn_sdp_enabled"):
        flags["cudnn"] = b.cudnn_sdp_enabled()
    return ", ".join(k for k, v in flags.items() if v)


# ---------------------------------------------------------------------------
# phases


def card_info(torch) -> dict:
    phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=TIMEOUT_S)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{name}, {count} device(s)")
    return {"smi": smi_line, "kind": name, "count": count}


def mma_ptxas(log: str) -> dict:
    """{kernel<args>: "registers, barriers (and static shared memory);
    spills"} as ptxas prints them, for the tensor-core kernels and the
    scans' decode, scores and chunked kernels in one nvcc -Xptxas -v
    log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            sym = line.split("'")[1]
            name = None
            for k in ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                      "flash_bwd_dkv_mma_kernel", "wkv_decode_kernel",
                      "wkv_scores_kernel", "wkv_chunk_kernel",
                      "ssd_decode_kernel", "ssd_scores_kernel",
                      "ssd_chunk_kernel", "wkv_bwd_kernel",
                      "ssd_bwd_kernel", "wkv_bwd_states_kernel",
                      "wkv_bwd_chunk_kernel", "ssd_bwd_states_kernel",
                      "ssd_bwd_chunk_kernel"):
                if k in sym:      # _Z..<k>ILi128ELi4EE.. -> k<128, 4>
                    rest = sym.split(k, 1)[1]
                    args = re.findall(r"Li(\d+)E", rest)
                    # a type argument first (ILi.. is an int argument)
                    if rest.startswith("I") and not rest.startswith("IL"):
                        args.insert(0, "bf16" if "bfloat16" in rest
                                    else "fp32")
                    name = f"{k}<{', '.join(args)}>"
        elif name and "spill stores" in line:
            out[name] = line.strip().split(", ", 1)[1]
        elif name and "Used" in line and "registers" in line:
            out[name] = (line.split("Used", 1)[1].strip() + "; "
                         + out.get(name, ""))
            name = None
    return out


def build_kernels(build, r6, m2, *mods) -> None:
    phase("build")
    t0 = time.perf_counter()
    built = build.build_all()
    for mod in (r6, m2, *mods):
        mod.load()
    print(f"built {sorted(built) or 'nothing (libraries present)'} in "
          f"{time.perf_counter() - t0:.2f}s")
    for name, info in sorted(built.items()):
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
    for name, info in sorted(built.items()):
        for kernel, props in mma_ptxas(str(info["log"])).items():
            print(f"  {name}: {kernel}: {props}")
    # the kernels' shared memory is dynamic, so ptxas does not print it
    from repro_torch.kernels.flash_attention import smem_bytes
    for dk, dv in ((64, 64), (128, 128), (96, 64)):
        sm = lambda kernel: smem_bytes(kernel, dk, dv)
        print(f"  dynamic shared memory per block at widths ({dk}, {dv}): "
              f"flash_fwd fp32 {sm('fwd')} B, bf16 mma 4 warps "
              f"{sm('fwd_mma')} B, 1 warp {sm('fwd_mma_1warp')} B; "
              f"flash_bwd_dq fp32 {sm('dq')} B, bf16 mma {sm('dq_mma')} B; "
              f"flash_bwd_dkv fp32 {sm('dkv')} B, bf16 mma "
              f"{sm('dkv_mma')} B; fused_update none")
    import torch
    for dt in (torch.bfloat16, torch.float32):
        print(f"  dynamic shared memory per block at 64 wide, {dt}: "
              f"wkv_chunk_kernel {r6.chunk_smem_bytes(dt, 64)} B, "
              f"wkv_scores_kernel {r6.chunk_smem_bytes(dt, 64, True)} B, "
              f"ssd_chunk_kernel {m2.chunk_smem_bytes(dt, 64)} B, "
              f"ssd_scores_kernel {m2.chunk_smem_bytes(dt, 64, True)} B; "
              f"the scans' decode and stepwise kernels: static only (ptxas "
              f"lines above)")
    print(f"  dynamic shared memory per block of the scans' backward: "
          f"wkv_bwd_kernel hd 64 {r6.bwd_smem_bytes(64)} B, ssd_bwd_kernel "
          f"p 64 n 64 {m2.bwd_smem_bytes(64, 64)} B; the chunked "
          f"wkv_bwd_chunk_kernel bf16 / fp32 "
          f"{r6.bwd_smem_bytes(64, torch.bfloat16)} / "
          f"{r6.bwd_smem_bytes(64, torch.float32)} B, ssd_bwd_chunk_kernel "
          f"{m2.bwd_smem_bytes(64, 64, torch.bfloat16)} / "
          f"{m2.bwd_smem_bytes(64, 64, torch.float32)} B")


def kernel_checks(torch, fa, ref) -> dict:
    phase("flash_fwd against its plain version on the card")
    cfg = (32, 8, 128)       # granite-8b heads, KV heads, head_dim
    cases = []
    # the serving paths' calls: granite-8b's attention layers and
    # zamba2-1.2b's shared attention block (heads, KV heads, head_dim)
    for arch, heads in (("", cfg), ("zamba2 ", ZAMBA2_ATTN)):
        for kv_len in (1, 37, 64):
            cases.append(Case(f"{arch}decode kv_len={kv_len}", 1, 1, 64,
                              *heads, "bfloat16", False, kv_len - 1,
                              kv_len))
        for n in (2, 12):
            cases.append(Case(f"{arch}prefill n={n}", 1, n, n, *heads,
                              "bfloat16", True))
    for b, H, KV, sq, sk, d, causal, dt in FLASH_CASES:
        for dt_ in sorted({dt, "bfloat16"}):   # each also in bf16
            cases.append(Case(f"test_kernels b{b} H{H}/{KV} {sq}x{sk} d{d} "
                              f"{'causal' if causal else 'full'} {dt_}",
                              b, sq, sk, H, KV, d, dt_, causal))
    for name, b, sq, sk, H, KV, d, causal, off, kv_len in MMA_EDGES:
        cases.append(Case(f"edge {name} bfloat16", b, sq, sk, H, KV, d,
                          "bfloat16", causal, off, kv_len))
    cases.append(Case("causal 2048", 1, 2048, 2048, *cfg, "bfloat16",
                      True))
    for dt in ("float32", "bfloat16"):       # the training paths' calls
        cases.append(Case(f"train b8 512 causal {dt}", TRAIN_BATCH,
                          TRAIN_SEQ, TRAIN_SEQ, *cfg, dt, True))
        cases.append(Case(f"train IR microbatch b1 512 causal {dt}",
                          IR_MB_ROWS, TRAIN_SEQ, TRAIN_SEQ, *cfg, dt, True))
    cases += wide_cases("fwd")
    errs = {}
    for i, case in enumerate(cases):
        e_o, e_l = compare(torch, fa, ref, case, seed=i)
        errs[case.name] = e_o
        print(f"  {case.name:<44} max|d o| {e_o:.3e}  max|d lse| "
              f"{e_l:.3e}  (tol {TOL[case.dtype]:g})")
    return errs


def model_check(torch) -> None:
    """The port's model on the card (flash kernel) against itself on the
    CPU (plain attention), same weights, smoke size, fp32."""
    phase("model on the card against the CPU, smoke size, fp32")
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import Model
    from repro_torch.planner import serve_plan
    from repro_torch.serve import SimpleEngine, poisson_trace
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=4, n_kv_heads=2, compute_dtype="float32")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _tree_to(p_cpu, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 16)
        l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.cuda()}, 16)
        for pos in range(9, 12):
            tok = toks[:, pos - 9:pos - 8]
            d_c, c_c = cpu.decode_step(p_cpu, c_c, tok, pos)
            d_g, c_g = gpu.decode_step(p_gpu, c_g, tok.cuda(), pos)
    err = max(float((l_g.cpu() - l_c).abs().max()),
              float((d_g.cpu() - d_c).abs().max()),
              float((c_g["layers"]["k"].cpu() - c_c["layers"]["k"])
                    .abs().max()))
    print(f"  logits and cache max |d| {err:.3e} (tol 1e-4)")
    check(err <= 1e-4, f"model on the card differs from the CPU by {err}")
    splan = serve_plan(cfg, n_stages=1, n_slots=1, prompt_budget=8,
                       page_seq=32)
    trace = poisson_trace(6, rate=1.5, seed=0, prompt_lens=(2, 8),
                          vocab=cfg.vocab_size)
    t_c = SimpleEngine(cpu, p_cpu, splan).run(trace)
    t_g = SimpleEngine(gpu, p_gpu, splan).run(trace)
    print(f"  engine tokens equal on card and CPU: {t_c == t_g}")
    check(t_c == t_g, "engine tokens differ between the card and the CPU")


def fma_only(ops) -> None:
    """The fp32 card-vs-CPU checks ran attention on the FMA kernels only:
    flash forwards and both backward kernels were launched, none a
    tensor-core one."""
    counts = ops.launch_counts()
    variants = {k: v for k, v in ops.variant_counts().items()
                if k.endswith("_mma")}
    print(f"  fp32 model checks: {counts['flash_fwd']} flash_fwd, "
          f"{counts['flash_bwd_dq']} flash_bwd_dq and "
          f"{counts['flash_bwd_dkv']} flash_bwd_dkv launches, tensor-core "
          f"variants {variants}")
    check(counts["flash_fwd"] > 0 and counts["flash_bwd_dq"] > 0
          and counts["flash_bwd_dkv"] > 0,
          "the fp32 model checks launched no attention kernel")
    check(not any(variants.values()),
          f"an fp32 model check reached a bf16 kernel: {variants}")


def per_call_launches(arch: str, layers: int = 0) -> dict:
    """Kernel launches one prefill or decode call of full ``arch`` (or
    ``layers`` of it) makes: one flash forward per attention layer (MoE
    included; two per enc-dec decoder layer, its self- and
    cross-attention), one scan per rwkv6 / mamba2 layer, and one flash
    forward per shared-block call of a hybrid model (after every full
    ``shared_attn_every`` segment of each stage)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import uniform_stage_sizes
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    if cfg.is_encdec:
        return {"flash_fwd": 2 * cfg.n_layers}
    if cfg.ssm is None:
        return {"flash_fwd": cfg.n_layers}
    if cfg.ssm.kind == "rwkv6":
        return {"rwkv6_scan": cfg.n_layers}
    k = cfg.ssm.shared_attn_every
    sizes = uniform_stage_sizes(cfg.n_layers, cfg.mesh_plan.pipe)
    return {"mamba2_scan": cfg.n_layers,
            "flash_fwd": sum(n // k for n in sizes)}


def main_path(torch, ops, arch: str, n_layers: int, *, layers: int = 0,
              logit_cap: float = 0.0, requests: int = 8) -> dict:
    """``repro_torch.launch.serve.main --engine simple`` on full
    ``arch`` (or ``layers`` of its ``n_layers``) over ``requests``
    requests: every admissible request served, finite logits (and every
    logit within ``logit_cap`` when it is set), exactly the path's
    launches."""
    depth = f"{layers} of {n_layers} layers" if layers else "full"
    phase(f"main path: repro_torch.launch.serve.main, {depth} {arch}, "
          f"bf16")
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.planner import serve_plan
    from repro_torch.serve import admissible, poisson_trace
    cfg = get_config(arch)
    check(cfg.n_layers == n_layers, "unexpected depth")
    if layers:
        cfg = cfg.replace(n_layers=layers)
    per_call = per_call_launches(arch, layers)
    args = dict(requests=requests, rate=1.5, prompt_lens=(2, 12),
                gen_lens=(1, 8), prompt_budget=16, page_seq=64, seed=0)
    trace = poisson_trace(args["requests"], rate=args["rate"],
                          seed=args["seed"], prompt_lens=args["prompt_lens"],
                          gen_lens=args["gen_lens"], vocab=cfg.vocab_size)
    splan = serve_plan(cfg, n_stages=1, n_slots=1,
                       prompt_budget=args["prompt_budget"],
                       page_seq=args["page_seq"])
    live = [q for q in trace if admissible(q, splan)]
    want_prefill = 1 + len(live)                 # + the warm-up's one
    want_decode = 1 + sum(q.gen_len - 1 for q in live)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "serve.jsonl"
        argv = ["--arch", arch, "--engine", "simple",
                "--requests", str(args["requests"]),
                "--rate", str(args["rate"]), "--prompt-lens", "2,12",
                "--gen-lens", "1,8", "--prompt-budget", "16",
                "--page-seq", "64", "--seed", "0",
                *(["--layers", str(layers)] if layers else []),
                "--metrics-out", str(out)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rc = serve.main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated()
        recs = [json.loads(x) for x in out.read_text().splitlines()]
    check(rc == 0, f"serve.main returned {rc}")
    run = [r for r in recs if r["event"] == "serve_run"][-1]
    summary = [r for r in recs if r["event"] == "summary"][-1]
    gauges, counters = summary["gauges"], summary["counters"]
    n_pf, n_dec = gauges["serve/prefill_calls"], gauges["serve/decode_calls"]
    print(f"  served {run['n_served']}/{run['n_requests']} requests, "
          f"{run['n_tokens']} tokens; {n_pf:g} prefill + {n_dec:g} decode "
          f"calls (warm-up included)")
    print(f"  decode {run['tok_per_s']:.2f} tok/s   p50 "
          f"{run['token_ms_p50']:.3f} ms/tok   p99 "
          f"{run['token_ms_p99']:.3f} ms/tok   warm-up "
          f"{run['compile_s']:.2f}s")
    print(f"  peak torch.cuda.max_memory_allocated: {peak / 2**30:.2f} GiB")
    for name, n in per_call.items():
        print(f"  {name} launches {counts[name]} = {n} x "
              f"({n_pf:g} + {n_dec:g})")
    check(run["n_served"] == len(live) and run["n_rejected"] ==
          len(trace) - len(live), "not every admissible request was served")
    check(run["n_tokens"] == sum(q.gen_len for q in live),
          "a request did not get exactly gen_len tokens")
    check(counters.get("serve/nonfinite_logits", 0) == 0,
          "non-finite logits")
    top = gauges["serve/max_abs_logit"]
    print(f"  max |logit| over the served rows: {top:.4f}"
          + (f" (softcap {logit_cap:g})" if logit_cap else ""))
    check(not logit_cap or top <= logit_cap,
          f"a logit of magnitude {top} outside +-{logit_cap}")
    check((n_pf, n_dec) == (want_prefill, want_decode),
          f"engine made {n_pf} + {n_dec} calls, expected "
          f"{want_prefill} + {want_decode}")
    want = {name: per_call.get(name, 0) * (want_prefill + want_decode)
            for name in counts}
    check(counts == want, f"the run launched {counts}, expected {want}")
    # every bf16 flash_fwd on the tensor cores; the scans: the decode
    # kernel for every decode step and the warm-up's one-token prefill,
    # the stepwise kernel for every request's prefill (prompts 2-12), the
    # chunked kernel never
    want_v = {k: 0 for k in variants}
    want_v["flash_fwd_mma"] = counts["flash_fwd"]
    for scan in ("rwkv6_scan", "mamba2_scan"):
        want_v[f"{scan}_decode"] = per_call.get(scan, 0) * (want_decode + 1)
    print(f"  variants: {variants}")
    check(variants == want_v, f"the run's variant launches {variants}, "
          f"expected {want_v}")
    check(all(math.isfinite(run[k]) for k in
              ("tok_per_s", "token_ms_p50", "token_ms_p99")),
          "non-finite serving metrics")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts, "variants": variants, "run": run,
            "peak_bytes": peak, "per_call": per_call, "max_abs_logit": top,
            "layers": cfg.n_layers}


# the MoE and code models' serving runs: (arch, engine, layers; 0 = full)
NEW_SERVE = [("deepseek-moe-16b", "simple", 0),
             ("deepseek-moe-16b", "pipelined", 0),
             ("granite-20b", "simple", 0), ("granite-20b", "pipelined", 0),
             ("starcoder2-15b", "simple", 0), ("grok-1-314b", "simple", 4)]
# their decode steps profiled as phase 6 profiles the first three models'
NEW_PROFILED = ("deepseek-moe-16b", "granite-20b")
# their training runs: full width, NEW_TRAIN_LAYERS in 4 stages
NEW_TRAIN = ("deepseek-moe-16b", "granite-20b")
NEW_TRAIN_LAYERS = 4


# the kernel function each wrapper launches, as the profiler names it
# (bf16 paths: the tensor-core variants of the forward and backward; a
# decode step's scans: their decode kernels)
KERNEL_SYMBOL = {"flash_fwd": "flash_fwd_mma_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_mma_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_mma_kernel",
                 "fused_update": "fused_update_kernel",
                 "rwkv6_scan": "wkv_decode_kernel",
                 "mamba2_scan": "ssd_decode_kernel"}


def decode_profile(torch, arch: str = ARCH) -> dict:
    """Where a full-width decode step spends its time: wall per step
    without the profiler, then device time per kernel under it."""
    phase(f"a full-width {arch} decode step under torch.profiler")
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg.compute_dtype)
    # 8 steps for the wall; 4 under the profiler: one window of 8 steps
    # is ~20k kernel records, about one CUPTI activity buffer, and once
    # lost ~1% of them (2,430.6 of 2,455 kernels a step)
    steps, prof_steps, attempts = 8, 4, 3
    want = {name: per_step * prof_steps
            for name, per_step in per_call_launches(arch).items()}
    with torch.inference_mode():
        prompt = torch.arange(1, 9, device="cuda")[None]
        _, cache = model.prefill(params, {"tokens": prompt}, 64)

        def step(pos):
            logits, _ = model.decode_step(params, cache, prompt[:, -1:],
                                          pos)
            return int(torch.argmax(logits[0, -1, :cfg.vocab_size]))

        step(8)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for pos in range(9, 9 + steps):
            step(pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
        # a profile short of a kernel's exact count (records dropped) is
        # taken again, at most `attempts` times; an excess fails at once
        for attempt in range(1, attempts + 1):
            with device_profile() as prof:
                for pos in range(9 + steps, 9 + steps + prof_steps):
                    step(pos)
                torch.cuda.synchronize()
            kern = device_kernels(prof)
            seen = {name: sum(e.count for e in kern
                              if KERNEL_SYMBOL[name] in e.key)
                    for name in want}
            check(all(seen[n] <= want[n] for n in want), f"the profiled "
                  f"decode steps show {seen} kernels, expected {want}")
            if seen == want or attempt == attempts:
                break
            print(f"  profile {attempt} of {attempts} incomplete: {seen} "
                  f"kernels, expected {want} (records dropped); again")
    del params, cache, model
    gc.collect()
    torch.cuda.empty_cache()
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / prof_steps
    n_kern = sum(e.count for e in kern) / prof_steps
    print(f"  wall per decode step (no profiler): {wall_ms:.3f} ms")
    print(f"  device kernels per step: {n_kern:.1f}")
    check(bool(kern), "the profiler saw no device activity in the decode "
          "steps")
    print(f"  device busy per step: {busy_ms:.3f} ms, "
          f"{100 * busy_ms / wall_ms:.1f}% of the wall "
          f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%)")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:8]:
        print(f"    {e.self_device_time_total / 1e3 / prof_steps:8.4f} ms "
              f"{e.count / prof_steps:6.1f}x  {e.key[:72]}")
    by = {}
    for name in want:
        hits = [e for e in kern if KERNEL_SYMBOL[name] in e.key]
        n_hit = sum(e.count for e in hits)
        check(n_hit == want[name], f"the profiled decode steps show "
              f"{n_hit} {name} kernels, expected {want[name]}")
        by[name] = (sum(e.self_device_time_total for e in hits) / 1e3
                    / prof_steps)
        print(f"  {name}: {by[name]:.4f} ms per step "
              f"({100 * by[name] / busy_ms:.1f}% of device busy)")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernel_ms": by,
            "idle_share": 1 - busy_ms / wall_ms, "kernels_per_step": n_kern}


def timings(torch, fa, ref, errs) -> list:
    phase("timings (CUDA events, after warm-up)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (32, 8, 128)
    cases = [(Case("decode kv_len=64", 1, 1, 64, *cfg, "bfloat16", False,
                   63, 64), 500),
             (Case("prefill n=12", 1, 12, 12, *cfg, "bfloat16", True), 500),
             (Case("zamba2 decode kv_len=64", 1, 1, 64, *ZAMBA2_ATTN,
                   "bfloat16", False, 63, 64), 500),
             (Case("zamba2 prefill n=12", 1, 12, 12, *ZAMBA2_ATTN,
                   "bfloat16", True), 500),
             (Case("causal 2048", 1, 2048, 2048, *cfg, "bfloat16", True),
              20),
             (Case("train b8 512 causal bfloat16", TRAIN_BATCH, TRAIN_SEQ,
                   TRAIN_SEQ, *cfg, "bfloat16", True), 20)]
    for tag, heads in WIDE_GQA:        # granite-20b's and starcoder2-15b's
        cases += [(Case(f"{tag} decode kv_len=64 bfloat16", 1, 1, 64,
                        *heads, "bfloat16", False, 63, 64), 500),
                  (Case(f"{tag} prefill n=12 bfloat16", 1, 12, 12, *heads,
                        "bfloat16", True), 500),
                  (Case(f"{tag} train b8 512 causal bfloat16", TRAIN_BATCH,
                        TRAIN_SEQ, TRAIN_SEQ, *heads, "bfloat16", True), 20)]
    for tag, heads in TP_GQA:          # a tensor rank's (phase 29)
        cases.append((Case(f"{tag} train b8 512 causal bfloat16",
                           TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, *heads,
                           "bfloat16", True), 20))
    for tag, heads, dv in TP_RANK_ATTN:    # phase 30's ranks'
        cases.append((Case(f"{tag} train b{TP_ROWS} {TP_SEQ} causal "
                           f"bfloat16", TP_ROWS, TP_SEQ, TP_SEQ, *heads,
                           "bfloat16", True, dv=dv), 50))
    print(f"  SDPA backends enabled (torch.backends.cuda): "
          f"{sdpa_flags(torch)}")
    return [fwd_row(torch, fa, ref, case, iters, errs[case.name])
            for case, iters in cases]


def fwd_row(torch, fa, ref, case: Case, iters: int, err: float) -> dict:
    """One forward shape: the kernel, its plain version and SDPA (CUDA
    events, after warm-up), the bound."""
    q, k, v = case.tensors(torch, seed=7)
    kw = case.kw()
    ms, wall = time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw), iters)
    plain_ms, _ = time_ms(
        torch, lambda: ref.flash_fwd_ref(q, k, v, **kw), iters)
    sdpa = sdpa_fn(torch, case, q, k, v)
    lib_ms, _ = time_ms(torch, sdpa, iters)
    lib_kernels = library_kernels(torch, sdpa)
    bound_ms, bound_by = case.bound()
    print(f"  {case.name:<28} kernel {ms:.4f} ms (wall {wall:.4f} ms "
          f"per call)  bound {bound_ms:.5f} ms ({bound_by})  plain "
          f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms "
          f"({ms / lib_ms:.2f}x sdpa; sdpa ran {lib_kernels})")
    return {"shape": case.name, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_kernels": lib_kernels,
            "max_abs_err": err, "wall_ms_per_call": wall}


# ---------------------------------------------------------------------------
# the flash backward and the fused update


class BwdCase(Case):
    """One flash backward call (dq and dk/dv) on a Case's shapes.
    ``dkv_normwise``: hold bf16 dk and dv by the largest error against
    the plain version's fp32 result (see :func:`compare_bwd`)."""

    dkv_normwise = False

    def bound(self, which: str):
        """(least ms, what bounds it) for one of the two kernels: inputs
        (q, k, v, do, lse, dl) read once and outputs (dq, or dk and dv)
        written once over HBM; 2 (2d + dv) (dq: S, dP, dS K) or 4 (d + dv)
        (dk/dv: S, dP, P^T dO, dS^T Q) FLOPs per unmasked (query, key)
        pair and head over the peak for the type (6d and 8d at dv = d):
        ``flash_attention.cost(which, ...)``."""
        return bound_of(*self.cost(which), self.dtype)

    def all_tensors(self, torch, fa, seed=0):
        q, k, v = self.tensors(torch, seed)
        o, lse = fa.flash_fwd(q, k, v, **self.kw())
        g = torch.Generator(device="cuda").manual_seed(seed + 1000)
        do = torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
        return q, k, v, o, lse, do


def compare_bwd(torch, fa, ref, case: BwdCase, seed=0):
    """Both backward kernels against the plain version on the same card
    inputs; returns {"dq": max |d dq|, "dkv": max over dk and dv}.  Keys
    at positions >= kv_len must come back exactly zero.

    With ``case.dkv_normwise`` (bf16 at granite-20b's G 48),
    dk and dv are held normwise: their largest error against the plain
    version computed in fp32 on the same bf16 inputs within 2e-2 of
    their largest magnitude.  There a key sums G·sq terms of bf16 Pᵀ dO
    and dSᵀ Q (576 at G 48, n 12; 24,576 at G 48 in training) up to
    |dv| ~ 30, and the elementwise 2e-2 fails by bf16 rounding alone:
    the plain version's own bf16 output misses it against its fp32
    result by up to 0.062 (NVIDIA H100 80GB HBM3), and the kernels'
    algorithm emulated on the CPU misses it too."""
    q, k, v, o, lse, do = case.all_tensors(torch, fa, seed)
    counters = lambda: (fa.launches_dq, fa.launches_dq_mma,
                        fa.launches_dkv, fa.launches_dkv_mma)
    before = counters()
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, **case.kw())
    torch.cuda.synchronize()
    mma = int(case.dtype == "bfloat16")
    check(counters() == (before[0] + 1, before[1] + mma, before[2] + 1,
                         before[3] + mma),
          f"{case.name}: the {case.dtype} call did not launch dq and dk/dv "
          f"once each on the {'tensor-core' if mma else 'FMA'} kernels")
    # dk/dv again (uncounted) into NaN-filled outputs: a key the kernel
    # does not write stays NaN, and a second run must repeat the first
    # bit for bit (no atomics)
    _, launch_dkv, (_, dk2, dv2) = fa._bwd_launchers(q, k, v, o, lse, do,
                                                     **case.kw())
    dk2.fill_(float("nan"))
    dv2.fill_(float("nan"))
    launch_dkv()
    torch.cuda.synchronize()
    check(torch.equal(dk2, dk) and torch.equal(dv2, dv), f"{case.name}: "
          f"dk/dv into NaN-filled outputs differ from the first run")
    for nm, t in (("dk", dk), ("dv", dv)):
        check(bool((t[:, case.kv_len:] == 0).all()), f"{case.name}: {nm} "
              f"not exactly zero for keys past kv_len {case.kv_len}")
    want = ref.flash_bwd_ref(q, k, v, o, lse, do, **case.kw())
    if case.dkv_normwise:
        f32 = ref.flash_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                lse, do.float(), **case.kw())
        want = (want[0], f32[1], f32[2])
    atol, rtol = BWD_TOL[case.dtype]
    errs = {}
    for got, w, nm in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        got, w = got.float(), w.float()
        check(bool(torch.isfinite(got).all()), f"{case.name}: {nm} not "
              f"finite")
        err = float((got - w).abs().max())
        if case.dkv_normwise and nm != "dq":
            scale = float(w.abs().max())
            check(err <= rtol * scale, f"{case.name}: {nm} max |d| "
                  f"{err:.3e} against the fp32 plain version beyond "
                  f"{rtol} x its max |{nm}| {scale:.3f}")
        else:
            check(torch.allclose(got, w, atol=atol, rtol=rtol),
                  f"{case.name}: {nm} max |d| {err:.3e} beyond atol "
                  f"{atol} / rtol {rtol}")
        errs[nm] = err
    return {"dq": errs["dq"], "dkv": max(errs["dk"], errs["dv"])}


def bwd_checks(torch, fa, ref) -> dict:
    phase("flash_bwd (dq, dk/dv) against its plain version on the card")
    cfg = (32, 8, 128)
    cases = []
    for dt in ("float32", "bfloat16"):
        cases.append(BwdCase(f"train b8 512 causal {dt}", TRAIN_BATCH,
                             TRAIN_SEQ, TRAIN_SEQ, *cfg, dt, True))
        cases.append(BwdCase(f"train IR microbatch b1 512 causal {dt}",
                             IR_MB_ROWS, TRAIN_SEQ, TRAIN_SEQ, *cfg, dt,
                             True))
        cases.append(BwdCase(f"test_flash_bwd b1 H4/2 128 d64 {dt}", 1,
                             128, 128, 4, 2, 64, dt, True))
        cases.append(BwdCase(f"full GQA H8/2 65x130 kv_len 97 {dt}", 3,
                             65, 130, 8, 2, 64, dt, False, 0, 97))
    for name, b, sq, sk, H, KV, d, causal, off, kv_len in (MMA_EDGES +
                                                           DKV_EDGES):
        cases.append(BwdCase(f"edge {name} bfloat16", b, sq, sk, H, KV, d,
                             "bfloat16", causal, off, kv_len))
    cases += wide_cases("bwd")
    errs = {}
    for i, case in enumerate(cases):
        e = compare_bwd(torch, fa, ref, case, seed=100 + i)
        errs[case.name] = e
        tol = (f"dk, dv within {BWD_TOL[case.dtype][1]} of their max "
               f"against fp32" if case.dkv_normwise
               else f"tol {BWD_TOL[case.dtype]}")
        print(f"  {case.name:<40} max|d dq| {e['dq']:.3e}  max|d dk,dv| "
              f"{e['dkv']:.3e}  ({tol})")
    return errs


def group_specs(kind: str, n_layers: int = 0) -> list:
    """[(path, ParamSpec)] of one update group of full-width granite-8b,
    in the order the update sees its leaves: ``"stage"``, a stage tree of
    ``n_layers`` layers; ``"outer"``, the embedding and final norm."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import (embed_specs, norm_specs,
                                           stack_specs, tree_map)
    from repro_torch.models.transformer import block_specs
    cfg = get_config(ARCH)
    tree = ({"layers": stack_specs(block_specs(cfg), n_layers, "layer")}
            if kind == "stage" else
            {"embed": embed_specs(cfg), "ln_f": norm_specs(cfg)})
    out = []
    tree_map(lambda path, sp: out.append((path, sp)), tree)
    return out


def make_group(torch, specs, predicted, seed=0):
    """fp32 w, v and g of random values for ``specs``, and an fp32 ŵ for
    each path ``predicted(path)`` accepts (None for the others; None
    for the list if it accepts none), as the main path's update gets
    them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda shape, scale=1.0: torch.randn(
        shape, generator=g, device="cuda") * scale
    ws = [mk(sp.shape) for _, sp in specs]
    vs = [mk(sp.shape, 1e-2) for _, sp in specs]
    gs = [mk(sp.shape) for _, sp in specs]
    whats = [torch.empty(sp.shape, device="cuda") if predicted(path)
             else None for path, sp in specs]
    return ws, vs, gs, (whats if any(w is not None for w in whats)
                        else None)


FU_KW = dict(lr=1e-2, gamma=0.9, s=6.0)


def fu_compare(torch, ops, ref, ws, vs, gs, whats, what: str,
               kw=FU_KW) -> float:
    """One kernel launch over a group, with the update's arguments
    ``kw``, against its plain version on the same inputs (computed
    first: the kernel writes in place); returns the largest |d| over w',
    v' and ŵ."""
    whats_l = [None] * len(ws) if whats is None else whats
    want = [ref.fused_update_ref(
        w, v, g, what_dtype=None if wh is None else wh.dtype, **kw)
        for w, v, g, wh in zip(ws, vs, gs, whats_l)]
    ops.fused_update(ws, vs, gs, whats=whats, **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for i, (w2, v2, wh2) in enumerate(want):
        pairs = [(ws[i], w2, FU_TOL["float32"]),
                 (vs[i], v2, FU_TOL["float32"])]
        if whats_l[i] is not None:
            pairs.append((whats_l[i], wh2, FU_TOL[
                "bfloat16" if whats_l[i].dtype == torch.bfloat16
                else "float32"]))
        for got, w, tol in pairs:
            d = float((got.float() - w.float()).abs().max())
            check(torch.allclose(got.float(), w.float(), atol=tol,
                                 rtol=tol),
                  f"fused_update {what}: tensor {i} max |d| {d:.3e} "
                  f"beyond {tol}")
            worst = max(worst, d)
    return worst


def fused_checks(torch, ops, ref) -> None:
    """One launch over a ragged group (one count not a multiple of the
    kernel's chunk), with and without ŵ, fp32 or bf16 g and ŵ.  (The
    main path's own groups are checked where they are timed.)"""
    phase("fused_update against its plain version on the card")
    shapes = [(4096, 1024), (8192 * 3 + 17,), (7,), (3, 1000, 5)]
    for g_dt, w_dt in ((torch.float32, None), (torch.float32, torch.float32),
                       (torch.bfloat16, torch.float32),
                       (torch.float32, torch.bfloat16)):
        g = torch.Generator(device="cuda").manual_seed(7)
        mk = lambda s, dt=torch.float32: torch.randn(
            s, generator=g, device="cuda").to(dt)
        ws = [mk(s) for s in shapes]
        vs = [mk(s) for s in shapes]
        gs = [mk(s, g_dt) for s in shapes]
        whats = (None if w_dt is None else
                 [torch.empty(s, device="cuda", dtype=w_dt) for s in shapes])
        err = fu_compare(torch, ops, ref, ws, vs, gs, whats,
                         f"g {g_dt} ŵ {w_dt}")
        print(f"  g {str(g_dt):<15} ŵ {str(w_dt):<15} ragged "
              f"{len(shapes)} tensors, one launch: max |d| {err:.3e}")


# ---------------------------------------------------------------------------
# the recurrences: rwkv6_scan and mamba2_scan

# the serving archs' full widths: rwkv6-7b h 64, hd 64; zamba2-1.2b
# h 64 (d_in 4096 / 64), p 64, n 64, g 1
SCAN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


class ScanCase:
    """One scan call in the model layout, with the decays drawn as the
    models draw them: rwkv6 w = exp(-exp(logw)), logw up to 4.2 (w down
    to ~1e-29); mamba2 decay = exp(-U(0, 11.5)) (down to ~1e-5); with
    ``zeros``, that share of the decays exactly 0 (a reset).  With
    ``pages`` (one per row), S0 is gathered from a buffer of
    ``n_pages + 1`` nonzero page states, as the decode wave gathers its
    rows' states (``Model.stage_decode``); rows may share a page."""

    def __init__(self, kind, name, b, s, h, d, dtype, n=None, g=1,
                 zeros=0.0, pages=None, n_pages=8):
        self.kind, self.name, self.b, self.s, self.h = kind, name, b, s, h
        self.d, self.n, self.g, self.dtype = d, n or d, g, dtype
        self.zeros = zeros
        self.pages, self.n_pages = pages, n_pages

    def variant(self) -> str:
        """The kernel the wrapper launches for this call."""
        if self.s == 1:
            return "decode"
        return "chunk" if self.s >= 64 else "step"

    def tensors(self, torch, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dt = getattr(torch, self.dtype)
        mk = lambda *sh, sc=1.0, d=torch.float32: (torch.randn(
            *sh, generator=g, device="cuda") * sc).to(d)
        uni = lambda *sh: torch.rand(*sh, generator=g, device="cuda")
        b, s, h, d = self.b, self.s, self.h, self.d
        reset = lambda x: (x.masked_fill(uni(*x.shape) < self.zeros, 0.0)
                           if self.zeros else x)
        if self.kind == "rwkv6":
            w = reset(torch.exp(-torch.exp(-3.0 + 7.2 * uni(b, s, h, d))))
            if self.pages is None:
                S0 = mk(b, h, d, d, sc=0.1)
            else:                   # the wave's gather: buf[i][pages]
                S0 = self.page_buffer(torch, seed)[self.page_index(torch)]
            return (mk(b, s, h, d, d=dt), mk(b, s, h, d, sc=0.3, d=dt),
                    mk(b, s, h, d, d=dt), w, mk(h, d, sc=0.3), S0)
        delta = torch.nn.functional.softplus(mk(b, s, h))
        decay = reset(torch.exp(-11.5 * uni(b, s, h)))
        # B and C as the model has them: strided views of one projection
        bc = mk(b, s, 2 * self.g * self.n, sc=0.5, d=dt)
        B, C = (t.reshape(b, s, self.g, self.n) for t in bc.chunk(2, -1))
        return (mk(b, s, h, d, d=dt), delta, decay, B, C,
                mk(b, h, d, self.n, sc=0.1))

    def page_buffer(self, torch, seed=0):
        """The page states the rows' S0 is gathered from: [n_pages + 1,
        h, d, n] fp32, nonzero, the last page the trash page."""
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        return torch.randn(self.n_pages + 1, self.h, self.d, self.n,
                           generator=g, device="cuda") * 0.1

    def page_index(self, torch):
        return torch.tensor(self.pages, dtype=torch.long, device="cuda")

    def plain(self, torch, ref, args):
        """The plain version (kernel layout) on the same inputs, back in
        the model layout: (y, S_T)."""
        tr = lambda t: t.transpose(1, 2)
        if self.kind == "rwkv6":
            r, k, v, w, u, S0 = args
            y, sT = ref.rwkv6_ref(tr(r), tr(k), tr(v), tr(w), u, S0)
            return tr(y).to(r.dtype), sT
        x, delta, decay, B, C, S0 = args
        rep = self.h // self.g
        per_head = lambda t: tr(t.repeat_interleave(rep, dim=2))
        y, sT = ref.mamba2_ref(tr(x), tr(delta), tr(decay), per_head(B),
                               per_head(C), S0)
        return tr(y), sT

    def recurrence_ms(self) -> float:
        """The fp32 recurrence's operations over the fp32 peak outside the
        tensor cores (``rwkv6_scan.recurrence_flops``: per step and state
        element 3 for the update and 2 for the read-out).  The operation
        bound of the stepwise and decode kernels, which run the
        recurrence itself."""
        from repro_torch.kernels import rwkv6_scan as r6
        flops = r6.recurrence_flops(self.b, self.s, self.h, self.d, self.n)
        return flops / PEAK_FLOPS["float32"] * 1e3

    def cost(self):
        """(FLOPs, bytes) of the call: its kernel module's ``cost()``, the
        formula the cost counter records."""
        from repro_torch.kernels import mamba2_scan as m2
        from repro_torch.kernels import rwkv6_scan as r6
        el = 2 if self.dtype == "bfloat16" else 4
        if self.kind == "rwkv6":
            return r6.cost(self.b, self.s, self.h, self.d, el=el)
        return m2.cost(self.b, self.s, self.h, self.d, self.n, self.g,
                       el=el)

    def bound(self):
        """(least ms, what bounds it), the larger of: bytes, every input
        read once and y, S_T written once, over HBM; and operations.  For
        the decode and stepwise kernels the operations are the fp32
        recurrence's (``recurrence_ms``).  For the chunked kernels (s >=
        64) they are the chunked form's tensor-core products over the
        TF32 peak, each counted once (not per 3xTF32 pass): rwkv6 per
        step and head 4 hd^2 (y and the state, sub-chunks of 16) + 32 hd
        (the diagonal scores times v); mamba2 per step and head 4 p n
        (C S^T, x^T B) + 128 p (the scores times x), and per step and B/C
        group 128 n (C B^T).  That form needs fewer operations than the
        recurrence, so the recurrence's count is no floor for it.  The
        formulas are the kernel modules' ``cost()``."""
        from repro_torch.kernels import rwkv6_scan as r6
        return bound_of(*self.cost(), r6.flops_type(self.s))


# the kernel function each scan variant launches, as the profiler names it
SCAN_SYMBOLS = {
    "rwkv6": {"decode": "wkv_decode_kernel", "step": "wkv_kernel",
              "chunk": "wkv_scores_kernel + wkv_chunk_kernel"},
    "mamba2": {"decode": "ssd_decode_kernel", "step": "ssd_kernel",
               "chunk": "ssd_scores_kernel + ssd_chunk_kernel"}}


def scan_fn(ops, case: ScanCase):
    return ops.rwkv6_scan if case.kind == "rwkv6" else ops.mamba2_scan


def scan_cases(kind: str) -> list:
    full = dict(h=64, d=64)            # both archs at full width, b 1
    cases = []
    for dt in ("float32", "bfloat16"):
        for name, s in (("decode s=1", 1), ("prefill s=12", 12),
                        ("ragged s=37", 37), ("full s=2048", 2048)):
            cases.append(ScanCase(kind, f"{name} {dt}", 1, s, dtype=dt,
                                  **full))
    # the chunked kernels' edges: one chunk, one chunk and a step, a
    # partial last chunk at b 2 with exact-zero decays; and decode at b 2
    cases += [
        ScanCase(kind, "chunk s=64 float32", 1, 64, dtype="float32", **full),
        ScanCase(kind, "chunk s=65 bfloat16", 1, 65, dtype="bfloat16",
                 **full),
        ScanCase(kind, "chunk s=200 b2 zeros float32", 2, 200,
                 dtype="float32", zeros=0.05, **full),
        ScanCase(kind, "chunk s=200 b2 zeros bfloat16", 2, 200,
                 dtype="bfloat16", zeros=0.05, **full),
        ScanCase(kind, "decode b2 zeros float32", 2, 1, dtype="float32",
                 zeros=0.05, **full)]
    # a tensor rank's call on the chunked kernels (phase 30)
    name, b, s, h, d = TP_SCAN
    cases += [ScanCase(kind, f"{name} {dt}", b, s, h, d, dt)
              for dt in ("float32", "bfloat16")]
    if kind == "rwkv6":
        # the decode wave's call: 8 rows, their states gathered from the
        # pages, the last two rows idle on the trash page (page 8)
        cases += [ScanCase(kind, f"wave decode b8 {dt}", 8, 1, dtype=dt,
                           pages=WAVE_PAGES, **full)
                  for dt in ("float32", "bfloat16")]
    if kind == "mamba2":
        cases.append(ScanCase(kind, "g=4 b2 h16 p32 n16 s=37 float32", 2,
                              37, 16, 32, "float32", n=16, g=4))
        cases.append(ScanCase(kind, "g=2 b1 h8 p16 n64 s=37 bfloat16", 1,
                              37, 8, 16, "bfloat16", n=64, g=2))
        cases.append(ScanCase(kind, "g=4 b2 h16 p32 n16 s=130 float32", 2,
                              130, 16, 32, "float32", n=16, g=4))
    return cases


def scan_checks(torch, ops, ref) -> dict:
    """Both scans' kernels against their plain versions on the card: y
    and S_T, fp32 and bf16, decode (s = 1) from a nonzero S0, prefill,
    ragged, s = 2048 at full width, the chunked kernels' edges (s = 64,
    65, 200 with b 2 and exact-zero decays), and mamba2 with g > 1; each
    call launches the variant its length routes it to."""
    errs = {}
    for kind in ("rwkv6", "mamba2"):
        phase(f"{kind}_scan against its plain version on the card")
        for i, case in enumerate(scan_cases(kind)):
            args = case.tensors(torch, seed=200 + i)
            before = ops.variant_counts()
            y, sT = scan_fn(ops, case)(*args)
            torch.cuda.synchronize()
            after = ops.variant_counts()
            got = {v: after[f"{kind}_scan_{v}"] - before[f"{kind}_scan_{v}"]
                   for v in ("decode", "chunk")}
            want = {v: int(case.variant() == v) for v in got}
            check(got == want, f"{kind} {case.name}: launched {got} of the "
                  f"decode and chunked kernels, expected {want}")
            y_r, sT_r = case.plain(torch, ref, args)
            e = {}
            for got, want, nm, tol in (
                    (y, y_r, "y", SCAN_TOL[case.dtype if case.kind ==
                                            "rwkv6" else "float32"]),
                    (sT, sT_r, "S_T", SCAN_TOL["float32"])):
                got, want = got.float(), want.float()
                check(bool(torch.isfinite(got).all()),
                      f"{kind} {case.name}: {nm} not finite")
                e[nm] = float((got - want).abs().max())
                check(torch.allclose(got, want, atol=tol, rtol=tol),
                      f"{kind} {case.name}: {nm} max |d| {e[nm]:.3e} beyond "
                      f"{tol}")
            errs[(kind, case.name)] = max(e.values())
            # the models' call: S_T written over S0 in place, bit for bit
            S_in = args[-1].clone()
            y_in, _ = scan_fn(ops, case)(*args[:-1], S_in, out=S_in)
            torch.cuda.synchronize()
            check(torch.equal(y_in, y) and torch.equal(S_in, sT),
                  f"{kind} {case.name}: out=S0 differs from a fresh S_T")
            if case.pages is not None:
                # the wave's scatter: buf[i][pages] = S_T; each page then
                # holds its row's S_T, the shared trash page in each
                # element one of its rows' (which write lands is left
                # open, element by element)
                buf = case.page_buffer(torch, seed=200 + i)
                buf[case.page_index(torch)] = S_in
                for p in set(case.pages):
                    rows = [r for r, q in enumerate(case.pages) if q == p]
                    hit = torch.zeros_like(buf[p], dtype=torch.bool)
                    for r in rows:
                        hit |= buf[p] == sT[r]
                    check(bool(hit.all()), f"{kind} {case.name}: page {p} "
                          f"after the scatter holds values of none of its "
                          f"rows' S_T {rows}")
            decays = args[3 if kind == "rwkv6" else 2]
            w_min = float(decays[decays > 0].min())
            n_zero = int((decays == 0).sum())
            print(f"  {case.name:<34} {case.variant():<6} max|d y| "
                  f"{e['y']:.3e}  max|d S_T| {e['S_T']:.3e}  (smallest "
                  f"decay {w_min:.2e}, {n_zero} exact zeros); in place: "
                  f"equal")
    return errs


def ssm_model_check(torch) -> None:
    """The port's rwkv6 and zamba2 models on the card (scan and flash
    kernels) against themselves on the CPU (plain versions), same
    weights, smoke size, fp32: prefill and three decode steps, logits
    and every state and KV leaf."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import Model
    for arch in ("rwkv6-7b", "zamba2-1.2b"):
        phase(f"{arch} on the card against the CPU, smoke size, fp32")
        cfg = smoke_config(get_config(arch)).replace(
            n_layers=4, compute_dtype="float32")
        if arch == "zamba2-1.2b":    # stages (3, 2): both branches of the
            cfg = cfg.replace(n_layers=5, mesh_plan=dataclasses.replace(
                cfg.mesh_plan, pipe=2))               # shared-block rule
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        p_gpu = _tree_to(p_cpu, "cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 9),
                             generator=torch.Generator().manual_seed(1))
        worst = 0.0
        with torch.inference_mode():
            l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 16)
            l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.cuda()}, 16)
            pairs = [(l_g, l_c)]
            for pos in range(9, 12):
                tok = toks[:, pos - 9:pos - 8]
                d_c, c_c = cpu.decode_step(p_cpu, c_c, tok, pos)
                d_g, c_g = gpu.decode_step(p_gpu, c_g, tok.cuda(), pos)
                pairs.append((d_g, d_c))
                pairs += [(c_g[grp][k], c_c[grp][k]) for grp in c_c
                          for k in c_c[grp]]
        for g_, c_ in pairs:
            d = float((g_.cpu().float() - c_.float()).abs().max())
            check(torch.allclose(g_.cpu().float(), c_.float(), atol=1e-4,
                                 rtol=1e-4),
                  f"{arch}: card and CPU differ by {d:.3e} (tol 1e-4)")
            worst = max(worst, d)
        print(f"  logits and every state leaf, prefill + 3 decode steps: "
              f"max |d| {worst:.3e} (tol 1e-4)")


def scan_timings(torch, ops, ref, errs) -> dict:
    """Each scan variant at its main path's shape, bf16 inputs, full width
    (b 1, h 64, 64-wide state): decode (s = 1) beside a copy of the same 1
    MB state (the practical floor of that I/O), the stepwise kernel at s
    = 12, the chunked kernels at s = 2048; device ms, wall ms per call,
    the plain version's ms and the bound."""
    phase("timings of the scan kernels (CUDA events, after warm-up)")
    state = torch.randn(1, 64, 64, 64, device="cuda")
    dst = torch.empty_like(state)
    copy_ms, _ = time_ms(torch, lambda: dst.copy_(state), 500)
    print(f"  copy of the 1 MB fp32 state (dst.copy_(S), 1 MB read and 1 MB "
          f"written): {copy_ms:.5f} ms")
    rows = {}
    for kind in ("rwkv6", "mamba2"):
        rows[kind] = []
        for case, iters, plain_iters in (
                (ScanCase(kind, "decode s=1 bfloat16", 1, 1, 64, 64,
                          "bfloat16"), 500, 20),
                (ScanCase(kind, "prefill s=12 bfloat16", 1, 12, 64, 64,
                          "bfloat16"), 500, 10),
                (ScanCase(kind, "full s=2048 bfloat16", 1, 2048, 64, 64,
                          "bfloat16"), 20, 2),
                (ScanCase(kind, f"{TP_SCAN[0]} bfloat16", *TP_SCAN[1:],
                          "bfloat16"), 20, 2)):
            args = case.tensors(torch, seed=7)
            fn = scan_fn(ops, case)
            ms, wall = time_ms(torch, lambda: fn(*args), iters)
            plain_ms, _ = time_ms(torch, lambda: case.plain(torch, ref,
                                                            args),
                                  plain_iters)
            bound_ms, bound_by = case.bound()
            width = "hd 64" if kind == "rwkv6" else "p 64, n 64, g 1"
            row = {
                "shape": f"{case.name}, b {case.b}, h {case.h}, {width}",
                "variant": case.variant(),
                "kernel": SCAN_SYMBOLS[kind][case.variant()],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "max_abs_err": errs[(kind, case.name)],
                "wall_ms_per_call": wall}
            extra = ""
            if case.variant() == "decode":
                row["state_copy_ms"] = copy_ms
                extra = f"  {ms / copy_ms:.2f}x the state copy"
            elif case.variant() == "chunk":
                extra = (f"  (fp32 recurrence's operations: "
                         f"{case.recurrence_ms():.4f} ms)")
            if case.name.startswith(TP_SCAN[0]):
                rows[f"{kind} tensor rank"] = row
            else:
                rows[kind].append(row)
            print(f"  {kind}_scan {case.name:<22} {row['kernel']}: {ms:.4f} "
                  f"ms (wall {wall:.4f} ms per call)  bound {bound_ms:.5f} "
                  f"ms ({bound_by})  plain {plain_ms:.4f} ms  library: "
                  f"none{extra}")
    print("  library: none -- no single PyTorch call computes either "
          "recurrence (a data-dependent decay per step and state element)")
    return rows


# the long-prompt phase: full-width, full-depth rwkv6-7b and zamba2-1.2b
# serving prompts of 1024-2048 tokens through the chunked scans
LONG_PROMPT = dict(requests=3, rate=1.0, prompt_lens=(1024, 2048),
                   gen_lens=(1, 4), prompt_budget=2048, page_seq=2112,
                   seed=0)


def long_prompt(torch, ops, arch: str) -> dict:
    """``repro_torch.launch.serve.main`` on full ``arch`` with long
    prompts: every request served, finite logits, every request's prefill
    scans on the chunked kernels and every decode step's on the decode
    kernels, and each request's time to first token; then
    :func:`long_prefill`."""
    lp = LONG_PROMPT
    phase(f"long prompt: repro_torch.launch.serve.main, full {arch}, bf16, "
          f"prompts {lp['prompt_lens'][0]}-{lp['prompt_lens'][1]}")
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.planner import serve_plan
    from repro_torch.serve import admissible, poisson_trace
    cfg = get_config(arch)
    per_call = per_call_launches(arch)
    scan = "rwkv6_scan" if cfg.ssm.kind == "rwkv6" else "mamba2_scan"
    trace = poisson_trace(lp["requests"], rate=lp["rate"], seed=lp["seed"],
                          prompt_lens=lp["prompt_lens"],
                          gen_lens=lp["gen_lens"], vocab=cfg.vocab_size)
    splan = serve_plan(cfg, n_stages=1, n_slots=1,
                       prompt_budget=lp["prompt_budget"],
                       page_seq=lp["page_seq"])
    live = [q for q in trace if admissible(q, splan)]
    check(len(live) == len(trace), "a long prompt was not admissible")
    want_prefill = 1 + len(live)                 # + the warm-up's one
    want_decode = 1 + sum(q.gen_len - 1 for q in live)
    pair = lambda lo_hi: f"{lo_hi[0]},{lo_hi[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "serve.jsonl"
        argv = ["--arch", arch, "--engine", "simple",
                "--requests", str(lp["requests"]),
                "--rate", str(lp["rate"]),
                "--prompt-lens", pair(lp["prompt_lens"]),
                "--gen-lens", pair(lp["gen_lens"]),
                "--prompt-budget", str(lp["prompt_budget"]),
                "--page-seq", str(lp["page_seq"]), "--seed", str(lp["seed"]),
                "--metrics-out", str(out)]
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        rc = serve.main(argv)
        torch.cuda.synchronize()
        counts, variants = ops.launch_counts(), ops.variant_counts()
        recs = [json.loads(x) for x in out.read_text().splitlines()]
    check(rc == 0, f"serve.main returned {rc}")
    run = [r for r in recs if r["event"] == "serve_run"][-1]
    summary = [r for r in recs if r["event"] == "summary"][-1]
    n_pf = summary["gauges"]["serve/prefill_calls"]
    n_dec = summary["gauges"]["serve/decode_calls"]
    check(run["n_served"] == len(live), "not every long prompt was served")
    check(summary["counters"].get("serve/nonfinite_logits", 0) == 0,
          "non-finite logits")
    check((n_pf, n_dec) == (want_prefill, want_decode),
          f"engine made {n_pf} + {n_dec} calls, expected {want_prefill} + "
          f"{want_decode}")
    want = {name: per_call.get(name, 0) * (want_prefill + want_decode)
            for name in counts}
    check(counts == want, f"the run launched {counts}, expected {want}")
    # every request's prefill on the chunked kernels; the decode steps and
    # the warm-up's one-token prefill on the decode kernel
    L = per_call[scan]
    got = (variants[f"{scan}_chunk"], variants[f"{scan}_decode"])
    exp = (L * (want_prefill - 1), L * (want_decode + 1))
    check(got == exp, f"{scan} chunked, decode launches {got}, expected "
          f"{exp}")
    print(f"  {scan}: {got[0]} chunked launches = {L} x {len(live)} "
          f"prefills, {got[1]} decode launches = {L} x ({want_decode} "
          f"decode steps + the warm-up's one-token prefill)")
    ttft = [(r["prompt_len"], r["ttft_ms"]) for r in recs
            if r["event"] == "serve_request"]
    check(len(ttft) == len(live) and all(math.isfinite(t) and t > 0
                                         for _, t in ttft),
          f"time to first token not reported for every request: {ttft}")
    for n, t in ttft:
        print(f"  request of {n} tokens: time to first token {t:.3f} ms")
    return {"ttft_ms": ttft, "launches": counts, "variants": variants,
            **long_prefill(torch, arch)}


def long_prefill(torch, arch: str) -> dict:
    """One prefill of the long-prompt trace's longest prompt on full
    ``arch``, bf16, random weights: timed (wall, the median of 3 after a
    warm-up) and profiled (device busy, the scans' share).  It calls only
    ``Model`` and the serving trace, so it also times another commit of
    the port imported in its place."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import poisson_trace
    lp = LONG_PROMPT
    cfg = get_config(arch)
    trace = poisson_trace(lp["requests"], rate=lp["rate"], seed=lp["seed"],
                          prompt_lens=lp["prompt_lens"],
                          gen_lens=lp["gen_lens"], vocab=cfg.vocab_size)
    req = max(trace, key=lambda q: len(q.prompt))
    longest = len(req.prompt)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg.compute_dtype)
    prompt = torch.tensor(list(req.prompt), device="cuda")[None]
    walls = []
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = model.prefill(params, {"tokens": prompt},
                                      lp["page_seq"])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        with device_profile() as prof:
            model.prefill(params, {"tokens": prompt}, lp["page_seq"])
            torch.cuda.synchronize()
    del params, model, logits
    gc.collect()
    torch.cuda.empty_cache()
    wall_ms = sorted(walls[1:])[1]
    kern = device_kernels(prof)
    check(bool(kern), "the profiler saw no device activity in the prefill")
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    stem = "wkv_" if cfg.ssm.kind == "rwkv6" else "ssd_"
    scan_kern = [e for e in kern if stem in e.key]
    scan_ms = sum(e.self_device_time_total for e in scan_kern) / 1e3
    print(f"  one prefill of {longest} tokens: wall {wall_ms:.3f} ms (median "
          f"of 3), device busy {busy_ms:.3f} ms, of which the scans "
          f"{scan_ms:.3f} ms ({sum(e.count for e in scan_kern)} kernels: "
          f"{sorted({e.key[:40] for e in scan_kern})})")
    return {"prefill_tokens": longest, "prefill_wall_ms": wall_ms,
            "prefill_busy_ms": busy_ms, "prefill_scan_ms": scan_ms}


# ---------------------------------------------------------------------------
# the pipelined engine: the paged decode wave and continuous batching

# the full-width pipelined run: the launcher's flags (pipe 4, 8 slots and
# pages, 2 prefill lanes, 16-token prompt budget, 64-position pages) and
# one seeded Poisson trace both engines serve
PIPE_ARCHS = ("granite-8b", "rwkv6-7b")
PIPE_PLAN = dict(n_stages=4, n_slots=8, max_prefill=2, prompt_budget=16,
                 n_pages=8, page_seq=64)
PIPE_TRACE = dict(n_requests=24, rate=2.0, seed=0, prompt_lens=(2, 12),
                  gen_lens=(8, 24))
# the depth of the pipelined and MPMD serving runs of phases 13, 17 and
# 24 (0: full): half of granite-8b's 36, rwkv6-7b's 32 and minicpm3-4b's
# 62 layers, which keeps the whole script inside its time with phase 25
# (their rounds are host-bound, so their walls scale with the layers)
PIPE_DEPTH = {"granite-8b": 18, "rwkv6-7b": 16, "minicpm3-4b": 16}
PIPE_ARGV = ["--engine", "pipelined", "--pipe", "4", "--slots", "8",
             "--pages", "8", "--max-prefill", "2", "--prompt-budget", "16",
             "--page-seq", "64", "--requests", "24", "--rate", "2.0",
             "--prompt-lens", "2,12", "--gen-lens", "8,24", "--seed", "0"]
# the wave's attention row: granite-8b's heads, R = 8 rows at ragged
# lengths <= 64 on pages 0-7 of 9
WAVE_LENS = (64, 40, 17, 1, 64, 9, 33, 2)
# the rwkv6 wave's scan rows: pages 0-5 live, two idle rows on the trash
# page 8 of 9
WAVE_PAGES = (0, 1, 2, 3, 4, 5, 8, 8)
# the full-width wave against SimpleEngine's steps from the same page
# states: the wave may stray from the steps at most this many times as
# far as the steps stray from the same steps in fp32 (bf16 rounding)
WAVE_STEP_FACTOR = 4.0


class PagedCase:
    """One paged flash forward call (the decode wave): q [R, 1, H, d]
    against pages [n_pages + 1, page_seq, KV, d | dv], row r at length
    ``lens[r]`` on page ``pages[r]``."""

    def __init__(self, name, H, KV, d, dtype, lens, pages, n_pages=8,
                 page_seq=64, dv=None):
        self.name, self.H, self.KV, self.d = name, H, KV, d
        self.dv = d if dv is None else dv
        self.dtype, self.lens, self.pages = dtype, list(lens), list(pages)
        self.R, self.n_pages, self.page_seq = len(lens), n_pages, page_seq

    def tensors(self, torch, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dt = getattr(torch, self.dtype)
        mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dt)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
        return (mk(self.R, 1, self.H, self.d),
                mk(self.n_pages + 1, self.page_seq, self.KV, self.d),
                mk(self.n_pages + 1, self.page_seq, self.KV, self.dv),
                i32(self.pages), i32(self.lens))

    def bound(self):
        """(least ms, what bounds it): q, each page's keys and values up
        to the longest length a row reads there (a page that rows share
        read once), o and lse; QK^T and PV over the rows' lengths
        (``flash_attention.paged_cost``)."""
        from repro_torch.kernels import flash_attention as fa
        return bound_of(*fa.paged_cost(
            self.H, self.KV, self.d, self.dv, self.lens, self.pages,
            el=2 if self.dtype == "bfloat16" else 4), self.dtype)


def paged_cases() -> list:
    """R in {1, 3, 8} at lengths 1, 17 and 64 mixed, the last two rows
    of R >= 3 on the trash page; granite's heads (d 128) and zamba2's
    (d 64); fp32 and bf16; and the waves' rows (granite-8b's heads,
    then G 48 and G 12 in fp32 and bf16)."""
    cases = []
    for heads, tag in (((32, 8, 128), "d128"), (ZAMBA2_ATTN, "d64")):
        for R in (1, 3, 8):
            pages = list(range(R))
            if R >= 3:
                pages[-2:] = [8, 8]
            lens = [(1, 17, 64)[r % 3] for r in range(R)]
            for dt in ("float32", "bfloat16"):
                cases.append(PagedCase(f"paged R={R} {tag} {dt}", *heads,
                                       dt, lens, pages))
    cases.append(PagedCase("wave R=8 ragged bfloat16", 32, 8, 128,
                           "bfloat16", WAVE_LENS, range(8)))
    for tag, heads in WIDE_GQA:       # the code models' waves
        for dt in ("float32", "bfloat16"):
            cases.append(PagedCase(f"wave R=8 {tag} ragged {dt}", *heads,
                                   dt, WAVE_LENS, WAVE_PAGES))
    return cases


def paged_checks(torch, fa, ref) -> dict:
    """The paged rows of both forward kernels against the plain version
    on the card (2e-5 fp32 on the FMA kernel, 2e-2 bf16 on the
    tensor-core kernel), one launch a call of the dtype's variant."""
    phase("flash_fwd paged rows (the decode wave) against the plain "
          "version on the card")
    return {case.name: paged_compare(torch, fa, ref, case, seed=300 + i)
            for i, case in enumerate(paged_cases())}


def paged_compare(torch, fa, ref, case: PagedCase, seed=0) -> float:
    """One paged call against the plain version on the same card inputs,
    one launch of the dtype's variant; returns max |d o|."""
    args = case.tensors(torch, seed=seed)
    before = (fa.launches, fa.launches_mma)
    o, lse = fa.flash_fwd_paged(*args)
    torch.cuda.synchronize()
    mma = int(case.dtype == "bfloat16")
    check((fa.launches, fa.launches_mma) ==
          (before[0] + 1, before[1] + mma),
          f"{case.name}: not one launch of the "
          f"{'tensor-core' if mma else 'FMA'} kernel")
    o_r, lse_r = ref.flash_fwd_paged_ref(*args)
    tol = TOL[case.dtype]
    e = {}
    for got, want, nm in ((o.float(), o_r.float(), "o"),
                          (lse, lse_r, "lse")):
        check(bool(torch.isfinite(got).all()),
              f"{case.name}: {nm} not finite")
        e[nm] = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=tol, rtol=tol),
              f"{case.name}: {nm} max |d| {e[nm]:.3e} beyond {tol}")
    print(f"  {case.name:<30} lens {case.lens} pages {case.pages}: "
          f"max|d o| {e['o']:.3e}  max|d lse| {e['lse']:.3e}  (tol "
          f"{tol:g})")
    return e["o"]


def pipelined_check(torch) -> None:
    """The pipelined engine on the card against the CPU at the smoke
    size in fp32 (granite 4 layers, KV 2; rwkv6 4 layers; pipe 2):
    equal tokens, a clean request trace, one flash_fwd or rwkv6_scan a
    layer for each wave and each prefill lane."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.planner import serve_plan
    from repro_torch.planner import verify as pv
    from repro_torch.serve import ServeEngine, poisson_trace
    for arch in PIPE_ARCHS:
        phase(f"pipelined engine, {arch}: the card against the CPU, smoke "
              f"size, fp32, pipe 2")
        cfg = smoke_config(get_config(arch)).replace(
            n_layers=4, compute_dtype="float32")
        if cfg.ssm is None:
            cfg = cfg.replace(n_kv_heads=2)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        splan = serve_plan(cfg, n_stages=2, n_slots=4, max_prefill=2,
                           prompt_budget=8, page_seq=32)
        trace = poisson_trace(10, rate=1.5, seed=0, prompt_lens=(1, 8),
                              vocab=cfg.vocab_size)
        want = ServeEngine(cpu, p_cpu, splan).run(trace)
        eng = ServeEngine(gpu, _tree_to(p_cpu, "cuda"), splan)
        name = "flash_fwd" if cfg.ssm is None else "rwkv6_scan"
        before = ops.launch_counts()[name]
        got = eng.run(trace)
        torch.cuda.synchronize()
        n = ops.launch_counts()[name] - before
        rep = pv.verify_request_trace(eng.last_events, n_slots=4,
                                      n_pages=4, n_stages=2)
        print(f"  tokens equal on card and CPU: {got == want}; request "
              f"trace clean: {rep.ok}; {n} {name} launches = "
              f"{cfg.n_layers} x ({eng.n_waves} waves + {eng.n_lanes} "
              f"lanes)")
        check(got == want, f"{arch}: pipelined tokens differ between the "
              f"card and the CPU")
        check(rep.ok, f"{arch}: request trace: {rep.violations[:3]}")
        check(n == cfg.n_layers * (eng.n_waves + eng.n_lanes),
              f"{arch}: {n} {name} launches, expected "
              f"{cfg.n_layers} x ({eng.n_waves} + {eng.n_lanes})")


def _steady_round(eng, n_pages: int, pos: int = 40) -> dict:
    """A decode round with every slot live (page i, position ``pos``) and
    no prefill lane."""
    import numpy as np
    R = eng.splan.n_slots
    F = max(eng.splan.max_prefill, 1)
    return {"dec_tokens": np.arange(1, R + 1, dtype=np.int32),
            "dec_pos": np.full((R,), pos, np.int32),
            "dec_pages": np.arange(R, dtype=np.int32) % n_pages,
            "pf_tokens": np.zeros((F, eng.splan.prompt_budget), np.int32),
            "pf_len": np.zeros((F,), np.int32),
            "pf_pages": np.full((F,), n_pages, np.int32)}


def wave_against_steps(torch, eng, simple) -> dict:
    """One full-width decode wave (8 live rows on pages 0-7, ragged
    positions) against SimpleEngine's decode step taken row by row from
    the same page states: the logits and each row's state after the step
    (rwkv6 x_tm, x_cm, S; dense the page's keys and values).  Both are
    also held against the same steps in fp32 (the bf16 weights upcast),
    which measures bf16 rounding: the wave must stay within
    ``WAVE_STEP_FACTOR`` times the steps' own distance from fp32.  The
    engine's own round from the same states must then emit the wave's
    argmax and leave the pages bit for bit as the wave did."""
    import numpy as np
    from repro_torch.models import Model
    model, splan, dev = eng.model, eng.splan, eng.device
    cfg, vocab, C = model.cfg, model.cfg.vocab_size, len(eng._caches)
    R = splan.n_slots
    batch = _steady_round(eng, splan.n_pages)
    batch["dec_tokens"] = toks = np.random.default_rng(0).integers(
        0, vocab, R).astype(np.int32)
    batch["dec_pos"] = pos = np.array([n - 1 for n in WAVE_LENS],
                                      np.int32)[:R]
    pages = batch["dec_pages"]
    snap = [{k: a.clone() for k, a in c["layers"].items()}
            for c in eng._caches]

    def restore():
        for c, sn in zip(eng._caches, snap):
            for k, a in c["layers"].items():
                a.copy_(sn[k])

    pidx = torch.as_tensor(pages, dtype=torch.long, device=dev)

    def rows_state(layers):        # {k: [R, L, ...]} the rows' pages
        return {k: torch.cat([c[k][:, pidx] for c in layers], 0)
                .transpose(0, 1) for k in layers[0]}

    with torch.inference_mode():
        t = lambda a, dt=torch.int32: torch.tensor(a, dtype=dt,
                                                   device=dev)
        pos_t, pages_t = t(pos), t(pages)
        x = model.decode_embed(eng._outer, t(toks, torch.long)[:, None],
                               pos_t[:, None])
        for q in range(C):
            x = model.stage_decode(eng._chunks[q], eng._caches[q], x,
                                   pos_t, pages_t)
        wave = model.logits(eng._outer, x)[:, 0, :vocab].float()
        wave_st = rows_state([c["layers"] for c in eng._caches])
        restore()
        dec_next, _, _ = eng._round(batch)
        round_st = rows_state([c["layers"] for c in eng._caches])
        restore()
        m32 = Model(cfg.replace(compute_dtype="float32"), device=dev)
        steps = {"bf16": ([], []), "fp32": ([], [])}
        for r in range(R):
            p = int(pages[r])
            one = {k: torch.cat([sn[k][:, p:p + 1] for sn in snap], 0)
                   for k in snap[0]}
            for tag in steps:
                cache = {"layers": {k: (a.clone() if tag == "bf16"
                                        else a.float())
                                    for k, a in one.items()}}
                if tag == "bf16":
                    logits, cache = simple._decode(cache, int(toks[r]),
                                                   int(pos[r]))
                else:
                    logits, cache = m32.decode_step(
                        simple.params, cache, t([[toks[r]]], torch.long),
                        int(pos[r]))
                steps[tag][0].append(logits[0, -1, :vocab].float())
                steps[tag][1].append({k: a[:, 0] for k, a in
                                      cache["layers"].items()})
    lg = {tag: torch.stack(v[0]) for tag, v in steps.items()}
    st = {tag: {k: torch.stack([d[k] for d in v[1]]).float()
                for k in v[1][0]} for tag, v in steps.items()}
    wave_f = {k: a.float() for k, a in wave_st.items()}
    check(bool(torch.isfinite(wave).all()), "wave logits not finite")
    check(np.array_equal(dec_next, wave.argmax(-1).cpu().numpy()),
          "the engine's round emitted other tokens than the wave's argmax")
    check(all(torch.equal(round_st[k], wave_st[k]) for k in wave_st),
          "the engine's round left other page states than the wave")
    dist = lambda a, b: float((a - b).abs().max())
    out = {}
    for what, w, s16, s32 in (
            [("logits", wave, lg["bf16"], lg["fp32"])]
            + [(k, wave_f[k], st["bf16"][k], st["fp32"][k])
               for k in wave_f]):
        e_ws, e_sf, e_wf = dist(w, s16), dist(s16, s32), dist(w, s32)
        out[what] = {"wave_step": e_ws, "step_fp32": e_sf,
                     "wave_fp32": e_wf, "scale": float(s32.abs().max())}
        print(f"  wave vs steps, {what:<7}: max|wave - step| {e_ws:.3e}, "
              f"max|step - fp32| {e_sf:.3e}, max|wave - fp32| {e_wf:.3e} "
              f"(max|fp32| {out[what]['scale']:.3e})")
        check(e_ws <= WAVE_STEP_FACTOR * e_sf, f"wave {what}: max|wave - "
              f"step| {e_ws:.3e} beyond {WAVE_STEP_FACTOR} x the steps' "
              f"bf16 rounding {e_sf:.3e}")
    top2 = lg["fp32"].topk(2, -1).values
    am = {tag: a.argmax(-1) for tag, a in
          (("wave", wave), ("step", lg["bf16"]), ("fp32", lg["fp32"]))}
    out["argmax_equal"] = {
        "wave_step": int((am["wave"] == am["step"]).sum()),
        "step_fp32": int((am["step"] == am["fp32"]).sum()),
        "wave_fp32": int((am["wave"] == am["fp32"]).sum()), "rows": R}
    out["fp32_top2_margin"] = [float(m) for m in top2[:, 0] - top2[:, 1]]
    print(f"  argmax equal over {R} rows: wave/step "
          f"{out['argmax_equal']['wave_step']}, step/fp32 "
          f"{out['argmax_equal']['step_fp32']}, wave/fp32 "
          f"{out['argmax_equal']['wave_fp32']}; fp32 top-2 margins "
          f"{[round(m, 4) for m in out['fp32_top2_margin']]}")
    return out


def _depth_argv(arch: str) -> list:
    """``--layers`` for ``arch``'s pipelined and MPMD serving runs
    (``PIPE_DEPTH``), or nothing at full depth."""
    n = PIPE_DEPTH.get(arch, 0)
    return ["--layers", str(n)] if n else []


def _depth(arch: str) -> str:
    from repro_torch.configs import get_config
    n = PIPE_DEPTH.get(arch, 0)
    return f"{n} of {get_config(arch).n_layers} layers" if n else "full"


def _pipelined_run(torch, ops, arch: str) -> dict:
    """``repro_torch.launch.serve.main --engine pipelined`` on ``arch``
    (at ``PIPE_DEPTH``) with ``PIPE_ARGV`` over ``PIPE_TRACE``:
    every admissible request gets its tokens, no non-finite logit in a
    live row, the request trace verifies, and every round launches
    exactly L ``flash_fwd`` (or ``rwkv6_scan``) for its wave and L a
    prefill lane, bf16 attention on the tensor cores.  Returns the
    engine (holding the weights) and the run's records."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.planner import serve_plan
    from repro_torch.planner import verify as pv
    from repro_torch.serve import admissible, poisson_trace
    cfg = get_config(arch)
    if PIPE_DEPTH.get(arch):
        cfg = cfg.replace(n_layers=PIPE_DEPTH[arch])
    L = cfg.n_layers
    name = "flash_fwd" if cfg.ssm is None else "rwkv6_scan"
    tr = dict(PIPE_TRACE)
    trace = poisson_trace(tr.pop("n_requests"), vocab=cfg.vocab_size, **tr)
    splan = serve_plan(cfg, **PIPE_PLAN)
    live = [q for q in trace if admissible(q, splan)]
    held = {}

    class Recording(serve.ServeEngine):
        """The launcher's engine, kept for the comparison and the
        profile, with each round's launches recorded."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rounds = []
            held["engine"] = self
            torch.cuda.synchronize()
            held["init_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

        def _round(self, batch):
            c0, v0 = ops.launch_counts(), ops.variant_counts()
            out = super()._round(batch)
            c1, v1 = ops.launch_counts(), ops.variant_counts()
            self.rounds.append({
                "wave": bool((batch["dec_pages"] < splan.n_pages).any()),
                "lanes": [int(n) for n in batch["pf_len"] if n > 0],
                "launches": {k: c1[k] - c0[k] for k in c1},
                "variants": {k: v1[k] - v0[k] for k in v1}})
            return out

        def run(self, *a, **k):
            held["results"] = super().run(*a, **k)
            return held["results"]

    gc.collect()
    torch.cuda.empty_cache()
    orig = serve.ServeEngine
    serve.ServeEngine = Recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "serve.jsonl"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            rc = serve.main(["--arch", arch, *PIPE_ARGV, *_depth_argv(arch),
                             "--metrics-out", str(out)])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            variants = ops.variant_counts()
            peak = torch.cuda.max_memory_allocated()
            recs = [json.loads(x) for x in out.read_text().splitlines()]
    finally:
        serve.ServeEngine = orig
    check(rc == 0, f"serve.main returned {rc}")
    eng, results = held["engine"], held["results"]
    run = [r for r in recs if r["event"] == "serve_run"][-1]
    summary = [r for r in recs if r["event"] == "summary"][-1]
    gauges, counters = summary["gauges"], summary["counters"]
    check(run["engine"] == "pipelined", "the launcher did not serve "
          "through the pipelined engine")
    check(run["n_served"] == len(live) and all(
        len(results[q.rid]) == q.gen_len for q in live),
        "an admissible request did not get its gen_len tokens")
    check(counters.get("serve/nonfinite_logits", 0) == 0,
          "non-finite logits in a live row")
    rep = pv.verify_request_trace(eng.last_events, n_slots=splan.n_slots,
                                  n_pages=splan.n_pages,
                                  n_stages=splan.n_stages)
    check(rep.ok, f"request trace: {rep.violations[:3]}")
    # every round: L launches for the wave (when a slot is live) and L a
    # lane, nothing else; bf16 attention on the tensor cores, the wave's
    # scans (and a one-token lane's) on the decode kernel
    for i, rd in enumerate(eng.rounds):
        n_calls = int(rd["wave"]) + len(rd["lanes"])
        want = {k: 0 for k in rd["launches"]}
        want[name] = L * n_calls
        check(rd["launches"] == want, f"round {i}: launched "
              f"{rd['launches']}, expected {want}")
        want_v = {k: 0 for k in rd["variants"]}
        if name == "flash_fwd":
            want_v["flash_fwd_mma"] = L * n_calls
        else:
            want_v["rwkv6_scan_decode"] = L * (
                int(rd["wave"]) + sum(n == 1 for n in rd["lanes"]))
        check(rd["variants"] == want_v, f"round {i}: variants "
              f"{rd['variants']}, expected {want_v}")
    ev = eng.last_events
    waves = 1 + len({e["round"] for e in ev if e["ev"] == "decode"})
    lanes = 1 + sum(e["ev"] == "admit" for e in ev)
    check((eng.n_waves, eng.n_lanes) == (waves, lanes)
          == (gauges["serve/wave_calls"], gauges["serve/lane_calls"])
          == (sum(rd["wave"] for rd in eng.rounds),
              sum(len(rd["lanes"]) for rd in eng.rounds)),
          f"waves/lanes {eng.n_waves}/{eng.n_lanes}, event log "
          f"{waves}/{lanes} (warm-up included)")
    check(counts[name] == L * (waves + lanes),
          f"{counts[name]} {name} launches, expected {L} x ({waves} + "
          f"{lanes})")
    rounds_run = len(eng.rounds) - 1
    tok_per_s = gauges["serve/decode_tok_per_s"]
    print(f"  served {run['n_served']}/{run['n_requests']} requests, "
          f"{run['n_tokens']} tokens in {rounds_run} rounds ({waves - 1} "
          f"waves, {lanes - 1} prefill lanes); request trace clean")
    print(f"  {counts[name]} {name} launches = {L} x ({waves} + {lanes}) "
          f"(warm-up round included); variants {variants}")
    print(f"  pipelined: {tok_per_s:.2f} tok/s over the rounds' wall "
          f"({run['tok_per_s']:.2f} with the launcher's wall, warm-up "
          f"included), p50 {run['token_ms_p50']:.3f} ms/token, p99 "
          f"{run['token_ms_p99']:.3f}; warm-up {run['compile_s']:.2f}s; "
          f"peak {peak / 2**30:.2f} GiB serving (weights, pages, "
          f"activations), {held['init_peak'] / 2**30:.2f} GiB while the "
          f"launcher drew the weights")

    return {"cfg": cfg, "L": L, "name": name, "trace": trace,
            "splan": splan, "live": live, "engine": eng,
            "results": results, "run": run, "gauges": gauges,
            "counts": counts, "variants": variants, "peak": peak,
            "waves": waves, "lanes": lanes, "rounds_run": rounds_run,
            "tok_per_s": tok_per_s, "init_peak": held["init_peak"]}


def pipelined_path(torch, ops, arch: str) -> dict:
    """``repro_torch.launch.serve.main --engine pipelined`` on full
    ``arch`` (pipe 4, 8 slots and pages, bf16, random weights from seed
    0) over one Poisson trace of 24 requests, then ``SimpleEngine`` with
    the same weights on the same trace; a steady decode round profiled;
    the page writes and the rwkv6 state gather/scatter timed alone."""
    phase(f"pipelined serving: repro_torch.launch.serve.main --engine "
          f"pipelined, {_depth(arch)} {arch}, bf16")
    from repro_torch.obs import MetricsRegistry
    from repro_torch.planner import serve_plan
    from repro_torch.serve import SimpleEngine
    r = _pipelined_run(torch, ops, arch)
    cfg, L, name, trace, splan = (r["cfg"], r["L"], r["name"], r["trace"],
                                  r["splan"])
    live, eng, results, run = r["live"], r["engine"], r["results"], r["run"]
    counts, variants, peak = r["counts"], r["variants"], r["peak"]
    waves, lanes, rounds_run = r["waves"], r["lanes"], r["rounds_run"]
    tok_per_s, held = r["tok_per_s"], {"init_peak": r["init_peak"]}
    del r

    # SimpleEngine with the same weights (no copy) on the same trace
    reg = MetricsRegistry()
    simple = SimpleEngine(eng.model, {"outer": eng._outer,
                                      "stages": eng._chunks},
                          serve_plan(cfg, n_stages=1, n_slots=1,
                                     max_prefill=1, prompt_budget=16,
                                     page_seq=64, validate=False),
                          registry=reg)
    simple._warm_up()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_res = simple.run(trace)
    s_wall = time.perf_counter() - t0
    s_tokens = sum(len(t) for t in s_res.values())
    s_hist = reg.histogram("serve/token_ms")
    check(reg.counter("serve/nonfinite_logits").value == 0,
          "SimpleEngine: non-finite logits")
    first = [s_res[q.rid][0] == results[q.rid][0] for q in live]
    whole = [s_res[q.rid] == results[q.rid] for q in live]
    # where each request's two sequences part (the token index)
    parts = sorted(next((i for i, (a, b) in enumerate(zip(
        s_res[q.rid], results[q.rid])) if a != b), None)
        for q in live if s_res[q.rid] != results[q.rid])
    simple_tok_s = s_tokens / s_wall
    # the pipelined engine timed as SimpleEngine is: run(trace) after its
    # warm-up, by the wall clock around the call (bench/serve.py's window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.run(trace)
    p_wall = time.perf_counter() - t0
    p_tok_s = sum(len(t) for t in again.values()) / p_wall
    check(again == results, "a second pipelined run of the trace emitted "
          "other tokens than the first")
    print(f"  SimpleEngine, same weights and trace: {simple_tok_s:.2f} "
          f"tok/s over run()'s wall ({s_wall:.3f} s), p50 "
          f"{s_hist.percentile(50.0):.3f} ms/token, p99 "
          f"{s_hist.percentile(99.0):.3f}")
    print(f"  pipelined, the same window (run()'s wall after warm-up): "
          f"{p_tok_s:.2f} tok/s ({p_wall:.3f} s; the same tokens again); "
          f"pipelined / simple {p_tok_s / simple_tok_s:.2f}x")
    print(f"  first tokens equal to SimpleEngine's: {sum(first)}/"
          f"{len(first)}; whole sequences equal: {sum(whole)}/{len(whole)} "
          f"(not gated: bf16 GEMMs at M = 8 and M = 1 round apart); the "
          f"others part at token {parts}")
    check(all(first), "a request's first token differs from "
          "SimpleEngine's (same kernels on the same prefill shapes)")
    wave_cmp = wave_against_steps(torch, eng, simple)

    # one steady decode round: every slot live, no prefill lane
    batch = _steady_round(eng, splan.n_pages)
    with torch.inference_mode():
        for _ in range(2):
            eng._round(batch)
        steps, prof_steps = 8, 2
        t = time.perf_counter()
        for _ in range(steps):
            eng._round(batch)
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
        # a profile short of the kernel's exact count (records dropped,
        # as decode_profile has seen) is taken again, at most 3 times
        for attempt in range(3):
            with device_profile() as prof:
                for _ in range(prof_steps):
                    eng._round(batch)
                torch.cuda.synchronize()
            kern = device_kernels(prof)
            hits = [e for e in kern if KERNEL_SYMBOL[name] in e.key]
            n_hit = sum(e.count for e in hits)
            check(n_hit <= L * prof_steps, f"the profiled rounds show "
                  f"{n_hit} {KERNEL_SYMBOL[name]}, expected "
                  f"{L * prof_steps}")
            if n_hit == L * prof_steps:
                break
            print(f"  profile {attempt + 1} incomplete: {n_hit} "
                  f"{KERNEL_SYMBOL[name]}; again")
    check(bool(kern), "the profiler saw no device activity in the rounds")
    check(n_hit == L * prof_steps, f"the profiled rounds show {n_hit} "
          f"{KERNEL_SYMBOL[name]}, expected {L * prof_steps}")
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / prof_steps
    n_kern = sum(e.count for e in kern) / prof_steps
    kernel_ms = sum(e.self_device_time_total for e in hits) / 1e3 / \
        prof_steps
    index_ms = sum(e.self_device_time_total for e in kern
                   if "index" in e.key.lower()) / 1e3 / prof_steps
    idle = 100 * (1 - busy_ms / wall_ms)
    print(f"  steady decode round (8 live slots, no lane): {wall_ms:.3f} "
          f"ms wall, {busy_ms:.3f} ms busy ({idle:.1f}% idle), "
          f"{n_kern:.1f} kernels; {KERNEL_SYMBOL[name]} "
          f"{kernel_ms:.4f} ms; indexing kernels {index_ms:.4f} ms")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:8]:
        print(f"    {e.self_device_time_total / 1e3 / prof_steps:8.4f} ms "
              f"{e.count / prof_steps:6.1f}x  {e.key[:72]}")
    # the wave's page traffic alone, one layer's worth, CUDA events
    bufs = eng._caches[0]["layers"]
    rows = torch.arange(splan.n_slots, device="cuda")
    with torch.inference_mode():
        if name == "flash_fwd":
            kx = torch.randn(splan.n_slots, cfg.n_kv_heads, cfg.hd,
                             device="cuda").to(bufs["k"].dtype)
            cols = torch.full_like(rows, 40)

            def writes():
                bufs["k"][0][rows, cols] = kx
                bufs["v"][0][rows, cols] = kx
            page_ms, _ = time_ms(torch, writes, 200)
            traffic = {"page writes (k and v)": page_ms * L}
        else:
            st = {k: b[0][rows] for k, b in bufs.items()}

            def gather():
                return {k: b[0][rows] for k, b in bufs.items()}

            def scatter():
                for k, b in bufs.items():
                    b[0][rows] = st[k]
            g_ms, _ = time_ms(torch, gather, 200)
            s_ms, _ = time_ms(torch, scatter, 200)
            traffic = {"state gather": g_ms * L, "state scatter": s_ms * L}
    for what, ms in traffic.items():
        print(f"  {what}: {ms:.4f} ms of device time a wave ({L} layers, "
              f"timed alone)")
    return {"launches": counts, "variants": variants, "run": run,
              "results": results, "layers": L,
              "tok_per_s": tok_per_s, "rounds": rounds_run,
              "waves": waves - 1, "lanes": lanes - 1, "peak_bytes": peak,
              "simple_tok_per_s": simple_tok_s,
              "simple_p50": s_hist.percentile(50.0),
              "simple_p99": s_hist.percentile(99.0),
              "first_equal": (sum(first), len(first)),
              "whole_equal": (sum(whole), len(whole)),
              "round_wall_ms": wall_ms, "round_busy_ms": busy_ms,
              "round_kernels": n_kern, "round_kernel_ms": kernel_ms,
              "round_index_ms": index_ms, "traffic_ms": traffic,
              "parts_at": parts, "wave_vs_steps": wave_cmp,
              "run_wall_s": p_wall, "run_tok_per_s": p_tok_s,
              "simple_wall_s": s_wall,
              "init_peak_bytes": held["init_peak"]}


def wave_timing(torch, fa, ref, errs) -> list:
    """The waves' attention rows (granite-8b's heads, then granite-20b's
    and starcoder2-15b's; R = 8, ragged lengths <= 64, bf16): the
    kernel, its plain version, its bound, and SDPA on the gathered pages
    with a boolean key mask (the gather untimed)."""
    return [_wave_row(torch, fa, ref, errs, case) for case in paged_cases()
            if case.name.startswith("wave") and case.dtype == "bfloat16"]


def _wave_row(torch, fa, ref, errs, case) -> dict:
    import torch.nn.functional as F
    q, kp, vp, pages, lens = case.tensors(torch, seed=7)
    # as the wave calls it: ranges checked on the host beforehand, so the
    # call does not read them back from the card
    ms, _ = time_ms(torch, lambda: fa.flash_fwd_paged(
        q, kp, vp, pages, lens, ranges_checked=True), 500)
    plain_ms, _ = time_ms(torch, lambda: ref.flash_fwd_paged_ref(
        q, kp, vp, pages, lens), 500)
    idx = pages.long()
    kt, vt = kp[idx].transpose(1, 2), vp[idx].transpose(1, 2)
    mask = (torch.arange(case.page_seq, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    o_lib = sdpa().transpose(1, 2)
    o_ker, _ = fa.flash_fwd_paged(q, kp, vp, pages, lens)
    check(torch.allclose(o_lib.float(), o_ker.float(), atol=2e-2,
                         rtol=2e-2), "SDPA with the key mask disagrees "
          "with the paged kernel")
    lib_ms, _ = time_ms(torch, sdpa, 500)
    bound_ms, bound_by = case.bound()
    row = {"shape": case.name, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
           "library": "SDPA on the gathered pages, boolean key mask",
           "max_abs_err": errs[case.name]}
    print(f"  {case.name:<28} kernel {ms:.4f} ms  bound "
          f"{bound_ms:.5f} ms ({bound_by})  plain {plain_ms:.4f} ms  "
          f"sdpa+mask {lib_ms:.4f} ms "
          f"({ms / lib_ms:.2f}x sdpa)")
    return row


# ---------------------------------------------------------------------------
# training


def train_check(torch) -> None:
    """The streaming SpecTrain tick on the card (kernels) against the same
    tick on the CPU (plain versions), smoke size, fp32, 4 stages."""
    S = TRAIN_STAGES
    n = 2 * (S - 1) + 3
    phase(f"training on the card against the CPU: {n} spectrain ticks, "
          f"{S} stages, smoke size, fp32")
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=4, n_kv_heads=2, compute_dtype="float32",
        mesh_plan=get_config(ARCH).mesh_plan)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    check(cpu.n_stages == S, "smoke model is not 4 stages")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _tree_to(p_cpu, "cuda")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    runs = {}
    for name, model, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        state = ps.make_state(model, params, batches[0], mode="spectrain")
        step = ps.make_train_step(model, mode="spectrain", lr=0.05)
        losses = []
        for b in batches:
            state, met = step(state, b)
            losses.append(float(met["loss"]))
        runs[name] = (state, losses)
    (s_c, l_c), (s_g, l_g) = runs["cpu"], runs["gpu"]
    l_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(l_g, l_c))
    check(l_err <= 1e-5, f"losses differ by rel {l_err:.3e} (tol 1e-5)")
    worst = 0.0
    for key in ("params", "momentum", "pred"):
        for g, c in zip(tree_leaves(s_g[key]), tree_leaves(s_c[key])):
            g = g.cpu()
            check(torch.allclose(g, c, rtol=1e-4, atol=1e-5),
                  f"{key} leaf differs by {float((g - c).abs().max())}")
            worst = max(worst, float((g - c).abs().max()))
    print(f"  losses max rel |d| {l_err:.3e} (tol 1e-5); params, momentum, "
          f"pred max |d| {worst:.3e} (rtol 1e-4 / atol 1e-5)")


# the archs of the MoE and code-model slice; the code models keep their
# published 48 heads over 1 and 4 KV heads in their smoke checks
NEW_ARCHS = ("deepseek-moe-16b", "grok-1-314b", "granite-20b",
             "starcoder2-15b")
CODE_HEADS = {"granite-20b": (48, 1), "starcoder2-15b": (48, 4)}


def new_arch_smoke_cfg(arch: str):
    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(get_config(arch)).replace(n_layers=4,
                                                 compute_dtype="float32")
    if arch in CODE_HEADS:
        H, KV = CODE_HEADS[arch]
        cfg = cfg.replace(n_heads=H, n_kv_heads=KV, head_dim=16)
    return cfg


def new_model_check(torch) -> None:
    """deepseek-moe-16b and grok-1-314b (and granite-20b and
    starcoder2-15b at their 48 heads over 1 and 4 KV heads) on the card
    against the CPU at the smoke size in fp32: prefill and three decode
    steps (logits and KV cache, 1e-4), SimpleEngine's tokens equal; for
    the MoE models 2(S-1)+3 streaming SpecTrain ticks on 4 stages
    (losses and aux losses to rel 1e-5, every params, momentum and
    prediction leaf to rtol 1e-4 / atol 1e-5)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.planner import serve_plan
    from repro_torch.serve import SimpleEngine, poisson_trace
    for arch in NEW_ARCHS:
        cfg = new_arch_smoke_cfg(arch)
        phase(f"{arch} on the card against the CPU, smoke size "
              f"({cfg.n_heads} heads over {cfg.n_kv_heads}), fp32")
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        p_gpu = _tree_to(p_cpu, "cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 9),
                             generator=torch.Generator().manual_seed(1))
        errs = []
        with torch.inference_mode():
            l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 16)
            l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.cuda()}, 16)
            errs.append(float((l_g.cpu() - l_c).abs().max()))
            for pos in range(9, 12):
                tok = toks[:, pos - 9:pos - 8]
                d_c, c_c = cpu.decode_step(p_cpu, c_c, tok, pos)
                d_g, c_g = gpu.decode_step(p_gpu, c_g, tok.cuda(), pos)
                errs.append(float((d_g.cpu() - d_c).abs().max()))
            errs.append(float((c_g["layers"]["k"].cpu()
                               - c_c["layers"]["k"]).abs().max()))
        err = max(errs)
        print(f"  prefill, 3 decode steps: logits and cache max |d| "
              f"{err:.3e} (tol 1e-4)")
        check(err <= 1e-4, f"{arch}: the card differs from the CPU by "
              f"{err}")
        splan = serve_plan(cfg, n_stages=1, n_slots=1, prompt_budget=8,
                           page_seq=32)
        trace = poisson_trace(6, rate=1.5, seed=0, prompt_lens=(2, 8),
                              vocab=cfg.vocab_size)
        t_c = SimpleEngine(cpu, p_cpu, splan).run(trace)
        t_g = SimpleEngine(gpu, p_gpu, splan).run(trace)
        print(f"  engine tokens equal on card and CPU: {t_c == t_g}")
        check(t_c == t_g, f"{arch}: engine tokens differ between the "
              f"card and the CPU")
        if cfg.moe is None:
            continue
        S = TRAIN_STAGES
        cfg = cfg.replace(mesh_plan=get_config(ARCH).mesh_plan)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        check(cpu.n_stages == S, "smoke model is not 4 stages")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        batches = []
        for _ in range(2 * (S - 1) + 3):
            t = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(
                np.int32)
            batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
        runs = {}
        for name, model, params in (("cpu", cpu, p_cpu),
                                    ("gpu", gpu, _tree_to(p_cpu, "cuda"))):
            state = ps.make_state(model, params, batches[0],
                                  mode="spectrain")
            step = ps.make_train_step(model, mode="spectrain", lr=0.05)
            mets = [step(state, b)[1] for b in batches]
            runs[name] = (state, [float(m["loss"]) for m in mets],
                          [float(m["aux"]) for m in mets])
        (s_c, l_c, a_c), (s_g, l_g, a_g) = runs["cpu"], runs["gpu"]
        rel = max(abs(a - b) / max(abs(b), 1e-12)
                  for a, b in zip(l_g + a_g, l_c + a_c))
        check(rel <= 1e-5, f"{arch}: losses or aux differ by rel {rel:.3e}")
        check(all(math.isfinite(a) and a > 0 for a in a_g),
              f"{arch}: aux losses {a_g}")
        worst = 0.0
        for key in ("params", "momentum", "pred"):
            for g, c in zip(tree_leaves(s_g[key]), tree_leaves(s_c[key])):
                g = g.cpu()
                check(torch.allclose(g, c, rtol=1e-4, atol=1e-5),
                      f"{arch}: {key} leaf differs by "
                      f"{float((g - c).abs().max())}")
                worst = max(worst, float((g - c).abs().max()))
        print(f"  {len(batches)} spectrain ticks on {S} stages: losses and "
              f"aux max rel |d| {rel:.3e} (tol 1e-5); aux "
              f"{[round(a, 5) for a in a_g]}; params, momentum, pred max "
              f"|d| {worst:.3e} (rtol 1e-4 / atol 1e-5)")


def train_main_path(torch, ops, arch: str = ARCH,
                    layers: int = TRAIN_LAYERS) -> dict:
    """``repro_torch.launch.train.main`` on full-width ``arch`` cut to
    ``layers`` in 4 stages (module docstring, phase 7); for an MoE model
    also every tick's aux loss finite, and every stage's router momentum
    zero before its first valid backward and non-zero at the end (its
    gradient reached it, the aux term included)."""
    S, L = TRAIN_STAGES, layers
    phase(f"main path: repro_torch.launch.train.main, {arch} full width, "
          f"{L} layers in {S} stages, bf16, spectrain, {TRAIN_STEPS} ticks")
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.layers import tree_leaves
    moe = get_config(arch).moe is not None
    argv = ["--arch", arch, "--layers", str(L), *TRAIN_ARGV[4:]]
    want_tick = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                 "fused_update": S + 1}
    # bf16: every forward, dq and dk/dv on the tensor-core kernels
    want_var = {"flash_fwd_mma": 2 * L, "flash_bwd_dq_mma": L,
                "flash_bwd_dkv_mma": L}
    # tick 7 profiled (8 or 9 if a profile comes up short)
    sp = StepProfile("train tick", want_tick, 7, TRAIN_STEPS - 1)
    rec = {"counts": [], "variants": [], "valid": [], "loss": [], "t": [],
           "t_end": [], "stage0": [], "aux": [], "router": []}
    snap = {}

    def on_step(s, state, metrics):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["counts"].append(dict(ops.launch_counts()))
        rec["variants"].append(dict(ops.variant_counts()))
        rec["valid"].append(metrics["loss_valid"])
        rec["loss"].append(float(metrics["loss"]))
        if moe:
            rec["aux"].append(float(metrics["aux"]))
            rec["router"].append([float(
                t["layers"]["moe"]["router"].abs().max())
                for t in state["momentum"]["stages"]])
        stage0 = tree_leaves(state["params"]["stages"][0])
        if s == 0:
            snap["stage0"] = [t.clone() for t in stage0]
        rec["stage0"].append(all(torch.equal(a, b) for a, b in
                                 zip(stage0, snap["stage0"])))
        sp.hook(s)
        rec["t_end"].append(time.perf_counter())

    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = train.main(argv, on_step=on_step)
    torch.cuda.synchronize()
    total = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del snap
    check(rc == 0, f"train.main returned {rc}")
    check(len(rec["loss"]) == TRAIN_STEPS, "not every tick ran")
    prev, prev_v = {k: 0 for k in want_tick}, {k: 0 for k in want_var}
    for s, (counts, var) in enumerate(zip(rec["counts"], rec["variants"])):
        got = {k: counts[k] - prev[k] for k in want_tick}
        check(got == want_tick, f"tick {s} launched {got}, expected "
              f"{want_tick}")
        got_v = {k: var[k] - prev_v[k] for k in want_var}
        check(got_v == want_var, f"tick {s} launched tensor-core "
              f"variants {got_v}, expected {want_var}")
        prev, prev_v = counts, var
    check(total == {k: want_tick.get(k, 0) * TRAIN_STEPS for k in total},
          f"the run launched {total}")
    check(all(math.isfinite(x) for x in rec["loss"]), "non-finite loss")
    check(rec["valid"] == [float(s >= S - 1) for s in range(TRAIN_STEPS)],
          f"loss_valid per tick {rec['valid']}")
    check(rec["stage0"] == [s < 2 * (S - 1) for s in range(TRAIN_STEPS)],
          f"stage 0 unchanged per tick {rec['stage0']} (expected until "
          f"tick {2 * (S - 1)})")
    if moe:
        check(all(math.isfinite(a) and a > 0 for a in rec["aux"]),
              f"aux losses {rec['aux']}")
        # stage k's first valid backward is at tick 2(S-1) - k
        check(all(rec["router"][s][k] == 0.0
                  for k in range(S) for s in range(2 * (S - 1) - k)),
              f"a router moved before its first valid backward: "
              f"{rec['router']}")
        check(all(x > 0 for x in rec["router"][-1]), f"a router's momentum "
              f"is zero after {TRAIN_STEPS} ticks: {rec['router'][-1]}")
        print(f"  aux losses {[round(a, 5) for a in rec['aux']]}; router "
              f"momentum max |v| per stage at the end "
              f"{[f'{x:.3e}' for x in rec['router'][-1]]} (zero before "
              f"each stage's first valid backward)")
    # tick i: from the end of the hook after tick i-1 to the start of the
    # hook after tick i (which synchronises first)
    steady = sorted(rec["t"][i] - rec["t_end"][i - 1]
                    for i in range(1, TRAIN_STEPS) if i not in sp.steps)
    wall_ms = steady[len(steady) // 2] * 1e3
    tok_per_s = TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3)
    print(f"  {TRAIN_STEPS} ticks in {time.perf_counter() - t0:.2f}s "
          f"(init and first-tick set-up included); losses "
          f"{[round(x, 4) for x in rec['loss']]}")
    print(f"  per tick: {want_tick} launches, of which tensor-core "
          f"{want_var} (exact on every tick)")
    print(f"  loss valid from tick {S - 1}; stage 0 unchanged through tick "
          f"{2 * (S - 1) - 1}, moved from tick {2 * (S - 1)}")
    print(f"  tick wall (median of ticks 1..{TRAIN_STEPS - 1} but the "
          f"profiled one): {wall_ms:.3f} ms  ({tok_per_s:.1f} tokens/s)")
    print(f"  peak torch.cuda.max_memory_allocated: {peak / 2**30:.2f} GiB")
    kern = sp.result()
    check(bool(kern), f"the profiler saw no device activity in tick "
          f"{sp.at}")
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"  tick {sp.at} under torch.profiler: device busy "
          f"{busy_ms:.3f} ms, {100 * busy_ms / wall_ms:.1f}% of the "
          f"unprofiled tick wall (idle {100 * (1 - busy_ms / wall_ms):.1f}%)")
    print(f"  device ms by kind: {kernel_kinds(kern)}")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms "
              f"{e.count:5d}x  {e.key[:72]}")
    by = {}
    for name, want in want_tick.items():
        hits = [e for e in kern if KERNEL_SYMBOL[name] in e.key]
        n_hit = sum(e.count for e in hits)
        check(n_hit == want, f"the profiled tick shows {n_hit} {name} "
              f"kernels, expected {want}")
        by[name] = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"  {name}: {n_hit} kernels, {by[name]:.4f} ms per tick "
              f"({100 * by[name] / busy_ms:.1f}% of device busy)")
    return {"launches": total, "per_tick": want_tick,
            "variants_per_tick": want_var, "wall_ms": wall_ms,
            "tok_per_s": tok_per_s, "peak_bytes": peak,
            "losses": rec["loss"], "busy_ms": busy_ms, "kernel_ms": by,
            "aux": rec["aux"], "arch": arch, "layers": L}


def new_serving(torch, ops) -> dict:
    """``repro_torch.launch.serve.main`` in bf16 from seed 0 on the MoE
    and code models: deepseek-moe-16b (28 layers) and granite-20b (52)
    through both engines, starcoder2-15b (40) through SimpleEngine,
    grok-1-314b at 4 of its 64 layers through SimpleEngine with every
    logit inside its softcap (30); each run as phase 5 (simple) or phase
    13's first run (pipelined) checks it; deepseek's and granite-20b's
    decode steps profiled as phase 6 profiles the others'."""
    from repro_torch.configs import get_config
    out = {}
    for arch, engine, layers in NEW_SERVE:
        cfg = get_config(arch)
        if engine == "simple":
            r = main_path(torch, ops, arch, cfg.n_layers, layers=layers,
                          logit_cap=cfg.logit_softcap)
            if arch in NEW_PROFILED:
                gc.collect()
                torch.cuda.empty_cache()
                r["profile"] = decode_profile(torch, arch)
        else:
            phase(f"pipelined serving: repro_torch.launch.serve.main "
                  f"--engine pipelined, full {arch}, bf16")
            r = _pipelined_run(torch, ops, arch)
            r = {"launches": r["counts"], "variants": r["variants"],
                 "run": r["run"], "peak_bytes": r["peak"],
                 "tok_per_s": r["tok_per_s"], "layers": r["L"],
                 "rounds": r["rounds_run"]}
        out[(arch, engine)] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_split(torch) -> dict:
    """One full-width deepseek-moe-16b MoE layer at the training tick's
    shape ([8, 512, 2048] bf16, 16 dispatch groups, capacity 31), its
    weights fp32 as the trainer holds them: the device time of each step
    (CUDA events, after warm-up): routing (router product, softmax,
    top-k, aux, slots), dispatch (index_add into the expert buffer),
    the routed experts' products (the weights' bf16 cast included),
    gather (combine) and the shared experts; then the whole layer's
    forward and forward + backward."""
    phase("deepseek-moe-16b MoE layer, training shape: device time by "
          "step (CUDA events)")
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params
    cfg = get_config("deepseek-moe-16b")
    g = torch.Generator(device="cuda").manual_seed(0)
    p = init_params(moe.moe_specs(cfg), g, "float32", "cuda")
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, generator=g,
                    device="cuda").to(torch.bfloat16)
    T = TRAIN_BATCH * TRAIN_SEQ
    G = moe.dispatch_groups(cfg, T)
    cap = moe.capacity(cfg, T // G)
    xg = x.reshape(G, T // G, cfg.d_model)
    sh = {m[len("shared_"):]: p[m] for m in p if m.startswith("shared_")}
    hs = x.reshape(1, T, cfg.d_model).expand(cfg.moe.num_shared, T,
                                             cfg.d_model)
    with torch.no_grad():
        r = moe.route(cfg, p, xg, cap)
        buf = moe.dispatch(cfg, xg, r)
        ob = moe.expert_ffn(cfg, p, buf)
        steps = {
            "routing": lambda: moe.route(cfg, p, xg, cap),
            "dispatch": lambda: moe.dispatch(cfg, xg, r),
            "expert GEMMs": lambda: moe.expert_ffn(cfg, p, buf),
            "gather": lambda: moe.combine(cfg, ob, r, T // G),
            "shared experts": lambda: moe.expert_ffn(cfg, sh, hs).sum(0),
        }
        ms = {k: time_ms(torch, f, 10)[0] for k, f in steps.items()}
        fwd_ms, _ = time_ms(torch, lambda: moe.moe_apply(cfg, p, x), 10)
    kept = float(r.keep.float().mean())
    xr = x.detach().requires_grad_()
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}

    def fwd_bwd():
        out, aux = moe.moe_apply(cfg, leaves, xr)
        torch.autograd.grad((out.float().sum() + aux),
                            [xr] + list(leaves.values()))
    fb_ms, _ = time_ms(torch, fwd_bwd, 5)
    total = sum(ms.values())
    print(f"  T = {T} tokens in {G} groups, capacity {cap} slots an "
          f"expert, {100 * kept:.1f}% of the (token, choice) pairs kept")
    for k, v in ms.items():
        print(f"  {k:<16} {v:8.4f} ms  ({100 * v / total:.1f}% of the "
              f"steps' sum)")
    print(f"  the steps' sum {total:.4f} ms; the layer's forward "
          f"{fwd_ms:.4f} ms; forward + backward {fb_ms:.4f} ms")
    del p, leaves, buf, ob, r
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms, "kept": kept,
            "groups": G, "capacity": cap}


# ---------------------------------------------------------------------------
# the round schedules through the IR interpreter (gpipe, 1f1b, 2bw,
# interleaved), planned by the port's planner

IR_ROUNDS, IR_PROF_ROUND = 4, 2
IR_BASE = ["--arch", ARCH, "--pipe", str(TRAIN_STAGES), "--batch",
           str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--dtype", "bfloat16",
           "--data-kind", "uniform", "--steps", str(IR_ROUNDS),
           "--log-every", "1"]
# (label, argv, layers, virtual stages, the dp split the plan must carry);
# 2bw's vanilla mode is held to JAX on the CPU only.  At 7 layers the dp
# split (2, 2, 1, 2) differs from the model's uniform (2, 2, 2, 1), so the
# stage trees are regrouped at full width
IR_RUNS = [
    ("gpipe spectrain", ["--schedule", "gpipe"], 8, 1, (2, 2, 2, 2)),
    ("1f1b spectrain", ["--schedule", "1f1b"], 8, 1, (2, 2, 2, 2)),
    ("2bw spectrain", ["--schedule", "2bw"], 8, 1, (2, 2, 2, 2)),
    ("2bw pipedream", ["--schedule", "2bw", "--mode", "pipedream"], 8, 1,
     (2, 2, 2, 2)),
    ("interleaved v2 spectrain", ["--schedule", "interleaved",
                                  "--virtual-stages", "2"], 8, 2, (1,) * 8),
    ("1f1b spectrain, 7 layers (dp regroups)", ["--schedule", "1f1b"], 7,
     1, (2, 2, 1, 2)),
]
# the IR update's arguments (the launcher's defaults; no ŵ, s 0)
IR_FU_KW = dict(lr=1e-2, gamma=0.9, s=0.0)
IR_CHECK_SCHEDULES = [("gpipe", "spectrain", 1), ("1f1b", "vanilla", 1),
                      ("2bw", "spectrain", 1), ("2bw", "pipedream", 1),
                      ("interleaved", "spectrain", 2)]


# a profiled kernel's kind, by its name: the first pattern it contains
KERNEL_KINDS = (("attention", ("flash_",)), ("fused_update",
                                             ("fused_update",)),
                ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
                ("copy", ("Memcpy", "direct_copy")),
                ("fill", ("FillFunctor", "Memset")),
                ("add", ("CUDAFunctor_add",)),
                ("elementwise", ("elementwise",)))


def kernel_kinds(kern) -> dict:
    """Device ms of a profile's kernels summed by :data:`KERNEL_KINDS`
    (the rest under "other"), rounded to 0.001 ms."""
    by = {}
    for e in kern:
        kind = next((k for k, pats in KERNEL_KINDS
                     if any(p in e.key for p in pats)), "other")
        by[kind] = by.get(kind, 0.0) + e.self_device_time_total / 1e3
    return {k: round(v, 3) for k, v in sorted(by.items(),
                                              key=lambda kv: -kv[1])}


def ir_check(torch) -> None:
    """Three IR rounds of each round schedule on the card against the
    same rounds on the CPU: 2 stages of a 5-layer smoke granite in fp32
    (a ragged dp split; 4 chunks of the interleaved plan), the CPU parity
    tests' tolerances."""
    phase("IR rounds on the card against the CPU: gpipe, 1f1b, 2bw "
          "(spectrain, pipedream), interleaved v2, smoke size, fp32")
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.planner import plan
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=5, n_kv_heads=2, compute_dtype="float32",
        mesh_plan=dataclasses.replace(get_config(ARCH).mesh_plan, pipe=2))
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    for schedule, mode, v in IR_CHECK_SCHEDULES:
        pplan = plan(cfg, n_stages=2, schedule=schedule, virtual_stages=v,
                     n_microbatches=2, batch=4, seq=16, device="cpu")
        runs = {}
        # copies: a state takes its params over and updates them
        for name, model, params in (("cpu", cpu, _tree_to(p_cpu, "cpu")),
                                    ("gpu", gpu, _tree_to(p_cpu, "cuda"))):
            state = ps.make_ir_state(model, params, plan=pplan, mode=mode)
            step = ps.make_ir_train_step(model, plan=pplan, mode=mode,
                                         lr=0.05)
            runs[name] = (state, [float(step(state, b)[1]["loss"])
                                  for b in batches])
        (s_c, l_c), (s_g, l_g) = runs["cpu"], runs["gpu"]
        l_err = max(abs(a - b) / max(abs(b), 1e-12)
                    for a, b in zip(l_g, l_c))
        check(l_err <= 1e-5, f"{schedule}: losses differ by rel "
              f"{l_err:.3e} (tol 1e-5)")
        worst = 0.0
        for key in ("params", "momentum") + (("stash",) if "stash" in s_c
                                             else ()):
            for g, c in zip(tree_leaves(s_g[key]), tree_leaves(s_c[key])):
                g = g.cpu()
                check(torch.allclose(g, c, rtol=1e-4, atol=1e-5),
                      f"{schedule} {mode}: {key} leaf differs by "
                      f"{float((g - c).abs().max())}")
                worst = max(worst, float((g - c).abs().max()))
        print(f"  {schedule} {mode} ({pplan.summary()}): losses max rel "
              f"|d| {l_err:.3e} (tol 1e-5); every state leaf max |d| "
              f"{worst:.3e} (rtol 1e-4 / atol 1e-5)")


def ir_update_checks(torch, ops, ref) -> None:
    """The IR update's groups at full width, one launch each against its
    plain version: a chunk tree of every layer count the runs below
    give a chunk, and the outer tree; fp32 w, v and the round's fp32
    mean gradient, no ŵ."""
    phase("fused_update at the IR rounds' groups against its plain "
          "version on the card")
    n_layers = sorted({n for *_, sizes in IR_RUNS for n in sizes})
    for label, specs in ([(f"chunk tree of {n} layer(s)",
                           group_specs("stage", n)) for n in n_layers]
                         + [("outer tree", group_specs("outer"))]):
        ws, vs, gs, _ = make_group(torch, specs, lambda path: False)
        err = fu_compare(torch, ops, ref, ws, vs, gs, None, label,
                         IR_FU_KW)
        print(f"  {label}: {len(ws)} tensors, "
              f"{sum(w.numel() for w in ws)} elements, {IR_FU_KW}: one "
              f"launch, max |d| {err:.3e} (tol {FU_TOL['float32']:g})")
        del ws, vs, gs
        torch.cuda.empty_cache()


def ir_schedules(torch, ops, ref, runs=None) -> dict:
    """Each round schedule through ``repro_torch.launch.train.main`` on
    full-width granite-8b, 4 stages, batch 8 x 512, bf16: the plan (dp,
    verified before the first round), finite losses, exact launches a
    round, one profiled round, peak memory and, for 2bw, the stash
    copy."""
    import contextlib
    import io
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.launch import train
    ir_update_checks(torch, ops, ref)
    out = {}
    for label, argv, L, v, sizes in (IR_RUNS if runs is None else runs):
        phase(f"ir_schedules: repro_torch.launch.train.main, {ARCH} full "
              f"width, {L} layers in {TRAIN_STAGES} stages, bf16, {label}, "
              f"{IR_ROUNDS} rounds")
        rec = {"counts": [], "variants": [], "loss": [], "t": [],
               "t_end": []}
        snap = {}
        M, C = IR_ROUND, TRAIN_STAGES * v
        want = {"flash_fwd": 2 * L * M, "flash_bwd_dq": L * M,
                "flash_bwd_dkv": L * M, "fused_update": C + 1}
        want_v = {"flash_fwd_mma": 2 * L * M, "flash_bwd_dq_mma": L * M,
                  "flash_bwd_dkv_mma": L * M}
        sp = StepProfile(label, want, IR_PROF_ROUND, IR_ROUNDS - 1)

        def on_step(s, state, metrics):
            torch.cuda.synchronize()
            rec["t"].append(time.perf_counter())
            rec["counts"].append(dict(ops.launch_counts()))
            rec["variants"].append(dict(ops.variant_counts()))
            rec["loss"].append(float(metrics["loss"]))
            sp.hook(s)
            if s == IR_ROUNDS - 1 and label in MPMD_LABELS:
                # before the stash timing below rewrites the stash
                snap["digests"] = leaf_digests(torch, state)
            if s == IR_ROUNDS - 1 and "stash" in state:
                # the double buffer's copy alone (after the last round:
                # it rewrites the stash), CUDA events, 3 runs
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                times = []
                for _ in range(3):
                    ev[0].record()
                    ps._stash_before_update(state)
                    ev[1].record()
                    ev[1].synchronize()
                    times.append(ev[0].elapsed_time(ev[1]))
                snap["stash_ms"] = sorted(times)[1]
                snap["stash_bytes"] = 2 * sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves(state["stash"]))
            rec["t_end"].append(time.perf_counter())

        from repro_torch.models.layers import tree_leaves
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train.main(IR_BASE + ["--layers", str(L)] + argv,
                            on_step=on_step)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        total = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        text = buf.getvalue()
        print("  " + text.strip().replace("\n", "\n  "))
        check(rc == 0, f"{label}: train.main returned {rc}")
        check(len(rec["loss"]) == IR_ROUNDS, f"{label}: not every round ran")
        plan_line = next((x for x in text.splitlines()
                          if x.startswith("# plan[")), "")
        check(f"part=dp:{sizes}" in plan_line,
              f"{label}: the plan is not the dp split {sizes}: "
              f"{plan_line!r}")
        m = re.search(r"# schedule \S+: round=(\d+) microbatches", text)
        check(m is not None, f"{label}: no round line printed")
        check(int(m.group(1)) == M, f"{label}: round of {m.group(1)} "
              f"microbatches, expected {M}")
        prev, prev_v = {k: 0 for k in want}, {k: 0 for k in want_v}
        for s, (counts, var) in enumerate(zip(rec["counts"],
                                              rec["variants"])):
            got = {k: counts[k] - prev[k] for k in want}
            check(got == want, f"{label}: round {s} launched {got}, "
                  f"expected {want}")
            got_v = {k: var[k] - prev_v[k] for k in want_v}
            check(got_v == want_v, f"{label}: round {s} launched "
                  f"tensor-core variants {got_v}, expected {want_v}")
            prev, prev_v = counts, var
        check(total == {k: want.get(k, 0) * IR_ROUNDS for k in total},
              f"{label}: the run launched {total}")
        check(all(math.isfinite(x) for x in rec["loss"]),
              f"{label}: non-finite loss {rec['loss']}")
        steady = sorted(rec["t"][i] - rec["t_end"][i - 1]
                        for i in range(1, IR_ROUNDS) if i not in sp.steps)
        wall_ms = steady[len(steady) // 2] * 1e3
        kern = sp.result()
        check(bool(kern), f"{label}: the profiler saw no device activity")
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        by = {}
        for name, n in want.items():
            hits = [e for e in kern if KERNEL_SYMBOL[name] in e.key]
            n_hit = sum(e.count for e in hits)
            check(n_hit == n, f"{label}: the profiled round shows {n_hit} "
                  f"{name} kernels, expected {n}")
            by[name] = sum(e.self_device_time_total for e in hits) / 1e3
        r = {"label": label, "layers": L, "chunks": C, "round": M,
             "plan": plan_line, "launches": total, "per_round": want,
             "wall_ms": wall_ms, "busy_ms": busy_ms,
             "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3),
             "peak_bytes": peak, "losses": rec["loss"], "kernel_ms": by,
             "n_kernels": sum(e.count for e in kern), "run_s": run_s,
             "stash_ms": snap.get("stash_ms"),
             "stash_bytes": snap.get("stash_bytes"),
             "digests": snap.get("digests"), "kern_counts": {
                 name: sum(e.count for e in kern
                           if KERNEL_SYMBOL[name] in e.key)
                 for name in want}}
        print(f"  per round: {want} launches, every attention launch on "
              f"the tensor cores {want_v} (exact on every round); losses "
              f"{[round(x, 4) for x in rec['loss']]}")
        print(f"  round wall (median of rounds 1..{IR_ROUNDS - 1} but the "
              f"profiled ones {sp.steps}): {wall_ms:.3f} ms "
              f"({r['tok_per_s']:.1f} tokens/s); profiled round {sp.at}: "
              f"device busy "
              f"{busy_ms:.3f} ms (idle {100 * (1 - busy_ms / wall_ms):.1f}%"
              f" of the unprofiled wall), {r['n_kernels']} kernels; "
              f"fused_update {by['fused_update']:.3f} ms in {C + 1} "
              f"launches; attention fwd+dq+dk/dv "
              f"{by['flash_fwd'] + by['flash_bwd_dq'] + by['flash_bwd_dkv']:.3f}"
              f" ms; peak {peak / 2**30:.2f} GiB; run {run_s:.1f} s")
        if r["stash_ms"] is not None:
            print(f"  2bw stash copy (params + momentum, "
                  f"{r['stash_bytes'] / 1e9:.2f} GB moved): "
                  f"{r['stash_ms']:.3f} ms")
        r["by_kind"] = kernel_kinds(kern)
        print(f"  device ms by kind: {r['by_kind']}")
        kern.sort(key=lambda e: -e.self_device_time_total)
        for e in kern[:10]:
            print(f"    {e.self_device_time_total / 1e3:9.4f} ms "
                  f"{e.count:5d}x  {e.key[:72]}")
        out[label] = r
        del snap
    return out


# ---------------------------------------------------------------------------
# stage-local (MPMD) execution: one process per stage on the one card

# (label of the ir_schedules run it is held to, argv, virtual stages)
MPMD_RUNS = [
    ("1f1b spectrain", ["--schedule", "1f1b"], 1),
    ("2bw spectrain", ["--schedule", "2bw"], 1),
    ("interleaved v2 spectrain", ["--schedule", "interleaved",
                                  "--virtual-stages", "2"], 2),
]
MPMD_LABELS = tuple(r[0] for r in MPMD_RUNS)
# a bit digest's chunk (elements) and index weights' period
DIGEST_CHUNK, DIGEST_PERIOD = 1 << 24, 8191
DIGEST_SAMPLE = 256


def leaf_digests(torch, state) -> dict:
    """``{key: {"d": [s1, s2], "sample": [...]}}`` for every tensor leaf of
    a train state's params, momentum and 2bw stash, keyed by its path
    (``params/stages/3/layers/...``): ``s1`` the sum of its bit patterns
    as int64, ``s2`` the sum weighted by ``(index % 8191) + 1`` (the two
    reduced on the card in chunks, wrapping alike on both sides), and a
    strided sample of 256 values in fp32 for a tolerance check where the
    bits differ.  Only the sums and the sample cross to the host."""
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import sgd
    from repro_torch.runtime import sharding as rsh
    out = {}

    def one(path, t, at=None):
        """``at``: (offset, whole length) of a ZeRO-1 piece: the weights
        and the sample's positions are the whole leaf's, and the sample
        holds the [position, value] pairs that fall in the piece."""
        if not isinstance(t, torch.Tensor):
            return
        flat = t.detach().reshape(-1)
        ints = flat.view({4: torch.int32, 2: torch.int16}[t.element_size()])
        off, n = (0, flat.numel()) if at is None else at
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for lo in range(0, flat.numel(), DIGEST_CHUNK):
            b = ints[lo:lo + DIGEST_CHUNK].to(torch.int64)
            w = torch.arange(off + lo, off + lo + b.numel(), device=t.device,
                             dtype=torch.int64) % DIGEST_PERIOD + 1
            s1, s2 = s1 + b.sum(), s2 + (b * w).sum()
        idx = torch.arange(DIGEST_SAMPLE, device=t.device) * \
            (n - 1) // (DIGEST_SAMPLE - 1)
        if at is None:
            out["/".join(path)] = {"d": [int(s1), int(s2)],
                                   "sample": flat[idx].float().cpu().tolist()}
            return
        mine = [(int(i), int(i) - off) for i in idx.tolist()
                if off <= i < off + flat.numel()]
        vals = flat[[j for _, j in mine]].float().cpu().tolist() \
            if mine else []
        out["/".join(path)] = {"d": [int(s1), int(s2)], "piece": True,
                               "at": [[i, v] for (i, _), v in
                                      zip(mine, vals)]}
    g = rsh.current_group()
    for name in ("params", "momentum", "stash"):
        if name not in state:
            continue
        like = (state["params"] if name == "momentum" else
                state["stash"].get("params") if name == "stash" else None)
        tree = state[name]
        if name == "stash":
            tree_map(lambda path, t: one(("stash",) + path, t),
                     {"params": tree["params"]})
            tree, like = {"momentum": tree["momentum"]}, {
                "momentum": tree["params"]}
        if like is not None and g is not None and g.data.world > 1 and \
                sgd.is_shard(like, tree):
            d = g.data
            ats = [(rsh.shard_range(p.numel(), d.rank, d.world)[0],
                    p.numel()) for p in tree_leaves(like)]
            it = iter(ats)
            prefix = (name,) if name != "stash" else ("stash",)
            tree_map(lambda path, t: one(prefix + path, t, next(it)), tree)
        else:
            prefix = (name,) if name != "stash" else ("stash",)
            tree_map(lambda path, t: one(prefix + path, t), tree)
    return out


def _wrap64(x: int) -> int:
    """``x`` as the card's int64 arithmetic wraps it."""
    return (x + 2**63) % 2**64 - 2**63


def merge_pieces(reps: list) -> int:
    """ZeRO-1: every replica's record digests its own pieces of the
    momentum (``leaf_digests``' ``piece`` entries); the pieces' sums add
    up to the whole leaf's (mod 2^64) and their samples fill the whole
    leaf's positions.  Replaces each record's entries by the whole
    leaf's, in place; returns how many leaves were merged."""
    keys = reps[0].get("pieces", [])
    for s_ in range(len(reps[0]["digests"])):
        for k in keys:
            d = [_wrap64(sum(r["digests"][s_][k][i] for r in reps))
                 for i in range(2)]
            for r in reps:
                r["digests"][s_][k] = d
    for k in keys:
        if "samples" not in reps[0]:
            break
        # the pieces lie in rank order, each one's positions in order
        merged = [v for r in reps for _, v in r["samples"][k]]
        for r in reps:
            r["samples"][k] = merged
    return len(keys)


class MpmdProbe:
    """The ``on_step`` hook of an MPMD run, called in every rank (it
    pickles into the spawned ranks): each round's launches, payload
    counters and loss (the last chunk's rank), its wall on rank 0
    between barriers, one profiled round (``StepProfile``, exact counts
    of the rank's own kernels), and after the last round the leaves'
    digests, the peak memory and the transport time; written to
    ``<out>/rank<r>.json``.  ``profile=False`` leaves the profiled round
    out (the trace phase's traced rounds)."""

    def __init__(self, out: str, label: str, M: int, profile: bool = True):
        self.out, self.label, self.M = out, label, M
        self.profile = profile
        self.rec = None

    def _want(self, state) -> dict:
        L_r = sum(int(t["layers"]["ln1"]["scale"].shape[0])
                  for t in state["params"]["stages"] if t)
        n_trees = sum(1 for t in state["params"]["stages"] if t) + \
            int(bool(state["params"]["outer"]))
        return {"flash_fwd": 2 * L_r * self.M, "flash_bwd_dq": L_r * self.M,
                "flash_bwd_dkv": L_r * self.M, "fused_update": n_trees}

    def __call__(self, s, state, metrics):
        import torch
        from repro_torch.kernels import ops
        from repro_torch.runtime import sharding as rsh
        g = rsh.current_group()
        torch.cuda.synchronize()
        g.barrier()
        if self.rec is None:
            want = self._want(state)
            self.rec = {"rank": g.rank, "want": want, "t": [], "t_end": [],
                        "counts": [], "variants": [], "xfer": [],
                        "loss": [], "transport": g.describe(),
                        # joining the group, the draw and round 0
                        "first_s": time.perf_counter() - g.t0}
            self.sp = (StepProfile(f"{self.label} rank {g.rank}", want,
                                   IR_PROF_ROUND, IR_ROUNDS - 1)
                       if self.profile else None)
        rec = self.rec
        rec["t"].append(time.perf_counter())
        rec["counts"].append(dict(ops.launch_counts()))
        rec["variants"].append(dict(ops.variant_counts()))
        rec["xfer"].append(g.counters())
        g.reset_counters()
        if metrics["loss"] is not None:
            rec["loss"].append(float(metrics["loss"]))
        if self.sp is not None:
            self.sp.hook(s)
        if s == IR_ROUNDS - 1:
            if self.sp is not None:
                kern = self.sp.result()
                rec["busy_ms"] = sum(e.self_device_time_total
                                     for e in kern) / 1e3
                rec["n_kernels"] = sum(e.count for e in kern)
                rec["prof_round"] = self.sp.at
            rec["prof_steps"] = self.sp.steps if self.sp is not None else []
            rec["digests"] = leaf_digests(torch, state)
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            with open(Path(self.out) / f"rank{g.rank}.json", "w") as f:
                json.dump(rec, f)
        torch.cuda.synchronize()
        g.barrier()
        rec["t_end"].append(time.perf_counter())


def _digests_agree(spmd: dict, ranks: list, what: str) -> dict:
    """The SPMD run's leaf digests against the ranks': every leaf held
    (by every rank the placement names), bit-equal counted; a leaf whose
    bits differ is named and held to rtol 1e-4 / atol 1e-5 on its
    sample."""
    held = {}
    for rep in ranks:
        for k, v in rep["digests"].items():
            held.setdefault(k, []).append((rep["rank"], v))
    check(set(held) == set(spmd), f"{what}: the ranks hold "
          f"{len(held)} leaves, the SPMD state {len(spmd)}; missing "
          f"{sorted(set(spmd) - set(held))[:3]}, extra "
          f"{sorted(set(held) - set(spmd))[:3]}")
    equal, differ = 0, []
    for k, want in spmd.items():
        for r, got in held[k]:
            if got["d"] == want["d"]:
                equal += 1
                continue
            a, b = got["sample"], want["sample"]
            worst = max(abs(x - y) - 1e-4 * abs(y) for x, y in zip(a, b))
            differ.append((k, r, worst))
            check(worst <= 1e-5, f"{what}: leaf {k} on rank {r} differs "
                  f"from the SPMD run's beyond rtol 1e-4 / atol 1e-5 "
                  f"(sample excess {worst:.3e})")
    return {"leaves": len(spmd), "copies": sum(map(len, held.values())),
            "bit_equal": equal, "differ": differ}


def _launcher_ranks(group, runs) -> list:
    """One rank of every launcher run of ``runs`` (``(argv, plan, runtime
    config, probe, log directory or None)``) in one spawn of the ranks:
    each the rank's part of what ``train.main`` spawns for its argv
    (``train._mpmd_rank`` under ``--execution mpmd``, else
    ``train._train`` of the ``(data, tensor)`` grid), after a barrier,
    with the launch counters, the group's counters and its joining time
    reset, and, where a run names a log directory, this rank's standard
    output written to ``<log>/rank<r>.log``.  Returns each run's seconds
    on this rank."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    secs = []
    for argv, pplan, rc, probe, log in runs:
        args = train.parse_args(argv)
        cfg = train.build(args)
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        group.reset_counters()
        group.barrier()
        group.t0 = t0 = time.perf_counter()
        with (fd_stdout(str(Path(log) / f"rank{group.rank}.log")) if log
              else contextlib.nullcontext()):
            got = (train._mpmd_rank(group, args, cfg, pplan, rc, probe)
                   if args.execution == "mpmd" else
                   train._train(group, args, cfg, pplan, False, rc, probe))
        check(got == 0, f"{' '.join(argv)}: rank {group.rank} returned "
              f"{got}")
        secs.append(time.perf_counter() - t0)
    group.barrier()
    return secs


def mpmd_train(torch, ops, ir_runs: dict, traced: bool = False) -> tuple:
    """``repro_torch.launch.train.main --execution mpmd``'s rank loop (4
    ranks on the card) under 1f1b, 2bw and interleaved v2, all in one
    spawn of the ranks, held to ``ir_schedules``' SPMD rounds of the same
    label (see the module docstring, phase 16); with ``traced``, the
    same spawn then runs the trace phase's traced 1f1b (phase 18 checks
    it).  Returns (the runs by label, the traced run or None)."""
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_stage_ranks
    from repro_torch.runtime import sharding as rsh
    out = {}
    S, M, L = TRAIN_STAGES, IR_ROUND, TRAIN_LAYERS
    tmp = tempfile.mkdtemp(prefix="mpmd_")
    runs, rdirs = [], {}
    for label, argv, v in MPMD_RUNS:
        rdirs[label] = Path(tmp) / f"run{len(runs)}"
        rdirs[label].mkdir()
        runs.append(_launcher_run(torch, IR_BASE + ["--layers", str(L)]
                                  + argv + ["--execution", "mpmd"],
                                  MpmdProbe(str(rdirs[label]), label, M)))
    if traced:
        tdir = Path(tmp) / "traced"
        (tdir / "probe").mkdir(parents=True)
        runs.append(_launcher_run(
            torch, IR_BASE + ["--layers", str(L), "--schedule", "1f1b",
                              "--execution", "mpmd", "--trace",
                              str(tdir / "mpmd.json")],
            MpmdProbe(str(tdir / "probe"), "1f1b spectrain", M,
                      profile=False), str(tdir)))
    phase(f"mpmd_train: repro_torch.launch.train.main --execution mpmd's "
          f"ranks, {ARCH} full width, {L} layers, {S} ranks on the card, "
          f"bf16, {', '.join(MPMD_LABELS)}"
          f"{' and the traced 1f1b' if traced else ''}, {IR_ROUNDS} rounds "
          f"each, one spawn of the ranks")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    secs = run_stage_ranks(_launcher_ranks, S, "cuda", args=(runs,))
    spawn_s = time.perf_counter() - t0
    print(f"  the ranks' spawn and {len(runs)} runs: {spawn_s:.1f} s; each "
          f"run on rank 0 {[round(x, 1) for x in secs[0]]} s")
    for i, (label, argv, v) in enumerate(MPMD_RUNS):
        phase(f"mpmd_train: the checks of {label}")
        rdir, pplan = rdirs[label], runs[i][1]
        cfg = train.build(train.parse_args(runs[i][0]))
        spmd = ir_runs[label]
        C = pplan.n_chunks
        head = rsh.head_rank(C, S)
        pred = ps.mpmd_transfers(pplan.device_streams())
        act_bytes = IR_MB_ROWS * TRAIN_SEQ * cfg.d_model * 2
        sizes = pplan.partition.sizes()
        run_s = max(r[i] for r in secs)
        reps = [json.loads((rdir / f"rank{r}.json").read_text())
                for r in range(S)]
        want_t = rsh.describe_transport(rsh.choose_transport("cuda", S), S)
        check(all(r["transport"] == want_t for r in reps),
              f"{label}: transport {reps[0]['transport']!r}, expected "
              f"{want_t!r}")
        design = {"flash_fwd": 2 * L * M, "flash_bwd_dq": L * M,
                  "flash_bwd_dkv": L * M, "fused_update": C + len({0, head})}
        check({k: spmd["per_round"][k] for k in design if k !=
               "fused_update"} == {k: design[k] for k in design
                                   if k != "fused_update"},
              f"{label}: SPMD round {spmd['per_round']} vs design {design}")
        for r, rep in enumerate(reps):
            L_r = sum(sizes[q] for q in rsh.local_chunks(r, C, S))
            want_r = {"flash_fwd": 2 * L_r * M, "flash_bwd_dq": L_r * M,
                      "flash_bwd_dkv": L_r * M,
                      "fused_update": len(rsh.local_chunks(r, C, S))
                      + int(r in (0, head))}
            check(rep["want"] == want_r, f"{label}: rank {r} expects "
                  f"{rep['want']}, the plan gives {want_r}")
            prev = {k: 0 for k in want_r}
            for s_, c in enumerate(rep["counts"]):
                got = {k: c[k] - prev[k] for k in want_r}
                check(got == want_r, f"{label}: rank {r} round {s_} "
                      f"launched {got}, expected {want_r}")
                prev = c
            mma = rep["variants"][-1]
            check(mma["flash_fwd_mma"] == want_r["flash_fwd"] * IR_ROUNDS,
                  f"{label}: rank {r} ran flash_fwd off the tensor cores")
            n_s = pred[r]["fwd_sent"] + pred[r]["bwd_sent"]
            n_r = pred[r]["fwd_recv"] + pred[r]["bwd_recv"]
            for s_, x in enumerate(rep["xfer"]):
                check((x["n_sent"], x["n_recv"], x["bytes_sent"],
                       x["bytes_recv"], x["n_ctl"]) ==
                      (n_s, n_r, n_s * act_bytes, n_r * act_bytes, 0),
                      f"{label}: rank {r} round {s_} moved {x}, the "
                      f"streams predict {n_s} sends and {n_r} receives "
                      f"of {act_bytes} B")
        total = {k: sum(rep["counts"][-1][k] for rep in reps)
                 for k in design}
        check(total == {k: n * IR_ROUNDS for k, n in design.items()},
              f"{label}: the ranks launched {total}, expected {design} a "
              f"round")
        losses = reps[head]["loss"]
        check(len(losses) == IR_ROUNDS, f"{label}: {len(losses)} losses")
        loss_equal = losses == spmd["losses"]
        if not loss_equal:
            worst = max(abs(a - b) / abs(b)
                        for a, b in zip(losses, spmd["losses"]))
            print(f"  losses differ from the SPMD run's: {losses} vs "
                  f"{spmd['losses']} (rel {worst:.3e})")
            check(worst <= 1e-4, f"{label}: losses beyond rtol 1e-4")
        dg = _digests_agree(spmd["digests"], reps, label)
        r0 = reps[0]
        prof = set().union(*(rep["prof_steps"] for rep in reps))
        steady = sorted(r0["t"][i] - r0["t_end"][i - 1]
                        for i in range(1, IR_ROUNDS) if i not in prof)
        check(bool(steady), f"{label}: no unprofiled steady round")
        wall_ms = steady[len(steady) // 2] * 1e3
        # each rank's transport time a round: the median of the steady
        # rounds (round 0 waits out the other ranks' first launches)
        xfer_s = [sorted(rep["xfer"][i]["transport_s"]
                         for i in range(1, IR_ROUNDS) if i not in prof)
                  for rep in reps]
        xfer_s = [x[len(x) // 2] for x in xfer_s]
        res = {"label": label, "chunks": C, "wall_ms": wall_ms,
               "spmd_wall_ms": spmd["wall_ms"], "losses": losses,
               "loss_equal": loss_equal, "digests": dg, "per_round": design,
               "per_rank": [rep["want"] for rep in reps],
               "busy_ms": [rep["busy_ms"] for rep in reps],
               "n_kernels": [rep["n_kernels"] for rep in reps],
               "peak_bytes": [rep["peak_bytes"] for rep in reps],
               "transport_ms": [1e3 * t for t in xfer_s],
               "sent": [pred[r]["fwd_sent"] + pred[r]["bwd_sent"]
                        for r in range(S)],
               "act_bytes": act_bytes, "run_s": run_s,
               "launches": total, "transport": r0["transport"],
               "rank_digests": [rep["digests"] for rep in reps]}
        print(f"  transport: {r0['transport']}")
        print(f"  launches a round, per rank: {res['per_rank']}; summed "
              f"{design} (SPMD: {spmd['per_round']}); exact on every "
              f"round, every attention launch on the tensor cores")
        print(f"  payloads a round, per rank sent: {res['sent']} of "
              f"{act_bytes} B each, as the streams predict; no control "
              f"messages")
        print(f"  losses {[round(x, 6) for x in losses]}: "
              f"{'bit-equal to' if loss_equal else 'within rtol of'} the "
              f"SPMD run's; leaves bit-equal {dg['bit_equal']}/"
              f"{dg['copies']} ({dg['leaves']} leaves)"
              + (f"; differing {dg['differ'][:4]}" if dg["differ"] else ""))
        print(f"  round wall (rank 0, median of the unprofiled steady "
              f"rounds): {wall_ms:.3f} ms (SPMD {spmd['wall_ms']:.3f} ms); "
              f"per rank: busy {[round(b, 3) for b in res['busy_ms']]} ms "
              f"in {res['n_kernels']} kernels (profiled round "
              f"{r0['prof_round']}), peak "
              f"{[round(p / 2**30, 2) for p in res['peak_bytes']]} GiB, "
              f"transport {[round(t, 3) for t in res['transport_ms']]} ms "
              f"a steady round (median); run {run_s:.1f} s in the shared "
              f"spawn, of it {max(r['first_s'] for r in reps):.1f} s from "
              f"the run's start to the end of round 0")
        out[label] = res
    traced_run = None
    if traced:
        tdir = Path(tmp) / "traced"
        traced_run = {
            "dir": tmp, "path": str(tdir / "mpmd.json"),
            "text": "".join((tdir / f"rank{r}.log").read_text()
                            for r in range(S)),
            "reps": [json.loads((tdir / "probe" / f"rank{r}.json")
                                .read_text()) for r in range(S)],
            "run_s": max(r[-1] for r in secs)}
    else:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, traced_run


# ---------------------------------------------------------------------------
# the pipeline tracer (obs/trace, drift, Perfetto) on the training paths

# (label of the ir_schedules run it is held to, argv, virtual stages)
TRACE_RUNS = [
    ("1f1b spectrain", ["--schedule", "1f1b"], 1),
    ("interleaved v2 spectrain", ["--schedule", "interleaved",
                                  "--virtual-stages", "2"], 2),
]
# pairs of untraced and traced full-width rounds for the overhead (10
# before phase 28 took the time)
TRACE_PAIRS = 6
TRACE_ROUNDS_RE = re.compile(
    r"# trace rounds: (\d+) filed, (\d+) dropped, (\d+) events a round")
TRACE_BUBBLE_RE = re.compile(
    r"# bubble: measured (\S+)\s+ir-predicted (\S+)\s+cost-weighted (\S+)")


@contextlib.contextmanager
def fd_stdout(path: str):
    """Send file descriptor 1 to ``path`` for the block: this process's
    standard output and that of the processes it spawns (the stage
    ranks print there)."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _trace_file(path, n_events: int, lanes: int, what: str) -> dict:
    """The written trace: valid (``validate_trace``), 2·n_events span
    events (the measured and the IR-predicted lane groups), ``lanes``
    measured lanes, every measured span positive; the measured spans'
    sum and, per (op, chunk) and per lane, their mean durations (ms)."""
    from repro_torch.obs import validate_trace
    obj = json.loads(Path(path).read_text())
    problems = validate_trace(obj)
    check(not problems, f"{what}: the trace is invalid: {problems[:3]}")
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    meas = [e for e in xs if e["pid"] == 0]
    check(len(xs) == 2 * n_events and len(meas) == n_events,
          f"{what}: {len(xs)} span events ({len(meas)} measured), expected "
          f"2 x {n_events}")
    check(sorted({e["tid"] for e in meas}) == list(range(lanes)),
          f"{what}: measured lanes {sorted({e['tid'] for e in meas})}, "
          f"expected {lanes}")
    check(all(e["dur"] > 0 for e in meas),
          f"{what}: a measured span is not positive")
    by_kind, by_lane = {}, {}
    for e in meas:
        by_kind.setdefault(f"{e['args']['op']} q{e['args']['chunk']}",
                           []).append(e["dur"] / 1e3)
        by_lane.setdefault(e["tid"], []).append(e["dur"] / 1e3)
    return {"sum_ms": sum(e["dur"] for e in meas) / 1e3,
            "by_kind": {k: sum(v) / len(v) for k, v in sorted(
                by_kind.items())},
            "lane_ms": [sum(by_lane[d]) for d in range(lanes)]}


def _trace_summary(text: str, what: str, rounds: int, events: int) -> dict:
    """The launcher's ``# trace rounds`` and ``# bubble`` lines: every
    round filed with ``events`` marks, none dropped."""
    m = TRACE_ROUNDS_RE.search(text)
    check(m is not None, f"{what}: no '# trace rounds' line printed")
    filed, dropped, n = (int(x) for x in m.groups())
    check((filed, dropped, n) == (rounds, 0, events),
          f"{what}: {filed} rounds filed, {dropped} dropped, {n} events a "
          f"round; expected {rounds}, 0, {events}")
    b = TRACE_BUBBLE_RE.search(text)
    check(b is not None, f"{what}: no drift report printed")
    return {"bubble": float(b.group(1)), "bubble_ir": float(b.group(2)),
            "bubble_weighted": float(b.group(3))}


def _ir_rounds(torch, ops, argv: list, want: dict, what: str) -> dict:
    """``train.main`` over IR_BASE + ``argv`` (IR_ROUNDS rounds): its
    printed lines, every round's loss, exact launches a round, the host
    wall of rounds 1.. (the card synchronized), the last state's leaf
    digests."""
    from repro_torch.launch import train
    rec = {"t": [], "t_end": [], "loss": [], "counts": []}

    def on_step(s, state, metrics):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["counts"].append(dict(ops.launch_counts()))
        rec["loss"].append(float(metrics["loss"]))
        if s == IR_ROUNDS - 1:
            rec["digests"] = leaf_digests(torch, state)
        rec["t_end"].append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(IR_BASE + argv, on_step=on_step)
    check(rc == 0, f"{what}: train.main returned {rc}")
    check(len(rec["loss"]) == IR_ROUNDS, f"{what}: not every round ran")
    prev = {k: 0 for k in want}
    for s, c in enumerate(rec["counts"]):
        got = {k: c[k] - prev[k] for k in want}
        check(got == want, f"{what}: round {s} launched {got}, expected "
              f"{want}")
        prev = c
    rec["walls_ms"] = [1e3 * (rec["t"][i] - rec["t_end"][i - 1])
                       for i in range(1, IR_ROUNDS)]
    rec["text"] = buf.getvalue()
    return rec


def trace_pairs(torch) -> dict:
    """The tracer's cost at full width: TRACE_PAIRS pairs of an untraced
    and a traced 1f1b round (the launcher's configuration and seed) on
    one state, alternating which runs first
    (``repro_torch.bench.trace_overhead.paired_walls``)."""
    from statistics import median

    from repro_torch.bench.trace_overhead import paired_walls
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.obs import PipelineTracer
    phase(f"trace: overhead, {TRACE_PAIRS} pairs of an untraced and a "
          f"traced 1f1b round on one state, alternating, {ARCH} full "
          f"width, {TRAIN_LAYERS} layers in {TRAIN_STAGES} stages, bf16")
    args = train.parse_args(IR_BASE + ["--layers", str(TRAIN_LAYERS),
                                       "--schedule", "1f1b"])
    cfg = train.build(args)
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg, device=args.device)
    pplan, _ = train.run_plan(args, cfg, model.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    state = ps.make_ir_state(model, model.init(gen), plan=pplan,
                             mode=args.mode)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                   seed=args.seed, kind=args.data_kind)
                        ).batch_at(0)
    kw = dict(plan=pplan, mode=args.mode, lr=args.lr, gamma=args.gamma)
    tracer = PipelineTracer(pplan, device=model.device)
    off, on = paired_walls(ps.make_ir_train_step(model, **kw),
                           tracer.wrap_step(ps.make_ir_train_step(
                               model, tracer=tracer, **kw)),
                           state, batch, model.device, TRACE_PAIRS)
    check(len(tracer.rounds) == TRACE_PAIRS + 1
          and tracer.dropped_rounds == 0,
          f"overhead: {len(tracer.rounds)} rounds filed, "
          f"{tracer.dropped_rounds} dropped")
    del state
    r = {"off_ms": 1e3 * median(off), "on_ms": 1e3 * median(on),
         "slower": sum(b > a for a, b in zip(off, on)),
         "off_iqr_ms": 1e3 * (sorted(off)[3 * TRACE_PAIRS // 4]
                              - sorted(off)[TRACE_PAIRS // 4])}
    r["pct"] = 100 * (r["on_ms"] / r["off_ms"] - 1)
    print(f"  untraced {[round(1e3 * x, 3) for x in off]} ms")
    print(f"  traced   {[round(1e3 * x, 3) for x in on]} ms")
    print(f"  medians: traced {r['on_ms']:.3f} ms, untraced "
          f"{r['off_ms']:.3f} ms ({r['pct']:+.2f}%); traced slower in "
          f"{r['slower']} of {TRACE_PAIRS} pairs; the untraced rounds' "
          f"quartile spread {r['off_iqr_ms']:.3f} ms")
    return r


def trace_phase(torch, ops, ir_runs: dict, mpmd_runs: dict,
                mpmd_traced: dict) -> dict:
    """The pipeline tracer through ``repro_torch.launch.train.main
    --trace`` (see the module docstring, phase 18): traced IR rounds of
    1f1b and interleaved v2 against untraced ones, a traced MPMD 1f1b
    run (``mpmd_traced``: run by phase 16's spawn of the ranks) against
    phase 16's, the traced stream tick, the overhead benchmark."""
    from statistics import median

    from repro_torch.bench import trace_overhead
    from repro_torch.launch import train
    from repro_torch.runtime import sharding as rsh
    out = {"ir": {}}
    M = IR_ROUND
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv, v in TRACE_RUNS:
            phase(f"trace: repro_torch.launch.train.main --trace, {ARCH} "
                  f"full width, {TRAIN_LAYERS} layers in {TRAIN_STAGES} "
                  f"stages, bf16, {label}, {IR_ROUNDS} rounds traced and "
                  f"untraced")
            C, L = TRAIN_STAGES * v, TRAIN_LAYERS
            n_ev = 2 * C * M
            want = {"flash_fwd": 2 * L * M, "flash_bwd_dq": L * M,
                    "flash_bwd_dkv": L * M, "fused_update": C + 1}
            path = str(Path(tmp) / f"ir{v}.json")
            base = ["--layers", str(L)] + argv
            plain = _ir_rounds(torch, ops, base, want, f"{label} untraced")
            traced = _ir_rounds(torch, ops, base + ["--trace", path], want,
                                f"{label} traced")
            print("  " + traced["text"].strip().replace("\n", "\n  "))
            check(traced["loss"] == plain["loss"],
                  f"{label}: traced losses {traced['loss']} vs untraced "
                  f"{plain['loss']}")
            differ = [k for k, d in plain["digests"].items()
                      if traced["digests"].get(k, {}).get("d") != d["d"]]
            check(set(traced["digests"]) == set(plain["digests"])
                  and not differ, f"{label}: traced leaves differ from the "
                  f"untraced: {differ[:4]}")
            summ = _trace_summary(traced["text"], label, IR_ROUNDS, n_ev)
            tf = _trace_file(path, n_ev, TRAIN_STAGES, label)
            spmd = ir_runs[label]
            lo = spmd["busy_ms"] - spmd["kernel_ms"]["fused_update"]
            # the tracer's mean over rounds 1..; each round's marks lie
            # inside its step, so the mean sum is under the mean wall
            hi = sum(traced["walls_ms"]) / len(traced["walls_ms"])
            check(lo <= tf["sum_ms"] <= hi,
                  f"{label}: the events sum to {tf['sum_ms']:.3f} ms, "
                  f"outside [busy - fused_update, wall] = [{lo:.3f}, "
                  f"{hi:.3f}]")
            r = {"label": label, "events": n_ev, "leaves": len(
                plain["digests"]), "busy_ms": spmd["busy_ms"],
                 "update_ms": spmd["kernel_ms"]["fused_update"],
                 "plain_ms": median(plain["walls_ms"]),
                 "traced_ms": median(traced["walls_ms"]),
                 "traced_mean_ms": hi, **summ, **tf}
            r["overhead_pct"] = 100 * (r["traced_ms"] / r["plain_ms"] - 1)
            print(f"  traced against untraced: losses and all {r['leaves']}"
                  f" leaves bit-equal; {n_ev} marks a round, "
                  f"{IR_ROUNDS} rounds filed, none dropped; launches a "
                  f"round {want} both")
            print(f"  events sum to {tf['sum_ms']:.3f} ms a round (mean of "
                  f"rounds 1..{IR_ROUNDS - 1}), within [busy "
                  f"{spmd['busy_ms']:.3f} - fused_update "
                  f"{r['update_ms']:.3f}, mean traced wall {hi:.3f}]; "
                  f"bubble measured {r['bubble']:.3f}, IR {r['bubble_ir']:.3f}"
                  f", cost-weighted {r['bubble_weighted']:.3f}")
            print(f"  mean event ms by (op, chunk): "
                  f"{ {k: round(x, 3) for k, x in tf['by_kind'].items()} }; "
                  f"per device lane {[round(x, 3) for x in tf['lane_ms']]}")
            print(f"  overhead: round wall (median of rounds 1..."
                  f"{IR_ROUNDS - 1}) traced {r['traced_ms']:.3f} ms, "
                  f"untraced {r['plain_ms']:.3f} ms "
                  f"({r['overhead_pct']:+.1f}%; host-bound rounds, not "
                  f"gated)")
            out["ir"][label] = r

        out["pairs"] = trace_pairs(torch)

        label = "1f1b spectrain"
        phase(f"trace: the traced MPMD run (--execution mpmd --trace, "
              f"{ARCH} full width, {TRAIN_LAYERS} layers, {TRAIN_STAGES} "
              f"ranks on the card, bf16, {label}, {IR_ROUNDS} rounds; run "
              f"in phase 16's spawn of the ranks)")
        path, text = mpmd_traced["path"], mpmd_traced["text"]
        run_s, reps = mpmd_traced["run_s"], mpmd_traced["reps"]
        print("  " + text.strip().replace("\n", "\n  "))
        ref = mpmd_runs[label]
        for r, rep in enumerate(reps):
            want_d = ref["rank_digests"][r]
            differ = [k for k, d in want_d.items()
                      if rep["digests"].get(k, {}).get("d") != d["d"]]
            check(set(rep["digests"]) == set(want_d) and not differ,
                  f"mpmd {label}: rank {r}'s traced leaves differ from the "
                  f"untraced run's: {differ[:4]}")
            check(rep["want"] == ref["per_rank"][r],
                  f"mpmd {label}: rank {r} launches {rep['want']}")
            prev = {k: 0 for k in rep["want"]}
            for s_, c in enumerate(rep["counts"]):
                got = {k: c[k] - prev[k] for k in rep["want"]}
                check(got == rep["want"], f"mpmd {label}: rank {r} round "
                      f"{s_} launched {got}")
                prev = c
            n_s = ref["sent"][r]
            check(all(x["n_sent"] == n_s and x["n_ctl"] == 0
                      for x in rep["xfer"]),
                  f"mpmd {label}: rank {r} moved {rep['xfer']}")
        losses = reps[rsh.head_rank(TRAIN_STAGES, TRAIN_STAGES)]["loss"]
        check(losses == ref["losses"], f"mpmd {label}: traced losses "
              f"{losses} vs untraced {ref['losses']}")
        n_ev = 2 * TRAIN_STAGES * M
        summ = _trace_summary(text, f"mpmd {label}", IR_ROUNDS, n_ev)
        tf = _trace_file(path, n_ev, TRAIN_STAGES, f"mpmd {label}")
        cli = subprocess.run([sys.executable, "-m", "repro_torch.obs.perfetto",
                      path], capture_output=True, text=True,
                     timeout=TIMEOUT_S, cwd=str(ROOT),
                     env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        check(cli.returncode == 0 and f"OK: {2 * n_ev} span events" in
              cli.stdout, f"python -m repro_torch.obs.perfetto: "
              f"{cli.stdout.strip()} {cli.stderr.strip()[-300:]}")
        r0 = reps[0]
        walls = [1e3 * (r0["t"][i] - r0["t_end"][i - 1])
                 for i in range(1, IR_ROUNDS)]
        out["mpmd"] = {"label": label, "events": n_ev, **summ, **tf,
                       "run_s": run_s, "wall_ms": median(walls),
                       "plain_wall_ms": ref["wall_ms"]}
        print(f"  traced against phase 16's untraced run: losses and every "
              f"rank's leaves bit-equal, launches and payloads a round "
              f"unchanged, no control message; {n_ev} events a round in "
              f"{TRAIN_STAGES} lanes (one a rank); {cli.stdout.strip()}")
        print(f"  per lane, the rank's ticks sum to "
              f"{[round(x, 3) for x in tf['lane_ms']]} ms a round (mean of "
              f"rounds 1..{IR_ROUNDS - 1}, transport waits included); "
              f"bubble measured {summ['bubble']:.3f}, IR "
              f"{summ['bubble_ir']:.3f}; rank 0's round wall "
              f"{out['mpmd']['wall_ms']:.3f} ms (untraced "
              f"{ref['wall_ms']:.3f}); run {run_s:.1f} s")

        phase(f"trace: the stream tick, repro_torch.launch.train.main "
              f"--trace, {ARCH} full width, {TRAIN_LAYERS} layers in "
              f"{TRAIN_STAGES} stages, bf16, spectrain, {TRAIN_STEPS} ticks")
        path = str(Path(tmp) / "stream.json")
        gc.collect()
        torch.cuda.empty_cache()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(TRAIN_ARGV + ["--trace", path])
        text = buf.getvalue()
        print("  " + text.strip().replace("\n", "\n  "))
        check(rc == 0, f"stream --trace: train.main returned {rc}")
        n_sp = (TRAIN_STEPS - 1) * TRAIN_STAGES
        tf = _trace_file(path, n_sp, TRAIN_STAGES, "stream --trace")
        meas = [float(m.group(1)) for m in re.finditer(
            r"#  s\d+\s+\S+\s+(\S+)", text)]
        check(len(meas) == TRAIN_STAGES and all(x > 0 for x in meas),
              f"stream --trace: probed stage costs {meas}")
        out["stream"] = {"probed_ms": [1e3 * x for x in meas], **tf}
        print(f"  probed stage forwards {[round(1e3 * x, 3) for x in meas]}"
              f" ms (after a warm call, the card synchronized); "
              f"{n_sp} attributed spans")

        phase("python -m repro_torch.bench.trace_overhead on the card")
        rows = trace_overhead.main(device="cuda")
        print("  " + "\n  ".join(rows))
        out["bench"] = rows
    return out


# ---------------------------------------------------------------------------
# the data-parallel baseline: the data axis as all-reducing replicas

# the paper's Data-P: --pipe 1, one whole model a replica, the training
# configuration's batch split over the replicas (B / N rows each), at 2
# layers (the gloo-host reduce-scatter and all-gather bound the step;
# 4 layers, phase 28's depth, before phase 29 took the time); 3 steps,
# the second profiled (4 and the third before phase 29)
DP_STEPS, DP_PROF_STEP = 3, 1
DP_LAYERS = 2
DATA_PIPE_LAYERS, DATA_PIPE_STAGES = 2, 2
DP_ARGV = ["--arch", ARCH, "--layers", str(DP_LAYERS), "--pipe", "1",
           "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--dtype",
           "bfloat16", "--mode", "sync", "--data-kind", "uniform",
           "--seed", "0", "--steps", str(DP_STEPS), "--log-every", "1"]
# the data sizes: 2 always (sharing the card when there is one); 4 where
# the machine has 4 cards, else its memory is reckoned, not run
DP_SIZES = (2, 4)
# the pod references on full-width granite-8b: layers, pods, steps, rows
DP_POD = dict(layers=2, pods=2, steps=3, rows=2)
DP_TOY_TOL = 1e-5       # the toy problem, card against the CPU
DP_TOY_STEPS, DP_TOY_LR = 20, 0.5


class DpProbe:
    """The ``on_step`` hook of a ``--data`` run, called in every replica
    (it pickles into the spawned replicas), or of the one-process
    reference (no group): each step's launches, all-reduce counters and
    loss, and an exact digest of every params and momentum leaf; the
    step walls between barriers; one profiled step (``StepProfile``,
    the digests outside its window); after the last step each leaf's
    sample and the peak memory, to ``<out>/rank<r>.json``."""

    def __init__(self, out: str, label: str, want: dict, *, symbols=None,
                 digests: bool = True):
        self.out, self.label, self.want = out, label, want
        self.symbols, self.digests = symbols, digests
        self.rec = None

    def __call__(self, s, state, metrics):
        import torch
        from repro_torch.kernels import ops
        from repro_torch.runtime import sharding as rsh
        g = rsh.current_group()
        torch.cuda.synchronize()
        if g is not None:
            g.barrier()
        rank = 0 if g is None else g.rank
        if self.rec is None:
            self.rec = {"rank": rank, "t": [], "t_end": [], "counts": [],
                        "variants": [], "xfer": [], "loss": [],
                        "digests": [],
                        "transport": None if g is None else g.describe()}
            self.sp = StepProfile(f"{self.label} replica {rank}", self.want,
                                  DP_PROF_STEP, DP_STEPS - 1, self.symbols)
        rec = self.rec
        rec["t"].append(time.perf_counter())
        self.sp.stop(s)
        rec["counts"].append(dict(ops.launch_counts()))
        rec["variants"].append(dict(ops.variant_counts()))
        if g is not None:
            rec["xfer"].append(g.counters())
            g.reset_counters()
            if g.tensor is not None:    # the tensor axis's all-reduces
                rec.setdefault("tp", []).append(g.tensor.counters())
                g.tensor.reset_counters()
            if g.data is not g:
                rec.setdefault("dxfer", []).append(g.data.counters())
                g.data.reset_counters()
        rec["loss"].append(float(metrics["loss"]))
        dg = {}
        if self.digests:
            dg = leaf_digests(torch, state)
            if "pred" in state:     # spectrain's next forward weights
                dg.update({"pred/" + k.split("/", 1)[1]: v for k, v in
                           leaf_digests(torch, {"params": state["pred"]}
                                        ).items()})
            rec["digests"].append({k: v["d"] for k, v in dg.items()})
            rec["pieces"] = sorted(k for k, v in dg.items()
                                   if v.get("piece"))
        from repro_torch.models.layers import tree_leaves
        rec["momentum_bytes"] = sum(
            t.numel() * 4 for t in tree_leaves(state["momentum"]))
        if s == DP_STEPS - 1:
            kern = self.sp.result()
            rec["busy_ms"] = sum(e.self_device_time_total
                                 for e in kern) / 1e3
            rec["n_kernels"] = sum(e.count for e in kern)
            rec["prof_step"] = self.sp.at
            rec["prof_steps"] = self.sp.steps
            rec["samples"] = {k: v["at"] if v.get("piece") else v["sample"]
                              for k, v in dg.items()}
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            with open(Path(self.out) / f"rank{rank}.json", "w") as f:
                json.dump(rec, f)
        self.sp.start(s)
        torch.cuda.synchronize()
        if g is not None:
            g.barrier()
        rec["t_end"].append(time.perf_counter())


class LossProbe:
    """The ``on_step`` hook of a short run held by its losses alone (the
    fp32 pair of phase 29, whose FMA attention kernels a profile of the
    tensor-core ones would not count): each step's loss, to
    ``<out>/rank<r>.json``."""

    def __init__(self, out: str, steps: int):
        self.out, self.steps, self.loss = out, steps, []

    def __call__(self, s, state, metrics):
        from repro_torch.runtime import sharding as rsh
        g = rsh.current_group()
        self.loss.append(float(metrics["loss"]))
        if s == self.steps - 1:
            rank = 0 if g is None else g.rank
            with open(Path(self.out) / f"rank{rank}.json", "w") as f:
                json.dump({"loss": self.loss}, f)


def _loss_run(argv: list, ranks: int) -> list:
    """``train.main(argv)`` with a :class:`LossProbe`: each rank's
    losses."""
    from repro_torch.launch import train
    steps = int(argv[argv.index("--steps") + 1])
    with tempfile.TemporaryDirectory() as tmp:
        rc = train.main(argv, on_step=LossProbe(tmp, steps))
        check(rc == 0, f"{' '.join(argv)}: train.main returned {rc}")
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                ["loss"] for r in range(ranks)]


def _dp_run(torch, n: int, want: dict, label: str, argv=DP_ARGV, *,
            tensor: int = 1, symbols=None, digests: bool = True) -> tuple:
    """``train.main(argv + --data n [--tensor T])`` with a
    :class:`DpProbe` in every rank (in this process for one rank);
    returns (the ranks' records, ZeRO-1's momentum pieces merged into
    whole-leaf digests and samples (``merge_pieces``) within each tensor
    coordinate, the run's seconds).  ``symbols`` and ``digests``: the
    probe's."""
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    extra = ["--data", str(n)] + (["--tensor", str(tensor)]
                                  if tensor > 1 else [])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = train.main(argv + extra, on_step=DpProbe(
            tmp, label, want, symbols=symbols, digests=digests))
        run_s = time.perf_counter() - t0
        check(rc == 0, f"{label}: train.main returned {rc}")
        reps = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(n * tensor)]
    for t in range(tensor if digests else 0):
        merge_pieces(reps[t::tensor])
    gc.collect()
    torch.cuda.empty_cache()
    return reps, run_s


def zero1_traffic(groups: list, n: int) -> tuple:
    """ZeRO-1's calls and bytes for fp32 leaves of the sizes in each
    list of ``groups`` (one reduce-scatter or all-gather pass a list)
    over ``n`` replicas: (calls, bytes), each pass cut into buckets of
    ``BUCKET_BYTES`` (``runtime.sharding.shard_buckets``)."""
    from repro_torch.runtime import sharding as rsh
    calls = nbytes = 0
    for sizes in groups:
        bks = rsh.shard_buckets(sizes, n, rsh.BUCKET_BYTES // 4)
        calls += len(bks)
        nbytes += 4 * n * sum(w for w, _ in bks)
    return calls, nbytes


def _steady(rec) -> list:
    """The step walls (ms) of the unprofiled steps after the first,
    sorted: each from the end of one hook to the start of the next."""
    return sorted(1e3 * (rec["t"][i] - rec["t_end"][i - 1])
                  for i in range(1, DP_STEPS)
                  if i not in rec["prof_steps"])


def _steady_xfer(rec, key: str, field: str) -> float:
    """The median over the unprofiled steady steps of a record's counter
    ``field`` in its list ``key`` (``xfer``, ``tp``), in ms."""
    return 1e3 * _median(rec[key][i][field] for i in range(1, DP_STEPS)
                         if i not in rec["prof_steps"])


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def dp_blocks_reference(torch, cfg, n: int) -> dict:
    """``SyncPodDP`` in this process on the ``n`` row blocks the replicas
    take (``pipeline_sync.pipeline_loss`` a block, the mean gradient
    ``sum(xs) / len(xs)``), from the weights the launcher draws: the
    losses a step and the digests of every params and momentum leaf
    after the last step.  The same GEMM shapes as a replica's, so it
    separates the replicas' arithmetic from the whole batch's bf16
    rounding."""
    from repro_torch.core import async_dp, pipeline_sync
    from repro_torch.core.pipeline_stream import device_batch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                  seed=0, kind="uniform"))
    algo = async_dp.SyncPodDP(
        lambda p, b: pipeline_sync.pipeline_loss(model, p, b, 1),
        model.init(torch.Generator(device="cuda").manual_seed(0)),
        n_pods=n, lr=1e-2, gamma=0.9)
    rows = TRAIN_BATCH // n
    losses = []
    for s_ in range(DP_STEPS):
        b = device_batch(data.batch_at(s_), "cuda")
        losses.append(algo.step([{k: v[r * rows:(r + 1) * rows]
                                  for k, v in b.items()}
                                 for r in range(n)])["loss"])
    dg = leaf_digests(torch, {"params": algo.params,
                              "momentum": algo.mom.v})
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "digests": {k: v["d"] for k, v in dg.items()},
            "samples": {k: v["sample"] for k, v in dg.items()}}


def _sample_excess(got: dict, want: dict) -> list:
    """[(excess over rtol 1e-4, leaf, got, want, largest |want|, largest
    |got - want|)] of every leaf's sample, the excess and the pair at its
    worst element, the worst leaf first."""
    out = []
    for k, w in want.items():
        g = got[k]
        i = max(range(len(g)), key=lambda j: abs(g[j] - w[j])
                - 1e-4 * abs(w[j]))
        out.append((abs(g[i] - w[i]) - 1e-4 * abs(w[i]), k, g[i], w[i],
                    max(abs(y) for y in w),
                    max(abs(x - y) for x, y in zip(g, w))))
    return sorted(out, reverse=True)


def dp_update_timings(torch, ops, ref) -> list:
    """``fused_update`` with no ŵ (the data-parallel update) at the
    path's whole tree (one group: the outer tree and 8 full-width
    layers) and at one stage tree (2 layers), each checked once against
    its plain version and timed beside ``torch.optim.SGD(fused=True,
    momentum=γ, dampening=γ)`` on the same tensors, which computes the
    same function (v' = γv + (1−γ)g, w' = w − ηv') after its first step
    (before it, torch seeds the buffer with the raw gradient)."""
    from repro_torch.kernels import fused_update as fu
    phase("dp_train: fused_update with no ŵ at the data-parallel update's "
          "group and a stage tree, against torch.optim.SGD(fused=True)")
    rows = []
    for label, specs in (
            (f"the data-parallel tree (outer + {TRAIN_LAYERS} layers), "
             f"no ŵ", group_specs("outer")
             + group_specs("stage", TRAIN_LAYERS)),
            (f"one stage ({TRAIN_LAYERS // TRAIN_STAGES} layers), no ŵ",
             group_specs("stage", TRAIN_LAYERS // TRAIN_STAGES))):
        gc.collect()
        torch.cuda.empty_cache()
        ws, vs, gs, _ = make_group(torch, specs, lambda path: False)
        n = sum(w.numel() for w in ws)
        ops.reset_launch_counts()
        err = fu_compare(torch, ops, ref, ws, vs, gs, None, label,
                         kw=IR_FU_KW)
        check(ops.launch_counts()["fused_update"] == 1,
              f"{label}: {ops.launch_counts()} launches, expected one")
        ms, _ = time_ms(torch, lambda: ops.fused_update(
            ws, vs, gs, **IR_FU_KW), 10)
        plain_ms, _ = time_ms(torch, lambda: [
            ref.fused_update_ref(w, v, g, **IR_FU_KW)
            for w, v, g in zip(ws, vs, gs)], 3)
        params = [torch.nn.Parameter(w) for w in ws]
        for p_, g in zip(params, gs):
            p_.grad = g
        opt = torch.optim.SGD(params, lr=IR_FU_KW["lr"],
                              momentum=IR_FU_KW["gamma"],
                              dampening=IR_FU_KW["gamma"], fused=True)
        opt.step()          # the seeding step: buffer = g
        lib_ms, _ = time_ms(torch, opt.step, 10)
        # w, v, g read; w', v' written (fused_update.cost)
        b_ms, b_by = bound_of(*fu.cost(n), "float32")
        nbytes = fu.cost(n)[1]
        shape = f"{label}: {len(ws)} tensors, {n} elements, fp32 w/v/g"
        rows.append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "max_abs_err": err})
        print(f"  fused_update   {shape} ({nbytes / 1e9:.2f} GB): one launch "
              f"against its plain version max |d| {err:.3e}; kernel "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)  bound "
              f"{b_ms:.4f} ms (bytes)  plain {plain_ms:.4f} ms  "
              f"torch.optim.SGD(fused, momentum=γ, dampening=γ) "
              f"{lib_ms:.4f} ms ({lib_ms / ms:.3f}x the kernel)")
        del ws, vs, gs, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _toy_problem(torch, device, seed=0, dim=24, classes=6):
    """tests/test_torch_dp.py's pod problem (numpy draws) on ``device``."""
    import numpy as np
    wtrue = np.random.default_rng(99).standard_normal(
        (dim, classes)).astype(np.float32)
    w0 = {"w": torch.from_numpy((np.random.default_rng(seed)
                                 .standard_normal((dim, classes)) * 0.01)
                                .astype(np.float32)).to(device),
          "b": torch.zeros((classes,), device=device)}

    def batches(step, n_pods=2, bs=32):
        out = []
        for p in range(n_pods):
            x = np.random.default_rng(step * 17 + p).standard_normal(
                (bs, dim)).astype(np.float32)
            out.append({"x": torch.from_numpy(x).to(device),
                        "y": torch.from_numpy((x @ wtrue).argmax(-1))
                        .to(device)})
        return out

    def loss_fn(p, batch):
        logits = batch["x"] @ p["w"] + p["b"]
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, batch["y"][:, None])[:, 0]
        return (lse - gold).mean()

    return w0, batches, loss_fn


def dp_pods(torch, ops) -> dict:
    """``SyncPodDP`` and ``AsyncPodDP`` (predict on and off) on
    full-width granite-8b at ``DP_POD['layers']`` layers, 2 pods,
    ``model.loss``: finite losses, exact launches a step; then the toy
    problem of the tests held card against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core import async_dp
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    L, P, T, R = (DP_POD[k] for k in ("layers", "pods", "steps", "rows"))
    phase(f"dp_train: SyncPodDP / AsyncPodDP (predict on, off) on {ARCH} "
          f"full width, {L} layers, {P} pods of {R} x {TRAIN_SEQ}, bf16, "
          f"{T} steps")
    base = get_config(ARCH)
    cfg = base.replace(n_layers=L, param_dtype="float32",
                       compute_dtype="bfloat16",
                       mesh_plan=dataclasses.replace(base.mesh_plan, pipe=1,
                                                     tensor=1))
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = []
    for _ in range(T):
        toks = torch.randint(0, cfg.vocab_size, (P, R, TRAIN_SEQ + 1),
                             device="cuda", generator=gen)
        batches.append([{"tokens": t[:, :-1], "targets": t[:, 1:]}
                        for t in toks])
    out = {}
    for label, cls, kw in (("sync", async_dp.SyncPodDP, {}),
                           ("async predict", async_dp.AsyncPodDP,
                            {"predict": True}),
                           ("async stale", async_dp.AsyncPodDP,
                            {"predict": False})):
        algo = cls(model.loss, params, n_pods=P, **kw)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [algo.step(b)["loss"] for b in batches]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / T
        counts = dict(ops.launch_counts())
        want = {"flash_fwd": L * P * T, "flash_bwd_dq": L * P * T,
                "flash_bwd_dkv": L * P * T,
                "fused_update": (1 if cls is async_dp.SyncPodDP else P) * T}
        check({k: counts[k] for k in want} == want,
              f"pods {label}: launched {counts}, expected {want}")
        check(all(math.isfinite(x) for x in losses),
              f"pods {label}: losses {losses}")
        out[label] = {"losses": losses, "ms": ms}
        print(f"  {label}: losses {[round(x, 5) for x in losses]}, "
              f"{ms:.1f} ms a step (host wall, warm-up included), "
              f"launches {want} as predicted")
        del algo
        gc.collect()
        torch.cuda.empty_cache()
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    worst = 0.0
    for label, cls, kw in (("sync", async_dp.SyncPodDP, {}),
                           ("async predict d8", async_dp.AsyncPodDP,
                            {"predict": True, "delay": 8}),
                           ("async stale", async_dp.AsyncPodDP,
                            {"predict": False})):
        runs = []
        for dev in ("cuda", "cpu"):
            w0, bat, loss_fn = _toy_problem(torch, dev)
            algo = cls(loss_fn, w0, lr=DP_TOY_LR, **kw)
            ls = [algo.step(bat(s))["loss"] for s in range(DP_TOY_STEPS)]
            ps = algo.params if isinstance(algo.params, list) \
                else [algo.params]
            runs.append((ls, [t.cpu() for p in ps for t in tree_leaves(p)]))
        (lc, pc), (lh, ph) = runs
        for a, b in zip(lc, lh):
            check(abs(a - b) <= DP_TOY_TOL * (1 + abs(b)),
                  f"toy {label}: loss {a} on the card, {b} on the CPU")
        for a, b in zip(pc, ph):
            d = float((a - b).abs().max())
            worst = max(worst, d)
            check(torch.allclose(a, b, rtol=DP_TOY_TOL, atol=DP_TOY_TOL),
                  f"toy {label}: params differ by {d:.3e}")
    print(f"  the tests' toy problem ({DP_TOY_STEPS} steps at lr "
          f"{DP_TOY_LR}; sync, async predict delay 8, async stale): card "
          f"against CPU within {DP_TOY_TOL} (largest |d| {worst:.3e})")
    out["toy_worst"] = worst
    return out


def dp_train(torch, ops, ref, mpmd_runs=None) -> dict:
    """The data-parallel baseline through ``repro_torch.launch.train.main
    --mode sync --pipe 1 --data N`` (see the module docstring, phase
    19), held to the one-process sync step, beside phase 16's MPMD 1f1b
    round and the P40 timeline model."""
    from repro_torch.bench import _timeline as tl
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.runtime import sharding as rsh
    out = {"update_rows": dp_update_timings(torch, ops, ref)}
    cards = torch.cuda.device_count()
    if cards > 1:
        topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True,
                              timeout=TIMEOUT_S)
        print("  interconnect (nvidia-smi topo -m):")
        for line in (topo.stdout or topo.stderr).splitlines():
            print(f"    {line}")
    cfg = train.build(train.parse_args(DP_ARGV))
    L = cfg.n_layers
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "fused_update": 1}
    phase(f"dp_train: the one-process sync step, {ARCH} full width, {L} "
          f"layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}, bf16, {DP_STEPS} "
          f"steps (the reference)")
    (one,), one_s = _dp_run(torch, 1, want, "one process")
    n_params = sum(math.prod(sp.shape) for sp in tree_leaves(
        Model(cfg, device="cpu").param_specs()))
    one_wall = _median(_steady(one))
    print(f"  losses {[round(x, 6) for x in one['loss']]}; step wall "
          f"{one_wall:.3f} ms, {TRAIN_BATCH * TRAIN_SEQ / one_wall * 1e3:.1f}"
          f" tokens/s; busy {one['busy_ms']:.3f} ms; peak "
          f"{one['peak_bytes'] / 2**30:.2f} GiB; run {one_s:.1f} s")
    sizes = [math.prod(sp.shape) for sp in tree_leaves(
        Model(cfg, device="cpu").param_specs())]
    out["one"] = {"wall_ms": one_wall, "busy_ms": one["busy_ms"],
                  "peak_bytes": one["peak_bytes"], "losses": one["loss"]}
    runs = {}
    for n in DP_SIZES:
        if n > 2 and n > cards:
            peak = max(r["peak_bytes"] for r in runs[2]["reps"])
            total = torch.cuda.get_device_properties(0).total_memory
            print(f"\n  --data {n} on {cards} card(s): {n} replicas x "
                  f"{peak / 2**30:.2f} GiB (the measured peak of a --data "
                  f"2 replica) = {n * peak / 2**30:.1f} GiB against the "
                  f"card's {total / 2**30:.1f} GiB: reckoned, not run (each "
                  f"replica holds the whole model: fp32 params, momentum "
                  f"and gradients of {n_params:,} parameters alone are "
                  f"{12 * n_params / 1e9:.1f} GB)")
            runs[n] = {"reckoned_bytes": n * peak}
            continue
        transport = rsh.choose_transport("cuda", n)
        phase(f"dp_train: repro_torch.launch.train.main --mode sync --pipe 1 "
              f"--data {n}, {ARCH} full width, {L} layers, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} ({TRAIN_BATCH // n} rows a "
              f"replica), bf16, {DP_STEPS} steps, {transport}")
        out["pods_ref"] = dp_blocks_reference(torch, cfg, n)
        reps, run_s = _dp_run(torch, n, want, f"--data {n}")
        want_t = rsh.describe_transport(transport, n)
        check(all(r["transport"] == want_t for r in reps),
              f"--data {n}: transport {reps[0]['transport']!r}, expected "
              f"{want_t!r}")
        for rep in reps:
            prev = {k: 0 for k in want}
            for s_, c in enumerate(rep["counts"]):
                got = {k: c[k] - prev[k] for k in want}
                check(got == want, f"--data {n}: replica {rep['rank']} step "
                      f"{s_} launched {got}, expected {want}")
                prev = c
            check(rep["variants"][-1]["flash_fwd_mma"] == L * DP_STEPS,
                  f"--data {n}: replica {rep['rank']} ran flash_fwd off the "
                  f"tensor cores")
            # ZeRO-1: one reduce-scatter of the fp32 gradient and one
            # all-gather of the fp32 weights a step, bucketed alike
            rs = zero1_traffic([sizes], n)
            for s_, x in enumerate(rep["xfer"]):
                check((x["n_reduce"], x["n_rs"], x["bytes_rs"], x["n_ag"],
                       x["bytes_ag"], x["n_sent"], x["n_ctl"])
                      == (0,) + rs + rs + (0, 0),
                      f"--data {n}: replica {rep['rank']} step {s_} moved "
                      f"{x}, expected a reduce-scatter and an all-gather of "
                      f"{rs[0]} calls and {rs[1]} B each")
            check(rep["momentum_bytes"] == 4 * sum(
                rsh.shard_range(m, rep["rank"], n)[1]
                - rsh.shard_range(m, rep["rank"], n)[0] for m in sizes),
                  f"--data {n}: replica {rep['rank']} holds "
                  f"{rep['momentum_bytes']} B of momentum, not its ZeRO-1 "
                  f"pieces")
            for s_ in range(DP_STEPS):
                check(rep["digests"][s_] == reps[0]["digests"][s_],
                      f"--data {n}: replica {rep['rank']} differs from "
                      f"replica 0 after step {s_}: "
                      + str(sorted(k for k, v in rep["digests"][s_].items()
                                   if v != reps[0]["digests"][s_][k])[:3]))
        losses = [sum(r["loss"][s_] for r in reps) / n
                  for s_ in range(DP_STEPS)]
        for a, b in zip(losses, one["loss"]):
            check(abs(a - b) <= 1e-5 + 1e-4 * abs(b),
                  f"--data {n}: losses {losses} against the one process's "
                  f"{one['loss']} beyond rtol 1e-4 / atol 1e-5")
        # the replicas against SyncPodDP on the same row blocks in one
        # process: the same GEMM shapes, so bit-equal at N = 2 (a + b = b +
        # a), within rtol 1e-4 / atol 1e-5 beyond (the ring's order)
        blocks = out["pods_ref"]
        same = sum(reps[0]["digests"][-1][k] == d
                   for k, d in blocks["digests"].items())
        b_excess = _sample_excess(reps[0]["samples"], blocks["samples"])
        print(f"  against SyncPodDP on the same {n} row blocks in one "
              f"process: {same}/{len(blocks['digests'])} leaves bit-equal, "
              f"losses {'bit-equal' if losses == blocks['losses'] else 'differ'}"
              f" ({[round(x, 6) for x in blocks['losses']]}); largest sample "
              f"excess over rtol 1e-4 {b_excess[0][0]:.3e}")
        if n == 2:
            check(same == len(blocks["digests"])
                  and losses == blocks["losses"],
                  f"--data {n}: the replicas are not bit-equal to SyncPodDP "
                  f"on the same row blocks ({same}/{len(blocks['digests'])} "
                  f"leaves)")
        for a, b in zip(losses, blocks["losses"]):
            check(abs(a - b) <= 1e-5 + 1e-4 * abs(b),
                  f"--data {n}: losses {losses} against SyncPodDP's "
                  f"{blocks['losses']}")
        check(b_excess[0][0] <= 1e-5, f"--data {n}: leaf {b_excess[0][1]} "
              f"differs from SyncPodDP's beyond rtol 1e-4 / atol 1e-5")
        # against the one process on the whole batch: the losses and the
        # params within rtol 1e-4 / atol 1e-5; the momentum holds the
        # gradients, whose bf16 GEMMs round otherwise at 4,096 rows than
        # at 2,048, so it is held to the bf16 tolerance (2e-2) of each
        # leaf's scale, its excess over rtol 1e-4 printed
        excess = _sample_excess(reps[0]["samples"], one["samples"])
        worst = excess[0][0]
        print("  leaf samples against the one process on the whole batch, "
              "the three largest excesses over rtol 1e-4 (excess, leaf, "
              "replica, one process, largest |value| of the sample): "
              + "; ".join(f"{e:.3e} {k} {x:.6e} {y:.6e} {m:.3e}"
                          for e, k, x, y, m, _ in excess[:3]))
        for e, k, _, _, m, d in excess:
            if k.startswith("params/"):
                check(e <= 1e-5, f"--data {n}: leaf {k} differs from the one "
                      f"process's beyond rtol 1e-4 / atol 1e-5 (sample "
                      f"excess {e:.3e})")
            else:
                check(d <= TOL["bfloat16"] * m,
                      f"--data {n}: leaf {k} differs from the one process's "
                      f"by {d:.3e}, beyond 2e-2 of its scale {m:.3e}")
        walls = _steady(reps[0])
        check(bool(walls), f"--data {n}: no unprofiled steady step")
        wall = _median(walls)
        reduce_ms = [_steady_xfer(r, "xfer", "reduce_s")
                     + _steady_xfer(r, "xfer", "gather_s") for r in reps]
        rec = {"n": n, "transport": reps[0]["transport"], "wall_ms": wall,
               "walls_ms": walls, "tok_per_s": TRAIN_BATCH * TRAIN_SEQ
               / wall * 1e3, "busy_ms": [r["busy_ms"] for r in reps],
               "n_kernels": [r["n_kernels"] for r in reps],
               "reduce_ms": reduce_ms,
               "peak_bytes": [r["peak_bytes"] for r in reps],
               "losses": losses, "sample_excess": worst, "run_s": run_s,
               "launches": {k: n * v * DP_STEPS for k, v in want.items()},
               "reps": [{"peak_bytes": r["peak_bytes"]} for r in reps]}
        runs[n] = rec
        print(f"  transport: {rec['transport']}")
        print(f"  launches a step, every replica: {want}, exact on every "
              f"step, every attention launch on the tensor cores; ZeRO-1: "
              f"a reduce-scatter of {rs[0]} calls and {rs[1]:,} B and an "
              f"all-gather of as many a step per replica ({n_params:,} "
              f"parameters); momentum held {reps[0]['momentum_bytes']:,} B "
              f"a replica (whole: {4 * n_params:,} B)")
        print(f"  replicas bit-equal after every step (params, and the "
              f"momentum pieces combined into whole leaves, "
              f"{len(reps[0]['digests'][0])} leaves); losses "
              f"{[round(x, 6) for x in losses]} against the one process's "
              f"{[round(x, 6) for x in one['loss']]} (rtol 1e-4 / atol "
              f"1e-5); params samples within rtol 1e-4 / atol 1e-5, momentum "
              f"within 2e-2 of each leaf's scale (largest excess over rtol "
              f"1e-4 of any leaf {worst:.3e})")
        print(f"  step wall (replica 0, median of the unprofiled steady "
              f"steps {[round(w, 3) for w in walls]}): {wall:.3f} ms, "
              f"{rec['tok_per_s']:.1f} tokens/s (one process {one_wall:.3f} "
              f"ms); per replica: busy "
              f"{[round(b, 3) for b in rec['busy_ms']]} ms in "
              f"{rec['n_kernels']} kernels (profiled step "
              f"{reps[0]['prof_step']}), reduce-scatter + all-gather host "
              f"{[round(t, 1) for t in reduce_ms]} ms a step, peak "
              f"{[round(p / 2**30, 2) for p in rec['peak_bytes']]} GiB; run "
              f"{run_s:.1f} s")
    out["runs"] = runs
    # the paper's modelled platform, for the same model and batch
    base = get_config(ARCH)
    m = tl.ModelCost(f"{ARCH} {L} layers", n_params,
                     2.0 * n_params * TRAIN_SEQ,
                     (base.d_model * TRAIN_SEQ,) * 3, batch=TRAIN_BATCH)
    out["p40_ratio"] = {n: tl.dp_step_time(m, n)["step"]
                        / tl.pipeline_step_time(m, n)["step"]
                        for n in (2, 4)}
    print(f"\n  P40 timeline model (bench/_timeline.py, the paper's 4x P40 "
          f"PCIe platform, not this card), {ARCH} {L} layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: Data-P step / Model-P step "
          f"{out['p40_ratio'][2]:.2f} at 2 GPUs, {out['p40_ratio'][4]:.2f} "
          f"at 4")
    if mpmd_runs:
        r = mpmd_runs["1f1b spectrain"]
        out["mpmd_wall_ms"] = r["wall_ms"]
        print(f"  beside phase 16's MPMD 1f1b round on {TRAIN_LAYERS} "
              f"layers and the same {TRAIN_BATCH * TRAIN_SEQ} tokens "
              f"({r['transport']}): {r['wall_ms']:.3f} ms")
    out["pods"] = dp_pods(torch, ops)
    return out


# phase 28: the data axis under the pipelines (the JAX package's GSPMD
# hybrid): full-width granite-8b at DATA_PIPE_LAYERS layers in
# DATA_PIPE_STAGES stages a replica (840 M parameters; 4 layers before
# phase 29 took the time: the gloo-host transport bounds every step),
# the training batch, DP_STEPS steps
DATA_PIPE_ARGV = ["--arch", ARCH, "--layers", str(DATA_PIPE_LAYERS),
                  "--pipe", str(DATA_PIPE_STAGES), "--batch",
                  str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--dtype",
                  "bfloat16", "--data-kind", "uniform", "--seed", "0",
                  "--steps", str(DP_STEPS), "--log-every", "1"]
# (label, flags, microbatches a step): the streaming tick (one reduction
# a tick) and a 1f1b round of 4 microbatches (one reduction a round)
# ZeRO-1 holds half the fp32 momentum a replica (2 B a parameter less):
# each replica's peak must land at least this share of it below the
# one-process run's, whose momentum is whole (the replicated layout's
# peak; its replicas' peaks sat within 0.3 GiB of it)
DATA_PIPE_PEAK_DROP = 0.8
DATA_PIPE_RUNS = (("tick spectrain", ["--mode", "spectrain"], 1),
                  ("1f1b spectrain", ["--schedule", "1f1b"], 4))
# the replicas' mean loss against the one process on the whole batch:
# bf16's unit roundoff (2^-8) of the loss, relative.  The two compute
# the same function of the same tokens; their bf16 GEMMs round the
# activations of 2,048 rows apart from those of 4,096, so a loss is
# known to a bf16 ulp, no better
DATA_PIPE_LOSS_RTOL = 2.0 ** -8


def zero1_update_check(torch, ops) -> dict:
    """``fused_update`` on ZeRO-1 pieces: a stage tree of full-width
    granite-8b (2 layers, fp32 w / v / g, fp32 ŵ) cut at odd offsets
    into views that end one leaf and start the next, as the replicas'
    pieces would be if cut across leaves; one launch over the views
    against the plain version on the same views, max |d| over w', v'
    and ŵ, which must be 0 (the kernel reads and writes each element
    alone)."""
    from repro_torch.kernels import ref
    phase("phase 28 (data_pipe): fused_update on ZeRO-1 pieces at odd "
          "offsets spanning leaves, against its plain version")
    specs = group_specs("stage", 2)
    ws, vs, gs, whats = make_group(torch, specs, lambda path: True, seed=7)
    n = sum(w.numel() for w in ws)
    cuts = [0, n // 3 + 1, 2 * n // 3 + 3, n]      # odd interior offsets
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        off, part = 0, []
        for i, w in enumerate(ws):
            lo, hi = max(a, off) - off, min(b, off + w.numel()) - off
            if lo < hi:
                part.append((i, lo, hi))
            off += w.numel()
        pieces.append(part)
    views = [v for part in pieces for v in part]
    span = sum(1 for part in pieces if len(part) > 1)
    kw = dict(lr=0.01, gamma=0.9, s=2.0)
    worst = 0.0
    ops.reset_launch_counts()
    for part in pieces:
        pw, pv, pg, ph = ([t[i].view(-1)[lo:hi] for i, lo, hi in part]
                          for t in (ws, vs, gs, whats))
        want = [ref.fused_update_ref(w, v, g, what_dtype=h.dtype, **kw)
                for w, v, g, h in zip(pw, pv, pg, ph)]
        ops.fused_update(pw, pv, pg, whats=ph, **kw)
        torch.cuda.synchronize()
        for got, w3 in zip(zip(pw, pv, ph), want):
            for x, y in zip(got, w3):
                worst = max(worst, float((x.float() - y.float()).abs()
                                         .max()))
    launches = ops.launch_counts()["fused_update"]
    check(worst == 0.0, f"fused_update on ZeRO-1 pieces: max |d| {worst}")
    check(launches == len(cuts) - 1, f"fused_update on ZeRO-1 pieces: "
          f"{launches} launches for {len(cuts) - 1} pieces")
    out = {"elements": n, "pieces": len(cuts) - 1, "views": len(views),
           "across_leaves": span, "max_abs_err": worst,
           "offsets": cuts[1:-1]}
    print(f"  {n:,} elements of {len(ws)} leaves cut at {cuts[1:-1]} into "
          f"{len(cuts) - 1} pieces ({len(views)} views, {span} pieces "
          f"spanning leaves), one launch a piece: max |d| "
          f"{worst} against the plain version")
    del ws, vs, gs, whats
    gc.collect()
    torch.cuda.empty_cache()
    return out


def data_pipe_launches(L: int, S: int, M: int, stream: bool) -> dict:
    """The exact launches a step of one replica (a tick, or a round of M
    microbatches): every layer's forward twice (the backward recomputes
    it), its two backward kernels once, one ``fused_update`` a stage
    tree and one for the outer tree."""
    k = 1 if stream else M
    return {"flash_fwd": 2 * L * k, "flash_bwd_dq": L * k,
            "flash_bwd_dkv": L * k, "fused_update": S + 1}


def data_pipe(torch, ops) -> dict:
    """Phase 28: ``repro_torch.launch.train.main --data N`` under the
    streaming SpecTrain tick and the 1f1b round (see DATA_PIPE_ARGV),
    each against the one-process run of the same flags on the same
    tokens: per replica and step the exact launches (every attention
    launch on the tensor cores), one gradient reduction a tick or a
    round of ⌈4n / 256 MiB⌉ calls and 4n bytes (and no other traffic),
    the replicas' params, momentum and ``pred`` bit-equal after every
    step, the mean loss within DATA_PIPE_LOSS_RTOL of the one process's;
    the step wall, the reduction's host seconds and the idle share.
    ``--data 2`` always (sharing the card over gloo-host when there is
    one), ``--data 4`` on the tick where there are 4 cards (NCCL; the
    1f1b round's 4 microbatches of 2 rows do not split 4 ways)."""
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.runtime import sharding as rsh
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    cfg = train.build(train.parse_args(DATA_PIPE_ARGV))
    L, S = cfg.n_layers, DATA_PIPE_STAGES
    specs = Model(cfg, device="cpu").param_specs()
    leaf_sizes = [math.prod(sp.shape) for sp in tree_leaves(specs)]
    # spectrain's ŵ: embed.tok and every stage leaf (fp32: the launcher
    # keeps no fused_predict)
    pred_sizes = [math.prod(specs["outer"]["embed"]["tok"].shape)] + [
        math.prod(sp.shape) for sp in tree_leaves(specs["stages"])]
    n_params = sum(leaf_sizes)
    out = {"n_params": n_params, "runs": {},
           "fu_pieces": zero1_update_check(torch, ops)}
    for label, flags, M in DATA_PIPE_RUNS:
        argv = DATA_PIPE_ARGV + flags
        stream = "--schedule" not in flags
        want = data_pipe_launches(L, S, M, stream)
        phase(f"phase 28 (data_pipe): the one-process reference, {label}, "
              f"{ARCH} full width, {L} layers in {S} stages, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, bf16, {DP_STEPS} steps")
        (one,), one_s = _dp_run(torch, 1, want, f"{label} one process",
                                argv)
        one_wall = _median(_steady(one))
        print(f"  losses {[round(x, 6) for x in one['loss']]}; step wall "
              f"{one_wall:.3f} ms, busy {one['busy_ms']:.3f} ms; peak "
              f"{one['peak_bytes'] / 2**30:.2f} GiB; run {one_s:.1f} s")
        sizes = (2, 4) if stream and cards >= 4 else (2,)
        for n in sizes:
            transport = rsh.choose_transport("cuda", n)
            what = f"--data {n} {label}"
            phase(f"phase 28 (data_pipe): repro_torch.launch.train.main "
                  f"{' '.join(flags)} --data {n}, {ARCH} full width, {L} "
                  f"layers in {S} stages a replica, batch {TRAIN_BATCH} x "
                  f"{TRAIN_SEQ} ({TRAIN_BATCH // (n * M)} rows of each of "
                  f"{M} microbatch{'es' if M > 1 else ''} a replica), bf16, "
                  f"{DP_STEPS} steps, {transport}")
            reps, run_s = _dp_run(torch, n, want, what, argv)
            want_t = rsh.describe_transport(transport, n)
            check(all(r["transport"] == want_t for r in reps),
                  f"{what}: transport {reps[0]['transport']!r}, expected "
                  f"{want_t!r}")
            for rep in reps:
                prev = {k: 0 for k in want}
                for s_, c in enumerate(rep["counts"]):
                    got = {k: c[k] - prev[k] for k in want}
                    check(got == want, f"{what}: replica {rep['rank']} step "
                          f"{s_} launched {got}, expected {want}")
                    prev = c
                check(rep["variants"][-1]["flash_fwd_mma"]
                      == want["flash_fwd"] * DP_STEPS,
                      f"{what}: replica {rep['rank']} ran flash_fwd off the "
                      f"tensor cores")
                # ZeRO-1: one reduce-scatter of the fp32 gradient, the
                # fp32 weights' all-gather and, on the spectrain tick,
                # ŵ's (the 1f1b round's reads lag 0: no prediction)
                rs = zero1_traffic([leaf_sizes], n)
                ag = zero1_traffic([leaf_sizes] + ([pred_sizes] if stream
                                                   else []), n)
                for s_, x in enumerate(rep["xfer"]):
                    check((x["n_reduce"], x["n_rs"], x["bytes_rs"],
                           x["n_ag"], x["bytes_ag"], x["n_stat"],
                           x["n_sent"], x["n_ctl"])
                          == (0,) + rs + ag + (0, 0, 0),
                          f"{what}: replica {rep['rank']} step {s_} moved "
                          f"{x}, expected a reduce-scatter of {rs} and "
                          f"all-gathers of {ag} (calls, B)")
                held = 4 * sum(rsh.shard_range(m, rep["rank"], n)[1]
                               - rsh.shard_range(m, rep["rank"], n)[0]
                               for m in leaf_sizes)
                check(rep["momentum_bytes"] == held,
                      f"{what}: replica {rep['rank']} holds "
                      f"{rep['momentum_bytes']} B of momentum, its ZeRO-1 "
                      f"pieces are {held} B")
                drop = DATA_PIPE_PEAK_DROP * (4 * n_params - held)
                check(rep["peak_bytes"] <= one["peak_bytes"] - drop,
                      f"{what}: replica {rep['rank']} peak "
                      f"{rep['peak_bytes'] / 2**30:.2f} GiB, not "
                      f"{drop / 2**30:.2f} GiB below the one process's "
                      f"{one['peak_bytes'] / 2**30:.2f} GiB (whole "
                      f"momentum)")
                for s_ in range(DP_STEPS):
                    check(rep["digests"][s_] == reps[0]["digests"][s_],
                          f"{what}: replica {rep['rank']} differs from "
                          f"replica 0 after step {s_}: " + str(sorted(
                              k for k, v in rep["digests"][s_].items()
                              if v != reps[0]["digests"][s_][k])[:3]))
            losses = [sum(r["loss"][s_] for r in reps) / n
                      for s_ in range(DP_STEPS)]
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, one["loss"]))
            check(rel <= DATA_PIPE_LOSS_RTOL,
                  f"{what}: losses {losses} against the one process's "
                  f"{one['loss']}: {rel:.3e} relative, beyond "
                  f"{DATA_PIPE_LOSS_RTOL:.3e}")
            excess = _sample_excess(reps[0]["samples"], one["samples"])
            walls = _steady(reps[0])
            check(bool(walls), f"{what}: no unprofiled steady step")
            wall = _median(walls)
            reduce_ms = [_steady_xfer(r, "xfer", "reduce_s") for r in reps]
            gather_ms = [_steady_xfer(r, "xfer", "gather_s") for r in reps]
            busy = [r["busy_ms"] for r in reps]
            rec = {"n": n, "transport": reps[0]["transport"],
                   "wall_ms": wall, "walls_ms": walls,
                   "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / wall * 1e3,
                   "busy_ms": busy, "idle": [1 - b / wall for b in busy],
                   "n_kernels": [r["n_kernels"] for r in reps],
                   "reduce_ms": reduce_ms, "gather_ms": gather_ms,
                   "rs": rs, "ag": ag,
                   "momentum_bytes": [r["momentum_bytes"] for r in reps],
                   "losses": losses,
                   "one_losses": one["loss"], "loss_rel": rel,
                   "one_wall_ms": one_wall, "one_busy_ms": one["busy_ms"],
                   "peak_bytes": [r["peak_bytes"] for r in reps],
                   "run_s": run_s, "sample_excess": excess[0][0],
                   "per_step": want,
                   "launches": {k: n * v * DP_STEPS
                                for k, v in want.items()}}
            out["runs"][(label, n)] = rec
            print(f"  transport: {rec['transport']}")
            print(f"  launches a step, every replica: {want}, exact on every "
                  f"step, every attention launch on the tensor cores; "
                  f"ZeRO-1 once a {'tick' if stream else 'round'}: a "
                  f"reduce-scatter of {rs[0]} calls and {rs[1]:,} B, "
                  f"all-gathers of {ag[0]} calls and {ag[1]:,} B per "
                  f"replica ({n_params:,} parameters), nothing else sent; "
                  f"momentum held {rec['momentum_bytes']} B a replica "
                  f"(whole {4 * n_params:,})")
            print(f"  replicas bit-equal after every step (params, the "
                  f"momentum pieces combined{', pred' if stream else ''}: "
                  f"{len(reps[0]['digests'][0])} leaves); losses "
                  f"{[round(x, 6) for x in losses]} against the one "
                  f"process's {[round(x, 6) for x in one['loss']]}: "
                  f"{rel:.3e} relative (allowed {DATA_PIPE_LOSS_RTOL:.3e}); "
                  f"leaf samples' largest excess over rtol 1e-4 "
                  f"{excess[0][0]:.3e} ({excess[0][1]})")
            print(f"  step wall (replica 0, median of the unprofiled steady "
                  f"steps {[round(w, 3) for w in walls]}): {wall:.3f} ms, "
                  f"{rec['tok_per_s']:.1f} tokens/s (one process "
                  f"{one_wall:.3f} ms); reduce-scatter host "
                  f"{[round(t, 1) for t in reduce_ms]} ms, all-gathers "
                  f"{[round(t, 1) for t in gather_ms]} ms a step; busy "
                  f"{[round(b, 3) for b in busy]} ms in {rec['n_kernels']} "
                  f"kernels (profiled step {reps[0]['prof_step']}), idle "
                  f"{[round(i, 4) for i in rec['idle']]}; peak "
                  f"{[round(p / 2**30, 2) for p in rec['peak_bytes']]} GiB "
                  f"(one process, whole momentum: "
                  f"{one['peak_bytes'] / 2**30:.2f} GiB); run {run_s:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 28: {out['seconds']:.1f} s")
    return out


# phase 29: the tensor axis, full-width granite-8b at 4 layers in 2
# stages (1,275 M parameters), the training batch, spectrain, DP_STEPS
# ticks, and a short fp32 pair (2 layers, 4 x 256) held to the one
# process at the CPU tests' tolerance; phase 30: the MoE, state-space
# and MLA decoders at full width on 4 x 256 tokens (TENSOR_MODELS).  All
# of their tensor ranks run in one spawn of the two ranks, which share
# the card over gloo-host
TENSOR_RANKS, TENSOR_LAYERS = 2, 4
TENSOR_ARGV = ["--arch", ARCH, "--layers", str(TENSOR_LAYERS), "--pipe",
               str(DATA_PIPE_STAGES), "--batch", str(TRAIN_BATCH), "--seq",
               str(TRAIN_SEQ), "--dtype", "bfloat16", "--data-kind",
               "uniform", "--seed", "0", "--steps", str(DP_STEPS),
               "--log-every", "1", "--mode", "spectrain"]
TENSOR_FP32_ARGV = ["--arch", ARCH, "--layers", "2", "--pipe", "2",
                    "--batch", "4", "--seq", "256", "--dtype", "float32",
                    "--data-kind", "uniform", "--seed", "0", "--steps",
                    str(DP_STEPS), "--log-every", "1", "--mode",
                    "spectrain"]
# (arch, layers) of phase 30, each in 2 stages: zamba2's shared block
# fires after every 10th layer of a stage, so 20 layers is the least
# depth at which each stage fires it once; grok-1-314b's one full-width
# layer (4.8 B parameters, >= 77 GB of fp32 state) does not fit the card
TENSOR_MODELS = (("deepseek-moe-16b", 2), ("rwkv6-7b", 2),
                 ("zamba2-1.2b", 20), ("minicpm3-4b", 2))
TENSOR_MODEL_BATCH, TENSOR_MODEL_SEQ = TP_ROWS, TP_SEQ
# the bf16 tick against the one-process tick: each row-parallel output
# (wo, w2: 2 a layer) and the embedding's lookup is rounded to bf16 on
# each rank before the ranks' halves are added, an extra rounding of at
# most 2^-8 relative an element that the loss, a mean over 4,096
# tokens, carries far below; the data axis's bound
TENSOR_LOSS_RTOL = 2.0 ** -8
TENSOR_FP32_TOL = (1e-4, 1e-5)      # rtol, atol: the CPU tests'


def tensor_model_argv(arch: str, layers: int) -> list:
    return ["--arch", arch, "--layers", str(layers), "--pipe",
            str(DATA_PIPE_STAGES), "--batch", str(TENSOR_MODEL_BATCH),
            "--seq", str(TENSOR_MODEL_SEQ), "--dtype", "bfloat16",
            "--data-kind", "uniform", "--seed", "0", "--steps",
            str(DP_STEPS), "--log-every", "1", "--mode", "spectrain"]


def tensor_launches(cfg, L: int, S: int) -> tuple:
    """(launches, variant launches) a spectrain tick a rank, the one
    process's at the rank's heads: 2L forwards and L of each backward
    kernel of the attention layers (zamba2: its shared block's firings),
    2L scans and L scan backwards of the SSM layers (chunked at s >=
    64), S + 1 ``fused_update``."""
    if cfg.ssm is not None:
        return ssm_train_launches(cfg.name, L, S)
    want = data_pipe_launches(L, S, 1, True)
    return want, {"flash_fwd_mma": 2 * L, "flash_bwd_dq_mma": L,
                  "flash_bwd_dkv_mma": L}


def tensor_all_reduces(cfg, L: int, S: int, rows: int, seq: int,
                       el: int = 2) -> tuple:
    """(calls, bytes) of one spectrain tick's tensor all-reduces a rank at
    T = 2, activations [rows, seq, d] in the compute dtype (``el``
    bytes, A below): the inject's embedding, the head's column-parallel
    input's cotangent and the embedding backward's lookup (3 A) and the
    head's max, sum of exponentials and gold logit ([rows, seq] fp32);
    then a layer's row-parallel outputs forward and again in the
    backward's recompute, and the cotangents backward of what enters the
    rank's heads or experts: a dense layer 6 A (a replicated K/V's two
    weight gradients beside); an MoE layer 6 A, the router made whole
    ([d, E]) twice and the gates ([rows·seq, k]); an rwkv6 layer 9 A (the
    four mixes in one call) and the decay's cotangent in fp32; a mamba2
    layer 3 A, B and C, and the gated norm's sums of squares ([rows,
    seq] fp32, three times); an MLA layer 5 A and its latents and rope
    key; each firing of zamba2's shared block 6 A.  The same formulas
    the CPU tests hold at el 4 (``tests/test_torch_tensor_*.py``)."""
    tok = rows * seq
    A = tok * cfg.d_model * el
    calls, nbytes = 6, 3 * A + 3 * tok * 4
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        calls += 7 * L
        nbytes += L * (9 * A + tok * cfg.d_model * 4)
    elif cfg.ssm is not None:
        bc = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        calls += 7 * L
        nbytes += L * (3 * A + 3 * tok * 4 + tok * bc * el)
        fires = S * ((L // S) // cfg.ssm.shared_attn_every)
        calls += 6 * fires
        nbytes += 6 * A * fires
    elif cfg.mla is not None:
        m = cfg.mla
        calls += 8 * L
        nbytes += L * (5 * A + tok * el * (m.q_lora_rank + m.kv_lora_rank
                                           + m.qk_rope_head_dim))
    else:
        kv_rep = cfg.n_kv_heads % 2 != 0
        calls += L * (6 + 2 * kv_rep)
        nbytes += L * (6 * A + kv_rep * 2 * cfg.d_model * cfg.n_kv_heads
                       * cfg.hd * 4)
        if cfg.moe is not None:
            calls += 3 * L
            nbytes += L * (2 * cfg.d_model * cfg.moe.num_experts * el
                           + tok * cfg.moe.top_k * el)
    return calls, nbytes


def _launcher_run(torch, argv, probe, log=None) -> tuple:
    """(the launcher's argv, its plan, its runtime config, the probe, the
    log directory): one run of :func:`_launcher_ranks`."""
    from repro_torch.api import runtime_config_from_args
    from repro_torch.launch import train
    args = train.parse_args(argv)
    pplan, _ = train.run_plan(args, train.build(args), torch.device("cuda"))
    return (argv, pplan, runtime_config_from_args(
        args, ticks_per_step=max(args.ticks, 1)), probe, log)


def _check_tensor_reps(reps, want, var, what, n_ar, b_ar) -> None:
    """Every rank's launches a tick exact (and their variants over the
    run), its tensor all-reduces a tick exact, nothing over the data
    axis."""
    for rep in reps:
        prev = {k: 0 for k in want}
        for s_, c in enumerate(rep["counts"]):
            got = {k: c[k] - prev[k] for k in want}
            check(got == want, f"{what}: rank {rep['rank']} tick {s_} "
                  f"launched {got}, expected {want}")
            prev = c
        got_var = {k: rep["variants"][-1][k] for k in var}
        check(got_var == {k: v * DP_STEPS for k, v in var.items()},
              f"{what}: rank {rep['rank']} ran the variants {got_var}, "
              f"expected {var} a tick (tensor cores, chunked scans)")
        for s_, x in enumerate(rep["tp"]):
            check((x["n_tp"], x["bytes_tp"]) == (n_ar, b_ar),
                  f"{what}: rank {rep['rank']} tick {s_} ran "
                  f"{x['n_tp']} tensor all-reduces of {x['bytes_tp']} B, "
                  f"expected {n_ar} of {b_ar} B")
        for x in rep["xfer"] + rep.get("dxfer", []):
            check(x["n_reduce"] + x["n_rs"] + x["n_sent"] == 0,
                  f"{what}: rank {rep['rank']} moved {x} over the data "
                  f"axis, which has one replica")


def _tensor_record(reps, one, want, n_ar, b_ar, rows, seq, what,
                   run_s) -> dict:
    """The ranks' losses against each other and the one process's (within
    2^-8), and the tick's wall, busy, idle share, peak and all-reduce
    host seconds a rank."""
    check(reps[0]["loss"] == reps[1]["loss"],
          f"{what}: the ranks' losses differ: {reps[0]['loss']} vs "
          f"{reps[1]['loss']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(reps[0]["loss"],
                                                 one["loss"]))
    check(rel <= TENSOR_LOSS_RTOL,
          f"{what}: losses {reps[0]['loss']} against the one process's "
          f"{one['loss']}: {rel:.3e} relative, beyond "
          f"{TENSOR_LOSS_RTOL:.3e}")
    walls = _steady(reps[0])
    check(bool(walls), f"{what}: no unprofiled steady tick")
    wall = _median(walls)
    busy = [r["busy_ms"] for r in reps]
    return {"wall_ms": wall, "walls_ms": walls,
            "one_wall_ms": _median(_steady(one)),
            "tok_per_s": rows * seq / wall * 1e3,
            "busy_ms": busy, "idle": [1 - b / wall for b in busy],
            "n_kernels": [r["n_kernels"] for r in reps],
            "tp_ms": [_steady_xfer(r, "tp", "tp_s") for r in reps],
            "n_tp": n_ar, "bytes_tp": b_ar, "losses": reps[0]["loss"],
            "one_losses": one["loss"], "loss_rel": rel,
            "peak_bytes": [r["peak_bytes"] for r in reps],
            "one_peak_bytes": one["peak_bytes"],
            "transport": reps[0]["transport"], "per_tick": want,
            "launches": {k: TENSOR_RANKS * v * DP_STEPS
                         for k, v in want.items()},
            "prof_step": reps[0]["prof_step"], "run_s": run_s}


def _print_tensor_record(rec: dict, heads: str) -> None:
    print(f"  launches a tick, every rank: {rec['per_tick']}, exact on "
          f"every tick ({heads}); {rec['n_tp']} tensor all-reduces a "
          f"tick of {rec['bytes_tp']:,} B a rank, exact")
    print(f"  losses {[round(x, 6) for x in rec['losses']]} (both ranks) "
          f"against the one-process tick's "
          f"{[round(x, 6) for x in rec['one_losses']]}: "
          f"{rec['loss_rel']:.3e} relative (allowed "
          f"{TENSOR_LOSS_RTOL:.3e})")
    print(f"  tick wall (rank 0, median of the unprofiled steady ticks "
          f"{[round(w, 3) for w in rec['walls_ms']]}): "
          f"{rec['wall_ms']:.3f} ms, {rec['tok_per_s']:.1f} tokens/s (one "
          f"process {rec['one_wall_ms']:.3f} ms); tensor all-reduce host "
          f"{[round(t, 1) for t in rec['tp_ms']]} ms a tick; busy "
          f"{[round(b, 3) for b in rec['busy_ms']]} ms in "
          f"{rec['n_kernels']} kernels (profiled tick {rec['prof_step']}), "
          f"idle {[round(i, 4) for i in rec['idle']]}; peak "
          f"{[round(p / 2**30, 2) for p in rec['peak_bytes']]} GiB (one "
          f"process {rec['one_peak_bytes'] / 2**30:.2f}); run "
          f"{rec['run_s']:.1f} s in the shared spawn")


def tensor_train(torch, ops) -> dict:
    """Phases 29 and 30: ``repro_torch.launch.train.main --tensor 2``'s
    ranks (see the module docstring) on granite-8b, its fp32 pair and
    the four models of :data:`TENSOR_MODELS`, in one spawn of the two
    ranks: the exact launches a tick per rank, the tensor all-reduces a
    tick, the losses tick by tick against the one-process tick of the
    same flags (run first, in this process), the fp32 pair at the CPU
    tolerance, and the tick's wall, busy, idle share, peak and transport
    seconds per rank."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_stage_ranks
    from repro_torch.runtime import sharding as rsh
    t_phase = time.perf_counter()
    T, S = TENSOR_RANKS, DATA_PIPE_STAGES
    transport = rsh.choose_transport("cuda", T)
    want_t = rsh.describe_transport(transport, T)
    tmp = Path(tempfile.mkdtemp(prefix="tensor_"))
    runs = [("granite", TENSOR_ARGV, TRAIN_BATCH, TRAIN_SEQ)] + [
        (arch, tensor_model_argv(arch, n), TENSOR_MODEL_BATCH,
         TENSOR_MODEL_SEQ) for arch, n in TENSOR_MODELS]
    out, ones, cases, plan = {}, {}, [], []
    try:
        for key, argv, rows, seq in runs:
            cfg = train.build(train.parse_args(argv))
            L = cfg.n_layers
            want, var = tensor_launches(cfg, L, S)
            phase(f"phase {29 if key == 'granite' else 30} (tensor_train): "
                  f"the one-process tick, {cfg.name} full width, {L} layers "
                  f"in {S} stages, bf16, {rows} x {seq}, {DP_STEPS} ticks")
            (ones[key],), _ = _dp_run(torch, 1, want, f"{cfg.name} one "
                                      f"process", argv, symbols=TRAIN_SYMBOL,
                                      digests=False)
            d = tmp / key
            d.mkdir()
            cases.append(_launcher_run(torch, argv + [
                "--tensor", str(T)], DpProbe(
                    str(d), f"{cfg.name} --tensor {T}", want,
                    symbols=TRAIN_SYMBOL, digests=False)))
            plan.append((key, cfg, want, var, rows, seq, d))
        phase(f"phase 29 (tensor_train): the one-process fp32 pair, {ARCH} "
              f"full width, 2 layers in {S} stages, batch 4 x 256, fp32 "
              f"(TF32 off), {DP_STEPS} ticks")
        (one32,) = _loss_run(TENSOR_FP32_ARGV, 1)
        d32 = tmp / "fp32"
        d32.mkdir()
        cases.insert(1, _launcher_run(torch, TENSOR_FP32_ARGV + [
            "--tensor", str(T)], LossProbe(str(d32), DP_STEPS)))
        phase(f"phases 29 and 30 (tensor_train): repro_torch.launch."
              f"train.main --tensor {T}'s ranks, one spawn on the card "
              f"({transport}): {ARCH} (4 layers, 8 x 512), its fp32 pair, "
              f"then {', '.join(f'{a} ({n} layers)' for a, n in TENSOR_MODELS)}"
              f" at 4 x 256, bf16, {DP_STEPS} ticks each")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        secs = run_stage_ranks(_launcher_ranks, T, "cuda", args=(cases,))
        spawn_s = time.perf_counter() - t0
        print(f"  the ranks' spawn and {len(cases)} runs: {spawn_s:.1f} s; "
              f"each run on rank 0 {[round(x, 1) for x in secs[0]]} s")
        run_s = [max(r[i] for r in secs) for i in range(len(cases))]
        del run_s[1]                    # the fp32 pair's
        for (key, cfg, want, var, rows, seq, d), rs in zip(plan, run_s):
            phase(f"phase {29 if key == 'granite' else 30} (tensor_train): "
                  f"the checks of {cfg.name} --tensor {T}")
            reps = [json.loads((d / f"rank{r}.json").read_text())
                    for r in range(T)]
            what = f"{cfg.name} --tensor {T} tick spectrain"
            check(all(r["transport"] == want_t for r in reps),
                  f"{what}: transport {reps[0]['transport']!r}, expected "
                  f"{want_t!r}")
            n_ar, b_ar = tensor_all_reduces(cfg, cfg.n_layers, S, rows,
                                            seq)
            _check_tensor_reps(reps, want, var, what, n_ar, b_ar)
            rec = _tensor_record(reps, ones[key], want, n_ar, b_ar, rows,
                                 seq, what, rs)
            rec.update(arch=cfg.name, layers=cfg.n_layers, rows=rows,
                       seq=seq, heads=_rank_heads(cfg, T))
            out["bf16" if key == "granite" else cfg.name] = rec
            print(f"  {cfg.name} ({rec['transport']}):")
            _print_tensor_record(rec, rec["heads"])
        phase(f"phase 29 (tensor_train): the checks of the fp32 pair")
        tp32 = [json.loads((d32 / f"rank{r}.json").read_text())["loss"]
                for r in range(T)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(tp32[0] == tp32[1], f"fp32 --tensor {T}: the ranks' losses "
          f"differ: {tp32}")
    rtol, atol = TENSOR_FP32_TOL
    for a, b in zip(tp32[0], one32):
        check(abs(a - b) <= atol + rtol * abs(b),
              f"fp32 --tensor {T}: losses {tp32[0]} against the one "
              f"process's {one32} beyond rtol {rtol} / atol {atol}")
    worst = max(abs(a - b) for a, b in zip(tp32[0], one32))
    out["fp32"] = {"losses": tp32[0], "one": one32, "max_abs": worst,
                   "run_s": max(r[1] for r in secs)}
    out["spawn_s"] = spawn_s
    print(f"  fp32: losses {[round(x, 7) for x in tp32[0]]} (both ranks) "
          f"against the one process's {[round(x, 7) for x in one32]}: "
          f"max |d| {worst:.3e} (rtol {rtol} / atol {atol})")
    if torch.cuda.device_count() >= 4:
        out["grid"] = tensor_grid(torch)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phases 29 and 30: {out['seconds']:.1f} s")
    return out


def _rank_heads(cfg, T: int) -> str:
    """What a tensor rank of ``cfg`` holds, for the record."""
    if cfg.moe is not None:
        return (f"{cfg.moe.num_experts // T} of {cfg.moe.num_experts} "
                f"experts, {cfg.n_heads // T} of {cfg.n_heads} heads over "
                f"{cfg.n_kv_heads // T} KV heads")
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return f"{cfg.n_heads // T} of {cfg.n_heads} rwkv6 heads"
    if cfg.ssm is not None:
        nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        return (f"{nh // T} of {nh} mamba2 heads, the shared block's "
                f"{cfg.n_heads // T} of {cfg.n_heads} heads")
    if cfg.mla is not None:
        return f"{cfg.n_heads // T} of {cfg.n_heads} MLA heads at (96, 64)"
    return (f"{cfg.n_heads // T} of {cfg.n_heads} query heads over "
            f"{cfg.n_kv_heads // T} KV heads")


def tensor_grid(torch) -> dict:
    """Where there are four cards, over NCCL, a card a rank: granite-8b
    at ``--tensor 4`` and ``--data 2 --tensor 2``, then the four models of
    :data:`TENSOR_MODELS` at ``--tensor 4``, in one spawn of the four
    ranks: each rank's exact launches and the ranks' agreement, the
    tick's wall, the collectives' host seconds (the tensor all-reduces,
    ZeRO-1's reduce-scatter and all-gathers) and the peaks.  No check
    beyond the launches and the ranks' agreement depends on four
    cards."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_stage_ranks
    out, cases, plan = {}, [], []
    tmp = Path(tempfile.mkdtemp(prefix="tensor_grid_"))
    runs = [(ARCH, TENSOR_ARGV, 1, 4), (ARCH, TENSOR_ARGV, 2, 2)] + [
        (arch, tensor_model_argv(arch, n), 1, 4)
        for arch, n in TENSOR_MODELS]
    try:
        for i, (arch, argv, n, t) in enumerate(runs):
            cfg = train.build(train.parse_args(argv))
            want, _ = tensor_launches(cfg, cfg.n_layers, DATA_PIPE_STAGES)
            d = tmp / str(i)
            d.mkdir()
            cases.append(_launcher_run(torch, argv + [
                "--data", str(n), "--tensor", str(t)], DpProbe(
                    str(d), f"{arch} --data {n} --tensor {t}", want,
                    symbols=TRAIN_SYMBOL, digests=False)))
            plan.append((arch, n, t, want, d))
        phase(f"phase 29 (tensor_train): over NCCL, a card a rank, one "
              f"spawn of 4 ranks: {ARCH} --tensor 4 and --data 2 --tensor "
              f"2, then {', '.join(a for a, _ in TENSOR_MODELS)} --tensor "
              f"4, bf16, {DP_STEPS} ticks each")
        gc.collect()
        torch.cuda.empty_cache()
        secs = run_stage_ranks(_launcher_ranks, 4, "cuda", args=(cases,))
        for i, (arch, n, t, want, d) in enumerate(plan):
            what = f"{arch} --data {n} --tensor {t}"
            reps = [json.loads((d / f"rank{r}.json").read_text())
                    for r in range(4)]
            for rep in reps:
                prev = {k: 0 for k in want}
                for s_, c in enumerate(rep["counts"]):
                    got = {k: c[k] - prev[k] for k in want}
                    check(got == want, f"{what}: rank {rep['rank']} tick "
                          f"{s_} launched {got}, expected {want}")
                    prev = c
            for dd in range(n):         # a replica's tensor ranks agree
                grp = reps[dd * t:(dd + 1) * t]
                check(all(r["loss"] == grp[0]["loss"] for r in grp),
                      f"{what}: replica {dd}'s tensor ranks' losses differ")
            wall = _median(_steady(reps[0]))
            rec = {"wall_ms": wall, "run_s": max(r[i] for r in secs),
                   "tp_ms": [_steady_xfer(r, "tp", "tp_s") for r in reps],
                   "data_ms": [_steady_xfer(r, "dxfer", "reduce_s")
                               + _steady_xfer(r, "dxfer", "gather_s")
                               if "dxfer" in r else 0.0 for r in reps],
                   "busy_ms": [r["busy_ms"] for r in reps],
                   "peak_bytes": [r["peak_bytes"] for r in reps],
                   "transport": reps[0]["transport"]}
            out[(arch, n, t)] = rec
            print(f"  {what} ({rec['transport']}): tick wall {wall:.3f} ms; "
                  f"busy {[round(b, 3) for b in rec['busy_ms']]} ms; tensor "
                  f"all-reduce host {[round(x, 3) for x in rec['tp_ms']]} "
                  f"ms, ZeRO-1 host {[round(x, 3) for x in rec['data_ms']]}"
                  f" ms a tick; peak "
                  f"{[round(p / 2**30, 2) for p in rec['peak_bytes']]} GiB; "
                  f"run {rec['run_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def run_tensor_only() -> int:
    """``python3 chip_smoke.py --tensor-only``: the card, the build and
    phases 29 and 30 alone (with four cards, their NCCL grid runs too)."""
    torch = _torch_or_none()
    if torch is None:
        return 2
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6
    t_start = _T0[0] = time.perf_counter()
    try:
        info = card_info(torch)
        build_kernels(build, r6, m2, fa, fu)
        torch.backends.cuda.matmul.allow_tf32 = False
        tens = tensor_train(torch, ops)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print_tensor(tens)
    print_phase_seconds()
    print(f"chip_smoke --tensor-only: passed in "
          f"{time.perf_counter() - t_start:.1f}s on {info['smi']}")
    return 0


def print_tensor(tens: dict) -> None:
    for key in ["bf16"] + [a for a, _ in TENSOR_MODELS]:
        r = tens[key]
        print(f"tensor axis --tensor {TENSOR_RANKS} tick spectrain, "
              f"{r['arch']} ({r['layers']} layers, {r['rows']} x "
              f"{r['seq']}, {r['transport']}): {r['wall_ms']:.3f} ms a tick "
              f"(one process {r['one_wall_ms']:.3f}), {r['n_tp']} tensor "
              f"all-reduces of {r['bytes_tp']:,} B a tick a rank in "
              f"{[round(x, 1) for x in r['tp_ms']]} ms, busy "
              f"{[round(b, 3) for b in r['busy_ms']]} ms, idle "
              f"{[round(i, 4) for i in r['idle']]}, peak "
              f"{[round(p / 2**30, 2) for p in r['peak_bytes']]} GiB; "
              f"losses within {r['loss_rel']:.3e} of the one process's")
    print(f"tensor axis fp32 pair max |d| {tens['fp32']['max_abs']:.3e}; "
          f"the ranks' one spawn {tens['spawn_s']:.1f} s")


def print_data_pipe(dpipe: dict) -> None:
    """Phase 28's summary lines."""
    for (label, n), r in dpipe["runs"].items():
        print(f"data axis --data {n} {label} ({r['transport']}, ZeRO-1): "
              f"{r['wall_ms']:.3f} ms a step (one process "
              f"{r['one_wall_ms']:.3f}), reduce-scatter {r['reduce_ms']} "
              f"ms, all-gathers {r['gather_ms']} ms, idle "
              f"{[round(i, 4) for i in r['idle']]}; peak "
              f"{[round(p / 2**30, 2) for p in r['peak_bytes']]} GiB; "
              f"losses within {r['loss_rel']:.3e} of the one process's; "
              f"replicas bit-equal every step")
    print(f"fused_update on ZeRO-1 pieces: {dpipe['fu_pieces']}")


def mpmd_serve(torch, ops, pipelined: dict, archs=PIPE_ARCHS) -> dict:
    """``repro_torch.launch.serve.main --execution mpmd`` (4 ranks on the
    card) on granite-8b and rwkv6-7b (or ``archs``) at ``PIPE_DEPTH``,
    held to phase 13's scan run (module docstring, phase 17)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    out = {}
    for arch in archs:
        phase(f"mpmd_serve: repro_torch.launch.serve.main --execution "
              f"mpmd, {_depth(arch)} {arch}, bf16, {PIPE_PLAN['n_stages']} "
              f"ranks on "
              f"the card")
        scan = pipelined[arch]
        L = PIPE_DEPTH.get(arch) or get_config(arch).n_layers
        name = "flash_fwd" if get_config(arch).ssm is None else "rwkv6_scan"
        gc.collect()
        torch.cuda.empty_cache()
        reps = []
        t0 = time.perf_counter()
        rc = serve.main(["--arch", arch, *PIPE_ARGV, *_depth_argv(arch),
                         "--execution", "mpmd"], ranks_out=reps)
        run_s = time.perf_counter() - t0
        check(rc == 0, f"{arch}: serve.main --execution mpmd returned {rc}")
        got, want = reps[0]["results"], scan["results"]
        same = [rid for rid in want if got.get(rid) == want[rid]]
        if len(same) != len(want):
            rid = next(r for r in sorted(want) if got.get(r) != want[r])
            a, b = list(got.get(rid, ())), list(want[rid])
            at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      min(len(a), len(b)))
            print(f"  first difference: request {rid} at token {at}: "
                  f"mpmd {a[at:at + 4]} vs scan {b[at:at + 4]}")
        check(len(same) == len(want), f"{arch}: {len(same)}/{len(want)} "
              f"requests' tokens equal the scan backend's")
        launched = sum(rep["launches"][name] for rep in reps)
        check(launched == scan["launches"][name] - 2 * L,
              f"{arch}: the ranks launched {launched} {name}, the scan run "
              f"{scan['launches'][name]} with its warm-up round (2 x {L})")
        check(all(rep["n_waves"] == reps[0]["n_waves"] for rep in reps),
              f"{arch}: the ranks ran different waves")
        n_tokens = sum(len(t) for t in got.values())
        tok_s = n_tokens / reps[0]["wall_s"]
        rounds = sorted(reps[0]["round_ms"])
        steady_ms = rounds[len(rounds) // 2]
        res = {"equal": (len(same), len(want)), "tok_per_s": tok_s,
               "scan_tok_per_s": scan["run_tok_per_s"],
               "round_ms": steady_ms, "launches": launched,
               "per_rank": [rep["launches"][name] for rep in reps],
               "sent": [rep["n_sent"] for rep in reps],
               "bytes_sent": [rep["bytes_sent"] for rep in reps],
               "transport_s": [rep["transport_s"] for rep in reps],
               "run_s": run_s}
        print(f"  tokens equal the scan backend's for {len(same)}/"
              f"{len(want)} requests; {name} launches per rank "
              f"{res['per_rank']} (sum {launched} = the scan run's without "
              f"its warm-up round)")
        print(f"  {tok_s:.2f} tok/s over run() after warm-up (scan backend "
              f"{scan['run_tok_per_s']:.2f}); median round "
              f"{steady_ms:.3f} ms on rank 0; payloads sent per rank "
              f"{res['sent']} ({[round(b / 1e6, 2) for b in res['bytes_sent']]}"
              f" MB), transport {[round(t, 3) for t in res['transport_s']]}"
              f" s; run {run_s:.1f} s")
        out[arch] = res
    return out


def bwd_timing(torch, fa, ref, case, bwd_errs) -> list:
    """dq and dk/dv alone at ``case`` (bf16, through the launchers
    flash_bwd itself uses) beside their bound, the plain version and
    SDPA's backward: one row each."""
    import torch.nn.functional as F
    q, k, v, o, lse, do = case.all_tensors(torch, fa, seed=9)
    kw = case.kw()
    launch_dq, launch_dkv, _ = fa._bwd_launchers(q, k, v, o, lse, do,
                                                 **kw)
    ms_dq, _ = time_ms(torch, launch_dq, 20)
    ms_dkv, _ = time_ms(torch, launch_dkv, 20)
    ms_wrap, wall_wrap = time_ms(
        torch, lambda: fa.flash_bwd(q, k, v, o, lse, do, **kw), 20)
    plain_ms, _ = time_ms(
        torch, lambda: ref.flash_bwd_ref(q, k, v, o, lse, do, **kw), 5)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=case.causal,
                                        enable_gqa=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                           retain_graph=True)
    lib_ms, _ = time_ms(torch, sdpa_bwd, 20)
    lib_kernels = library_kernels(torch, sdpa_bwd)
    print(f"  {case.name}: SDPA backward ran {lib_kernels}")
    rows = []
    for name, which, ms in (("flash_bwd_dq", "dq", ms_dq),
                            ("flash_bwd_dkv", "dkv", ms_dkv)):
        b_ms, b_by = case.bound(which)
        rows.append({"name": name, "shape": case.name, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "library_kernels": lib_kernels,
                     "max_abs_err": bwd_errs[case.name][which]})
        print(f"  {name:<14} {case.name}: kernel {ms:.4f} ms  bound "
              f"{b_ms:.5f} ms ({b_by})  plain (dq, dk, dv together) "
              f"{plain_ms:.4f} ms  SDPA backward (dq, dk, dv together) "
              f"{lib_ms:.4f} ms")
    print(f"  flash_bwd wrapper (dl + both kernels): {ms_wrap:.4f} ms "
          f"device, {wall_wrap:.4f} ms wall per call; dq + dk/dv "
          f"{ms_dq + ms_dkv:.4f} ms = {(ms_dq + ms_dkv) / lib_ms:.2f}x SDPA "
          f"backward")
    return rows


def train_timings(torch, fa, ref, ops, bwd_errs) -> list:
    from repro_torch.kernels import fused_update as fu
    phase("timings of the training kernels (CUDA events, after warm-up)")
    rows = []
    by_shape = [bwd_timing(torch, fa, ref, BwdCase(
        "train b8 512 causal bfloat16", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
        32, 8, 128, "bfloat16", True), bwd_errs)]
    # granite-20b's and starcoder2-15b's, and a tensor rank's (phases 29
    # and 30)
    for tag, heads in WIDE_GQA + TP_GQA:
        by_shape.append(bwd_timing(torch, fa, ref, BwdCase(
            f"{tag} train b8 512 causal bfloat16", TRAIN_BATCH, TRAIN_SEQ,
            TRAIN_SEQ, *heads, "bfloat16", True), bwd_errs))
    for tag, heads, dv in TP_RANK_ATTN:
        by_shape.append(bwd_timing(torch, fa, ref, BwdCase(
            f"{tag} train b{TP_ROWS} {TP_SEQ} causal bfloat16", TP_ROWS,
            TP_SEQ, TP_SEQ, *heads, "bfloat16", True, dv=dv), bwd_errs))
    for i in range(2):                 # dq, dk/dv: granite-8b's the row
        rows.append(dict(by_shape[0][i],
                         shapes=[shape[i] for shape in by_shape]))

    # the main path's two kinds of group, fp32 w/v/g: one stage (2
    # full-width layers, fp32 ŵ for every leaf) and the outer tree (fp32
    # ŵ for embed.tok only); each checked once against its plain version,
    # then timed
    fu_rows = []
    for label, specs, predicted in (
            (f"one stage ({TRAIN_LAYERS // TRAIN_STAGES} layers), ŵ on "
             f"every leaf", group_specs("stage", TRAIN_LAYERS // TRAIN_STAGES),
             lambda path: True),
            ("outer tree, ŵ on embed.tok", group_specs("outer"),
             lambda path: path == ("embed", "tok"))):
        ws, vs, gs, whats = make_group(torch, specs, predicted)
        n = sum(w.numel() for w in ws)
        n_pred = sum(w.numel() for w in (whats or []) if w is not None)
        err = fu_compare(torch, ops, ref, ws, vs, gs, whats, label)
        ms, _ = time_ms(torch, lambda: ops.fused_update(
            ws, vs, gs, whats=whats, **FU_KW), 10)
        plain_ms, _ = time_ms(torch, lambda: [
            ref.fused_update_ref(w, v, g, **FU_KW) for w, v, g in
            zip(ws, vs, gs)], 3)
        params = [torch.nn.Parameter(w) for w in ws]
        for p_, g in zip(params, gs):
            p_.grad = g
        # dampening = gamma gives v' = gamma v + (1 - gamma) g (the
        # paper's form); it writes w' and v' but no prediction
        opt = torch.optim.SGD(params, lr=FU_KW["lr"],
                              momentum=FU_KW["gamma"],
                              dampening=FU_KW["gamma"], fused=True)
        lib_ms, _ = time_ms(torch, opt.step, 10)
        # w, v, g read; w', v' written; ŵ written where predicted
        # (fused_update.cost)
        b_ms, b_by = bound_of(*fu.cost(n, n_pred), "float32")
        nbytes = fu.cost(n, n_pred)[1]
        shape = (f"{label}: {len(ws)} tensors, {n} elements, fp32 "
                 f"w/v/g/ŵ")
        fu_rows.append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms, "max_abs_err": err})
        print(f"  fused_update   {shape} ({nbytes / 1e9:.2f} GB): one "
              f"launch against its plain version max |d| {err:.3e} (tol "
              f"{FU_TOL['float32']:g}); kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s)  bound {b_ms:.4f} ms "
              f"(bytes)  plain {plain_ms:.4f} ms  "
              f"torch.optim.SGD(fused, no ŵ) {lib_ms:.4f} ms")
        del ws, vs, gs, whats, params, opt
    rows.append({"name": "fused_update", **fu_rows[0], "shapes": fu_rows})
    return rows


# ---------------------------------------------------------------------------
# multi-head latent attention (phase 24): minicpm3-4b, its 40 heads at
# G = 1 with q.k width 64 + 32 and v width 64

MLA_ARCH = "minicpm3-4b"
MLA_HEADS = (40, 40, 96)            # heads, KV heads (G = 1), q.k width
MLA_DV = 64                         # v width
MLA_TRAIN_LAYERS = 8                # of 62, in 4 stages (689,377,280 params)
# width pairs the kernels are not built for: each must raise on the card
MLA_REFUSED_PAIRS = ((96, 96), (64, 96), (128, 64))


def mla_cases(kind: str) -> list:
    """minicpm3-4b's attention calls at (96, 64), fp32 and bf16:
    ``"fwd"`` decode over 64 keys and prefill n = 12 (serving), the
    tick's [8, 512] causal (training); ``"bwd"`` prefill n = 12 and the
    training shape; then edges in bf16: decode at kv_len 1 (one row of
    the one-warp block), 65 queries (row 64 opens a block), kv_len 77 of
    100 without a mask, an offset causal block."""
    cases = []
    for dt in ("float32", "bfloat16"):
        if kind == "fwd":
            cases.append(Case(f"MLA decode kv_len=64 {dt}", 1, 1, 64,
                              *MLA_HEADS, dt, False, 63, 64, dv=MLA_DV))
        cases.append(Case(f"MLA prefill n=12 {dt}", 1, 12, 12, *MLA_HEADS,
                          dt, True, dv=MLA_DV))
        cases.append(Case(f"MLA train b8 512 causal {dt}", TRAIN_BATCH,
                          TRAIN_SEQ, TRAIN_SEQ, *MLA_HEADS, dt, True,
                          dv=MLA_DV))
    for name, b, sq, sk, H, off, kv_len, causal in (
            ("decode kv_len 1", 1, 1, 64, 40, 0, 1, False),
            ("65 queries", 2, 65, 65, 8, 0, 65, True),
            ("kv_len 77 of 100", 1, 40, 100, 4, 0, 77, False),
            ("offset 29 causal", 1, 21, 50, 8, 29, 50, True)):
        cases.append(Case(f"MLA edge {name} bfloat16", b, sq, sk, H, H, 96,
                          "bfloat16", causal, off, kv_len, dv=MLA_DV))
    if kind == "bwd":
        cases = [BwdCase(c.name, c.b, c.sq, c.sk, c.H, c.KV, c.d, c.dtype,
                         c.causal, c.q_offset, c.kv_len, dv=c.dv)
                 for c in cases]
    return cases


def mla_wave_cases() -> list:
    """The MLA decode wave's call: R = 8 rows of 40 heads at the waves'
    ragged lengths, each on its own gathered page (identity pages)."""
    return [PagedCase(f"MLA wave R=8 ragged {dt}", *MLA_HEADS, dt,
                      WAVE_LENS, range(8), n_pages=7, dv=MLA_DV)
            for dt in ("float32", "bfloat16")]


def mla_kernel_checks(torch, fa, ref) -> dict:
    """Phase 24's kernel checks: the forward, the paged wave, dq and dk/dv
    at (96, 64) against their plain versions at phases 3 and 8's
    tolerances, one launch of the dtype's variant each; then every
    wrapper raises on a width pair that has no kernel, launching
    nothing."""
    phase("phase 24: the flash kernels at MLA's widths (q.k 96, v 64) "
          "against their plain versions on the card")
    errs = {"fwd": {}, "paged": {}, "bwd": {}}
    for i, case in enumerate(mla_cases("fwd")):
        e_o, e_l = compare(torch, fa, ref, case, seed=500 + i)
        errs["fwd"][case.name] = e_o
        print(f"  {case.name:<44} max|d o| {e_o:.3e}  max|d lse| "
              f"{e_l:.3e}  (tol {TOL[case.dtype]:g})")
    for i, case in enumerate(mla_wave_cases()):
        errs["paged"][case.name] = paged_compare(torch, fa, ref, case,
                                                 seed=520 + i)
    for i, case in enumerate(mla_cases("bwd")):
        e = compare_bwd(torch, fa, ref, case, seed=540 + i)
        errs["bwd"][case.name] = e
        print(f"  {case.name:<44} max|d dq| {e['dq']:.3e}  max|d dk,dv| "
              f"{e['dkv']:.3e}  (tol {BWD_TOL[case.dtype]})")
    counts = (fa.launches, fa.launches_dq, fa.launches_dkv)
    for dk, dv in MLA_REFUSED_PAIRS:
        q = torch.zeros(1, 3, 2, dk, device="cuda", dtype=torch.bfloat16)
        k = torch.zeros(1, 5, 2, dk, device="cuda", dtype=torch.bfloat16)
        v = torch.zeros(1, 5, 2, dv, device="cuda", dtype=torch.bfloat16)
        o = torch.zeros(1, 3, 2, dv, device="cuda", dtype=torch.bfloat16)
        lse = torch.zeros(1, 2, 3, device="cuda")
        one = torch.ones(1, dtype=torch.int32, device="cuda")
        for what, call in (
                ("flash_fwd", lambda: fa.flash_fwd(q, k, v, causal=True)),
                ("flash_fwd_paged", lambda: fa.flash_fwd_paged(
                    q[:, :1], k, v, one - 1, one)),
                ("flash_bwd", lambda: fa.flash_bwd(q, k, v, o, lse, o,
                                                   causal=True))):
            try:
                call()
            except ValueError as exc:
                check(f"(q.k {dk}, v {dv})" in str(exc),
                      f"{what} at ({dk}, {dv}) raised another error: {exc}")
            else:
                raise SmokeFailure(f"{what} at ({dk}, {dv}) did not raise")
        check(fa.smem_bytes("fwd_mma", dk, dv) == -1,
              f"the forward library has a kernel at ({dk}, {dv})")
    torch.cuda.synchronize()
    check((fa.launches, fa.launches_dq, fa.launches_dkv) == counts,
          "a refused width pair launched a kernel")
    print(f"  width pairs {MLA_REFUSED_PAIRS}: flash_fwd, flash_fwd_paged "
          f"and flash_bwd each raise ValueError naming the pair, nothing "
          f"launched; the kernels take {fa.WIDTH_PAIRS}")
    return errs


def mla_serving(torch, ops) -> dict:
    """Phase 24's serving: ``repro_torch.launch.serve.main`` on
    minicpm3-4b (bf16, seed 0) through SimpleEngine at full depth (62
    layers; as phase 5: exact launches, finite logits; one decode step
    under the profiler) and the pipelined engine at ``PIPE_DEPTH`` (as
    phase 13's first run: exact
    launches a round; then run() again after warm-up for tok/s, the same
    tokens); MPMD follows in :func:`mpmd_serve`."""
    from repro_torch.configs import get_config
    L = get_config(MLA_ARCH).n_layers
    out = {"simple": main_path(torch, ops, MLA_ARCH, L)}
    gc.collect()
    torch.cuda.empty_cache()
    out["simple"]["profile"] = decode_profile(torch, MLA_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"pipelined serving: repro_torch.launch.serve.main --engine "
          f"pipelined, {_depth(MLA_ARCH)} {MLA_ARCH}, bf16")
    r = _pipelined_run(torch, ops, MLA_ARCH)
    eng, results = r["engine"], r["results"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.run(r["trace"])
    wall = time.perf_counter() - t0
    check(again == results, "a second pipelined run of the trace emitted "
          "other tokens than the first")
    run_tok_s = sum(len(t) for t in again.values()) / wall
    print(f"  pipelined, run()'s wall after warm-up: {run_tok_s:.2f} tok/s "
          f"({wall:.3f} s; the same tokens again)")
    out["pipelined"] = {
        "launches": r["counts"], "variants": r["variants"], "run": r["run"],
        "peak_bytes": r["peak"], "tok_per_s": r["tok_per_s"],
        "layers": r["L"], "rounds": r["rounds_run"], "results": results,
        "run_tok_per_s": run_tok_s}
    del r, eng, again
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mla_timings(torch, fa, ref, errs) -> dict:
    """Phase 24's timings (CUDA events, after warm-up, bf16): the forward
    at minicpm3-4b's decode, prefill and training shapes, the wave, and
    dq and dk/dv at the training shape, each beside its bound, its plain
    version and SDPA (which takes a v of another width)."""
    phase("phase 24: timings of the kernels at MLA's widths (CUDA events, "
          "after warm-up)")
    fwd = [fwd_row(torch, fa, ref, case, iters, errs["fwd"][case.name])
           for case, iters in (
               (Case("MLA decode kv_len=64 bfloat16", 1, 1, 64, *MLA_HEADS,
                     "bfloat16", False, 63, 64, dv=MLA_DV), 500),
               (Case("MLA prefill n=12 bfloat16", 1, 12, 12, *MLA_HEADS,
                     "bfloat16", True, dv=MLA_DV), 500),
               (Case("MLA train b8 512 causal bfloat16", TRAIN_BATCH,
                     TRAIN_SEQ, TRAIN_SEQ, *MLA_HEADS, "bfloat16", True,
                     dv=MLA_DV), 20))]
    fwd.append(_wave_row(torch, fa, ref, errs["paged"],
                         mla_wave_cases()[1]))
    bwd = bwd_timing(torch, fa, ref, BwdCase(
        "MLA train b8 512 causal bfloat16", TRAIN_BATCH, TRAIN_SEQ,
        TRAIN_SEQ, *MLA_HEADS, "bfloat16", True, dv=MLA_DV), errs["bwd"])
    return {"flash_fwd": fwd, "flash_bwd_dq": [bwd[0]],
            "flash_bwd_dkv": [bwd[1]]}


# ---------------------------------------------------------------------------
# encoder-decoder and the vision frontend (phase 25): whisper-base and the
# paper's transformer-paper (6 + 6 layers, d 512, 8 heads of 64), and
# pixtral-12b (40 layers, d 5120, 32 heads over 8 of 128, 256 patches)

ENCDEC_ARCHS = ("whisper-base", "transformer-paper")
ENCDEC_HEADS = (8, 8, 64)           # heads, KV heads, head_dim
WHISPER_FRAMES = 1500               # the encoder's fixed context
WHISPER_TEXT = 448                  # whisper's text context
PAPER_SRC, PAPER_TGT = 20, 64       # IMDb inputs cut to 20 words
ENCDEC_DECODE_STEPS = 32            # decode steps held to forward's logits
ENCDEC_DECODE_TOL = 2e-3            # JAX's test_decode_matches_forward's
ENCDEC_LR = 0.05
ENCDEC_SERVE_REQUESTS = 24
VLM_ARCH = "pixtral-12b"
VLM_HEADS = (32, 8, 128)
VLM_PATCHES = 256
VLM_FWD_LAYERS = 2                  # full width, card against the CPU
VLM_FWD_TOL = 1e-4                  # of max |logit|, fp32, TF32 off
VLM_TRAIN_LAYERS = 4                # of 40, in 4 stages


def encdec_cases(kind: str) -> list:
    """Phase 25's attention calls, fp32 and bf16: whisper's encoder
    self-attention (causal over 1500 frames: 23 64-key tiles and 28
    keys), its decoder's cross-attention (448 text positions against
    1500 frames, no mask) and its decode step's cross call (one query
    against 1500); transformer-paper's cross-attention (64 target
    positions against its 20-token source); ``"fwd"`` adds pixtral-12b's
    prefill of 256 patches and 8 text tokens (264 rows, causal)."""
    cases = []
    for dt in ("float32", "bfloat16"):
        cases += [
            Case(f"whisper encoder self 1500 causal {dt}", 2,
                 WHISPER_FRAMES, WHISPER_FRAMES, *ENCDEC_HEADS, dt, True),
            Case(f"whisper cross 448 x 1500 {dt}", 2, WHISPER_TEXT,
                 WHISPER_FRAMES, *ENCDEC_HEADS, dt, False),
            Case(f"transformer-paper cross 64 x 20 {dt}", 2, PAPER_TGT,
                 PAPER_SRC, *ENCDEC_HEADS, dt, False)]
        if kind == "fwd":
            cases += [
                Case(f"whisper decode cross 1 x 1500 {dt}", 1, 1,
                     WHISPER_FRAMES, *ENCDEC_HEADS, dt, False),
                Case(f"pixtral prefill 264 (256 patches) {dt}", 1, 264,
                     264, *VLM_HEADS, dt, True)]
    if kind == "bwd":
        cases = [BwdCase(c.name, c.b, c.sq, c.sk, c.H, c.KV, c.d, c.dtype,
                         c.causal, c.q_offset, c.kv_len) for c in cases]
    return cases


def encdec_kernel_checks(torch, fa, ref) -> dict:
    """Phase 25's kernel checks: the forward, dq and dk/dv at the enc-dec
    and pixtral shapes against their plain versions at phase 3's
    tolerances, one launch of the dtype's variant each."""
    phase("phase 25: the flash kernels at the enc-dec shapes (cross-"
          "attention, sq != sk, no mask; 1500 keys) against their plain "
          "versions on the card")
    errs = {"fwd": {}, "bwd": {}}
    for i, case in enumerate(encdec_cases("fwd")):
        e_o, e_l = compare(torch, fa, ref, case, seed=600 + i)
        errs["fwd"][case.name] = e_o
        print(f"  {case.name:<44} max|d o| {e_o:.3e}  max|d lse| "
              f"{e_l:.3e}  (tol {TOL[case.dtype]:g})")
    for i, case in enumerate(encdec_cases("bwd")):
        e = compare_bwd(torch, fa, ref, case, seed=640 + i)
        errs["bwd"][case.name] = e
        print(f"  {case.name:<44} max|d dq| {e['dq']:.3e}  max|d dk,dv| "
              f"{e['dkv']:.3e}  (tol {BWD_TOL[case.dtype]})")
    return errs


def _encdec_batch(torch, cfg, b: int, seed: int) -> dict:
    """Full-width inputs on the card: whisper's 1500 frames and 448 text
    tokens, transformer-paper's 20 source and 64 target tokens."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = WHISPER_TEXT if cfg.frontend == "audio" else PAPER_TGT
    tok = lambda n: torch.randint(0, cfg.vocab_size, (b, n), generator=g,
                                  device="cuda")
    out = {"tokens": tok(T), "targets": tok(T)}
    if cfg.frontend == "audio":
        out["frames"] = torch.randn(b, WHISPER_FRAMES, cfg.d_model,
                                    generator=g, device="cuda")
    else:
        out["src_tokens"] = tok(PAPER_SRC)
    return out


def encdec_model_check(torch, ops) -> dict:
    """Phase 25's model checks on whisper-base and transformer-paper at
    full width (6 + 6 layers, d 512), fp32, TF32 off, random weights
    from seed 0 (FMA attention kernels): ``encode`` and
    ``encdec_prefill_cache``, then decode steps whose logits are held to
    ``forward``'s at each position on the card (JAX's
    test_decode_matches_forward, 2e-3); one ``loss`` -> backward -> SGD
    step (``optim.sgd``: one ``fused_update``) on the card against the
    same on the CPU at b = 2 (the loss to rel 1e-5, the stepped params
    to rtol 1e-4 / atol 1e-5, each momentum leaf, 0.1 of the gradient,
    within 1e-3 of its largest magnitude), with the launches exact
    (enc L + 2 dec L flash forwards and as many of each backward
    kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import sgd
    out = {}
    for arch in ENCDEC_ARCHS:
        cfg = get_config(arch).replace(compute_dtype="float32")
        phase(f"phase 25: {arch} full width ({cfg.n_enc_layers} + "
              f"{cfg.n_layers} layers, d {cfg.d_model}) on the card: "
              f"decode against forward, one SGD step against the CPU, fp32")
        gpu = Model(cfg)
        params = gpu.init(torch.Generator(device="cuda").manual_seed(0))
        batch = _encdec_batch(torch, cfg, 2, seed=1)
        with torch.inference_mode():
            t0 = time.perf_counter()
            enc = gpu.encode(params, batch)
            cache = gpu.encdec_prefill_cache(params, batch,
                                             ENCDEC_DECODE_STEPS)
            full, _ = gpu.forward(params, batch)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            check(bool(torch.isfinite(full).all()), f"{arch}: non-finite "
                  f"logits")
            check(tuple(cache["cross"]["k"].shape) == (
                cfg.n_layers, 2, enc.shape[1], cfg.n_kv_heads, cfg.hd),
                f"{arch}: cross cache {tuple(cache['cross']['k'].shape)}")
            errs = []
            for t in range(ENCDEC_DECODE_STEPS):
                lg, cache = gpu.decode_step(
                    params, cache, batch["tokens"][:, t:t + 1], t)
                errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
        err = max(errs)
        print(f"  encode {tuple(enc.shape)}, forward {tuple(full.shape)} "
              f"({fwd_s:.2f} s with the cross cache); {ENCDEC_DECODE_STEPS}"
              f" decode steps against forward's logits: max |d| {err:.3e} "
              f"(tol {ENCDEC_DECODE_TOL:g})")
        check(err <= ENCDEC_DECODE_TOL, f"{arch}: decode differs from "
              f"forward by {err}")
        del cache, full, enc
        # one loss -> backward -> SGD step, card against the CPU
        cpu = Model(cfg, device="cpu")
        runs = {}
        for name, model, p, b in (
                ("gpu", gpu, params, batch),
                ("cpu", cpu, _tree_to(params, "cpu"), _tree_to(batch,
                                                               "cpu"))):
            leaves = tree_map(lambda _, a: a.detach().clone()
                              .requires_grad_(), p)
            c0 = ops.launch_counts()
            t0 = time.perf_counter()
            loss = model.loss(leaves, b)
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
            it = iter(grads)
            g_tree = tree_map(lambda _, a: next(it), leaves)
            state = sgd.init(leaves)
            new = tree_map(lambda _, a: a.detach(), leaves)
            sgd.update(new, state, g_tree, lr=ENCDEC_LR)
            if name == "gpu":
                torch.cuda.synchronize()
            runs[name] = {"loss": float(loss.detach()), "params": new,
                          "v": state.v, "s": time.perf_counter() - t0,
                          "launches": {k: v - c0[k] for k, v in
                                       ops.launch_counts().items()}}
        L2 = cfg.n_enc_layers + 2 * cfg.n_layers
        want = {"flash_fwd": L2, "flash_bwd_dq": L2, "flash_bwd_dkv": L2,
                "fused_update": 1, "rwkv6_scan": 0, "mamba2_scan": 0,
                "rwkv6_scan_bwd": 0, "mamba2_scan_bwd": 0}
        g, c = runs["gpu"], runs["cpu"]
        check(g["launches"] == want, f"{arch}: the step launched "
              f"{g['launches']}, expected {want}")
        rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        check(rel <= 1e-5, f"{arch}: loss {g['loss']} vs {c['loss']}")
        worst_p = worst_v = 0.0
        for a, b in zip(tree_leaves(g["params"]), tree_leaves(c["params"])):
            a = a.cpu()
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
                  f"{arch}: a stepped param differs by "
                  f"{float((a - b).abs().max())}")
            worst_p = max(worst_p, float((a - b).abs().max()))
        for a, b in zip(tree_leaves(g["v"]), tree_leaves(c["v"])):
            e = float((a.cpu() - b).abs().max())
            scale = float(b.abs().max())
            check(e <= 1e-3 * scale, f"{arch}: a momentum leaf differs by "
                  f"{e:.3e}, beyond 1e-3 of its max {scale:.3e}")
            worst_v = max(worst_v, e / max(scale, 1e-30))
        print(f"  one SGD step at b 2 ({tuple(batch['tokens'].shape)} "
              f"tokens): loss {g['loss']:.6f} (CPU {c['loss']:.6f}, rel "
              f"{rel:.2e}); stepped params max |d| {worst_p:.3e}; momentum "
              f"worst |d| / max {worst_v:.2e}; card {g['s']:.2f} s, CPU "
              f"{c['s']:.2f} s; launches {g['launches']}")
        out[arch] = {"decode_err": err, "loss": g["loss"], "loss_rel": rel,
                     "param_err": worst_p, "mom_rel": worst_v,
                     "launches": g["launches"]}
        del gpu, cpu, params, runs, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def encdec_serving(torch, ops) -> dict:
    """``repro_torch.launch.serve.main`` on full whisper-base (SimpleEngine,
    the launcher's choice for enc-dec; bf16, seed 0) on 24 requests, as
    phase 5 checks its runs (2 L flash forwards a call: the decoder's
    self- and cross-attention), and one decode step profiled."""
    from repro_torch.configs import get_config
    arch = ENCDEC_ARCHS[0]
    out = main_path(torch, ops, arch, get_config(arch).n_layers,
                    requests=ENCDEC_SERVE_REQUESTS)
    out["profile"] = decode_profile(torch, arch)
    return out


def vlm_forward_check(torch) -> dict:
    """pixtral-12b at full width, ``VLM_FWD_LAYERS`` of its 40 layers,
    fp32: ``forward`` with 256 patches over the first of 264 positions on
    the card against the CPU (within ``VLM_FWD_TOL`` of the largest
    |logit|); the patches move every position's logits."""
    phase(f"phase 25: {VLM_ARCH} full width, {VLM_FWD_LAYERS} layers, "
          f"forward with {VLM_PATCHES} patches, card against the CPU, fp32")
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(VLM_ARCH)
    cfg = cfg.replace(n_layers=VLM_FWD_LAYERS, compute_dtype="float32",
                      mesh_plan=dataclasses.replace(cfg.mesh_plan, pipe=1))
    gpu = Model(cfg)
    params = gpu.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    s = VLM_PATCHES + 8
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s), generator=g,
                                     device="cuda"),
             "patches": torch.randn(1, VLM_PATCHES, cfg.d_model,
                                    generator=g, device="cuda")}
    with torch.inference_mode():
        l_g, _ = gpu.forward(params, batch)
        text, _ = gpu.forward(params, {"tokens": batch["tokens"]})
        torch.cuda.synchronize()
        moved = float((l_g - text).abs().amax(dim=(0, 2)).min())
        del text
        cpu = Model(cfg, device="cpu")
        p_cpu = _tree_to(params, "cpu")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        l_c, _ = cpu.forward(p_cpu, _tree_to(batch, "cpu"))
        cpu_s = time.perf_counter() - t0
    err = float((l_g.cpu() - l_c).abs().max())
    scale = float(l_c.abs().max())
    print(f"  logits {tuple(l_g.shape)}: card against CPU max |d| "
          f"{err:.3e}, {err / scale:.2e} of max |logit| {scale:.3f} (tol "
          f"{VLM_FWD_TOL:g}); the patches move every position by >= "
          f"{moved:.3e}; CPU forward {cpu_s:.1f} s")
    check(err <= VLM_FWD_TOL * scale, f"{VLM_ARCH}: the card's logits "
          f"differ from the CPU's by {err}")
    check(moved > 0, f"{VLM_ARCH}: the patches left a position unchanged")
    del gpu, cpu, p_cpu, l_g, l_c
    gc.collect()
    torch.cuda.empty_cache()
    return {"err": err, "rel": err / scale, "moved": moved}


def vlm_serving(torch, ops) -> dict:
    """pixtral-12b at full depth (40 layers, bf16, seed 0) through
    ``repro_torch.launch.serve.main``: SimpleEngine (as phase 5 checks
    its runs, one decode step profiled) and the pipelined engine (as
    phase 13's first run: exact launches a round)."""
    from repro_torch.configs import get_config
    out = {"simple": main_path(torch, ops, VLM_ARCH,
                               get_config(VLM_ARCH).n_layers)}
    out["simple"]["profile"] = decode_profile(torch, VLM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"pipelined serving: repro_torch.launch.serve.main --engine "
          f"pipelined, full {VLM_ARCH}, bf16")
    r = _pipelined_run(torch, ops, VLM_ARCH)
    out["pipelined"] = {
        "launches": r["counts"], "variants": r["variants"], "run": r["run"],
        "peak_bytes": r["peak"], "tok_per_s": r["tok_per_s"],
        "layers": r["L"], "rounds": r["rounds_run"]}
    del r
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encdec_timings(torch, fa, ref, errs) -> dict:
    """Phase 25's timings (CUDA events, after warm-up, bf16): the forward
    at the enc-dec and pixtral shapes, dq and dk/dv at whisper's cross
    shape and its 1500-frame encoder, each beside its bound, its plain
    version and SDPA (no mask for cross-attention, causal for the
    encoder; ``enable_gqa`` where G > 1)."""
    phase("phase 25: timings of the kernels at the enc-dec shapes (CUDA "
          "events, after warm-up)")
    fwd = [fwd_row(torch, fa, ref, case, 20 if case.sq > 64 else 500,
                   errs["fwd"][case.name])
           for case in encdec_cases("fwd") if case.dtype == "bfloat16"]
    dq, dkv = [], []
    for case in encdec_cases("bwd"):
        if case.dtype != "bfloat16" or case.sq == PAPER_TGT:
            continue
        rows = bwd_timing(torch, fa, ref, case, errs["bwd"])
        dq.append(rows[0])
        dkv.append(rows[1])
    return {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv}


# ---------------------------------------------------------------------------
# the paper's evaluation: the four-scheme simulator (Fig. 7), Fig. 8's
# RMSE and Table 1's ordering, on the full-width snn-paper

EVAL_ARCH, EVAL_CLASSES = "snn-paper", 10       # CIFAR-10's classes
# the loss plateaus near the label prior's entropy for ~300 steps and
# then falls: at 600 every scheme is well past the prior (sync ~1.76
# against 2.30, held-out accuracy ~0.40 against a 0.11 majority share)
EVAL_BATCH, EVAL_STEPS = 128, 600
# spectrain's second run, with Fig. 8's RMSEs, follows the first 150 steps
# of the same trajectory (its learning is checked on the first run; 300
# before phase 28 took the time)
EVAL_RMSE_STEPS = 150
EVAL_HELD = 4096                    # held-out teacher samples a scheme
# staleness shows at 0.01: vanilla and pipedream end above sync,
# spectrain near it; at 0.02 vanilla diverges, at 0.1 sync does too
EVAL_LR = 0.01
EVAL_PROFILED = (100, 103)          # steady steps under torch.profiler
SIM_TOL = (1e-5, 1e-6)              # rtol, atol: the CPU parity tests'


def _mean(xs) -> float:
    return float(sum(xs) / len(xs))


def _sim_metrics_close(got, want, what: str) -> float:
    """Every metric of every step within ``SIM_TOL``; the largest
    relative difference."""
    rtol, atol = SIM_TOL
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.keys() == w.keys(), f"{what} step {i}: metrics differ")
        for k in w:
            d = abs(g[k] - w[k])
            check(d <= atol + rtol * abs(w[k]), f"{what} step {i} {k}: "
                  f"card {g[k]!r} CPU {w[k]!r}")
            worst = max(worst, d / max(abs(w[k]), 1e-30))
    return worst


def _trees_close(torch, got, want, what: str) -> float:
    from repro_torch.models.layers import tree_leaves
    rtol, atol = SIM_TOL
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g = g.cpu()
        check(torch.allclose(g, w, rtol=rtol, atol=atol),
              f"{what}: a leaf differs by {float((g - w).abs().max())}")
        worst = max(worst, float((g - w).abs().max()))
    return worst


def simulator_check(torch, ops) -> None:
    """The simulator on the card (cuBLAS, the fused update kernel and,
    through ``staged_from_model``, the fp32 flash kernels) against the
    same simulator on the CPU, 10 steps of each scheme at the CPU tests'
    sizes, within their tolerances."""
    phase("simulator on the card against the CPU: 10 steps of each "
          "scheme, make_mlp_staged and staged_from_model, fp32")
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.simulator import (Simulator, make_mlp_staged,
                                            staged_from_model)
    from repro_torch.models import Model
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((16, 8)).astype(np.float32)
    mlp_batches = []
    for _ in range(10):
        x = rng.standard_normal((32, 16)).astype(np.float32)
        mlp_batches.append({"x": x, "y": (x @ w_true).argmax(-1)})
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=4, n_kv_heads=2, compute_dtype="float32",
        mesh_plan=dataclasses.replace(get_config(ARCH).mesh_plan, pipe=2))
    lm_batches = []
    for _ in range(10):
        t = rng.integers(0, cfg.vocab_size, size=(2, 9))
        lm_batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    models = {dev: Model(cfg, device=dev) for dev in ("cpu", "cuda")}
    p_lm = models["cpu"].init(torch.Generator().manual_seed(0))

    def setups(dev):
        fns, params = make_mlp_staged(
            torch.Generator().manual_seed(0), in_dim=16, width=32, depth=4,
            n_classes=8, n_stages=4, device=dev)
        yield "make_mlp_staged", fns, params, 4, mlp_batches, (1, 2, 3)
        fns, repack = staged_from_model(models[dev])
        yield ("staged_from_model", fns, repack(_tree_to(p_lm, dev)), 2,
               lm_batches, (1,))

    for scheme in Simulator.SCHEMES:
        for (name, f_c, p_c, n, bs, rs), (_, f_g, p_g, _, _, _) in zip(
                setups("cpu"), setups("cuda")):
            runs = {}
            for dev, fns, params in (("cpu", f_c, p_c), ("cuda", f_g, p_g)):
                sim = Simulator(fns, params, n_stages=n, scheme=scheme,
                                lr=0.05, rmse_s=rs)
                ops.reset_launch_counts()
                runs[dev] = ([sim.step(b) for b in bs], sim.params,
                             ops.launch_counts())
            counts = runs["cuda"][2]
            layers = cfg.n_layers if name == "staged_from_model" else 0
            want = {"fused_update": (n + 1) * len(bs),
                    "flash_fwd": 2 * layers * len(bs),
                    "flash_bwd_dq": layers * len(bs),
                    "flash_bwd_dkv": layers * len(bs)}
            check({k: counts[k] for k in want} == want,
                  f"{scheme} {name}: launches {counts}, expected {want}")
            m_err = _sim_metrics_close(runs["cuda"][0], runs["cpu"][0],
                                       f"{scheme} {name}")
            p_err = _trees_close(torch, runs["cuda"][1], runs["cpu"][1],
                                 f"{scheme} {name}")
            print(f"  {scheme:<9} {name:<17} losses and RMSEs max rel |d| "
                  f"{m_err:.3e}, params max |d| {p_err:.3e} (rtol "
                  f"{SIM_TOL[0]:g} / atol {SIM_TOL[1]:g}); launches "
                  f"{want}")


def resume_check(torch) -> None:
    """Checkpoint and exact resume through the launcher on the card:
    6 ticks in one run against 3 ticks, a save, and a second run resumed
    to 6 (``--ckpt-dir``, ``--resume auto``); every leaf of the final
    checkpoint bit for bit, for spectrain and pipedream."""
    phase("checkpoint and exact resume on the card: train.main, smoke "
          "size, 4 layers, pipe 2, 6 ticks against 3 + resume + 3")
    import numpy as np
    from repro_torch.launch import train
    argv = ["--arch", ARCH, "--smoke", "--layers", "4", "--pipe", "2",
            "--batch", "4", "--seq", "16", "--save-every", "3",
            "--log-every", "100"]
    for mode in ("spectrain", "pipedream"):
        with tempfile.TemporaryDirectory() as d:
            one, two = f"{d}/one", f"{d}/two"
            check(train.main(argv + ["--mode", mode, "--steps", "6",
                                     "--ckpt-dir", one]) == 0, "run A")
            check(train.main(argv + ["--mode", mode, "--steps", "3",
                                     "--ckpt-dir", two]) == 0, "run B")
            ran = []
            check(train.main(argv + ["--mode", mode, "--steps", "6",
                                     "--ckpt-dir", two, "--resume", "auto"],
                             on_step=lambda s, st, m: ran.append(s)) == 0,
                  "run B resumed")
            check(ran == [3, 4, 5], f"the resumed run ran steps {ran}")
            last = "step_00000005/shard_0.npz"
            with np.load(f"{one}/{last}") as a, np.load(f"{two}/{last}") as b:
                check(set(a.files) == set(b.files), "leaf sets differ")
                same = [k for k in a.files if np.array_equal(a[k], b[k])]
                n_par = sum(k.startswith(("params/", "momentum/"))
                            for k in a.files)
                check(len(same) == len(a.files), f"{mode}: leaves differ "
                      f"after resume: {sorted(set(a.files) - set(same))}")
        print(f"  {mode}: all {len(a.files)} leaves of the step-5 "
              f"checkpoint bit-equal ({n_par} params and momentum leaves)")


def paper_eval(torch, ops, fu, *, lr=EVAL_LR, steps=EVAL_STEPS,
               rmse_steps=EVAL_RMSE_STEPS, profiled=EVAL_PROFILED) -> dict:
    """The four schemes on the full-width, full-depth snn-paper (32 FC
    layers of 2048, input 3072, 10 classes, 4 stages), batch 128 of the
    synthetic teacher task, ``steps`` steps each, every update through
    the fused update kernel (N + 1 launches a step); then spectrain
    again for its first ``rmse_steps`` steps with Fig. 8's RMSEs at
    s = 1, 2, 3 (the same trajectory).
    Each scheme's final weights are scored on a held-out teacher batch;
    every scheme must have learned past the label prior (a final loss
    below the prior's entropy, a held-out accuracy above the majority
    share, each by three standard errors).  The update kernel is held against
    its plain version at the simulator's two groups, then timed."""
    from repro_torch.bench import teacher_batches
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import Simulator, make_mlp_staged
    from repro_torch.kernels import ref
    from repro_torch.models.layers import tree_leaves
    import gc
    cfg = get_config(EVAL_ARCH)
    dims = dict(in_dim=cfg.vocab_size, width=cfg.d_model,
                depth=cfg.n_layers, n_classes=EVAL_CLASSES,
                n_stages=cfg.mesh_plan.pipe)
    N, B = dims["n_stages"], EVAL_BATCH
    phase(f"main path: the paper's evaluation, {EVAL_ARCH} full width and "
          f"depth ({dims}), batch {B}, lr {lr}, {steps} steps a scheme")
    fns, params = make_mlp_staged(torch.Generator("cuda").manual_seed(0),
                                  device="cuda", **dims)
    leaves = tree_leaves(params)
    P = sum(t.numel() for t in leaves)
    P_mat = sum(t.numel() for t in leaves if t.dim() == 2)
    check(len(leaves) == 68 and P == 140_597_258,
          f"snn-paper has {len(leaves)} leaves, {P} parameters")
    data = teacher_batches(in_dim=dims["in_dim"], n_classes=EVAL_CLASSES,
                           batch=B, seed=1, device="cuda")
    batches = [next(data) for _ in range(steps)]
    held = next(teacher_batches(in_dim=dims["in_dim"],
                                n_classes=EVAL_CLASSES, batch=EVAL_HELD,
                                seed=2, device="cuda"))
    # the label prior: its entropy is the loss of a model that learned
    # only the class shares; the majority share, its accuracy
    shares = torch.bincount(torch.cat([b["y"] for b in batches]),
                            minlength=EVAL_CLASSES).double()
    shares = shares[shares > 0] / shares.sum()
    prior_loss = float(-(shares * shares.log()).sum())
    majority = float(torch.bincount(held["y"]).max()) / EVAL_HELD
    acc_se = math.sqrt(majority * (1 - majority) / EVAL_HELD)

    def sub(tree):
        return sum(x.numel() for x in tree_leaves(tree))

    P_stage = [sub(t) for t in params["stages"]]
    P_in, P_out = sub(params["outer"]["in"]), sub(params["outer"]["out"])
    # fp32 operations one step needs: forward, weight gradients, input
    # gradients of every layer but the first
    flops = 2 * B * P_mat * 3 - 2 * B * dims["in_dim"] * dims["width"]
    out = {}
    # spectrain twice: the training step alone, then with Fig. 8's RMSEs
    # (three whole-tree predictions and six whole-tree reductions a step)
    runs = [(scheme, scheme, (), steps) for scheme in Simulator.SCHEMES]
    runs.append(("spectrain+rmse", "spectrain", (1, 2, 3), rmse_steps))
    for name, scheme, rmse_s, n_steps in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = Simulator(fns, params, n_stages=N, scheme=scheme, lr=lr,
                        rmse_s=rmse_s)
        ms, walls, per_step = [], [], []
        prof = None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for i, b in enumerate(batches[:n_steps]):
            if i == profiled[0]:
                prof = device_profile()
                prof.__enter__()
            before = fu.launches
            t = time.perf_counter()
            ms.append(sim.step(b))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            per_step.append(fu.launches - before)
            if i == profiled[1] - 1:
                prof.__exit__(None, None, None)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [m["loss"] for m in ms]
        check(all(math.isfinite(x) for x in losses),
              f"{name}: a loss is not finite")
        check(per_step == [N + 1] * n_steps,
              f"{name}: fused_update launches per step {set(per_step)}")
        check(counts == {k: (N + 1) * n_steps if k == "fused_update"
                         else 0 for k in counts},
              f"{name}: launches {counts}")
        n_prof = profiled[1] - profiled[0]
        steady = sorted(w for i, w in enumerate(walls)
                        if i >= 10 and not profiled[0] <= i < profiled[1])
        wall_ms = steady[len(steady) // 2] * 1e3
        kern = device_kernels(prof)
        check(bool(kern), f"{name}: the profiler saw no device activity")
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n_prof
        fu_ms = sum(e.self_device_time_total for e in kern
                    if "fused_update" in e.key) / 1e3 / n_prof
        # bytes the step must move (fp32): the update reads w, v, g and
        # writes w', v'; each prediction reads w, v and writes ŵ; each
        # RMSE at s predicts the whole tree and reads it, the stale and
        # the new tree twice over
        pred = 0
        if scheme == "spectrain":
            pred += sum(P_stage[k] for k in range(N) if sim.s_fwd[k] > 0)
            pred += sum(P_stage[k] for k in range(N) if sim.s_bwd[k] > 0)
            pred += P_in * ((sim.s_fwd[0] > 0) + (sim.s_bwd[0] > 0))
            pred += P_out * (sim.s_bwd[N - 1] > 0)
        nbytes = 4 * (5 * P + 3 * pred + 7 * P * len(rmse_s))
        bound_ms = max(nbytes / HBM_BPS, flops / PEAK_FLOPS["float32"]) * 1e3
        upd_kw = dict(lr=sim.lr, gamma=sim.gamma, s=0.0)
        rec = {"wall_ms": wall_ms, "busy_ms": busy_ms,
               "idle": 1 - busy_ms / wall_ms, "fused_update_ms": fu_ms,
               "peak_bytes": peak,
               "launches": counts["fused_update"], "per_step": N + 1,
               "bound_ms": bound_ms, "bytes": nbytes, "flops": flops,
               "first_loss": losses[0], "losses": losses}
        head = (f"  {name:<14} {wall_ms:8.3f} ms/step wall (median of "
                f"steady steps), {busy_ms:8.3f} ms busy "
                f"({100 * rec['idle']:.1f}% idle), fused_update "
                f"{fu_ms:.3f} ms; bound {bound_ms:.3f} ms "
                f"({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} GFLOP); ")
        tail = (f"; {N + 1} fused_update a step; peak "
                f"{peak / 2**30:.2f} GiB")
        if rmse_s:
            # the learning is the first run's: the same trajectory
            rec["rmse"] = {}
            for s_ in rmse_s:
                p_ = _mean([m[f"rmse_pred_s{s_}"] for m in ms[20:]])
                st_ = _mean([m[f"rmse_stale_s{s_}"] for m in ms[20:]])
                rec["rmse"][s_] = (p_, st_)
                check(p_ < st_, f"Fig. 8 at s={s_}: RMSE(pred) {p_} is not "
                      f"below RMSE(stale) {st_}")
            print(f"{head}{n_steps} steps, the first run's losses{tail}")
        else:
            check(_mean(losses[-20:]) < _mean(losses[:20]),
                  f"{name}: the last 20 losses average "
                  f"{_mean(losses[-20:])}, the first 20 "
                  f"{_mean(losses[:20])}")
            with torch.no_grad():
                p_ = sim.params
                h = fns.embed(p_["outer"]["in"], held)
                for sp in p_["stages"]:
                    h = fns.stage(sp, h)
                held_loss = float(fns.head_loss(p_["outer"]["out"], h,
                                                held))
                logits = (h @ p_["outer"]["out"]["w"]
                          + p_["outer"]["out"]["b"])
                acc = float((logits.argmax(-1) == held["y"])
                            .double().mean())
            last = losses[-40:]
            loss_se = math.sqrt(sum((x - _mean(last)) ** 2 for x in last)
                                / (len(last) - 1) / len(last))
            check(_mean(last) < prior_loss - 3 * loss_se,
                  f"{name}: final loss {_mean(last)} is not below the "
                  f"label prior's entropy {prior_loss} by 3 standard "
                  f"errors ({loss_se})")
            check(acc > majority + 3 * acc_se,
                  f"{name}: held-out accuracy {acc} is not above the "
                  f"majority share {majority} by 3 standard errors")
            rec.update(final_loss=_mean(last), final_loss_se=loss_se,
                       held_loss=held_loss, held_acc=acc)
            print(f"{head}loss {losses[0]:.4f} -> final {_mean(last):.4f} "
                  f"(± {loss_se:.4f}); held-out loss {held_loss:.4f}, "
                  f"accuracy {acc:.4f}{tail}")
        out[name] = rec
        for s_, (p_, st_) in rec.get("rmse", {}).items():
            print(f"    Fig. 8 s={s_}: RMSE(pred) {p_:.3e}  RMSE(stale) "
                  f"{st_:.3e}  stale/pred {st_ / p_:.3f}")
        kern.sort(key=lambda e: -e.self_device_time_total)
        for e in kern[:6]:
            print(f"    {e.self_device_time_total / 1e3 / n_prof:9.4f} ms a "
                  f"step {e.count // n_prof:5d}x  {e.key[:70]}")
        del sim
    f = {k: out[k]["final_loss"] for k in Simulator.SCHEMES}
    check(out["spectrain+rmse"]["losses"]
          == out["spectrain"]["losses"][:rmse_steps],
          "the RMSEs changed spectrain's trajectory")
    table1 = {"spectrain <= vanilla * 1.05":
              f["spectrain"] <= f["vanilla"] * 1.05,
              "spectrain <= pipedream * 1.05":
              f["spectrain"] <= f["pipedream"] * 1.05,
              "spectrain <= sync * 1.25 + 0.05":
              f["spectrain"] <= f["sync"] * 1.25 + 0.05}
    print(f"  Table 1 (final loss, mean of the last 40 steps): "
          f"{ {k: round(v, 4) for k, v in f.items()} }; the JAX test's "
          f"bounds (a finding here, not a check): {table1}")
    print(f"  label prior: loss {prior_loss:.4f} (entropy of the training "
          f"labels), held-out accuracy {majority:.4f} (majority share, "
          f"± {acc_se:.4f}); held-out accuracy "
          f"{ {k: round(out[k]['held_acc'], 4) for k in f} }")
    out["table1"] = table1
    out["prior"] = {"loss": prior_loss, "majority": majority}
    # the kernel at the simulator's two groups (one stage tree, the outer
    # tree), with its arguments (no ŵ, s 0): checked, then timed
    g = torch.Generator("cuda").manual_seed(3)
    mk = lambda w, scale: torch.randn(w.shape, generator=g,
                                      device="cuda") * scale
    out["fu_rows"] = []
    for label, tree in (
            (f"snn-paper stage ({dims['depth'] // N} layers of "
             f"{dims['width']})", params["stages"][0]),
            (f"snn-paper outer tree (in {dims['in_dim']}x{dims['width']}, "
             f"out {dims['width']}x{EVAL_CLASSES})", params["outer"])):
        ws = [t.clone() for t in tree_leaves(tree)]
        vs = [mk(w, 1e-2) for w in ws]
        gs = [mk(w, 1.0) for w in ws]
        n = sum(w.numel() for w in ws)
        err = fu_compare(torch, ops, ref, ws, vs, gs, None, label, upd_kw)
        ms_, _ = time_ms(torch, lambda: ops.fused_update(
            ws, vs, gs, **upd_kw), 10)
        plain_ms, _ = time_ms(torch, lambda: [
            ref.fused_update_ref(w, v, g_, **upd_kw)
            for w, v, g_ in zip(ws, vs, gs)], 3)
        # with no ŵ, torch.optim.SGD(fused=True, dampening=gamma)
        # computes the same update (but for its first step, which sets v
        # to g)
        opt_params = [torch.nn.Parameter(w) for w in ws]
        for p_, g_ in zip(opt_params, gs):
            p_.grad = g_
        opt = torch.optim.SGD(opt_params, lr=upd_kw["lr"],
                              momentum=upd_kw["gamma"],
                              dampening=upd_kw["gamma"], fused=True)
        lib_ms, _ = time_ms(torch, opt.step, 10)
        b_ms, b_by = bound_of(*fu.cost(n), "float32")
        row = {"shape": f"{label}: {len(ws)} tensors, {n} elements, fp32 "
                        f"w/v/g, no ŵ, lr {upd_kw['lr']:g}, gamma "
                        f"{upd_kw['gamma']:g}",
               "ms": ms_, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib_ms,
               "max_abs_err": err}
        out["fu_rows"].append(row)
        print(f"  fused_update at {row['shape']}: one launch against its "
              f"plain version max |d| {err:.3e} (tol "
              f"{FU_TOL['float32']:g}); {ms_:.4f} ms, bound {b_ms:.4f} ms "
              f"(bytes), plain {plain_ms:.4f} ms, torch.optim.SGD(fused) "
              f"{lib_ms:.4f} ms")
        del ws, vs, gs, opt_params, opt
    del params, batches
    return out


def bench_scripts(torch) -> None:
    """The evaluation scripts' own runs on the card at their default
    (the JAX scripts') sizes."""
    phase("python -m repro_torch.bench.rmse / .convergence on the card, "
          "their default sizes")
    from repro_torch.bench import convergence, rmse
    for mod in (rmse, convergence):
        t0 = time.perf_counter()
        lines = mod.main(device="cuda")
        for line in lines:
            print(f"  {line}")
        check(not any(re.search(r"nan|inf", line) for line in lines),
              f"{mod.__name__}: a non-finite number")
        print(f"  ({mod.__name__}: {time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# training the SSM families (phase 26): the scans' backward kernels, the
# smoke-size tick and round card against CPU, rwkv6-7b and zamba2-1.2b
# through launch.train.main

# of each output's largest magnitude: fp32 inputs, bf16 inputs
SCAN_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the full-width ticks: arch -> (layers, stages); rwkv6-7b at 8 of its 32
# layers (>= 16 B a parameter of fp32 state), zamba2-1.2b whole on its
# mesh plan's 2 stages (19 layers a stage: the shared block fires once in
# each; at 4 stages of 9-10 layers it would fire in none)
SSM_TRAIN = {"rwkv6-7b": (8, 4), "zamba2-1.2b": (38, 2)}
SSM_ROUNDS = 4                     # rwkv6-7b's 1f1b rounds
SSM_TRAIN_LR = 0.02
# the kernels of the training path, as the profiler names them: the
# chunked forward (s = 512), the chunked backward's gradient kernel, the
# bf16 attention
TRAIN_SYMBOL = dict(KERNEL_SYMBOL, rwkv6_scan="wkv_chunk_kernel",
                    mamba2_scan="ssd_chunk_kernel",
                    rwkv6_scan_bwd="wkv_bwd_chunk_kernel",
                    mamba2_scan_bwd="ssd_bwd_chunk_kernel")
# the three kernels of one chunked backward call (s >= 64): the walk over
# the chunks, every chunk's gradients, the sum over heads / batch rows
SCAN_BWD_PARTS = {
    "rwkv6_scan_bwd": ("wkv_bwd_states_kernel", "wkv_bwd_chunk_kernel",
                       "wkv_bwd_du_kernel"),
    "mamba2_scan_bwd": ("ssd_bwd_states_kernel", "ssd_bwd_chunk_kernel",
                        "ssd_bwd_group_kernel")}
SCAN_BWD_SYMBOLS = {k[:-len("_scan_bwd")]: " + ".join(v)
                    for k, v in SCAN_BWD_PARTS.items()}


class ScanBwdCase:
    """One backward call in the model layout: the forward's inputs with
    decays uniform in [0, 1], 5% of them exactly 0 and 5% exactly 1, a
    nonzero S0, and the cotangents dy (y's dtype: r's for rwkv6, fp32 for
    mamba2) and a nonzero dS_T.  mamba2's B and C are strided views of one
    projection, as the model has them."""

    def __init__(self, kind, name, b, s, h, d, dtype, n=None, g=1):
        self.kind, self.name, self.b, self.s, self.h = kind, name, b, s, h
        self.d, self.n, self.g, self.dtype = d, n or d, g, dtype

    def tensors(self, torch, seed=0):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        dt = getattr(torch, self.dtype)
        mk = lambda *sh, sc=1.0, d=torch.float32: (torch.randn(
            *sh, generator=gen, device="cuda") * sc).to(d)

        def decays(*sh):
            u = torch.rand(*sh, generator=gen, device="cuda")
            c = torch.rand(*sh, generator=gen, device="cuda")
            return u.masked_fill(c < 0.05, 0.0).masked_fill(c > 0.95, 1.0)
        b, s, h, d, n = self.b, self.s, self.h, self.d, self.n
        if self.kind == "rwkv6":
            return (mk(b, s, h, d, d=dt), mk(b, s, h, d, sc=0.3, d=dt),
                    mk(b, s, h, d, d=dt), decays(b, s, h, d),
                    mk(h, d, sc=0.3), mk(b, h, d, d, sc=0.3),
                    mk(b, s, h, d, d=dt), mk(b, h, d, d, sc=0.3))
        delta = torch.nn.functional.softplus(mk(b, s, h))
        bc = mk(b, s, 2 * self.g * n, sc=0.5, d=dt)
        B, C = (t.reshape(b, s, self.g, n) for t in bc.chunk(2, -1))
        return (mk(b, s, h, d, d=dt), delta, decays(b, s, h), B, C,
                mk(b, h, d, n, sc=0.3), mk(b, s, h, d),
                mk(b, h, d, n, sc=0.3))

    def kernel(self, mods, args):
        r6, m2 = mods
        return (r6.rwkv6_scan_bwd if self.kind == "rwkv6"
                else m2.mamba2_scan_bwd)(*args)

    def plain(self, torch, ref, args):
        """The plain backward (kernel layout) on the same inputs, back in
        the model layout and the kernel's output dtypes."""
        tr = lambda t: t.transpose(1, 2)
        if self.kind == "rwkv6":
            r, k, v, w, u, S0, dy, dS_T = args
            dr, dk, dv, dw, du, dS0 = ref.rwkv6_bwd_ref(
                tr(r), tr(k), tr(v), tr(w), u, S0, tr(dy), dS_T)
            return (tr(dr).to(r.dtype), tr(dk).to(r.dtype),
                    tr(dv).to(r.dtype), tr(dw), du, dS0)
        x, delta, decay, B, C, S0, dy, dS_T = args
        b, s, h, _ = x.shape
        rep, n = h // self.g, self.n
        per_head = lambda t: tr(t.repeat_interleave(rep, dim=2))
        dx, ddt, ddecay, dBh, dCh, dS0 = ref.mamba2_bwd_ref(
            tr(x), tr(delta), tr(decay), per_head(B), per_head(C), S0,
            tr(dy), dS_T)
        group = lambda t: tr(t.reshape(b, self.g, rep, s, n).sum(2))
        return (tr(dx).to(x.dtype), tr(ddt), tr(ddecay),
                group(dBh).to(B.dtype), group(dCh).to(B.dtype), dS0)

    def autograd(self, torch, ref, args):
        """torch.autograd of the plain forward (kernel layout), in the
        model layout: the gradient the formulas must equal."""
        tr = lambda t: t.transpose(1, 2)
        leaves = [a.detach().clone().requires_grad_() for a in args[:6]]
        dy, dS_T = args[6], args[7]
        with torch.enable_grad():
            if self.kind == "rwkv6":
                r, k, v, w, u, S0 = leaves
                y, sT = ref.rwkv6_ref(tr(r), tr(k), tr(v), tr(w), u, S0)
            else:
                x, delta, decay, B, C, S0 = leaves
                rep = self.h // self.g
                per_head = lambda t: tr(t.repeat_interleave(rep, dim=2))
                y, sT = ref.mamba2_ref(tr(x), tr(delta), tr(decay),
                                       per_head(B), per_head(C), S0)
            return torch.autograd.grad((tr(y), sT), leaves,
                                       (dy.to(y.dtype), dS_T))

    def variant(self) -> str:
        return "chunk" if self.s >= 64 else "step"

    def bound(self):
        """(least ms, what bounds it): the larger of the bytes, every input
        read once and every gradient written once, over HBM, and the
        operations over their peak.  s < 64 (the stepwise kernels): the
        fp32 operations over the fp32 peak outside the tensor cores, per
        step and state entry 14: the state recomputed (3), the cotangent's
        update (rwkv6: w G + r dy, 3; mamba2: + dy C and x decay, 3) and
        four products summed (rwkv6: dr, dk, dv, dw; mamba2: dC, G B, dB,
        ddecay).  s >= 64 (the chunked kernels): the chunked form's
        tensor-core products over the TF32 peak, each product counted
        once, as the forward's bound counts them (not once per 3xTF32
        pass: the passes are the kernels' cost, not the function's), the
        triangular ones at the triangle (chunked_ops).  The formulas are
        the kernel modules' ``bwd_cost()``."""
        from repro_torch.kernels import mamba2_scan as m2
        from repro_torch.kernels import rwkv6_scan as r6
        el = 2 if self.dtype == "bfloat16" else 4
        b, s, h, d, n, g = self.b, self.s, self.h, self.d, self.n, self.g
        cost = (r6.bwd_cost(b, s, h, d, el=el) if self.kind == "rwkv6"
                else m2.bwd_cost(b, s, h, d, n, g, el=el))
        return bound_of(*cost, r6.flops_type(s))

    def chunked_ops(self, passes: bool = False) -> float:
        """Tensor-core FLOPs of the chunked backward (2 a multiply-add;
        with ``passes``, times each product's mma passes, 1 to 3 as
        3xTF32 splits its fp32-derived operands, bf16 operands being
        exact): the kernel modules' ``bwd_chunk_flops``."""
        from repro_torch.kernels import mamba2_scan as m2
        from repro_torch.kernels import rwkv6_scan as r6
        bf16 = self.dtype == "bfloat16"
        if self.kind == "mamba2":
            return m2.bwd_chunk_flops(self.b, self.s, self.h, self.d,
                                      self.n, bf16=bf16, passes=passes)
        return r6.bwd_chunk_flops(self.b, self.s, self.h, self.d,
                                  bf16=bf16, passes=passes)


def scan_bwd_cases(kind: str) -> list:
    """At full width (rwkv6-7b's 64 heads of 64; zamba2-1.2b's 64 heads,
    p 64, n 64, g 1), in fp32 and bf16: the training tick's shape [8, 512]
    and the rounds' [1, 512], s = 64, 100 (a partial last chunk) and 2048
    on the chunked kernels, s = 1, 12, 63 on the stepwise ones; the other
    head sizes and mamba2 with g > 1, on both."""
    cases = []
    for dt in ("float32", "bfloat16"):
        cases += [ScanBwdCase(kind, f"train b8 s=512 {dt}", 8, 512, 64, 64,
                              dt),
                  ScanBwdCase(kind, f"b1 s=512 {dt}", 1, 512, 64, 64, dt),
                  ScanBwdCase(kind, f"b1 s=2048 {dt}", 1, 2048, 64, 64, dt)]
        for s in (1, 12, 63, 64, 100):
            cases.append(ScanBwdCase(kind, f"b2 s={s} {dt}", 2, s, 64, 64,
                                     dt))
        name, b, s, h, d = TP_SCAN      # a tensor rank's (phase 30)
        cases.append(ScanBwdCase(kind, f"{name} {dt}", b, s, h, d, dt))
    if kind == "rwkv6":
        cases += [ScanBwdCase(kind, "hd32 b2 h4 s=20 float32", 2, 20, 4, 32,
                              "float32"),
                  ScanBwdCase(kind, "hd16 b1 h2 s=9 bfloat16", 1, 9, 2, 16,
                              "bfloat16"),
                  ScanBwdCase(kind, "hd32 b1 h4 s=130 float32", 1, 130, 4,
                              32, "float32"),
                  ScanBwdCase(kind, "hd16 b2 h2 s=70 bfloat16", 2, 70, 2, 16,
                              "bfloat16")]
    else:
        cases += [ScanBwdCase(kind, "g=4 b2 h16 p32 n16 s=37 float32", 2,
                              37, 16, 32, "float32", n=16, g=4),
                  ScanBwdCase(kind, "g=2 b1 h8 p16 n64 s=20 bfloat16", 1,
                              20, 8, 16, "bfloat16", n=64, g=2),
                  ScanBwdCase(kind, "g=4 b2 h16 p32 n16 s=100 float32", 2,
                              100, 16, 32, "float32", n=16, g=4),
                  ScanBwdCase(kind, "g=2 b1 h8 p16 n64 s=130 bfloat16", 1,
                              130, 8, 16, "bfloat16", n=64, g=2)]
    return cases


def _rel_max(torch, got, want) -> float:
    """max |got - want| over max |want| (fp32)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def scan_bwd_checks(torch, ops, ref, r6, m2) -> dict:
    """Both scans' backward kernels against their plain versions (the
    formulas) and against autograd of the plain forward, elementwise
    within SCAN_BWD_TOL of each output's largest magnitude; every call
    run twice on the same inputs, bit-equal, on its variant (the chunked
    kernels at s >= 64, counted under ``{kind}_scan_bwd_chunk``); every
    call again through ``ops`` under autograd, whose gradients are the
    kernel's bit for bit.  Returns {(kind, case): worst relative
    error}."""
    errs = {}
    for kind in ("rwkv6", "mamba2"):
        phase(f"phase 26: {kind}_scan backward against its plain version "
              f"and autograd on the card")
        names = (("dr", "dk", "dv", "dw", "du", "dS0") if kind == "rwkv6"
                 else ("dx", "ddt", "ddecay", "dB", "dC", "dS0"))
        for i, case in enumerate(scan_bwd_cases(kind)):
            args = case.tensors(torch, seed=900 + i)
            c0 = ops.launch_counts()[f"{kind}_scan_bwd"]
            v0 = ops.variant_counts()[f"{kind}_scan_bwd_chunk"]
            got = case.kernel((r6, m2), args)
            again = case.kernel((r6, m2), args)
            torch.cuda.synchronize()
            check(ops.launch_counts()[f"{kind}_scan_bwd"] == c0 + 2,
                  f"{kind} {case.name}: not one launch a call")
            chunked = ops.variant_counts()[f"{kind}_scan_bwd_chunk"] - v0
            check(chunked == (2 if case.variant() == "chunk" else 0),
                  f"{kind} {case.name}: {chunked} of 2 calls on the chunked "
                  f"backward (s = {case.s})")
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            check(same, f"{kind} {case.name}: two runs on the same inputs "
                  f"differ")
            del again
            tol = SCAN_BWD_TOL[case.dtype]
            e, a = {}, {}
            for what, want in (("plain", case.plain(torch, ref, args)),
                               ("autograd", case.autograd(torch, ref,
                                                          args))):
                for nm, g, w in zip(names, got, want):
                    check(g.shape == w.shape and g.dtype == w.dtype,
                          f"{kind} {case.name}: {nm} {tuple(g.shape)} "
                          f"{g.dtype} against {what} {tuple(w.shape)} "
                          f"{w.dtype}")
                    check(bool(torch.isfinite(g.float()).all()),
                          f"{kind} {case.name}: {nm} not finite")
                    err = _rel_max(torch, g, w)
                    check(err <= tol, f"{kind} {case.name}: {nm} {err:.3e} "
                          f"of its max from the {what} backward (tol {tol})")
                    e[(what, nm)] = err
                    a[(what, nm)] = float((g.float() - w.float()).abs()
                                          .max())
                del want
            errs[(kind, case.name)] = {"rel": max(e.values()),
                                       "abs": max(a.values())}
            by = {w: max(v for (x, _), v in e.items() if x == w)
                  for w in ("plain", "autograd")}
            worst = max(e, key=e.get)
            zeros = int((args[3 if kind == "rwkv6" else 2] == 0).sum())
            # the same call under autograd through ops: the forward on the
            # scan kernel, the gradient the backward kernel's
            leaves = [a.detach().clone().requires_grad_() for a in args[:6]]
            scan = ops.rwkv6_scan if kind == "rwkv6" else ops.mamba2_scan
            y, sT = scan(*leaves)
            grads = torch.autograd.grad((y, sT), leaves, (args[6], args[7]))
            check(all(torch.equal(a, b) for a, b in zip(grads, got)),
                  f"{kind} {case.name}: the gradient through ops differs "
                  f"from the kernel's")
            del y, sT, grads, leaves
            print(f"  {case.name:<32} {case.variant():<5} plain "
                  f"{by['plain']:.2e}  autograd {by['autograd']:.2e} of max "
                  f"(worst {worst[1]} vs {worst[0]}); two runs and ops "
                  f"under autograd bit-equal; {zeros} exact-zero decays")
            del got, args
            gc.collect()
            torch.cuda.empty_cache()
    return errs


def scan_bwd_timings(torch, r6, m2, ref, errs) -> dict:
    """Each backward at the training tick's call (bf16, b 8, s 512, 64
    heads, 64 wide) and the 1f1b rounds' (b 1), both on the chunked
    kernels: device ms, the plain backward's ms, the bound.  No PyTorch
    call computes either."""
    phase("phase 26: timings of the scans' backward kernels (CUDA events, "
          "after warm-up)")
    rows = {}
    for kind in ("rwkv6", "mamba2"):
        width = "hd 64" if kind == "rwkv6" else "p 64, n 64, g 1"
        for b, s, h in ((8, 512, 64), (1, 512, 64), TP_SCAN[1:4]):
            name = ("train b8 s=512 bfloat16" if b == 8
                    else "b1 s=512 bfloat16" if b == 1
                    else f"{TP_SCAN[0]} bfloat16")
            case = ScanBwdCase(kind, name, b, s, h, 64, "bfloat16")
            args = case.tensors(torch, seed=7)
            ms, wall = time_ms(torch, lambda: case.kernel((r6, m2), args),
                               20)
            plain_ms, _ = time_ms(torch,
                                  lambda: case.plain(torch, ref, args), 2)
            bound_ms, bound_by = case.bound()
            row = {"shape": f"[{b}, {s}, {h}, 64] bf16, {width}",
                   "kernel": SCAN_BWD_SYMBOLS[kind], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None,
                   "tensor_core_gflop": case.chunked_ops() / 1e9,
                   "tensor_core_pass_gflop":
                       case.chunked_ops(passes=True) / 1e9,
                   "max_abs_err": errs[(kind, name)]["abs"],
                   "max_rel_err": errs[(kind, name)]["rel"],
                   "wall_ms_per_call": wall}
            if b == 8:
                rows[kind] = row
            else:
                rows[kind]["b1" if b == 1 else "tensor_rank"] = row
            print(f"  {kind}_scan_bwd {row['shape']} {row['kernel']}: "
                  f"{ms:.4f} ms (wall {wall:.4f} ms per call)  bound "
                  f"{bound_ms:.5f} ms ({bound_by}; tensor-core "
                  f"{row['tensor_core_gflop']:.2f} GFLOP at TF32 peak "
                  f"{case.chunked_ops() / PEAK_FLOPS['tf32'] * 1e3:.5f} ms, "
                  f"{row['tensor_core_pass_gflop']:.2f} GFLOP counting each "
                  f"3xTF32 pass)  "
                  f"plain {plain_ms:.4f} ms  library: none")
            del args
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def _copy_state(dst, src):
    """Write the state ``src`` (any device) over ``dst`` in place: every
    tensor copied, every number set."""
    import torch
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_state(dst[k], v)
        elif isinstance(v, tuple):
            for d, x in zip(dst[k], v):
                _copy_state(d, x)
        elif isinstance(v, torch.Tensor):
            dst[k].copy_(v)
        else:
            dst[k] = v


def _clone_state(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_state(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


# the relative size of the weight perturbation whose effect on the CPU's
# own tick measures how far two correct runs of the smoke rwkv6 may part
NOISE_REL = 1e-7
NOISE_FACTOR = 4.0


def _perturb(torch, trees, seed: int) -> None:
    """Multiply every leaf of ``trees`` by (1 + NOISE_REL N(0, 1)) in
    place, the draws from ``seed``."""
    from repro_torch.models.layers import tree_leaves
    gen = torch.Generator().manual_seed(seed)
    for tree in trees:
        for leaf in tree_leaves(tree):
            leaf.mul_(1 + NOISE_REL * torch.randn(leaf.shape,
                                                  generator=gen))


def ssm_train_check(torch) -> dict:
    """The SSM families' training on the card (kernels) against the CPU
    (plain versions), smoke size, fp32, lr 0.02: 2(S-1)+3 spectrain ticks
    and one 1f1b round (S microbatches), on rwkv6 at 4 stages of one
    layer and zamba2 at 2 stages of 2 (its shared block, every 2 layers,
    fires in each stage); losses within rtol 1e-4, every params,
    momentum and prediction leaf within rtol 1e-4 / atol 1e-5.  zamba2's
    ticks run on, each side on its own state.

    rwkv6's ticks each start from the CPU's state (the card's is
    overwritten before each), and a leaf that misses that tolerance
    passes if its distance from the CPU's is within NOISE_FACTOR of the
    distance the CPU's own tick moves when the weights it starts from are
    perturbed by NOISE_REL relative (the round likewise).  The smoke
    rwkv6 is that ill-conditioned at ticks 5-7, when stages 1 and 0 take
    their first gradients: a 1e-7 perturbation moves the momentum of
    ``embed/tok`` by 1.9e-4 in one tick on the CPU alone (the
    group norm of the first token's rank-one WKV output, whose scale
    can nearly cancel), so no run, however exact, holds 1e-5 there."""
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.planner import plan as make_plan
    out = {}
    for arch in SSM_ARCHS:
        full = get_config(arch)
        cfg = smoke_config(full).replace(n_layers=4,
                                         compute_dtype="float32",
                                         mesh_plan=full.mesh_plan)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        S = cpu.n_stages
        n = 2 * (S - 1) + 3
        resync = cfg.ssm.kind == "rwkv6"
        phase(f"phase 26: {arch} training on the card against the CPU, "
              f"smoke size, fp32: {n} spectrain ticks"
              + (" (each from the CPU's state)" if resync else "")
              + f" and a 1f1b round on {S} stages")
        if cpu.hybrid:
            k = cfg.ssm.shared_attn_every
            check(all(m // k >= 1 for m in cpu.stage_sizes),
                  f"{arch}: a stage fires no shared block")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        batches = []
        for _ in range(n):
            t = rng.integers(0, cfg.vocab_size, size=(4, 17))
            batches.append({"tokens": t[:, :-1].astype(np.int32),
                            "targets": t[:, 1:].astype(np.int32)})
        states = {dev: ps.make_state(model, _tree_to(p_cpu, dev),
                                     batches[0], mode="spectrain")
                  for dev, model in (("cpu", cpu), ("cuda", gpu))}
        steps = {dev: ps.make_train_step(model, mode="spectrain",
                                         lr=SSM_TRAIN_LR)
                 for dev, model in (("cpu", cpu), ("cuda", gpu))}
        rec = {"loss": 0.0, "abs": 0.0, "noise": 0, "ratio": 0.0}

        def compare(st_g, st_c, what, st_n=None):
            for key in ("params", "momentum", "pred"):
                if key not in st_c:
                    continue
                noise = ([None] * len(tree_leaves(st_c[key])) if st_n is None
                         else tree_leaves(st_n[key]))
                for g, c, z in zip(tree_leaves(st_g[key]),
                                   tree_leaves(st_c[key]), noise):
                    g = g.cpu()
                    d = float((g - c).abs().max())
                    rec["abs"] = max(rec["abs"], d)
                    if torch.allclose(g, c, rtol=1e-4, atol=1e-5):
                        continue
                    floor = (0.0 if z is None else
                             float((z - c).abs().max()))
                    check(d <= NOISE_FACTOR * floor,
                          f"{arch} {what}: a {key} leaf differs by {d:.3e}"
                          f" (the CPU's own tick moves {floor:.3e} under a "
                          f"{NOISE_REL:g} perturbation)")
                    rec["noise"] += 1
                    rec["ratio"] = max(rec["ratio"], d / floor)
        for t, b in enumerate(batches):
            noisy = None
            if resync:
                if t:
                    _copy_state(states["cuda"], states["cpu"])
                noisy = _clone_state(states["cpu"])
                _perturb(torch, [noisy["params"]] + (
                    [noisy["pred"]] if "pred" in noisy else []), seed=t)
                steps["cpu"](noisy, b)
            l_c = float(steps["cpu"](states["cpu"], b)[1]["loss"])
            l_g = float(steps["cuda"](states["cuda"], b)[1]["loss"])
            rec["loss"] = max(rec["loss"],
                              abs(l_g - l_c) / max(abs(l_c), 1e-12))
            if resync:
                compare(states["cuda"], states["cpu"], f"tick {t}", noisy)
        if not resync:
            compare(states["cuda"], states["cpu"], f"{n} ticks")
        pl = make_plan(cfg, n_stages=S, schedule="1f1b",
                       n_microbatches=S, partitioner="uniform")
        rounds = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu), ("noise", cpu)):
            if dev == "noise" and not resync:
                continue
            params = _tree_to(p_cpu, "cuda" if dev == "cuda" else "cpu")
            if dev == "noise":
                _perturb(torch, [params], seed=n)
            ir = ps.make_ir_state(model, params, plan=pl)
            ir, met = ps.make_ir_train_step(model, plan=pl,
                                            lr=SSM_TRAIN_LR)(ir, batches[0])
            rounds[dev] = (ir, float(met["loss"]))
        rec["loss"] = max(rec["loss"], abs(rounds["cuda"][1] - rounds[
            "cpu"][1]) / abs(rounds["cpu"][1]))
        compare(rounds["cuda"][0], rounds["cpu"][0], "1f1b round",
                rounds.get("noise", (None,))[0])
        check(rec["loss"] <= 1e-4,
              f"{arch}: losses differ by rel {rec['loss']:.3e}")
        print(f"  losses (ticks and the round) max rel |d| "
              f"{rec['loss']:.3e} (tol 1e-4); params, momentum and "
              f"prediction max |d| {rec['abs']:.3e}; leaves past rtol 1e-4 "
              f"/ atol 1e-5: {rec['noise']}"
              + (f", each within {rec['ratio']:.2f}x the CPU's own move "
                 f"under a {NOISE_REL:g} weight perturbation (allowed "
                 f"{NOISE_FACTOR:g}x)" if rec["noise"] else ""))
        out[arch] = dict(rec, resync=resync)
    return out


def ssm_train_launches(arch: str, L: int, S: int, M: int = 0) -> tuple:
    """(launches, tensor-core and chunked variant launches) of one tick
    (``M`` = 0) or one round of ``M`` microbatches of full-width ``arch``
    at ``L`` layers in ``S`` stages: each layer's scan runs in the
    forward and again in the backward's recompute (the chunked kernels
    at s = 512) and its backward once (the chunked backward); a hybrid
    stage's shared block
    (after every full segment) makes two flash forwards and one of each
    backward kernel; S + 1 fused updates a tick, C + 1 a round."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import uniform_stage_sizes
    cfg = get_config(arch)
    kind = "rwkv6" if cfg.ssm.kind == "rwkv6" else "mamba2"
    m = max(M, 1)
    want = {f"{kind}_scan": 2 * L * m, f"{kind}_scan_bwd": L * m,
            "fused_update": S + 1}
    var = {f"{kind}_scan_chunk": 2 * L * m, f"{kind}_scan_bwd_chunk": L * m}
    if cfg.ssm.shared_attn_every:
        F = sum(n // cfg.ssm.shared_attn_every
                for n in uniform_stage_sizes(L, S)) * m
        want.update(flash_fwd=2 * F, flash_bwd_dq=F, flash_bwd_dkv=F)
        var.update(flash_fwd_mma=2 * F, flash_bwd_dq_mma=F,
                   flash_bwd_dkv_mma=F)
    return want, var


def ssm_train_path(torch, ops, arch: str, schedule: str = "stream") -> dict:
    """``repro_torch.launch.train.main`` on full-width ``arch``
    (SSM_TRAIN's depth and stages), bf16, batch 8 x 512 uniform tokens,
    spectrain: TRAIN_STEPS ticks of the stream schedule or SSM_ROUNDS
    rounds of a round schedule.  Finite losses (ticks: valid from tick
    S-1, stage 0 unchanged until tick 2(S-1)), exact launches every tick
    or round (``ssm_train_launches``), one profiled tick or round showing
    the same kernels, the wall, busy, tokens/s and peak."""
    from repro_torch.launch import train
    from repro_torch.models.layers import tree_leaves
    L, S = SSM_TRAIN[arch]
    rounds = schedule != "stream"
    steps = SSM_ROUNDS if rounds else TRAIN_STEPS
    M = IR_ROUND if rounds else 0
    what = (f"{SSM_ROUNDS} {schedule} rounds of {M} microbatches"
            if rounds else f"{steps} ticks")
    phase(f"phase 26: repro_torch.launch.train.main, {arch} full width, "
          f"{L} layers in {S} stages, bf16, spectrain, {what}")
    argv = ["--arch", arch, "--layers", str(L), "--pipe", str(S),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--dtype", "bfloat16", "--mode", "spectrain", "--schedule",
            schedule, "--data-kind", "uniform", "--lr", str(SSM_TRAIN_LR),
            "--steps", str(steps), "--log-every", "1"]
    want, want_var = ssm_train_launches(arch, L, S, M)
    sp = StepProfile(f"{arch} {schedule}", want, steps - 3, steps - 1,
                     symbols=TRAIN_SYMBOL)
    rec = {"counts": [], "variants": [], "valid": [], "loss": [], "t": [],
           "t_end": [], "stage0": []}
    snap = {}

    def on_step(s, state, metrics):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["counts"].append(dict(ops.launch_counts()))
        rec["variants"].append(dict(ops.variant_counts()))
        rec["valid"].append(metrics["loss_valid"])
        rec["loss"].append(float(metrics["loss"]))
        stage0 = tree_leaves(state["params"]["stages"][0])
        if s == 0:
            snap["stage0"] = [t.clone() for t in stage0]
        rec["stage0"].append(all(torch.equal(a, b) for a, b in
                                 zip(stage0, snap["stage0"])))
        sp.hook(s)
        rec["t_end"].append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv, on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    total = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    snap.clear()
    text = buf.getvalue()
    print("  " + "\n  ".join(x for x in text.strip().splitlines()
                             if x.startswith("#")))
    check(rc == 0, f"train.main returned {rc}")
    check(len(rec["loss"]) == steps, "not every step ran")
    m = re.search(r"params=([\d,]+)", text)
    n_params = int(m.group(1).replace(",", "")) if m else 0
    prev = {k: 0 for k in want}
    prev_v = {k: 0 for k in want_var}
    for s, (counts, var) in enumerate(zip(rec["counts"], rec["variants"])):
        got = {k: counts[k] - prev[k] for k in want}
        check(got == want, f"step {s} launched {got}, expected {want}")
        got_v = {k: var[k] - prev_v[k] for k in want_var}
        check(got_v == want_var, f"step {s} launched variants {got_v}, "
              f"expected {want_var}")
        prev, prev_v = counts, var
    check(total == {k: want.get(k, 0) * steps for k in total},
          f"the run launched {total}")
    check(all(math.isfinite(x) for x in rec["loss"]),
          f"non-finite loss {rec['loss']}")
    if rounds:
        check(rec["valid"] == [1.0] * steps, f"loss_valid {rec['valid']}")
    else:
        check(rec["valid"] == [float(s >= S - 1) for s in range(steps)],
              f"loss_valid per tick {rec['valid']}")
        check(rec["stage0"] == [s < 2 * (S - 1) for s in range(steps)],
              f"stage 0 unchanged per tick {rec['stage0']} (expected "
              f"until tick {2 * (S - 1)})")
    steady = sorted(rec["t"][i] - rec["t_end"][i - 1]
                    for i in range(1, steps) if i not in sp.steps)
    wall_ms = steady[len(steady) // 2] * 1e3
    tok_per_s = TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3)
    kern = sp.result()
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    by, parts = {}, {}
    for name in want:
        hits = [e for e in kern if TRAIN_SYMBOL[name] in e.key]
        n_hit = sum(e.count for e in hits)
        check(n_hit == want[name], f"the profiled step shows {n_hit} "
              f"{name} kernels, expected {want[name]}")
        by[name] = sum(e.self_device_time_total for e in hits) / 1e3
        if name in SCAN_BWD_PARTS:      # the walk and the sum too
            for part in SCAN_BWD_PARTS[name]:
                ph = [e for e in kern if part in e.key]
                check(sum(e.count for e in ph) == want[name],
                      f"the profiled step shows {sum(e.count for e in ph)} "
                      f"{part} kernels, expected {want[name]}")
                parts[part] = sum(e.self_device_time_total
                                  for e in ph) / 1e3
            by[name] = sum(parts[x] for x in SCAN_BWD_PARTS[name])
    unit = "round" if rounds else "tick"
    print(f"  {n_params:,} parameters; losses "
          f"{[round(x, 4) for x in rec['loss']]}")
    print(f"  per {unit}: {want} launches, variants {want_var} (exact on "
          f"every {unit})")
    print(f"  {unit} wall (median of steps 1..{steps - 1} but the "
          f"profiled {sp.steps}): {wall_ms:.3f} ms ({tok_per_s:.1f} "
          f"tokens/s); profiled step {sp.at}: device busy {busy_ms:.3f} ms "
          f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%), "
          f"{sum(e.count for e in kern)} kernels; peak "
          f"{peak / 2**30:.2f} GiB; run {run_s:.1f} s")
    print(f"  device ms by kind: {kernel_kinds(kern)}")
    for name, ms in by.items():
        print(f"  {name}: {want[name]} calls, {ms:.4f} ms "
              f"({100 * ms / busy_ms:.1f}% of device busy)"
              + (" = " + " + ".join(f"{x} {parts[x]:.4f}"
                                    for x in SCAN_BWD_PARTS[name])
                 if name in SCAN_BWD_PARTS else ""))
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms "
              f"{e.count:5d}x  {e.key[:72]}")
    return {"arch": arch, "schedule": schedule, "layers": L, "stages": S,
            "n_params": n_params, "launches": total, "per_step": want,
            "variants_per_step": want_var, "wall_ms": wall_ms,
            "tok_per_s": tok_per_s, "busy_ms": busy_ms, "kernel_ms": by,
            "bwd_parts_ms": parts, "peak_bytes": peak, "losses": rec["loss"],
            "run_s": run_s}


# ---------------------------------------------------------------------------
# the cost-accounting phase (phase 27): the dry-run's count of a training
# tick on the meta device against the same tick counted on the card

# the smoke run's three training configurations: (layers, stages), bf16,
# TRAIN_BATCH x TRAIN_SEQ, spectrain, one tick a step
COST_TICKS = {ARCH: (TRAIN_LAYERS, TRAIN_STAGES), "rwkv6-7b": (8, 4),
              "zamba2-1.2b": (38, 2)}
COST_WARMUP = 1             # ticks before the counted one
COST_TIMED = 3              # uncounted ticks timed for the wall and MFU
COST_MEM_TOL = 0.15         # counted peak against max_memory_allocated
# the totals of the card's count may differ from the meta count's only by
# the ops named in the phase's output, by at most this share
COST_TOTAL_TOL = 1e-3
ADAM_TOL = 1e-6
# the CPU reference of the card's Adam step: this many leading elements
# of each leaf (the update is elementwise; the whole tree on the CPU took
# 45.5 s of the phase)
ADAM_CPU_ELEMENTS = 1 << 20


def _cost_tick(torch, ops, arch: str, L: int, S: int) -> dict:
    """One configuration: the dry-run's ``build_cell`` on meta, then the
    same tick built by ``dryrun.make_train_step`` on the card from the
    launcher's random init, ``COST_WARMUP`` ticks, one tick under
    ``CostCounter`` (launches and peak memory read around it), and
    ``COST_TIMED`` uncounted ticks timed with CUDA events."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    from repro_torch.runtime.op_cost import CostCounter, op_differences
    shape = ShapeConfig("tick", TRAIN_SEQ, TRAIN_BATCH, "train")
    cell_kw = dict(pipe=S, layers=L, ticks=1, dtype="bfloat16")
    t0 = time.perf_counter()
    meta = dryrun.build_cell(arch, shape, by_op=True, **cell_kw)
    meta_s = time.perf_counter() - t0
    check(meta["status"] == "ok", f"{arch}: the meta count failed: {meta}")
    cfg = dryrun.cell_config(arch, **{k: v for k, v in cell_kw.items()})
    model = Model(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    toks = lambda: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                 generator=gen, device="cuda")
    batch = {"tokens": toks(), "targets": toks()}
    state, step, batch = dryrun.make_train_step(
        model, shape, ticks=1, params=params, batch=batch)
    del params
    for _ in range(COST_WARMUP):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with CostCounter() as counter:
        state, met = step(state, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    card = counter.result()
    mem = counter.memory(arguments=(state, batch), outputs=(state, met))
    loss = float(met["loss"])
    # the counted kernel calls against the launch counters and the meta
    calls = {k: v["calls"] for k, v in card["kernels"].items()}
    meta_calls = {k: v["calls"] for k, v in meta["kernels"].items()}
    check(calls == launched == meta_calls,
          f"{arch}: counted kernel calls {calls}, launches {launched}, "
          f"meta {meta_calls}")
    diffs = op_differences(card, {"by_op": meta["by_op"],
                                  "kernels": meta["kernels"]})
    totals = {}
    for key, mkey in (("flops", "flops"), ("bytes", "bytes_raw"),
                      ("transcendentals", "transcendentals")):
        a, b = card[key], meta["cost"][mkey]
        totals[key] = (a, b)
        check(abs(a - b) <= COST_TOTAL_TOL * max(abs(b), 1.0),
              f"{arch}: card {key} {a:.6e} against meta {b:.6e} beyond "
              f"{COST_TOTAL_TOL:g} (ops apart: {diffs[:8]})")
    counted_peak = mem["argument_bytes"] + mem["temp_bytes"]
    gap = (counted_peak - peak) / peak
    check(abs(gap) <= COST_MEM_TOL,
          f"{arch}: counted arguments + temporaries {counted_peak / 2**30:.3f}"
          f" GiB against max_memory_allocated {peak / 2**30:.3f} GiB "
          f"({100 * gap:+.1f}%) beyond {100 * COST_MEM_TOL:.0f}%")
    # the uncounted ticks' wall
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(COST_TIMED):
        state, met = step(state, batch)
    ev1.record()
    ev1.synchronize()
    wall_ms = ev0.elapsed_time(ev1) / COST_TIMED
    check(math.isfinite(loss) and math.isfinite(float(met["loss"])),
          f"{arch}: non-finite loss")
    mf = meta["model_flops"]
    rec = {"arch": arch, "layers": L, "stages": S,
           "n_params": cfg.param_count(), "model_flops": mf,
           "counted_flops": card["flops"], "meta_flops": meta["cost"]["flops"],
           "matmul_flops": card["matmul_flops"],
           "kernel_flops": sum(v["flops"] for v in card["kernels"].values()),
           "useful_flops_ratio": mf / card["flops"],
           "meta_useful_flops_ratio": meta["useful_flops_ratio"],
           "bytes": card["bytes"], "transcendentals": card["transcendentals"],
           "calls": calls, "wall_ms": wall_ms,
           "mfu": mf / (wall_ms / 1e3 * PEAK_FLOPS["bfloat16"]),
           "peak_bytes": peak, "counted_peak_bytes": counted_peak,
           "memory_allocated_before": before, "memory": mem,
           "mem_gap": gap, "ops_apart": diffs, "meta_s": meta_s,
           "counted_s": counted_s, "fits": meta["fits"], "totals": totals}
    del state, step, batch, model, met, counter
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _adam_card_check(torch) -> dict:
    """``optim.adam`` update (one step, weight decay) and predict on one
    full-width granite-8b stage tree (2 of 8 layers) on the card, against
    the same step on the CPU over the first ``ADAM_CPU_ELEMENTS`` of
    every leaf (the update is elementwise, so a leaf's leading elements
    take the step they would take in the whole tree)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import (init_params, stack_specs,
                                           tree_leaves, tree_map)
    from repro_torch.models.transformer import block_specs
    from repro_torch.optim import adam
    cfg = get_config(ARCH)
    specs = {"layers": stack_specs(block_specs(cfg),
                                   TRAIN_LAYERS // TRAIN_STAGES, "layer")}
    gen = torch.Generator(device="cuda").manual_seed(3)
    head = lambda _, t: t.reshape(-1)[:ADAM_CPU_ELEMENTS].cpu()
    p_card = init_params(specs, gen, "float32", "cuda")
    g = tree_map(lambda _, t: torch.randn(
        t.shape, generator=gen, device="cuda") * 1e-3, p_card)
    p_cpu, g_cpu = tree_map(head, p_card), tree_map(head, g)
    p_card, st_card = adam.update(p_card, adam.init(p_card), g,
                                  lr=1e-3, weight_decay=0.01)
    p_cpu, st_cpu = adam.update(p_cpu, adam.init(p_cpu), g_cpu, lr=1e-3,
                                weight_decay=0.01)
    del g
    pred_card = adam.predict(p_card, st_card, lr=1e-3, s=6)
    pred_cpu = adam.predict(p_cpu, st_cpu, lr=1e-3, s=6)
    worst, n = 0.0, sum(t.numel() for t in tree_leaves(p_card))
    for a_tree, b_tree in ((p_card, p_cpu), (st_card.m, st_cpu.m),
                           (st_card.v, st_cpu.v), (pred_card, pred_cpu)):
        for a, b in zip(tree_leaves(tree_map(head, a_tree)),
                        tree_leaves(b_tree)):
            check(torch.allclose(a, b, atol=ADAM_TOL, rtol=ADAM_TOL),
                  "adam: card against CPU beyond 1e-6")
            worst = max(worst, float((a - b).abs().max()))
    checked = sum(t.numel() for t in tree_leaves(p_cpu))
    del p_card, st_card, pred_card
    gc.collect()
    torch.cuda.empty_cache()
    return {"elements": n, "checked": checked, "max_abs": worst}


def _compression_card_check(torch) -> dict:
    """``topk_compress`` (3 steps of error feedback, frac 0.01) and the
    int8 rounding from given draws on one full-width granite-8b layer's
    q and output projections, card against CPU.  The int8 rounding bit
    for bit; top-k bit for bit in what it keeps (the sorted magnitudes
    sent), in sent + residual (the accumulated gradient) and in the
    stats, the kept positions differing only where a magnitude ties
    with the k-th largest (among ~10^8 fp32 normals such ties occur, and
    the two devices' ``topk`` break them apart); each step starts both
    sides from the CPU's residual."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import compression as comp
    cfg = get_config(ARCH)
    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes = {"wq": (d, d), "wo": (d, d)}
    res = comp.topk_init({k: torch.empty(v) for k, v in shapes.items()})
    n = ties = 0
    for _ in range(3):
        g = {k: torch.randn(v, generator=gen, device="cuda")
             for k, v in shapes.items()}
        sc, rc, stc = comp.topk_compress(
            g, tree_map(lambda _, t: t.cuda(), res), frac=0.01)
        g = tree_map(lambda _, t: t.cpu(), g)
        sp, rp, stp = comp.topk_compress(g, res, frac=0.01)
        check(stc == stp, f"topk stats {stc} != {stp}")
        for k in shapes:
            a_s, a_r = sc[k].cpu(), rc[k].cpu()
            acc = sp[k] + rp[k]
            check(torch.equal(a_s + a_r, acc), f"topk {k}: sent + "
                  f"residual differs between card and CPU")
            kept = lambda t: t[t != 0].abs().sort().values
            check(torch.equal(kept(a_s), kept(sp[k])),
                  f"topk {k}: the kept magnitudes differ")
            apart = a_s != sp[k]
            kth = kept(sp[k])[0]
            check(bool((acc[apart].abs() == kth).all()),
                  f"topk {k}: kept positions differ beyond ties with the "
                  f"k-th magnitude")
            ties += int(apart.sum())
        res = rp
        n = stc["total"]
    rounds = 0
    for k, v in shapes.items():
        g = torch.randn(v, generator=gen, device="cuda")
        u = torch.rand(v, generator=gen, device="cuda")
        check(torch.equal(comp.int8_round(g, u).cpu(),
                          comp.int8_round(g.cpu(), u.cpu())),
              f"int8_round {k}: card != CPU")
        rounds += g.numel()
    return {"topk_elements": n, "int8_elements": rounds,
            "tie_positions": ties}


def _restart_card_check(torch) -> dict:
    """A ``RestartManager`` run of the 4-layer smoke granite on 2 stages
    (fp32, 12 ticks, a checkpoint every 3) crashed at tick 7 and
    restored from tick 5, against the uninterrupted run: every leaf of
    params, momentum and prediction bit for bit."""
    from repro_torch.configs import MeshPlan, get_config, smoke_config
    from repro_torch.core import pipeline_stream
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.obs import MetricsRegistry
    from repro_torch.runtime.fault_tolerance import RestartManager
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=4, mesh_plan=MeshPlan(pipe=2, tensor=1,
                                       num_microbatches=1),
        param_dtype="float32", compute_dtype="float32")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=3))

    def run(d, fail_at, reg=None):
        m = Model(cfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        st = pipeline_stream.make_state(m, m.init(gen), data.batch_at(0))
        step = pipeline_stream.make_train_step(m, mode="spectrain",
                                               lr=0.02)
        st, _ = RestartManager(d, save_every=3, inject_failure_at=fail_at,
                               registry=reg).run(st, step, data, 0, 12)
        return [t.clone() for t in tree_leaves(
            {k: st[k] for k in ("params", "momentum", "pred")})]

    reg = MetricsRegistry()
    with tempfile.TemporaryDirectory() as d:
        want = run(f"{d}/a", None)
        got = run(f"{d}/b", 7, reg)
    same = sum(torch.equal(a, b) for a, b in zip(got, want))
    check(same == len(want), f"restart: {len(want) - same} of {len(want)} "
          f"leaves differ from the uninterrupted run")
    restored = [e["step"] for e in reg.find("restore")]
    check(restored == [5], f"restart restored {restored}, not [5]")
    return {"leaves": len(want), "restored_from": restored[0]}


def cost_accounting(torch, ops, info: dict) -> dict:
    """Phase 27 (see the module docstring): the three training ticks
    counted on meta and on the card; the library modules on the card."""
    phase("phase 27 (cost_accounting): the dry-run's meta count of a "
          "training tick against the same tick counted on the card; "
          "Adam, compression and restart on the card")
    t_phase = time.perf_counter()
    ticks = {}
    for arch, (L, S) in COST_TICKS.items():
        t0 = time.perf_counter()
        r = _cost_tick(torch, ops, arch, L, S)
        r["seconds"] = time.perf_counter() - t0
        ticks[arch] = r
        print(f"  {arch} ({L} layers, {S} stages, {r['n_params']:,} "
              f"parameters), one tick of {TRAIN_BATCH} x {TRAIN_SEQ}: "
              f"kernel calls counted = launched = meta {r['calls']}; "
              f"flops card {r['counted_flops']:.6e} / meta "
              f"{r['meta_flops']:.6e}, bytes "
              f"{r['totals']['bytes'][0]:.6e} / "
              f"{r['totals']['bytes'][1]:.6e}, transcendentals "
              f"{r['totals']['transcendentals'][0]:.6e} / "
              f"{r['totals']['transcendentals'][1]:.6e}; ops apart: "
              f"{r['ops_apart'] or 'none'}")
        print(f"    model_flops {r['model_flops']:.6e} (6 N T), counted "
              f"{r['counted_flops']:.6e} (matrix {r['matmul_flops']:.6e}, "
              f"kernels {r['kernel_flops']:.6e}), useful_flops_ratio "
              f"{r['useful_flops_ratio']:.4f}; uncounted tick "
              f"{r['wall_ms']:.3f} ms (CUDA events, {COST_TIMED} ticks), "
              f"MFU {100 * r['mfu']:.2f}% of 989 TFLOP/s bf16 on "
              f"{info['smi']}")
        print(f"    memory: counted arguments "
              f"{r['memory']['argument_bytes'] / 2**30:.3f} GiB + "
              f"temporaries {r['memory']['temp_bytes'] / 2**30:.3f} GiB = "
              f"{r['counted_peak_bytes'] / 2**30:.3f} GiB against "
              f"max_memory_allocated {r['peak_bytes'] / 2**30:.3f} GiB "
              f"(gap {100 * r['mem_gap']:+.2f}%; allocated before the "
              f"tick {r['memory_allocated_before'] / 2**30:.3f} GiB); "
              f"meta count {r['meta_s']:.2f} s, counted tick "
              f"{r['counted_s']:.2f} s, the configuration "
              f"{r['seconds']:.1f} s")
    t0 = time.perf_counter()
    adam = _adam_card_check(torch)
    print(f"  adam update + predict on a full-width {ARCH} stage tree "
          f"({adam['elements']:,} elements) on the card, against the CPU "
          f"on {adam['checked']:,} of them: max |d| {adam['max_abs']:.3e} "
          f"(tol {ADAM_TOL:g}); {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    comp = _compression_card_check(torch)
    print(f"  topk_compress x3 ({comp['topk_elements']:,} elements, frac "
          f"0.01): card equal to CPU in the kept magnitudes, sent + "
          f"residual and stats ({comp['tie_positions']} positions apart, "
          f"all ties with the k-th magnitude); int8_round "
          f"({comp['int8_elements']:,} elements): bit for bit; "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rst = _restart_card_check(torch)
    print(f"  RestartManager: crashed at tick 7, restored from tick "
          f"{rst['restored_from']}: all {rst['leaves']} leaves bit-equal "
          f"to the uninterrupted run; {time.perf_counter() - t0:.1f} s")
    took = time.perf_counter() - t_phase
    print(f"  phase 27 took {took:.1f} s")
    return {"ticks": ticks, "adam": adam, "compression": comp,
            "restart": rst, "seconds": took}


def _torch_or_none():
    """torch with a card and the repository's ``src/`` on the path, or
    None (the reason printed)."""
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return None
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {src}/repro_torch not found; run from the root "
              f"of the repository", file=sys.stderr)
        return None
    sys.path.insert(0, str(src))
    return torch


def run_mpmd_only() -> int:
    """``python3 chip_smoke.py --mpmd-only``: the card, the build, phase
    15's three SPMD runs that the stage-local runs are held to, and
    phase 16 on the cards present (with one card each, as on a machine
    of four, the ranks take NCCL).  Prints the MPMD lines; no JSON."""
    torch = _torch_or_none()
    if torch is None:
        return 2
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6
    t_start = _T0[0] = time.perf_counter()
    try:
        info = card_info(torch)
        build_kernels(build, r6, m2, fa, fu)
        ir_runs = ir_schedules(torch, ops, ref, [
            r for r in IR_RUNS if r[0] in MPMD_LABELS])
        gc.collect()
        torch.cuda.empty_cache()
        mpmd_runs, _ = mpmd_train(torch, ops, ir_runs)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    for label, r in mpmd_runs.items():
        print(f"MPMD round {label} ({r['transport']}): {r['wall_ms']:.3f} "
              f"ms wall on rank 0 (SPMD {r['spmd_wall_ms']:.3f}); leaves "
              f"bit-equal {r['digests']['bit_equal']}/"
              f"{r['digests']['copies']}, losses "
              f"{'bit-equal' if r['loss_equal'] else 'within rtol'}")
    print(f"chip_smoke --mpmd-only: passed in "
          f"{time.perf_counter() - t_start:.1f}s on {info['smi']}")
    return 0


def print_dp(dp: dict) -> None:
    """The data-parallel phase's summary lines."""
    for n, r in dp["runs"].items():
        if "wall_ms" not in r:
            print(f"Data-P --data {n}: reckoned, not run "
                  f"({r['reckoned_bytes'] / 2**30:.1f} GiB of replicas)")
            continue
        print(f"Data-P --data {n} ({r['transport']}): {r['wall_ms']:.3f} ms "
              f"a step, {r['tok_per_s']:.1f} tokens/s (one process "
              f"{dp['one']['wall_ms']:.3f} ms"
              + (f", MPMD 1f1b round {dp['mpmd_wall_ms']:.3f} ms"
                 if "mpmd_wall_ms" in dp else "")
              + f"); per-replica busy "
              f"{[round(b, 3) for b in r['busy_ms']]} ms, all-reduce host "
              f"{[round(t, 1) for t in r['reduce_ms']]} ms, peak "
              f"{[round(p / 2**30, 2) for p in r['peak_bytes']]} GiB; "
              f"replicas bit-equal every step")
    print(f"P40 timeline model (the paper's platform, not this card): "
          f"Data-P / Model-P step {dp['p40_ratio'][2]:.2f} at 2 GPUs, "
          f"{dp['p40_ratio'][4]:.2f} at 4")
    rows = dp["update_rows"]
    print("fused_update, no ŵ: " + "; ".join(
        f"{r['shape'].split(':')[0]}: {r['ms']:.4f} ms (bound "
        f"{r['bound_ms']:.4f}, SGD(fused) {r['library_ms']:.4f})"
        for r in rows))


def run_dp_only() -> int:
    """``python3 chip_smoke.py --dp-only``: the card, the build, phase 19
    and phase 28 alone, on the cards present (with a card each the
    replicas take NCCL, and ``--data 4`` runs where there are 4).  Prints
    the Data-P and data-axis lines; no JSON."""
    torch = _torch_or_none()
    if torch is None:
        return 2
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6
    t_start = _T0[0] = time.perf_counter()
    try:
        info = card_info(torch)
        build_kernels(build, r6, m2, fa, fu)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dp = dp_train(torch, ops, ref)
        gc.collect()
        torch.cuda.empty_cache()
        dpipe = data_pipe(torch, ops)
        gc.collect()
        torch.cuda.empty_cache()
        tens = tensor_train(torch, ops)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print_dp(dp)
    print_data_pipe(dpipe)
    print_tensor(tens)
    print_phase_seconds()
    print(f"chip_smoke --dp-only: passed in "
          f"{time.perf_counter() - t_start:.1f}s on {info['smi']}")
    return 0


def run() -> int:
    torch = _torch_or_none()
    if torch is None:
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6

    t_start = _T0[0] = time.perf_counter()
    try:
        info = card_info(torch)
        build_kernels(build, r6, m2, fa, fu)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        errs = kernel_checks(torch, fa, ref)
        paged_errs = paged_checks(torch, fa, ref)
        bwd_errs = bwd_checks(torch, fa, ref)
        mla_errs = mla_kernel_checks(torch, fa, ref)
        encdec_errs = encdec_kernel_checks(torch, fa, ref)
        fused_checks(torch, ops, ref)
        scan_errs = scan_checks(torch, ops, ref)
        scan_bwd_errs = scan_bwd_checks(torch, ops, ref, r6, m2)
        ops.reset_launch_counts()
        model_check(torch)
        ssm_model_check(torch)
        pipelined_check(torch)
        train_check(torch)
        ssm_chk = ssm_train_check(torch)
        new_model_check(torch)
        encdec_chk = encdec_model_check(torch, ops)
        ir_check(torch)
        fma_only(ops)
        simulator_check(torch, ops)
        resume_check(torch)
        ssm = {}
        for arch in SSM_ARCHS:
            ssm[arch] = main_path(torch, ops, arch,
                                  get_config(arch).n_layers)
            ssm[arch]["profile"] = decode_profile(torch, arch)
        for arch in SSM_ARCHS:
            ssm[arch]["long_prompt"] = long_prompt(torch, ops, arch)
        main = main_path(torch, ops, ARCH, get_config(ARCH).n_layers)
        decode_profile(torch)
        pipelined = {}
        for arch in PIPE_ARCHS:
            pipelined[arch] = pipelined_path(torch, ops, arch)
            gc.collect()
            torch.cuda.empty_cache()
        mpmd_srv = mpmd_serve(torch, ops, pipelined)
        new_srv = new_serving(torch, ops)
        mla_srv = mla_serving(torch, ops)
        mla_srv["mpmd"] = mpmd_serve(torch, ops,
                                     {MLA_ARCH: mla_srv["pipelined"]},
                                     (MLA_ARCH,))[MLA_ARCH]
        encdec_srv = encdec_serving(torch, ops)
        vlm_srv = vlm_serving(torch, ops)
        train = train_main_path(torch, ops)
        gc.collect()
        torch.cuda.empty_cache()
        costs = cost_accounting(torch, ops, info)
        new_train = {}
        for arch in NEW_TRAIN:
            gc.collect()
            torch.cuda.empty_cache()
            new_train[arch] = train_main_path(torch, ops, arch,
                                              NEW_TRAIN_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        mla_train = train_main_path(torch, ops, MLA_ARCH, MLA_TRAIN_LAYERS)
        vlm_fwd = vlm_forward_check(torch)
        vlm_train = train_main_path(torch, ops, VLM_ARCH, VLM_TRAIN_LAYERS)
        ssm_train = {}
        for arch in SSM_ARCHS:
            gc.collect()
            torch.cuda.empty_cache()
            ssm_train[arch] = ssm_train_path(torch, ops, arch)
        gc.collect()
        torch.cuda.empty_cache()
        ssm_rounds = ssm_train_path(torch, ops, "rwkv6-7b", "1f1b")
        split = moe_split(torch)
        ir_runs = ir_schedules(torch, ops, ref)
        gc.collect()
        torch.cuda.empty_cache()
        mpmd_runs, mpmd_traced = mpmd_train(torch, ops, ir_runs, True)
        try:
            traced = trace_phase(torch, ops, ir_runs, mpmd_runs,
                                 mpmd_traced)
        finally:
            shutil.rmtree(mpmd_traced["dir"], ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        dp = dp_train(torch, ops, ref, mpmd_runs)
        gc.collect()
        torch.cuda.empty_cache()
        dpipe = data_pipe(torch, ops)
        gc.collect()
        torch.cuda.empty_cache()
        tens = tensor_train(torch, ops)
        evaluation = paper_eval(torch, ops, fu)
        bench_scripts(torch)
        rows = timings(torch, fa, ref, errs)
        rows.extend(wave_timing(torch, fa, ref, paged_errs))
        train_rows = train_timings(torch, fa, ref, ops, bwd_errs)
        mla_rows = mla_timings(torch, fa, ref, mla_errs)
        encdec_rows = encdec_timings(torch, fa, ref, encdec_errs)
        scan_rows = scan_timings(torch, ops, ref, scan_errs)
        scan_bwd_rows = scan_bwd_timings(torch, r6, m2, ref, scan_bwd_errs)
    except Exception:   # every phase's failure ends the run non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    top = rows[0]        # the decode step: the serving path's common call
    design = "mma.sync bf16, packed GQA rows, cp.async 2-stage"
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:39",
        "launches": main["launches"]["flash_fwd"],
        "launches_by_path": {
            "serve": main["launches"]["flash_fwd"],
            "serve zamba2-1.2b": ssm["zamba2-1.2b"]["launches"]["flash_fwd"],
            f"serve pipelined granite-8b ({_depth('granite-8b')})":
                pipelined["granite-8b"]["launches"]["flash_fwd"],
            "train": train["launches"]["flash_fwd"]},
        "variant_by_path": {
            "serve": f"flash_fwd_mma_kernel x "
                     f"{main['variants']['flash_fwd_mma']}",
            "serve zamba2-1.2b": f"flash_fwd_mma_kernel x "
                     f"{ssm['zamba2-1.2b']['variants']['flash_fwd_mma']}",
            "serve pipelined granite-8b": f"flash_fwd_mma_kernel x "
                     f"{pipelined['granite-8b']['variants']['flash_fwd_mma']}"
                     f" (paged rows in the wave)",
            "train": f"flash_fwd_mma_kernel x "
                     f"{train['variants_per_tick']['flash_fwd_mma']} a tick",
            "fp32 checks": "flash_fwd_kernel (FMA)"},
        "design": design,
        "max_abs_err": top["max_abs_err"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "shapes": rows,
    }]
    sources = {"flash_bwd_dq": ("flash_bwd.cu", "flash_attention.py:136"),
               "flash_bwd_dkv": ("flash_bwd.cu", "flash_attention.py:177"),
               "fused_update": ("fused_update.cu", "fused_update.py:22")}
    eval_launches = sum(evaluation[k]["launches"]
                        for k in ("sync", "vanilla", "pipedream",
                                  "spectrain", "spectrain+rmse"))
    for row in train_rows:
        if row["name"] == "fused_update":
            row["shapes"].extend(evaluation["fu_rows"])
        src_file, tpu = sources[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src_file}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": train["launches"][row["name"]],
            "launches_per_tick": train["per_tick"][row["name"]],
            **({"launches_by_path": {
                "train": train["launches"]["fused_update"],
                "paper evaluation (snn-paper, 4 schemes + spectrain with "
                "RMSEs)": eval_launches},
                "launches_per_simulator_step": evaluation["sync"][
                    "per_step"]} if row["name"] == "fused_update" else {}),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], **({"shapes": row["shapes"]}
                                      if "shapes" in row else {}),
            **({"variant_by_path": {
                "train": f"{row['name']}_mma_kernel x "
                         f"{train['variants_per_tick'][row['name'] + '_mma']}"
                         f" a tick",
                "fp32 checks": f"{row['name']}_kernel (FMA)"},
                "design": design} if row["name"].startswith("flash_bwd")
               else {})})
    # the IR rounds' launches (each run counted from 0 to its end)
    for k in kernels:
        if k["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "fused_update"):
            k.setdefault("launches_by_path", {
                "train": train["launches"][k["name"]]})
            k["launches_by_path"]["train IR rounds (all runs)"] = sum(
                r["launches"][k["name"]] for r in ir_runs.values())
            k["launches_per_ir_round"] = {
                label: r["per_round"][k["name"]]
                for label, r in ir_runs.items()}
    # the MPMD runs' launches, summed over the ranks and per rank
    for k in kernels:
        if k["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "fused_update"):
            k["launches_by_path"]["train IR rounds mpmd (all runs, sum "
                                  "over ranks)"] = sum(
                r["launches"][k["name"]] for r in mpmd_runs.values())
            k["launches_per_mpmd_round_per_rank"] = {
                label: [w[k["name"]] for w in r["per_rank"]]
                for label, r in mpmd_runs.items()}
        if k["name"] == "flash_fwd":
            k["launches_by_path"][f"serve pipelined mpmd granite-8b "
                                  f"({_depth('granite-8b')})"] = \
                mpmd_srv["granite-8b"]["launches"]
            k["launches_per_rank_serve_mpmd"] = \
                mpmd_srv["granite-8b"]["per_rank"]
    # the MoE and code models' serving and training runs
    for k in kernels:
        if k["name"] == "flash_fwd":
            for (arch, engine), r in new_srv.items():
                k["launches_by_path"][
                    f"serve {engine} {arch} ({r['layers']} layers)"] = \
                    r["launches"]["flash_fwd"]
        if k["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "fused_update"):
            for arch, r in new_train.items():
                k["launches_by_path"][
                    f"train {arch} ({r['layers']} layers)"] = \
                    r["launches"][k["name"]]
    # the data-parallel replicas' launches, summed over the replicas
    for k in kernels:
        if k["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "fused_update"):
            for n, r in dp["runs"].items():
                if "launches" in r:
                    k["launches_by_path"][
                        f"train data-parallel --data {n} (sum over "
                        f"replicas)"] = r["launches"][k["name"]]
        if k["name"] == "fused_update":
            k["shapes"].extend(dp["update_rows"])
    # phase 28: the data axis under the tick and the 1f1b round
    for k in kernels:
        if k["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "fused_update"):
            for (label, n), r in dpipe["runs"].items():
                k["launches_by_path"][
                    f"train data axis --data {n} {label} ({DATA_PIPE_LAYERS}"
                    f" layers, sum over replicas)"] = r["launches"][k["name"]]
            if k["name"] in tens["bf16"]["launches"]:
                k["launches_by_path"][
                    f"train tensor axis --tensor {TENSOR_RANKS} "
                    f"({TENSOR_LAYERS} layers, sum over ranks)"] = \
                    tens["bf16"]["launches"][k["name"]]
    # minicpm3-4b (multi-head latent attention): rows 1-3 at (96, 64)
    for k in kernels:
        if k["name"] not in mla_rows:
            continue
        k["shapes"].extend(mla_rows[k["name"]])
        k["launches_by_path"][f"train {MLA_ARCH} ({MLA_TRAIN_LAYERS} "
                              f"layers, widths 96 / 64)"] = \
            mla_train["launches"][k["name"]]
        if k["name"] == "flash_fwd":
            for engine in ("simple", "pipelined"):
                r = mla_srv[engine]
                k["launches_by_path"][
                    f"serve {engine} {MLA_ARCH} ({r['layers']} layers, "
                    f"widths 96 / 64)"] = r["launches"]["flash_fwd"]
            k["launches_by_path"][f"serve pipelined mpmd {MLA_ARCH} (sum "
                                  f"over ranks)"] = mla_srv["mpmd"]["launches"]
    # phase 25: the enc-dec models and pixtral-12b
    for k in kernels:
        if k["name"] in encdec_rows:
            k["shapes"].extend(encdec_rows[k["name"]])
        if k["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "fused_update"):
            k["launches_by_path"][f"train {VLM_ARCH} ({VLM_TRAIN_LAYERS} "
                                  f"layers)"] = \
                vlm_train["launches"][k["name"]]
            for arch, r in encdec_chk.items():
                k["launches_by_path"][
                    f"{arch} loss + SGD step (fp32, full width, b 2)"] = \
                    r["launches"][k["name"]]
        if k["name"] == "flash_fwd":
            k["launches_by_path"][
                f"serve simple {ENCDEC_ARCHS[0]} (self + cross a layer)"] = \
                encdec_srv["launches"]["flash_fwd"]
            for engine in ("simple", "pipelined"):
                k["launches_by_path"][
                    f"serve {engine} {VLM_ARCH} "
                    f"({vlm_srv[engine]['layers']} layers)"] = \
                    vlm_srv[engine]["launches"]["flash_fwd"]
    for kind, arch in (("rwkv6", "rwkv6-7b"), ("mamba2", "zamba2-1.2b")):
        name = f"{kind}_scan"
        top = scan_rows[kind][0]        # the decode step: the common call
        v_serve = ssm[arch]["variants"]
        v_long = ssm[arch]["long_prompt"]["variants"]
        launches = {
            "decode": v_serve[f"{name}_decode"],
            "step": ssm[arch]["launches"][name] - v_serve[f"{name}_decode"]
            - v_serve[f"{name}_chunk"],
            "chunk": v_long[f"{name}_chunk"]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:"
                        f"{36 if kind == 'rwkv6' else 29}",
            "launches": ssm[arch]["launches"][name],
            **({"launches_by_path": {
                "serve": ssm[arch]["launches"][name],
                f"serve pipelined rwkv6-7b ({_depth('rwkv6-7b')})":
                    pipelined["rwkv6-7b"]["launches"][name],
                f"serve pipelined mpmd rwkv6-7b ({_depth('rwkv6-7b')}, sum "
                f"over ranks)":
                    mpmd_srv["rwkv6-7b"]["launches"]},
                "launches_per_rank_serve_mpmd":
                    mpmd_srv["rwkv6-7b"]["per_rank"]}
               if kind == "rwkv6" else {}),
            "launches_per_call": ssm[arch]["per_call"][name],
            "launches_long_prompt": ssm[arch]["long_prompt"]["launches"][name],
            "max_abs_err": max(v for (k, _), v in scan_errs.items()
                               if k == kind),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes the "
                       "recurrence",
            "shape": top["shape"], "shapes": scan_rows[kind],
            "variants": [dict(row, launches=launches[row["variant"]],
                              launches_on=("long-prompt serving"
                                           if row["variant"] == "chunk"
                                           else "serving"))
                         for row in scan_rows[kind]]})
    # phase 26: the SSM families' training (ticks and rwkv6's 1f1b rounds)
    tick_path = {arch: f"train {arch} ({r['layers']} layers, "
                       f"{r['stages']} stages)"
                 for arch, r in ssm_train.items()}
    rounds_path = (f"train rwkv6-7b 1f1b rounds ({ssm_rounds['layers']} "
                   f"layers)")
    for k in kernels:
        name = k["name"]
        for arch, r in ssm_train.items():
            if r["launches"].get(name):
                k.setdefault("launches_by_path", {})[tick_path[arch]] = \
                    r["launches"][name]
        if ssm_rounds["launches"].get(name):
            k.setdefault("launches_by_path", {})[rounds_path] = \
                ssm_rounds["launches"][name]
    for kind, arch, line in (("rwkv6", "rwkv6-7b", 64),
                             ("mamba2", "zamba2-1.2b", 300)):
        name = f"{kind}_scan_bwd"
        row = scan_bwd_rows[kind]
        r = ssm_train[arch]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/models/ssm.py:{line}",
            "replaces_note": "no Pallas body: XLA differentiates this "
                             "lax.scan, through which the JAX package "
                             "trains the family",
            "launches": r["launches"][name],
            "launches_per_tick": r["per_step"][name],
            "launches_by_path": {tick_path[arch]: r["launches"][name],
                                 **({rounds_path:
                                     ssm_rounds["launches"][name]}
                                    if kind == "rwkv6" else {})},
            "max_abs_err": row["max_abs_err"],
            "max_rel_err_of_max": max(v["rel"] for (kd, _), v in
                                      scan_bwd_errs.items() if kd == kind),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes the "
                       "recurrence's gradient",
            "shape": row["shape"], "kernel": row["kernel"],
            "variant": "chunked (s >= 64): "
                       f"{r['variants_per_step'][name + '_chunk']} a tick",
            "tensor_core_gflop": row["tensor_core_gflop"],
            "tensor_core_pass_gflop": row["tensor_core_pass_gflop"],
            "at_b1": {k: row["b1"][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "tensor_core_gflop")}})
    # phase 30: the tensor axis's ranks on the four decoders, and the
    # kernels at a rank's shapes
    for k in kernels:
        for arch, _ in TENSOR_MODELS:
            r = tens[arch]
            if r["launches"].get(k["name"]):
                k.setdefault("launches_by_path", {})[
                    f"train tensor axis --tensor {TENSOR_RANKS} {arch} "
                    f"({r['layers']} layers, {r['rows']} x {r['seq']}, sum "
                    f"over ranks)"] = r["launches"][k["name"]]
        kind = k["name"].split("_scan")[0]
        if k["name"].endswith("_scan_bwd"):
            k["tensor_rank"] = scan_bwd_rows[kind]["tensor_rank"]
        elif k["name"].endswith("_scan"):
            k["tensor_rank"] = scan_rows[f"{kind} tensor rank"]
    for arch, rec in ssm.items():
        lp = rec["long_prompt"]
        print(f"{arch} long prompts: time to first token "
              f"{[round(t, 3) for _, t in lp['ttft_ms']]} ms at "
              f"{[n for n, _ in lp['ttft_ms']]} tokens; one "
              f"{lp['prefill_tokens']}-token prefill "
              f"{lp['prefill_wall_ms']:.3f} ms wall, "
              f"{lp['prefill_busy_ms']:.3f} ms busy, scans "
              f"{lp['prefill_scan_ms']:.3f} ms")
    for arch, rec in ssm.items():
        run, prof = rec["run"], rec["profile"]
        print(f"{arch} serving: {run['tok_per_s']:.2f} tok/s, p50 "
              f"{run['token_ms_p50']:.3f} ms/token, p99 "
              f"{run['token_ms_p99']:.3f}; decode step {prof['wall_ms']:.3f} "
              f"ms wall, {prof['busy_ms']:.3f} ms busy, "
              f"{100 * prof['idle_share']:.1f}% idle, "
              f"{prof['kernels_per_step']:.0f} kernels; peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB")
    for arch, rec in pipelined.items():
        run = rec["run"]
        wv = rec["wave_vs_steps"]["logits"]
        print(f"{arch} pipelined serving ({rec['layers']} layers, pipe 4, "
              f"8 slots, 24 requests): "
              f"{rec['run_tok_per_s']:.2f} tok/s against SimpleEngine's "
              f"{rec['simple_tok_per_s']:.2f}, both over run()'s wall "
              f"after warm-up "
              f"({rec['run_tok_per_s'] / rec['simple_tok_per_s']:.2f}x; "
              f"{rec['tok_per_s']:.2f} tok/s inside the rounds); p50 "
              f"{run['token_ms_p50']:.3f} / {rec['simple_p50']:.3f} ms/token, "
              f"p99 {run['token_ms_p99']:.3f} / {rec['simple_p99']:.3f}; "
              f"{rec['rounds']} rounds; steady round "
              f"{rec['round_wall_ms']:.3f} ms wall, "
              f"{rec['round_busy_ms']:.3f} ms busy "
              f"({100 * (1 - rec['round_busy_ms'] / rec['round_wall_ms']):.1f}"
              f"% idle), {rec['round_kernels']:.0f} kernels; "
              f"{rec['traffic_ms']}; peak {rec['peak_bytes'] / 2**30:.2f} "
              f"GiB; first tokens equal {rec['first_equal']}, whole "
              f"{rec['whole_equal']}; one wave's logits vs the steps "
              f"{wv['wave_step']:.3e}, the steps vs fp32 "
              f"{wv['step_fp32']:.3e}")
    print(f"\nchip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f}s on {info['smi']}")
    for scheme in ("sync", "vanilla", "pipedream", "spectrain",
                   "spectrain+rmse"):
        rec = evaluation[scheme]
        rmse = "".join(f"; s={k} stale/pred {st / pr:.3f}"
                       for k, (pr, st) in rec.get("rmse", {}).items())
        learned = (f"; final loss {rec['final_loss']:.4f}, held-out "
                   f"accuracy {rec['held_acc']:.4f}" if "held_acc" in rec
                   else f"; {len(rec['losses'])} steps")
        print(f"snn-paper {scheme}: {rec['wall_ms']:.3f} ms/step wall, "
              f"{rec['busy_ms']:.3f} ms busy ({100 * rec['idle']:.1f}% "
              f"idle), bound {rec['bound_ms']:.3f} ms{learned}; peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB{rmse}")
    print(f"snn-paper label prior: loss {evaluation['prior']['loss']:.4f}, "
          f"majority share {evaluation['prior']['majority']:.4f}; Table 1 "
          f"bounds: {evaluation['table1']}")
    for label, r in ir_runs.items():
        stash = (f", stash copy {r['stash_ms']:.3f} ms"
                 if r["stash_ms"] is not None else "")
        print(f"IR round {label} ({r['layers']} layers, {r['chunks']} "
              f"chunks, {r['round']} microbatches): "
              f"{r['wall_ms']:.3f} ms wall, {r['busy_ms']:.3f} ms busy "
              f"({100 * (1 - r['busy_ms'] / r['wall_ms']):.1f}% idle), "
              f"{r['tok_per_s']:.1f} tokens/s, fused_update "
              f"{r['kernel_ms']['fused_update']:.3f} ms in "
              f"{r['per_round']['fused_update']} launches, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB{stash}")
    for label, r in mpmd_runs.items():
        print(f"MPMD round {label} ({r['chunks']} chunks, {r['transport']}):"
              f" {r['wall_ms']:.3f} ms wall on rank 0 (SPMD "
              f"{r['spmd_wall_ms']:.3f}), per-rank busy "
              f"{[round(b, 3) for b in r['busy_ms']]} ms, kernels "
              f"{r['n_kernels']}, peak "
              f"{[round(p / 2**30, 2) for p in r['peak_bytes']]} GiB, "
              f"transport {[round(t, 3) for t in r['transport_ms']]} ms; "
              f"leaves bit-equal {r['digests']['bit_equal']}/"
              f"{r['digests']['copies']}, losses "
              f"{'bit-equal' if r['loss_equal'] else 'within rtol'}")
    for arch, r in mpmd_srv.items():
        print(f"MPMD serving {arch}: tokens equal {r['equal'][0]}/"
              f"{r['equal'][1]}, {r['tok_per_s']:.2f} tok/s (scan "
              f"{r['scan_tok_per_s']:.2f}), median round {r['round_ms']:.3f}"
              f" ms")
    for label, r in traced["ir"].items():
        print(f"traced IR round {label}: {r['events']} events, bit-equal "
              f"to untraced; events {r['sum_ms']:.3f} ms of a "
              f"{r['traced_mean_ms']:.3f} ms wall (busy {r['busy_ms']:.3f}, "
              f"fused_update {r['update_ms']:.3f}); bubble measured "
              f"{r['bubble']:.3f} vs IR {r['bubble_ir']:.3f}; wall traced "
              f"{r['traced_ms']:.3f} / untraced {r['plain_ms']:.3f} ms "
              f"({r['overhead_pct']:+.1f}%)")
    r = traced["mpmd"]
    print(f"traced MPMD round {r['label']}: {r['events']} events in "
          f"{len(r['lane_ms'])} rank lanes, bit-equal to untraced; lanes "
          f"{[round(x, 3) for x in r['lane_ms']]} ms; bubble measured "
          f"{r['bubble']:.3f} vs IR {r['bubble_ir']:.3f}; rank 0 wall "
          f"{r['wall_ms']:.3f} ms (untraced {r['plain_wall_ms']:.3f})")
    r = traced["pairs"]
    print(f"tracer overhead, full-width 1f1b, {TRACE_PAIRS} alternating "
          f"pairs on one state: traced {r['on_ms']:.3f} / untraced "
          f"{r['off_ms']:.3f} ms ({r['pct']:+.2f}%, traced slower in "
          f"{r['slower']} of {TRACE_PAIRS})")
    print(f"traced stream tick: probed stage forwards "
          f"{[round(x, 3) for x in traced['stream']['probed_ms']]} ms; "
          f"{'; '.join(traced['bench'])}")
    print_dp(dp)
    print_data_pipe(dpipe)
    print_tensor(tens)
    for (arch, engine), r in new_srv.items():
        run = r["run"]
        print(f"{arch} serving ({engine}, {r['layers']} layers, bf16): "
              f"{run['tok_per_s']:.2f} tok/s over the launcher's wall, p50 "
              f"{run['token_ms_p50']:.3f} ms/token, p99 "
              f"{run['token_ms_p99']:.3f}"
              + (f", {r['tok_per_s']:.2f} tok/s over the rounds, "
                 f"{r['rounds']} rounds" if engine == "pipelined" else
                 f", max |logit| {r['max_abs_logit']:.3f}")
              + f"; peak {r['peak_bytes'] / 2**30:.2f} GiB"
              + ("" if "profile" not in r else
                 f"; decode step {r['profile']['wall_ms']:.3f} ms wall, "
                 f"{r['profile']['busy_ms']:.3f} ms busy "
                 f"({100 * r['profile']['idle_share']:.1f}% idle), "
                 f"{r['profile']['kernels_per_step']:.0f} kernels"))
    for arch, r in new_train.items():
        aux = (f", aux {r['aux'][-1]:.5f}" if r["aux"] else "")
        print(f"{arch} training tick ({r['layers']} layers, 4 stages): "
              f"{r['wall_ms']:.3f} ms wall, {r['tok_per_s']:.1f} tokens/s, "
              f"device busy {r['busy_ms']:.3f} ms, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; last loss "
              f"{r['losses'][-1]:.4f}{aux}")
    print(f"deepseek-moe-16b MoE layer at the tick's shape: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split["ms"].items())
          + f"; forward {split['fwd_ms']:.4f} ms, forward + backward "
          f"{split['fwd_bwd_ms']:.4f} ms")
    simple, pipe, mpmd = (mla_srv[k] for k in ("simple", "pipelined",
                                                "mpmd"))
    prof = simple["profile"]
    print(f"{MLA_ARCH} serving (bf16): SimpleEngine at 62 layers "
          f"{simple['run']['tok_per_s']:.2f} tok/s over the launcher's wall, "
          f"p50 {simple['run']['token_ms_p50']:.3f} ms/token, p99 "
          f"{simple['run']['token_ms_p99']:.3f}; decode step "
          f"{prof['wall_ms']:.3f} ms wall, {prof['busy_ms']:.3f} ms busy "
          f"({100 * prof['idle_share']:.1f}% idle), "
          f"{prof['kernels_per_step']:.0f} kernels, flash_fwd "
          f"{prof['kernel_ms']['flash_fwd']:.4f} ms; pipelined at "
          f"{pipe['layers']} layers "
          f"{pipe['run_tok_per_s']:.2f} tok/s over run() after warm-up "
          f"({pipe['tok_per_s']:.2f} over the rounds, {pipe['rounds']} "
          f"rounds); MPMD {mpmd['tok_per_s']:.2f} tok/s, tokens equal "
          f"{mpmd['equal'][0]}/{mpmd['equal'][1]}; peaks "
          f"{simple['peak_bytes'] / 2**30:.2f} / "
          f"{pipe['peak_bytes'] / 2**30:.2f} GiB")
    print(f"{MLA_ARCH} training tick ({MLA_TRAIN_LAYERS} layers, 4 stages): "
          f"{mla_train['wall_ms']:.3f} ms wall, "
          f"{mla_train['tok_per_s']:.1f} tokens/s, device busy "
          f"{mla_train['busy_ms']:.3f} ms, peak "
          f"{mla_train['peak_bytes'] / 2**30:.2f} GiB; last loss "
          f"{mla_train['losses'][-1]:.4f}")
    for name, rows_ in mla_rows.items():
        for row in rows_:
            print(f"{name} {row['shape']}: {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ({row['bound_by']}), plain "
                  f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}")
    for arch, r in encdec_chk.items():
        print(f"{arch} (full width, fp32): decode against forward max |d| "
              f"{r['decode_err']:.3e}; one SGD step card vs CPU: loss rel "
              f"{r['loss_rel']:.2e}, params {r['param_err']:.3e}, momentum "
              f"{r['mom_rel']:.2e} of max")
    prof = encdec_srv["profile"]
    print(f"{ENCDEC_ARCHS[0]} serving (SimpleEngine, {ENCDEC_SERVE_REQUESTS} "
          f"requests, bf16): {encdec_srv['run']['tok_per_s']:.2f} tok/s over "
          f"the launcher's wall, p50 {encdec_srv['run']['token_ms_p50']:.3f} "
          f"ms/token; decode step {prof['wall_ms']:.3f} ms wall, "
          f"{prof['busy_ms']:.3f} ms busy ({100 * prof['idle_share']:.1f}% "
          f"idle), {prof['kernels_per_step']:.0f} kernels")
    simple, pipe = vlm_srv["simple"], vlm_srv["pipelined"]
    prof = simple["profile"]
    print(f"{VLM_ARCH} serving (40 layers, bf16): SimpleEngine "
          f"{simple['run']['tok_per_s']:.2f} tok/s over the launcher's wall; "
          f"decode step {prof['wall_ms']:.3f} ms wall, {prof['busy_ms']:.3f} "
          f"ms busy ({100 * prof['idle_share']:.1f}% idle), "
          f"{prof['kernels_per_step']:.0f} kernels; pipelined "
          f"{pipe['tok_per_s']:.2f} tok/s over the rounds ({pipe['rounds']} "
          f"rounds); forward with {VLM_PATCHES} patches card vs CPU "
          f"{vlm_fwd['rel']:.2e} of max |logit|")
    print(f"{VLM_ARCH} training tick ({VLM_TRAIN_LAYERS} layers, 4 stages): "
          f"{vlm_train['wall_ms']:.3f} ms wall, "
          f"{vlm_train['tok_per_s']:.1f} tokens/s, device busy "
          f"{vlm_train['busy_ms']:.3f} ms, peak "
          f"{vlm_train['peak_bytes'] / 2**30:.2f} GiB; last loss "
          f"{vlm_train['losses'][-1]:.4f}")
    for name, rows_ in encdec_rows.items():
        for row in rows_:
            print(f"{name} {row['shape']}: {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ({row['bound_by']}), plain "
                  f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}")
    for r in list(ssm_train.values()) + [ssm_rounds]:
        unit = "tick" if r["schedule"] == "stream" else f"{r['schedule']} round"
        bwd = sum(ms for n, ms in r["kernel_ms"].items()
                  if n.endswith("_scan_bwd"))
        print(f"{r['arch']} training {unit} ({r['layers']} layers, "
              f"{r['stages']} stages, {r['n_params']:,} parameters): "
              f"{r['wall_ms']:.3f} ms wall, {r['tok_per_s']:.1f} tokens/s, "
              f"device busy {r['busy_ms']:.3f} ms, the scans' backward "
              f"{bwd:.3f} ms ({100 * bwd / r['busy_ms']:.1f}% of busy), peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; last loss "
              f"{r['losses'][-1]:.4f}")
    for arch, r in ssm_chk.items():
        print(f"{arch} smoke training card vs CPU: losses rel "
              f"{r['loss']:.2e}, params, momentum and prediction max |d| "
              f"{r['abs']:.2e}, {r['noise']} leaves held to the CPU's own "
              f"move under a {NOISE_REL:g} perturbation (worst "
              f"{r['ratio']:.2f}x)")
    for kind, row in scan_bwd_rows.items():
        for rw in (row, row["b1"]):
            print(f"{kind}_scan_bwd {rw['shape']}: {rw['ms']:.4f} ms, bound "
                  f"{rw['bound_ms']:.5f} ({rw['bound_by']}), plain "
                  f"{rw['plain_ms']:.4f}")
    for arch, r in costs["ticks"].items():
        print(f"cost accounting {arch} tick ({r['layers']} layers, "
              f"{r['stages']} stages): model_flops {r['model_flops']:.6e}, "
              f"counted {r['counted_flops']:.6e}, useful_flops_ratio "
              f"{r['useful_flops_ratio']:.4f}, wall {r['wall_ms']:.3f} ms, "
              f"MFU {100 * r['mfu']:.2f}%, counted peak "
              f"{r['counted_peak_bytes'] / 2**30:.3f} GiB against "
              f"{r['peak_bytes'] / 2**30:.3f} GiB ({100 * r['mem_gap']:+.2f}%)"
              f" on {info['smi']}")
    print(f"training tick: {train['wall_ms']:.3f} ms wall, "
          f"{train['tok_per_s']:.1f} tokens/s, device busy "
          f"{train['busy_ms']:.3f} ms, peak {train['peak_bytes'] / 2**30:.2f} "
          f"GiB")
    print_phase_seconds()
    print(info["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(run_mpmd_only() if "--mpmd-only" in sys.argv[1:]
             else run_dp_only() if "--dp-only" in sys.argv[1:]
             else run_tensor_only() if "--tensor-only" in sys.argv[1:]
             else run())
