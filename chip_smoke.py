#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CapsNet serving (dynamic and EM routing,
unsharded and sharded, one server and a fleet under chaos), training and
fast-math paths, its LM serving and training (granite-3-2b and
falcon-mamba-7b), MoE serving and training (qwen3-moe-30b-a3b), mixtral-8x7b
with sliding-window attention and the expert-parallel MoE dispatch,
phi3-medium-14b, mistral-large-123b, stablelm-12b (head dim 160) and the
zamba2-7b hybrid (Mamba-2, head dim 112), llava-next-mistral-7b (VLM)
and the seamless-m4t-large-v2 encoder-decoder (cross attention), its dry
run, granite-3-2b's width at a head dim of 320 (the flash-attention
kernels' wide route) and the six examples' twins, on one H100.  Every CLI
it runs (but those on several ranks) runs in this process through its
``main`` (``run_cli``).

    python3 chip_smoke.py [--out results.json]

Phases, each printing its own lines:

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, capability; TF32 is switched off for convolutions and
   products so both backends compute in fp32.
2. build — compiles every kernel from ``src/repro_torch/csrc`` with nvcc,
   one compiler per source, all at once (``repro_torch.kernels.cudalib``),
   and counts the tensor-core instructions (HMMA, HGMMA) of each bf16
   flash-attention kernel in the library's SASS (``cuobjdump -sass``) at
   every head dim of ``HEAD_DIMS`` and of the bf16 wide kernels (head
   dims above 256: the forward and the backward's two) at each of their
   pair counts (and the backward's terms of ds), with each
   flash-attention kernel's registers and spills by instantiation
   (``-Xptxas -v``): the head dim, the wide fp32 kernels' dtype, the bf16
   wide kernels' pair count (and terms).
3. kernels — every routing kernel against its plain PyTorch version on the
   card, on the votes the serving path hands it (the CapsNet encoder at
   random weights on synthetic images) for Caps-MN1, Caps-EN3, Caps-CF3,
   Caps-MN1 at the CLI's default microbatch of 8 and Caps-EN3 at 128 (its
   fp32 stream too wide to stage: the unstaged path), and on seeded votes
   (B=20, L=90, H=7, C=5: the one-column path and the 4-byte and element
   copies): the procedure kernel at
   fp32 (exact and approx), bf16, int8 and early exit at ε = 0, 8 and 1e6;
   the iteration kernel at fp32 and bf16.  Tolerance: max|Δ| ≤ 1e-5 on v
   (and on s and b_new scaled by max(1, max|plain|)); early-exit work
   counters equal, ε = 0 giving iterations · n_tiles; two calls bitwise
   equal.  Times are medians of 20 CUDA-event-timed calls after 3 warm-up
   calls, which hold the wrapper's host work, and beside them the device
   time (``device_ms``: the span the card is busy with the call's CUDA
   kernels by ``torch.profiler``, median of 20 calls, reported only
   between 0.95 × the bound and the calls' CUDA-event time; phases 5–7
   give it too); each line also gives the
   stream bytes (û once per iteration)
   over the time in TB/s and the tile kernel's blocks and cluster size
   (``ops.tile_geometry``).
4. serve — Caps-MN1 at full width through ``CapsServer`` with
   ``RouterSpec(backend="cuda")`` and ``ServeConfig(microbatch=100,
   n_micro=2)``: the wave scores against a ``backend="torch"`` server on
   the same packed waves (max|Δ| ≤ 1e-5, predictions equal wherever the
   top-two margin exceeds 1e-4), one wave's time split into its stages,
   then 600 requests in ragged arrivals in sync and in async mode (the
   main path, whose kernel launches are counted), then 150 in sync mode
   with ``fusion="iteration"`` (the fallback path, counted on its own).
5. train — the forward kernel at ``procedure_train_l_tile`` (max|Δ| ≤
   1e-5 on v, two calls bitwise equal) and the backward kernel against
   their plain versions on the votes of Caps-MN1, Caps-EN3, Caps-CF3,
   Caps-SV3 (9 iterations) and Caps-MN1 at B=8, fp32 and bf16, with a
   seeded random ∂v.  Backward
   tolerance: fp32 max|Δ| ≤ max(1e-5 · max(1, max|plain|), 2·ε64); bf16
   within one bf16 rounding, |Δ| ≤ 2^-7·|plain| + max(1e-6, 2·ε64)
   element-wise, where ε64 is the plain version's own error against a
   float64 autograd reference on the same shape (below 1e-6 at 3
   iterations; 2.9e-3 at Caps-SV3, where 9 iterations amplify fp32
   round-off); two calls bitwise equal; medians of 20 CUDA-event-timed
   calls, the device time split into replay, reverse sweep and ∂û, and
   the reverse tile kernel's blocks and cluster.  Then Caps-MN1 at
   full width, B=100: the step-1 parameter gradients of
   ``make_capsnet_train_step(cfg, plan="auto")`` (the kernels) and of the
   bf16 stream against ``make_capsnet_train_step(cfg)`` (exact torch
   routing) within 1e-4 and 2e-2 per element, the loss on the step's batch
   lower after the step, 5 steps with finite losses and exactly one
   forward and one backward kernel launch each (the main training path,
   counted on its own), one step's time split into its stages, and the
   training CLI (``--smoke --routing fused``) whose checkpoint loads back
   through ``convert.load_jax_checkpoint`` with equal parameters.
6. em and fast math — ``em_stage_stats`` and ``em_stage_estep`` against
   their plain versions on the phase-3 votes, with a_in the serving mask
   (a broadcast view) and a seeded sigmoid, r a softmax of seeded logits,
   and μ, 1/σ² and the bias from one real M-step, and on the phase-3
   seeded votes B=20, L=90, H=7, C=5 (H·C not a multiple of 4: the
   E-step's scalar path) and, past 256 capsules (the wide E-step kernel,
   h-passes of 256), B=4, L=128, H=300, C=16 (16-byte loads) and B=2,
   L=64, H=257, C=5 (scalar): max|Δ| ≤ 1e-5 · max(1, max|plain|) on each
   output, two calls bitwise equal, medians of 20 CUDA-event-timed calls
   and the device time; the E-step's geometry (``ops.estep_geometry``).
   Then the whole EM procedure at Caps-MN1,
   B=100: ``RouterSpec(algorithm="em", backend="cuda")`` against
   ``backend="torch"`` within the reference's gate (rtol 1e-4, atol
   1e-5), both against a float64 run, the spread of ``a_out``, and one
   router call's device time split into statistics, E-step and the rest.
   Then
   Caps-MN1 EM serving at full width through ``CapsServer`` (600 requests
   in ragged arrivals, sync; the main EM path, whose launches are counted:
   each EM kernel exactly iterations × n_micro per wave), one wave split
   into encoder and EM stage, and the CLI ``--algorithm em``.  Last,
   ``fastmath.ops.exp``/``inv_sqrt``/``reciprocal`` with recovery on and
   off at 2^26 elements and at the reference test's shapes, on its inputs
   and on inputs reaching the clip at 254.999 and the subnormal range:
   kernel and plain version bitwise equal (max ULP 0), within the
   reference's accuracy bounds of the exact functions, timed beside the
   bound and the exact functions' PyTorch times.

7. sharded — 7a, one rank on the card (a 1-rank NCCL group over
   ``dist.HashStore()``, ``make_mesh((1,), ("vault",))``): the three
   stage kernels against their plain versions on the phase-3 votes of
   Caps-MN1, Caps-EN3, Caps-CF3 and Caps-MN1 at B=8, on the seeded
   votes (H·C = 35: the update kernel's one-element runs) and on
   Caps-EN2's and Caps-EN3's votes at B=8 handed over as views that are
   not 16-byte aligned (one-element runs in two passes), fp32 and
   bf16, exact and approx, at the inputs of the procedure's iteration 1
   (max|Δ| ≤ 1e-5·max(1, max|plain|) on each output, two calls bitwise
   equal, medians of 20 CUDA-event-timed calls, the device time against
   the bound, the update kernel's geometry from
   ``ops.stage_update_geometry``), with the ungated time of
   ``torch.einsum("blhc,bhc->lh", û, v)`` beside them (Eq.4 alone, not
   the same function); the whole sharded procedure at
   Caps-MN1, B=100, for {B}, {L} and {H} against the unsharded procedure
   kernel and the torch backend (rtol 2e-4, atol 2e-5), EM {B} and {L}
   against the torch path (rtol 1e-4, atol 1e-5), the collectives timed
   alone; then the slice's main path, ``CapsServer`` at Caps-MN1 full
   width with ``ServeConfig(microbatch=100, n_micro=2,
   pipeline="software", routing_plan="auto")``: the resolved dimension,
   wave scores within 1e-5 of an unsharded torch-backend server, one wave
   split into encoder and sharded routing, 600 requests in ragged arrivals
   (sync; each stage kernel of the plan's form exactly iterations ×
   n_micro launches per wave), 150 with ``routing_plan=(("L", "vault"),)``
   (the fold path, counted on its own), and ``serve_caps --plan auto``.
   7b, two gloo ranks sharing the card (``repro_torch.launch.ranks``;
   NCCL refuses two ranks on one GPU):
   dynamic {B}, {L}, {H} and EM {B}, {L} over a (2,) vault mesh against
   each rank's unsharded result, and a Caps-MN1 wave through
   ``pipeline="two_stage"`` over a (2, 1) (pipe, vault) mesh with
   ``routing_plan="auto"`` within 1e-5 of the unpipelined arm.
8. lm — the two LM kernels against their plain versions on the card:
   ``flash_attention`` at granite-3-2b's prefill wave (B=8, Hq=32, Hkv=8,
   S=1024, D=64, causal) in bf16 and fp32, the reference's FLASH_CASES,
   odd S, and D = 112 and 160 in fp32 and bf16; ``selective_scan`` at falcon-mamba-7b's prefill (Bt=4,
   T=1024, Din=8192, N=16, bf16) and the reference's SSM_CASES, y and h_T,
   with and without h0.  Tolerance: fp32 max|Δ| ≤ 1e-5·max(1,
   max|plain|); the scan in bf16 each element within one bf16 ulp of the
   plain output on top of that fp32 gate.  bf16 attention runs on the
   tensor cores, which round p to bf16 before its product as the library
   does, and is held to the library-anchored gate (``lib_gate``): against
   the same function in float64, max|kernel − exact| ≤ 2·max|SDPA −
   exact| + g and the mean ≤ 1.5·the library's mean + g (g = 1e-5·max(1,
   max|exact|)); the plain version's rounding model (``round_operands``,
   the kernel's 64 × 64 tiles) is held to the same gate, max|Δ| is the
   kernel's distance from it, and the one-ulp gate's verdict on kernel
   and library is printed.  Two calls bitwise equal; medians of 20
   CUDA-event-timed calls beside the bound (bf16 operations at 989
   TFLOP/s) and, for attention, SDPA; for the scan also the
   special-function floor (one exp per (t, channel, state) at 16 a clock
   on 132 SMs at 1.98 GHz) and its blocks.  Then granite-3-2b at full width,
   all 40 layers, random bf16 weights: 16 requests (prompt 1024, +32
   tokens) through ``WaveServer`` and ``LMDecodeAdapter`` in waves of 8 —
   the main path, counted: exactly 40 ``flash_attention`` launches a wave,
   books balanced, nothing failed or shed — the prefill logits of the
   kernel path against the plain path on the same weights (max|Δ| /
   max|logit| stated; the first token equal wherever the top-2 margin
   exceeds 2·max|Δ|), and one prefill split into attention kernel,
   projections and MLP.  Then falcon-mamba-7b at full width and depth (64
   layers): 4 prompts of 1024 tokens prefilled with exactly 64
   ``selective_scan`` launches, 32 tokens greedily decoded, layer 0's scan
   (y and h_T) against the plain version.  Last, ``python -m
   repro_torch.launch.serve --smoke`` and ``serve_caps --model lm
   --smoke`` on the card.
9. lm training — ``flash_attention_fwd_lse`` and ``flash_attention_bwd``
   against their plain versions at granite-3-2b's training shape (B=8,
   Hq=32, Hkv=8, S=1024, D=64, causal) in bf16 and fp32, the reference's
   BWD_CASES, odd S, a bidirectional bf16 case at D=128, and D = 112 and
   160 in fp32 and bf16, causal and bidirectional: in fp32 o,
   lse, dq within 1e-5·max(1, max|plain|) and dk, dv too; in bf16 (the
   tensor-core kernels) o, lse, dq, dk, dv each by the phase-8
   library-anchored gate, the library being the flash-attention op's o
   and lse on expanded KV heads and SDPA's autograd backward (dk, dv of
   the float64 reference summed over the group in float64), with the
   plain rounding model under the same gate and the one-ulp verdicts
   printed; lse within 1e-5 (rtol and atol) of a dense logsumexp; two
   calls bitwise equal; medians of 20 CUDA-event-timed calls beside the
   bound (the backward counted at 2.5× the forward's products) and the
   library (fp32: the memory-efficient op); then the device time of the
   bf16 serving forward and backward at granite's shape by part
   (``torch.profiler``).  Then the main training path, counted:
   granite-3-2b at full width and depth (40 layers, batch 8 × 1024, remat)
   for 5 ``make_train_step`` steps on one repeated batch with warmup=1
   under the two-level remat (groups of 5) — the loss falls, exactly
   3 × 40 − 8 = 112 ``flash_attention_fwd_lse`` (``train_attention_
   launches``) and 40 ``flash_attention_bwd`` launches a step — with step
   time, tokens/s, peak memory and a step split into forward, backward
   and clip + AdamW; the kernel route against the plain-version route at
   full width cut to 2 layers (whole-tree gradients, max|Δ| / max|g| under
   ``TRAIN_GRAD_REL_LIMIT``); falcon-mamba-7b at full width cut to 8 of
   64 layers, B=1 × 1024, 5 steps through the chunked scan with no kernel
   launch; and ``python -m repro_torch.launch.train --smoke`` with a
   checkpoint and a resume.
10. fleet — Caps-MN1 at full width behind ``CapsFleet``: 2..3 replicas
   sharing the card, waves of 100 × 2 deadline-ordered, cuda-backend
   dynamic routing, 2000 requests in ragged arrivals from two tenant
   threads, both arms on one wave function warmed first (the fleet's
   cache, injected).  A clean arm (the main path, counted: the procedure
   kernel launched) whose first waves' scores are held to phase 4's
   single-server wave function on the same packed waves (max|Δ| ≤ 1e-5),
   and a chaos arm under ``faults.fleet_wrap`` with plans from
   ``FaultPlan.generate``: replica 0 errs, returns NaN scores, straggles
   and crashes; replica 1 errs, corrupts and straggles.  Gates: 0 lost
   and 0 failed, books balanced for each tenant, evacuated == adopted, the
   crash buried once, one guard trip for each corrupt fault fired.  Each
   arm's req/s and p50/p90 beside phase 4's, the elastic events, and the
   CLI ``serve_caps --replicas 2 --max-replicas 3 --tenants 2 --chaos``.
11. moe — ``flash_attention`` at qwen3-moe-30b-a3b's prefill (B=4,
   Hq=32, Hkv=4, S=1024, D=128, causal, bf16) by ``lib_gate`` beside SDPA;
   qwen3-moe-30b-a3b at full width and depth (48 layers, 128 experts top
   8, random bf16 weights, about 61 GB): 4 prompts of 1024 + 32 tokens
   through ``WaveServer`` and ``LMDecodeAdapter`` (the main path, counted:
   exactly 48 ``flash_attention`` launches a wave), time to first token,
   decode step, generated tokens/s, the MoE dispatch's share of a prefill
   (two MoE forwards bitwise equal), peak memory, the kernel route against
   the plain route at a 2-layer cut (phase 8's gate), and the CLIs
   ``serve --arch qwen3-moe-30b-a3b --smoke`` and ``serve_caps --model
   moe --smoke``.
12. mixtral and MoE training — the three flash-attention kernels with
   mixtral-8x7b's sliding window (4096) at B=1, Hq=32, Hkv=8, D=128, S =
   8192 and 6144 (not a multiple of the window), fp32 and bf16: fp32
   within 1e-5·max(1, max|plain|) of the plain versions (dk, dv by the
   grouped gate), bf16 by ``lib_gate``, the library being SDPA with an
   explicit boolean band mask on expanded KV heads (its autograd backward;
   lse from the memory-efficient op with the band as a bias), the plain
   rounding model under the same gate; window = S bitwise causal, two
   calls bitwise equal; event and device ms beside the band's bound and
   the unwindowed forward.  mixtral-8x7b at full width cut to 24 of 32
   layers (70.2 GB bf16): 2 prompts of 6144 + 32 tokens through
   ``WaveServer`` and ``LMDecodeAdapter`` (the main path, counted:
   exactly 24 ``flash_attention`` launches a wave; the cache rolls from
   the first decode step), TTFT, decode step, tokens/s, the MoE share,
   peak memory.  The rolling cache at a 2-layer fp32 cut with every token
   kept: 8 decode steps' logits each within 1e-4 of max|logit| of a full
   windowed forward on the plain route, at S = 6144 and 8192, and the
   kernel route's prefill against the plain route's (phase 8's gate).
   ``flash_attention_fwd_lse`` and ``flash_attention_bwd`` at
   qwen3-moe's training shape by ``lib_gate``; qwen3-moe-30b-a3b at full
   width cut to 6 of 48 layers, batch 4 × 1024, remat (two levels,
   groups of 2), 5 steps (counted: 3 × 6 − 3 = 15 forward and 6 backward
   launches a step), the loss falling,
   moe_aux, step time, tokens/s, peak memory; its kernel route against
   the plain route at 2 layers (fp32 gradients under
   ``MOE_GRAD_REL_LIMIT``, bf16 reported with its rerouted tokens);
   ``train --arch mixtral-8x7b --smoke``.  Last, one qwen3-moe MoE layer
   at full width on 4 × 1024 tokens over two gloo ranks sharing the card
   through the Router's "E"-sharded plan (64 experts a rank): y and aux
   within 1e-5·max(1, max|y|) of the 1-rank dispatch in fp32, bf16
   reported, the dispatch time beside the unsharded one and the psum's
   share.
13. slice 11 b–c — the three flash-attention kernels at D = 112 and 160
   with a sliding window (small shapes, fp32 and bf16, as phase 12), and
   ``flash_attention`` at the prefill shape of each model below by
   ``lib_gate`` beside SDPA, the two training kernels at stablelm-12b's
   (4, 32, 8, 1024, 160) and zamba2-7b's (4, 32, 32, 1024, 112); then,
   each freed before the next, phi3-medium-14b (40 layers, D = 128),
   mistral-large-123b at full width cut to 24 of 88 layers, stablelm-12b
   (40 layers, D = 160) and zamba2-7b (81 Mamba-2 layers and 13 calls of
   the shared attention block, D = 112), random bf16 weights, each serving
   4 prompts of 1024 + 32 tokens in one wave through ``WaveServer`` and
   ``LMDecodeAdapter`` (the main path, counted: exactly one
   ``flash_attention`` launch an attention block a wave): TTFT, decode
   step, generated tokens/s, peak memory, the attention kernel's share of
   a prefill (zamba2: the Mamba-2 layers' and their SSD chunk loop's
   too), the kernel route against the plain route at 2 layers (zamba2:
   one super-block) under phase 8's gate.  zamba2's decode at a 15-layer
   fp32 cut: 8 greedy steps each within 1e-4 of max|logit| of a full
   forward on the plain route.  stablelm-12b cut to 8 of 40 layers and
   zamba2-7b cut to 15 of 81 (2 super-blocks and a tail of 3), batch 4 ×
   1024, remat, 5 steps (counted: ``train_attention_launches``), the loss
   falling.  Last, granite-3-2b's phase 9 training again with
   single-level remat, beside phase 9's two-level run.
14. slice 11 step d — the three flash-attention kernels at Sk ≠ Sq
   (bidirectional cross attention: ``CROSS_CHECKS``, seamless's (4, 16,
   16, Sq 1024, Sk 4096, 64) in bf16 and fp32, odd pairs 37/200 and
   333/129 at D = 64, 128, 160 in both dtypes, a 32:8 GQA case) under
   phases 8 and 9's gates (fp32 against the plain versions, bf16 by
   ``lib_gate`` anchored on SDPA, with the plain rounding model; two
   calls bitwise equal, counters moving), each with its bound and SDPA's
   time, and the device time of the three at seamless's shape (the
   profiler, late in a long run, often shows none of the calls: then
   "not measured", and ``scripts/kernel_ab.py`` in a process of its own
   gives it); the training kernels also at the shapes the two models
   train (llava's (4, 32, 8, 3328, 128) causal, seamless's encoder (4,
   16, 16, 4096, 64) bidirectional and decoder (4, 16, 16, 1024, 64)
   causal) by ``lib_gate``; then llava-next-mistral-7b (32 layers, 7.26 B) and seamless-m4t-large-v2
   (24 encoder + 24 decoder layers, 2.04 B) at full width, random bf16
   weights, each serving 4 requests through ``serve_loop.generate`` (the
   main path, counted: one ``flash_attention`` launch an attention block,
   32 and 72), llava's of 2304 image tokens + 1024 text, seamless's of
   1024 text over 4096 frames, + 32 generated: TTFT, decode step,
   generated tokens/s, peak memory, attention's share of a prefill, the
   kernel route against the plain route at 2 layers (phase 8's gate);
   each one's decode at a 4-layer fp32 cut against a full forward (8
   greedy steps, each within 1e-4 of max|logit|; ``generate``, which sizes
   the cache itself, gives the same tokens); seamless trained at full
   depth and llava cut to 12 of 32 layers, batch 4 × 1024 text tokens
   (llava's with random image embeddings, so that ``img_proj`` learns),
   remat, 5 steps (counted: ``train_attention_launches``, the encoder's
   stack and two attention blocks a decoder layer), the loss falling.
15. shard — the sharding tables of the ten full configs on the
   production meshes of ``repro_torch.launch.mesh`` from meta tensors,
   then four gloo ranks sharing the card on a (data 2, model 2) mesh:
   granite-3-2b's sharded training, serving and resume against the
   unsharded run, and CapsNet routing gradients under the {B} plan.
16. launch — the CLIs on their ranks through ``repro_torch.launch.ranks``:
   (a) ``train --mesh 1,1`` on one NCCL rank and (b) ``train --mesh 2,2``
   run alone, which starts four gloo ranks sharing the card, granite-3-2b
   at full width cut to 2 layers, 8 × 1024, 3 steps, each loss of (b)
   within 1e-3 relative of (a)'s and (a)'s launches a step exact; then two
   gloo ranks: (c) ``serve`` of granite-3-2b cut to 4 layers, 6 requests
   of 1024 + 16 in groups of 4, every rank holding every request, first
   tokens equal to the 1-rank run's where the top-2 margin exceeds twice
   the first-step logits' max|Δ| between the two groupings, and (d)
   ``serve_caps --pipeline two_stage`` (and ``--plan auto``), Caps-MN1,
   300 requests in waves of 2 × 100: books balanced with 0 failed, every
   wave on both ranks, each wave's scores within 1e-5 of the unpipelined
   arm on the same input, every prediction equal to ``--pipeline none``'s.
17. dryrun — (a) started in child processes right after phase 2, at nice
   19 and with no card visible, beside phases 3-16 (``DryrunJobs``):
   ``python -m repro_torch.launch.dryrun --smoke --all --multi-pod both``
   (every cell ok or skip), the production cells granite-3-2b train_4k
   and mistral-large-123b decode_32k on (16, 16) and zamba2-7b long_500k
   on (2, 16, 16), and ``routing_dryrun`` for Caps-MN1; the phase reads
   their records and prints the peak a device, the FLOPs a device and
   their ratio to the model's 6·N_active·tokens / n (2· to serve), and the
   collective bytes by kind.  (b) On one rank at full width, three cells
   dry-run on fake CUDA tensors and run on the card (each run once before,
   so that lazy workspaces exist): granite-3-2b's training step at phase
   9's 8 × 1024 (40 layers), its prefill of phase 8's wave (8 × 1024, a
   cache of 1024 + 32) and Caps-MN1's training step at B = 100 (phase 5):
   each kernel's dry-run calls equal to its launches and the products'
   FLOPs outside the kernels equal to ``FlopCounterMode``'s over the same
   step (both exact); the predicted peak against ``max_memory_allocated``
   after ``reset_peak_memory_stats`` (less what was held before the step
   beside its arguments), within 10 % or reported as a miss with its
   numbers and the card's allocations live at the step's peak by source
   (the allocator's history).
18. wide — the three flash-attention kernels at head dims above 256,
   where they run unpadded on ``flash_attention_wide.cu`` (``WIDE_CHECKS``:
   the d_head 320 model's (4, 32, 8, 1024, 320) bf16; (4, 16, 4, 1024, D)
   causal at D = 288 and 512, cross attention Sq 256 over Sk 1024 at D =
   320, a 256 window at (1, 8, 2, 2048, 384), Sq 37 over Sk 200 and
   S = 1023 at D = 288, the same two at D = 300 and 257, whose rows
   are not 16-byte aligned, and above D = 512, where o and dq are cut
   into pieces, (2, 8, 2, 1024, 640) causal and cross attention (2, 8, 8,
   256 over 1024) at D = 1024; fp32 and bf16): two calls bitwise
   equal, every launch counted; fp32 o, lse, dq within 1e-5·max(1,
   max|plain|) of the plain versions and dk, dv too; bf16 by ``lib_gate``
   against float64, anchored on SDPA on expanded KV heads (the backend it
   chose printed) and its autograd backward, lse on the memory-efficient
   op where it takes the head dim (else within the fp32 gate of the plain
   version), with the one-ulp verdict against the plain versions printed
   and each bf16 output's max|Δ| from the plain rounding model
   (``round_operands=True`` at the kernels' 64 × 64 tiles: the
   tensor-core forward rounds p, the backward p and ds); event
   times beside the plain versions', the bound and the library's, and at
   the model's shape (both dtypes) the device times.  Then the main
   path: granite-3-2b at full width with ``d_head`` 320 cut to 4 layers
   (``WIDE_MODEL``), in bf16 (the tensor-core wide kernels) and in fp32
   (the CUDA-core ones): in each a prefill of 4 × 1024 and one training
   step of 4 × 1024, counted (4 ``flash_attention`` launches; the step's
   ``train_attention_launches``), the kernel route against the plain route
   (phase 8's logit and first-token gates, phase 9's gradient gate; in
   fp32 1e-4 of max|logit| and ``MOE_GRAD_REL_LIMIT``), each dry-run on
   fake CUDA tensors against the card (phase 17 (b)'s
   ``_hold_prediction``), the two arms' prefill and step times printed
   side by side.  Last, the six examples' twins
   (``examples/torch_*.py``) at their smoke sizes through their ``main``:
   the five single-process ones here, ``torch_distributed_routing`` on two
   gloo ranks sharing the card; each held to its docstring's claim (the
   routing kernel against its plain version, B/L/H shardings equal within
   the sharded gate, pipelined scores equal to unpipelined ones, the loss
   falls, resume is step-indexed).

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
non-zero before it; without a CUDA device the script exits non-zero at
once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12           # bf16 on the tensor cores, dense
# fp32 products in split TF32 (three TF32 products each at the 495
# TFLOP/s dense TF32 rate): the fp32 attention kernels up to D = 256
TF32_SPLIT_FLOP_PER_S = 495e12 / 3
# special-function units: 16 results a clock on each of 132 SMs at the
# 1.98 GHz boost clock (H100 SXM data sheet): the floor of an exp-bound walk
SFU_PER_S = 16 * 132 * 1.98e9
TOL = 1e-5
MARGIN = 1e-4
GRAD_TOL = {"fp32": 1e-4, "bf16": 2e-2}    # the reference's GRAD_ATOL
BF16_REL = 2.0 ** -7                       # one bf16 rounding
TRAIN_STEPS = 5
EPS_LADDER = (0.0, 8.0, 1e6)
LOAD = 0.3                 # mean arrivals per tick, as a share of a wave
EM_GATE = dict(rtol=1e-4, atol=1e-5)       # the reference's EM gate
FASTMATH_N = 2 ** 26
FASTMATH_SHAPES = ((8,), (100,), (16, 32), (3, 5, 7))
# the reference's accuracy bounds against the exact functions
FASTMATH_TOL = {"exp": 0.045, "inv_sqrt": 0.005, "reciprocal": 0.02}
KERNEL_SOURCE = {
    "routing_procedure_fused": "src/repro_torch/csrc/routing.cu",
    "routing_iteration_fused": "src/repro_torch/csrc/routing.cu",
    "routing_procedure_bwd": "src/repro_torch/csrc/routing_bwd.cu",
    "em_stage_stats": "src/repro_torch/csrc/em_routing.cu",
    "em_stage_estep": "src/repro_torch/csrc/em_routing.cu",
    "fastmath_2d": "src/repro_torch/csrc/fastmath.cu",
    "routing_stage_votes": "src/repro_torch/csrc/routing_stage.cu",
    "routing_stage_update": "src/repro_torch/csrc/routing_stage.cu",
    "routing_stage_update_fold": "src/repro_torch/csrc/routing_stage.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_fwd_lse": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "selective_scan": "src/repro_torch/csrc/ssm_scan.cu",
}
REPLACES = {
    "routing_procedure_fused": "src/repro/kernels/routing/kernel.py:303",
    "routing_iteration_fused": "src/repro/kernels/routing/kernel.py:139",
    "routing_procedure_bwd": "src/repro/kernels/routing/kernel.py:543",
    "em_stage_stats": "src/repro/kernels/routing/kernel.py:831",
    "em_stage_estep": "src/repro/kernels/routing/kernel.py:861",
    "fastmath_2d": "src/repro/kernels/fastmath/kernel.py:56",
    "routing_stage_votes": "src/repro/kernels/routing/kernel.py:685",
    "routing_stage_update": "src/repro/kernels/routing/kernel.py:706",
    "routing_stage_update_fold": "src/repro/kernels/routing/kernel.py:734",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:75",
    "flash_attention_fwd_lse":
        "src/repro/kernels/flash_attention/kernel.py:264",
    "flash_attention_bwd": "src/repro/kernels/flash_attention/kernel.py:303",
    "selective_scan": "src/repro/kernels/ssm_scan/kernel.py:49",
}
ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def host_ms(fn, runs: int = 10) -> float:
    """Median milliseconds of ``fn()`` on the host clock, synchronised."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# the plain versions' timing: they repeat the kernels' arithmetic and are
# no yardstick of speed, so 5 calls, not 20 (a whole run spent minutes on
# them)
PLAIN_TIMING = dict(runs=5, warmup=1)


def timed_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` CUDA-event-timed calls
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_op(e) -> bool:
    """Whether a profiler event is work on the card: a kernel, fill or
    copy, not the device-side range of a ``record_function`` span (a user
    annotation), which covers the kernels launched inside it."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


# a host pause between profiled calls, and the device-timeline gap that
# tells two calls apart (a call's own launches follow each other closely)
CALL_PAUSE_S = 0.002
CALL_GAP_US = 1000.0


def device_ms(fn, runs: int = 20, warmup: int = 3, parts: dict = None,
              bound_ms: float = None) -> dict:
    """The device time of one call of ``fn``, host work excluded: the time
    the card is busy with the CUDA kernels (and fills and copies) the call
    runs, by ``torch.profiler`` — the union of their intervals, so that
    kernels that overlap (a programmatic dependent launch and its primary)
    count once — median over ``runs`` calls after
    ``warmup``.  The calls are told apart by a host pause between them;
    the tracer can miss the first launches of a session, so one more call
    runs first and only the calls that show the most common number of
    device operations count (at least half of ``runs``).  ``parts`` maps a
    part's name to substrings of kernel names; each part then gets its own
    median of summed kernel durations ("other" takes the rest).

    Each profiled call is timed by CUDA events as well (``event_ms``, their
    median).  The device time is reported only where it lies between
    0.95 · ``bound_ms`` (the least time the card could take, where the
    caller gives it) and the event time: a sum of kernel durations below
    the card's bound or above the call's own span misread the trace.
    Otherwise, and where the profiler shows too few calls, ``"ms"`` is
    None and ``"rejected"`` says why (printed too)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spans = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end))
            time.sleep(CALL_PAUSE_S)
    event_ms = statistics.median(spans[1:])
    evs = sorted((e for e in prof.events() if device_op(e)),
                 key=lambda e: e.time_range.start)
    calls, last_end = [], None
    for e in evs:
        if last_end is None or e.time_range.start - last_end > CALL_GAP_US:
            calls.append([])
        calls[-1].append(e)
        last_end = max(last_end or 0.0, e.time_range.end)
    sizes = [len(c) for c in calls]
    size = max(set(sizes), key=sizes.count) if sizes else 0
    calls = [c for c in calls if len(c) == size][-runs:]
    if len(calls) < runs // 2:
        reason = (f"the profiler showed {len(calls)} of {runs} calls")
        print(f"[device_ms] no device time: {reason}")
        return {"ms": None, "calls_seen": len(calls), "event_ms": event_ms,
                "rejected": reason}

    def part_of(name):
        for part, keys in (parts or {}).items():
            if any(k in name for k in keys):
                return part
        return "other"

    per = {k: [] for k in ["ms", *(parts or {}), "other"]}
    for call in calls:
        sums = {k: 0.0 for k in per}
        busy_end = None
        for e in call:   # sorted by start: the union of the intervals
            t0, t1 = e.time_range.start, e.time_range.end
            if busy_end is None or t0 >= busy_end:
                sums["ms"] += (t1 - t0) / 1e3
            elif t1 > busy_end:
                sums["ms"] += (t1 - busy_end) / 1e3
            busy_end = t1 if busy_end is None else max(busy_end, t1)
            sums[part_of(e.name)] += (t1 - t0) / 1e3
        for k in per:
            per[k].append(sums[k])
    out = {k: statistics.median(v) for k, v in per.items()}
    out.update(kernels_a_call=size, calls_seen=len(calls), event_ms=event_ms)
    reason = None
    if bound_ms is not None and out["ms"] < 0.95 * bound_ms:
        reason = (f"{out['ms']:.4f} ms is below 0.95 x the bound "
                  f"{bound_ms:.4f} ms")
    elif out["ms"] > event_ms:
        reason = (f"{out['ms']:.4f} ms exceeds the calls' event time "
                  f"{event_ms:.4f} ms")
    if reason:
        print(f"[device_ms] device time not reported: {reason}")
        out.update({k: None for k in per}, rejected=reason)
    return out


def dev_note(d: dict) -> str:
    if d["ms"] is None:
        return f"not measured: {d.get('rejected', 'no trace')}"
    return f"{d['ms']:.4f} ms"


def bound(bytes_moved: int, flops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type (fp32 by default)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_rate(dtype: torch.dtype, D: int) -> float:
    """The peak rate of the attention kernels' products at head dim D:
    bf16 on the tensor cores; fp32 up to D = 256 in split TF32 on the
    tensor cores; fp32 above (the wide route) on the CUDA cores."""
    if dtype == torch.bfloat16:
        return BF16_FLOP_PER_S
    return TF32_SPLIT_FLOP_PER_S if D <= 256 else FP32_FLOP_PER_S


def tile_launch(ops, B, L, H, C, l_tile, sd, stream_bytes, ms,
                approx=False, early_exit=False, reverse=False) -> dict:
    """What a routing call launched and the rate it streamed at: the tile
    kernel's blocks as the library launches them (its geometry from
    ``ops.tile_geometry``, the clusters from the card's occupancy) and the
    cluster size, and the stream bytes (û once per iteration, the
    reference's model) over the measured time, in TB/s.  ``reverse``: the
    backward's reverse sweep on the same geometry."""
    from repro_torch.kernels import cudalib
    geo = ops.tile_geometry(B, L, H, C, l_tile, sd)
    blocks = cudalib.build().routing_tile_blocks(
        {"fp32": 0, "bf16": 1, "int8": 2}[sd], B, L, H, C, l_tile, geo.rows,
        geo.batch_chunk, geo.cluster, int(geo.staged), geo.slots,
        int(approx), int(early_exit), int(reverse))
    check(blocks > 0, f"routing_tile_blocks failed: CUDA error {-blocks}")
    return {"blocks": blocks, "cluster": geo.cluster, "rows": geo.rows,
            "row_groups": geo.groups,
            "tb_per_s": stream_bytes / (ms * 1e-3) / 1e12}


def launch_note(t: dict) -> str:
    return (f"{t['tb_per_s']:.2f} TB/s, {t['blocks']} blocks in clusters of "
            f"{t['cluster']} over {t['row_groups']} groups of {t['rows']} "
            f"L-rows")


def captured(tag: str, fn, *args) -> tuple:
    """``fn(*args)`` with its standard output captured and printed line by
    line under ``tag``, and every kernel launch counter put back as it was
    (its launches are not a main path's).  Returns (the result, the output,
    wall seconds)."""
    import io
    from repro_torch.kernels.fastmath import kernel as fmk
    from repro_torch.kernels.routing import kernel as rk
    counters = (*lm_counters(), *rk.KERNEL_WRAPPERS, fmk.fastmath_2d)
    saved = [fn.launches for fn in counters]
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            result = fn(*args)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        for counter, n in zip(counters, saved):
            counter.launches = n
        for line in buf.getvalue().strip().splitlines():
            print(f"{tag}: {line}")
    return result, buf.getvalue(), wall


def run_cli(tag: str, args: list) -> tuple:
    """``python -m args[0] args[1:]`` in this process (``captured``): the
    module's ``main(args[1:])``.  A process of its own, as the CLI checks
    ran before, paid a fresh interpreter, torch and a CUDA context, 10-15 s
    a CLI.  Returns (the output, wall seconds); fails if ``main`` raises
    or exits non-zero."""
    import importlib
    main = importlib.import_module(args[0]).main

    def call():
        try:
            main(list(args[1:]))
        except SystemExit as e:
            return e.code
        return 0

    rc, stdout, wall = captured(tag, call)
    check(rc in (None, 0), f"python -m {' '.join(args)} exited {rc!r}")
    return stdout, wall


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"[device] {card}")
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, capability {cap[0]}.{cap[1]}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(cap[0] == 9, f"capability {cap} is not Hopper (9.x)")
    return {"card": card, "capability": cap}


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

# the bf16 flash-attention kernels that run on the tensor cores
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
              "flash_bwd_dkv_tc_kernel")
# the fp32 ones up to D = 256, on the tensor cores in split TF32
F32_TC_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dq_f32_kernel",
                  "flash_bwd_dkv_f32_kernel")
# every flash-attention kernel up to D = 256, fp32 and bf16, whose
# registers, spills and HMMA count phase 2 reports per head-dim
# instantiation
FLASH_KERNELS = TC_KERNELS + F32_TC_KERNELS
# the fp32 kernels of head dims above 256, on the CUDA cores, one
# instantiation a count of column groups (kernel.WIDE_F32_GROUPS)
WIDE_F32_KERNELS = ("wide_fwd_f32_kernel", "wide_dq_f32_kernel",
                    "wide_dkv_f32_kernel")
# the bf16 wide kernels on the tensor cores: the forward, one
# instantiation a pair count (kernel.WIDE_TC_PAIRS), and the backward's
# two, one a pair count and number of bf16 terms of ds (1, 2)
WIDE_BWD_TC_KERNELS = ("wide_dq_tc_kernel", "wide_dkv_tc_kernel")
WIDE_TC_KERNELS = ("wide_fwd_tc_kernel",) + WIDE_BWD_TC_KERNELS
WIDE_DS_TERMS = (1, 2)


def wide_tc_variants(name: str) -> list:
    """The instantiations of a wide kernel, as its template arguments
    print: "p" for the bf16 forward, "p,terms" for the bf16 backward's
    two, "groups" for the fp32 three."""
    from repro_torch.kernels.flash_attention.kernel import (
        WIDE_F32_GROUPS, WIDE_TC_PAIRS)
    if name in WIDE_F32_KERNELS:
        return [str(g) for g in WIDE_F32_GROUPS]
    if name in WIDE_BWD_TC_KERNELS:
        return [f"{p},{t}" for p in WIDE_TC_PAIRS for t in WIDE_DS_TERMS]
    return [str(p) for p in WIDE_TC_PAIRS]


def template_ints(name: str, mangled: str) -> str:
    """The int template arguments of kernel ``name`` in a mangled symbol,
    comma-joined: the head dim of a flash kernel, the pair count (and the
    terms of ds) of a wide tensor-core kernel."""
    n = 2 if name in WIDE_BWD_TC_KERNELS else 1
    ints = re.findall(r"Li(\d+)E", mangled.split(name, 1)[1])
    return ",".join(ints[:n])


def tensor_core_counts(cudalib) -> dict:
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in the SASS of each
    tensor-core kernel (bf16, and the fp32 split-TF32 ones), per head-dim
    instantiation, from ``cuobjdump -sass`` of the built library; fails if
    an instantiation has none."""
    tool = os.path.join(os.path.dirname(cudalib._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cudalib.build_info.path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    names = FLASH_KERNELS + WIDE_TC_KERNELS
    counts = {name: {} for name in names}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        fn = chunk.split("\n", 1)[0]
        for name in names:
            if re.search(rf"\d{name}I", fn):
                d = template_ints(name, fn)
                if name not in WIDE_TC_KERNELS:
                    d = int(d)
                counts[name][d] = {
                    "HMMA": len(re.findall(r"\bHMMA\b", chunk)),
                    "HGMMA": len(re.findall(r"\bHGMMA\b", chunk))}
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    for name, by_d in counts.items():
        want = wide_tc_variants(name) if name in WIDE_TC_KERNELS \
            else HEAD_DIMS
        check(sorted(by_d) == sorted(want) and
              all(c["HMMA"] + c["HGMMA"] > 0 for c in by_d.values()),
              f"{name}: no tensor-core instruction in {by_d}")
        hmma = sum(c["HMMA"] for c in by_d.values())
        hgmma = sum(c["HGMMA"] for c in by_d.values())
        key = ("pairs,terms" if name in WIDE_BWD_TC_KERNELS else "pairs"
               if name in WIDE_TC_KERNELS else "D")
        per_d = ", ".join(f"{key}={d}: {by_d[d]['HMMA'] + by_d[d]['HGMMA']}"
                          for d in sorted(by_d))
        print(f"[build] tensor cores: {name} HMMA {hmma}, HGMMA {hgmma} "
              f"({per_d}; cuobjdump -sass)")
    return counts


def phase_build(cudalib) -> dict:
    cudalib.build()
    info = cudalib.build_info
    print(f"[build] {info.path}: {'compiled' if info.compiled else 'cached'}"
          f" in {info.seconds:.2f} s")
    regs = [line.strip() for line in info.log.splitlines()
            if "registers" in line or "spill" in line]
    for line in sorted(set(regs)):
        print(f"[build] ptxas: {line}")
    # each flash-attention kernel's registers and spills, by instantiation:
    # the head dim, for the wide fp32 kernels their column groups, for the
    # bf16 wide kernels their pair count (and the backward's terms of ds)
    fn, spill, flash_regs = None, "", {}
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            fn = next((name for name in FLASH_KERNELS + WIDE_F32_KERNELS
                       + WIDE_TC_KERNELS
                       if re.search(rf"\d{name}I", line)), None)
            if fn:
                fn += f"<{template_ints(fn, line)}>"
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "registers" in line:
            used = int(re.search(r"Used (\d+) registers", line).group(1))
            found = re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", spill)
            check(found is not None, f"ptxas gave no spill line for {fn}")
            stores, loads = (int(x) for x in found.groups())
            flash_regs[fn] = {"registers": used, "spill_stores": stores,
                              "spill_loads": loads}
            print(f"[build] ptxas: {fn}: {used} registers; {spill}")
            fn = None
    wide = sorted(k for k in flash_regs
                  if k.startswith(WIDE_F32_KERNELS + WIDE_TC_KERNELS))
    check(wide == sorted(
        f"{name}<{v}>" for name in WIDE_F32_KERNELS + WIDE_TC_KERNELS
        for v in wide_tc_variants(name)),
          f"ptxas reported {wide} of the wide kernels")
    # the SASS count runs beside the later phases (cuobjdump of the whole
    # library takes tens of seconds); main() joins it before the summary
    counted = {}
    thread = threading.Thread(
        target=lambda: counted.update(tensor_core_counts(cudalib)),
        daemon=True)
    thread.start()
    return {"seconds": info.seconds, "compiled": info.compiled,
            "flash_registers": flash_regs, "tensor_cores": counted,
            "tensor_core_thread": thread}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def votes_for(cfg, batch: int, seed: int = 0) -> torch.Tensor:
    """The votes the serving path hands the router: the CapsNet encoder at
    random weights on synthetic images, for ``batch`` lanes."""
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.models import capsnet
    net = capsnet.CapsNet(cfg, device="cuda", seed=seed)
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    images = torch.from_numpy(ds.batch(seed, batch)["images"]).cuda()
    with torch.inference_mode():
        u_hat = capsnet.encode_votes(net, images)
    return u_hat.clone().contiguous()


def check_procedure(kernel, ops, name, u, iters, results) -> None:
    B, L, H, C = u.shape
    variants = [("fp32", False, None), ("fp32-approx", True, None),
                ("bf16", False, None), ("int8", False, None)]
    variants += [(f"early-exit eps={e:g}", False, e) for e in EPS_LADDER]
    for label, use_approx, eps in variants:
        sd = "int8" if label == "int8" else \
            "bf16" if label == "bf16" else "fp32"
        l_tile = ops.procedure_l_tile(B, L, H, C, sd,
                                      early_exit=eps is not None)
        n = L // l_tile
        if sd == "int8":
            args = ops.quantize_u_stream(u, l_tile)
        else:
            args = (u.to(ops.STREAM_DTYPES[sd]).contiguous(), None)
        kw = dict(iterations=iters, l_tile=l_tile, use_approx=use_approx,
                  early_exit_eps=eps)
        before = kernel.routing_procedure_fused.launches
        out_k = kernel.routing_procedure_fused(*args, **kw)
        out_k2 = kernel.routing_procedure_fused(*args, **kw)
        out_p = kernel.routing_procedure_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        check(kernel.routing_procedure_fused.launches == before + 2,
              "launch counter did not move")
        eff = iters * n
        if eps is not None:
            (vk, ck), (vk2, ck2), (vp, cp) = out_k, out_k2, out_p
            ck, ck2, cp = int(ck), int(ck2), int(cp)
            check(ck == cp, f"{name} {label}: work counter kernel {ck} != "
                            f"plain {cp}")
            check(ck2 == ck, f"{name} {label}: two calls count {ck}, {ck2}")
            if eps == 0.0:
                check(ck == iters * n, f"{name} eps=0: counter {ck} != "
                                       f"{iters}·{n}")
            eff = ck
        else:
            vk, vk2, vp = out_k, out_k2, out_p
        check(torch.equal(vk, vk2), f"{name} {label}: two calls differ")
        err = float((vk - vp).abs().max())
        check(bool(torch.isfinite(vk).all()), f"{name} {label}: non-finite")
        check(err <= TOL, f"{name} {label}: max|Δ| {err:.3g} > {TOL}")
        item = torch.empty((), dtype=ops.STREAM_DTYPES[sd]).element_size()
        elems = B * L * H * C
        bytes_once = elems * item + B * H * C * 4 + (n * 4 if sd == "int8"
                                                     else 0)
        # Eq.2 (2 FLOP/element) runs every iteration; Eq.4 (2 more) only in
        # the tile-iterations that did work
        flops = 2 * elems * iters + 2 * elems * iters * eff / (iters * n)
        b_ms, b_by = bound(bytes_once, flops)
        ms = timed_ms(lambda: kernel.routing_procedure_fused(*args, **kw))
        dev = device_ms(lambda: kernel.routing_procedure_fused(*args, **kw),
                        bound_ms=b_ms)
        plain_ms = timed_ms(
            lambda: kernel.routing_procedure_fused_plain(*args, **kw),
            **PLAIN_TIMING)
        stream = ops.dma_bytes_per_call(
            B, L, H, C, iters, form="procedure", stream_dtype=sd,
            early_exit_work_fraction=(eff / (iters * n)
                                      if eps is not None else None))
        stream_ms = stream["total_bytes"] / HBM_BYTES_PER_S * 1e3
        launch = tile_launch(ops, B, L, H, C, l_tile, sd,
                             stream["total_bytes"], ms, use_approx,
                             eps is not None)
        row = {"kernel": "routing_procedure_fused", "shape": name,
               "B": B, "L": L, "H": H, "C": C, "l_tile": l_tile,
               "n_tiles": n, "variant": label, "max_abs_err": err,
               "tol": TOL, "work": eff, "fixed_grid_work": iters * n,
               "deterministic": True, "ms": ms, "device_ms": dev["ms"],
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "stream_bound_ms": stream_ms, **launch}
        results.append(row)
        print(f"[kernels] {name:<22} procedure {label:<20} l_tile={l_tile:<4}"
              f" max|Δ|={err:.2e} (tol {TOL:g}) work={eff}/{iters * n}, "
              f"two calls bitwise equal; kernel {ms:.3f} ms (device "
              f"{dev_note(dev)})  plain "
              f"{plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  stream "
              f"bound {stream_ms:.4f} ms; {launch_note(launch)}")


def check_iteration(kernel, ops, name, u, results) -> None:
    from repro_torch.kernels.routing import ref
    B, L, H, C = u.shape
    for sd in ("fp32", "bf16"):
        us = u.to(ops.STREAM_DTYPES[sd]).contiguous()
        l_tile = ops.auto_l_tile(B, L, H, C, sd)
        # the state entering iteration 1: b and v after iteration 0
        b0 = torch.zeros((L, H), device="cuda")
        v0 = torch.zeros((B, H, C), device="cuda")
        s1, b1 = kernel.routing_iteration_fused_plain(us, b0, v0,
                                                      l_tile=l_tile)
        v1 = ref.squash(s1).contiguous()
        before = kernel.routing_iteration_fused.launches
        sk, bk = kernel.routing_iteration_fused(us, b1, v1, l_tile=l_tile)
        sk2, bk2 = kernel.routing_iteration_fused(us, b1, v1, l_tile=l_tile)
        sp, bp = kernel.routing_iteration_fused_plain(us, b1, v1,
                                                      l_tile=l_tile)
        torch.cuda.synchronize()
        check(kernel.routing_iteration_fused.launches == before + 2,
              "launch counter did not move")
        check(torch.equal(sk, sk2) and torch.equal(bk, bk2),
              f"{name} iteration {sd}: two calls differ")
        err_s = float((sk - sp).abs().max()) / max(1.0,
                                                   float(sp.abs().max()))
        err_b = float((bk - bp).abs().max()) / max(1.0,
                                                   float(bp.abs().max()))
        err = max(err_s, err_b)
        check(err <= TOL, f"{name} iteration {sd}: scaled max|Δ| "
                          f"{err:.3g} > {TOL}")
        elems = B * L * H * C
        bytes_once = (elems * us.element_size() + 2 * L * H * 4
                      + 2 * B * H * C * 4)
        b_ms, b_by = bound(bytes_once, 4 * elems)
        ms = timed_ms(lambda: kernel.routing_iteration_fused(
            us, b1, v1, l_tile=l_tile))
        dev = device_ms(lambda: kernel.routing_iteration_fused(
            us, b1, v1, l_tile=l_tile), bound_ms=b_ms)
        plain_ms = timed_ms(lambda: kernel.routing_iteration_fused_plain(
            us, b1, v1, l_tile=l_tile), **PLAIN_TIMING)
        stream = ops.dma_bytes_per_call(B, L, H, C, 1, form="iteration",
                                        stream_dtype=sd)
        stream_ms = stream["total_bytes"] / HBM_BYTES_PER_S * 1e3
        launch = tile_launch(ops, B, L, H, C, l_tile, sd,
                             stream["total_bytes"], ms)
        results.append({"kernel": "routing_iteration_fused", "shape": name,
                        "B": B, "L": L, "H": H, "C": C, "l_tile": l_tile,
                        "n_tiles": L // l_tile, "variant": sd,
                        "max_abs_err": err, "tol": TOL,
                        "deterministic": True, "ms": ms,
                        "device_ms": dev["ms"],
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "stream_bound_ms": stream_ms,
                        **launch})
        print(f"[kernels] {name:<22} iteration {sd:<20} l_tile={l_tile:<4}"
              f" scaled max|Δ|={err:.2e} (tol {TOL:g}), two calls bitwise "
              f"equal; kernel {ms:.3f} ms (device {dev_note(dev)})  plain "
              f"{plain_ms:.3f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})  stream bound {stream_ms:.4f} ms; "
              f"{launch_note(launch)}")


def odd_votes(shape=(20, 90, 7, 5), seed: int = 6) -> torch.Tensor:
    """Seeded votes whose capsule width C is not a multiple of 4 and whose
    rows of L-rows are not 16-byte multiples: the tile kernel's one-column
    path and its 4-byte and element copies."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda") * 0.05


def phase_kernels(kernel, ops, CAPS) -> list:
    # the three Table-1 widths at the serving microbatch, the CLI's default
    # microbatch of 8, Caps-EN3 at 128 (in fp32 one L-row of B/8 batch rows
    # does not fit a block's shared memory: the unstaged path), and odd
    # capsule widths (C not a multiple of 4, rows not 16-byte multiples)
    shapes = [(name, lambda cfg=CAPS[cfg_name], b=batch: votes_for(cfg, b),
               CAPS[cfg_name].routing_iters)
              for name, cfg_name, batch in (
                  ("Caps-MN1", "Caps-MN1", 100),
                  ("Caps-EN3", "Caps-EN3", 100),
                  ("Caps-CF3", "Caps-CF3", 100),
                  ("Caps-MN1 microbatch 8", "Caps-MN1", 8),
                  ("Caps-EN3 microbatch 128", "Caps-EN3", 128))]
    shapes.append(("odd capsules H=7 C=5", odd_votes, 3))
    results = []
    before = kernel.launch_counts()
    for name, make_votes, iters in shapes:
        u = make_votes()
        print(f"[kernels] {name}: votes {tuple(u.shape)}, "
              f"max|û| {float(u.abs().max()):.3f}")
        check_procedure(kernel, ops, name, u, iters, results)
        check_iteration(kernel, ops, name, u, results)
        del u
        torch.cuda.empty_cache()
    after = kernel.launch_counts()
    print("[kernels] launch counter deltas: " + ", ".join(
        f"{k} +{after[k] - before[k]}" for k in after))
    print("[kernels] library_ms: none — no single PyTorch call computes "
          "dynamic routing")
    return results


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def top2_margin(scores):
    top2 = scores.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def phase_agreement(net, cfg, spec_cuda, ds, caps_serve) -> dict:
    """Both adapters' wave functions on the same packed waves."""
    from repro_torch.core.router import RouterSpec
    cuda_ad = caps_serve.CapsAdapter(net, spec_cuda)
    torch_ad = caps_serve.CapsAdapter(
        net, RouterSpec(backend="torch", iterations=net.cfg.routing_iters))
    wave_c = cuda_ad.make_wave_fn(cfg)
    wave_t = torch_ad.make_wave_fn(cfg)
    worst, near, lanes = 0.0, 0, 0
    for index, count in ((0, cfg.wave_lanes), (1, 137)):
        images = ds.batch(10_000 + index, count)["images"]
        packed = cuda_ad.pack(list(images), cfg)
        sc = wave_c(packed).reshape(-1, net.cfg.num_h_caps)[:count]
        st = wave_t(packed).reshape(-1, net.cfg.num_h_caps)[:count]
        torch.cuda.synchronize()
        worst = max(worst, float((sc - st).abs().max()))
        margin = top2_margin(st)
        clear = margin > MARGIN
        near += int((~clear).sum())
        lanes += count
        same = sc.argmax(-1) == st.argmax(-1)
        check(bool(same[clear].all()),
              "cuda and torch servers disagree on a prediction outside "
              "the near-tie margin")
    print(f"[serve] agreement cuda vs torch backend: max|Δ score| "
          f"{worst:.2e} (tol {TOL:g}); predictions equal on all "
          f"{lanes - near}/{lanes} lanes with top-2 margin > {MARGIN:g} "
          f"({near} near-tie lanes)")
    check(worst <= TOL, f"wave scores differ by {worst:.3g} > {TOL}")
    return {"max_abs_score_diff": worst, "near_tie_lanes": near,
            "lanes": lanes}


def wave_breakdown(net, spec, cfg, ds, caps_serve) -> dict:
    """Where one full wave's time goes: host packing (with the copy to the
    card), the encoder and the routing stage of one microbatch (CUDA
    events), the whole wave function, and unpacking (with the copy back)."""
    from repro_torch.core.router import build_router
    from repro_torch.models import capsnet
    adapter = caps_serve.CapsAdapter(net, spec)
    wave = adapter.make_wave_fn(cfg)
    router = build_router(spec, device=net.device)
    images = list(ds.batch(20_000, cfg.wave_lanes)["images"])
    em = spec.algorithm == "em"

    packed = adapter.pack(images, cfg)
    micro = {k: v[0] for k, v in packed.items()}

    def encode():
        return capsnet.encode_votes(net, micro["images"]) * \
            micro["mask"][:, None, None, None]

    with torch.inference_mode():
        votes = encode()
        # the stage hand-off: EM's (votes, a_in = the mask over L)
        hand_off = ((votes, micro["mask"][:, None].expand(votes.shape[:2]))
                    if em else (votes,))
        out = {"pack_ms": host_ms(lambda: adapter.pack(images, cfg)),
               "encode_ms": timed_ms(encode, runs=10),
               "route_ms": timed_ms(lambda: router(*hand_off), runs=10),
               "wave_ms": timed_ms(lambda: wave(packed), runs=10)}
        result = wave(packed)
        out["unpack_ms"] = host_ms(
            lambda: adapter.unpack(result, cfg.wave_lanes))
    print(f"[serve] one {spec.algorithm} wave of {cfg.n_micro} x "
          f"{cfg.microbatch} lanes: "
          f"wave function {out['wave_ms']:.3f} ms = per microbatch encoder "
          f"{out['encode_ms']:.3f} ms + routing {out['route_ms']:.3f} ms "
          f"(x {cfg.n_micro}, plus stacking); host pack + copy in "
          f"{out['pack_ms']:.3f} ms, copy out + unpack "
          f"{out['unpack_ms']:.3f} ms")
    return out


def serve_once(net, spec, cfg, ds, mode, requests, caps_serve, serve_cli,
               kernel, card) -> dict:
    server = caps_serve.CapsServer(net, spec=spec, cfg=cfg)
    schedule = serve_cli.arrival_schedule(requests,
                                          max(1.0, LOAD * cfg.wave_lanes))
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    if mode == "async":
        serve_cli.run_async(server, ds, schedule, 2)
    else:
        serve_cli.run_sync(server, ds, schedule)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel.launch_counts()
    s = serve_cli.check_books(server, requests)
    check(s["submitted"] == s["completed"] == requests,
          f"{mode}: submitted {s['submitted']}, completed "
          f"{s['completed']}, requests {requests}")
    for key in ("wave_errors", "failed", "guard_trips", "shed"):
        check(s[key] == 0, f"{mode}: {key} = {s[key]} ({s['last_error']})")
    print(f"[serve] {mode:<5} {spec.algorithm} fusion={spec.fusion}: "
          f"{s['completed']} "
          f"requests in {s['waves']} waves ({len(schedule)} ragged ticks, "
          f"{s['padded_lanes']} padded lanes), wave_errors "
          f"{s['wave_errors']}, failed {s['failed']}, guard_trips "
          f"{s['guard_trips']}, shed {s['shed']}; throughput "
          f"{s['throughput_rps']:.1f} req/s, p50 "
          f"{s['p50_latency_s'] * 1e3:.2f} ms, p90 "
          f"{s['p90_latency_s'] * 1e3:.2f} ms, wall {wall:.2f} s on "
          f"{card}; launches {counts}")
    return {"mode": mode, "fusion": spec.fusion, "requests": requests,
            "waves": s["waves"], "throughput_rps": s["throughput_rps"],
            "p50_latency_s": s["p50_latency_s"],
            "p90_latency_s": s["p90_latency_s"], "wall_s": wall,
            "launches": counts}


def phase_serve(kernel, CAPS, card: str) -> dict:
    from repro_torch.core.router import RouterSpec
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.launch import serve_caps as serve_cli
    from repro_torch.models.capsnet import CapsNet
    from repro_torch.runtime import caps_serve
    caps_cfg = CAPS["Caps-MN1"]
    net = CapsNet(caps_cfg, device="cuda", seed=0)
    print(f"[serve] {caps_cfg.name} at full width: conv "
          f"{caps_cfg.conv_channels} channels, L={caps_cfg.num_l_caps}, "
          f"H={caps_cfg.num_h_caps}, C_L={caps_cfg.l_caps_dim}, "
          f"C_H={caps_cfg.h_caps_dim}, {caps_cfg.routing_iters} iterations, "
          f"random weights (seed 0)")
    cfg = caps_serve.ServeConfig(microbatch=100, n_micro=2,
                                 pipeline="software")
    spec = RouterSpec(backend="cuda", iterations=caps_cfg.routing_iters)
    ds = SyntheticCapsDataset(caps_cfg.image_hw, caps_cfg.image_channels,
                              caps_cfg.num_h_caps)
    out = {"agreement": phase_agreement(net, cfg, spec, ds, caps_serve),
           "breakdown": wave_breakdown(net, spec, cfg, ds, caps_serve)}
    runs = [serve_once(net, spec, cfg, ds, mode, 600, caps_serve,
                       serve_cli, kernel, card) for mode in ("sync", "async")]
    main = sum(r["launches"]["routing_procedure_fused"] for r in runs)
    check(main > 0, "the main path launched routing_procedure_fused "
                    "no time")
    waves = sum(r["waves"] for r in runs)
    fallback = serve_once(net, spec._replace(fusion="iteration"), cfg, ds,
                          "sync", 150, caps_serve, serve_cli, kernel, card)
    check(fallback["launches"]["routing_iteration_fused"] > 0,
          "the fusion='iteration' path launched routing_iteration_fused "
          "no time")
    out.update(runs=runs + [fallback], main_waves=waves,
               main_launches={"routing_procedure_fused": main},
               fallback_launches=fallback["launches"])
    print(f"[serve] main path: routing_procedure_fused launched {main} times"
          f" in {waves} waves ({main / waves:.1f} per wave: one per "
          f"microbatch); fallback path: routing_iteration_fused launched "
          f"{fallback['launches']['routing_iteration_fused']} times in "
          f"{fallback['waves']} waves")
    return out


# ---------------------------------------------------------------------------
# phase 5: train
# ---------------------------------------------------------------------------

def backward_f64(u: torch.Tensor, g: torch.Tensor, iters: int) -> torch.Tensor:
    """∂û in float64 by autograd of the textbook routing loop (exact
    softmax and squash): an independent reference that shows how much
    round-off a shape's arithmetic amplifies."""
    u64 = u.double().requires_grad_()
    B, L, H, C = u.shape
    b = torch.zeros((L, H), dtype=torch.float64, device=u.device)
    v = torch.zeros((B, H, C), dtype=torch.float64, device=u.device)
    for _ in range(iters):
        b = b + torch.einsum("blhc,bhc->lh", u64, v)
        c = torch.softmax(b, dim=-1)
        s = torch.einsum("blhc,lh->bhc", u64, c)
        n2 = torch.sum(s * s, dim=-1, keepdim=True)
        v = s * (n2 / (1.0 + n2)) / torch.sqrt(n2 + 1e-9)
    (du,) = torch.autograd.grad(v, u64, g.double())
    return du


def check_forward_at_train_tile(kernel, ops, name, us, sd, kw,
                                results) -> None:
    """The forward kernel at the training tile (the train Function's
    forward) against its plain version, tolerance 1e-5 on v as in phase
    3, two calls bitwise equal; timed beside its plain version."""
    B, L, H, C = us.shape
    with torch.no_grad():
        vk = kernel.routing_procedure_fused(us, **kw)
        vk2 = kernel.routing_procedure_fused(us, **kw)
        vp = kernel.routing_procedure_fused_plain(us, **kw)
    torch.cuda.synchronize()
    check(torch.equal(vk, vk2), f"{name} forward at the train tile ({sd}): "
                                "two calls differ")
    err = float((vk - vp).abs().max())
    check(err <= TOL, f"{name} forward at the train tile ({sd}): max|Δ| "
                      f"{err:.3g} > {TOL}")
    elems = B * L * H * C
    b_ms, b_by = bound(elems * us.element_size() + B * H * C * 4,
                       4 * elems * kw["iterations"])
    ms = timed_ms(lambda: kernel.routing_procedure_fused(us, **kw))
    dev = device_ms(lambda: kernel.routing_procedure_fused(us, **kw),
                    bound_ms=b_ms)
    plain_ms = timed_ms(lambda: kernel.routing_procedure_fused_plain(
        us, **kw), **PLAIN_TIMING)
    stream = ops.dma_bytes_per_call(B, L, H, C, kw["iterations"],
                                    form="procedure", stream_dtype=sd)
    stream_ms = stream["total_bytes"] / HBM_BYTES_PER_S * 1e3
    launch = tile_launch(ops, B, L, H, C, kw["l_tile"], sd,
                         stream["total_bytes"], ms)
    results.append({"kernel": "routing_procedure_fused", "shape": name,
                    "B": B, "L": L, "H": H, "C": C,
                    "iterations": kw["iterations"], "l_tile": kw["l_tile"],
                    "n_tiles": L // kw["l_tile"], "variant": f"{sd} train",
                    "max_abs_err": err, "tol": TOL, "deterministic": True,
                    "ms": ms, "device_ms": dev["ms"], "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "stream_bound_ms": stream_ms, **launch})
    print(f"[train] {name:<22} forward  {sd:<5} T={kw['iterations']} "
          f"l_tile={kw['l_tile']:<3} max|Δ|={err:.2e} (tol {TOL:g}), two "
          f"calls bitwise equal; kernel {ms:.3f} ms (device {dev_note(dev)})"
          f"  plain {plain_ms:.3f} "
          f"ms  bound {b_ms:.4f} ms ({b_by})  stream bound {stream_ms:.4f} "
          f"ms; {launch_note(launch)}")


# the backward's device time by kernel: the replay's forward launches, the
# reverse sweep's, the ∂û pass
BWD_PARTS = {"replay": ("routing_tile_kernel", "routing_reduce_kernel"),
             "reverse": ("reverse_tile_kernel", "reverse_reduce_kernel"),
             "du": ("du_kernel",)}


def check_backward(kernel, ops, name, u, iters, results) -> None:
    """The backward kernel against its plain version at the training tile,
    fp32 and bf16, with a seeded random ∂v.  Tolerance: fp32 max|Δ| ≤
    max(1e-5 · max(1, max|plain|), 2·ε64); bf16 |Δ| ≤ 2^-7·|plain| +
    max(1e-6, 2·ε64) element-wise — one bf16 rounding — where ε64 is the
    plain version's own fp32 error against ``backward_f64`` on this shape
    (negligible at 3 iterations; at 9 the routing loop amplifies fp32
    round-off, and two fp32 summation orders cannot agree closer than
    their distance to exact arithmetic)."""
    B, L, H, C = u.shape
    gen = torch.Generator(device="cuda").manual_seed(B * L + H)
    g = torch.randn((B, H, C), generator=gen, device="cuda")
    eps64 = None
    for sd in ("fp32", "bf16"):
        us = u.to(ops.STREAM_DTYPES[sd]).contiguous()
        l_tile = ops.procedure_train_l_tile(B, L, H, C, iters, sd)
        kw = dict(iterations=iters, l_tile=l_tile)
        check_forward_at_train_tile(kernel, ops, name, us, sd, kw, results)
        before = kernel.routing_procedure_bwd.launches
        du_k = kernel.routing_procedure_bwd(us, g, **kw)
        du_k2 = kernel.routing_procedure_bwd(us, g, **kw)
        du_p = kernel.routing_procedure_bwd_plain(us, g, **kw)
        torch.cuda.synchronize()
        check(kernel.routing_procedure_bwd.launches == before + 2,
              "launch counter did not move")
        check(du_k.dtype == us.dtype, f"{name} {sd}: ∂û dtype {du_k.dtype}")
        check(bool(torch.isfinite(du_k).all()), f"{name} {sd}: non-finite")
        check(torch.equal(du_k, du_k2), f"{name} {sd}: two calls differ")
        dk, dp = du_k.float(), du_p.float()
        delta = (dk - dp).abs()
        err = float(delta.max())
        if sd == "fp32":
            d64 = backward_f64(u, g, iters)
            eps64 = float((dp.double() - d64).abs().max())
            err64 = float((dk.double() - d64).abs().max())
            del d64
            tol = max(TOL * max(1.0, float(dp.abs().max())), 2 * eps64)
            check(err <= tol, f"{name} backward fp32: max|Δ| {err:.3g} > "
                              f"{tol:.3g}")
            worst = err / tol
            f64_note = (f"; against float64: kernel {err64:.2e}, plain "
                        f"{eps64:.2e}")
        else:
            lim = BF16_REL * dp.abs() + max(1e-6, 2 * eps64)
            worst = float((delta / lim).max())
            check(worst <= 1.0, f"{name} backward bf16: {worst:.3g} of one "
                                f"bf16 rounding off the plain version")
            err64, f64_note = None, ""
        elems = B * L * H * C
        # û and ∂v read once, ∂û written once
        bytes_once = 2 * elems * us.element_size() + B * H * C * 4
        # replay 4T, reverse 4(T-1), the ∂û sum 2 + 4(T-1) FLOP per element
        flops = elems * (4 * iters + 4 * (iters - 1) + 2 + 4 * (iters - 1))
        b_ms, b_by = bound(bytes_once, flops)
        ms = timed_ms(lambda: kernel.routing_procedure_bwd(us, g, **kw))
        dev = device_ms(lambda: kernel.routing_procedure_bwd(us, g, **kw),
                        parts=BWD_PARTS, bound_ms=b_ms)
        plain_ms = timed_ms(
            lambda: kernel.routing_procedure_bwd_plain(us, g, **kw),
            **PLAIN_TIMING)
        stream = ops.dma_bytes_per_call(B, L, H, C, iters, form="procedure",
                                        stream_dtype=sd, backward=True)
        stream_ms = stream["total_bytes"] / HBM_BYTES_PER_S * 1e3
        launch = tile_launch(ops, B, L, H, C, l_tile, sd,
                             stream["total_bytes"], ms)
        rev = tile_launch(ops, B, L, H, C, l_tile, sd,
                          stream["total_bytes"], ms, reverse=True)
        results.append({"kernel": "routing_procedure_bwd", "shape": name,
                        "B": B, "L": L, "H": H, "C": C, "iterations": iters,
                        "l_tile": l_tile, "n_tiles": L // l_tile,
                        "variant": sd, "max_abs_err": err,
                        "share_of_tol": worst,
                        "max_abs_plain": float(dp.abs().max()),
                        "plain_err_f64": eps64, "kernel_err_f64": err64,
                        "deterministic": True, "ms": ms,
                        "device_ms": dev["ms"],
                        "device_split": {k: dev.get(k) for k in
                                         (*BWD_PARTS, "other")},
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "stream_bound_ms": stream_ms,
                        "reverse_blocks": rev["blocks"],
                        "reverse_cluster": rev["cluster"], **launch})
        split = ("" if dev["ms"] is None else
                 f" = replay {dev['replay']:.4f} + reverse "
                 f"{dev['reverse']:.4f} + ∂û {dev['du']:.4f} + other "
                 f"{dev['other']:.4f}")
        print(f"[train] {name:<22} backward {sd:<5} T={iters} "
              f"l_tile={l_tile:<3} max|Δ|={err:.2e} ({worst:.2f} of "
              f"tol{f64_note}), deterministic; kernel {ms:.3f} ms (device "
              f"{dev_note(dev)}{split})  plain "
              f"{plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  stream "
              f"bound {stream_ms:.4f} ms; replay {launch_note(launch)}; "
              f"reverse {rev['blocks']} blocks in clusters of "
              f"{rev['cluster']}")


def param_grads(net, router, images, labels) -> dict:
    from repro_torch.models import capsnet
    params = dict(net.named_parameters())
    loss, _ = capsnet.loss_fn(net, images, labels, router=router)
    return dict(zip(params, torch.autograd.grad(loss,
                                                list(params.values()))))


def tree_max_delta(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def step_breakdown(net, router, opt_cfg, images, labels, runs=5) -> dict:
    """One train step split with CUDA events, as the step computes it:
    encoder forward, routing forward (the procedure kernel through the
    router), the rest of the forward and the loss, the routing backward
    (between the gradient hooks on v and û), the rest of the backward, and
    clip + AdamW.  Medians of ``runs`` steps after one warm-up step; the
    weights move by each step, as in training."""
    from repro_torch import optim
    from repro_torch.models import capsnet
    from repro_torch.runtime.train_loop import apply_adamw_
    names = ("encoder_fwd", "routing_fwd", "rest_fwd_loss", "routing_bwd",
             "rest_bwd", "clip_adamw", "step")
    times = {k: [] for k in names}
    params = dict(net.named_parameters())
    opt = optim.adamw_init(params)
    for run in range(runs + 1):
        ev = {k: torch.cuda.Event(enable_timing=True) for k in
              ("start", "route_in", "route_out", "loss", "v_grad",
               "u_grad", "grads", "end")}

        def timed_router(u_hat):
            ev["route_in"].record()
            u_hat.register_hook(lambda g: ev["u_grad"].record())
            v = router(u_hat)
            ev["route_out"].record()
            v.register_hook(lambda g: ev["v_grad"].record())
            return v

        torch.cuda.synchronize()
        ev["start"].record()
        loss, _ = capsnet.loss_fn(net, images, labels, router=timed_router)
        ev["loss"].record()
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        ev["grads"].record()
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        lr_scale = optim.linear_warmup_cosine(opt.step + 1, 100, 10_000)
        opt = apply_adamw_(params, grads, opt, opt_cfg, lr_scale)
        ev["end"].record()
        torch.cuda.synchronize()
        if run == 0:
            continue

        def span(a, b):
            return ev[a].elapsed_time(ev[b])
        times["encoder_fwd"].append(span("start", "route_in"))
        times["routing_fwd"].append(span("route_in", "route_out"))
        times["rest_fwd_loss"].append(span("route_out", "loss"))
        times["routing_bwd"].append(span("v_grad", "u_grad"))
        times["rest_bwd"].append(span("loss", "v_grad")
                                 + span("u_grad", "grads"))
        times["clip_adamw"].append(span("grads", "end"))
        times["step"].append(span("start", "end"))
    return {k: statistics.median(v) for k, v in times.items()}


def train_cli(card: str) -> dict:
    """The training CLI on the card; its last checkpoint loads back through
    ``convert.load_jax_checkpoint`` with the parameters it saved."""
    import numpy as np
    from repro_torch import checkpoint, convert
    from repro_torch.configs.caps_benchmarks import smoke_caps
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    stdout, wall = run_cli("[train] cli", [
        "repro_torch.launch.train_capsnet", "--smoke", "--routing", "fused",
        "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", ckpt_dir])
    check("eval accuracy (fused routing)" in stdout,
          "train_capsnet printed no eval accuracy")
    step = checkpoint.latest_step(ckpt_dir)
    check(step == 6, f"latest checkpoint step {step}, expected 6")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    net = convert.load_jax_checkpoint(path, smoke_caps(), device="cuda")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    back = checkpoint.flatten(convert.capsnet_to_jax(net))
    check(set(back) == set(manifest), "checkpoint leaves differ from the "
                                      "net's parameters")
    for key, entry in manifest.items():
        saved = np.load(os.path.join(path, entry["file"]))
        check(np.array_equal(saved, back[key]),
              f"checkpoint leaf {key} does not load back equal")
    print(f"[train] cli: --smoke --routing fused --steps 6 --ckpt-every 3 "
          f"in {wall:.1f} s on {card}; checkpoint step {step} "
          f"({len(manifest)} leaves) loads back through "
          f"convert.load_jax_checkpoint with equal parameters")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"wall_s": wall, "checkpoint_step": step,
            "leaves": len(manifest)}


def phase_train(kernel, ops, CAPS, card: str) -> dict:
    from repro_torch.core.router import RouterSpec
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.models import capsnet
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_loop import make_capsnet_train_step
    rows = []
    for name, cfg, batch in (("Caps-MN1", CAPS["Caps-MN1"], 100),
                             ("Caps-EN3", CAPS["Caps-EN3"], 100),
                             ("Caps-CF3", CAPS["Caps-CF3"], 100),
                             ("Caps-SV3", CAPS["Caps-SV3"], 100),
                             ("Caps-MN1 microbatch 8", CAPS["Caps-MN1"], 8)):
        u = votes_for(cfg, batch)
        check_backward(kernel, ops, name, u, cfg.routing_iters, rows)
        del u
        torch.cuda.empty_cache()

    cfg = CAPS["Caps-MN1"]
    print(f"[train] {cfg.name} at full width, B={cfg.batch_size}: conv "
          f"{cfg.conv_channels} channels, L={cfg.num_l_caps}, "
          f"H={cfg.num_h_caps}, C_L={cfg.l_caps_dim}, C_H={cfg.h_caps_dim}, "
          f"{cfg.routing_iters} iterations, random weights (seed 0), "
          f"synthetic batch (seed 0)")
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    # the step's defaults (AdamW lr 3e-4, warmup 100): a first step at the
    # full rate, near lr·sign(g) on 8.2 M parameters, overshoots
    step = make_capsnet_train_step(cfg, plan="auto")
    exact = make_capsnet_train_step(cfg)
    bf16 = make_capsnet_train_step(
        cfg, spec=RouterSpec(backend="cuda", stream_dtype="bf16",
                             iterations=cfg.routing_iters))
    votes_shape = (cfg.batch_size, cfg.num_l_caps, cfg.num_h_caps,
                   cfg.h_caps_dim)
    resolved = step.router.resolve(torch.zeros(votes_shape, device="cuda"))
    check(resolved.fusion == "procedure" and resolved.differentiable,
          f"plan='auto' resolved to {resolved!r}")
    check(bf16.router.resolve(torch.zeros(votes_shape, device="cuda"))
          .differentiable, "the bf16 train router is not differentiable")
    batch = ds.batch(0, cfg.batch_size)
    images = torch.from_numpy(batch["images"]).cuda()
    labels = torch.from_numpy(batch["labels"]).cuda()

    net = capsnet.CapsNet(cfg, device="cuda", seed=0)
    g_exact = param_grads(net, exact.router, images, labels)
    g_kernel = param_grads(net, step.router, images, labels)
    g_bf16 = param_grads(net, bf16.router, images, labels)
    d_fp32 = tree_max_delta(g_kernel, g_exact)
    d_bf16 = tree_max_delta(g_bf16, g_exact)
    g_max = max(float(g.abs().max()) for g in g_exact.values())
    print(f"[train] step-1 parameter gradients over {len(g_exact)} leaves "
          f"(max|g| {g_max:.3e}): kernels vs exact torch routing max|Δ| "
          f"{d_fp32:.2e} (tol {GRAD_TOL['fp32']:g}); bf16 stream "
          f"{d_bf16:.2e} (tol {GRAD_TOL['bf16']:g})")
    check(d_fp32 <= GRAD_TOL["fp32"], f"fp32 grads differ by {d_fp32:.3g}")
    check(d_bf16 <= GRAD_TOL["bf16"], f"bf16 grads differ by {d_bf16:.3g}")
    del g_exact, g_kernel, g_bf16

    # step 1, then the loss on its own batch
    opt = adamw_init(dict(net.named_parameters()))
    net, opt, metrics = step(net, opt, images, labels)
    before = float(metrics["loss"])
    with torch.no_grad():
        after = float(capsnet.loss_fn(net, images, labels,
                                      router=step.router)[0])
    print(f"[train] step 1 of make_capsnet_train_step(cfg, plan='auto'): "
          f"loss on its batch {before:.6f} -> {after:.6f} after the step")
    check(after < before, f"loss did not decrease: {before} -> {after}")

    # the main training path: TRAIN_STEPS more steps, counted on their own
    losses = []
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        net, opt, metrics = step(net, opt, images, labels)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel.launch_counts()
    print(f"[train] {TRAIN_STEPS} more steps: losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; {wall:.3f} s on the "
          f"host clock; launches {counts}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"non-finite loss in {losses}")
    for name in ("routing_procedure_fused", "routing_procedure_bwd"):
        check(counts[name] == TRAIN_STEPS,
              f"{name} launched {counts[name]} times in {TRAIN_STEPS} steps;"
              f" expected one per step")
    check(counts["routing_iteration_fused"] == 0,
          "the train path launched the iteration kernel")

    bd = step_breakdown(net, step.router, step.opt_cfg, images, labels)
    print(f"[train] one step at B={cfg.batch_size}: {bd['step']:.3f} ms = "
          f"encoder fwd {bd['encoder_fwd']:.3f} + routing fwd "
          f"{bd['routing_fwd']:.3f} + rest of fwd and loss "
          f"{bd['rest_fwd_loss']:.3f} + routing bwd {bd['routing_bwd']:.3f}"
          f" + rest of bwd {bd['rest_bwd']:.3f} + clip and AdamW "
          f"{bd['clip_adamw']:.3f} (CUDA events, median of 5) on {card}")
    cli = train_cli(card)
    return {"backward": rows, "grad_delta_fp32": d_fp32,
            "grad_delta_bf16": d_bf16, "grad_max": g_max,
            "loss_step1": [before, after], "losses": losses,
            "steps_wall_s": wall, "main_launches": counts, "breakdown": bd,
            "cli": cli}


# ---------------------------------------------------------------------------
# phase 6: em and fast math
# ---------------------------------------------------------------------------

def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|Δ| over max(1, max|want|)."""
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def em_row(kernel_name, name, variant, dims, errs, ms, dev, plain_ms,
           bytes_once, flops) -> dict:
    B, L, H, C = dims
    b_ms, b_by = bound(bytes_once, flops)
    return {"kernel": kernel_name, "shape": name, "B": B, "L": L, "H": H,
            "C": C, "variant": variant, "max_abs_err": max(errs.values()),
            "scaled_errs": errs, "tol": TOL, "deterministic": True,
            "ms": ms, "device_ms": dev["ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_em_kernels(kernel, name, u, results) -> None:
    """Both EM kernels against their plain versions on votes ``u``: a_in
    the serving mask (a broadcast view, stride 0 along L) and a seeded
    sigmoid, r a softmax of seeded logits, μ, 1/σ² and the bias from one
    real M-step.  Tolerance max|Δ| ≤ 1e-5·max(1, max|plain|) on each
    output; two calls bitwise equal.  ``l_tile`` is the one the EM path
    passes (``ops.auto_l_tile``); it only selects the reference's error
    surface."""
    from repro_torch.kernels.routing import ops
    B, L, H, C = u.shape
    lt = dict(l_tile=ops.auto_l_tile(B, L, H, C, "fp32"))
    gen = torch.Generator(device="cuda").manual_seed(B * L + H)
    r = torch.softmax(torch.randn((B, L, H), generator=gen, device="cuda"),
                      dim=-1)
    a_variants = (
        ("mask", torch.ones((B,), device="cuda")[:, None].expand(B, L)),
        ("sigmoid", torch.sigmoid(torch.randn((B, L), generator=gen,
                                              device="cuda"))))
    elems = B * L * H * C
    for a_label, a_in in a_variants:
        before = kernel.launch_counts()
        sk = kernel.em_stage_stats(u, r, a_in, **lt)
        sk2 = kernel.em_stage_stats(u, r, a_in, **lt)
        sp = kernel.em_stage_stats_plain(u, r, a_in, **lt)
        torch.cuda.synchronize()
        check(kernel.launch_counts()["em_stage_stats"]
              == before["em_stage_stats"] + 2, "launch counter did not move")
        check(all(torch.equal(x, y) for x, y in zip(sk, sk2)),
              f"{name} stats {a_label}: two calls differ")
        errs = {k: scaled_err(x, y)
                for k, x, y in zip(("rsum", "rv", "rv2"), sk, sp)}
        check(all(torch.isfinite(x).all() for x in sk),
              f"{name} stats {a_label}: non-finite")
        check(max(errs.values()) <= TOL, f"{name} stats {a_label}: scaled "
                                         f"max|Δ| {errs} > {TOL}")
        a_bytes = B * 4 if a_in.stride(1) == 0 else B * L * 4
        bytes_once = (elems + B * L * H) * 4 + a_bytes + \
            (B * H + 2 * B * H * C) * 4
        ms = timed_ms(lambda: kernel.em_stage_stats(u, r, a_in, **lt))
        dev = device_ms(lambda: kernel.em_stage_stats(u, r, a_in, **lt),
                        bound_ms=bound(bytes_once,
                                       5 * elems + 2 * B * L * H)[0])
        plain_ms = timed_ms(lambda: kernel.em_stage_stats_plain(
            u, r, a_in, **lt), **PLAIN_TIMING)
        # r·a and Σrw per (b,l,h); w·v, v², w·v² and two sums per element
        row = em_row("em_stage_stats", name, a_label, u.shape, errs, ms,
                     dev, plain_ms, bytes_once, 5 * elems + 2 * B * L * H)
        results.append(row)
        print(f"[em] {name:<22} em_stage_stats a_in={a_label:<8} scaled "
              f"max|Δ| rsum {errs['rsum']:.1e} rv {errs['rv']:.1e} rv2 "
              f"{errs['rv2']:.1e} (tol {TOL:g}), deterministic; kernel "
              f"{ms:.4f} ms (device {dev_note(dev)})  plain {plain_ms:.3f} "
              f"ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")

        # iteration 0's M-step (λ = 0.05), default options
        mu, isig, bias, _ = ops.em_m_step(*sp, lam=0.05)
        ek = kernel.em_stage_estep(u, mu, isig, bias, **lt)
        ek2 = kernel.em_stage_estep(u, mu, isig, bias, **lt)
        ep = kernel.em_stage_estep_plain(u, mu, isig, bias, **lt)
        torch.cuda.synchronize()
        check(torch.equal(ek, ek2), f"{name} estep {a_label}: two calls "
                                    "differ")
        check(bool(torch.isfinite(ek).all()), f"{name} estep {a_label}: "
                                              "non-finite")
        errs = {"r": scaled_err(ek, ep)}
        check(errs["r"] <= TOL, f"{name} estep {a_label}: scaled max|Δ| "
                                f"{errs['r']:.3g} > {TOL}")
        r64 = estep_f64(u, mu, isig, bias)
        err64 = {"kernel": float((ek.double() - r64).abs().max()),
                 "plain": float((ep.double() - r64).abs().max())}
        del r64
        bytes_once = (elems + 2 * B * H * C + B * H + B * L * H) * 4
        ms = timed_ms(lambda: kernel.em_stage_estep(u, mu, isig, bias, **lt))
        dev = device_ms(lambda: kernel.em_stage_estep(u, mu, isig, bias,
                                                      **lt),
                        bound_ms=bound(bytes_once,
                                       4 * elems + 6 * B * L * H)[0])
        plain_ms = timed_ms(lambda: kernel.em_stage_estep_plain(
            u, mu, isig, bias, **lt), **PLAIN_TIMING)
        # v−μ, its square, ·(1/σ²), Σ_c per element; bias, max, exp, Σ and
        # the division per (b,l,h)
        row = em_row("em_stage_estep", name, a_label, u.shape, errs, ms,
                     dev, plain_ms, bytes_once, 4 * elems + 6 * B * L * H)
        geo = ops.estep_geometry(B, L, H, C)
        row.update(err_f64=err64, vector=geo.vector, blocks=geo.blocks,
                   rows_per_pass=geo.rows_per_pass, warps=geo.warps,
                   h_passes=geo.h_passes)
        results.append(row)
        print(f"[em] {name:<22} em_stage_estep a_in={a_label:<8} scaled "
              f"max|Δ| {errs['r']:.1e} (tol {TOL:g}; against float64: "
              f"kernel {err64['kernel']:.1e}, plain {err64['plain']:.1e}), "
              f"deterministic, rows "
              f"sum to 1 within {float((ek.sum(-1) - 1).abs().max()):.1e}; "
              f"kernel {ms:.4f} ms (device {dev_note(dev)})  plain "
              f"{plain_ms:.3f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
              f"{'16-byte' if geo.vector == 4 else 'scalar'} loads, "
              f"{geo.rows_per_pass} rows a pass, {geo.h_passes} h-pass"
              f"{'es' if geo.h_passes > 1 else ''}, {geo.warps} warps in "
              f"{geo.blocks} blocks")


def estep_f64(u, mu, isig, bias) -> torch.Tensor:
    """The E-step in float64: how far fp32 rounding alone moves r on these
    inputs."""
    d = u.double() - mu.double()[:, None]
    logits = bias.double()[:, None] - 0.5 * torch.sum(
        d * d * isig.double()[:, None], dim=-1)
    return torch.softmax(logits, dim=-1)


def em_f64(votes: torch.Tensor, a_in: torch.Tensor, iters: int,
           eps: float = 1e-9) -> tuple:
    """EM routing in float64 (the torch path's arithmetic, default
    options): an independent reference for both fp32 paths."""
    import math
    v, a = votes.double(), a_in.double()
    B, L, H, C = v.shape
    r = torch.full((B, L, H), 1.0 / H, dtype=torch.float64, device=v.device)
    for it in range(iters):
        lam = 1.0 - 0.95 ** (it + 1)
        rw = r * a[..., None]
        r_sum = torch.sum(rw, dim=1) + eps
        mu = torch.einsum("blh,blhc->bhc", rw, v) / r_sum[..., None]
        diff2 = torch.square(v - mu[:, None])
        sigma2 = torch.einsum("blh,blhc->bhc", rw, diff2) \
            / r_sum[..., None] + eps
        cost = (1.0 + 0.5 * torch.log(sigma2)) * r_sum[..., None]
        a_out = torch.sigmoid(lam * (1.0 - torch.sum(cost, dim=-1)))
        log_p = -0.5 * torch.sum(torch.log(2.0 * math.pi * sigma2[:, None])
                                 + diff2 / sigma2[:, None], dim=-1)
        r = torch.softmax(torch.log(a_out[:, None] + eps) + log_p, dim=-1)
    return mu, a_out


# an EM router call's device time by kernel
EM_PARTS = {"stats": ("em_stats_kernel", "em_stats_reduce_kernel"),
            "estep": ("em_estep_kernel",)}


def em_whole(CAPS) -> dict:
    """The whole EM procedure at Caps-MN1, B=100, on the serving path's
    votes and mask: the cuda backend against the torch backend within the
    reference's gate, both against float64."""
    from repro_torch.core.router import RouterSpec, build_router
    cfg = CAPS["Caps-MN1"]
    u = votes_for(cfg, 100)
    B, L = u.shape[:2]
    a_in = torch.ones((B,), device="cuda")[:, None].expand(B, L)
    spec = RouterSpec(algorithm="em", backend="cuda",
                      iterations=cfg.routing_iters)
    cuda_r = build_router(spec)
    torch_r = build_router(spec._replace(backend="torch"))
    with torch.inference_mode():
        pose_c, act_c = cuda_r(u, a_in)
        pose_t, act_t = torch_r(u, a_in)
        pose64, act64 = em_f64(u, a_in, cfg.routing_iters)
        cuda_ms = timed_ms(lambda: cuda_r(u, a_in), runs=10)
        torch_ms = timed_ms(lambda: torch_r(u, a_in), runs=10)
        split = device_ms(lambda: cuda_r(u, a_in), runs=10, parts=EM_PARTS)
    torch.cuda.synchronize()
    out = {"pose_err": float((pose_c - pose_t).abs().max()),
           "a_out_err": float((act_c - act_t).abs().max()),
           "pose_err64_cuda": float((pose_c.double() - pose64).abs().max()),
           "pose_err64_torch": float((pose_t.double() - pose64).abs().max()),
           "a_out_err64_cuda": float((act_c.double() - act64).abs().max()),
           "a_out_err64_torch": float((act_t.double() - act64).abs().max()),
           "a_out_min": float(act_c.min()), "a_out_max": float(act_c.max()),
           "a_out_min_f64": float(act64.min()),
           "max_abs_pose": float(pose_t.abs().max()),
           "cuda_ms": cuda_ms, "torch_ms": torch_ms, "device_split": split}
    print(f"[em] whole EM at {cfg.name}, B={B}, {cfg.routing_iters} "
          f"iterations: cuda vs torch backend max|Δ| pose "
          f"{out['pose_err']:.2e}, a_out {out['a_out_err']:.2e} (gate rtol "
          f"{EM_GATE['rtol']:g}, atol {EM_GATE['atol']:g}); against float64:"
          f" pose cuda {out['pose_err64_cuda']:.2e} / torch "
          f"{out['pose_err64_torch']:.2e}, a_out cuda "
          f"{out['a_out_err64_cuda']:.2e} / torch "
          f"{out['a_out_err64_torch']:.2e}; max|pose| "
          f"{out['max_abs_pose']:.3e}")
    print(f"[em] a_out spread: min {out['a_out_min']!r}, max "
          f"{out['a_out_max']!r} (float64 min {out['a_out_min_f64']!r}); "
          f"router call cuda {cuda_ms:.3f} ms, torch {torch_ms:.3f} ms")
    if split["ms"] is not None:
        print(f"[em] one cuda router call, device time {split['ms']:.4f} ms "
              f"= M-step statistics {split['stats']:.4f} + E-step "
              f"{split['estep']:.4f} + M-step arithmetic and the rest "
              f"(PyTorch) {split['other']:.4f} ({split['kernels_a_call']} "
              f"device operations; torch.profiler, median of 10)")
    check(bool(torch.isfinite(pose_c).all() and torch.isfinite(act_c).all()),
          "the cuda EM path gave non-finite values")
    check(torch.allclose(pose_c, pose_t, **EM_GATE),
          f"EM pose cuda vs torch: max|Δ| {out['pose_err']:.3g} outside the "
          f"gate")
    check(torch.allclose(act_c, act_t, **EM_GATE),
          f"EM a_out cuda vs torch: max|Δ| {out['a_out_err']:.3g} outside "
          f"the gate")
    return out


def em_cli(card: str) -> dict:
    stdout, wall = run_cli("[em] cli", [
        "repro_torch.launch.serve_caps", "--algorithm", "em", "--backend",
        "cuda", "--requests", "64"])
    check("served 64 requests" in stdout and "0 failed" in stdout,
          "serve_caps --algorithm em did not serve 64 requests cleanly")
    print(f"[em] cli: --algorithm em --backend cuda --requests 64 in "
          f"{wall:.1f} s on {card}")
    return {"wall_s": wall}


# (B, L, H, C) past the narrow E-step kernel's 256 capsules
WIDE_ESTEP_SHAPES = ((4, 128, 300, 16), (2, 64, 257, 5))


def phase_em(kernel, CAPS, card: str) -> dict:
    from repro_torch.core.router import RouterSpec
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.launch import serve_caps as serve_cli
    from repro_torch.models.capsnet import CapsNet
    from repro_torch.runtime import caps_serve
    rows = []
    for name, cfg, batch in (("Caps-MN1", CAPS["Caps-MN1"], 100),
                             ("Caps-EN3", CAPS["Caps-EN3"], 100),
                             ("Caps-CF3", CAPS["Caps-CF3"], 100),
                             ("Caps-MN1 microbatch 8", CAPS["Caps-MN1"], 8)):
        u = votes_for(cfg, batch)
        check_em_kernels(kernel, name, u, rows)
        del u
        torch.cuda.empty_cache()
    # H·C = 35 is not a multiple of 4: the E-step's scalar path
    check_em_kernels(kernel, "odd capsules H=7 C=5", odd_votes(), rows)
    # H > 256: the wide E-step kernel (h-passes of 256 h, online softmax),
    # 16-byte loads at C = 16 and the scalar path at C = 5
    for shape in WIDE_ESTEP_SHAPES:
        check_em_kernels(kernel, f"wide H={shape[2]} C={shape[3]}",
                         odd_votes(shape, seed=shape[2]), rows)
    print("[em] library_ms: none — no single PyTorch call computes an EM "
          "M-step's statistics or its E-step")
    whole = em_whole(CAPS)

    caps_cfg = CAPS["Caps-MN1"]
    net = CapsNet(caps_cfg, device="cuda", seed=0)
    cfg = caps_serve.ServeConfig(microbatch=100, n_micro=2,
                                 pipeline="software")
    spec = RouterSpec(algorithm="em", backend="cuda",
                      iterations=caps_cfg.routing_iters)
    ds = SyntheticCapsDataset(caps_cfg.image_hw, caps_cfg.image_channels,
                              caps_cfg.num_h_caps)
    breakdown = wave_breakdown(net, spec, cfg, ds, caps_serve)
    run = serve_once(net, spec, cfg, ds, "sync", 600, caps_serve, serve_cli,
                     kernel, card)
    counts, waves = run["launches"], run["waves"]
    per_wave = spec.iterations * cfg.n_micro
    for name in ("em_stage_stats", "em_stage_estep"):
        check(counts[name] == per_wave * waves,
              f"{name} launched {counts[name]} times in {waves} waves; "
              f"expected {per_wave} per wave")
    for name in ("routing_procedure_fused", "routing_iteration_fused",
                 "routing_procedure_bwd"):
        check(counts[name] == 0, f"the EM path launched {name}")
    print(f"[em] main path: em_stage_stats and em_stage_estep launched "
          f"{counts['em_stage_stats']} and {counts['em_stage_estep']} times "
          f"in {waves} waves ({per_wave} each per wave: {spec.iterations} "
          f"iterations x {cfg.n_micro} microbatches); dynamic kernels 0")
    return {"kernels": rows, "whole": whole, "breakdown": breakdown,
            "run": run, "main_launches": counts, "cli": em_cli(card)}


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between the fp32 bit patterns of a and b."""
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def phase_fastmath(card: str) -> dict:
    """The fast-math entry points on the card: kernel against plain
    version bitwise, against the exact functions within the reference's
    bounds, timed beside the bound and the exact functions' PyTorch
    calls (which compute other functions: a yardstick, not a twin)."""
    from repro_torch.kernels.fastmath import kernel as fk
    from repro_torch.kernels.fastmath import ops as fops
    from repro_torch.kernels.fastmath import ref as fref
    gen = torch.Generator(device="cuda").manual_seed(56)
    oracle = {"exp": fref.exp_ref, "inv_sqrt": fref.inv_sqrt_ref,
              "reciprocal": fref.reciprocal_ref}
    library = {"exp": torch.exp, "inv_sqrt": torch.rsqrt,
               "reciprocal": torch.reciprocal}
    n = FASTMATH_N

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    rows = []
    for op in ("exp", "inv_sqrt", "reciprocal"):
        shift = -4.0 if op == "exp" else 0.0
        # the reference test's inputs, and inputs that reach the exp clip
        # at 254.999 (x > 88.7) and its subnormal bitcasts (x < -87.3), or
        # 75 decades for inv_sqrt and reciprocal
        ref_in = uniform((n // 512, 512), 0.1, 8.0) + shift
        wide = (uniform((n // 512, 512), -100.0, 100.0) if op == "exp"
                else torch.exp(uniform((n // 512, 512), -87.0, 87.0)))
        cases = [("reference inputs", ref_in), ("wide", wide)]
        cases += [(f"shape {s}", uniform(s, 0.1, 8.0) + shift)
                  for s in FASTMATH_SHAPES]
        for recover in (True, False):
            ulp, rel = 0, 0.0
            for label, x in cases:
                got = getattr(fops, op)(x, recover=recover)
                want = fk.fastmath_2d_plain(
                    x.reshape(1, -1), op=op, recover=recover, block_rows=1,
                    block_cols=x.numel()).reshape(x.shape)
                torch.cuda.synchronize()
                check(got.shape == x.shape, f"{op}: shape {got.shape}")
                ulp = max(ulp, max_ulp(got, want))
                if recover and label != "wide":
                    exact = oracle[op](x)
                    rel = max(rel, float(((got - exact).abs()
                                          / exact.abs()).max()))
            check(ulp == 0, f"{op} recover={recover}: kernel {ulp} ULP off "
                            "its plain version")
            if recover:
                check(rel < FASTMATH_TOL[op], f"{op}: max relative error "
                      f"{rel:.3g} against the exact function >= "
                      f"{FASTMATH_TOL[op]}")
            x = ref_in
            ms = timed_ms(lambda: fk.fastmath_2d(x, op=op, recover=recover))
            plain_ms = timed_ms(lambda: fk.fastmath_2d_plain(
                x, op=op, recover=recover), **PLAIN_TIMING)
            library_ms = timed_ms(lambda: library[op](x))
            # 4 bytes in and 4 out; about 8 integer and fp32 operations
            b_ms, b_by = bound(8 * n, 8 * n)
            row = {"kernel": "fastmath_2d", "op": op, "recover": recover,
                   "n": n, "max_ulp": ulp, "max_abs_err": 0.0,
                   "max_rel_err_exact": rel if recover else None,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": library_ms,
                   "library": library[op].__name__}
            rows.append(row)
            print(f"[fastmath] {op:<10} recover={recover!s:<5} max ULP "
                  f"kernel vs plain {ulp} over {len(cases)} inputs"
                  + (f", max rel err vs exact {rel:.2e} (tol "
                     f"{FASTMATH_TOL[op]})" if recover else "")
                  + f"; at 2^26: kernel {ms:.4f} ms  plain {plain_ms:.3f} ms"
                  f"  bound {b_ms:.4f} ms ({b_by})  "
                  f"torch.{library[op].__name__} {library_ms:.4f} ms (exact "
                  "function, not the same)")
        del ref_in, wide, cases
        torch.cuda.empty_cache()
    # the fast-math path: its three entry points, both ways, counted
    x = uniform((n // 512, 512), 0.1, 8.0)
    fk.fastmath_2d.launches = 0
    for op in ("exp", "inv_sqrt", "reciprocal"):
        for recover in (True, False):
            getattr(fops, op)(x, recover=recover)
    torch.cuda.synchronize()
    launches = fk.fastmath_2d.launches
    check(launches == 6, f"the fast-math path launched fastmath_2d "
                         f"{launches} times, expected 6")
    print(f"[fastmath] path: ops.exp/inv_sqrt/reciprocal, recover on and off"
          f", at 2^26 elements launched fastmath_2d {launches} times on "
          f"{card}")
    return {"rows": rows, "launches": launches}


# ---------------------------------------------------------------------------
# phase 7: sharded routing
# ---------------------------------------------------------------------------

STAGE_KERNELS = ("routing_stage_votes", "routing_stage_update",
                 "routing_stage_update_fold")
SHARDED_GATE = dict(rtol=2e-4, atol=2e-5)   # the reference's sharded gate
TWO_STAGE_TOL = 1e-5
RANK_TIMEOUT_S = 300     # a launch of ranks past this fails its phase


def stage_inputs(kernel, ops, u, sd):
    """The operands the sharded path hands each stage at iteration 1 of
    the real procedure: c and b after iteration 0, s from c (plain
    versions, so every kernel gets the same inputs)."""
    from repro_torch.kernels.routing import ref
    B, L, H, C = u.shape
    us = u.to(ops.STREAM_DTYPES[sd]).contiguous()
    lt = ops.auto_l_tile(B, L, H, C, sd)
    c0 = torch.full((L, H), 1.0 / H, device="cuda")
    s0 = kernel.routing_stage_votes_plain(us, c0, l_tile=lt)
    _, b1 = kernel.routing_stage_update_plain(us, s0, l_tile=lt)
    c1 = ref.softmax_h(b1)
    s1 = kernel.routing_stage_votes_plain(us, c1, l_tile=lt)
    return us, lt, c1.contiguous(), s1.contiguous(), b1.contiguous()


def eq4_reference(name, us, s, sd) -> None:
    """Prints, ungated, the time of ``torch.einsum("blhc,bhc->lh", û, v)``
    at the stream dtype: Eq.4 alone, not the update kernel's function
    (no squash, no fold), as phase 6 prints ``torch.exp`` beside
    ``fastmath_2d``."""
    from repro_torch.kernels.routing import ref
    v = ref.squash(s, False).to(us.dtype)

    def eq4():
        return torch.einsum("blhc,bhc->lh", us, v)
    ms = timed_ms(eq4)
    dev = device_ms(eq4)
    print(f"[sharded] {name:<22} reference (Eq.4 only, not the same "
          f"function): torch.einsum('blhc,bhc->lh') {sd} {ms:.4f} ms "
          f"(device {dev_note(dev)})")


def check_stage_kernels(kernel, ops, name, u, results,
                        offset: int = 0) -> None:
    """Each stage kernel against its plain version, fp32 and bf16 streams,
    exact and approx: max|Δ| ≤ 1e-5·max(1, max|plain|) on each output, two
    calls bitwise equal, medians of 20 CUDA-event-timed calls beside the
    bound (each input read once, each output written once).  ``offset``
    hands the kernels û as a view that many elements into its storage
    (not 16-byte aligned: the update kernel's one-element runs)."""
    B, L, H, C = u.shape
    elems = B * L * H * C
    for sd in ("fp32", "bf16"):
        us, lt, c, s, b = stage_inputs(kernel, ops, u, sd)
        if offset:
            flat = torch.empty(elems + offset, dtype=us.dtype, device="cuda")
            flat[offset:].copy_(us.reshape(-1))
            us = flat[offset:].view(us.shape)
            del flat
        u_bytes = elems * us.element_size()
        lh, bhc = L * H * 4, B * H * C * 4
        cases = [("routing_stage_votes", "-", lambda: kernel.routing_stage_votes(
            us, c, l_tile=lt), lambda: kernel.routing_stage_votes_plain(
            us, c, l_tile=lt), u_bytes + lh + bhc)]
        for ua in (False, True):
            kw = dict(l_tile=lt, use_approx=ua)
            mode = "approx" if ua else "exact"
            cases.append(("routing_stage_update", mode,
                          lambda kw=kw: kernel.routing_stage_update(us, s,
                                                                    **kw),
                          lambda kw=kw: kernel.routing_stage_update_plain(
                              us, s, **kw), u_bytes + 2 * bhc + lh))
            cases.append(("routing_stage_update_fold", mode,
                          lambda kw=kw: kernel.routing_stage_update_fold(
                              us, s, b, **kw),
                          lambda kw=kw: kernel.routing_stage_update_fold_plain(
                              us, s, b, **kw), u_bytes + 2 * bhc + 3 * lh))
        for kname, mode, run_k, run_p, bytes_once in cases:
            before = getattr(kernel, kname).launches
            out_k, out_k2, out_p = run_k(), run_k(), run_p()
            torch.cuda.synchronize()
            check(getattr(kernel, kname).launches == before + 2,
                  f"{kname}: launch counter did not move")
            as_tuple = (lambda o: o if isinstance(o, tuple) else (o,))
            out_k, out_k2, out_p = map(as_tuple, (out_k, out_k2, out_p))
            check(all(torch.equal(x, y) for x, y in zip(out_k, out_k2)),
                  f"{name} {kname} {sd} {mode}: two calls differ")
            check(all(bool(torch.isfinite(x).all()) for x in out_k),
                  f"{name} {kname} {sd} {mode}: non-finite")
            errs = [scaled_err(x, y) for x, y in zip(out_k, out_p)]
            err = max(errs)
            check(err <= TOL, f"{name} {kname} {sd} {mode}: scaled max|Δ| "
                              f"{errs} > {TOL}")
            b_ms, b_by = bound(bytes_once, 2 * elems)
            ms = timed_ms(run_k)
            dev = device_ms(run_k, bound_ms=b_ms)
            plain_ms = timed_ms(run_p, **PLAIN_TIMING)
            geo_note = ""
            if kname != "routing_stage_votes":
                geo = ops.stage_update_geometry(
                    B, L, H, C, sd, aligned=us.data_ptr() % 16 == 0)
                geo_note = (f"; {geo.blocks} blocks of {geo.threads}, "
                            f"{geo.rows} rows x {geo.slices} slices, "
                            f"{geo.passes} pass(es) of {geo.cols} columns, "
                            f"runs of {geo.vector}, "
                            f"{geo.unroll} runs in flight in "
                            + ("shared memory" if geo.smem_ring
                               else "registers"))
            results.append({"kernel": kname, "shape": name, "B": B, "L": L,
                            "H": H, "C": C, "variant": f"{sd} {mode}",
                            "max_abs_err": err, "scaled_errs": errs,
                            "tol": TOL, "deterministic": True, "ms": ms,
                            "device_ms": dev["ms"],
                            "plain_ms": plain_ms, "bound_ms": b_ms,
                            "bound_by": b_by})
            print(f"[sharded] {name:<22} {kname:<26} {sd} {mode:<6} scaled "
                  f"max|Δ| {err:.1e} (tol {TOL:g}), deterministic; kernel "
                  f"{ms:.4f} ms (device {dev_note(dev)})  plain "
                  f"{plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})"
                  f"{geo_note}")
        eq4_reference(name, us, s, sd)
        del us, c, s, b
        torch.cuda.empty_cache()


def sharded_whole(CAPS, mesh) -> dict:
    """The whole sharded procedure at Caps-MN1, B=100, over the 1-rank
    vault mesh, for {B}, {L} and {H} (EM: {B} and {L}): against the
    unsharded procedure kernel and the torch backend, at the reference's
    gates; the sharded routing stage timed beside the procedure kernel,
    and the collectives of the H plan timed alone."""
    from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
    from repro_torch.runtime import mesh_utils
    cfg = CAPS["Caps-MN1"]
    u = votes_for(cfg, 100)
    B, L, H, C = u.shape
    iters = cfg.routing_iters
    spec = RouterSpec(backend="cuda", iterations=iters)
    out = {"dynamic": {}, "em": {}}
    with torch.inference_mode():
        want_t = build_router(spec._replace(backend="torch"))(u)
        proc = build_router(spec)
        want_p = proc(u)
        out["procedure_ms"] = timed_ms(lambda: proc(u), runs=10)
        for dim in "BLH":
            r = build_router(spec, ExecutionPlan(
                mesh=mesh, axes=((dim, "vault"),)))
            got = r(u)
            torch.cuda.synchronize()
            e_t = float((got - want_t).abs().max())
            e_p = float((got - want_p).abs().max())
            check(torch.allclose(got, want_t, **SHARDED_GATE),
                  f"sharded {{{dim}}} vs torch: max|Δ| {e_t:.3g}")
            check(torch.allclose(got, want_p, **SHARDED_GATE),
                  f"sharded {{{dim}}} vs procedure kernel: max|Δ| {e_p:.3g}")
            ms = timed_ms(lambda: r(u), runs=10)
            out["dynamic"][dim] = {"err_torch": e_t, "err_procedure": e_p,
                                   "ms": ms, "fusion": r.resolve(u).fusion}
            print(f"[sharded] whole dynamic routing {{{dim}}} over the "
                  f"1-rank vault mesh at {cfg.name}, B={B}: max|Δ| vs torch "
                  f"{e_t:.2e}, vs the unsharded procedure kernel {e_p:.2e} "
                  f"(gate rtol {SHARDED_GATE['rtol']:g}, atol "
                  f"{SHARDED_GATE['atol']:g}); router call {ms:.3f} ms "
                  f"against the procedure kernel's {out['procedure_ms']:.3f}"
                  " ms")
        a_in = torch.ones((B,), device="cuda")[:, None].expand(B, L)
        espec = RouterSpec(algorithm="em", backend="cuda", iterations=iters)
        pose_t, act_t = build_router(espec._replace(backend="torch"))(u, a_in)
        for dim in "BL":
            pose, act = build_router(espec, ExecutionPlan(
                mesh=mesh, axes=((dim, "vault"),)))(u, a_in)
            torch.cuda.synchronize()
            e = {"pose": float((pose - pose_t).abs().max()),
                 "a_out": float((act - act_t).abs().max())}
            check(torch.allclose(pose, pose_t, **EM_GATE)
                  and torch.allclose(act, act_t, **EM_GATE),
                  f"sharded EM {{{dim}}} vs torch: {e}")
            out["em"][dim] = e
            print(f"[sharded] whole EM {{{dim}}}: max|Δ| vs torch pose "
                  f"{e['pose']:.2e}, a_out {e['a_out']:.2e} (gate rtol "
                  f"{EM_GATE['rtol']:g}, atol {EM_GATE['atol']:g})")
        # the H plan's collectives per call: iterations × (pmax + psum of
        # the (L, 1) softmax terms) and one all-gather of v along H
        col = torch.ones((L, 1), device="cuda")
        v = torch.ones((B, H, C), device="cuda")
        with mesh_utils.active(mesh):
            pmax_ms = timed_ms(lambda: mesh_utils.pmax(col, "vault"))
            psum_ms = timed_ms(lambda: mesh_utils.psum(col, "vault"))
            gather_ms = timed_ms(lambda: mesh_utils.all_gather(v, "vault", 1))
    out["collectives_ms"] = {"pmax": pmax_ms, "psum": psum_ms,
                             "all_gather": gather_ms,
                             "per_H_call": iters * (pmax_ms + psum_ms)
                             + gather_ms}
    print(f"[sharded] collectives timed alone on the 1-rank NCCL group: pmax "
          f"{pmax_ms:.4f} ms, psum {psum_ms:.4f} ms, all_gather "
          f"{gather_ms:.4f} ms; the H plan issues {2 * iters} all-reduces "
          f"and 1 all-gather per call: "
          f"{out['collectives_ms']['per_H_call']:.3f} ms")
    return out


def sharded_breakdown(net, spec, cfg, ds, caps_serve, whole) -> dict:
    """One sharded wave split into its stages: the wave function, the
    encoder and the routing stage of one microbatch (CUDA events), the
    routing stage's collectives from ``sharded_whole``."""
    from repro_torch.core.router import build_router
    from repro_torch.models import capsnet
    adapter = caps_serve.CapsAdapter(net, spec)
    wave = adapter.make_wave_fn(cfg)
    router = build_router(spec, "auto")
    packed = adapter.pack(list(ds.batch(20_000, cfg.wave_lanes)["images"]),
                          cfg)
    micro = {k: v[0] for k, v in packed.items()}

    def encode():
        return capsnet.encode_votes(net, micro["images"]) * \
            micro["mask"][:, None, None, None]

    with torch.inference_mode():
        votes = encode()
        out = {"encode_ms": timed_ms(encode, runs=10),
               "route_ms": timed_ms(lambda: router(votes), runs=10),
               "wave_ms": timed_ms(lambda: wave(packed), runs=10),
               "collectives_ms": whole["collectives_ms"]["per_H_call"],
               "procedure_ms": whole["procedure_ms"]}
    print(f"[sharded] one auto-plan wave of {cfg.n_micro} x {cfg.microbatch}"
          f" lanes: wave function {out['wave_ms']:.3f} ms = per microbatch "
          f"encoder {out['encode_ms']:.3f} ms + sharded routing "
          f"{out['route_ms']:.3f} ms (of it collectives about "
          f"{out['collectives_ms']:.3f} ms), x {cfg.n_micro}; the unsharded "
          f"procedure kernel takes {out['procedure_ms']:.3f} ms per "
          "microbatch")
    return out


def sharded_cli(card: str) -> dict:
    stdout, wall = run_cli("[sharded] cli", [
        "repro_torch.launch.serve_caps", "--plan", "auto", "--backend",
        "cuda", "--requests", "64"])
    check("served 64 requests" in stdout and "0 failed" in stdout,
          "serve_caps --plan auto did not serve 64 requests cleanly")
    print(f"[sharded] cli: --plan auto --backend cuda --requests 64 in "
          f"{wall:.1f} s on {card}")
    return {"wall_s": wall}


def _rank_worker(argv: list) -> None:
    """One of two gloo ranks sharing the card (NCCL refuses two ranks on
    one GPU): sharded dynamic routing {B}, {L}, {H} and EM {B}, {L} over a
    (2,) vault mesh against this rank's own unsharded result, and a
    Caps-MN1 serving wave through the two-stage pipeline over a (2, 1)
    (pipe, vault) mesh against the unpipelined arm.  Writes its errors and
    launch counts to ``rank<r>.json``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist
    from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS
    from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.kernels.routing import kernel
    from repro_torch.models.capsnet import CapsNet
    from repro_torch.runtime import caps_serve, mesh_utils
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp, rank = argv[0], dist.get_rank()
    cfg = CAPS_BENCHMARKS["Caps-MN1"]
    iters = cfg.routing_iters
    mesh = mesh_utils.make_mesh((2,), ("vault",), device="cuda")
    u = votes_for(cfg, 100)
    B, L = u.shape[:2]
    spec = RouterSpec(backend="cuda", iterations=iters)
    res = {"rank": rank, "dynamic": {}, "em": {}}
    with torch.inference_mode():
        want = build_router(spec._replace(backend="torch"))(u)
        for dim in "BLH":
            kernel.reset_launch_counts()
            t0 = time.perf_counter()
            got = build_router(spec, ExecutionPlan(
                mesh=mesh, axes=((dim, "vault"),)))(u)
            torch.cuda.synchronize()
            res["dynamic"][dim] = {
                "err": float((got - want).abs().max()),
                "ok": bool(torch.allclose(got, want, **SHARDED_GATE)),
                "wall_ms": (time.perf_counter() - t0) * 1e3,
                "launches": {k: v for k, v in kernel.launch_counts()
                             .items() if v}}
        a_in = torch.ones((B,), device="cuda")[:, None].expand(B, L)
        espec = RouterSpec(algorithm="em", backend="cuda",
                           iterations=iters)
        pose_t, act_t = build_router(espec._replace(backend="torch"))(
            u, a_in)
        for dim in "BL":
            pose, act = build_router(espec, ExecutionPlan(
                mesh=mesh, axes=((dim, "vault"),)))(u, a_in)
            torch.cuda.synchronize()
            res["em"][dim] = {
                "err_pose": float((pose - pose_t).abs().max()),
                "err_a_out": float((act - act_t).abs().max()),
                "ok": bool(torch.allclose(pose, pose_t, **EM_GATE)
                           and torch.allclose(act, act_t, **EM_GATE))}
    del u
    net = CapsNet(cfg, device="cuda", seed=0)
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    pipe = mesh_utils.make_mesh((2, 1), ("pipe", "vault"), device="cuda")
    base = dict(microbatch=100, n_micro=2)
    adapter = caps_serve.CapsAdapter(net, spec)
    two = adapter.make_wave_fn(caps_serve.ServeConfig(
        pipeline="two_stage", mesh=pipe, routing_plan="auto", **base))
    plain = adapter.make_wave_fn(caps_serve.ServeConfig(pipeline=None,
                                                        **base))
    sc = caps_serve.ServeConfig(pipeline=None, **base)
    packed = adapter.pack(list(ds.batch(30_000, 170)["images"]), sc)
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    got = two(packed)
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in kernel.launch_counts().items() if v}
    want = plain(packed)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    res["two_stage"] = {"err": err, "ok": err <= TWO_STAGE_TOL,
                        "first_wave_ms": wave_ms, "launches": counts,
                        "pipe_rank": mesh_utils.axis_index(pipe, "pipe")}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def two_ranks(card: str) -> dict:
    """Phase 7b: two gloo ranks on the one card through
    ``repro_torch.launch.ranks``.  A rank that fails fails the phase; every
    rank is stopped."""
    import tempfile
    from repro_torch.launch import ranks
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks.run(_rank_worker, [tmp], 2, "cuda", timeout_s=RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for res in ranks:
        r = res["rank"]
        for dim, d in res["dynamic"].items():
            print(f"[sharded] 2 ranks, rank {r}: dynamic {{{dim}}} over the "
                  f"(2,) vault mesh max|Δ| vs its unsharded torch result "
                  f"{d['err']:.2e} (gate rtol {SHARDED_GATE['rtol']:g}, atol"
                  f" {SHARDED_GATE['atol']:g}), first call {d['wall_ms']:.1f}"
                  f" ms, launches {d['launches']}")
            check(d["ok"], f"rank {r} dynamic {{{dim}}}: {d['err']:.3g}")
        for dim, d in res["em"].items():
            print(f"[sharded] 2 ranks, rank {r}: EM {{{dim}}} max|Δ| pose "
                  f"{d['err_pose']:.2e}, a_out {d['err_a_out']:.2e}")
            check(d["ok"], f"rank {r} EM {{{dim}}}: {d}")
        t = res["two_stage"]
        print(f"[sharded] 2 ranks, rank {r} (pipe rank {t['pipe_rank']}): "
              f"Caps-MN1 wave of 2 x 100 lanes through two_stage over a "
              f"(2, 1) (pipe, vault) mesh, routing_plan='auto': max|Δ| vs "
              f"the unpipelined arm {t['err']:.2e} (tol {TWO_STAGE_TOL:g}); "
              f"first wave {t['first_wave_ms']:.1f} ms; launches "
              f"{t['launches']}")
        check(t["ok"], f"rank {r} two_stage: {t['err']:.3g}")
    print(f"[sharded] 2 gloo ranks on {card}: passed in {wall:.1f} s")
    return {"ranks": ranks, "wall_s": wall}


def phase_sharded(kernel, ops, CAPS, card: str) -> dict:
    from repro_torch.core.router import RouterSpec, build_router
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.launch import serve_caps as serve_cli
    from repro_torch.models.capsnet import CapsNet
    from repro_torch.runtime import caps_serve, mesh_utils
    import torch.distributed as dist
    mesh = mesh_utils.make_mesh((1,), ("vault",), device="cuda")
    print(f"[sharded] 1-rank mesh {mesh} over {dist.get_backend()}")
    rows = []
    for name, cfg, batch in (("Caps-MN1", CAPS["Caps-MN1"], 100),
                             ("Caps-EN3", CAPS["Caps-EN3"], 100),
                             ("Caps-CF3", CAPS["Caps-CF3"], 100),
                             ("Caps-MN1 microbatch 8", CAPS["Caps-MN1"], 8)):
        u = votes_for(cfg, batch)
        check_stage_kernels(kernel, ops, name, u, rows)
        del u
        torch.cuda.empty_cache()
    # H·C = 35: the update kernel's one-element runs and element stagings
    check_stage_kernels(kernel, ops, "odd capsules H=7 C=5", odd_votes(),
                        rows)
    # û not 16-byte aligned at Caps-EN2 and Caps-EN3 (H·C = 752, 992):
    # one-element runs in two passes, EN2's cutting a capsule
    for cfg_name in ("Caps-EN2", "Caps-EN3"):
        u = votes_for(CAPS[cfg_name], 8)
        check_stage_kernels(kernel, ops, f"{cfg_name} B=8 unaligned", u, rows,
                            offset=1)
        del u
    print("[sharded] library_ms: none — no single PyTorch call computes a "
          "routing stage")
    whole = sharded_whole(CAPS, mesh)

    caps_cfg = CAPS["Caps-MN1"]
    net = CapsNet(caps_cfg, device="cuda", seed=0)
    ds = SyntheticCapsDataset(caps_cfg.image_hw, caps_cfg.image_channels,
                              caps_cfg.num_h_caps)
    spec = RouterSpec(backend="cuda", iterations=caps_cfg.routing_iters)
    cfg = caps_serve.ServeConfig(microbatch=100, n_micro=2,
                                 pipeline="software", routing_plan="auto")
    plain_cfg = caps_serve.ServeConfig(microbatch=100, n_micro=2,
                                       pipeline="software")
    with torch.inference_mode():
        resolved = build_router(spec, "auto").resolve(votes_for(caps_cfg,
                                                                100))
    dim = resolved[0][0]
    print(f"[sharded] plan='auto' at {caps_cfg.name}, B=100 on the 1-rank "
          f"vault mesh resolves to {tuple(resolved)}, fusion "
          f"{resolved.fusion!r} (DeviceModel.h100: nominal data-sheet rates)")
    # the wave scores against an unsharded torch-backend server
    sharded_ad = caps_serve.CapsAdapter(net, spec)
    torch_ad = caps_serve.CapsAdapter(net, spec._replace(backend="torch"))
    wave_s, wave_t = sharded_ad.make_wave_fn(cfg), torch_ad.make_wave_fn(
        plain_cfg)
    worst = 0.0
    for index, count in ((0, cfg.wave_lanes), (1, 137)):
        packed = sharded_ad.pack(list(ds.batch(40_000 + index, count)
                                      ["images"]), cfg)
        worst = max(worst, float((wave_s(packed) - wave_t(packed)).abs()
                                 .max()))
    print(f"[sharded] auto-plan wave scores vs the unsharded torch server: "
          f"max|Δ| {worst:.2e} (tol {TOL:g})")
    check(worst <= TOL, f"auto-plan wave scores differ by {worst:.3g}")
    breakdown = sharded_breakdown(net, spec, cfg, ds, caps_serve, whole)
    per_wave = spec.iterations * cfg.n_micro
    update = ("routing_stage_update_fold" if dim == "L"
              else "routing_stage_update")
    run = serve_once(net, spec, cfg, ds, "sync", 600, caps_serve, serve_cli,
                     kernel, card)
    counts, waves = run["launches"], run["waves"]
    for name in STAGE_KERNELS:
        want = per_wave * waves if name in ("routing_stage_votes",
                                            update) else 0
        check(counts[name] == want, f"{name} launched {counts[name]} times "
                                    f"in {waves} waves; expected {want}")
    check(counts["routing_procedure_fused"] == 0,
          "the sharded path launched the procedure kernel")
    print(f"[sharded] main path (plan auto -> {dim}): routing_stage_votes "
          f"and {update} launched {counts['routing_stage_votes']} and "
          f"{counts[update]} times in {waves} waves ({per_wave} each per "
          f"wave: {spec.iterations} iterations x {cfg.n_micro} microbatches)")
    fold_cfg = caps_serve.ServeConfig(microbatch=100, n_micro=2,
                                      pipeline="software", mesh=mesh,
                                      routing_plan=(("L", "vault"),))
    fold_run = serve_once(net, spec, fold_cfg, ds, "sync", 150, caps_serve,
                          serve_cli, kernel, card)
    fc, fw = fold_run["launches"], fold_run["waves"]
    for name in STAGE_KERNELS:
        want = per_wave * fw if name != "routing_stage_update" else 0
        check(fc[name] == want, f"L plan: {name} launched {fc[name]} times "
                                f"in {fw} waves; expected {want}")
    print(f"[sharded] fold path (L plan): routing_stage_votes and "
          f"routing_stage_update_fold launched {fc['routing_stage_votes']} "
          f"and {fc['routing_stage_update_fold']} times in {fw} waves")
    cli = sharded_cli(card)
    ranks = two_ranks(card)
    return {"kernels": rows, "whole": whole, "resolved": [list(a) for a in
                                                          resolved],
            "agreement": worst, "breakdown": breakdown, "run": run,
            "fold_run": fold_run,
            "main_launches": {k: counts[k] for k in STAGE_KERNELS},
            "fold_launches": {k: fc[k] for k in STAGE_KERNELS},
            "cli": cli, "two_ranks": ranks}


# ---------------------------------------------------------------------------
# phase 8: LM serving
# ---------------------------------------------------------------------------

# the fp32 kernels (split TF32) at an LM training shape, qwen3-moe's (4,
# 32, 4, 1024, 128) causal, and mixtral's window of 4096 over S = 5120 at 4
# query heads over one KV head (the band's edge crosses the steps; all of
# mixtral's 32 heads run in phase 12); phases 8 and 9 each run both
FP32_TRAINING_CHECKS = [(4, 32, 4, 1024, 128, True, "fp32"),
                        (1, 4, 1, 5120, 128, True, "fp32", 4096)]
# (B, Hq, Hkv, S, D, causal, dtype[, window]): granite-3-2b's prefill
# wave, the reference's FLASH_CASES (tests/test_kernels.py:602-608), odd
# S, bf16 cases at the other head dims (every instantiation of the
# tensor-core kernel), zamba2-7b's D = 112 and stablelm-12b's D = 160 in
# fp32 and bf16, causal and bidirectional, at odd S, and
# FP32_TRAINING_CHECKS
FLASH_CHECKS = [(8, 32, 8, 1024, 64, True, "bf16"),
                (8, 32, 8, 1024, 64, True, "fp32"),
                (1, 2, 2, 128, 32, True, "fp32"), (2, 4, 2, 128, 64, True,
                                                   "fp32"),
                (1, 8, 2, 256, 64, True, "fp32"), (2, 2, 2, 128, 32, False,
                                                   "fp32"),
                (1, 2, 1, 64, 128, True, "fp32"),
                (8, 32, 8, 1023, 64, True, "bf16"),
                (2, 4, 2, 37, 16, False, "fp32"),
                (2, 4, 2, 37, 16, False, "bf16"),
                (1, 2, 2, 128, 32, True, "bf16"),
                (1, 2, 1, 64, 128, True, "bf16"),
                (2, 4, 2, 37, 112, True, "fp32"),
                (1, 4, 2, 200, 112, False, "fp32"),
                (2, 4, 2, 37, 112, False, "bf16"),
                (1, 4, 2, 1023, 112, True, "bf16"),
                (2, 4, 2, 37, 160, False, "fp32"),
                (1, 4, 2, 200, 160, True, "fp32"),
                (2, 4, 2, 37, 160, True, "bf16"),
                (1, 4, 2, 1023, 160, False, "bf16")] + [
    # head dims the kernels do not instantiate, zero-padded (80 and 96 to
    # 112), and the D = 256 instantiation: fp32 and bf16, causal and
    # Sk != Sq, at small shapes
    (1, 4, 2, 200, 80, True, "fp32"), (2, 4, 2, (37, 200), 80, False,
                                       "bf16"),
    (2, 4, 2, (64, 130), 96, False, "fp32"), (1, 4, 2, 1023, 96, True,
                                              "bf16"),
    (1, 4, 2, 130, 256, True, "fp32"), (2, 4, 2, (37, 200), 256, False,
                                        "fp32"),
    (1, 4, 2, 1023, 256, True, "bf16"), (2, 4, 2, (37, 200), 256, False,
                                         "bf16")] + FP32_TRAINING_CHECKS
# (Bt, T, Din, N, dtype): falcon-mamba-7b's prefill, the reference's
# SSM_CASES (tests/test_kernels.py:700-706), odd T, and Din that is not a
# multiple of the kernel's 64 channels (odd, and 100), N = 32 in bf16
SCAN_CHECKS = [(4, 1024, 8192, 16, "bf16"), (1, 64, 16, 8, "fp32"),
               (2, 128, 32, 16, "fp32"), (2, 64, 8, 4, "fp32"),
               (1, 96, 16, 8, "fp32"), (2, 37, 64, 16, "bf16"),
               (2, 37, 75, 32, "bf16"), (1, 40, 100, 16, "fp32"),
               # state sizes the kernel does not instantiate: 12 padded to
               # 16, 48 in chunks of 32 and 16
               (2, 64, 128, 12, "fp32"), (2, 64, 128, 12, "bf16"),
               (2, 64, 128, 48, "fp32"), (2, 64, 128, 48, "bf16")]
LM_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
GRANITE_SERVE = dict(requests=16, prompt_len=1024, new_tokens=32, wave=8)
FALCON_SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def ulp_excess(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max|Δ|, the worst excess over the one-ulp gate) of ``lm_close``,
    without raising: fp32 max|Δ| ≤ 1e-5·max(1, max|want|); bf16 each
    element within one bf16 ulp of ``want`` on top of that."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    gate = TOL * max(1.0, float(w.abs().max()))
    allowed = gate + (bf16_ulp(w) if want.dtype == torch.bfloat16 else 0.0)
    return float(diff.max()), float((diff - allowed).max())


def lm_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """fp32: max|Δ| ≤ 1e-5·max(1, max|plain|).  bf16: each element within
    one bf16 ulp of the plain output, on top of that fp32 gate (the two
    fp32 accumulators differ by round-off, then each rounds to bf16; near
    zero an ulp alone is smaller than the round-off).  Returns max|Δ|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, plain "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff, worst = ulp_excess(got, want)
    check(worst <= 0.0, f"{name}: max|Δ| {diff:.3g} exceeds its tolerance "
                        f"by {worst:.3g}")
    return diff


# The gate of the bf16 tensor-core kernels (phases 8 and 9).  They round p,
# and ds in the backward, to bf16 once before each product whose operand it
# is, as the library calls do, so they no longer agree with the fp32 plain
# versions to one ulp (neither does the library).  Each output is held
# instead to the library call's error on the same inputs, both measured
# against the same function in float64 ("exact"):
#   max e_k ≤ LIB_MAX_FACTOR·max e_l + g and mean e_k ≤ LIB_MEAN_FACTOR·
#   mean e_l + g, with e = |X − exact| and g = TOL·max(1, max|exact|).
# The max over ~10⁸ elements is a tail statistic, and a factor of 2 leaves
# room for another summation order; a wrong mask, KV head or tile gives
# errors of the order of |o|, hundreds of times the round-off; the mean
# check fails a systematic bias, such as truncating where it should round.
LIB_MAX_FACTOR = 2.0
LIB_MEAN_FACTOR = 1.5


def lib_gate(name: str, got: torch.Tensor, lib: torch.Tensor,
             exact: torch.Tensor) -> dict:
    """Hold ``got`` (a bf16 tensor-core kernel's output) to the library
    call's output ``lib`` on the same inputs, both against the float64
    ``exact``; raises if it fails.  Returns the four errors."""
    check(got.shape == lib.shape == exact.shape and got.dtype == lib.dtype,
          f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, library "
          f"{tuple(lib.shape)} {lib.dtype}, exact {tuple(exact.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    e_k = (got.double() - exact).abs()
    e_l = (lib.double() - exact).abs()
    g = TOL * max(1.0, float(exact.abs().max()))
    out = {"max_err": float(e_k.max()), "lib_max_err": float(e_l.max()),
           "mean_err": float(e_k.mean()), "lib_mean_err": float(e_l.mean())}
    check(out["max_err"] <= LIB_MAX_FACTOR * out["lib_max_err"] + g,
          f"{name}: max|kernel − exact| {out['max_err']:.3g} over "
          f"{LIB_MAX_FACTOR}·{out['lib_max_err']:.3g} (library) + {g:.2g}")
    check(out["mean_err"] <= LIB_MEAN_FACTOR * out["lib_mean_err"] + g,
          f"{name}: mean|kernel − exact| {out['mean_err']:.3g} over "
          f"{LIB_MEAN_FACTOR}·{out['lib_mean_err']:.3g} (library) + {g:.2g}")
    return out


def case_dims(case) -> tuple:
    """(B, Hq, Hkv, Sq, Sk, D, causal, dtype) of an attention check's case
    (B, Hq, Hkv, S, D, causal, dtype[, window]): S is one length, or (Sq,
    Sk) for cross attention."""
    B, Hq, Hkv, S, D, causal, dt = case[:7]
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    return B, Hq, Hkv, Sq, Sk, D, causal, dt


def case_window(case):
    """The sliding window of an attention check's case (its eighth entry),
    or None."""
    return case[7] if len(case) > 7 else None


def sdpa_kw(S: int, causal: bool, window) -> dict:
    """SDPA's arguments for the same function: ``is_causal``, or the
    boolean band mask of a window."""
    if window is None:
        return {"is_causal": causal}
    return {"attn_mask": band_mask(S, window)}


def attention_f64(q, k, v, causal: bool, do=None, window=None) -> dict:
    """The same function in float64 from the same inputs, dense, one batch
    row at a time (one KV head's group at a time where the row's float64
    scores would pass 4 GB): o and lse; given dO also dq, and dk, dv
    summed over each KV head's query-head group in float64.  ``window``:
    the causal sliding window.  k, v may hold another number of keys than
    q of queries (bidirectional cross attention)."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / D ** 0.5
    keys = ("o", "lse") if do is None else ("o", "lse", "dq", "dk", "dv")
    parts = {name: [] for name in keys}
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        if window is not None:
            mask = mask.triu(1 - window)
    kv_pass = Hkv if Hq * S * Sk * 8 <= 2 ** 32 else 1
    for b in range(B):
        row = {name: [] for name in keys}
        for j0 in range(0, Hkv, kv_pass):
            heads = slice(j0 * group, (j0 + kv_pass) * group)
            qb = q[b, heads].double()
            kb, vb = (t[b, j0:j0 + kv_pass].double()
                      .repeat_interleave(group, dim=0) for t in (k, v))
            s = qb @ kb.transpose(-1, -2) * scale
            if causal:
                s = s.masked_fill(~mask, float("-inf"))
            lse = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - lse[..., None])
            del s
            o = p @ vb
            row["o"].append(o)
            row["lse"].append(lse)
            if do is None:
                continue
            dob = do[b, heads].double()
            dp = dob @ vb.transpose(-1, -2)
            ds = p * (dp - (o * dob).sum(-1, keepdim=True))
            del dp
            row["dq"].append(ds @ kb * scale)
            row["dk"].append((ds.transpose(-1, -2) @ qb * scale)
                             .reshape(-1, group, Sk, D).sum(1))
            row["dv"].append((p.transpose(-1, -2) @ dob)
                             .reshape(-1, group, Sk, D).sum(1))
            del p, ds
        for name in keys:
            parts[name].append(torch.cat(row[name]))
    return {name: torch.stack(ts) for name, ts in parts.items()}


def old_gate_verdicts(kernel_excess: float, lib_excess: float) -> str:
    """The one-ulp gate's verdict (``lm_close``, against the fp32 plain
    version) on the kernel and on the library call, for the record."""
    def verdict(x):
        return "passes" if x <= 0.0 else f"fails by {x:.3g}"
    return (f"old one-ulp gate: kernel {verdict(kernel_excess)}, library "
            f"{verdict(lib_excess)}")


def gate_line(errs: dict) -> str:
    return (f"max {errs['max_err']:.3e} (library {errs['lib_max_err']:.3e}) "
            f"mean {errs['mean_err']:.3e} (library "
            f"{errs['lib_mean_err']:.3e})")


def check_flash(fk, case, gen, rows) -> None:
    """fp32: ``lm_close`` against the plain version.  bf16 (the tensor-core
    kernel): ``lib_gate`` against float64, anchored on SDPA, and the
    plain version's rounding model at the kernel's 64 × 64 tiles held to
    the same gate; max|Δ| is the kernel's distance from that model.
    ``case`` as ``case_dims`` and ``case_window`` read it."""
    B, Hq, Hkv, S, Sk, D, causal, dt = case_dims(case)
    window = case_window(case)
    c = {"causal": causal, "window": window}
    dtype = LM_DTYPES[dt]
    q = torch.randn(B, Hq, S, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda").to(dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    skw = dict(sdpa_kw(S, causal, window), enable_gqa=True)
    label = f"flash {case}"
    before = fk.flash_attention.launches
    out = fk.flash_attention(q, k, v, **c)
    again = fk.flash_attention(q, k, v, **c)
    plain = fk.flash_attention_plain(q, k, v, **c)
    torch.cuda.synchronize()
    check(fk.flash_attention.launches == before + 2,
          "flash_attention's launch counter did not move")
    check(torch.equal(out, again), f"{label}: two calls differ")
    extra = {}
    if dtype == torch.bfloat16:
        exact = attention_f64(q, k, v, causal, window=window)["o"]
        lib = sdpa(q, k, v, **skw)
        gate = lib_gate(label, out, lib, exact)
        model = fk.flash_attention_plain(q, k, v, **c, block_q=64,
                                         block_k=64, round_operands=True)
        lib_gate(f"{label} plain rounding model", model, lib, exact)
        err = float((out.float() - model.float()).abs().max())
        verdicts = old_gate_verdicts(ulp_excess(out, plain)[1],
                                     ulp_excess(lib, plain)[1])
        extra = {"gate": gate, "old_gate": verdicts}
        del exact, lib, model
        note = (f"gate {gate_line(gate)}; max|Δ| from the plain rounding "
                f"model {err:.2e}; {verdicts}")
    else:
        err = lm_close(label, out, plain)
        note = f"max|Δ| {err:.2e}"
    ms = timed_ms(lambda: fk.flash_attention(q, k, v, **c))
    # the plain version at S of thousands: one call
    plain_ms = timed_ms(lambda: fk.flash_attention_plain(q, k, v, **c),
                        **(dict(runs=1, warmup=0) if S > 2048
                           else PLAIN_TIMING))
    sdpa_ms = timed_ms(lambda: sdpa(q, k, v, **skw))
    item = q.element_size()
    bytes_once = (2 * q.numel() + 2 * k.numel()) * item
    pairs = band_pairs(S, window) if causal else S * Sk
    flops = 4.0 * B * Hq * D * pairs      # q·kᵀ and p·v multiply-adds
    b_ms, b_by = bound(bytes_once, flops, attention_rate(dtype, D))
    rows.append({"kernel": "flash_attention", "B": B, "Hq": Hq, "Hkv": Hkv,
                 "S": S, "Sk": Sk, "D": D, "causal": causal,
                 "window": window, "dtype": dt, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": sdpa_ms, **extra})
    print(f"[lm] flash_attention B={B} Hq={Hq} Hkv={Hkv} S={S}"
          f"{f' Sk={Sk}' if Sk != S else ''} D={D} "
          f"causal={causal}{f' window={window}' if window else ''} {dt}: "
          f"{note}, two calls bitwise equal; kernel "
          f"{ms:.4f} ms  plain {plain_ms:.3f} ms  bound {b_ms:.4f} ms "
          f"({b_by})  SDPA {sdpa_ms:.4f} ms (kernel {ms / sdpa_ms:.2f}×)")


def check_scan(sk, case, gen, rows) -> None:
    Bt, T, Din, N, dt = case
    dtype = LM_DTYPES[dt]
    x = torch.randn(Bt, T, Din, generator=gen, device="cuda").to(dtype)
    dtv = torch.nn.functional.softplus(
        torch.randn(Bt, T, Din, generator=gen, device="cuda") - 2.0)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device="cuda").repeat(Din, 1)   # -exp(A_log) at init
    Bm = torch.randn(Bt, T, N, generator=gen, device="cuda").to(dtype)
    Cm = torch.randn(Bt, T, N, generator=gen, device="cuda").to(dtype)
    Dv = torch.randn(Din, generator=gen, device="cuda")
    h0 = torch.randn(Bt, Din, N, generator=gen, device="cuda")
    kernel_ns = sk.launch_state_dims(N)      # one a launch
    for init in (None, h0):
        args = (x, dtv, A, Bm, Cm, Dv)
        before = sk.selective_scan.launches
        y, h = sk.selective_scan(*args, chunk=1, h0=init)
        y2, h2 = sk.selective_scan(*args, chunk=1, h0=init)
        py, ph = sk.selective_scan_plain(*args, chunk=1, h0=init)
        torch.cuda.synchronize()
        check(sk.selective_scan.launches == before + 2 * len(kernel_ns),
              "selective_scan's launch counter did not move")
        label = f"scan {case} h0={'yes' if init is not None else 'no'}"
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"{label}: two calls differ")
        err = max(lm_close(f"{label} y", y, py),
                  lm_close(f"{label} h_T", h, ph))
        ms = timed_ms(lambda: sk.selective_scan(*args, chunk=1, h0=init))
        plain_ms = timed_ms(lambda: sk.selective_scan_plain(
            *args, chunk=1, h0=init), **PLAIN_TIMING)
        ins = [x, dtv, A, Bm, Cm, Dv] + ([init] if init is not None else [])
        bytes_once = sum(t.numel() * t.element_size() for t in ins) \
            + y.numel() * y.element_size() + h.numel() * 4
        # per (t, channel, state): dt·A, exp, a·h, u·B, +, h·C, + ; per
        # (t, channel): dt·x, D·x, +
        flops = Bt * T * Din * (7 * N + 3)
        b_ms, b_by = bound(bytes_once, flops)
        # one exp per (t, channel, state) on the special-function units
        sfu_ms = Bt * T * Din * N / SFU_PER_S * 1e3
        geo = sk.scan_geometry(Bt, Din, kernel_ns[0],
                               dtype if len(kernel_ns) == 1
                               else torch.float32)
        rows.append({"kernel": "selective_scan", "Bt": Bt, "T": T,
                     "Din": Din, "N": N, "kernel_N": kernel_ns, "dtype": dt,
                     "h0": init is not None, "max_abs_err": err,
                     "deterministic": True, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "sfu_floor_ms": sfu_ms,
                     "blocks": geo.blocks, "threads": geo.threads,
                     "library_ms": None})
        print(f"[lm] selective_scan Bt={Bt} T={T} Din={Din} N={N} "
              f"(kernel N {kernel_ns}) {dt} "
              f"h0={'yes' if init is not None else 'no'}: max|Δ| y, h_T "
              f"{err:.2e}, two calls bitwise equal; kernel {ms:.4f} ms  "
              f"plain {plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  "
              f"special-function floor {sfu_ms:.4f} ms; {geo.blocks} blocks "
              f"of {geo.threads} threads")


@contextlib.contextmanager
def plain_lm_path():
    """The comparison arm only: the two LM kernels' entry points call their
    plain versions, on the card, for the duration of the block.  The port
    itself never does this — a CUDA tensor reaches a kernel or raises."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    with mock.patch.object(fops, "flash_attention", fk.flash_attention_plain), \
            mock.patch.object(sops, "selective_scan",
                              sk.selective_scan_plain):
        yield


# Kernel path against plain path on granite's prefill logits: bf16 weights
# and activations through 40 layers put max|Δ| near 2e-2 of max|logit| on
# the H100; a tenth of max|logit| leaves room for that and still fails a
# kernel fault that moves the logits grossly.
LOGIT_REL_LIMIT = 0.1


def first_token_agreement(name, logits_k, logits_p,
                          paths: str = "kernel path vs plain path",
                          limit: float = LOGIT_REL_LIMIT) -> dict:
    """Prefill logits of the kernel path against the plain path on the same
    weights: max|Δ| / max|logit| stated and held below ``limit``
    (``LOGIT_REL_LIMIT`` by default); the first greedy token equal on every lane whose
    top-2 margin exceeds 2·max|Δ| (no perturbation of that size can swap
    the top two), and at least one lane that clear, so a gross fault cannot
    pass vacuously."""
    lk, lp = logits_k.float(), logits_p.float()
    check(bool(torch.isfinite(lk).all()), f"{name}: non-finite logits")
    delta = float((lk - lp).abs().max())
    rel = delta / float(lp.abs().max())
    check(rel < limit, f"{name}: max|Δ| {rel:.3e} of max|logit| is over "
                       f"{limit}")
    clear = top2_margin(lp) > 2 * delta
    check(bool(clear.any()), f"{name}: no lane has a top-2 margin over "
                             f"2·{delta:.3g}, so no first token is checked")
    same = lk.argmax(-1) == lp.argmax(-1)
    check(bool(same[clear].all()), f"{name}: first tokens differ on a lane "
                                   f"with top-2 margin > 2·{delta:.3g}")
    print(f"[lm] {name} prefill logits, {paths} on the "
          f"card: max|Δ| {delta:.4g} = {rel:.3e} of max|logit|; first token "
          f"equal on {int(same.sum())}/{same.numel()} lanes "
          f"({int(clear.sum())} with top-2 margin > 2·max|Δ|)")
    return {"max_abs_diff": delta, "rel_diff": rel,
            "lanes_equal": int(same.sum()), "lanes": same.numel(),
            "lanes_clear": int(clear.sum())}


def granite_prefill_split(lm, L, params, cfg, tokens, prefill_ms) -> dict:
    """One prefill wave split by CUDA events on layer 0 (times n_layers):
    the attention kernel, the attention projections (q, k, v, o and the
    cache's k, v, with RoPE and the layout copies), the SwiGLU MLP; the
    rest (norms, residuals, embedding, unembedding, cache writes) is the
    wave's time less those."""
    from repro_torch.kernels.flash_attention import ops as fops
    lp = lm.layer(params["layers"], 0)
    x, positions = lm._embed_inputs(params, cfg, {"tokens": tokens})
    h = L.apply_norm(lp["attn_norm"], x, cfg.norm_type)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
              rope_theta=cfg.rope_theta)
    B, S, _ = x.shape
    q = torch.randn(B, cfg.n_heads, S, cfg.d_head, device="cuda").to(cfg.dtype)
    kv = torch.randn(B, cfg.n_kv, S, cfg.d_head, device="cuda").to(cfg.dtype)
    attn_ms = timed_ms(lambda: fops.attention(q, kv, kv), runs=10)
    block_ms = timed_ms(lambda: L.attention_forward(lp["attn"], h, positions,
                                                    **kw), runs=10)
    kv_ms = timed_ms(lambda: L.project_kv(lp["attn"], h, positions,
                                          n_kv=cfg.n_kv, d_head=cfg.d_head,
                                          rope_theta=cfg.rope_theta), runs=10)
    mlp_ms = timed_ms(lambda: L.swiglu(lp["mlp"], h), runs=10)
    n = cfg.n_layers
    out = {"prefill_ms": prefill_ms, "attention_kernel_ms": n * attn_ms,
           "projections_ms": n * (block_ms - attn_ms + kv_ms),
           "mlp_ms": n * mlp_ms}
    out["rest_ms"] = prefill_ms - sum(v for k, v in out.items()
                                      if k != "prefill_ms")
    print(f"[lm] granite-3-2b prefill of {B} x {S}: {prefill_ms:.2f} ms = "
          f"attention kernel {out['attention_kernel_ms']:.2f} "
          f"({100 * out['attention_kernel_ms'] / prefill_ms:.1f} %) + "
          f"projections "
          f"{out['projections_ms']:.2f} + MLP {out['mlp_ms']:.2f} + rest "
          f"(norms, residuals, embed, unembed, cache writes) "
          f"{out['rest_ms']:.2f} ms ({n} layers, layer 0 timed)")
    return out


def serve_granite(fk, sk, card: str) -> dict:
    """granite-3-2b at full width, all 40 layers, random weights: 16
    requests through ``WaveServer`` and ``LMDecodeAdapter`` in waves of 8
    (the main path, counted), the kernel path against the plain path, and
    one prefill split into its parts."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import LMDecodeAdapter
    from repro_torch.runtime.wave_serve import ServeConfig, WaveServer
    cfg = configs.get_config("granite-3-2b")
    sv = GRANITE_SERVE
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv} KV "
          f"heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded"
          f" to {cfg.vocab_padded}, {cfg.param_count() / 1e9:.3f} B "
          f"parameters in {cfg.dtype} (random, seed 0), made in "
          f"{time.perf_counter() - t0:.1f} s")
    adapter = LMDecodeAdapter(params, cfg, prompt_len=sv["prompt_len"],
                              max_new_tokens=sv["new_tokens"])
    scfg = ServeConfig(microbatch=sv["wave"], n_micro=1, pipeline=None)
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab, (sv["requests"], sv["prompt_len"]), dtype=np.int32)
    w = sv["wave"]
    warm = adapter.make_wave_fn(scfg)(adapter.pack(list(prompts[:w]), scfg))
    server = WaveServer(adapter, cfg=scfg)
    fk.flash_attention.launches = 0
    sk.selective_scan.launches = 0
    t0 = time.perf_counter()
    server.submit(prompts)
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fk.flash_attention.launches,
                "selective_scan": sk.selective_scan.launches}
    s = server.metrics.summary()
    check(s["submitted"] == s["completed"] == sv["requests"] and
          server.pending() == 0, f"granite books: {s}")
    for key in ("wave_errors", "failed", "guard_trips", "shed"):
        check(s[key] == 0, f"granite serving: {key} = {s[key]} "
                           f"({s['last_error']})")
    check(launches["flash_attention"] == cfg.n_layers * s["waves"],
          f"flash_attention launched {launches['flash_attention']} times in "
          f"{s['waves']} waves; expected {cfg.n_layers} per wave")
    check(launches["selective_scan"] == 0, "granite launched the scan")
    outs = np.stack([c.pred for c in sorted(done, key=lambda c: c.rid)])
    check(outs.shape == (sv["requests"], sv["new_tokens"]) and
          outs.min() >= 0 and outs.max() < cfg.vocab_padded,
          f"granite completions {outs.shape}, range [{outs.min()}, "
          f"{outs.max()}]")
    check(np.array_equal(outs[:w], warm.astype(np.int32)),
          "the served wave differs from the same wave run before")
    tokens = sv["requests"] * sv["new_tokens"]
    print(f"[lm] granite-3-2b served {s['completed']} requests (prompt "
          f"{sv['prompt_len']}, +{sv['new_tokens']} tokens) in {s['waves']} "
          f"waves of {sv['wave']}: {sv['requests'] / wall:.3f} req/s, "
          f"{tokens / wall:.1f} generated tokens/s, p50 "
          f"{s['p50_latency_s'] * 1e3:.1f} ms, wall {wall:.2f} s; "
          f"wave_errors {s['wave_errors']}, failed {s['failed']}, shed "
          f"{s['shed']}; launches {launches} on {card}")
    batch = {"tokens": torch.from_numpy(prompts[:w]).cuda()}
    max_len = sv["prompt_len"] + sv["new_tokens"]
    with torch.inference_mode():
        logits_k, _ = lm.prefill(params, cfg, batch, max_len)
        prefill_ms = host_ms(lambda: lm.prefill(params, cfg, batch, max_len),
                             runs=3)
        with plain_lm_path():
            logits_p, _ = lm.prefill(params, cfg, batch, max_len)
        agreement = first_token_agreement("granite-3-2b", logits_k, logits_p)
        split = granite_prefill_split(lm, L, params, cfg, batch["tokens"],
                                      prefill_ms)
    print(f"[lm] granite-3-2b time to first token of a wave of {w} x "
          f"{sv['prompt_len']} (prefill + first argmax): {prefill_ms:.2f} ms")
    out = {"requests": sv["requests"], "waves": s["waves"], "wall_s": wall,
           "req_per_s": sv["requests"] / wall, "tokens_per_s": tokens / wall,
           "p50_latency_s": s["p50_latency_s"],
           "p90_latency_s": s["p90_latency_s"], "ttft_ms": prefill_ms,
           "launches": launches, "agreement": agreement, "split": split}
    return out


def serve_falcon(lm_kernels, card: str) -> dict:
    """falcon-mamba-7b at full width and depth, random weights: 4 prompts
    of 1024 tokens prefilled (the main path, counted) and greedily decoded
    for 32 tokens, and one layer's final scan state against the plain
    version."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm, ssm
    from repro_torch.runtime.serve_loop import generate
    fk, sk = lm_kernels
    cfg = configs.get_config("falcon-mamba-7b")
    sv = FALCON_SERVE
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name} at full width and depth: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, d_inner {cfg.ssm.d_inner}, d_state "
          f"{cfg.ssm.d_state}, dt_rank {cfg.ssm.dt_rank}, conv "
          f"{cfg.ssm.conv_kernel}, vocab {cfg.vocab}, "
          f"{cfg.param_count() / 1e9:.3f} B parameters in {cfg.dtype} "
          f"(random, seed 0), made in {time.perf_counter() - t0:.1f} s")
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (sv["batch"], sv["prompt_len"]), dtype=np.int32)).cuda()
    max_len = sv["prompt_len"] + sv["new_tokens"]
    with torch.inference_mode():
        lm.prefill(params, cfg, {"tokens": prompts}, max_len)   # warm-up
        fk.flash_attention.launches = 0
        sk.selective_scan.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = lm.prefill(params, cfg, {"tokens": prompts}, max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = {"flash_attention": fk.flash_attention.launches,
                    "selective_scan": sk.selective_scan.launches}
        check(launches["selective_scan"] == cfg.n_layers,
              f"the prefill launched selective_scan "
              f"{launches['selective_scan']} times; expected {cfg.n_layers}")
        check(launches["flash_attention"] == 0, "falcon launched attention")
        check(bool(torch.isfinite(logits.float()).all()) and
              bool(torch.isfinite(state.ssm.ssm).all()),
              "falcon prefill: non-finite logits or state")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = generate(params, cfg, {"tokens": prompts},
                              sv["new_tokens"])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        check(out.shape == (sv["batch"], sv["new_tokens"]) and
              int(out.min()) >= 0 and int(out.max()) < cfg.vocab_padded,
              f"falcon tokens {tuple(out.shape)}")
        check(torch.equal(out[:, 0], logits.argmax(-1).to(out.dtype)),
              "generate's first token differs from the prefill's argmax")
        decode_ms = (gen_s * 1e3 - prefill_ms) / (sv["new_tokens"] - 1)
        # layer 0's scan on the prompts, kernel against plain version: y
        # and h_T (the inputs as mamba_forward makes them)
        mp = lm.layer(params["layers"], 0)["mamba"]
        x = L.apply_norm(lm.layer(params["layers"], 0)["norm"],
                         L.embed(params["embed"], prompts.long()),
                         cfg.norm_type)
        xin, _ = (x @ mp["in_proj"]).chunk(2, dim=-1)
        xc, _ = ssm._causal_conv(xin, mp["conv_w"], mp["conv_b"])
        xc = torch.nn.functional.silu(xc.float()).to(x.dtype)
        y_k, h_k = ssm._ssm_core_m1(mp, xc, cfg.ssm, None)
        with plain_lm_path():
            y_p, h_p = ssm._ssm_core_m1(mp, xc, cfg.ssm, None)
        err_h = lm_close("falcon layer 0 h_T", h_k, h_p)
        err_y = lm_close("falcon layer 0 scan output", y_k, y_p)
    tokens = sv["batch"] * sv["new_tokens"]
    print(f"[lm] falcon-mamba-7b: prefill of {sv['batch']} x "
          f"{sv['prompt_len']} in {prefill_ms:.2f} ms (time to first token)"
          f" with launches {launches}; generate (prefill + "
          f"{sv['new_tokens'] - 1} decode steps) {gen_s:.2f} s, "
          f"{decode_ms:.2f} ms a decode step, {tokens / gen_s:.1f} "
          f"generated tokens/s; layer 0 kernel vs plain: h_T max|Δ| "
          f"{err_h:.2e}, y max|Δ| {err_y:.2e}; no depth cut, on "
          f"{card}")
    result = {"layers": cfg.n_layers, "prefill_ms": prefill_ms,
              "generate_s": gen_s, "decode_step_ms": decode_ms,
              "tokens_per_s": tokens / gen_s, "launches": launches,
              "layer0_h_err": err_h, "layer0_y_err": err_y}
    return result


def lm_cli(card: str) -> dict:
    """The two LM CLIs on the card (``run_cli``)."""
    out = {}
    for name, args, want in (
            ("serve", ["repro_torch.launch.serve", "--arch", "granite-3-2b",
                       "--smoke"], ["served 8 requests"]),
            ("serve_caps", ["repro_torch.launch.serve_caps", "--model", "lm",
                            "--smoke"], ["served 24 requests", "0 failed"])):
        stdout, wall = run_cli(f"[lm] cli {name}", args)
        check(all(w in stdout for w in want),
              f"{' '.join(args)} did not serve cleanly")
        print(f"[lm] cli: python -m {' '.join(args)} in {wall:.1f} s on "
              f"{card}")
        out[name] = {"wall_s": wall}
    return out


def phase_lm(card: str) -> dict:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssm_scan import kernel as sk
    gen = torch.Generator(device="cuda").manual_seed(88)
    rows = []
    with torch.inference_mode():
        for case in FLASH_CHECKS:
            check_flash(fk, case, gen, rows)
        torch.cuda.empty_cache()
        for case in SCAN_CHECKS:
            check_scan(sk, case, gen, rows)
    torch.cuda.empty_cache()
    granite = serve_granite(fk, sk, card)
    gc.collect()
    torch.cuda.empty_cache()
    falcon = serve_falcon((fk, sk), card)
    gc.collect()
    torch.cuda.empty_cache()
    cli = lm_cli(card)
    return {"kernels": rows, "granite": granite, "falcon": falcon,
            "cli": cli}


# ---------------------------------------------------------------------------
# phase 9: LM training
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, D, causal, dtype[, window]): granite-3-2b's training
# shape, the reference's BWD_CASES (tests/test_kernels.py:641-646), odd S,
# a bidirectional bf16 case at D=128, bf16 cases at D=16 and 32 (every
# instantiation of the tensor-core kernels), D = 112 and 160 in fp32 and
# bf16, causal and bidirectional, at odd S, and FP32_TRAINING_CHECKS
TRAIN_ATTN_CHECKS = [(8, 32, 8, 1024, 64, True, "bf16"),
                     (8, 32, 8, 1024, 64, True, "fp32"),
                     (1, 2, 2, 64, 16, True, "fp32"),
                     (2, 4, 2, 64, 16, True, "fp32"),
                     (1, 8, 2, 64, 32, True, "fp32"),
                     (1, 2, 1, 128, 32, False, "fp32"),
                     (8, 32, 8, 1023, 64, True, "bf16"),
                     (2, 4, 2, 130, 128, False, "bf16"),
                     (2, 4, 2, 64, 16, True, "bf16"),
                     (1, 8, 2, 200, 32, True, "bf16"),
                     (1, 4, 2, 37, 112, True, "fp32"),
                     (1, 4, 2, 130, 112, False, "fp32"),
                     (2, 4, 2, 1023, 112, True, "bf16"),
                     (2, 4, 2, 130, 112, False, "bf16"),
                     (1, 4, 2, 37, 160, False, "fp32"),
                     (1, 4, 2, 130, 160, True, "fp32"),
                     (2, 4, 2, 37, 160, True, "bf16"),
                     (2, 4, 2, 1023, 160, False, "bf16")] + [
    # zero-padded head dims (80, 96 to 112) and D = 256, as in phase 8
    (1, 4, 2, 130, 80, True, "fp32"), (2, 4, 2, (37, 200), 80, False,
                                       "bf16"),
    (1, 4, 2, (64, 130), 96, False, "fp32"), (2, 4, 2, 1023, 96, True,
                                              "bf16"),
    (1, 4, 2, 130, 256, True, "fp32"), (1, 4, 2, (37, 200), 256, False,
                                        "fp32"),
    (2, 4, 2, 1023, 256, True, "bf16"), (2, 4, 2, (37, 200), 256, False,
                                         "bf16")] + FP32_TRAINING_CHECKS
BWD_FLOP_FACTOR = 2.5      # the backward's products over the forward's
# granite-3-2b trains all 40 layers at seq 1024 and batch 8, the largest of
# 8, 4 and 2 (it fits with remat); falcon-mamba-7b 8 of its 64 layers
# (parameters, gradients and fp32 moments of all 64 take about 87 GB; 32
# layers until the script grew past 800 s, 16 until it passed 1100 s on a
# slow host; it launches no kernel) at B=1,
# T=1024.  Five steps each on one repeated batch with warmup=1, so
# that the learning rate is not ramping through the run.
GRANITE_TRAIN = dict(batch=8, seq=1024, steps=5)
FALCON_TRAIN = dict(layers=8, batch=1, seq=1024, steps=5)
# kernel route against plain route at granite's full width, 2 layers:
# whole-tree gradients max|Δ| / max|g| measured 1.01e-2 on the H100 (bf16
# gradients a bf16 ulp apart where the two fp32 accumulators straddle a
# rounding, PERF.md §2); ten times that still fails a kernel fault that
# moves the gradients grossly.
TRAIN_GRAD_REL_LIMIT = 0.1


def lse_dense(q, k, causal: bool, window=None) -> torch.Tensor:
    """The row log-sum-exp of the masked scores in fp32, materialised;
    ``window``: the causal sliding window."""
    B, Hq, S, D = q.shape
    kf = k.float().repeat_interleave(Hq // k.shape[1], dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / D ** 0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        if window is not None:
            mask = mask.triu(1 - window)
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(logits, dim=-1)


def grouped_excess(got, want, want_heads) -> tuple:
    """(max|Δ|, the worst excess over the gate) of ``grouped_close`` for a
    bf16 dk or dv, without raising."""
    B, Hkv, S, D = want.shape
    heads = want_heads.reshape(B, Hkv, -1, S, D)
    diff = (got.float() - want.float()).abs()
    allowed = TOL * max(1.0, float(want.float().abs().max())) \
        + bf16_ulp(heads).sum(dim=2) + bf16_ulp(want)
    return float(diff.max()), float((diff - allowed).max())


def grouped_close(name, got, want, want_heads) -> float:
    """dk or dv: fp32 as ``lm_close``; bf16 each element within the fp32
    gate plus one bf16 ulp of every per-head plain value of its group (each
    rounds once before the sum) plus one ulp of the plain result (the sum
    rounds once).  Returns max|Δ|."""
    if want.dtype != torch.bfloat16:
        return lm_close(name, got, want)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: kernel gives {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff, worst = grouped_excess(got, want, want_heads)
    check(worst <= 0.0, f"{name}: max|Δ| {diff:.3g} exceeds its tolerance "
                        f"by {worst:.3g}")
    return diff


def library_fwd_lse(q, k, v, causal: bool):
    """One PyTorch call computing o and lse on KV heads expanded to the
    query heads: the flash-attention op for bf16, the memory-efficient op
    (which takes fp32) otherwise."""
    aten = torch.ops.aten
    if q.dtype == torch.bfloat16:
        return lambda: aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, causal)
    return lambda: aten._scaled_dot_product_efficient_attention(
        q, k, v, None, True, 0.0, causal)


def train_gates_bf16(fk, label, q, k, v, do, o, lse, grads, causal,
                     plain) -> tuple:
    """The bf16 training kernels' outputs o, lse, dq, dk, dv each held by
    ``lib_gate`` against float64, anchored on the library (the
    flash-attention op's o and lse on expanded KV heads, SDPA's autograd
    backward), and the plain versions' rounding model at the kernel's
    64 × 64 tiles held to the same gate.  Returns (max|Δ| of each output
    from that model, the gate's errors, the old gate's verdicts)."""
    S = q.shape[2]
    group = q.shape[1] // k.shape[1]
    exact = attention_f64(q, k, v, causal, do)
    kx, vx = (t.repeat_interleave(group, dim=1) for t in (k, v))
    lib_o, lib_lse = library_fwd_lse(q, kx, vx, causal)()[:2]
    del kx, vx
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        o_lib = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal, enable_gqa=True)
        lib_grads = torch.autograd.grad(o_lib, (qg, kg, vg), do)
    names = ("o", "lse", "dq", "dk", "dv")
    got = dict(zip(names, (o, lse) + tuple(grads)))
    lib = dict(zip(names, (lib_o, lib_lse[..., :S].float()) + lib_grads))
    m_o, m_lse = fk.flash_attention_fwd_lse_plain(
        q, k, v, causal=causal, block_q=64, block_k=64, round_operands=True)
    model = dict(zip(names, (m_o, m_lse) + fk.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal, block_q=64, block_k=64,
        round_operands=True)))
    gates, errs = {}, {}
    for name in names:
        gates[name] = lib_gate(f"{label} {name}", got[name], lib[name],
                               exact[name])
        lib_gate(f"{label} {name} plain rounding model", model[name],
                 lib[name], exact[name])
        errs[name] = float((got[name].float() - model[name].float())
                           .abs().max())
    p_o, p_lse, p_dq, p_dk, p_dv, dk_h, dv_h = plain
    verdicts = {}
    for name, ref in (("o", p_o), ("lse", p_lse), ("dq", p_dq)):
        verdicts[name] = old_gate_verdicts(ulp_excess(got[name], ref)[1],
                                           ulp_excess(lib[name], ref)[1])
    for name, ref, heads in (("dk", p_dk, dk_h), ("dv", p_dv, dv_h)):
        verdicts[name] = old_gate_verdicts(
            grouped_excess(got[name], ref, heads)[1],
            grouped_excess(lib[name], ref, heads)[1])
    return errs, gates, verdicts


def check_train_attention(fk, case, gen, rows, plain_timing=None) -> None:
    """fp32: o, lse, dq against the plain versions by ``lm_close``, dk, dv
    by ``grouped_close``.  bf16 (the tensor-core kernels):
    ``train_gates_bf16``.  Every case: lse within 1e-5 of a dense
    logsumexp, two calls bitwise equal.  ``case`` as ``case_dims`` and
    ``case_window`` read it (a window in fp32 only).  ``plain_timing``:
    ``timed_ms``'s runs and warmup for the plain versions (if None,
    ``PLAIN_TIMING``, and one call at S of thousands)."""
    B, Hq, Hkv, S, Sk, D, causal, dt = case_dims(case)
    window = case_window(case)
    check(window is None or dt == "fp32", f"{case}: a window in fp32 only")
    c = {"causal": causal, "window": window}
    if plain_timing is None:
        plain_timing = dict(runs=1, warmup=0) if S > 2048 else PLAIN_TIMING
    dtype = LM_DTYPES[dt]
    q, do = (torch.randn(B, Hq, S, D, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    label = f"train attention {case}"
    before = (fk.flash_attention_fwd_lse.launches,
              fk.flash_attention_bwd.launches)
    o, lse = fk.flash_attention_fwd_lse(q, k, v, **c)
    o2, lse2 = fk.flash_attention_fwd_lse(q, k, v, **c)
    grads = fk.flash_attention_bwd(q, k, v, o, lse, do, **c)
    grads2 = fk.flash_attention_bwd(q, k, v, o, lse, do, **c)
    torch.cuda.synchronize()
    check((fk.flash_attention_fwd_lse.launches,
           fk.flash_attention_bwd.launches) == (before[0] + 2, before[1] + 2),
          f"{label}: the launch counters did not move by 2")
    check(torch.equal(o, o2) and torch.equal(lse, lse2),
          f"{label}: two forward calls differ")
    check(all(torch.equal(a, b) for a, b in zip(grads, grads2)),
          f"{label}: two backward calls differ")
    dense = lse_dense(q, k, causal, window)
    lse_dense_err = float((lse - dense).abs().max())
    check(bool(((lse - dense).abs() <= 1e-5 + 1e-5 * dense.abs()).all()),
          f"{label}: lse {lse_dense_err:.3g} from the dense logsumexp")
    del dense
    p_o, p_lse = fk.flash_attention_fwd_lse_plain(q, k, v, **c)
    dq_p, dk_h, dv_h = fk.flash_attention_bwd_heads_plain(
        q, k, v, o, lse, do, **c)
    dk_p, dv_p = (fk.group_sum(t, Hkv, k.dtype) for t in (dk_h, dv_h))
    extra, notes = {}, ""
    if dtype == torch.bfloat16:
        errs, gates, verdicts = train_gates_bf16(
            fk, label, q, k, v, do, o, lse, grads, causal,
            (p_o, p_lse, dq_p, dk_p, dv_p, dk_h, dv_h))
        extra = {"gate": gates, "old_gate": verdicts}
        notes = "; ".join(f"{name} gate {gate_line(gates[name])}, "
                          f"{verdicts[name]}" for name in gates)
    else:
        errs = {"o": lm_close(f"{label} o", o, p_o),
                "lse": lm_close(f"{label} lse", lse, p_lse),
                "dq": lm_close(f"{label} dq", grads[0], dq_p)}
        for name, got, heads, ref in (("dk", grads[1], dk_h, dk_p),
                                      ("dv", grads[2], dv_h, dv_p)):
            errs[name] = grouped_close(f"{label} {name}", got, ref, heads)
    del dq_p, dk_h, dv_h, dk_p, dv_p, p_o, p_lse
    fwd_ms = timed_ms(lambda: fk.flash_attention_fwd_lse(q, k, v, **c))
    bwd_ms = timed_ms(lambda: fk.flash_attention_bwd(q, k, v, o, lse, do,
                                                     **c))
    fwd_plain_ms = timed_ms(lambda: fk.flash_attention_fwd_lse_plain(
        q, k, v, **c), **(plain_timing or {}))
    bwd_plain_ms = timed_ms(lambda: fk.flash_attention_bwd_plain(
        q, k, v, o, lse, do, **c), **(plain_timing or {}))
    group = Hq // Hkv
    kx, vx = (t.repeat_interleave(group, dim=1) for t in (k, v))
    if window is None:
        fwd_lib_ms = timed_ms(library_fwd_lse(q, kx, vx, causal))
    else:     # the memory-efficient op with the band as an additive bias
        bias = torch.zeros(B, Hq, S, S, dtype=dtype, device="cuda")
        bias.masked_fill_(~band_mask(S, window), float("-inf"))
        fwd_lib_ms = timed_ms(
            lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                q, kx, vx, bias, True))
        del bias
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o_lib = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, enable_gqa=True, **sdpa_kw(S, causal, window))
    bwd_lib_ms = timed_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True))
    del kx, vx, o_lib
    item = q.element_size()
    pairs = band_pairs(S, window) if causal else S * Sk
    fwd_flops = 4.0 * B * Hq * D * pairs      # q·kᵀ and p·v multiply-adds
    rate = attention_rate(dtype, D)
    lse_bytes = B * Hq * S * 4
    fwd_bytes = (2 * q.numel() + 2 * k.numel()) * item + lse_bytes
    bwd_bytes = (4 * q.numel() + 4 * k.numel()) * item + lse_bytes
    fb_ms, fb_by = bound(fwd_bytes, fwd_flops, rate)
    bb_ms, bb_by = bound(bwd_bytes, BWD_FLOP_FACTOR * fwd_flops, rate)
    common = {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "Sk": Sk, "D": D,
              "causal": causal, "window": window, "dtype": dt}
    fwd_extra = {key: {n: val[n] for n in ("o", "lse")}
                 for key, val in extra.items()}
    bwd_extra = {key: {n: val[n] for n in ("dq", "dk", "dv")}
                 for key, val in extra.items()}
    rows.append({"kernel": "flash_attention_fwd_lse", **common,
                 "max_abs_err": max(errs["o"], errs["lse"]),
                 "lse_dense_err": lse_dense_err, "ms": fwd_ms,
                 "plain_ms": fwd_plain_ms, "bound_ms": fb_ms,
                 "bound_by": fb_by, "library_ms": fwd_lib_ms, **fwd_extra})
    rows.append({"kernel": "flash_attention_bwd", **common,
                 "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
                 "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bb_ms,
                 "bound_by": bb_by, "library_ms": bwd_lib_ms, **bwd_extra})
    what = " from the plain rounding model" if extra else ""
    print(f"[train] attention B={B} Hq={Hq} Hkv={Hkv} S={S}"
          f"{f' Sk={Sk}' if Sk != S else ''} D={D} "
          f"causal={causal}{f' window={window}' if window else ''} {dt}: "
          f"max|Δ|{what} o {errs['o']:.2e} lse "
          f"{errs['lse']:.2e} (dense {lse_dense_err:.2e}) dq "
          f"{errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e}, two "
          f"calls bitwise equal; fwd_lse {fwd_ms:.4f} ms (plain "
          f"{fwd_plain_ms:.3f}, bound {fb_ms:.4f} {fb_by}, library "
          f"{fwd_lib_ms:.4f}, kernel {fwd_ms / fwd_lib_ms:.2f}×); bwd "
          f"{bwd_ms:.4f} ms (plain {bwd_plain_ms:.3f}, bound {bb_ms:.4f} "
          f"{bb_by}, SDPA backward {bwd_lib_ms:.4f}, kernel "
          f"{bwd_ms / bwd_lib_ms:.2f}×)")
    if notes:
        print(f"[train]   {label}: {notes}")


def attention_profile(fk) -> dict:
    """Device time by part of one granite-shaped bf16 call of the serving
    forward and of the backward (``device_ms`` over 10 calls each): the
    forward kernel; the dq kernel, the dk/dv kernel and the PyTorch work
    around them (delta and the group sums).  Beside the CUDA-event times
    of the kernel checks, which also hold the wrapper's host time."""
    B, Hq, Hkv, S, D, causal, _ = TRAIN_ATTN_CHECKS[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, do = (torch.randn(B, Hq, S, D, generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    o, lse = fk.flash_attention_fwd_lse(q, k, v, causal=causal)
    calls = {"forward": lambda: fk.flash_attention(q, k, v, causal=causal),
             "backward": lambda: fk.flash_attention_bwd(q, k, v, o, lse, do,
                                                        causal=causal)}
    out = {}
    for what, fn in calls.items():
        dev = device_ms(fn, runs=10, parts={kn: (kn,) for kn in TC_KERNELS})
        parts = {} if dev["ms"] is None else {
            ("pytorch" if kn == "other" else kn): dev[kn]
            for kn in (*TC_KERNELS, "other") if dev[kn] > 0}
        out[what] = parts
        shown = ", ".join(f"{name} {ms:.4f} ms" for name, ms in parts.items())
        print(f"[train] profiler, granite-shaped bf16 {what}, device time a "
              f"call: {shown or 'not measured (no device events)'}")
    return out


def lm_counters():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssm_scan import kernel as sk
    return (fk.flash_attention, fk.flash_attention_fwd_lse,
            fk.flash_attention_bwd, sk.selective_scan)


def read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in lm_counters()}


def train_lm(cfg, spec: dict, card: str) -> dict:
    """The main training path: ``init_train_state`` and
    ``make_train_step`` (remat on), ``spec["steps"]`` steps on one
    repeated synthetic batch with warmup=1 (with the inputs a VLM or an
    encoder-decoder takes, ``modality_inputs``), counted; the loss falls;
    step time, tokens/s (the labeled text tokens) and peak memory."""
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import train_loop
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = train_loop.init_train_state(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.3f} B parameters in "
          f"{cfg.dtype} (random, seed 0), remat={cfg.remat}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = {k: torch.from_numpy(v).cuda() for k, v in {
        **SyntheticLMDataset(vocab=cfg.vocab, seq_len=spec["seq"]).batch(
            0, spec["batch"]),
        **modality_inputs(cfg, spec["batch"], seed=0)}.items()}
    step = train_loop.make_train_step(cfg, opt_cfg=AdamWConfig(), warmup=1,
                                      total_steps=100)
    for fn in lm_counters():
        fn.launches = 0
    losses, auxes, times = [], [], []
    for _ in range(spec["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"{cfg.name}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{cfg.name}: the loss did not fall over "
                                  f"{spec['steps']} steps: {losses}")
    step_s = statistics.median(times[1:])
    tokens = spec["batch"] * spec["seq"]
    print(f"[train] {cfg.name} at batch {spec['batch']} x seq "
          f"{spec['seq']}: {spec['steps']} steps on one repeated batch, "
          f"warmup=1 (with the default warmup of 100 the learning rate is "
          f"too small after a few steps to show a fall): loss "
          f"{' -> '.join(f'{x:.4f}' for x in losses)}"
          + (f"; moe_aux {' -> '.join(f'{x:.4f}' for x in auxes)}"
             if cfg.family == "moe" else "") + "; step "
          f"{step_s * 1e3:.1f} ms (median of steps 2-{spec['steps']}; first"
          f" {times[0] * 1e3:.1f} ms), {tokens / step_s:.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB; launches {counts} on {card}")
    return {"params": params, "opt": opt, "batch": batch, "step": step,
            "out": {"layers": cfg.n_layers, "batch": spec["batch"],
                    "seq": spec["seq"], "losses": losses,
                    "moe_aux": auxes,
                    "step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
                    "tokens_per_s": tokens / step_s, "peak_gb": peak_gb,
                    "launches": counts}}


def train_attention_launches(cfg) -> tuple:
    """(flash_attention_fwd_lse, flash_attention_bwd) launches of one
    training step with remat.  The backward kernel runs once an attention
    block.  The forward runs in the forward and again in the backward's
    recomputation: twice a layer under single-level remat; under the
    two-level remat (``lm._remat_group``: groups of G, 1 < G < n) a third
    time, less the last layer of each group, whose recomputation torch's
    checkpoint stops before (3n − n/G); a hybrid's shared block twice a
    super-block (its super-block's checkpoint).  An encoder-decoder adds
    its encoder's stack, and a decoder layer runs two attention blocks
    (self and cross)."""
    from repro_torch.models import lm
    if cfg.family == "hybrid":
        n_super = lm.hybrid_layout(cfg)[0]
        return 2 * n_super, n_super

    def stack(n):
        g = lm._remat_group(n)
        return 3 * n - n // g if 1 < g < n else 2 * n

    fwd, bwd = stack(cfg.n_layers), cfg.n_layers
    if cfg.enc_dec:
        return (stack(cfg.n_enc_layers) + 2 * fwd,
                cfg.n_enc_layers + 2 * bwd)
    return fwd, bwd


def check_train_launches(cfg, counts: dict, steps: int) -> None:
    fwd, bwd = train_attention_launches(cfg)
    want = {"flash_attention": 0, "flash_attention_fwd_lse": fwd * steps,
            "flash_attention_bwd": bwd * steps, "selective_scan": 0}
    check(counts == want, f"{cfg.name} training launched {counts} in "
                          f"{steps} steps; expected {want}")


def granite_step_split(cfg, run, attn_rows) -> dict:
    """One more granite step split by CUDA events: the forward (loss_fn),
    the backward (autograd.grad, which recomputes each layer under remat)
    and clip + AdamW; the attention kernels' share is n_layers × (2 ×
    fwd_lse + bwd) at the kernel check's times."""
    from repro_torch.checkpoint.ckpt import flatten, unflatten_like
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import train_loop
    params, opt, batch = run["params"], run["opt"], run["batch"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in flatten(params).items()}
    ev[0].record()
    loss, _ = lm.loss_fn(unflatten_like(params, leaves), cfg, batch)
    ev[1].record()
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    ev[2].record()
    train_loop.clip_and_adamw_(flatten(params), grads, opt, AdamWConfig(),
                               1.0, 1.0)
    ev[3].record()
    torch.cuda.synchronize()
    fwd, bwd, optim = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    first = TRAIN_ATTN_CHECKS[0]      # granite's training shape, bf16
    main = {r["kernel"]: r for r in attn_rows
            if (r["B"], r["Hq"], r["Hkv"], r["S"], r["D"], r["causal"],
                r["dtype"]) == first}
    n = cfg.n_layers
    attn_fwd = n * main["flash_attention_fwd_lse"]["ms"]
    attn_bwd = n * (main["flash_attention_fwd_lse"]["ms"]
                    + main["flash_attention_bwd"]["ms"])
    out = {"forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": optim,
           "attention_in_forward_ms": attn_fwd,
           "attention_in_backward_ms": attn_bwd}
    step = fwd + bwd + optim
    print(f"[train] granite-3-2b step split: forward {fwd:.1f} ms (attention"
          f" kernel {attn_fwd:.1f}), backward {bwd:.1f} ms (remat forward "
          f"attention + backward kernel {attn_bwd:.1f}), clip + AdamW "
          f"{optim:.1f} ms ({n} layers; attention at the kernel check's "
          f"times: {100 * (attn_fwd + attn_bwd) / step:.1f} % of the "
          f"{step:.1f} ms split step)")
    return out


def tree_grads(params, cfg, batch) -> tuple:
    from repro_torch.checkpoint.ckpt import flatten, unflatten_like
    from repro_torch.models import lm
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in flatten(params).items()}
    loss, _ = lm.loss_fn(unflatten_like(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@contextlib.contextmanager
def plain_train_path():
    """The comparison arm only: ``attention_train`` calls the training
    kernels' plain versions, on the card, for the duration of the block."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    with mock.patch.object(fops, "flash_attention_fwd_lse",
                           fk.flash_attention_fwd_lse_plain), \
            mock.patch.object(fops, "flash_attention_bwd",
                              fk.flash_attention_bwd_plain):
        yield


def granite_route_agreement(cfg_full, spec) -> dict:
    """granite-3-2b at full width cut to 2 layers: the loss and whole-tree
    gradients of the kernel route against the plain-version route on the
    same weights and batch."""
    import dataclasses
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models import lm
    cfg = dataclasses.replace(cfg_full, n_layers=2)
    params = lm.init_params(cfg, seed=0, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=spec["seq"]).batch(0, spec["batch"]).items()}
    before = read_counts()
    loss_k, g_k = tree_grads(params, cfg, batch)
    after = read_counts()
    check(after["flash_attention_fwd_lse"] - before["flash_attention_fwd_lse"]
          == 2 * cfg.n_layers and after["flash_attention_bwd"]
          - before["flash_attention_bwd"] == cfg.n_layers,
          f"the kernel route launched {before} -> {after}")
    with plain_train_path():
        loss_p, g_p = tree_grads(params, cfg, batch)
    check(read_counts() == after, "the plain route launched a kernel")
    delta = max(float((g_k[k].float() - g_p[k].float()).abs().max())
                for k in g_k)
    scale = max(float(g.float().abs().max()) for g in g_p.values())
    worst_leaf, worst = max(
        ((k, float((g_k[k].float() - g_p[k].float()).abs().max())
          / max(float(g_p[k].float().abs().max()), 1e-30)) for k in g_k),
        key=lambda kv: kv[1])
    rel = delta / scale
    check(all(bool(torch.isfinite(g).all()) for g in g_k.values()),
          "kernel route: non-finite gradients")
    check(rel < TRAIN_GRAD_REL_LIMIT,
          f"kernel vs plain route: max|Δg| / max|g| {rel:.3e} is over "
          f"{TRAIN_GRAD_REL_LIMIT}")
    print(f"[train] granite-3-2b, 2 layers at full width, batch "
          f"{spec['batch']} x {spec['seq']}: kernel route vs plain route "
          f"on the card: loss {loss_k:.6f} vs {loss_p:.6f} (|Δ| "
          f"{abs(loss_k - loss_p):.3g}); whole-tree gradients max|Δ| "
          f"{delta:.4g} = {rel:.3e} of max|g| {scale:.4g} (limit "
          f"{TRAIN_GRAD_REL_LIMIT}); worst leaf {worst_leaf} at {worst:.3e} "
          f"of its max|g|")
    return {"loss_kernel": loss_k, "loss_plain": loss_p,
            "max_abs_diff": delta, "max_abs_grad": scale, "rel_diff": rel,
            "worst_leaf": worst_leaf, "worst_leaf_rel": worst}


def train_cli(card: str) -> dict:
    """``python -m repro_torch.launch.train --smoke`` on the card: three
    steps with a checkpoint, then a resume to step five."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, steps, want in (("first", "3", "done"),
                                  ("resume", "5", "resumed at step 3")):
            args = ["repro_torch.launch.train", "--arch", "granite-3-2b",
                    "--smoke", "--steps", steps, "--ckpt-dir", tmp]
            stdout, wall = run_cli(f"[train] cli {name}", args)
            check(want in stdout and "done" in stdout,
                  f"{' '.join(args)}: no '{want}'")
            print(f"[train] cli: python -m {' '.join(args[:-1])} <tmp> in "
                  f"{wall:.1f} s on {card}")
            out[name] = {"wall_s": wall}
    return out


def phase_lm_train(card: str) -> dict:
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for case in TRAIN_ATTN_CHECKS:     # grad mode on: SDPA's backward is timed
        check_train_attention(fk, case, gen, rows)
        torch.cuda.empty_cache()
    profiled = attention_profile(fk)
    torch.cuda.empty_cache()
    granite_cfg = configs.get_config("granite-3-2b")
    run = train_lm(granite_cfg, GRANITE_TRAIN, card)
    check_train_launches(granite_cfg, run["out"]["launches"],
                         GRANITE_TRAIN["steps"])
    split = granite_step_split(granite_cfg, run, rows)
    granite = dict(run["out"], split=split)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    agreement = granite_route_agreement(granite_cfg, GRANITE_TRAIN)
    gc.collect()
    torch.cuda.empty_cache()
    falcon_cfg = dataclasses.replace(configs.get_config("falcon-mamba-7b"),
                                     n_layers=FALCON_TRAIN["layers"])
    run = train_lm(falcon_cfg, FALCON_TRAIN, card)
    check(all(v == 0 for v in run["out"]["launches"].values()),
          f"falcon-mamba training launched {run['out']['launches']}; it "
          f"trains through the chunked scan, no kernel")
    falcon = run["out"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    cli = train_cli(card)
    return {"kernels": rows, "profile": profiled, "granite": granite,
            "agreement": agreement, "falcon": falcon, "cli": cli}


# ---------------------------------------------------------------------------
# phase 10: the serving fleet with chaos
# ---------------------------------------------------------------------------

# Two tenants submit ragged arrivals (mean FLEET["load"] of a wave a tick,
# split between them, a tick every FLEET["tick_s"]) to a fleet of 2..3
# replicas of Caps-MN1 sharing the card, at phase 4's wave of 100 × 2.
FLEET = dict(requests=2000, load=0.15, tick_s=0.004, replicas=2,
             max_replicas=3)
FLEET_TENANTS = (("gold", 2.0, 1), ("free", None, 0))  # name, SLO s, priority
# the chaos arm's per-replica schedules (``FaultPlan.generate``): replica 0
# errs at its call 1, returns NaN scores at 2, straggles at 3 and crashes at
# 4; replica 1 errs, corrupts and straggles all along (never more than two
# errors in a row, within ``max_wave_retries``); the replacement is clean
CHAOS_PLANS = {
    "default/r0": dict(seed=5, n_waves=6, p_error=0.3, p_corrupt=0.3,
                       p_straggle=0.3, straggle_s=0.02, crash_wave=4),
    "default/r1": dict(seed=3, n_waves=200, p_error=0.1, p_corrupt=0.1,
                       p_straggle=0.1, straggle_s=0.02)}
FLEET_RECORDED_WAVES = 8


def fleet_arm(net, spec, cfg, ds, kernel, label, wave_cache,
              wave_wrap=None) -> dict:
    """One fleet run: the tenants' submitter threads against a started
    ``CapsFleet``, stopped when they are done (``stop()`` drains).  Counts
    the kernel launches of the run alone."""
    from repro_torch.launch import serve_caps as serve_cli
    from repro_torch.runtime.caps_fleet import CapsFleet, TenantPolicy
    from repro_torch.runtime.elastic import ElasticPolicy
    tenants = [TenantPolicy(n, slo_s=slo, priority=pr)
               for n, slo, pr in FLEET_TENANTS]
    fleet = CapsFleet(net, models={"default": (spec, cfg)}, tenants=tenants,
                      policy=ElasticPolicy(min_replicas=FLEET["replicas"],
                                           max_replicas=FLEET["max_replicas"]),
                      control_interval_s=0.05, wave_cache=wave_cache,
                      wave_wrap=wave_wrap)
    schedule = serve_cli.arrival_schedule(
        FLEET["requests"], max(1.0, FLEET["load"] * cfg.wave_lanes))
    n = len(tenants)

    def submitter(i: int):
        for tick, count in enumerate(schedule[i::n]):
            if count:
                fleet.submit(ds.batch(1000 * i + tick, count)["images"],
                             tenant=tenants[i].name)
            time.sleep(FLEET["tick_s"])

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(n)]
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    fleet.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads),
          f"{label}: a submitter thread did not finish")
    s = fleet.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel.launch_counts()
    lost = (s["submitted"] - s["completed"] - s["shed"] - s["failed"]
            - s["pending"])
    check(lost == 0 and s["pending"] == 0,
          f"{label}: {lost} requests lost, {s['pending']} pending: {s}")
    check(s["submitted"] == FLEET["requests"],
          f"{label}: {FLEET['requests']} sent, {s['submitted']} submitted")
    for name, t in s["per_tenant"].items():
        check(t["submitted"] == (t["completed"] + t["shed"] + t["failed"]
                                 + t["pending"]),
              f"{label}: tenant {name}'s books do not balance: {t}")
    check(s["failed"] == 0 and s["shed"] == 0,
          f"{label}: {s['failed']} failed, {s['shed']} shed")
    check(s["evacuated"] == s["adopted"],
          f"{label}: evacuated {s['evacuated']} != adopted {s['adopted']}")
    events = [e for evs in s["scale_events"].values() for e in evs]
    rps = s["completed"] / wall
    print(f"[fleet] {label}: {s['completed']}/{s['submitted']} requests "
          f"completed in {s['waves']} waves over {len(schedule)} ragged "
          f"ticks, {FLEET['replicas']}..{FLEET['max_replicas']} replicas on "
          f"one card ({s['replicas']} at the end, {s['replicas_retired']} "
          f"retired); {rps:.1f} req/s, p50 {s['p50_latency_s'] * 1e3:.2f} "
          f"ms, p90 {s['p90_latency_s'] * 1e3:.2f} ms, wall {wall:.2f} s; "
          f"lost 0, failed {s['failed']}, shed {s['shed']}, goodput "
          f"{s['goodput']}; wave errors {s['wave_errors']}, retried "
          f"{s['retried']}, requeued {s['requeued']}, guard trips "
          f"{s['guard_trips']}, evacuated {s['evacuated']} -> adopted "
          f"{s['adopted']}; launches {counts}")
    for e in events:
        print(f"[fleet] {label}: elastic event {e}")
    for name, t in s["per_tenant"].items():
        print(f"[fleet] {label}: tenant {name}: submitted {t['submitted']}, "
              f"completed {t['completed']}, goodput {t['goodput']}")
    return {"summary": {k: v for k, v in s.items()
                        if k not in ("per_replica",)},
            "wall_s": wall, "req_per_s": rps, "launches": counts,
            "events": events}


def fleet_cli(card: str) -> dict:
    """``serve_caps`` in fleet mode with chaos on the card (``run_cli``):
    Caps-MN1 at full width, two replicas up to three, two tenants."""
    args = ["repro_torch.launch.serve_caps", "--network", "Caps-MN1",
            "--requests", "600", "--microbatch", "100", "--n-micro", "2",
            "--replicas", "2", "--max-replicas", "3", "--tenants", "2",
            "--slo-ms", "2000", "--chaos"]
    stdout, wall = run_cli("[fleet] cli", args)
    check("served 600 requests" in stdout and "chaos:" in stdout,
          f"{' '.join(args)} did not serve cleanly")
    print(f"[fleet] cli: python -m {' '.join(args)} in {wall:.1f} s on "
          f"{card}")
    return {"wall_s": wall}


def phase_fleet(kernel, CAPS, card: str, serve: dict) -> dict:
    """Caps-MN1 at full width behind ``CapsFleet`` on one card: a clean arm
    (the slice's main path, counted) whose wave scores are held to phase
    4's single-server wave function on the same packed waves, and a chaos
    arm under ``faults.fleet_wrap``."""
    from repro_torch.core.router import RouterSpec
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.models.capsnet import CapsNet
    from repro_torch.runtime import caps_serve, faults
    caps_cfg = CAPS["Caps-MN1"]
    net = CapsNet(caps_cfg, device="cuda", seed=0)
    spec = RouterSpec(backend="cuda", iterations=caps_cfg.routing_iters)
    single = caps_serve.ServeConfig(microbatch=100, n_micro=2,
                                    pipeline="software")
    cfg = dataclasses.replace(single, queue_order="deadline")
    ds = SyntheticCapsDataset(caps_cfg.image_hw, caps_cfg.image_channels,
                              caps_cfg.num_h_caps)
    print(f"[fleet] {caps_cfg.name} at full width (random weights, seed 0) "
          f"behind CapsFleet: {FLEET['replicas']}..{FLEET['max_replicas']} "
          f"replicas sharing {card}, tenants {FLEET_TENANTS}, waves of "
          f"{cfg.n_micro} x {cfg.microbatch} deadline-ordered, "
          f"{FLEET['requests']} requests, cuda-backend dynamic routing")

    # one wave function for both arms (the fleet's cache, injected), warmed
    # first, so that neither arm's latencies hold the first waves' set-up
    adapter = caps_serve.CapsAdapter(net, spec)
    wave_cache = {(spec, cfg): adapter.make_wave_fn(cfg)}
    warm = adapter.pack(list(ds.batch(30_000, cfg.wave_lanes)["images"]), cfg)
    for _ in range(3):
        wave_cache[(spec, cfg)](warm)
    torch.cuda.synchronize()
    recorded = []

    def record(name, fn):
        def wave(micro):
            out = fn(micro)
            if len(recorded) < FLEET_RECORDED_WAVES:
                recorded.append((micro, out))
            return out
        return wave

    clean = fleet_arm(net, spec, cfg, ds, kernel, "clean arm", wave_cache,
                      wave_wrap=record)
    check(clean["launches"]["routing_procedure_fused"] > 0,
          "the fleet launched routing_procedure_fused no time")
    check(clean["summary"]["guard_trips"] == 0 and
          clean["summary"]["wave_errors"] == 0,
          f"clean arm: {clean['summary']}")
    wave4 = caps_serve.CapsAdapter(net, spec).make_wave_fn(single)
    worst = 0.0
    for micro, out in recorded:
        worst = max(worst, float((wave4(micro) - out).abs().max()))
    check(worst <= TOL, f"the fleet's wave scores differ from the single "
                        f"server's by {worst:.3g} > {TOL}")
    print(f"[fleet] clean arm: {len(recorded)} recorded waves against phase "
          f"4's single-server wave function on the same packed waves: "
          f"max|Δ score| {worst:.2e} (tol {TOL:g})")

    plans = {name: faults.FaultPlan.generate(kw["seed"], kw["n_waves"],
                                             **{k: v for k, v in kw.items()
                                                if k not in ("seed",
                                                             "n_waves")})
             for name, kw in CHAOS_PLANS.items()}
    registry = {}
    chaos = fleet_arm(net, spec, cfg, ds, kernel, "chaos arm", wave_cache,
                      wave_wrap=faults.fleet_wrap(plans, registry=registry))
    fired = {name: dict(w.fired) for name, w in registry.items()}
    kinds = [k for f in fired.values() for k in f.values()]
    corrupt = kinds.count("corrupt")
    cs = chaos["summary"]
    check(kinds.count("crash") == 1 and len(cs["health_events"]) == 1,
          f"chaos arm: crashes fired {kinds.count('crash')}, burials "
          f"{len(cs['health_events'])}")
    check(corrupt >= 1 and cs["guard_trips"] == corrupt,
          f"chaos arm: {corrupt} corrupt faults fired, {cs['guard_trips']} "
          f"guard trips")
    check(kinds.count("error") >= 1 and cs["wave_errors"] >= 1,
          f"chaos arm: {kinds.count('error')} errors fired, "
          f"{cs['wave_errors']} wave errors")
    print(f"[fleet] chaos arm: faults fired {fired}; one guard trip for "
          f"each of the {corrupt} corrupt faults, the crashed replica "
          f"buried once ({cs['health_events'][0]['evacuated']} evacuated to "
          f"{cs['health_events'][0]['adopted_by']}, restarted as "
          f"{cs['health_events'][0]['restarted']})")
    runs = {r["mode"]: r for r in serve["runs"] if r["fusion"] == "auto"}
    for label, arm in (("clean fleet", clean), ("chaos fleet", chaos)):
        print(f"[fleet] {label}: {arm['req_per_s']:.1f} req/s, p50 "
              f"{arm['summary']['p50_latency_s'] * 1e3:.2f} ms, p90 "
              f"{arm['summary']['p90_latency_s'] * 1e3:.2f} ms beside phase "
              f"4's single server: "
              + "; ".join(f"{m} {r['throughput_rps']:.1f} req/s, p50 "
                          f"{r['p50_latency_s'] * 1e3:.2f} ms, p90 "
                          f"{r['p90_latency_s'] * 1e3:.2f} ms"
                          for m, r in runs.items()))
    return {"clean": clean, "chaos": chaos, "fired": fired,
            "max_abs_score_diff": worst,
            "main_launches": clean["launches"], "cli": fleet_cli(card)}


# ---------------------------------------------------------------------------
# phase 11: MoE serving, qwen3-moe-30b-a3b
# ---------------------------------------------------------------------------

QWEN_SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)
# flash_attention at qwen3-moe's prefill: D = 128, 8 query heads a KV head
QWEN_FLASH = (4, 32, 4, 1024, 128, True, "bf16")
QWEN_CUT_LAYERS = 2        # the kernel route against the plain route
# decode steps timed a model (host-bound steps of 50–200 ms; 16 until the
# script neared its time limit on a slow host)
DECODE_TIMED_STEPS = 8


def moe_prefill_share(lm, L, moe_lib, params, cfg, tokens,
                      prefill_ms) -> dict:
    """The MoE dispatch's share of a prefill: layer 0's MoE on its normed
    input, CUDA events, times n_layers, over the prefill; two calls
    bitwise equal."""
    lp = lm.layer(params["layers"], 0)
    x, _ = lm._embed_inputs(params, cfg, {"tokens": tokens})
    h = L.apply_norm(lp["mlp_norm"], x, cfg.norm_type)
    y1, _ = moe_lib.moe_forward(lp["moe"], h, cfg.moe)
    y2, _ = moe_lib.moe_forward(lp["moe"], h, cfg.moe)
    torch.cuda.synchronize()
    check(torch.equal(y1, y2), "two MoE forwards differ")
    check(bool(torch.isfinite(y1).all()), "the MoE forward is not finite")
    moe_ms = timed_ms(lambda: moe_lib.moe_forward(lp["moe"], h, cfg.moe),
                      runs=5, warmup=1)
    share = cfg.n_layers * moe_ms / prefill_ms
    B, S, _ = x.shape
    print(f"[moe] MoE dispatch at {B} x {S} tokens ({cfg.moe.n_experts} "
          f"experts, top {cfg.moe.top_k}, capacity "
          f"{moe_lib._capacity(B * S, cfg.moe)}): {moe_ms:.3f} ms a layer, "
          f"x {cfg.n_layers} = {cfg.n_layers * moe_ms:.1f} ms, "
          f"{100 * share:.1f} % of the {prefill_ms:.1f} ms prefill; two "
          f"calls bitwise equal")
    return {"moe_layer_ms": moe_ms, "share": share, "bitwise": True}


def moe_decode_share(lm, moe_lib, params, cfg, toks, decode_ms) -> dict:
    """The MoE's share of a decode step: layer 0's MoE at the decode shape
    (one token a lane; the capacity keeps every token in every expert, so
    each expert's weights are read), CUDA events, times n_layers."""
    lp = lm.layer(params["layers"], 0)
    x, _ = lm._embed_inputs(params, cfg, {"tokens": toks})
    moe_ms = timed_ms(lambda: moe_lib.moe_forward(lp["moe"], x, cfg.moe),
                      runs=10)
    share = cfg.n_layers * moe_ms / decode_ms
    print(f"[moe] MoE at decode ({x.shape[0]} tokens, capacity "
          f"{moe_lib._capacity(x.shape[0], cfg.moe)}): {moe_ms:.3f} ms a "
          f"layer, x {cfg.n_layers} = {cfg.n_layers * moe_ms:.1f} ms, "
          f"{100 * share:.1f} % of the {decode_ms:.1f} ms decode step")
    return {"moe_layer_ms": moe_ms, "share": share}


def moe_route_agreement(lm, L, moe_lib, fk, params, cfg, batch,
                        max_len) -> dict:
    """The kernel route against the plain route at full width cut to
    ``QWEN_CUT_LAYERS`` layers.  In fp32 (the same weights, the fp32
    attention kernel) under phase 8's gate (``first_token_agreement``).
    In bf16 the top-8 expert choice is discrete: an attention output that
    differs in its last bf16 bit moves a token whose 8th and 9th router
    scores nearly tie to another expert, and that token's residual by the
    order of itself; max|Δ| / max|logit| is reported beside the number of
    tokens whose layer-0 expert set differs between the routes, and
    ``lib_gate`` at this shape holds the bf16 kernel itself."""
    cut = dataclasses.replace(cfg, n_layers=QWEN_CUT_LAYERS)
    cut_params = {**params, "layers": lm._tree_map(
        lambda t: t[:QWEN_CUT_LAYERS], params["layers"])}
    out = {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        c = dataclasses.replace(cut, dtype=dtype)
        p = lm._tree_map(lambda t: t.to(dtype) if t.dtype == cfg.dtype
                         else t, cut_params)
        fk.flash_attention.launches = 0
        logits_k, _ = lm.prefill(p, c, batch, max_len)
        check(fk.flash_attention.launches == QWEN_CUT_LAYERS,
              f"{label}: the kernel route of the cut did not launch "
              f"flash_attention once a layer")
        with plain_lm_path():
            logits_p, _ = lm.prefill(p, c, batch, max_len)
        name = (f"qwen3-moe-30b-a3b cut to {QWEN_CUT_LAYERS} layers, "
                f"{label}")
        if dtype == torch.float32:
            out[label] = first_token_agreement(name, logits_k, logits_p)
            continue
        lk, lp = logits_k.float(), logits_p.float()
        check(bool(torch.isfinite(lk).all()), f"{name}: non-finite logits")
        delta = float((lk - lp).abs().max())
        lp0 = lm.layer(p["layers"], 0)
        x, pos = lm._embed_inputs(p, c, batch)
        h = L.apply_norm(lp0["attn_norm"], x, c.norm_type)
        sets = []
        for route, ctx in (("kernels", contextlib.nullcontext()),
                           ("plain", plain_lm_path())):
            with ctx:
                a = L.attention_forward(
                    lp0["attn"], h, pos, n_heads=c.n_heads, n_kv=c.n_kv,
                    d_head=c.d_head, rope_theta=c.rope_theta)
            hm = L.apply_norm(lp0["mlp_norm"], x + a, c.norm_type)
            probs = torch.softmax(hm.reshape(-1, c.d_model).float()
                                  @ lp0["moe"]["router"], -1)
            sets.append(torch.sort(moe_lib._top_k(probs, c.moe.top_k)[1],
                                   -1).values)
        flipped = int((sets[0] != sets[1]).any(-1).sum())
        out[label] = {"max_abs_diff": delta,
                      "rel_diff": delta / float(lp.abs().max()),
                      "layer0_tokens_rerouted": flipped,
                      "tokens": sets[0].shape[0]}
        print(f"[moe] {name} prefill logits, kernel route vs plain route: "
              f"max|Δ| {delta:.4g} = {out[label]['rel_diff']:.3e} of "
              f"max|logit| (reported: {flipped} of {sets[0].shape[0]} "
              f"tokens choose another expert set at layer 0 between the "
              f"routes)")
        del p, logits_k, logits_p
    return out


def moe_cli(card: str) -> dict:
    """``serve --arch qwen3-moe-30b-a3b --smoke`` and ``serve_caps --model
    moe --smoke`` on the card (``run_cli``)."""
    out = {}
    for name, args, want in (
            ("serve", ["repro_torch.launch.serve", "--arch",
                       "qwen3-moe-30b-a3b", "--smoke"],
             ["served 8 requests"]),
            ("serve_caps", ["repro_torch.launch.serve_caps", "--model",
                            "moe", "--smoke"],
             ["served 24 requests", "0 failed"])):
        stdout, wall = run_cli(f"[moe] cli {name}", args)
        check(all(w in stdout for w in want),
              f"{' '.join(args)} did not serve cleanly")
        print(f"[moe] cli: python -m {' '.join(args)} in {wall:.1f} s on "
              f"{card}")
        out[name] = {"wall_s": wall}
    return out


def phase_moe(card: str) -> dict:
    """qwen3-moe-30b-a3b at full width and depth, random bf16 weights:
    ``flash_attention`` at its prefill shape by ``lib_gate``; 4 prompts of
    1024 + 32 tokens through ``WaveServer`` and ``LMDecodeAdapter`` (the
    main path, counted: exactly 48 ``flash_attention`` launches a wave);
    time to first token, decode step, generated tokens/s, the MoE
    dispatch's share of a prefill, peak memory; the kernel route against
    the plain route at a 2-layer cut."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.runtime.serve_loop import LMDecodeAdapter
    from repro_torch.runtime.wave_serve import ServeConfig, WaveServer
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(111)
    with torch.inference_mode():
        check_flash(fk, QWEN_FLASH, gen, rows)
    torch.cuda.empty_cache()
    cfg = configs.get_config("qwen3-moe-30b-a3b")
    sv = QWEN_SERVE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    print(f"[moe] {cfg.name} at full width and depth: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv} "
          f"KV heads of {cfg.d_head} (qk-norm, rope θ {cfg.rope_theta:g}), "
          f"{cfg.moe.n_experts} experts top {cfg.moe.top_k} of hidden "
          f"{cfg.moe.d_ff}, vocab {cfg.vocab} padded to {cfg.vocab_padded}, "
          f"{cfg.param_count() / 1e9:.3f} B parameters in {cfg.dtype} "
          f"(random, seed 0), {weights_gb:.2f} GB on the card, made in "
          f"{time.perf_counter() - t0:.1f} s; no depth cut")
    adapter = LMDecodeAdapter(params, cfg, prompt_len=sv["prompt_len"],
                              max_new_tokens=sv["new_tokens"])
    scfg = ServeConfig(microbatch=sv["batch"], n_micro=1, pipeline=None)
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab, (sv["batch"], sv["prompt_len"]), dtype=np.int32)
    warm = adapter.make_wave_fn(scfg)(adapter.pack(list(prompts), scfg))
    server = WaveServer(adapter, cfg=scfg)
    fk.flash_attention.launches = 0
    t0 = time.perf_counter()
    server.submit(prompts)
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fk.flash_attention.launches}
    s = server.metrics.summary()
    check(s["submitted"] == s["completed"] == sv["batch"] and
          server.pending() == 0, f"qwen3-moe books: {s}")
    for key in ("wave_errors", "failed", "guard_trips", "shed"):
        check(s[key] == 0, f"qwen3-moe serving: {key} = {s[key]} "
                           f"({s['last_error']})")
    check(launches["flash_attention"] == cfg.n_layers * s["waves"],
          f"flash_attention launched {launches['flash_attention']} times in "
          f"{s['waves']} waves; expected {cfg.n_layers} per wave")
    outs = np.stack([c.pred for c in sorted(done, key=lambda c: c.rid)])
    check(outs.shape == (sv["batch"], sv["new_tokens"]) and
          outs.min() >= 0 and outs.max() < cfg.vocab_padded,
          f"qwen3-moe completions {outs.shape}, range [{outs.min()}, "
          f"{outs.max()}]")
    check(np.array_equal(outs, warm.astype(np.int32)),
          "the served wave differs from the same wave run before")
    tokens = sv["batch"] * sv["new_tokens"]
    print(f"[moe] qwen3-moe-30b-a3b served {s['completed']} requests (prompt "
          f"{sv['prompt_len']}, +{sv['new_tokens']} tokens) in {s['waves']} "
          f"wave: {tokens / wall:.1f} generated tokens/s, wall {wall:.2f} s; "
          f"wave_errors {s['wave_errors']}, failed {s['failed']}, shed "
          f"{s['shed']}; launches {launches} on {card}")
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    max_len = sv["prompt_len"] + sv["new_tokens"]
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: lm.prefill(params, cfg, batch, max_len),
                             runs=3)
        logits, state = lm.prefill(params, cfg, batch, max_len)
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_TIMED_STEPS):   # each step consumes its state
            logits, state = lm.decode_step(params, cfg, state, toks)
            toks = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TIMED_STEPS
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
        del state, logits
        share = moe_prefill_share(lm, L, moe_lib, params, cfg,
                                  batch["tokens"], prefill_ms)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        decode_moe = moe_decode_share(lm, moe_lib, params, cfg, toks,
                                      decode_ms)
        agreement = moe_route_agreement(lm, L, moe_lib, fk, params, cfg,
                                        batch, max_len)
    print(f"[moe] qwen3-moe-30b-a3b time to first token of {sv['batch']} x "
          f"{sv['prompt_len']} (prefill + first argmax): {prefill_ms:.2f} "
          f"ms; decode {decode_ms:.2f} ms a step ({DECODE_TIMED_STEPS} steps "
          f"timed); peak memory {peak_gb:.2f} GB; on {card}")
    del params, adapter, server
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernels": rows, "launches": launches, "wall_s": wall,
            "tokens_per_s": tokens / wall, "ttft_ms": prefill_ms,
            "decode_step_ms": decode_ms, "moe": share,
            "moe_decode": decode_moe,
            "weights_gb": weights_gb, "peak_gb": peak_gb,
            "agreement": agreement, "cli": moe_cli(card)}


# ---------------------------------------------------------------------------
# phase 12: mixtral-8x7b, MoE training and expert parallelism
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, D, window): mixtral-8x7b's attention at a prompt of two
# windows and at one that is not a multiple of the window (and not of the
# kernels' 64 × 64 tiles at the band's lower edge)
SWA_CHECKS = [(1, 32, 8, 8192, 128, 4096), (1, 32, 8, 6144, 128, 4096)]
# mixtral-8x7b at full width, 24 of its 32 layers: 24 × 1.451 B + 0.262 B
# parameters = 35.09 B, 70.2 GB in bf16, beside the window's cache (0.8 GB
# at 2 × 4096 slots) and the prefill's MoE buffers on the 80 GB card; all
# 32 layers (93.4 GB) do not fit
MIXTRAL_SERVE = dict(layers=24, batch=2, prompt_len=6144, new_tokens=32)
# the rolling cache against a full windowed forward: a 2-layer cut in fp32,
# every token kept (capacity factor n_experts / top_k), prompts of 1.5 and
# 2 windows, 8 decode steps each
ROLL_CHECK = dict(layers=2, batch=1, prompts=(6144, 8192), steps=8)
ROLL_REL_LIMIT = 1e-4
# qwen3-moe-30b-a3b trains 6 of its 48 layers at full width: 6 × 0.623 B +
# 0.622 B = 4.36 B parameters, about 12 bytes each with bf16 gradients and
# AdamW's fp32 moments (52 GB), at batch 4 × 1024 with remat
QWEN_TRAIN = dict(layers=6, batch=4, seq=1024, steps=5)
# the training kernels at qwen3-moe's shape: D = 128, 8 query heads a KV
# head
QWEN_TRAIN_ATTN = (4, 32, 4, 1024, 128, True, "bf16")
# kernel route against plain route, qwen3-moe at full width cut to 2
# layers, batch 4 × 1024, fp32: whole-tree gradients max|Δ| / max|g|
# measured 2.77e-6 on the H100, no token rerouted at layer 0; ten times
# that, rounded up, still fails a reroute (bf16: 1.7e-1 with 117 tokens
# rerouted) or a kernel fault
MOE_GRAD_REL_LIMIT = 3e-5
# the expert-parallel dispatch: one qwen3-moe MoE layer at full width on 4
# × 1024 tokens over 2 gloo ranks sharing the card, 64 experts a rank
EP = dict(ranks=2, tokens=4096, seed=5)
EP_RUNS = 5


def band_pairs(S: int, window) -> int:
    """(row, key) pairs a causal attention over S positions computes under
    ``window`` (None: the whole lower triangle)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def band_mask(S: int, window: int, device="cuda") -> torch.Tensor:
    """The (S, S) boolean band, True where row r attends key c: c ≤ r and
    c > r − window."""
    return torch.ones(S, S, dtype=torch.bool, device=device).tril().triu(
        1 - window)


def check_swa_attention(fk, case, gen, rows, tag: str = "mixtral") -> None:
    """The windowed flash-attention kernels at one shape, fp32 and bf16:
    ``flash_attention``, ``flash_attention_fwd_lse`` (o, lse) and
    ``flash_attention_bwd`` (dq, dk, dv).  fp32 held to the plain versions
    (``lm_close``, ``grouped_close``); bf16 by ``lib_gate`` against
    float64, the library being SDPA with an explicit boolean band mask on
    expanded KV heads (its autograd backward for dq, dk, dv; the
    memory-efficient op with the band as an additive bias for lse), and
    the plain rounding model under the same gate.  Window = S equals
    causal bitwise; two calls bitwise equal.  Times: the three kernels
    (CUDA events, and the device time in bf16), the unwindowed forward at
    the same shape, the plain versions, the bound and the library."""
    B, Hq, Hkv, S, D, W = case
    group = Hq // Hkv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    band = band_mask(S, W)
    pairs = band_pairs(S, W)
    for dt in ("fp32", "bf16"):
        dtype = LM_DTYPES[dt]
        q, do = (torch.randn(B, Hq, S, D, generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        label = f"swa {case} {dt}"
        before = read_counts()
        o_s = fk.flash_attention(q, k, v, window=W)
        o, lse = fk.flash_attention_fwd_lse(q, k, v, window=W)
        grads = fk.flash_attention_bwd(q, k, v, o, lse, do, window=W)
        again = (fk.flash_attention(q, k, v, window=W),
                 *fk.flash_attention_fwd_lse(q, k, v, window=W),
                 *fk.flash_attention_bwd(q, k, v, o, lse, do, window=W))
        torch.cuda.synchronize()
        after = read_counts()
        check(all(after[n] - before[n] == 2 for n in (
            "flash_attention", "flash_attention_fwd_lse",
            "flash_attention_bwd")), f"{label}: the launch counters moved "
                                     f"{before} -> {after}")
        check(all(torch.equal(a, b) for a, b in zip(
            (o_s, o, lse, *grads), again)), f"{label}: two calls differ")
        del again
        # a window of S is the causal function, bitwise
        oc, lc = fk.flash_attention_fwd_lse(q, k, v)
        ow, lw = fk.flash_attention_fwd_lse(q, k, v, window=S)
        check(torch.equal(fk.flash_attention(q, k, v, window=S),
                          fk.flash_attention(q, k, v)) and
              torch.equal(oc, ow) and torch.equal(lc, lw) and
              all(torch.equal(a, b) for a, b in zip(
                  fk.flash_attention_bwd(q, k, v, oc, lc, do),
                  fk.flash_attention_bwd(q, k, v, oc, lc, do, window=S))),
              f"{label}: window = S differs from causal")
        del oc, lc, ow, lw
        kx, vx = (t.repeat_interleave(group, dim=1) for t in (k, v))
        if dtype == torch.bfloat16:
            exact = attention_f64(q, k, v, True, do, window=W)
            bias = torch.zeros(B, Hq, S, S, dtype=dtype, device="cuda")
            bias.masked_fill_(~band, float("-inf"))
            lib_o, lib_lse = torch.ops.aten._scaled_dot_product_efficient_attention(
                q, kx, vx, bias, True)[:2]
            del bias
            qg, kg, vg = (t.detach().clone().requires_grad_(True)
                          for t in (q, kx, vx))
            with torch.enable_grad():
                o_lib = sdpa(qg, kg, vg, attn_mask=band)
                ldq, ldk, ldv = torch.autograd.grad(o_lib, (qg, kg, vg), do)
            del qg, kg, vg, o_lib
            lib = {"o": lib_o, "lse": lib_lse[..., :S].float(), "dq": ldq,
                   "dk": ldk.float().view(B, Hkv, group, S, D).sum(2)
                   .to(dtype),
                   "dv": ldv.float().view(B, Hkv, group, S, D).sum(2)
                   .to(dtype)}
            del ldk, ldv
            m_o, m_lse = fk.flash_attention_fwd_lse_plain(
                q, k, v, window=W, block_q=64, block_k=64,
                round_operands=True)
            model = {"o": m_o, "lse": m_lse, **dict(zip(
                ("dq", "dk", "dv"), fk.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, window=W, block_q=64, block_k=64,
                    round_operands=True)))}
            got = {"o": o, "lse": lse, **dict(zip(("dq", "dk", "dv"),
                                                   grads))}
            gates, errs = {}, {}
            gates["o_serving"] = lib_gate(f"{label} flash_attention o", o_s,
                                          lib["o"], exact["o"])
            errs["o_serving"] = float((o_s.float() - model["o"].float())
                                      .abs().max())
            for name in got:
                gates[name] = lib_gate(f"{label} {name}", got[name],
                                       lib[name], exact[name])
                lib_gate(f"{label} {name} plain rounding model", model[name],
                         lib[name], exact[name])
                errs[name] = float((got[name].float() - model[name].float())
                                   .abs().max())
            del exact, lib, model, got
            extra = {"gate": gates}
            note = "; ".join(f"{n} gate {gate_line(g)}"
                             for n, g in gates.items())
        else:
            p_o, p_lse = fk.flash_attention_fwd_lse_plain(q, k, v, window=W)
            dq_p, dk_h, dv_h = fk.flash_attention_bwd_heads_plain(
                q, k, v, o, lse, do, window=W)
            errs = {"o_serving": lm_close(f"{label} flash_attention o", o_s,
                                          p_o),
                    "o": lm_close(f"{label} o", o, p_o),
                    "lse": lm_close(f"{label} lse", lse, p_lse),
                    "dq": lm_close(f"{label} dq", grads[0], dq_p)}
            for name, g, heads in (("dk", grads[1], dk_h),
                                   ("dv", grads[2], dv_h)):
                errs[name] = grouped_close(f"{label} {name}", g,
                                           fk.group_sum(heads, Hkv, dtype),
                                           heads)
            del p_o, p_lse, dq_p, dk_h, dv_h
            extra, note = {}, ""
        ms = {"flash_attention": timed_ms(
                  lambda: fk.flash_attention(q, k, v, window=W)),
              "flash_attention_fwd_lse": timed_ms(
                  lambda: fk.flash_attention_fwd_lse(q, k, v, window=W)),
              "flash_attention_bwd": timed_ms(
                  lambda: fk.flash_attention_bwd(q, k, v, o, lse, do,
                                                 window=W))}
        causal_ms = timed_ms(lambda: fk.flash_attention(q, k, v))
        plain = {"flash_attention": lambda: fk.flash_attention_plain(
                     q, k, v, window=W),
                 "flash_attention_fwd_lse":
                     lambda: fk.flash_attention_fwd_lse_plain(q, k, v,
                                                              window=W),
                 "flash_attention_bwd": lambda: fk.flash_attention_bwd_plain(
                     q, k, v, o, lse, do, window=W)}
        # one call each: a plain call at S = 8192 takes about 1.2 s
        plain_ms = {n: timed_ms(fn, runs=1, warmup=0)
                    for n, fn in plain.items()}
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, kx, vx))
        with torch.enable_grad():
            o_lib = sdpa(qg, kg, vg, attn_mask=band)
            lib_ms = {"flash_attention": timed_ms(
                          lambda: sdpa(q, kx, vx, attn_mask=band)),
                      "flash_attention_bwd": timed_ms(
                          lambda: torch.autograd.grad(
                              o_lib, (qg, kg, vg), do, retain_graph=True))}
        lib_ms["flash_attention_fwd_lse"] = lib_ms["flash_attention"]
        del qg, kg, vg, o_lib, kx, vx
        item = q.element_size()
        flops = 4.0 * B * Hq * D * pairs   # q·kᵀ and p·v multiply-adds
        rate = attention_rate(dtype, D)
        lse_bytes = B * Hq * S * 4
        bounds = {"flash_attention": bound(
                      (2 * q.numel() + 2 * k.numel()) * item, flops, rate),
                  "flash_attention_fwd_lse": bound(
                      (2 * q.numel() + 2 * k.numel()) * item + lse_bytes,
                      flops, rate),
                  "flash_attention_bwd": bound(
                      (4 * q.numel() + 4 * k.numel()) * item + lse_bytes,
                      BWD_FLOP_FACTOR * flops, rate)}
        dev = {}
        if dtype == torch.bfloat16:
            calls = {"flash_attention":
                     lambda: fk.flash_attention(q, k, v, window=W),
                     "flash_attention_fwd_lse":
                     lambda: fk.flash_attention_fwd_lse(q, k, v, window=W),
                     "flash_attention_bwd":
                     lambda: fk.flash_attention_bwd(q, k, v, o, lse, do,
                                                    window=W)}
            dev = {n: device_ms(fn, runs=10, bound_ms=bounds[n][0])
                   for n, fn in calls.items()}
        err_of = {"flash_attention": errs["o_serving"],
                  "flash_attention_fwd_lse": max(errs["o"], errs["lse"]),
                  "flash_attention_bwd": max(errs["dq"], errs["dk"],
                                             errs["dv"])}
        for n in ms:
            rows.append({"kernel": n, "B": B, "Hq": Hq, "Hkv": Hkv, "S": S,
                         "D": D, "causal": True, "window": W, "dtype": dt,
                         "pairs": pairs, "max_abs_err": err_of[n],
                         "ms": ms[n],
                         "device_ms": dev[n]["ms"] if dev else None,
                         "plain_ms": plain_ms[n], "bound_ms": bounds[n][0],
                         "bound_by": bounds[n][1], "library_ms": lib_ms[n],
                         **({"unwindowed_ms": causal_ms}
                            if n == "flash_attention" else {}), **extra})
            print(f"[{tag}] {n} B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} window"
                  f" {W} {dt}: max|Δ|{' from the plain rounding model' if dev else ''}"
                  f" {err_of[n]:.2e}, two calls bitwise equal, window = S "
                  f"bitwise causal; kernel {ms[n]:.4f} ms (device "
                  f"{dev_note(dev[n]) if dev else 'not measured in fp32'})"
                  f"  plain {plain_ms[n]:.2f} ms  bound {bounds[n][0]:.4f} ms"
                  f" ({bounds[n][1]}, {pairs / 1e6:.2f} M pairs)  library "
                  f"{lib_ms[n]:.4f} ms (kernel {ms[n] / lib_ms[n]:.2f}×)")
        print(f"[{tag}]   windowed forward {ms['flash_attention']:.4f} ms "
              f"against the unwindowed causal forward {causal_ms:.4f} ms at "
              f"the same shape: {ms['flash_attention'] / causal_ms:.3f}× "
              f"(pairs {pairs / band_pairs(S, None):.3f}×)")
        if note:
            print(f"[{tag}]   {label}: {note}")
        del q, k, v, do, o, lse, grads, o_s
        torch.cuda.empty_cache()


def mixtral_serve(card: str) -> dict:
    """mixtral-8x7b at full width cut to 24 of 32 layers, random bf16
    weights: 2 prompts of 6144 tokens + 32 generated through ``WaveServer``
    and ``LMDecodeAdapter`` (the main path, counted: exactly n_layers
    ``flash_attention`` launches a wave, windowed); the prompt crosses the
    window, so decode starts on a wrapped, rolling cache.  Time to first
    token, decode step, tokens/s, the MoE dispatch's share of a prefill
    and of a decode step, peak memory."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.runtime.serve_loop import LMDecodeAdapter
    from repro_torch.runtime.wave_serve import ServeConfig, WaveServer
    sv = MIXTRAL_SERVE
    full = configs.get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=sv["layers"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    print(f"[mixtral] {cfg.name} at full width: {cfg.n_layers} of "
          f"{full.n_layers} layers (all {full.n_layers}, "
          f"{full.param_count() / 1e9:.2f} B parameters, take "
          f"{2 * full.param_count() / 1e9:.1f} GB in bf16), d_model "
          f"{cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv} KV "
          f"heads of {cfg.d_head}, sliding window {cfg.sliding_window}, "
          f"{cfg.moe.n_experts} experts top {cfg.moe.top_k} of hidden "
          f"{cfg.moe.d_ff} in {cfg.moe.sub_experts} slices, "
          f"{cfg.param_count() / 1e9:.3f} B parameters (random, seed 0), "
          f"{weights_gb:.2f} GB on the card, made in "
          f"{time.perf_counter() - t0:.1f} s")
    adapter = LMDecodeAdapter(params, cfg, prompt_len=sv["prompt_len"],
                              max_new_tokens=sv["new_tokens"])
    scfg = ServeConfig(microbatch=sv["batch"], n_micro=1, pipeline=None)
    prompts = np.random.default_rng(12).integers(
        0, cfg.vocab, (sv["batch"], sv["prompt_len"]), dtype=np.int32)
    warm = adapter.make_wave_fn(scfg)(adapter.pack(list(prompts), scfg))
    server = WaveServer(adapter, cfg=scfg)
    fk.flash_attention.launches = 0
    t0 = time.perf_counter()
    server.submit(prompts)
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fk.flash_attention.launches}
    s = server.metrics.summary()
    check(s["submitted"] == s["completed"] == sv["batch"] and
          server.pending() == 0, f"mixtral books: {s}")
    for key in ("wave_errors", "failed", "guard_trips", "shed"):
        check(s[key] == 0, f"mixtral serving: {key} = {s[key]} "
                           f"({s['last_error']})")
    check(launches["flash_attention"] == cfg.n_layers * s["waves"],
          f"flash_attention launched {launches['flash_attention']} times in "
          f"{s['waves']} waves; expected {cfg.n_layers} per wave")
    outs = np.stack([c.pred for c in sorted(done, key=lambda c: c.rid)])
    check(outs.shape == (sv["batch"], sv["new_tokens"]) and
          outs.min() >= 0 and outs.max() < cfg.vocab_padded,
          f"mixtral completions {outs.shape}, range [{outs.min()}, "
          f"{outs.max()}]")
    check(np.array_equal(outs, warm.astype(np.int32)),
          "the served wave differs from the same wave run before")
    tokens = sv["batch"] * sv["new_tokens"]
    print(f"[mixtral] served {s['completed']} requests (prompt "
          f"{sv['prompt_len']}, +{sv['new_tokens']} tokens; cache "
          f"{lm._cache_len(cfg, sv['prompt_len'] + sv['new_tokens'])} slots "
          f"rolling from the first step) in {s['waves']} wave: "
          f"{tokens / wall:.1f} generated tokens/s, wall {wall:.2f} s; "
          f"wave_errors {s['wave_errors']}, failed {s['failed']}, shed "
          f"{s['shed']}; launches {launches} on {card}")
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    max_len = sv["prompt_len"] + sv["new_tokens"]
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: lm.prefill(params, cfg, batch, max_len),
                             runs=3)
        logits, state = lm.prefill(params, cfg, batch, max_len)
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_TIMED_STEPS):   # each step consumes its state
            logits, state = lm.decode_step(params, cfg, state, toks)
            toks = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TIMED_STEPS
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
        del state, logits
        share = moe_prefill_share(lm, L, moe_lib, params, cfg,
                                  batch["tokens"], prefill_ms)
        decode_moe = moe_decode_share(lm, moe_lib, params, cfg, toks,
                                      decode_ms)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[mixtral] time to first token of {sv['batch']} x "
          f"{sv['prompt_len']} (prefill + first argmax): {prefill_ms:.2f} "
          f"ms; decode {decode_ms:.2f} ms a step ({DECODE_TIMED_STEPS} steps "
          f"timed); peak memory {peak_gb:.2f} GB; on {card}")
    del params, adapter, server
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "launches": launches, "wall_s": wall,
            "tokens_per_s": tokens / wall, "ttft_ms": prefill_ms,
            "decode_step_ms": decode_ms, "moe": share,
            "moe_decode": decode_moe, "weights_gb": weights_gb,
            "peak_gb": peak_gb}


def mixtral_rolling_check() -> dict:
    """mixtral-8x7b at full width cut to 2 layers, fp32, every token kept
    (capacity factor n_experts / top_k, so only the window can differ
    between two token counts): for prompts of 6144 and 8192 tokens, each
    of 8 greedy decode steps' logits against the last row of a full
    windowed forward over the same tokens on the plain route, under
    ``ROLL_REL_LIMIT`` of max|logit|; each prompt on a fresh state.  The
    kernel route's prefill logits against the plain route's under phase
    8's gate."""
    from repro_torch import configs
    from repro_torch.models import lm
    full = configs.get_config("mixtral-8x7b")
    rc = ROLL_CHECK
    cfg = dataclasses.replace(
        full, n_layers=rc["layers"], dtype=torch.float32,
        moe=full.moe._replace(
            capacity_factor=full.moe.n_experts / full.moe.top_k))
    params = lm.init_params(cfg, seed=3, device="cuda")
    out = {}
    with torch.inference_mode():
        for S in rc["prompts"]:
            toks = torch.from_numpy(np.random.default_rng(S).integers(
                0, cfg.vocab, (rc["batch"], S), dtype=np.int32)).cuda()
            max_len = S + rc["steps"]
            logits, state = lm.prefill(params, cfg, {"tokens": toks},
                                       max_len)
            plain, _ = lm.prefill(params, cfg, {"tokens": toks}, max_len,
                                  route="plain")
            route = first_token_agreement(
                f"mixtral-8x7b cut to {rc['layers']} layers, fp32, S={S}",
                logits, plain)
            seq, errs = toks, []
            for _ in range(rc["steps"]):
                nxt = logits.argmax(-1).to(torch.int32)[:, None]
                seq = torch.cat([seq, nxt], dim=1)
                logits, state = lm.decode_step(params, cfg, state, nxt)
                want, _ = lm.prefill(params, cfg, {"tokens": seq},
                                     seq.shape[1], route="plain")
                errs.append(float((logits - want).abs().max())
                            / float(want.abs().max()))
            worst = max(errs)
            print(f"[mixtral] rolling cache, {rc['layers']} layers fp32, "
                  f"prompt {S} (window {cfg.sliding_window}, cache "
                  f"{state.kv[0].shape[2]} slots): {rc['steps']} decode "
                  f"steps against a full windowed forward on the plain "
                  f"route, max|Δ| / max|logit| per step "
                  f"{', '.join(f'{e:.2e}' for e in errs)} (limit "
                  f"{ROLL_REL_LIMIT:g})")
            check(worst < ROLL_REL_LIMIT,
                  f"rolling cache at S={S}: {worst:.3e} of max|logit|")
            out[S] = {"rel_errs": errs, "prefill_route": route}
            del state, logits, plain
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_layer0_sets(lm, L, moe_lib, params, cfg, batch) -> torch.Tensor:
    """Each token's sorted layer-0 expert set under the current route."""
    lp0 = lm.layer(params["layers"], 0)
    x, pos = lm._embed_inputs(params, cfg, batch)
    h = L.apply_norm(lp0["attn_norm"], x, cfg.norm_type)
    a = L.attention_forward(lp0["attn"], h, pos, n_heads=cfg.n_heads,
                            n_kv=cfg.n_kv, d_head=cfg.d_head,
                            rope_theta=cfg.rope_theta, route="train")
    hm = L.apply_norm(lp0["mlp_norm"], x + a, cfg.norm_type)
    probs = torch.softmax(hm.reshape(-1, cfg.d_model).float()
                          @ lp0["moe"]["router"], -1)
    return torch.sort(moe_lib._top_k(probs, cfg.moe.top_k)[1], -1).values


def moe_train_agreement(cfg_full, spec) -> dict:
    """qwen3-moe-30b-a3b at full width cut to 2 layers, batch 4 × 1024:
    the loss and whole-tree gradients of the kernel route against the
    plain-version route on the same weights.  fp32 under
    ``MOE_GRAD_REL_LIMIT``; bf16 reported beside the number of tokens
    whose layer-0 expert set differs between the routes (the top-8 choice
    is discrete)."""
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    cut = dataclasses.replace(cfg_full, n_layers=2)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
        vocab=cut.vocab, seq_len=spec["seq"]).batch(0, spec["batch"]).items()}
    out = {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = dataclasses.replace(cut, dtype=dtype)
        params = lm.init_params(cfg, seed=0, device="cuda")
        before = read_counts()
        loss_k, g_k = tree_grads(params, cfg, batch)
        after = read_counts()
        check(after["flash_attention_fwd_lse"]
              - before["flash_attention_fwd_lse"] == 2 * cfg.n_layers
              and after["flash_attention_bwd"]
              - before["flash_attention_bwd"] == cfg.n_layers,
              f"{label}: the kernel route launched {before} -> {after}")
        with plain_train_path():
            loss_p, g_p = tree_grads(params, cfg, batch)
        check(read_counts() == after, "the plain route launched a kernel")
        with torch.no_grad():
            sets_k = moe_layer0_sets(lm, L, moe_lib, params, cfg, batch)
            with plain_train_path():
                sets_p = moe_layer0_sets(lm, L, moe_lib, params, cfg, batch)
        rerouted = int((sets_k != sets_p).any(-1).sum())
        delta = max(float((g_k[k].float() - g_p[k].float()).abs().max())
                    for k in g_k)
        scale = max(float(g.float().abs().max()) for g in g_p.values())
        rel = delta / scale
        check(all(bool(torch.isfinite(g).all()) for g in g_k.values()),
              f"{label}: non-finite gradients on the kernel route")
        out[label] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                      "max_abs_diff": delta, "max_abs_grad": scale,
                      "rel_diff": rel, "layer0_tokens_rerouted": rerouted,
                      "tokens": sets_k.shape[0]}
        print(f"[moe-train] qwen3-moe-30b-a3b cut to 2 layers, {label}, "
              f"batch {spec['batch']} x {spec['seq']}: kernel route vs plain"
              f" route: loss {loss_k:.6f} vs {loss_p:.6f}; whole-tree "
              f"gradients max|Δ| {delta:.4g} = {rel:.3e} of max|g| "
              f"{scale:.4g}"
              + (f" (limit {MOE_GRAD_REL_LIMIT:g})" if dtype == torch.float32
                 else " (reported)")
              + f"; {rerouted} of {sets_k.shape[0]} tokens choose another "
              f"expert set at layer 0 between the routes")
        if dtype == torch.float32:
            check(rel < MOE_GRAD_REL_LIMIT,
                  f"fp32 kernel vs plain route: {rel:.3e} of max|g|")
        del params, g_k, g_p
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_train_cli(card: str) -> dict:
    """``python -m repro_torch.launch.train --arch mixtral-8x7b --smoke``
    on the card (``run_cli``)."""
    args = ["repro_torch.launch.train", "--arch", "mixtral-8x7b", "--smoke",
            "--steps", "3"]
    stdout, wall = run_cli("[moe-train] cli", args)
    check("moe_aux" in stdout and "done" in stdout,
          f"{' '.join(args)} did not report its aux and finish")
    print(f"[moe-train] cli: python -m {' '.join(args)} in {wall:.1f} s on "
          f"{card}")
    return {"wall_s": wall}


def qwen_moe_train(card: str) -> dict:
    """The training kernels at qwen3-moe's shape by ``lib_gate`` beside the
    library; qwen3-moe-30b-a3b at full width cut to 6 of 48 layers, batch 4
    × 1024, remat, 5 steps (the main path, counted:
    ``train_attention_launches``, 15 ``flash_attention_fwd_lse`` and 6
    ``flash_attention_bwd`` launches a step); the loss falls; moe_aux,
    step time, tokens/s, peak memory."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(122)
    check_train_attention(fk, QWEN_TRAIN_ATTN, gen, rows)
    torch.cuda.empty_cache()
    full = configs.get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(full, n_layers=QWEN_TRAIN["layers"])
    run = train_lm(cfg, QWEN_TRAIN, card)
    check_train_launches(cfg, run["out"]["launches"], QWEN_TRAIN["steps"])
    aux = run["out"]["moe_aux"][-1]
    check(all(np.isfinite(run["out"]["moe_aux"])) and aux > 0,
          f"moe_aux {run['out']['moe_aux']}")
    print(f"[moe-train] {cfg.name} ({cfg.n_layers} of {full.n_layers} "
          f"layers): moe_aux {aux:.4f} at the last step (the sum over "
          f"{cfg.n_layers} layers of E·Σ mean(p)·f, {aux / cfg.n_layers:.4f} "
          f"a layer against {cfg.moe.top_k} when balanced)")
    out = run["out"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    agreement = moe_train_agreement(full, QWEN_TRAIN)
    return {"kernels": rows, "qwen": out, "agreement": agreement,
            "cli": moe_train_cli(card)}


def _ep_worker(argv: list) -> None:
    """One of two gloo ranks sharing the card: one qwen3-moe MoE layer at
    full width (128 experts top 8, d_model 2048, hidden 768), the same
    seeded weights and 4 × 1024 tokens on both ranks, through the Router's
    "E"-sharded plan (64 experts a rank, y psum'd) against this rank's own
    1-rank dispatch, fp32 and bf16; dispatch times, sharded and not, and
    the psum of y alone.  Writes ``ep<r>.json``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
    from repro_torch.models import moe as moe_lib
    from repro_torch.runtime import mesh_utils
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp, rank = argv[0], dist.get_rank()
    cfg = configs.get_config("qwen3-moe-30b-a3b").moe
    mesh = mesh_utils.make_mesh((EP["ranks"],), ("expert",),
                                device="cuda")
    spec = RouterSpec(algorithm="moe", options=(("moe_cfg", cfg),))
    sharded = build_router(spec, ExecutionPlan(
        mesh=mesh, axes=(("E", "expert"),)), device="cuda")
    whole = build_router(spec, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(EP["seed"])
    params = moe_lib.init_moe(gen, cfg, dtype=torch.float32,
                              device="cuda")
    x = torch.randn(EP["tokens"], cfg.d_model, generator=gen,
                    device="cuda")
    res = {"rank": rank, "e_local": cfg.n_shards_experts // EP["ranks"]}
    with torch.inference_mode():
        for label, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            args = (x.to(dtype), *moe_lib.router_args(
                {k: (v if k == "router" else v.to(dtype))
                 for k, v in params.items()}))
            y, aux = sharded(*args)
            y1, aux1 = whole(*args)
            torch.cuda.synchronize()
            ys = max(1.0, float(y1.float().abs().max()))
            res[label] = {
                "err": float((y.float() - y1.float()).abs().max()),
                "scale": ys, "aux": float(aux), "aux_whole": float(aux1),
                "finite": bool(torch.isfinite(y).all()),
                "sharded_ms": host_ms(lambda: sharded(*args),
                                      runs=EP_RUNS),
                "whole_ms": host_ms(lambda: whole(*args), runs=EP_RUNS)}
            with mesh_utils.active(mesh):
                res[label]["psum_ms"] = host_ms(
                    lambda: mesh_utils.psum(y, "expert"), runs=EP_RUNS)
    with open(os.path.join(tmp, f"ep{rank}.json"), "w") as f:
        json.dump(res, f)


def expert_parallel(card: str) -> dict:
    """Two gloo ranks on the one card (``repro_torch.launch.ranks``): the
    E-sharded dispatch within 1e-5·max(1, max|y|) of the 1-rank dispatch in
    fp32 with the same aux; bf16 reported; the dispatch's time beside the
    unsharded one and the collective's share.  A rank that fails fails the
    phase; every rank is stopped."""
    import tempfile
    from repro_torch.launch import ranks
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks.run(_ep_worker, [tmp], EP["ranks"], "cuda",
                   timeout_s=RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(EP["ranks"]):
            with open(os.path.join(tmp, f"ep{r}.json")) as f:
                ranks.append(json.load(f))
    for res in ranks:
        for label in ("fp32", "bf16"):
            d = res[label]
            print(f"[ep] rank {res['rank']}: qwen3-moe MoE layer, "
                  f"{EP['tokens']} tokens, {res['e_local']} experts a rank "
                  f"over {EP['ranks']} gloo ranks sharing the card, {label}:"
                  f" y max|Δ| vs the 1-rank dispatch {d['err']:.3e} "
                  f"({d['err'] / d['scale']:.2e} of max(1, max|y|)), aux "
                  f"{d['aux']:.6f} vs {d['aux_whole']:.6f}; dispatch "
                  f"{d['sharded_ms']:.2f} ms sharded (psum of y alone "
                  f"{d['psum_ms']:.2f} ms, {100 * d['psum_ms'] / d['sharded_ms']:.0f} %)"
                  f" against {d['whole_ms']:.2f} ms unsharded")
            check(d["finite"], f"rank {res['rank']} {label}: non-finite y")
        d = res["fp32"]
        check(d["err"] <= TOL * d["scale"] and d["aux"] == d["aux_whole"],
              f"rank {res['rank']}: the E-sharded dispatch is {d['err']:.3g}"
              f" from the 1-rank one (aux {d['aux']} vs {d['aux_whole']})")
    print(f"[ep] {EP['ranks']} gloo ranks on {card}: passed in {wall:.1f} s")
    return {"ranks": ranks, "wall_s": wall}


def phase_mixtral(card: str) -> dict:
    """Phase 12: the windowed attention kernels, mixtral-8x7b served at
    full width on a rolling cache, the rolling cache against a full
    windowed forward, qwen3-moe-30b-a3b trained with the aux loss, and the
    expert-parallel dispatch on two ranks."""
    from repro_torch.kernels.flash_attention import kernel as fk
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(121)
    for case in SWA_CHECKS:
        check_swa_attention(fk, case, gen, rows)
    serve = mixtral_serve(card)
    rolling = mixtral_rolling_check()
    train = qwen_moe_train(card)
    ep = expert_parallel(card)
    return {"kernels": rows, "serve": serve, "rolling": rolling,
            "train": train, "ep": ep}


# ---------------------------------------------------------------------------
# phase 13: phi3-medium-14b, mistral-large-123b, stablelm-12b, zamba2-7b
# ---------------------------------------------------------------------------

SLICE11_ARCHS = ("phi3-medium-14b", "mistral-large-123b", "stablelm-12b",
                 "zamba2-7b")
SLICE11_SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)
# mistral-large-123b's 88 layers are 122.61 B parameters, 245 GB in bf16;
# 24 of them, 24 × 1.3841 B + 0.805 B of embeddings = 34.03 B (68.1 GB),
# leave room for the 0.4 GB cache and the prefill's MLP buffers on the 80 GB
# card.  The others serve at full depth.
SLICE11_LAYERS = {"mistral-large-123b": 24}
# flash_attention at each one's prefill (B, Hq, Hkv, S, D, causal, dtype):
# D = 128 (phi3: 4 query heads a KV head; mistral-large: 12), stablelm's
# D = 160 (4 a KV head), zamba2's D = 112 (no grouping)
SLICE11_FLASH = {"phi3-medium-14b": (4, 40, 10, 1024, 128, True, "bf16"),
                 "mistral-large-123b": (4, 96, 8, 1024, 128, True, "bf16"),
                 "stablelm-12b": (4, 32, 8, 1024, 160, True, "bf16"),
                 "zamba2-7b": (4, 32, 32, 1024, 112, True, "bf16")}
# the windowed kernels at the new head dims, small (B, Hq, Hkv, S, D,
# window); no model of this slice has a window, the kernels take one
NEW_DIM_SWA = [(1, 4, 2, 200, 112, 64), (1, 4, 2, 200, 160, 48)]
# the kernel route against the plain route: 2 layers of the dense ones,
# one super-block (6 layers) of zamba2, at full width in bf16
SLICE11_CUT = {"zamba2-7b": 6}
# zamba2's decode against a full forward: fp32 at full width, 15 layers (2
# super-blocks and a tail of 3), one prompt of 1024, 8 greedy steps
ZAMBA_DECODE = dict(layers=15, batch=1, prompt=1024, steps=8)
ZAMBA_DECODE_REL_LIMIT = 1e-4
# training at batch 4 × 1024, remat, 5 steps on one repeated batch; with
# bf16 weights and gradients and AdamW's fp32 moments about 12 bytes a
# parameter: stablelm-12b 8 of 40 layers (3.25 B, ≈ 39 GB), zamba2-7b 15
# of 81 (2 super-blocks and a tail of 3; 39 layers, 7.2 s a step in its
# plain SSD chunk loop, until the script passed 1100 s on a slow host)
SLICE11_TRAIN = {"stablelm-12b": dict(layers=8, batch=4, seq=1024,
                                      steps=5),
                 "zamba2-7b": dict(layers=15, batch=4, seq=1024, steps=5)}


def attention_calls(cfg) -> int:
    """Attention blocks a forward runs: a hybrid's shared block once a
    super-block; an encoder-decoder's encoder layers, and two a decoder
    layer (self and cross attention)."""
    from repro_torch.models import lm
    if cfg.family == "hybrid":
        return lm.hybrid_layout(cfg)[0]
    return cfg.n_enc_layers + 2 * cfg.n_layers if cfg.enc_dec \
        else cfg.n_layers


def cut_params(lm, params, cfg, n_layers: int) -> tuple:
    """The config and parameter views of the first ``n_layers`` layers (a
    hybrid's: its first super-blocks, no tail; an encoder-decoder's
    encoder cut alike, ``configs.with_layers``)."""
    from repro_torch import configs
    check(n_layers <= cfg.n_layers, f"a cut of {n_layers} layers of "
                                    f"{cfg.n_layers}")
    cut = configs.with_layers(cfg, n_layers)
    if cfg.family == "hybrid":
        n_super = lm.hybrid_layout(cut)[0]
        p = {k: v for k, v in params.items() if k != "tail"}
        p["blocks"] = lm._tree_map(lambda t: t[:n_super], params["blocks"])
        return cut, p
    p = {**params, "layers": lm._tree_map(lambda t: t[:n_layers],
                                          params["layers"])}
    if cfg.enc_dec:
        p["encoder"] = {**params["encoder"], "layers": lm._tree_map(
            lambda t: t[:cut.n_enc_layers], params["encoder"]["layers"])}
    return cut, p


def ssd_prefill_share(lm, L, ssm, params, cfg, tokens, prefill) -> dict:
    """zamba2's Mamba-2 layers in a prefill: every Mamba-2 block of the
    model run back to back on the embedded prompt, and their SSD cores
    (the plain chunk loop) on layer 0's conv output, CUDA events around
    the whole stack (the blocks are launch-bound, so a block timed alone
    holds the host's gaps the stack overlaps), over the prefill timed
    just before them (``prefill()``; launch-bound times drift with the
    host's load over a run)."""
    n_super, tail = lm.hybrid_layout(cfg)
    blocks = [lm.layer(lm.layer(params["blocks"], s), j)
              for s in range(n_super) for j in range(cfg.attn_every)]
    blocks += [lm.layer(params["tail"], j) for j in range(tail)]
    x, _ = lm._embed_inputs(params, cfg, {"tokens": tokens})
    mp = blocks[0]["mamba"]
    h = L.apply_norm(blocks[0]["norm"], x, cfg.norm_type)
    xin, _ = (h @ mp["in_proj"]).chunk(2, dim=-1)
    xc, _ = ssm._causal_conv(xin, mp["conv_w"], mp["conv_b"])
    xc = torch.nn.functional.silu(xc.float()).to(h.dtype)

    def stack():
        for lp in blocks:
            lm._ssm_block_fwd(lp, x, cfg)

    def cores():
        for lp in blocks:
            ssm._ssm_core_m2(lp["mamba"], xc, cfg.ssm, None,
                             chunk=lm.SSM_CHUNK)
    prefill_ms = timed_ms(prefill, runs=3, warmup=1)
    stack_ms = timed_ms(stack, runs=3, warmup=1)
    core_ms = timed_ms(cores, runs=3, warmup=1)
    out = {"prefill_ms": prefill_ms, "mamba_stack_ms": stack_ms,
           "ssd_cores_ms": core_ms,
           "mamba_share": stack_ms / prefill_ms,
           "ssd_share": core_ms / prefill_ms}
    print(f"[slice11] zamba2-7b Mamba-2 layers in the prefill: the "
          f"{len(blocks)} blocks back to back {stack_ms:.1f} ms "
          f"({100 * out['mamba_share']:.1f} % of the {prefill_ms:.1f} ms "
          f"prefill), their SSD chunk loops alone {core_ms:.1f} ms "
          f"({100 * out['ssd_share']:.1f} %; plain PyTorch: the reference "
          f"has no SSD kernel)")
    return out


def serve_slice11(arch: str, attn_row: dict, card: str) -> dict:
    """One configuration of this slice at full width (mistral-large cut to
    ``SLICE11_LAYERS``), random bf16 weights: 4 prompts of 1024 + 32 tokens
    in one wave through ``WaveServer`` and ``LMDecodeAdapter`` (the main
    path, counted: exactly one ``flash_attention`` launch an attention
    block a wave); time to first token, decode step, generated tokens/s,
    peak memory, the attention kernel's share of a prefill (zamba2: the
    Mamba-2 layers' too); the kernel route against the plain route at a
    cut (phase 8's gate)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers as L
    from repro_torch.models import lm, ssm
    from repro_torch.runtime.serve_loop import LMDecodeAdapter
    from repro_torch.runtime.wave_serve import ServeConfig, WaveServer
    sv = SLICE11_SERVE
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=SLICE11_LAYERS[arch]) \
        if arch in SLICE11_LAYERS else full
    meta_b = cfg.param_count() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    shape = (f"{cfg.n_layers} Mamba-2 layers (d_inner {cfg.ssm.d_inner}, "
             f"{cfg.ssm.n_heads} SSM heads of {cfg.ssm.headdim}, d_state "
             f"{cfg.ssm.d_state}) and a shared attention block after every "
             f"{cfg.attn_every}" if cfg.family == "hybrid"
             else f"{cfg.n_layers} layers")
    cut = (f" of {full.n_layers} (all {full.n_layers}: "
           f"{full.param_count() / 1e9:.2f} B parameters, "
           f"{2 * full.param_count() / 1e9:.1f} GB in bf16)"
           if cfg.n_layers != full.n_layers else ", no depth cut")
    print(f"[slice11] {arch} at full width: {shape}{cut}, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv} KV "
          f"heads of {cfg.d_head}, d_ff {cfg.d_ff}, {cfg.norm_type} norm, "
          f"vocab {cfg.vocab}, {meta_b:.3f} B parameters (param_count on "
          f"the meta device) in {cfg.dtype} (random, seed 0), "
          f"{weights_gb:.2f} GB on the card, made in "
          f"{time.perf_counter() - t0:.1f} s")
    adapter = LMDecodeAdapter(params, cfg, prompt_len=sv["prompt_len"],
                              max_new_tokens=sv["new_tokens"])
    scfg = ServeConfig(microbatch=sv["batch"], n_micro=1, pipeline=None)
    prompts = np.random.default_rng(13).integers(
        0, cfg.vocab, (sv["batch"], sv["prompt_len"]), dtype=np.int32)
    warm = adapter.make_wave_fn(scfg)(adapter.pack(list(prompts), scfg))
    server = WaveServer(adapter, cfg=scfg)
    for fn in lm_counters():
        fn.launches = 0
    t0 = time.perf_counter()
    server.submit(prompts)
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    s = server.metrics.summary()
    check(s["submitted"] == s["completed"] == sv["batch"] and
          server.pending() == 0, f"{arch} books: {s}")
    for key in ("wave_errors", "failed", "guard_trips", "shed"):
        check(s[key] == 0, f"{arch} serving: {key} = {s[key]} "
                           f"({s['last_error']})")
    n_attn = attention_calls(cfg)
    check(launches == {"flash_attention": n_attn * s["waves"],
                       "flash_attention_fwd_lse": 0,
                       "flash_attention_bwd": 0, "selective_scan": 0},
          f"{arch} launched {launches} in {s['waves']} waves; expected "
          f"{n_attn} flash_attention launches a wave")
    outs = np.stack([c.pred for c in sorted(done, key=lambda c: c.rid)])
    check(outs.shape == (sv["batch"], sv["new_tokens"]) and
          outs.min() >= 0 and outs.max() < cfg.vocab_padded,
          f"{arch} completions {outs.shape}, range [{outs.min()}, "
          f"{outs.max()}]")
    check(np.array_equal(outs, warm.astype(np.int32)),
          f"{arch}: the served wave differs from the same wave run before")
    tokens = sv["batch"] * sv["new_tokens"]
    print(f"[slice11] {arch} served {s['completed']} requests (prompt "
          f"{sv['prompt_len']}, +{sv['new_tokens']} tokens) in {s['waves']} "
          f"wave: {tokens / wall:.1f} generated tokens/s, wall {wall:.2f} s; "
          f"wave_errors {s['wave_errors']}, failed {s['failed']}, shed "
          f"{s['shed']}; launches {launches} on {card}")
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    max_len = sv["prompt_len"] + sv["new_tokens"]
    out = {"layers": cfg.n_layers, "params_b": meta_b,
           "launches": launches, "wall_s": wall,
           "tokens_per_s": tokens / wall, "weights_gb": weights_gb}
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: lm.prefill(params, cfg, batch, max_len),
                             runs=3)
        logits, state = lm.prefill(params, cfg, batch, max_len)
        check(state.kv[0].shape[0] == n_attn,
              f"{arch}: {state.kv[0].shape[0]} KV caches for {n_attn} "
              f"attention blocks")
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_TIMED_STEPS):   # each step consumes its state
            logits, state = lm.decode_step(params, cfg, state, toks)
            toks = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TIMED_STEPS
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
        del state, logits
        attn_share = n_attn * attn_row["ms"] / prefill_ms
        print(f"[slice11] {arch} time to first token of {sv['batch']} x "
              f"{sv['prompt_len']} (prefill + first argmax): "
              f"{prefill_ms:.2f} ms, the attention kernel {n_attn} x "
              f"{attn_row['ms']:.4f} ms = {100 * attn_share:.1f} % of it; "
              f"decode {decode_ms:.2f} ms a step ({DECODE_TIMED_STEPS} "
              f"steps timed); on {card}")
        out.update(ttft_ms=prefill_ms, decode_step_ms=decode_ms,
                   attention_share=attn_share)
        if cfg.family == "hybrid":
            out["mamba"] = ssd_prefill_share(
                lm, L, ssm, params, cfg, batch["tokens"],
                lambda: lm.prefill(params, cfg, batch, max_len))
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        c_cfg, c_params = cut_params(lm, params, cfg,
                                     SLICE11_CUT.get(arch, 2))
        logits_k, _ = lm.prefill(c_params, c_cfg, batch, max_len)
        with plain_lm_path():
            logits_p, _ = lm.prefill(c_params, c_cfg, batch, max_len)
        out["agreement"] = first_token_agreement(
            f"{arch} cut to {c_cfg.n_layers} layers, bf16", logits_k,
            logits_p)
        del logits_k, logits_p, c_params
    print(f"[slice11] {arch}: peak memory {out['peak_gb']:.2f} GB "
          f"(weights {weights_gb:.2f} GB)")
    del params, adapter, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zamba_decode_check() -> dict:
    """zamba2-7b at full width cut to ``ZAMBA_DECODE`` layers (super-blocks
    and a tail), fp32: each of 8 greedy decode steps' logits against the
    last row of a full forward over the prompt and the tokens generated so
    far on the plain route, under ``ZAMBA_DECODE_REL_LIMIT`` of
    max|logit|; the kernel route's prefill against the plain route's
    (phase 8's gate)."""
    from repro_torch import configs
    from repro_torch.models import lm
    zc = ZAMBA_DECODE
    cfg = dataclasses.replace(configs.get_config("zamba2-7b"),
                              n_layers=zc["layers"], dtype=torch.float32)
    params = lm.init_params(cfg, seed=4, device="cuda")
    with torch.inference_mode():
        toks = torch.from_numpy(np.random.default_rng(14).integers(
            0, cfg.vocab, (zc["batch"], zc["prompt"]),
            dtype=np.int32)).cuda()
        max_len = zc["prompt"] + zc["steps"]
        logits, state = lm.prefill(params, cfg, {"tokens": toks}, max_len)
        plain, _ = lm.prefill(params, cfg, {"tokens": toks}, max_len,
                              route="plain")
        route = first_token_agreement(
            f"zamba2-7b cut to {cfg.n_layers} layers, fp32", logits, plain)
        seq, errs = toks, []
        for _ in range(zc["steps"]):
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            seq = torch.cat([seq, nxt], dim=1)
            logits, state = lm.decode_step(params, cfg, state, nxt)
            want, _ = lm.prefill(params, cfg, {"tokens": seq}, seq.shape[1],
                                 route="plain")
            errs.append(float((logits - want).abs().max())
                        / float(want.abs().max()))
    n_super, tail = lm.hybrid_layout(cfg)
    print(f"[slice11] zamba2-7b decode, {cfg.n_layers} layers ({n_super} "
          f"super-blocks, tail {tail}) fp32, prompt {zc['prompt']}: "
          f"{zc['steps']} decode steps against a full forward on the plain "
          f"route, max|Δ| / max|logit| per step "
          f"{', '.join(f'{e:.2e}' for e in errs)} (limit "
          f"{ZAMBA_DECODE_REL_LIMIT:g})")
    check(max(errs) < ZAMBA_DECODE_REL_LIMIT,
          f"zamba2 decode: {max(errs):.3e} of max|logit|")
    del params, state, logits, plain
    gc.collect()
    torch.cuda.empty_cache()
    return {"rel_errs": errs, "prefill_route": route}


def train_slice11(arch: str, card: str) -> dict:
    """stablelm-12b or zamba2-7b at full width cut to ``SLICE11_TRAIN``'s
    layers, batch 4 × 1024, remat, 5 steps (the main path, counted:
    ``train_attention_launches``)."""
    from repro_torch import configs
    spec = SLICE11_TRAIN[arch]
    cfg = dataclasses.replace(configs.get_config(arch),
                              n_layers=spec["layers"])
    run = train_lm(cfg, spec, card)
    check_train_launches(cfg, run["out"]["launches"], spec["steps"])
    out = dict(run["out"], params_b=cfg.param_count() / 1e9)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def granite_single_level(card: str, two_level: dict) -> dict:
    """The comparison arm of the two-level remat: granite-3-2b's phase 9
    training run again with every layer checkpointed once
    (``lm._remat_group`` patched to 1 inside this script only), beside
    phase 9's two-level run (groups of 5)."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get_config("granite-3-2b")
    with mock.patch.object(lm, "_remat_group", lambda n: 1):
        run = train_lm(cfg, GRANITE_TRAIN, card)
    n = cfg.n_layers * GRANITE_TRAIN["steps"]
    check(run["out"]["launches"]["flash_attention_fwd_lse"] == 2 * n,
          f"single-level remat launched {run['out']['launches']}")
    single = run["out"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    g = lm._remat_group(cfg.n_layers)
    print(f"[slice11] granite-3-2b training, batch {GRANITE_TRAIN['batch']} "
          f"x {GRANITE_TRAIN['seq']}: two-level remat (groups of {g}, "
          f"{cfg.n_layers // g} + {g} layer inputs kept) "
          f"{two_level['step_ms']:.1f} ms a step, peak "
          f"{two_level['peak_gb']:.2f} GB; single-level ({cfg.n_layers} "
          f"kept) {single['step_ms']:.1f} ms, peak {single['peak_gb']:.2f} "
          f"GB: {two_level['step_ms'] / single['step_ms']:.3f}× the time, "
          f"{single['peak_gb'] - two_level['peak_gb']:.2f} GB less")
    return {"single_level": single, "two_level_step_ms":
            two_level["step_ms"], "two_level_peak_gb": two_level["peak_gb"]}


def phase_slice11(card: str, lm_train: dict) -> dict:
    """Phase 13: the flash-attention kernels at D = 112 and 160 (windowed,
    and at each served model's prefill shape), phi3-medium-14b,
    mistral-large-123b (cut), stablelm-12b and zamba2-7b served, zamba2's
    decode against a full forward, stablelm and zamba2 trained, granite's
    training under single-level remat beside phase 9's two-level run."""
    from repro_torch.kernels.flash_attention import kernel as fk
    t0 = time.perf_counter()
    rows, train_rows = [], []
    gen = torch.Generator(device="cuda").manual_seed(131)
    for case in NEW_DIM_SWA:
        check_swa_attention(fk, case, gen, rows, tag="slice11")
    with torch.inference_mode():
        for arch in SLICE11_ARCHS:
            check_flash(fk, SLICE11_FLASH[arch], gen, rows)
    for arch in SLICE11_TRAIN:        # grad mode on: SDPA's backward is timed
        check_train_attention(fk, SLICE11_FLASH[arch], gen, train_rows)
    torch.cuda.empty_cache()
    serve = {}
    for arch in SLICE11_ARCHS:
        key = SLICE11_FLASH[arch]
        row = next(r for r in rows if r["kernel"] == "flash_attention" and
                   (r["B"], r["Hq"], r["Hkv"], r["S"], r["D"]) == key[:5])
        serve[arch] = serve_slice11(arch, row, card)
    decode = zamba_decode_check()
    train = {arch: train_slice11(arch, card) for arch in SLICE11_TRAIN}
    remat = granite_single_level(card, lm_train["granite"])
    print(f"[phase 13] {time.perf_counter() - t0:.1f} s")
    return {"kernels": rows + train_rows, "serve": serve,
            "zamba_decode": decode, "train": train, "remat": remat}



# ---------------------------------------------------------------------------
# phase 14: llava-next-mistral-7b (VLM), seamless-m4t-large-v2 (enc-dec)
# ---------------------------------------------------------------------------

PHASE14_ARCHS = ("llava-next-mistral-7b", "seamless-m4t-large-v2")
# the three flash kernels at Sk ≠ Sq (bidirectional cross attention), as
# (B, Hq, Hkv, (Sq, Sk), D, causal, dtype): seamless-m4t-large-v2's cross
# attention (4 × 1024 text rows over 4096 encoder frames, 16 heads of 64)
# in bf16 and fp32, odd pairs with fewer and with more keys than queries at
# D = 64, 128 and 160 in both dtypes, and a GQA case (32 query heads over 8)
SEAMLESS_CROSS = (4, 16, 16, (1024, 4096), 64, False, "bf16")
CROSS_CHECKS = [SEAMLESS_CROSS, SEAMLESS_CROSS[:6] + ("fp32",),
                *((1, 4, 2, sqk, d, False, dt)
                  for sqk in ((37, 200), (333, 129)) for d in (64, 128, 160)
                  for dt in ("fp32", "bf16")),
                (2, 32, 8, (256, 1000), 128, False, "bf16")]
# each served model's other prefill attention shapes (the attention share),
# which its training runs too (4 rows of 1024 text tokens): llava's 2304
# image + 1024 text positions, causal; seamless's encoder over 4096 frames,
# bidirectional, and its decoder's causal self-attention
PREFILL_FLASH = {"llava-next-mistral-7b": [(4, 32, 8, 3328, 128, True,
                                            "bf16")],
                 "seamless-m4t-large-v2": [(4, 16, 16, 4096, 64, False,
                                            "bf16"),
                                           (4, 16, 16, 1024, 64, True,
                                            "bf16"), SEAMLESS_CROSS]}
# serving: 4 requests of 1024 text tokens + 32 generated, llava's with
# 2304 image tokens before the text, seamless's over 4096 frames
PHASE14_SERVE = dict(batch=4, prompt_len=1024, new_tokens=32)
# decode against a full forward: fp32 at full width, 4 layers (seamless: 4
# encoder and 4 decoder), one prompt of 512 text tokens, 8 greedy steps
PHASE14_DECODE = dict(layers=4, batch=1, prompt=512, steps=8)
PHASE14_DECODE_REL_LIMIT = 1e-4
# training, batch 4 × 1024 text tokens, remat, 5 steps on one repeated
# batch: seamless at full depth (24 + 24 layers, 2.04 B parameters, ≈ 24 GB
# at 12 bytes a parameter); llava cut to 12 of 32 layers (2.88 B, ≈ 35 GB)
# with its 2304 image tokens a row
PHASE14_TRAIN = {"llava-next-mistral-7b": dict(layers=12, batch=4, seq=1024,
                                               steps=5),
                 "seamless-m4t-large-v2": dict(layers=24, batch=4, seq=1024,
                                               steps=5)}


def modality_inputs(cfg, batch: int, seed: int) -> dict:
    """The inputs a VLM or an encoder-decoder takes beside its tokens, as
    numpy arrays: the stub frontends' (``data.synthetic.modality_stubs``:
    seamless's normal frames), a VLM's image embeddings drawn normal at
    the token embeddings' scale (0.02) rather than the CLI's zeros, so that
    image positions differ and ``img_proj`` gets a gradient."""
    from repro_torch.data.synthetic import modality_stubs
    out = modality_stubs(cfg, batch, seed=seed + 1)
    if "image_embeds" in out:
        out["image_embeds"] = 0.02 * np.random.default_rng(
            seed + 2).standard_normal(out["image_embeds"].shape,
                                      dtype=np.float32)
    return out


def lm_inputs(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """A served batch on the card: random prompts and
    ``modality_inputs``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, prompt_len),
                                  dtype=np.int32),
           **modality_inputs(cfg, batch, seed)}
    return {k: torch.from_numpy(v).cuda() for k, v in out.items()}


def image_tokens(cfg) -> int:
    return cfg.n_img_tokens if cfg.family == "vlm" else 0


def cross_profile(fk) -> dict:
    """Device time of the three kernels at seamless's cross shape in bf16
    (``device_ms`` over 10 calls each, against each one's bound), beside
    the CUDA-event times of the kernel checks.  Late in a long run the
    profiler often shows too few of the calls, and the time is then "not
    measured"; ``scripts/kernel_ab.py`` times the same shape in a process
    of its own."""
    B, Hq, Hkv, Sq, Sk, D, _, _ = case_dims(SEAMLESS_CROSS)
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, do = (torch.randn(B, Hq, Sq, D, generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    o, lse = fk.flash_attention_fwd_lse(q, k, v, causal=False)
    flops = 4.0 * B * Hq * D * Sq * Sk
    b_fwd = bound((2 * q.numel() + 2 * k.numel()) * 2, flops,
                  BF16_FLOP_PER_S)[0]
    b_bwd = bound((4 * q.numel() + 4 * k.numel()) * 2 + B * Hq * Sq * 4,
                  BWD_FLOP_FACTOR * flops, BF16_FLOP_PER_S)[0]
    calls = {"flash_attention": (lambda: fk.flash_attention(
                 q, k, v, causal=False), b_fwd),
             "flash_attention_fwd_lse": (lambda: fk.flash_attention_fwd_lse(
                 q, k, v, causal=False), b_fwd),
             "flash_attention_bwd": (lambda: fk.flash_attention_bwd(
                 q, k, v, o, lse, do, causal=False), b_bwd)}
    out = {}
    for name, (fn, b_ms) in calls.items():
        dev = device_ms(fn, runs=10, bound_ms=b_ms)
        out[name] = {"device_ms": dev["ms"], "event_ms": dev["event_ms"],
                     "bound_ms": b_ms}
        print(f"[phase14] {name} at seamless's cross shape (B={B}, H={Hq}, "
              f"Sq={Sq}, Sk={Sk}, D={D}, bf16): device {dev_note(dev)}, "
              f"event {dev['event_ms']:.4f} ms, bound {b_ms:.4f} ms")
    return out


def serve_phase14(arch: str, attn_rows: list, card: str) -> dict:
    """One model at full width and depth, random bf16 weights: 4 requests
    through ``serve_loop.generate`` (the main path, counted: one
    ``flash_attention`` launch an attention block, ``attention_calls``),
    generated tokens/s, time to first token, decode step, peak memory,
    attention's share of a prefill at the kernel checks' times; the kernel
    route against the plain route at 2 layers (phase 8's gate)."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop
    sv = PHASE14_SERVE
    cfg = configs.get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    n_img = image_tokens(cfg)
    shape = (f"{cfg.n_enc_layers} encoder layers over {cfg.source_len} "
             f"frames and {cfg.n_layers} decoder layers with cross "
             f"attention" if cfg.enc_dec else
             f"{cfg.n_layers} layers, {n_img} image tokens a request")
    print(f"[phase14] {arch} at full width: {shape}, d_model {cfg.d_model}, "
          f"{cfg.n_heads} query heads over {cfg.n_kv} KV heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, {cfg.norm_type} norm, vocab "
          f"{cfg.vocab}, {cfg.param_count() / 1e9:.3f} B parameters in "
          f"{cfg.dtype} (random, seed 0), {weights_gb:.2f} GB on the card, "
          f"made in {time.perf_counter() - t0:.1f} s")
    batch = lm_inputs(cfg, sv["batch"], sv["prompt_len"], seed=19)
    warm, _ = serve_loop.generate(params, cfg, batch, sv["new_tokens"])
    for fn in lm_counters():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = serve_loop.generate(params, cfg, batch, sv["new_tokens"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_attn = attention_calls(cfg)
    check(launches == {"flash_attention": n_attn,
                       "flash_attention_fwd_lse": 0,
                       "flash_attention_bwd": 0, "selective_scan": 0},
          f"{arch} launched {launches} in one generate; expected {n_attn} "
          f"flash_attention launches")
    check(tuple(out.shape) == (sv["batch"], sv["new_tokens"]) and
          bool(stats.finite.all()) and int(out.min()) >= 0 and
          int(out.max()) < cfg.vocab_padded,
          f"{arch} generated {tuple(out.shape)}, finite "
          f"{stats.finite.tolist()}")
    check(torch.equal(out, warm), f"{arch}: two generations differ")
    tokens = sv["batch"] * sv["new_tokens"]
    print(f"[phase14] {arch} generated {sv['batch']} x {sv['new_tokens']} "
          f"tokens after prompts of {n_img} + {sv['prompt_len']}: "
          f"{tokens / wall:.1f} generated tokens/s, wall {wall:.2f} s; "
          f"launches {launches} on {card}")
    res = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "params_b": cfg.param_count() / 1e9, "weights_gb": weights_gb,
           "launches": launches, "wall_s": wall,
           "tokens_per_s": tokens / wall}
    max_len = n_img + sv["prompt_len"] + sv["new_tokens"]
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: lm.prefill(params, cfg, batch, max_len),
                             runs=3)
        logits, state = lm.prefill(params, cfg, batch, max_len)
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_TIMED_STEPS):   # each step consumes its state
            logits, state = lm.decode_step(params, cfg, state, toks)
            toks = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TIMED_STEPS
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
        del state, logits
        # attention's time in a prefill: each shape's kernel check time ×
        # its blocks (seamless: encoder, decoder self, cross, a layer each)
        shapes = PREFILL_FLASH[arch]
        per = [next(r["ms"] for r in attn_rows
                    if r["kernel"] == "flash_attention" and
                    (r["B"], r["Hq"], r["Hkv"], r["S"], r["Sk"], r["D"],
                     r["causal"]) == case_dims(c)[:7]) for c in shapes]
        counts = ([cfg.n_enc_layers, cfg.n_layers, cfg.n_layers]
                  if cfg.enc_dec else [cfg.n_layers])
        attn_ms = sum(n * ms for n, ms in zip(counts, per))
        res.update(ttft_ms=prefill_ms, decode_step_ms=decode_ms,
                   attention_ms=attn_ms, attention_share=attn_ms / prefill_ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[phase14] {arch} time to first token of {sv['batch']} x "
              f"({n_img} + {sv['prompt_len']}) (prefill + first argmax): "
              f"{prefill_ms:.2f} ms, attention kernels "
              f"{' + '.join(f'{n} x {ms:.4f}' for n, ms in zip(counts, per))}"
              f" ms = {100 * res['attention_share']:.1f} % of it; decode "
              f"{decode_ms:.2f} ms a step ({DECODE_TIMED_STEPS} steps timed); "
              f"peak memory {res['peak_gb']:.2f} GB (weights "
              f"{weights_gb:.2f} GB); on {card}")
        c_cfg, c_params = cut_params(lm, params, cfg, 2)
        logits_k, _ = lm.prefill(c_params, c_cfg, batch, max_len)
        with plain_lm_path():
            logits_p, _ = lm.prefill(c_params, c_cfg, batch, max_len)
        res["agreement"] = first_token_agreement(
            f"{arch} cut to {c_cfg.n_layers} layers"
            + (f" (and {c_cfg.n_enc_layers} encoder layers)"
               if cfg.enc_dec else "") + ", bf16", logits_k, logits_p)
        del logits_k, logits_p, c_params
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def decode_check14(arch: str) -> dict:
    """The model at full width cut to ``PHASE14_DECODE`` layers, fp32: each
    of 8 greedy decode steps' logits against the last row of a full
    forward on the plain route over the same inputs (llava's image tokens,
    seamless's frames) and the tokens so far, under
    ``PHASE14_DECODE_REL_LIMIT`` of max|logit|; ``serve_loop.generate``,
    which sizes the cache itself (llava: n_img + prompt + generated),
    gives the same tokens."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.runtime import serve_loop
    dc = PHASE14_DECODE
    cfg = configs.with_layers(dataclasses.replace(
        configs.get_config(arch), dtype=torch.float32), dc["layers"])
    params = lm.init_params(cfg, seed=4, device="cuda")
    inputs = lm_inputs(cfg, dc["batch"], dc["prompt"], seed=23)
    n_img = image_tokens(cfg)
    with torch.inference_mode():
        logits, state = lm.prefill(params, cfg, inputs,
                                   n_img + dc["prompt"] + dc["steps"])
        seq, errs, fed = inputs["tokens"], [], []
        for _ in range(dc["steps"]):
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            fed.append(nxt)
            seq = torch.cat([seq, nxt], dim=1)
            logits, state = lm.decode_step(params, cfg, state, nxt)
            want, _ = lm.prefill(params, cfg, {**inputs, "tokens": seq},
                                 n_img + seq.shape[1], route="plain")
            errs.append(float((logits - want).abs().max())
                        / float(want.abs().max()))
        fed.append(logits.argmax(-1).to(torch.int32)[:, None])
        gen, _ = serve_loop.generate(params, cfg, inputs, dc["steps"] + 1)
    what = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers "
            f"over {cfg.source_len} frames" if cfg.enc_dec else
            f"{cfg.n_layers} layers after {n_img} image tokens")
    print(f"[phase14] {arch} decode, {what}, fp32, prompt {dc['prompt']}: "
          f"{dc['steps']} decode steps against a full forward on the plain "
          f"route, max|Δ| / max|logit| per step "
          f"{', '.join(f'{e:.2e}' for e in errs)} (limit "
          f"{PHASE14_DECODE_REL_LIMIT:g}); generate's tokens "
          f"{'equal' if torch.equal(gen, torch.cat(fed, 1)) else 'differ'}")
    check(max(errs) < PHASE14_DECODE_REL_LIMIT,
          f"{arch} decode: {max(errs):.3e} of max|logit|")
    check(torch.equal(gen, torch.cat(fed, 1)),
          f"{arch}: generate's tokens differ from prefill + decode's")
    del params, state, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"rel_errs": errs, "layers": cfg.n_layers,
            "enc_layers": cfg.n_enc_layers}


def train_phase14(arch: str, card: str) -> dict:
    """``PHASE14_TRAIN``'s cut, batch 4 × 1024 text tokens (llava's rows
    with 2304 image tokens before them, seamless's over 4096 frames),
    remat, 5 steps (the main path, counted: ``train_attention_launches``)."""
    from repro_torch import configs
    spec = PHASE14_TRAIN[arch]
    cfg = configs.with_layers(configs.get_config(arch), spec["layers"])
    run = train_lm(cfg, spec, card)
    check_train_launches(cfg, run["out"]["launches"], spec["steps"])
    out = dict(run["out"], params_b=cfg.param_count() / 1e9,
               enc_layers=cfg.n_enc_layers)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_vlm_encdec(card: str) -> dict:
    """Phase 14: the three flash-attention kernels at Sk ≠ Sq, and
    llava-next-mistral-7b and seamless-m4t-large-v2 served at full width,
    their decode against a full forward, and trained."""
    from repro_torch.kernels.flash_attention import kernel as fk
    t0 = time.perf_counter()
    rows, train_rows = [], []
    gen = torch.Generator(device="cuda").manual_seed(141)
    with torch.inference_mode():
        for case in CROSS_CHECKS + PREFILL_FLASH[PHASE14_ARCHS[0]] + \
                PREFILL_FLASH[PHASE14_ARCHS[1]][:2]:
            check_flash(fk, case, gen, rows)
            torch.cuda.empty_cache()
    # the training kernels at Sk ≠ Sq, then at the shapes the two trained
    # models run (the cross shape is among the first); the plain versions,
    # 0.1–0.6 s a call at the models' shapes, timed over 3 calls there
    for case in CROSS_CHECKS:         # grad mode on: SDPA's backward is timed
        check_train_attention(fk, case, gen, train_rows)
        torch.cuda.empty_cache()
    for case in PREFILL_FLASH[PHASE14_ARCHS[0]] + \
            PREFILL_FLASH[PHASE14_ARCHS[1]][:2]:
        check_train_attention(fk, case, gen, train_rows,
                              plain_timing=dict(runs=3, warmup=1))
        torch.cuda.empty_cache()
    profile = cross_profile(fk)
    torch.cuda.empty_cache()
    serve = {arch: serve_phase14(arch, rows, card) for arch in PHASE14_ARCHS}
    decode = {arch: decode_check14(arch) for arch in PHASE14_ARCHS}
    train = {arch: train_phase14(arch, card) for arch in PHASE14_ARCHS}
    print(f"[phase 14] {time.perf_counter() - t0:.1f} s")
    return {"kernels": rows + train_rows, "cross_profile": profile,
            "serve": serve, "decode": decode, "train": train}


# ---------------------------------------------------------------------------
# phase 15: the sharding tables, sharded training and serving
# ---------------------------------------------------------------------------

# four gloo ranks sharing the card on a (data 2, model 2) mesh: granite at
# full width cut to 4 of 40 layers (8 until the script passed 1100 s on a
# slow host), batch 8 x 1024, bf16, train rules
SHARD = dict(arch="granite-3-2b", layers=4, batch=8, seq=1024, steps=3,
             fp32_layers=2, resume_steps=2, serve_batch=4, prompt=1024,
             gen=16, caps="Caps-MN1", caps_batch=100, mesh=(2, 2))
# the local flash-attention shape each rank trains at: (B/2, Hq/2, Hkv/2,
# S, D) of granite's (8, 32, 8, 1024, 64)
SHARD_ATTN_CHECK = (4, 16, 4, 1024, 64, True, "bf16")


class ShapeMesh:
    """A mesh's axis names and sizes for ``make_rules``: the production
    meshes' tables are read without their ranks."""

    def __init__(self, shape, axes):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(axes)

    def size(self, i=None):
        return int(np.prod(self.shape)) if i is None else self.shape[i]


def sharding_tables() -> dict:
    """(a) Every leaf's local shape and the bytes a device holds, for the
    ten full configs on the production meshes in every mode, from meta
    tensors (no weight is allocated): a dimension is split over its axis
    where the axis size divides it, else held whole."""
    from repro_torch import configs
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.launch.mesh import PRODUCTION
    from repro_torch.models import lm
    from repro_torch.runtime import sharding
    out = {}
    for arch in configs.list_archs():
        cfg = configs.get_config(arch)
        shapes = flatten(lm.init_params(cfg, device="meta"))
        axes = flatten(lm.param_logical_axes(cfg))
        total = sum(t.numel() * t.element_size() for t in shapes.values())
        out[arch] = {"bytes": total}
        for shape, mesh_axes in PRODUCTION.values():
            for mode in ("train", "prefill", "decode"):
                rules = sharding.make_rules(cfg, ShapeMesh(shape, mesh_axes),
                                            mode)
                local = {k: lm.local_shape(tuple(t.shape), axes[k], rules)
                         for k, t in shapes.items()}
                per = sum(int(np.prod(v)) * shapes[k].element_size()
                          for k, v in local.items())
                key = f"{'x'.join(map(str, shape))} {mode}"
                out[arch][key] = {"bytes_per_device": per, "local": local,
                                  "embed": rules.rules["embed"]}
                print(f"[tables] {arch} on {shape} {mode}: "
                      f"{per / 2 ** 30:.3f} GiB a device of "
                      f"{total / 2 ** 30:.2f} GiB "
                      f"(embed -> {rules.rules['embed']})")
        for key in ("16x16 train",) + (("16x16 decode",)
                                       if arch == "mistral-large-123b"
                                       else ()):
            leaves = ", ".join(f"{k} {tuple(v)}" for k, v in
                               out[arch][key]["local"].items())
            print(f"[tables] {arch} {key} local shapes: {leaves}")
    mistral = out["mistral-large-123b"]
    check(mistral["16x16 decode"]["embed"] == "data",
          "mistral-large-123b's serving shard should keep the 2-D sharding")
    check(all(out[a]["16x16 decode"]["embed"] is None for a in out
              if a != "mistral-large-123b"),
          "every other config should replicate embed over data to serve")
    return out


def _loss_grads(params, cfg, batch, rules=None):
    """(loss, gradients keyed by path) of ``lm.loss_fn``; under ``rules``
    finished by ``sharding.sync_grads``."""
    from repro_torch.checkpoint.ckpt import flatten, unflatten_like
    from repro_torch.models import lm
    from repro_torch.runtime import sharding
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in flatten(params).items()}
    loss, _ = lm.loss_fn(unflatten_like(params, leaves), cfg, batch, rules)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    if rules is not None:
        grads = sharding.sync_grads(grads, sharding.param_held(cfg, rules),
                                    rules)
    return float(loss.detach()), grads


def _grad_gap(got: dict, want: dict) -> dict:
    delta = max(float((got[k].float() - want[k].float()).abs().max())
                for k in want)
    scale = max(float(g.float().abs().max()) for g in want.values())
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    return {"max_abs_diff": delta, "max_abs_grad": scale,
            "rel_diff": delta / scale, "finite": finite}


class _CollectiveClock:
    """Host time inside ``torch.distributed``'s all_reduce and all_gather
    (each between two synchronisations of the card), while active."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.s, self.calls = dist, 0.0, 0
        self.saved = (dist.all_reduce, dist.all_gather)

    def _wrap(self, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            self.calls += 1
            return out
        return timed

    def __enter__(self):
        self.dist.all_reduce = self._wrap(self.saved[0])
        self.dist.all_gather = self._wrap(self.saved[1])
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce, self.dist.all_gather = self.saved


def _shard_worker(argv: list) -> None:
    """One of the gloo ranks sharing the card (b, c, e and the checkpoint
    of d).  Writes ``shard<r>.json``; rank 0 also holds the unsharded
    reference computations on the same weights."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.checkpoint.ckpt import flatten, unflatten_like
    from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import elastic, mesh_utils, sharding, train_loop
    tmp, spec, rank = argv[0], json.loads(argv[1]), dist.get_rank()
    dev = torch.device("cuda")
    world = int(np.prod(spec["mesh"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"rank": rank}
    torch.cuda.reset_peak_memory_stats()
    mesh = mesh_utils.make_mesh(spec["mesh"], ("data", "model"), dev)
    cfg = configs.with_layers(configs.get_config(spec["arch"]),
                              spec["layers"])
    rules = sharding.make_rules(cfg, mesh, "train")
    bax = rules.axis("batch")
    per = spec["batch"] // rules.size(bax)
    rows = slice(rules.index(bax) * per, (rules.index(bax) + 1) * per)
    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=spec["seq"])
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(0, spec["batch"]).items()}
    mine = {k: v[rows] for k, v in batch.items()}
    full = lm.init_params(cfg, seed=0, device=dev)
    local = lm.shard_params(full, cfg, rules)

    # (b) step-0 loss and whole-tree gradients against the unsharded
    loss_s, g_s = _loss_grads(local, cfg, mine, rules)
    g_s = flatten(lm.gather_params(unflatten_like(local, g_s), cfg,
                                   rules))
    if rank == 0:
        loss_u, g_u = _loss_grads(full, cfg, batch)
        res["bf16"] = dict(_grad_gap(g_s, g_u), loss_sharded=loss_s,
                           loss_unsharded=loss_u)
    del g_s, full
    if rank == 0:
        del g_u
    gc.collect()

    # (b) the counted steps: the main path
    step = train_loop.make_train_step(cfg, rules, opt_cfg=AdamWConfig(),
                                      warmup=1, total_steps=100)
    opt = adamw_init(flatten(local))
    for fn in lm_counters():
        fn.launches = 0
    losses, times = [], []
    for _ in range(spec["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, mine)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res["launches"] = read_counts()
    res["losses"], res["step_s"] = losses, times
    with _CollectiveClock() as clock:
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, mine)
        torch.cuda.synchronize()
        res["timed_step_s"] = time.perf_counter() - t0
    res["collective_s"], res["collective_calls"] = clock.s, clock.calls
    res["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del local, opt, step
    gc.collect()

    # (c) serving under the decode rules: flash-decoding
    from repro_torch.runtime import serve_loop
    rules_d = sharding.make_rules(cfg, mesh, "decode")
    full = lm.init_params(cfg, seed=0, device=dev)
    served = lm.shard_params(full, cfg, rules_d)
    prompts = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab, (spec["serve_batch"], spec["prompt"]),
        dtype=np.int32)).to(dev)
    sper = spec["serve_batch"] // rules_d.size(rules_d.axis("batch"))
    srows = slice(rules_d.index(rules_d.axis("batch")) * sper,
                  (rules_d.index(rules_d.axis("batch")) + 1) * sper)
    max_len = spec["prompt"] + spec["gen"]
    with torch.inference_mode():
        logits, state = lm.prefill(served, cfg, {"tokens": prompts[srows]},
                                   max_len, rules=rules_d)
        res["kv_len"] = state.kv_len
        res["cache_slots"] = state.kv[0].shape[2]
        del state
        logits = mesh_utils.all_gather(logits.float(), rules_d.axis(
            "batch"), 0, mesh=mesh)
        if rank == 0:
            want, _ = lm.prefill(full, cfg, {"tokens": prompts},
                                 max_len)
            torch.save({"sharded": logits.cpu(),
                        "unsharded": want.float().cpu()},
                       os.path.join(tmp, "first_logits.pt"))
        del full
        for fn in lm_counters():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = serve_loop.generate(served, cfg,
                                         {"tokens": prompts[srows]},
                                         spec["gen"], rules_d)
        torch.cuda.synchronize()
        res["generate_s"] = time.perf_counter() - t0
        res["generate_launches"] = read_counts()
        res["generated"] = out.tolist()
    del served
    gc.collect()

    # (b, d) fp32 at 2 layers: gradients within GRAD_ATOL of the
    # unsharded; two steps, then a checkpoint at step 2 for the resume
    cfg32 = dataclasses.replace(configs.with_layers(cfg,
                                                    spec["fp32_layers"]),
                                dtype=torch.float32)
    rules32 = sharding.make_rules(cfg32, mesh, "train")
    full = lm.init_params(cfg32, seed=0, device=dev)
    local = lm.shard_params(full, cfg32, rules32)
    loss_s, g_s = _loss_grads(local, cfg32, mine, rules32)
    g_s = flatten(lm.gather_params(unflatten_like(local, g_s), cfg32,
                                   rules32))
    if rank == 0:
        loss_u, g_u = _loss_grads(full, cfg32, batch)
        res["fp32"] = dict(_grad_gap(g_s, g_u), loss_sharded=loss_s,
                           loss_unsharded=loss_u)
        del g_u
    del g_s, full
    step = train_loop.make_train_step(cfg32, rules32,
                                      opt_cfg=AdamWConfig(), warmup=1,
                                      total_steps=100)
    opt = adamw_init(flatten(local))
    res["resume_losses"] = []
    for _ in range(spec["resume_steps"]):
        local, opt, m = step(local, opt, mine)
        res["resume_losses"].append(float(m["loss"]))
    t0 = time.perf_counter()
    elastic.save(os.path.join(tmp, "ckpt"), spec["resume_steps"], local,
                 opt, cfg32, rules32)
    res["ckpt_s"] = time.perf_counter() - t0
    del local, opt, step
    gc.collect()

    # (e) CapsNet: differentiable torch routing under the {B} plan over
    # two of the ranks (axis "x"), against the unsharded route
    from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS
    caps = CAPS_BENCHMARKS[spec["caps"]]
    mesh_xy = mesh_utils.make_mesh(spec["mesh"], ("x", "y"), dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    shape = (spec["caps_batch"], caps.num_l_caps, caps.num_h_caps,
             caps.h_caps_dim)
    u = torch.randn(shape, generator=gen, device=dev) * 0.05
    w = torch.randn(shape[0], shape[2], shape[3], generator=gen,
                    device=dev)
    rspec = RouterSpec(iterations=caps.routing_iters, differentiable=True)
    grads = []
    for plan in (ExecutionPlan(mesh=mesh_xy, axes=(("B", "x"),)), None):
        ui = u.clone().requires_grad_(True)
        v = build_router(rspec, plan, device=dev)(ui)
        grads.append((v.detach(), torch.autograd.grad(
            (v * w).sum(), ui)[0]))
    res["caps"] = {
        "v_max_abs_diff": float((grads[0][0] - grads[1][0]).abs().max()),
        "grad_max_abs_diff": float((grads[0][1] - grads[1][1])
                                   .abs().max()),
        "grad_max_abs": float(grads[1][1].abs().max()),
        "shape": list(shape)}
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(tmp, f"shard{rank}.json"), "w") as f:
        json.dump(res, f)


def run_shard_ranks(spec: dict, tmp: str) -> list:
    """The ranks of ``_shard_worker`` (``repro_torch.launch.ranks``); a
    rank that fails fails the phase, and every rank is stopped."""
    from repro_torch.launch import ranks as launcher
    world = int(np.prod(spec["mesh"]))
    launcher.run(_shard_worker, [tmp, json.dumps(spec)], world, "cuda",
                 timeout_s=RANK_TIMEOUT_S)
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"shard{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def shard_resume(spec: dict, tmp: str, last_loss: float) -> dict:
    """(d) ``elastic.resume_or_init`` of the ranks' step-2 checkpoint on a
    one-rank (1, 1) mesh in this process; two more steps on the same
    batch, the loss below the step-2 loss + 0.5 (the reference's gate)."""
    from repro_torch import configs
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.runtime import elastic, mesh_utils, train_loop
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(configs.with_layers(
        configs.get_config(spec["arch"]), spec["fp32_layers"]),
        dtype=torch.float32)
    mesh = mesh_utils.make_mesh((1, 1), ("data", "model"), "cuda")
    t0 = time.perf_counter()
    params, opt, start, rules = elastic.resume_or_init(
        cfg, mesh, os.path.join(tmp, "ckpt"), 0, "train", "cuda")
    load_s = time.perf_counter() - t0
    check(start == spec["resume_steps"], f"resumed at step {start}, not "
                                         f"{spec['resume_steps']}")
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=spec["seq"]).batch(
            0, spec["batch"]).items()}
    step = train_loop.make_train_step(cfg, rules, opt_cfg=AdamWConfig(),
                                      warmup=1, total_steps=100)
    losses = []
    for _ in range(spec["resume_steps"]):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)) and losses[-1] < last_loss + 0.5,
          f"the resumed run's loss {losses} is not below the step-"
          f"{spec['resume_steps']} loss {last_loss:.4f} + 0.5")
    print(f"[shard] (d) resume: the (2, 2) ranks' step-{start} checkpoint "
          f"of whole leaves read into a (1, 1) mesh's blocks in "
          f"{load_s:.1f} s; loss {last_loss:.4f} at step {start}, then "
          f"{' -> '.join(f'{x:.4f}' for x in losses)} (gate: below "
          f"{last_loss + 0.5:.4f})")
    del params, opt
    return {"start": start, "losses": losses, "load_s": load_s}


def report_shard_ranks(spec: dict, ranks: list, tmp: str, cfg,
                       card: str) -> dict:
    """The gates of (b), (c) and (e) on the ranks' results."""
    r0 = ranks[0]
    fwd, bwd = train_attention_launches(cfg)
    for res in ranks:
        r = res["rank"]
        want = {"flash_attention": 0,
                "flash_attention_fwd_lse": fwd * spec["steps"],
                "flash_attention_bwd": bwd * spec["steps"],
                "selective_scan": 0}
        check(res["launches"] == want, f"rank {r}: {spec['steps']} sharded "
              f"steps launched {res['launches']}; expected {want}")
        want = {"flash_attention": cfg.n_layers,
                "flash_attention_fwd_lse": 0, "flash_attention_bwd": 0,
                "selective_scan": 0}
        check(res["generate_launches"] == want,
              f"rank {r}: generate launched {res['generate_launches']}; "
              f"expected {want}")
        check(all(np.isfinite(res["losses"])) and
              res["losses"][-1] < res["losses"][0],
              f"rank {r}: the loss did not fall: {res['losses']}")
        med = statistics.median(res["step_s"][1:] or res["step_s"])
        share = res["collective_s"] / res["timed_step_s"]
        print(f"[shard] (b) rank {r}: {cfg.name} at full width, "
              f"{cfg.n_layers} layers, batch {spec['batch']} x {spec['seq']}"
              f" over (data, model) = {tuple(spec['mesh'])}, bf16: loss "
              f"{' -> '.join(f'{x:.4f}' for x in res['losses'])}; step "
              f"{med * 1e3:.1f} ms (median of steps 2-{spec['steps']}; "
              f"first {res['step_s'][0] * 1e3:.1f} ms); the collectives "
              f"{res['collective_s'] * 1e3:.1f} ms of a "
              f"{res['timed_step_s'] * 1e3:.1f} ms step timed around them "
              f"({100 * share:.1f} %, {res['collective_calls']} calls); "
              f"launches {res['launches']} a run of {spec['steps']}; peak "
              f"memory {res['train_peak_gb']:.2f} GB training, "
              f"{res['peak_gb']:.2f} GB in all")
    for label, gate in (("bf16", None), ("fp32", GRAD_TOL["fp32"])):
        d = r0[label]
        check(d["finite"], f"{label}: non-finite sharded gradients")
        if gate is None:
            ok = d["rel_diff"] < TRAIN_GRAD_REL_LIMIT
            limit = f"max|Δ| / max|g| < {TRAIN_GRAD_REL_LIMIT}"
        else:
            ok = d["max_abs_diff"] <= gate * max(1.0, d["max_abs_grad"])
            limit = f"max|Δ| <= {gate}·max(1, max|g|)"
        check(ok and abs(d["loss_sharded"] - d["loss_unsharded"])
              <= (1e-2 if gate is None else TOL) * max(1.0, abs(
                  d["loss_unsharded"])),
              f"{label}: sharded vs unsharded loss {d['loss_sharded']} vs "
              f"{d['loss_unsharded']}, gradients {d}")
        print(f"[shard] (b) {label} at "
              f"{cfg.n_layers if label == 'bf16' else spec['fp32_layers']} "
              f"layers: step-0 loss {d['loss_sharded']:.6f} sharded vs "
              f"{d['loss_unsharded']:.6f} unsharded on the same weights; "
              f"whole-tree gradients max|Δ| {d['max_abs_diff']:.4g} = "
              f"{d['rel_diff']:.3e} of max|g| {d['max_abs_grad']:.4g} "
              f"({limit})")
    first = torch.load(os.path.join(tmp, "first_logits.pt"))
    agree = first_token_agreement(
        cfg.name, first["sharded"], first["unsharded"],
        "the decode rules on the (2, 2) ranks vs the unsharded prefill")
    gens = [t for res in ranks[::spec["mesh"][1]] for t in res["generated"]]
    print(f"[shard] (c) generate over the decode rules: {spec['serve_batch']}"
          f" x ({spec['prompt']} + {spec['gen']}), the cache "
          f"{r0['kv_len']} slots held {r0['cache_slots']} a rank "
          f"(cache_seq over model), {r0['generate_s'] * 1e3:.1f} ms on rank "
          f"0; first tokens {[g[0] for g in gens]}")
    c = r0["caps"]
    check(c["grad_max_abs_diff"] <= GRAD_TOL["fp32"]
          and c["v_max_abs_diff"] <= TOL,
          f"CapsNet {spec['caps']} sharded routing: {c}")
    print(f"[shard] (e) {spec['caps']} at B={spec['caps_batch']}, torch "
          f"routing under the {{B}} plan over 2 of the gloo ranks: v max|Δ| "
          f"{c['v_max_abs_diff']:.3g}, ∂û max|Δ| {c['grad_max_abs_diff']:.3g}"
          f" of max {c['grad_max_abs']:.3g} (gate {GRAD_TOL['fp32']}) "
          f"against the unsharded route on {card}")
    return {"agreement": agree}


def phase_shard(card: str) -> dict:
    """Phase 15: the sharding tables, the local attention shape by
    ``lib_gate``, sharded training, serving, resume and CapsNet routing on
    four gloo ranks sharing the card (the CLI on a (1, 1) mesh runs in
    phase 16)."""
    import tempfile
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    parts = {}
    t0 = time.perf_counter()
    tables = sharding_tables()
    parts["tables"] = time.perf_counter() - t0
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(151)
    t0 = time.perf_counter()
    check_train_attention(fk, SHARD_ATTN_CHECK, gen, rows)
    torch.cuda.empty_cache()
    parts["lib_gate"] = time.perf_counter() - t0
    cfg = configs.with_layers(configs.get_config(SHARD["arch"]),
                              SHARD["layers"])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_shard_ranks(SHARD, tmp)
        wall = parts["ranks"] = time.perf_counter() - t0
        gates = report_shard_ranks(SHARD, ranks, tmp, cfg, card)
        t0 = time.perf_counter()
        resume = shard_resume(SHARD, tmp, ranks[0]["resume_losses"][-1])
        parts["resume"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[shard] {int(np.prod(SHARD['mesh']))} gloo ranks on {card}: "
          f"passed in {wall:.1f} s; the phase's parts (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    launches = {
        "flash_attention": sum(r["generate_launches"]["flash_attention"]
                               for r in ranks),
        "flash_attention_fwd_lse": sum(
            r["launches"]["flash_attention_fwd_lse"] for r in ranks),
        "flash_attention_bwd": sum(r["launches"]["flash_attention_bwd"]
                                   for r in ranks)}
    return {"tables": {a: {k: (v if not isinstance(v, dict) else
                               {kk: vv for kk, vv in v.items()
                                if kk != "local"})
                           for k, v in t.items()}
                       for a, t in tables.items()},
            "kernels": rows, "ranks": ranks, "wall_s": wall, **gates,
            "resume": resume, "launches": launches,
            "parts_s": parts}

# ---------------------------------------------------------------------------
# phase 16: multi-rank launch
# ---------------------------------------------------------------------------

# (a), (b): granite-3-2b at full width cut to 2 layers, batch 8 x 1024, on
# one NCCL rank (--mesh 1,1) and on four gloo ranks sharing the card that
# --mesh 2,2 starts itself; each step's loss within LAUNCH_LOSS_REL
LAUNCH_TRAIN = ["--arch", "granite-3-2b", "--layers", "2", "--seq", "1024",
                "--global-batch", "8", "--steps", "3"]
LAUNCH_LOSS_REL = 1e-3
# (c): granite-3-2b at full width cut to 4 layers, 6 requests in groups of
# 4 on two gloo ranks: a sharded group and a short one served whole
LAUNCH_SERVE = ["--arch", "granite-3-2b", "--layers", "4", "--requests",
                "6", "--batch", "4", "--prompt-len", "1024", "--gen", "16"]
# (d): Caps-MN1 through the two-stage pipeline on two gloo ranks
LAUNCH_CAPS = ["--network", "Caps-MN1", "--requests", "300", "--microbatch",
               "100", "--n-micro", "2"]


def _record_caps_waves(cli, record: list):
    """Rank 0's served waves of ``serve_caps``: each wave's input and
    scores, kept to hold them against the unpipelined arm after the run.
    A context: ``RankWaves.lead`` records inside it and is restored on
    exit, so that one command's waves are not recorded into another's."""
    lead = cli.RankWaves.lead

    def recording(self, key):
        fn = lead(self, key)

        def wave(micro):
            out = fn(micro)
            if key == 0:
                record.append((self, {k: v.clone() for k, v in
                                      micro.items()}, out.clone()))
            return out
        return wave
    return mock.patch.object(cli.RankWaves, "lead", recording)


def _unpipelined_gap(record: list) -> float:
    """max|Δ| of the recorded waves' scores from the same waves through
    the unpipelined, unsharded wave function on this rank."""
    from repro_torch.runtime import caps_serve
    waves = record[0][0]
    plain = caps_serve.make_wave_fn(
        waves.net, waves.specs[0], dataclasses.replace(
            waves.cfg, pipeline=None, mesh=None, routing_plan=None))
    return max(float((plain(micro) - out).abs().max())
               for _, micro, out in record)


def launched_rank(argv: list) -> list:
    """One rank of a phase-16 launch (``repro_torch.launch.ranks.run``):
    ``argv[0]`` is a JSON list of commands, each a CLI module and its
    arguments, run in order.  For each, the kernels' launch counts are set
    to 0 just before its ``main`` and read just after; every rank's counts,
    wall time and result digest are gathered to every rank."""
    import importlib
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.routing import kernel
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for module, *args in json.loads(argv[0]):
        cli = importlib.import_module(module)
        record = []
        recorder = (_record_caps_waves(cli, record)
                    if module.endswith("serve_caps")
                    else contextlib.nullcontext())
        for fn in lm_counters():
            fn.launches = 0
        kernel.reset_launch_counts()
        t0 = time.perf_counter()
        with recorder:
            res = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**read_counts(), **{k: v for k, v in
                                      kernel.launch_counts().items() if v}}
        if res is None:                      # a follower
            digest = {}
        elif module.endswith(".train"):
            digest = {"start": res["start"], "losses": res["losses"]}
        elif module.endswith(".serve"):
            digest = {"results": np.stack(res["results"]).tolist()}
        else:
            digest = {k: res[k] for k in ("submitted", "completed", "shed",
                                          "failed", "waves", "rank_waves",
                                          "predictions")}
            digest["wave_gap"] = _unpipelined_gap(record)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, {"counts": counts, "wall_s": wall,
                                       **digest})
        out.append(every)
    return out


def launch_train(card: str) -> dict:
    """(a) ``train --mesh 1,1`` on one NCCL rank through the launcher; (b)
    the same with ``--mesh 2,2`` run alone, which starts four gloo ranks
    sharing the card itself."""
    from repro_torch import configs
    from repro_torch.launch import ranks, train
    t0 = time.perf_counter()
    (a,), = ranks.run(launched_rank, [json.dumps(
        [["repro_torch.launch.train", *LAUNCH_TRAIN, "--mesh", "1,1"]])],
        1, "cuda", timeout_s=RANK_TIMEOUT_S)
    a_s = time.perf_counter() - t0
    cfg = configs.with_layers(configs.get_config("granite-3-2b"), 2)
    fwd, bwd = train_attention_launches(cfg)
    steps = int(LAUNCH_TRAIN[-1])
    check(a["counts"]["flash_attention_fwd_lse"] == fwd * steps
          and a["counts"]["flash_attention_bwd"] == bwd * steps,
          f"(a) launches {a['counts']}, want {fwd}, {bwd} a step")
    t0 = time.perf_counter()
    # the CLI starts its own ranks: hold that launch to the same limit
    limited = functools.partial(ranks.run, timeout_s=RANK_TIMEOUT_S)
    with mock.patch.object(ranks, "run", limited):
        b = train.main(LAUNCH_TRAIN + ["--mesh", "2,2"])
    b_s = time.perf_counter() - t0
    rel = [abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"])]
    print(f"[launch] (a) train --mesh 1,1 on one NCCL rank: losses "
          f"{a['losses']}, {a['wall_s']:.1f} s in main, {a_s:.1f} s with "
          f"the start; launches {a['counts']}")
    print(f"[launch] (b) train --mesh 2,2 alone (4 gloo ranks sharing "
          f"{card}): losses {b['losses']}, relative gap to (a) "
          f"{max(rel):.2e} (limit {LAUNCH_LOSS_REL:g}), {b_s:.1f} s")
    check(len(b["losses"]) == steps and max(rel) <= LAUNCH_LOSS_REL,
          f"(b) losses {b['losses']} against (a)'s {a['losses']}")
    return {"a": a, "a_s": a_s, "b": b, "b_s": b_s, "loss_rel": max(rel),
            "launches": a["counts"]}


def launch_serve_margins(cfg, prompts, batch: int, ranks: int) -> dict:
    """Each request's first-step logits as the 1-rank run computes them
    (groups of ``batch``) and as ``ranks`` ranks do (a full group split
    into rows, the short last group whole), on the CLI's weights; the
    top-2 margins of the first and max|Δ| between the two."""
    from repro_torch.models import lm
    params = lm.init_params(cfg, seed=0, device="cuda")
    S = prompts.shape[1]

    def first(rows):
        logits, _ = lm.prefill(params, cfg, {"tokens": torch.as_tensor(
            rows, device="cuda")}, max_len=S + 1)
        return logits.float()

    one, split = [], []
    with torch.inference_mode():
        for lo in range(0, len(prompts), batch):
            group = prompts[lo:lo + batch]
            one.append(first(group))
            per = batch // ranks
            split.append(torch.cat([first(group[i:i + per]) for i in
                                    range(0, len(group), per)])
                         if len(group) == batch else first(group))
    one, split = torch.cat(one), torch.cat(split)
    top2 = one.topk(2, dim=-1).values
    return {"delta": float((one - split).abs().max()),
            "margin": (top2[:, 0] - top2[:, 1]).tolist(),
            "first": one.argmax(-1).tolist()}


def phase_launch(card: str) -> dict:
    """Phase 16: the CLIs on their ranks through ``launch.ranks``."""
    from repro_torch import configs
    from repro_torch.launch import ranks, serve, serve_caps
    parts = {}
    t0 = time.perf_counter()
    train_out = launch_train(card)
    parts["train"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # (c) and (d) in one start of two gloo ranks
    t0 = time.perf_counter()
    commands = [["repro_torch.launch.serve", *LAUNCH_SERVE],
                ["repro_torch.launch.serve_caps", *LAUNCH_CAPS,
                 "--pipeline", "two_stage"],
                ["repro_torch.launch.serve_caps", *LAUNCH_CAPS,
                 "--pipeline", "two_stage", "--plan", "auto"]]
    served, plain_caps, auto_caps = ranks.run(
        launched_rank, [json.dumps(commands)], 2, "cuda",
        timeout_s=RANK_TIMEOUT_S)
    parts["ranks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = np.stack(serve.main(LAUNCH_SERVE)["results"])
    cfg = configs.with_layers(configs.get_config("granite-3-2b"), 4)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (6, int(LAUNCH_SERVE[LAUNCH_SERVE.index(
            "--prompt-len") + 1])), dtype=np.int32)
    m = launch_serve_margins(cfg, prompts, 4, 2)
    gc.collect()
    torch.cuda.empty_cache()
    parts["serve_reference"] = time.perf_counter() - t0
    clear = [i for i, g in enumerate(m["margin"]) if g > 2 * m["delta"]]
    for r, res in enumerate(served):
        got = np.array(res["results"])
        check(got.shape == one.shape,
              f"(c) rank {r} holds {got.shape[0]} requests of "
              f"{one.shape[0]}")
        check(all(got[i, 0] == one[i, 0] for i in clear),
              f"(c) rank {r}: first tokens differ from the 1-rank run on "
              f"clear lanes {clear}")
    same = [int((np.array(res["results"]) == one).all(1).sum())
            for res in served]
    print(f"[launch] (c) serve on 2 gloo ranks: every rank holds "
          f"{one.shape[0]} requests x {one.shape[1]} tokens; first-step "
          f"logits of split rows max|Δ| {m['delta']:.3e} from the 1-rank "
          f"grouping, {len(clear)} of {len(m['margin'])} lanes clear "
          f"(margin > 2·max|Δ|), their first tokens equal; requests equal "
          f"to the 1-rank run in full, by rank: {same}; launches "
          f"{[res['counts']['flash_attention'] for res in served]}; "
          f"{served[0]['wall_s']:.1f} s in main")
    t0 = time.perf_counter()
    none = serve_caps.main(LAUNCH_CAPS + ["--pipeline", "none"])
    parts["caps_reference"] = time.perf_counter() - t0
    caps = {}
    for label, every in (("plain", plain_caps), ("auto", auto_caps)):
        lead = every[0]
        check(lead["failed"] == 0 and lead["submitted"] == lead["completed"]
              + lead["shed"] and lead["completed"] == 300,
              f"(d) {label}: books {lead}")
        check(lead["rank_waves"] == [lead["waves"]] * 2,
              f"(d) {label}: waves by rank {lead['rank_waves']}")
        check(lead["wave_gap"] <= TWO_STAGE_TOL,
              f"(d) {label}: scores {lead['wave_gap']:.3g} from the "
              f"unpipelined arm")
        preds = {int(k): v for k, v in lead["predictions"].items()}
        agree = sum(preds[k] == v for k, v in none["predictions"].items())
        check(agree == len(none["predictions"]) == 300,
              f"(d) {label}: {agree} of 300 predictions equal to "
              f"--pipeline none")
        caps[label] = {"books": {k: lead[k] for k in (
            "submitted", "completed", "shed", "failed", "waves")},
            "wave_gap": lead["wave_gap"], "wall_s": lead["wall_s"],
            "counts": [r["counts"] for r in every]}
        print(f"[launch] (d) serve_caps --pipeline two_stage"
              f"{' --plan auto' if label == 'auto' else ''} on 2 gloo "
              f"ranks: {lead['completed']} served in {lead['waves']} "
              f"waves, 0 failed, every wave on both ranks; scores max|Δ| "
              f"{lead['wave_gap']:.2e} from the unpipelined arm (tol "
              f"{TWO_STAGE_TOL:g}); 300 of 300 predictions equal to "
              f"--pipeline none; launches by rank "
              f"{[r['counts'] for r in every]}; {lead['wall_s']:.1f} s")
    print(f"[launch] phase 16 parts (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return {"train": train_out, "serve": {
        "delta": m["delta"], "clear": clear, "same": same,
        "launches": sum(r["counts"]["flash_attention"] for r in served)},
        "caps": caps, "parts_s": parts,
        "launches": {
            "flash_attention": sum(r["counts"]["flash_attention"]
                                   for r in served),
            "flash_attention_fwd_lse":
                train_out["launches"]["flash_attention_fwd_lse"],
            "flash_attention_bwd":
                train_out["launches"]["flash_attention_bwd"],
            "routing_procedure_fused": sum(
                r["counts"].get("routing_procedure_fused", 0)
                for r in plain_caps)}}


# ---------------------------------------------------------------------------
# phase 17: the dry run
# ---------------------------------------------------------------------------

# (a): the production cells traced beside the smoke sweep, (arch, shape,
# --multi-pod)
DRYRUN_CELLS = (("granite-3-2b", "train_4k", "off"),
                ("mistral-large-123b", "decode_32k", "off"),
                ("zamba2-7b", "long_500k", "on"))
DRYRUN_DEADLINE_S = 1000   # (a)'s children end by then (from their start)
PEAK_REL_LIMIT = 0.10      # predicted peak against the card's (a miss is
                           # reported with its numbers and the card's
                           # largest allocations at its peak)


class DryrunJobs:
    """Phase 17 (a) in child processes, started after phase 2 (the build,
    whose compilers need the host's cores) so that their CPU work overlaps
    the card's phases: the smoke sweep
    ``python -m repro_torch.launch.dryrun --smoke --all --multi-pod both``
    in one, the production cells of ``DRYRUN_CELLS`` and ``routing_dryrun``
    for Caps-MN1 one after the other in another.  The parent holds a
    default process group from phase 7 on, and the dry run starts fake
    groups of its own.  The children see no card (``CUDA_VISIBLE_DEVICES``
    empty: a CUDA context each would take card memory that mixtral's phase
    needs), so their fake tensors lie on the CPU (``dryrun.fake_device``);
    they run at nice 19.  ``stop`` ends any still running."""

    def __init__(self):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="dryrun_")
        py = sys.executable
        dr = [py, "-m", "repro_torch.launch.dryrun"]
        self.cmds = {
            "smoke": [dr + ["--smoke", "--all", "--multi-pod", "both",
                            "--out", os.path.join(self.dir, "smoke")]],
            "production": [
                dr + ["--arch", a, "--shape", sh, "--multi-pod", mp,
                      "--out", os.path.join(self.dir, "production")]
                for a, sh, mp in DRYRUN_CELLS]
            + [[py, "-m", "repro_torch.launch.routing_dryrun", "--configs",
                "Caps-MN1", "--out", os.path.join(self.dir, "routing")]]}
        self.env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                        CUDA_VISIBLE_DEVICES="")
        self.procs = []
        self.results = {}
        self.lock = threading.Lock()       # no child starts after ``stop``
        self.stopped = False
        self.t0 = None
        self.threads = [threading.Thread(target=self._run, args=(name,),
                                         daemon=True)
                        for name in self.cmds]

    def start(self) -> None:
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()

    def _run(self, name: str) -> None:
        rcs, secs = [], []
        log = os.path.join(self.dir, f"{name}.log")
        with open(log, "w") as f:
            for cmd in self.cmds[name]:
                t0 = time.perf_counter()
                with self.lock:
                    if self.stopped:
                        return
                    # ``nice`` and not a preexec_fn: this thread is not the
                    # only one, and a fork then runs no Python before exec
                    p = subprocess.Popen(["nice", "-n", "19", *cmd],
                                         stdout=f, stderr=subprocess.STDOUT,
                                         env=self.env, cwd=ROOT)
                    self.procs.append(p)
                rcs.append(p.wait())
                secs.append(time.perf_counter() - t0)
        self.results[name] = {"rcs": rcs, "seconds": secs, "log": log,
                              "done_at_s": time.perf_counter() - self.t0}

    def wait(self) -> float:
        """Join the children (until ``DRYRUN_DEADLINE_S`` after their
        start); returns the seconds waited."""
        t0 = time.perf_counter()
        for t in self.threads:
            t.join(max(1.0, DRYRUN_DEADLINE_S
                       - (time.perf_counter() - self.t0)))
        return time.perf_counter() - t0

    def stop(self) -> None:
        with self.lock:
            self.stopped = True
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for t in self.threads:
            if t.ident is not None:          # started
                t.join()
        shutil.rmtree(self.dir, ignore_errors=True)


def _log_tail(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def dryrun_a(jobs: DryrunJobs) -> dict:
    """Phase 17 (a): the children's records read and checked."""
    from repro_torch.launch.routing_dryrun import RATES
    waited = jobs.wait()
    for name in jobs.cmds:
        res = jobs.results.get(name)
        check(res is not None, f"(a) {name}: still running "
                               f"{DRYRUN_DEADLINE_S} s after its start")
        check(all(rc == 0 for rc in res["rcs"]),
              f"(a) {name}: exit codes {res['rcs']}; log tail:\n"
              f"{_log_tail(res['log'])}")
    recs = []
    for fname in sorted(os.listdir(os.path.join(jobs.dir, "smoke"))):
        with open(os.path.join(jobs.dir, "smoke", fname)) as f:
            recs.append(json.load(f))
    status = {k: sum(r["status"] == k for r in recs)
              for k in ("ok", "skip", "fail")}
    from repro_torch import configs
    cells = len(configs.list_archs()) * len(configs.SHAPES) * 2
    check(status["fail"] == 0 and status["ok"] + status["skip"] == cells,
          f"(a) smoke sweep: {status} of {len(recs)} cells; {cells} "
          f"expected")
    check(all(r["memory"]["peak_bytes_per_device"] > 0
              and r["ops"]["flops"] > 0 for r in recs if r["status"] == "ok"),
          "(a) smoke sweep: a cell with no peak or no FLOPs")
    smoke_s = jobs.results["smoke"]["seconds"][0]
    print(f"[dryrun] (a) python -m repro_torch.launch.dryrun --smoke --all "
          f"--multi-pod both: {status['ok']} ok, {status['skip']} skip, "
          f"{status['fail']} fail, {smoke_s:.1f} s in its child (nice 19, "
          f"fake tensors on the CPU, beside phases 3-16)")
    cells = {}
    for (arch, shape, mp), secs in zip(DRYRUN_CELLS,
                                       jobs.results["production"]["seconds"]):
        tag = f"{arch}__{shape}__{'multi' if mp == 'on' else 'single'}"
        with open(os.path.join(jobs.dir, "production", tag + ".json")) as f:
            rec = json.load(f)
        check(rec["status"] == "ok", f"(a) {tag}: {rec.get('error')}")
        mem, ops = rec["memory"], rec["ops"]
        ratio = ops["flops"] / rec["model_flops_per_device"]
        check(mem["peak_bytes_per_device"] > 0 and ops["flops"] > 0
              and ops["collective_bytes"] > 0, f"(a) {tag}: {mem}, {ops}")
        cells[tag] = {"peak_bytes": mem["peak_bytes_per_device"],
                      "memory": mem, "flops": ops["flops"],
                      "product_flops": ops["product_flops"],
                      "model_flops": rec["model_flops_per_device"],
                      "flops_ratio": ratio,
                      "collective_by_kind": ops["collective_by_kind"],
                      "kernel_calls": ops["kernel_calls"],
                      "n_microbatches": rec.get("num_microbatches"),
                      "trace_s": rec["trace_s"], "child_s": secs,
                      "ranks": {r: {"peak_bytes":
                                    v["memory"]["peak_bytes_per_device"],
                                    "flops": v["ops"]["flops"]}
                                for r, v in rec["ranks"].items()}}
        print(f"[dryrun] (a) {tag} on {rec['mesh_shape']}"
              + (f", {rec['num_microbatches']} microbatches"
                 if "num_microbatches" in rec else "")
              + f": peak {mem['peak_bytes_per_device'] / 2 ** 30:.3f} GiB a "
              f"device (arguments {mem['argument_bytes'] / 2 ** 30:.3f}, "
              f"temporaries {mem['temp_bytes'] / 2 ** 30:.3f}), "
              f"{ops['flops']:.4e} FLOPs a device ({ops['product_flops']:.4e}"
              f" in products), {ratio:.3f}x the model's "
              f"{rec['model_flops_per_device']:.4e}; collective bytes "
              + ", ".join(f"{k} {v:.4e}" for k, v in
                          ops["collective_by_kind"].items())
              + f"; kernel calls {ops['kernel_calls']}; ranks "
              + ", ".join(f"{r}: {v['memory']['peak_bytes_per_device'] / 2 ** 30:.3f} GiB, "
                          f"{v['ops']['flops']:.4e} FLOPs"
                          for r, v in rec["ranks"].items())
              + f"; traced in {rec['trace_s']} s")
    with open(os.path.join(jobs.dir, "routing", "Caps-MN1.json")) as f:
        routing = json.load(f)
    for tag, c in routing["cells"].items():
        check(c["status"] in ("ok", "skip"), f"(a) routing {tag}: {c}")
        if c["status"] == "skip":
            print(f"[dryrun] (a) routing Caps-MN1 B={routing['batch']} "
                  f"{tag}: skip ({c['reason']})")
            continue
        t = c["terms"]
        print(f"[dryrun] (a) routing Caps-MN1 B={routing['batch']} {tag}: "
              f"{c['flops']:.4e} FLOPs, collective bytes "
              + ", ".join(f"{k} {v:.4e}" for k, v in
                          c["collective_by_kind"].items())
              + f", peak {c['peak_bytes'] / 2 ** 20:.2f} MiB, kernel calls "
              f"{c['kernel_calls']}; terms at the nominal rates (not "
              f"measured): compute {t['compute_s'] * 1e3:.4f} ms, memory "
              f"{t['memory_s'] * 1e3:.4f} ms, collective "
              f"{t['collective_s'] * 1e3:.4f} ms")
    print(f"[dryrun] (a) planner (DeviceModel.h100): 32 vaults -> "
          f"{routing['paper_scale']['planner_pick']}, 256 -> "
          f"{routing['pod_scale']['planner_pick']}; smallest traced term "
          f"max: {routing['pod_scale'].get('best_measured')}; rates "
          f"{RATES} (NVIDIA H100 SXM5 80GB, 700 W, data sheet, and one NDR "
          f"InfiniBand port a GPU; not measured)")
    return {"smoke": status, "smoke_s": smoke_s, "cells": cells,
            "routing": routing["cells"],
            "planner": {"paper_scale": routing["paper_scale"]["planner_pick"],
                        "pod_scale": routing["pod_scale"]["planner_pick"]},
            "waited_s": waited,
            "children": {k: v for k, v in jobs.results.items()}}


def _held_bytes(*trees) -> int:
    """Bytes of the card's blocks behind the tensors of ``trees``, each
    storage once, at the allocator's 512-byte granularity (as the dry
    run's tracker counts them)."""
    from repro_torch.launch.op_analysis import ALLOC_BLOCK, _tensors
    seen = {}
    for t in _tensors(trees):
        st = t.untyped_storage()
        seen[st._cdata] = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
    return sum(seen.values())


def _card_step(run, args) -> dict:
    """``run()`` measured on the card: its peak beyond what was allocated
    before it that is not its arguments, with every kernel counter set to
    0 just before and read just after; then again under
    ``FlopCounterMode`` for its products.  The caller ran it once
    before (the lazy workspaces exist)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.routing import kernel
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    other = torch.cuda.memory_allocated() - _held_bytes(*args)
    torch.cuda.reset_peak_memory_stats()
    for fn in lm_counters():
        fn.launches = 0
    kernel.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - other
    launches = {k: v for k, v in {**read_counts(),
                                  **kernel.launch_counts()}.items() if v}
    del out
    with FlopCounterMode(display=False) as fc:
        out = run()
    torch.cuda.synchronize()
    del out
    return {"peak": peak, "other": other, "launches": launches,
            "product_flops": int(fc.get_total_flops())}


def _peak_sources(run, top: int = 6) -> list:
    """``run()`` once more under the allocator's history: the blocks it
    allocated that are live at its peak, summed by the first frame in the
    port's source (else in torch's), largest first."""
    mem = torch.cuda.memory
    gc.collect()
    torch.cuda.synchronize()
    mem._record_memory_history(max_entries=400000, stacks="python")
    try:
        out = run()
        torch.cuda.synchronize()
        snap = mem._snapshot()
    finally:
        mem._record_memory_history(enabled=None)
    del out
    live, cur, best, at_peak = {}, 0, -1, {}
    for ev in snap["device_traces"][torch.cuda.current_device()]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > best:
                best, at_peak = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    by = {}
    for ev in at_peak.values():
        frames = ev.get("frames") or []
        f = next((f for f in frames if "repro_torch" in f["filename"]),
                 next((f for f in frames if "torch" in f["filename"]), None))
        key = (f"{os.path.basename(f['filename'])}:{f['line']}" if f else
               "no Python frame (the autograd engine's thread, or a "
               "library's own workspace)")
        by[key] = by.get(key, 0) + ev["size"]
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def _hold_prediction(label: str, pred: dict, real: dict, run) -> dict:
    """Each kernel's calls and the products' FLOPs of the dry run against
    the card's, exactly; its peak within ``PEAK_REL_LIMIT`` of the card's,
    or reported as a miss with the card's largest allocations at its
    peak."""
    calls = {k: v["calls"] for k, v in pred["ops"]["kernels"].items()}
    names = sorted(set(calls) | set(real["launches"]))
    check(all(calls.get(k, 0) == real["launches"].get(k, 0) for k in names),
          f"(b) {label}: dry-run kernel calls {calls} against launches "
          f"{real['launches']}")
    flops = int(pred["ops"]["product_flops"])
    check(flops == real["product_flops"],
          f"(b) {label}: dry-run product FLOPs {flops} against "
          f"FlopCounterMode's {real['product_flops']}")
    peak = pred["memory"]["peak_bytes_per_device"]
    rel = (peak - real["peak"]) / real["peak"]
    within = abs(rel) <= PEAK_REL_LIMIT
    print(f"[dryrun] (b) {label}: predicted peak {peak / 2 ** 30:.4f} GiB "
          f"(arguments {pred['memory']['argument_bytes'] / 2 ** 30:.4f}), "
          f"card {real['peak'] / 2 ** 30:.4f} GiB (max_memory_allocated "
          f"less {real['other'] / 2 ** 20:.1f} MiB held before the step "
          f"beside its arguments): {rel * 100:+.2f} % "
          f"({'within' if within else 'MISS: outside'} the "
          f"{PEAK_REL_LIMIT * 100:.0f} % limit); kernel calls {calls} = "
          f"launches {real['launches']}; product FLOPs {flops:.6e} = "
          f"FlopCounterMode's; dry run traced in {pred['trace_s']} s")
    sources = []
    if not within:
        try:          # a diagnosis: it reads the allocator's private API
            sources = _peak_sources(run)
            note = ", ".join(f"{k} {v / 2 ** 20:.1f} MiB"
                             for k, v in sources)
        except Exception as e:        # noqa: BLE001
            note = f"not measured ({type(e).__name__}: {e})"
        print(f"[dryrun] (b) {label}: the card's blocks live at the step's "
              f"peak, allocated in the step, by source: {note}")
    return {"predicted_peak": peak, "card_peak": real["peak"],
            "rel": rel, "within": within, "sources": sources,
            "other": real["other"], "calls": calls,
            "launches": real["launches"], "product_flops": flops,
            "predicted": pred["memory"], "trace_s": pred["trace_s"]}


def granite_cells() -> dict:
    """(b) granite-3-2b at full width: phase 9's training step (8 x 1024,
    the second step) and phase 8's serving wave's prefill (8 x 1024, a
    cache of 1024 + 32)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.runtime import train_loop
    cfg = configs.get_config("granite-3-2b")
    out = {}
    gen = np.random.default_rng(17)
    train = configs.ShapeCell("granite_train", GRANITE_TRAIN["seq"],
                              GRANITE_TRAIN["batch"], "train")
    pred = dryrun.analyze_step(cfg, train, device="cuda")
    params, opt = train_loop.init_train_state(cfg, seed=0, device="cuda")
    batch = {k: torch.from_numpy(gen.integers(0, cfg.vocab, shape,
                                              dtype=np.int32)).cuda()
             for k, (shape, _) in configs.input_specs(cfg, train).items()}
    step = train_loop.make_train_step(cfg)
    step(params, opt, batch)                       # step 1
    real = _card_step(lambda: step(params, opt, batch), (params, opt, batch))
    out["granite_train"] = _hold_prediction(
        f"granite-3-2b training {GRANITE_TRAIN['batch']} x "
        f"{GRANITE_TRAIN['seq']}, {cfg.n_layers} layers, steps 2 and 3",
        pred, real, lambda: step(params, opt, batch))
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    sv = GRANITE_SERVE
    wave = configs.ShapeCell("granite_wave", sv["prompt_len"], sv["wave"],
                             "prefill")
    max_len = sv["prompt_len"] + sv["new_tokens"]
    pred = dryrun.analyze_step(cfg, wave, device="cuda", max_len=max_len)
    params = lm.init_params(cfg, seed=0, device="cuda")
    batch = {"tokens": torch.from_numpy(gen.integers(
        0, cfg.vocab, (sv["wave"], sv["prompt_len"]), dtype=np.int32)).cuda()}

    def prefill():
        with torch.no_grad():
            return lm.prefill(params, cfg, batch, max_len=max_len)

    prefill()                                      # the first wave
    real = _card_step(prefill, (params, batch))
    out["granite_prefill"] = _hold_prediction(
        f"granite-3-2b prefill {sv['wave']} x {sv['prompt_len']} (cache "
        f"{max_len})", pred, real, prefill)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def capsnet_cell(CAPS) -> dict:
    """(b) Caps-MN1 at full width, B = 100: phase 5's training step
    (``make_capsnet_train_step(cfg, plan="auto")``), the second step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import capsnet
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_loop import make_capsnet_train_step
    cfg = CAPS["Caps-MN1"]
    step = make_capsnet_train_step(cfg, plan="auto")
    # resolved on a real tensor first: the plan's default mesh exists
    step.router.resolve(torch.zeros((cfg.batch_size, cfg.num_l_caps,
                                     cfg.num_h_caps, cfg.h_caps_dim),
                                    device="cuda"))
    b = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                             cfg.num_h_caps).batch(0, cfg.batch_size)
    t0 = time.perf_counter()
    with FakeTensorMode():
        net = capsnet.CapsNet(cfg, device="cuda", seed=0)
        opt = adamw_init(dict(net.named_parameters()))
        images = torch.empty(b["images"].shape, device="cuda")
        labels = torch.empty(b["labels"].shape, device="cuda",
                             dtype=torch.from_numpy(b["labels"]).dtype)
        with OpAnalysis() as a:
            a.arguments(dict(net.named_parameters()), opt, images, labels)
            a.outputs(step(net, opt, images, labels))
    pred = {"memory": a.memory(), "ops": a.stats.as_dict(),
            "trace_s": round(time.perf_counter() - t0, 2)}
    del net, opt, images, labels
    net = capsnet.CapsNet(cfg, device="cuda", seed=0)
    opt = adamw_init(dict(net.named_parameters()))
    images = torch.from_numpy(b["images"]).cuda()
    labels = torch.from_numpy(b["labels"]).cuda()
    state = {"opt": opt}

    def train():
        _, state["opt"], metrics = step(net, state["opt"], images, labels)
        return metrics

    train()                                        # step 1
    real = _card_step(train, (dict(net.named_parameters()), state["opt"],
                              images, labels))
    return {"capsnet_train": _hold_prediction(
        f"Caps-MN1 training step B={cfg.batch_size}, steps 2 and 3", pred,
        real, train)}


def phase_dryrun(jobs: DryrunJobs, CAPS) -> dict:
    """Phase 17: (a) the children's dry runs; (b) three cells dry-run on
    fake CUDA tensors and run on the card."""
    parts = {}
    t0 = time.perf_counter()
    a = dryrun_a(jobs)
    parts["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = granite_cells()
    parts["granite"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b.update(capsnet_cell(CAPS))
    parts["capsnet"] = time.perf_counter() - t0
    misses = [k for k, cell in b.items() if not cell["within"]]
    print(f"[dryrun] (b) predicted peaks within {PEAK_REL_LIMIT * 100:.0f} "
          f"%: {len(b) - len(misses)} of {len(b)}"
          + (f"; missed: {', '.join(misses)}" if misses else ""))
    launches = {}
    for cell in b.values():
        for k, v in cell["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"[kernels] phase 17 (b) launches, the cells' measured steps: "
          + ", ".join(f"{k} {v}" for k, v in sorted(launches.items())))
    print(f"[dryrun] phase 17 parts (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return {"a": a, "b": b, "launches": launches, "parts_s": parts}


# ---------------------------------------------------------------------------
# phase 18: head dims above 256, and the examples' twins
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, D, causal, dtype, window): the shape the d_head 320
# model's prefill and training step give the kernels (granite-3-2b's
# heads at D = 320) first, in bf16 and fp32 (the model's two arms), then
# (4, 16, 4, 1024, D) causal at D = 288 and 512, cross attention of Sq 256
# over Sk 1024 at D = 320, a 256 window at D = 384, small odd shapes at
# D = 288, 300 and 257 (rows of 600 and 514 bytes in bf16, not 16-byte
# aligned; in fp32 not a multiple of 16 bytes at D = 257 and 300), and
# above 512, where o and dq are cut into pieces, (2, 8, 2, 1024, 640)
# causal and cross attention at D = 1024; fp32 and bf16
WIDE_CHECKS = [(4, 32, 8, 1024, 320, True, dt, None)
               for dt in ("bf16", "fp32")] + [
    (B, Hq, Hkv, S, D, causal, dt, window)
    for B, Hq, Hkv, S, D, causal, window in (
        (4, 16, 4, 1024, 288, True, None), (4, 16, 4, 1024, 512, True, None),
        (4, 16, 16, (256, 1024), 320, False, None),
        (1, 8, 2, 2048, 384, True, 256),
        (2, 4, 2, (37, 200), 288, False, None),
        (1, 4, 2, 1023, 288, True, None),
        (2, 4, 2, (37, 200), 300, False, None),
        (1, 4, 2, 1023, 257, True, None),
        (2, 8, 2, 1024, 640, True, None),
        (2, 8, 8, (256, 1024), 1024, False, None))
    for dt in ("fp32", "bf16")]
# granite-3-2b at full width with a head dim of 320 (32 query heads over 8
# KV heads: q is 10240 wide), cut to 4 of its 40 layers, in bf16 and in
# fp32 (~0.5 B parameters, under 10 GB with AdamW's moments; the plain
# route's fp32 scores 512 MB a layer)
WIDE_MODEL = dict(arch="granite-3-2b", d_head=320, layers=4, batch=4,
                  seq=1024, dtypes=("bf16", "fp32"))
# the fp32 arm's gates: the script's fp32 limits for the same comparisons
# (logits: the decode checks' 1e-4 of max|logit|; gradients: the fp32 MoE
# kernel-vs-plain-route limit)
WIDE_FP32_LOGIT_REL_LIMIT = 1e-4
# granite-3-2b at full width in fp32 at its d_head of 64 (the split-TF32
# kernels; the full config is bf16, its smoke config, which the CLIs'
# --smoke runs, fp32, so the dtype is set here as in the d_head 320 fp32
# arm): a prefill of batch × seq at all 40 layers and a training step at
# that arm's cut of 4, each counted and held to the plain route under its
# fp32 gates; the attention kernels' share of each call's device time
GRANITE_FP32 = dict(arch="granite-3-2b", prefill_layers=40, train_layers=4,
                    batch=4, seq=1024)
WIDE_TIMING = dict(runs=5, warmup=1)      # the plain fp32 backward at D =
                                          # 1024 takes tens of ms a call
WIDE_SOURCE = "src/repro_torch/csrc/flash_attention_wide.cu"


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend SDPA picks for these arguments."""
    from torch.nn.attention import SDPBackend
    names = {int(getattr(SDPBackend, n)): n for n in (
        "MATH", "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")}
    choice = int(torch._fused_sdp_choice(q, k, v, **kw))
    return names.get(choice, str(choice))


def wide_library(q, k, v, causal: bool, window, do) -> dict:
    """The library's calls for the same functions, on KV heads expanded to
    the query heads (SDPA picks no fused backend with ``enable_gqa`` here):
    SDPA's forward with a boolean band mask for a window, its autograd
    backward, and the memory-efficient op's o and lse where it takes the
    head dim (else no lse and no ``fwd_lse`` call).  Returns the calls,
    their outputs (dk, dv summed over each KV head's group in fp32) and the
    backend SDPA chose."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kx, vx = (t.repeat_interleave(group, dim=1) for t in (k, v))
    mask = band_mask(S, window) if window is not None else None
    kw = dict(attn_mask=mask, is_causal=causal and mask is None)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"backend": sdpa_backend(q, kx, vx, **kw)}
    out["fwd"] = lambda: sdpa(q, kx, vx, **kw)
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q, kx, vx))
    with torch.enable_grad():
        o_lib = sdpa(qg, kg, vg, **kw)
    out["bwd"] = lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                             retain_graph=True)
    ldq, ldk, ldv = out["bwd"]()
    out["o"], out["dq"] = o_lib.detach(), ldq
    out["dk"], out["dv"] = (t.float().view(B, Hkv, group, Sk, D).sum(2)
                            .to(q.dtype) for t in (ldk, ldv))
    bias = None
    if mask is not None:
        bias = torch.zeros(B, Hq, S, S, dtype=q.dtype, device=q.device)
        bias.masked_fill_(~mask, float("-inf"))
    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    try:
        lse = efficient(q, kx, vx, bias, True, 0.0, causal and mask is None
                        )[1]
        out["lse"] = lse[..., :S].float()
        out["fwd_lse"] = lambda: efficient(q, kx, vx, bias, True, 0.0,
                                           causal and mask is None)
    except RuntimeError as e:
        print(f"[wide] the memory-efficient op refuses D={D}: "
              f"{str(e).splitlines()[0][:160]}; no library lse")
        out["lse"] = out["fwd_lse"] = None
    return out


def check_wide(fk, case, gen, rows, profile: bool = False) -> None:
    """The three flash-attention kernels at one shape of a head dim above
    256, where they run on the wide kernels: two calls of each bitwise
    equal, each launch counted; held to the plain versions (fp32:
    ``lm_close`` on o, lse, dq and ``grouped_close`` on dk, dv; bf16: the
    same one-ulp gate's verdict printed, and each output's max|Δ| from the
    plain rounding model at the kernels' 64 × 64 tiles) and in bf16 by
    ``lib_gate`` against float64, anchored on the library
    (``wide_library``); event times beside the plain versions', the bound
    and the library's, and with ``profile`` the device times."""
    B, Hq, Hkv, S, Sk, D, causal, dt, window = (*case_dims(case[:7]),
                                                  case[7])
    dtype = LM_DTYPES[dt]
    q, do = (torch.randn(B, Hq, S, D, generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window)
    label = f"wide {case}"
    before = read_counts()
    o_s = fk.flash_attention(q, k, v, **kw)
    o, lse = fk.flash_attention_fwd_lse(q, k, v, **kw)
    grads = fk.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = (fk.flash_attention(q, k, v, **kw),
             *fk.flash_attention_fwd_lse(q, k, v, **kw),
             *fk.flash_attention_bwd(q, k, v, o, lse, do, **kw))
    torch.cuda.synchronize()
    after = read_counts()
    check(all(after[n] - before[n] == 2 for n in (
        "flash_attention", "flash_attention_fwd_lse", "flash_attention_bwd")),
        f"{label}: the launch counters moved {before} -> {after}")
    check(all(torch.equal(a, b) for a, b in zip((o_s, o, lse, *grads),
                                                 again)),
          f"{label}: two calls differ")
    del again
    p_o, p_lse = fk.flash_attention_fwd_lse_plain(q, k, v, **kw)
    dq_p, dk_h, dv_h = fk.flash_attention_bwd_heads_plain(q, k, v, o, lse,
                                                          do, **kw)
    dk_p, dv_p = (fk.group_sum(t, Hkv, k.dtype) for t in (dk_h, dv_h))
    got = {"o_serve": o_s, "o": o, "lse": lse, "dq": grads[0],
           "dk": grads[1], "dv": grads[2]}
    plain = {"o_serve": p_o, "o": p_o, "lse": p_lse, "dq": dq_p, "dk": dk_p,
             "dv": dv_p}
    errs, excess = {}, {}
    for name in got:
        if name in ("dk", "dv") and dtype == torch.bfloat16:
            heads = dk_h if name == "dk" else dv_h
            errs[name], excess[name] = grouped_excess(got[name], plain[name],
                                                      heads)
        else:
            errs[name], excess[name] = ulp_excess(got[name], plain[name])
        if dtype == torch.float32:
            check(excess[name] <= 0.0, f"{label} {name}: max|Δ| "
                  f"{errs[name]:.3g} over its tolerance by "
                  f"{excess[name]:.3g}")
    del dq_p, dk_h, dv_h, dk_p, dv_p, p_lse
    model_err = {}
    if dtype == torch.bfloat16:   # the tensor-core kernels round p and ds
        m_o = fk.flash_attention_plain(q, k, v, block_q=64, block_k=64,
                                       round_operands=True, **kw)
        m_dq, m_dk, m_dv = fk.flash_attention_bwd_heads_plain(
            q, k, v, o, lse, do, block_q=64, block_k=64,
            round_operands=True, **kw)
        model = {"o_serve": m_o, "o": m_o, "dq": m_dq,
                 "dk": fk.group_sum(m_dk, Hkv, k.dtype),
                 "dv": fk.group_sum(m_dv, Hkv, v.dtype)}
        model_err = {n: float((got[n].float() - m.float()).abs().max())
                     for n, m in model.items()}
        del m_o, m_dq, m_dk, m_dv, model
    lib = wide_library(q, k, v, causal, window, do)
    gates = {}
    if dtype == torch.bfloat16:
        exact = attention_f64(q, k, v, causal, do, window=window)
        for name in ("o", "lse", "dq", "dk", "dv"):
            if lib[name] is None:
                check(excess[name] <= 0.0, f"{label} {name}: max|Δ| "
                      f"{errs[name]:.3g} from the plain version")
                continue
            gates[name] = lib_gate(f"{label} {name}", got[name], lib[name],
                                   exact[name])
        del exact
    t = dict(WIDE_TIMING)
    ms = {"fwd": timed_ms(lambda: fk.flash_attention(q, k, v, **kw), **t),
          "fwd_lse": timed_ms(lambda: fk.flash_attention_fwd_lse(
              q, k, v, **kw), **t),
          "bwd": timed_ms(lambda: fk.flash_attention_bwd(
              q, k, v, o, lse, do, **kw), **t)}
    plain_ms = {
        "fwd": timed_ms(lambda: fk.flash_attention_plain(q, k, v, **kw), **t),
        "fwd_lse": timed_ms(lambda: fk.flash_attention_fwd_lse_plain(
            q, k, v, **kw), **t),
        "bwd": timed_ms(lambda: fk.flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), **t)}
    lib_ms = {kind: (timed_ms(lib[kind], **t) if lib[kind] else None)
              for kind in ("fwd", "fwd_lse", "bwd")}
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    common = {"route": "wide", "B": B, "Hq": Hq, "Hkv": Hkv, "S": S,
              "Sk": Sk, "D": D, "causal": causal, "window": window,
              "dtype": dt, "library_backend": lib["backend"]}
    notes = []
    for kind, name, outs in (
            ("fwd", "flash_attention", ("o_serve",)),
            ("fwd_lse", "flash_attention_fwd_lse", ("o", "lse")),
            ("bwd", "flash_attention_bwd", ("dq", "dk", "dv"))):
        flops, nbytes = fk.attention_cost(kind, q, k, causal, window)
        b_ms, b_by = bound(nbytes, flops, rate)
        dev = None
        if profile:
            call = {"fwd": lambda: fk.flash_attention(q, k, v, **kw),
                    "fwd_lse": lambda: fk.flash_attention_fwd_lse(
                        q, k, v, **kw),
                    "bwd": lambda: fk.flash_attention_bwd(
                        q, k, v, o, lse, do, **kw)}[kind]
            dev = device_ms(call, runs=10, warmup=2, bound_ms=b_ms)["ms"]
        rows.append({"kernel": name, **common,
                     "max_abs_err": max(errs[n] for n in outs),
                     "rounding_model_err": max(
                         (model_err[n] for n in outs if n in model_err),
                         default=None),
                     "ulp_gate": {n: excess[n] <= 0.0 for n in outs},
                     "gate": {n: gates[n] for n in outs if n in gates},
                     "ms": ms[kind], "device_ms": dev,
                     "plain_ms": plain_ms[kind], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms[kind]})
        lib_txt = (f"library {lib_ms[kind]:.4f}" if lib_ms[kind] else
                   "no library call")
        dev_txt = f" / device {dev:.4f}" if dev else ""
        notes.append(f"{kind} {ms[kind]:.4f}{dev_txt} ms (plain "
                     f"{plain_ms[kind]:.3f}, bound {b_ms:.4f} {b_by}, "
                     f"{lib_txt})")
    verdict = ", ".join(
        f"{n} {errs[n]:.2e}{'' if excess[n] <= 0 else ' (over one ulp)'}"
        for n in got) + "".join(
        f"; {n} from the plain rounding model {e:.2e}"
        for n, e in model_err.items())
    print(f"[wide] B={B} Hq={Hq} Hkv={Hkv} S={S}"
          f"{f' Sk={Sk}' if Sk != S else ''} D={D} causal={causal}"
          f"{f' window={window}' if window else ''} {dt}: max|Δ| from the "
          f"plain versions {verdict}; two calls bitwise equal; "
          + "; ".join(notes) + f"; SDPA backend {lib['backend']}")
    if gates:
        print(f"[wide]   {label}: " + "; ".join(
            f"{n} gate {gate_line(g)}" for n, g in gates.items()))


def wide_model(card: str, dt: str) -> dict:
    """The main path at a head dim above 256: granite-3-2b at full width
    with ``d_head`` 320 (``WIDE_MODEL``), random weights in ``dt`` (the bf16
    arm runs the tensor-core wide kernels, the fp32 arm the CUDA-core
    ones): ``model_arm`` at ``WIDE_MODEL``'s cut for both calls, each
    dry-run against the card."""
    from repro_torch import configs
    m = WIDE_MODEL
    cfg = dataclasses.replace(configs.with_layers(
        configs.get_config(m["arch"]), m["layers"]), d_head=m["d_head"],
        dtype=LM_DTYPES[dt])
    return model_arm(card, cfg, cfg, m["batch"], m["seq"], dryrun_too=True)


def granite_fp32(card: str) -> dict:
    """The fp32 route at D ≤ 256 at full width: granite-3-2b in fp32 at its
    own head dim (``GRANITE_FP32``), the split-TF32 kernels: ``model_arm``
    with a prefill at all 40 layers and a training step at 4, and the
    attention kernels' share of each."""
    from repro_torch import configs
    m = GRANITE_FP32
    full = dataclasses.replace(configs.get_config(m["arch"]),
                               dtype=torch.float32)
    return model_arm(card, configs.with_layers(full, m["prefill_layers"]),
                     configs.with_layers(full, m["train_layers"]), m["batch"],
                     m["seq"], share_of=F32_TC_KERNELS)


def kernel_share(fn, names, runs: int = 1) -> dict:
    """The device time of one call of ``fn`` (the CUDA kernels, fills and
    copies of ``runs`` calls by ``torch.profiler``, after one call
    unprofiled, summed and divided by ``runs``) and the part of it in
    kernels whose names hold one of ``names``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = part = 0.0
    for e in prof.events():
        if not device_op(e):
            continue
        us = e.time_range.end - e.time_range.start
        total += us
        if any(n in e.name for n in names):
            part += us
    total, part = total / 1e3 / runs, part / 1e3 / runs
    return {"device_ms": total, "kernels_ms": part,
            "share": part / total if total else None}


def model_arm(card: str, cfg, cfg_train, B: int, S: int,
              dryrun_too: bool = False, share_of: tuple = ()) -> dict:
    """A model's main path on random weights (seed 0): a prefill of B × S
    at ``cfg`` and one training step (remat) at ``cfg_train`` (the same
    model at another depth, or the same), each counted (one
    ``flash_attention`` launch a layer; ``train_attention_launches``), the
    kernel route against the plain route (prefill logits and first tokens,
    phase 8's gate, in fp32 under ``WIDE_FP32_LOGIT_REL_LIMIT``;
    whole-tree gradients, ``TRAIN_GRAD_REL_LIMIT``, in fp32
    ``MOE_GRAD_REL_LIMIT``); with ``dryrun_too`` each dry-run on fake CUDA
    tensors against the card (phase 17 (b)'s ``_hold_prediction``: kernel
    calls = launches, product FLOPs equal); with ``share_of`` the share of
    each call's device time in those kernels (``kernel_share``)."""
    from repro_torch import configs
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.runtime import train_loop
    fp32 = cfg.dtype == torch.float32
    dt = "fp32" if fp32 else "bf16"
    logit_limit = WIDE_FP32_LOGIT_REL_LIMIT if fp32 else LOGIT_REL_LIMIT
    grad_limit = MOE_GRAD_REL_LIMIT if fp32 else TRAIN_GRAD_REL_LIMIT
    print(f"[wide] {cfg.name} at full width with d_head {cfg.d_head}: "
          f"{cfg.n_layers} layers (training {cfg_train.n_layers}), d_model "
          f"{cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv} KV heads"
          f" (q {cfg.n_heads * cfg.d_head} wide), "
          f"{cfg.param_count() / 1e9:.3f} B parameters in {cfg.dtype} "
          f"(random, seed 0), remat={cfg.remat}")
    out = {}
    params = lm.init_params(cfg, seed=0, device="cuda")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).cuda()}

    def prefill():
        with torch.no_grad():
            return lm.prefill(params, cfg, batch, max_len=S)

    torch.cuda.synchronize()
    for fn in lm_counters():
        fn.launches = 0
    t0 = time.perf_counter()
    logits_k, _ = prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = read_counts()
    check(prefill_counts == {"flash_attention": cfg.n_layers,
                             "flash_attention_fwd_lse": 0,
                             "flash_attention_bwd": 0, "selective_scan": 0},
          f"the d_head {cfg.d_head} prefill launched {prefill_counts}")
    with plain_lm_path():
        logits_p, _ = prefill()
    out["prefill"] = first_token_agreement(
        f"{cfg.name} d_head {cfg.d_head} {dt} ({cfg.n_layers} layers, {B} x "
        f"{S})", logits_k, logits_p, limit=logit_limit)
    out["prefill"]["ms"] = prefill_ms
    del logits_k, logits_p
    if share_of:
        out["prefill_share"] = kernel_share(prefill, share_of)
    if dryrun_too:
        pred = dryrun.analyze_step(cfg, configs.ShapeCell(
            "wide_prefill", S, B, "prefill"), device="cuda", max_len=S)
        out["prefill_dryrun"] = _hold_prediction(
            f"{cfg.name} d_head {cfg.d_head} {dt} prefill {B} x {S}", pred,
            _card_step(prefill, (params, batch)), prefill)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    prefill_layers, cfg = cfg.n_layers, cfg_train
    params, opt = train_loop.init_train_state(cfg, seed=0, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=S).batch(0, B).items()}
    step = train_loop.make_train_step(cfg)
    torch.cuda.synchronize()
    for fn in lm_counters():
        fn.launches = 0
    t0 = time.perf_counter()
    _, _, metrics = step(params, opt, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    train_counts = read_counts()
    check_train_launches(cfg, train_counts, 1)
    check(np.isfinite(loss), f"the d_head {cfg.d_head} step: loss {loss}")
    loss_k, g_k = tree_grads(params, cfg, batch)
    with plain_train_path():
        loss_p, g_p = tree_grads(params, cfg, batch)
    delta = max(float((g_k[k].float() - g_p[k].float()).abs().max())
                for k in g_k)
    scale = max(float(g.float().abs().max()) for g in g_p.values())
    rel = delta / scale
    check(all(bool(torch.isfinite(g).all()) for g in g_k.values()),
          f"the d_head {cfg.d_head} {dt} kernel route: non-finite "
          f"gradients")
    check(rel < grad_limit, f"the d_head {cfg.d_head} {dt} kernel route vs "
          f"plain route: max|Δg| / max|g| {rel:.3e} is over {grad_limit}")
    del g_k, g_p
    print(f"[wide] {cfg.name} d_head {cfg.d_head} {dt} training step {B} x "
          f"{S}: "
          f"loss {loss:.4f}, {step_ms:.1f} ms (the first step), launches "
          f"{train_counts}; kernel route vs plain route on the card: loss "
          f"{loss_k:.6f} vs {loss_p:.6f}, whole-tree gradients max|Δ| "
          f"{delta:.4g} = {rel:.3e} of max|g| {scale:.4g} (limit "
          f"{grad_limit}); prefill {prefill_ms:.1f} ms")
    out["train"] = {"loss": loss, "step_ms": step_ms, "loss_kernel": loss_k,
                    "loss_plain": loss_p, "max_abs_diff": delta,
                    "max_abs_grad": scale, "rel_diff": rel}
    if share_of:
        out["train_share"] = kernel_share(lambda: step(params, opt, batch),
                                          share_of)
        print(f"[wide] {cfg.name} {dt}: the attention kernels' share of "
              f"device time: prefill ({prefill_layers} layers) "
              f"{out['prefill_share']['kernels_ms']:.3f} of "
              f"{out['prefill_share']['device_ms']:.3f} ms "
              f"({out['prefill_share']['share']:.2%}), training step "
              f"({cfg.n_layers} layers) {out['train_share']['kernels_ms']:.3f}"
              f" of {out['train_share']['device_ms']:.3f} ms "
              f"({out['train_share']['share']:.2%}) on {card}")
    if dryrun_too:
        pred = dryrun.analyze_step(cfg, configs.ShapeCell(
            "wide_train", S, B, "train"), device="cuda")
        out["train_dryrun"] = _hold_prediction(
            f"{cfg.name} d_head {cfg.d_head} {dt} training {B} x {S}", pred,
            _card_step(lambda: step(params, opt, batch),
                       (params, opt, batch)),
            lambda: step(params, opt, batch))
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = {k: prefill_counts[k] + train_counts[k]
                       for k in prefill_counts}
    return out


def examples_on_card(card: str) -> dict:
    """The six examples' twins (``examples/torch_*.py``) on the card at
    their smoke sizes, each through its ``main``: the five single-process
    ones in this process, ``torch_distributed_routing`` on two gloo ranks
    sharing the card under ``RANK_TIMEOUT_S``; each held to the claim its
    docstring makes."""
    import importlib
    import tempfile
    if os.path.join(ROOT, "examples") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "examples"))  # spawned ranks
                                                            # inherit it

    def run(name, argv):
        res, _, wall = captured(f"[examples] {name}",
                                importlib.import_module(name).main, argv)
        print(f"[examples] {' '.join([name, *argv])}: {wall:.1f} s on {card}")
        return res, wall

    out = {}
    q, out["torch_quickstart"] = run("torch_quickstart", [])
    check(q["kernel"]["launches"] == 1 and
          q["kernel"]["kernel_vs_plain"] <= TOL and
          q["kernel"]["backend_err"] <= TOL and
          q["approx"]["same_classification"] and
          bool(torch.isfinite(q["class_probs"]).all()),
          f"torch_quickstart: {q['kernel']}, {q['approx']}")
    work, full = q["deep_edge"]["work"], q["deep_edge"]["full"]
    check(work[0.0] == full and work[1e6] < full,
          f"torch_quickstart: early-exit work {work} of {full}")
    d, out["torch_distributed_routing"] = run(
        "torch_distributed_routing", ["-n", "2", "--timeout",
                                      str(RANK_TIMEOUT_S)])
    gate = 2e-5 + 2e-4          # the sharded gate at |v| < 1 (squashed)
    errs = {k: r["err"] for k, r in d.items()
            if isinstance(r, dict) and "err" in r}
    check(len(errs) == 8 and max(errs.values()) <= gate and all(
        "all-reduce" in d[f"{dim}_{b}"]["collectives"]
        for dim in "BLH" for b in ("torch", "cuda")) and max(
        max(d[f"EM_L_{b}"].values()) for b in ("torch", "cuda")) <= 1e-4,
        f"torch_distributed_routing on 2 ranks: {d}")
    s, out["torch_serve_capsnet"] = run("torch_serve_capsnet", [])
    check(s["ragged"]["completed"] == 16 and s["pipelined_gap"] <= TOL and
          s["auto_gap"] <= 1e-4 and s["async"]["submitted"] == 12
          == s["async"]["completed"] + s["async"]["shed"],
          f"torch_serve_capsnet: {s}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ["--ckpt-dir", tmp]
        a, wall_a = run("torch_train_capsnet",
                        ["--smoke", "--steps", "6", *ckpt])
        b, wall_b = run("torch_train_capsnet",
                        ["--smoke", "--routing", "fused", *ckpt])
    check(a["start"] == 0 and b["start"] == 6 and
          sorted(b["losses"]) == list(range(7, 13)) and
          all(np.isfinite(x) for r in (a, b) for x in r["losses"].values()),
          f"torch_train_capsnet: resumed at {b['start']}, steps "
          f"{sorted(b['losses'])}")
    out["torch_train_capsnet"] = wall_a + wall_b
    g, out["torch_serve_lm"] = run("torch_serve_lm", [])
    check(tuple(g["tokens"].shape) == (4, 32) and g["deterministic"],
          f"torch_serve_lm: {g['tokens'].shape}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ["--ckpt-dir", tmp, "--ckpt-every", "10"]
        a, wall_a = run("torch_train_lm", ["--steps", "20", *ckpt])
        b, wall_b = run("torch_train_lm", ["--steps", "24", *ckpt])
    check(a["fell"] and b["start"] == 20 and
          sorted(b["losses"]) == [21, 22, 23, 24],
          f"torch_train_lm: fell {a['fell']}, resumed at {b['start']}")
    out["torch_train_lm"] = wall_a + wall_b
    print(f"[examples] the six twins on {card}: the claims hold "
          f"(B/L/H shardings equal, pipelined scores equal unpipelined, the "
          f"loss falls, resume is step-indexed)")
    return {"wall_s": out}


def phase_wide(card: str) -> dict:
    """Phase 18: the wide kernels against their plain versions, the d_head
    320 model's main path, granite-3-2b's fp32 main path at D = 64 (the
    split-TF32 kernels), and the examples' twins."""
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device="cuda").manual_seed(18)
    parts, rows = {}, []
    t0 = time.perf_counter()
    for i, case in enumerate(WIDE_CHECKS):
        check_wide(fk, case, gen, rows, profile=i < 2)  # the model's shape
        gc.collect()
        torch.cuda.empty_cache()
    parts["kernels"] = time.perf_counter() - t0
    model = {}
    for dt in WIDE_MODEL["dtypes"]:
        t0 = time.perf_counter()
        model[dt] = wide_model(card, dt)
        parts[f"model_{dt}"] = time.perf_counter() - t0
        print(f"[kernels] phase 18 launches, the d_head 320 model's counted "
              f"prefill and step, {dt}: " + ", ".join(
                  f"{k} {v}" for k, v in sorted(
                      model[dt]["launches"].items())))
    print("[wide] the d_head 320 model, prefill / first training step: "
          + "; ".join(f"{dt} {model[dt]['prefill']['ms']:.1f} / "
                      f"{model[dt]['train']['step_ms']:.1f} ms"
                      for dt in model))
    t0 = time.perf_counter()
    granite = granite_fp32(card)
    parts["granite_fp32"] = time.perf_counter() - t0
    print(f"[kernels] phase 18 launches, granite-3-2b fp32's counted prefill "
          f"({GRANITE_FP32['prefill_layers']} layers) and step "
          f"({GRANITE_FP32['train_layers']} layers): " + ", ".join(
              f"{k} {v}" for k, v in sorted(granite["launches"].items())))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    examples = examples_on_card(card)
    parts["examples"] = time.perf_counter() - t0
    print(f"[wide] phase 18 parts (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return {"kernels": rows, "model": model, "granite_fp32": granite,
            "examples": examples,
            "launches": {**{dt: model[dt]["launches"] for dt in model},
                         "granite_fp32": granite["launches"]},
            "parts_s": parts}


def summary(kernel_rows, serve, train, em, fastmath, sharded, lm,
            lm_train, fleet, moe, mixtral, slice11, vlm_encdec,
            shard, launch, dryrun, wide) -> dict:
    """One entry per kernel.  ``launches`` counts each main path's run
    (serving, the fleet's clean arm and the training steps for the
    procedure kernel, serving for the iteration kernel, training for the
    backward;
    EM serving; the fast-math entry points; the auto-plan sharded serving
    for the stage kernels, and the L plan's serving for the fold, which
    the auto plan does not take; granite-3-2b, qwen3-moe-30b-a3b,
    mixtral-8x7b, phi3-medium-14b, mistral-large-123b, stablelm-12b,
    zamba2-7b, llava-next-mistral-7b and seamless-m4t-large-v2 serving, and
    granite-3-2b's sharded generate on every rank and the serve CLI on
    two ranks (phase 16), for flash attention,
    falcon-mamba-7b's counted prefill for the scan, granite-3-2b's,
    qwen3-moe-30b-a3b's, stablelm-12b's, zamba2-7b's,
    llava-next-mistral-7b's and seamless-m4t-large-v2's counted training
    steps, granite-3-2b's sharded steps on every rank and the train CLI's
    steps on one NCCL rank (phase 16), for the two training kernels; and
    the two-stage serving CLI on two ranks for the procedure kernel; and
    the measured steps of phase 17 (b): granite-3-2b's training step and
    prefill for the three flash-attention kernels, Caps-MN1's training
    step for the procedure kernel and its backward); the routing times are
    those of Caps-MN1 at B=100, fp32, at the tile its path uses (for EM,
    with the serving mask as a_in), the fast-math times those of exp with
    recovery at 2^26 elements, whose ``library_ms`` is ``torch.exp`` (the
    exact function, not the same one); the LM kernels' times those of
    their main paths' shapes in bf16 (the falcon-mamba-7b prefill's scan
    without h0; the three flash-attention kernels at mixtral-8x7b's
    windowed shape, B=1, Hq=32, Hkv=8, S=8192, D=128, window 4096), whose
    ``library_ms`` is SDPA with the boolean band mask (for the backward its
    autograd backward); and the wide route of the three flash-attention
    kernels (head dims above 256: ``flash_attention_wide.cu``), launched by
    phase 18's d_head 320 model (its counted prefill and training step;
    the bf16 arm's tensor-core kernels, and as ``..._wide_fp32`` the fp32
    arm's CUDA-core ones), timed at that model's shape (4, 32, 8, 1024,
    320) in the arm's dtype, whose
    ``library_ms`` is SDPA on expanded KV heads (the backend it chose is in
    phase 18's rows) and, for the training forward, the memory-efficient
    op where it takes the head dim (else null); and, as ``..._fp32``, the
    split-TF32 kernels (fp32 at D ≤ 256), launched by phase 18's
    granite-3-2b fp32 arm (its counted prefill and training step), timed at
    (4, 32, 4, 1024, 128) causal fp32 in phases 8 and 9, whose
    ``library_ms`` is SDPA's fp32 call (the memory-efficient op with lse
    for the training forward, SDPA's autograd backward)."""
    out = []
    launches = {
        "routing_procedure_fused":
            serve["main_launches"]["routing_procedure_fused"]
            + fleet["main_launches"]["routing_procedure_fused"]
            + train["main_launches"]["routing_procedure_fused"]
            + launch["launches"]["routing_procedure_fused"]
            + dryrun["launches"].get("routing_procedure_fused", 0),
        "routing_iteration_fused":
            serve["fallback_launches"]["routing_iteration_fused"],
        "routing_procedure_bwd":
            train["main_launches"]["routing_procedure_bwd"]
            + dryrun["launches"].get("routing_procedure_bwd", 0),
    }
    rows_all = kernel_rows + train["backward"]
    for name in ("routing_procedure_fused", "routing_iteration_fused",
                 "routing_procedure_bwd"):
        rows = [r for r in rows_all if r["kernel"] == name]
        main = next(r for r in rows if r["shape"] == "Caps-MN1"
                    and r["variant"] == "fp32")
        out.append({"name": name, "route": "cuda",
                    "source": KERNEL_SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": main["ms"], "device_ms": main["device_ms"],
                    "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": None})
    for name in ("em_stage_stats", "em_stage_estep"):
        rows = [r for r in em["kernels"] if r["kernel"] == name]
        main = next(r for r in rows if r["shape"] == "Caps-MN1"
                    and r["variant"] == "mask")
        out.append({"name": name, "route": "cuda",
                    "source": KERNEL_SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": em["main_launches"][name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": main["ms"], "device_ms": main["device_ms"],
                    "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": None})
    for name in STAGE_KERNELS:
        rows = [r for r in sharded["kernels"] if r["kernel"] == name]
        main = next(r for r in rows if r["shape"] == "Caps-MN1"
                    and r["variant"] in ("fp32 -", "fp32 exact"))
        launches = sharded["main_launches"][name]
        if launches == 0:       # the path the main plan does not take
            launches = sharded["fold_launches"][name]
        out.append({"name": name, "route": "cuda",
                    "source": KERNEL_SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": launches,
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": main["ms"], "device_ms": main["device_ms"],
                    "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": None})
    main = next(r for r in fastmath["rows"] if r["op"] == "exp"
                and r["recover"])
    out.append({"name": "fastmath_2d", "route": "cuda",
                "source": KERNEL_SOURCE["fastmath_2d"],
                "replaces": REPLACES["fastmath_2d"],
                "launches": fastmath["launches"],
                "max_abs_err": max(r["max_abs_err"] for r in fastmath["rows"]),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"]})
    served = [lm["granite"], moe, mixtral["serve"],
              *slice11["serve"].values(), *vlm_encdec["serve"].values()]
    trained = [lm_train["granite"], mixtral["train"]["qwen"],
               *slice11["train"].values(), *vlm_encdec["train"].values()]
    launches = {"flash_attention": sum(r["launches"]["flash_attention"]
                                       for r in served)
                + shard["launches"]["flash_attention"]
                + launch["launches"]["flash_attention"]
                + dryrun["launches"].get("flash_attention", 0),
                "selective_scan": lm["falcon"]["launches"]["selective_scan"],
                "flash_attention_fwd_lse": sum(
                    r["launches"]["flash_attention_fwd_lse"]
                    for r in trained)
                + shard["launches"]["flash_attention_fwd_lse"]
                + launch["launches"]["flash_attention_fwd_lse"]
                + dryrun["launches"].get("flash_attention_fwd_lse", 0),
                "flash_attention_bwd": sum(
                    r["launches"]["flash_attention_bwd"] for r in trained)
                + shard["launches"]["flash_attention_bwd"]
                + launch["launches"]["flash_attention_bwd"]
                + dryrun["launches"].get("flash_attention_bwd", 0)}
    lm_rows = (lm["kernels"] + moe["kernels"] + lm_train["kernels"]
               + mixtral["kernels"] + mixtral["train"]["kernels"]
               + slice11["kernels"] + vlm_encdec["kernels"]
               + shard["kernels"])
    swa_main = {r["kernel"]: r for r in mixtral["kernels"]
                if r["S"] == SWA_CHECKS[0][3] and r["dtype"] == "bf16"}
    for name in ("flash_attention", "selective_scan",
                 "flash_attention_fwd_lse", "flash_attention_bwd"):
        rows = [r for r in lm_rows if r["kernel"] == name]
        # mixtral's windowed shape in bf16; the scan: falcon's, no h0
        main = swa_main.get(name, rows[0])
        out.append({"name": name, "route": "cuda",
                    "source": KERNEL_SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"]})
    # the split-TF32 kernels (fp32, D <= 256): launched by phase 18's
    # granite-3-2b fp32 arm, timed at qwen3-moe's shape (4, 32, 4, 1024,
    # 128) causal fp32 (phases 8 and 9)
    f32_rows = [r for r in lm["kernels"] + lm_train["kernels"]
                if r.get("dtype") == "fp32" and r.get("D", 0) <= 256
                and r["kernel"].startswith("flash_attention")]
    for name in ("flash_attention", "flash_attention_fwd_lse",
                 "flash_attention_bwd"):
        rows = [r for r in f32_rows if r["kernel"] == name]
        main = next(r for r in rows if (r["B"], r["Hq"], r["Hkv"], r["S"],
                                        r["D"], r["window"]) ==
                    (4, 32, 4, 1024, 128, None))
        out.append({"name": f"{name}_fp32", "route": "cuda",
                    "source": KERNEL_SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": wide["launches"]["granite_fp32"][name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"]})
    for name in ("flash_attention", "flash_attention_fwd_lse",
                 "flash_attention_bwd"):
        for dt, suffix in (("bf16", ""), ("fp32", "_fp32")):
            rows = [r for r in wide["kernels"]
                    if r["kernel"] == name and r["dtype"] == dt]
            main = rows[0]                # the d_head 320 model's shape
            out.append({"name": f"{name}_wide{suffix}", "route": "cuda",
                        "source": WIDE_SOURCE, "replaces": REPLACES[name],
                        "launches": wide["launches"][dt][name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": main["ms"], "device_ms": main["device_ms"],
                        "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"]})
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS
    from repro_torch.kernels import cudalib
    from repro_torch.kernels.routing import kernel, ops

    t0 = time.perf_counter()
    phase_s = {}

    def run(name, fn, *fn_args):
        """One phase, its wall time kept and printed, the card's cache
        emptied after it."""
        start = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - start
        print(f"[phase-time] {name} {phase_s[name]:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        return out

    device = run("device", phase_device)
    card = device["card"]
    jobs = DryrunJobs()              # phase 17 (a), beside phases 3-16
    try:
        return _phases(args, t0, phase_s, run, device, card, jobs,
                       cudalib, kernel, ops, CAPS_BENCHMARKS)
    finally:
        jobs.stop()


def _phases(args, t0, phase_s, run, device, card, jobs, cudalib, kernel,
            ops, CAPS_BENCHMARKS) -> int:
    build = run("build", phase_build, cudalib)
    jobs.start()
    kernel_rows = run("kernels", phase_kernels, kernel, ops,
                      CAPS_BENCHMARKS)
    serve = run("serve", phase_serve, kernel, CAPS_BENCHMARKS, card)
    train = run("train", phase_train, kernel, ops, CAPS_BENCHMARKS, card)
    em = run("em", phase_em, kernel, CAPS_BENCHMARKS, card)
    fastmath = run("fastmath", phase_fastmath, card)
    sharded = run("sharded", phase_sharded, kernel, ops, CAPS_BENCHMARKS,
                  card)
    lm = run("lm", phase_lm, card)
    lm_train = run("lm_train", phase_lm_train, card)
    fleet = run("fleet", phase_fleet, kernel, CAPS_BENCHMARKS, card, serve)
    moe = run("moe", phase_moe, card)
    mixtral = run("mixtral", phase_mixtral, card)
    slice11 = run("slice11", phase_slice11, card, lm_train)
    vlm_encdec = run("vlm_encdec", phase_vlm_encdec, card)
    shard = run("shard", phase_shard, card)
    launch = run("launch", phase_launch, card)
    dryrun = run("dryrun", phase_dryrun, jobs, CAPS_BENCHMARKS)
    wide = run("wide", phase_wide, card)
    build.pop("tensor_core_thread").join()
    check(bool(build["tensor_cores"]), "the tensor-core count of phase 2 "
          "failed (its thread's error above)")
    result = summary(kernel_rows, serve, train, em, fastmath, sharded, lm,
                     lm_train, fleet, moe, mixtral, slice11, vlm_encdec,
                     shard, launch, dryrun, wide)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "build": build,
                       "kernels": kernel_rows, "serve": serve,
                       "train": train, "em": em, "fastmath": fastmath,
                       "sharded": sharded, "lm": lm, "lm_train": lm_train,
                       "fleet": fleet, "moe": moe, "mixtral": mixtral,
                       "slice11": slice11, "vlm_encdec": vlm_encdec,
                       "shard": shard, "launch": launch, "dryrun": dryrun,
                       "wide": wide, "summary": result,
                       "phase_seconds": phase_s,
                       "seconds": time.perf_counter() - t0}, f, indent=1,
                      default=str)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
