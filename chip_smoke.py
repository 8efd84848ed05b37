#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--layers N]

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions; TF32 switched off for matmuls and cuDNN.
2. build   — compile every CUDA source of ``src/repro_torch/csrc`` with nvcc,
   one process per source, all started together.
3. kernels — each kernel against its plain PyTorch version on the card at
   the main paths' shapes, with the stated tolerances: paged attention
   (bf16, fp32, and fp32 queries over bf16 pools) and quantized paged
   attention (int8 and fp8 codes under bf16 and fp32 queries), each at the
   main path's positions (up to ~200) and at a long-context case (440-509
   in the engine's max_seq = 512 table), and at the split plan's other
   shapes (B = KV = 1, G = 16, a window that leaves splits empty, head_dim
   8, 16, 40 and 256, pages of 4, 8 and 32 rows), both timed at the two
   position ranges with the wrapper's host time per call; the fused
   log-softmax gather (the
   target's row-major unembedding with fp32 and bf16 h, and the draft's
   tied, transposed embedding; timed with bf16 h and with fp32 h), flash
   attention (target and draft heads, bf16 through the TMA/wgmma kernel
   and fp32; bf16 at the toy head dims 40 and 16 through the mma.sync
   kernel, G = 7 and 1; causal with no window and with one shorter than
   every tile, S = 1000; the TMA/wgmma kernel asked for its log-sum-exp
   gives the same output bits), flash attention's backward (bf16 through
   the TMA/wgmma kernels from the forward kernel's log-sum-exp: the
   draft's heads at S = 511, as run t1 trains them, at hd 128 and at hd 64
   with a window shorter than every tile, and the target's at S = 512; the
   toy heads hd 16 and 40 in fp32 through the older kernels, causal and
   with a window shorter than every tile; each case's route printed and
   checked; two calls bitwise equal; timed at both training shapes beside
   SDPA's backward) and the WKV6 scan (rwkv6-3b's
   heads at its decode,
   shared-scoring and full-sequence shapes in bf16, and a toy hd = 32 in
   fp32; spread decays and a non-zero initial state; then decays at the
   model's clamp ends and mixed, B = H = 1 at T = 4096 (32 segments), the
   in-place decode form with half the rows frozen (their state compared
   bitwise), two calls bitwise equal, a capture into a CUDA graph and two
   streams at once; timed with the wrapper's host time per call), the
   WKV6 backward (rwkv6-3b's training shape B 4, T 512, H 40, hd 64 with
   bf16 r/k/v, a ragged T 509 at decays at both clamp ends and mixed,
   B = H = 1 at T 4096 with decays near 1, a toy hd 32 in fp32; each with
   a non-zero state and final-state cotangent, at ``SCAN_BWD_TOL``, twice
   bitwise; timed at the training shape beside its bound and the plain
   version, its checkpoint scratch printed; no PyTorch call computes it),
   then
   the Gemma shapes at head_dim 256 (gemma3's 4 query heads over 1 kv
   head, recurrentgemma's 16 over 1): flash attention in bf16 (the
   256-wide TMA/wgmma kernel, its log-sum-exp asked for gives the same
   bits) and fp32, causal, with no window and each family's window over a
   sequence it binds; paged and int8 paged attention under bf16 and fp32
   queries; the gather at both vocabularies (262,144 and 256,000, tied
   bf16 embeddings, bf16 and fp32 h) held to float64 log-probs; each
   timed, beside SDPA at head_dim 256 for flash; flash attention's
   backward at head_dim 256 (gemma3's heads at B 2, S 1024, causal and
   with window 512; recurrentgemma's at B 1, S 4096 with window 2048 and
   at B 2, S 1024; a window of 8 over a ragged S 300: bf16 through the
   TMA/wgmma kernels from the forward's log-sum-exp, which is held to the
   plain one; fp32 at S 200 for both, through the older kernels), its
   route and plan printed, twice bitwise, the bf16 training shapes timed
   beside SDPA's backward; then flash attention
   with ``causal=False`` at the cross-attention families' shapes
   (llama-3.2-vision-11b's cross layers, Sq 512 over Sk 6,404 keys, H
   32/8, hd 128; seamless-m4t-medium's encoder, S 1,024, H 16/16, hd 64,
   and its cross layers, 512 over 1,024), bf16, on N(0, 1) inputs and on
   a tail case whose softmax the last 4 keys decide (a dropped tail or
   padding let in fails it), elementwise within 2^-5 of each value plus
   2e-2 of the output's deviation, its log-sum-exp asked for giving the
   same bits, timed beside SDPA (``is_causal=False``), and its backward at
   all three shapes on both inputs (within 2^-5 of each value plus
   5e-3 of the largest gradient), twice bitwise, timed beside SDPA's
   backward.  Each
   kernel's time
   beside its bound, the plain version's time and, where one exists, one
   PyTorch library call computing the same function (a yardstick the port
   never calls).  Launches made here are not counted.
4. main paths — the full-width Qwen2.5-Math draft/target/PRM triple with
   seeded random weights in bf16, served by the paged GSI engine through
   the continuous-batching scheduler: (a) 6 requests on 4 slots over bf16
   pages at a threshold among the selected tilted rewards, so that it both
   accepts draft candidates and falls back (both counted and required),
   (d) run (a) again through the pipelined scheduler (``sync=False``, the
   CLI's default), whose tokens, finish reasons, engine steps, accepted
   and decision counts, prefix counters and paged-attention launches must
   equal (a)'s bit for bit, with host work overlapping a step
   (``pipeline_stats``), (b) a short run whose threshold no tilted reward
   can reach, so the target fallback must run, and (c) 5 requests over
   int8 pages with shared scoring and the draft's weights rounded through
   int8, at a threshold among its selected tilted rewards, so that it too
   both accepts and falls back (both counted and required).  Then run
   score-prm, at full depth: the sequences (a) finished go through
   target.prefill, target.score, draft.score and PRM.reward_at_end, and
   each result is held against the decode path (teacher-forced paged
   decode_step) on the same tokens.  Every kernel launch counter is zeroed
   just before each run and read just after: in (a), (d) and (b) every paged
   attention call launched the bf16 kernel; in (c) every one launched the
   quantized kernel and the vocab gather ran twice per draft phase; in
   score-prm the flash kernel ran once per layer of every full-sequence
   call and the gather once per score call, with no paged launch.
   Then the SLO runs, at full width and ``SLO_LAYERS`` deep (said on a
   ``reduced:`` line): five requests (r0 64 tokens, r1 48, r2 40 at
   priority 1 with a deadline it cannot meet, r3 r0's first 32 tokens and
   24 of its own, r4 40 at priority 1 with one it meets) on 2 slots over
   bf16 pages with the prefix cache, n 4, temperature 0, no EOS and no
   early stop, at a threshold between two of the requests' first-step
   selected tilted rewards (one calibration step), each request with a
   token stream: run gsi-slo (lock-step, prefill chunks of 16; r2 and r4
   submitted once neither slot is free or mid-prefill, so r2 pauses a
   live slot), gsi-slo-async (the same pipelined) and gsi-slo-oneshot
   (whole prompts, all five at the start at priority 0).  Each request's
   tokens and finish reason are identical in all three; the chunked runs
   commit at most 16 prompt tokens a call, the one-shot run more, and the
   chunked runs preempt and resume; every run accepts and falls back,
   misses r2's deadline (counted as the responses say), hits the prefix
   cache, reassembles every stream, conserves pages and launches the
   paged kernel layers x paged decode_step calls times, nothing else.
   TTFT and TPOT per priority class are printed.  Then the warm cache:
   run gsi-slo-oneshot's radix cache saved to an ``.npz``, loaded into a
   fresh engine (rows bitwise equal, pages conserved), and r0 served
   alone for one step with a prefix hit and the same first step.
   Then the replica fleet (``ReplicaRouter``), at full width and
   ``FLEET_LAYERS`` deep (a ``reduced:`` line), every replica's engine over
   the one shared set of weights, bf16 pages of 16 rows with the prefix
   cache, temperature 0, capacity 1 a replica, at a threshold from one
   calibration step of the same prompts: 8 requests in 2 preamble groups
   (33-token preambles, so two full pages are shared; step budgets 1, 2,
   3, 3 as the reference benchmark cycles them) through fleet-single (one
   replica), fleet-affinity (2 replicas, sequential, no skew guard),
   fleet-rr (round robin), fleet-async (affinity, pipelined replicas, one
   thread and CUDA stream each) and fleet-grow (rendezvous hashing on 2
   replicas, then ``add_replica`` to 3 and each group's next request).
   Every request's tokens are identical in all five; the prefix hits
   equal the host's prediction (affinity above round robin);
   ``add_replica`` moves the groups and pages the host predicts, at least
   one, and the moved group's next request hits on the new replica; the
   threaded runs' replicas ran on distinct, non-default streams; every run
   accepts and falls back, conserves pages and launches the paged kernel
   layers x paged decode_step calls times summed over its replicas, and
   nothing else.  Then fleet-int8-async (2 threaded replicas over int8
   pages with shared scoring and the int8 draft, 4 requests, its own
   calibrated threshold) against fleet-int8-single (one such replica):
   identical tokens, and the quantized kernel and the gather launched
   exactly as in gsi-int8-shared.  Each run prints its wall time, tokens/s,
   per-replica hits and routing counters, and a threaded run its wall time
   against the sum of its replicas' step times.
   Then, once the Qwen weights are freed, GSI with a mixture-of-experts
   target at full width, ``MOE_LAYERS`` deep: the Qwen2.5-Math-1.5B
   draft, ``qwen2-moe-a2.7b`` (24 layers, 60 routed experts top-4 laid out
   as 64, 4 shared) and the Qwen2.5-Math PRM, seeded random bf16 weights,
   4 requests on 4 slots over bf16 pages, n 4, at most 2 steps of 16
   tokens: one calibration engine step (the same prompts, seed and slots)
   gives a threshold among the run's first-step selected tilted rewards;
   run gsi-moe (lock-step) must both accept and fall back to the MoE
   target, run gsi-moe-async (pipelined) must commit its tokens, finish
   reasons, steps and counters bit for bit, and each launches the paged
   kernel layers x paged decode_step calls times (each model's layers),
   nothing else; each model's host and stream ms per decode_step and the
   memory after the weights are printed.  Then layer 0 of the MoE target
   at the runs' 16 rows: bf16 twice (bitwise equal) against fp32 from the
   same weights and input, the share of routed slots dropped, and its
   device time against the bytes it must read (every laid-out expert).
   Then, once those weights are freed too, the full-width full-depth
   rwkv6-3b triple (bf16, seeded random weights, every decay_base
   overwritten so the WKV state carries): run gsi-rwkv-shared serves 4
   requests through the dense engine with shared scoring, at a threshold
   at which it both accepts draft candidates and falls back to the target
   (both counted and required), and the scan ran
   exactly layers x (decode_step calls + score_candidates calls) times and
   the gather once per score_candidates call; run score-rwkv puts its
   sequences through the four full-sequence calls (the scan once per layer
   of each, the gather twice) and holds them against the decode path
   (printing the counted bf16 run's own gap as a control, then in fp32
   activations over the same weights).
   Then, once those weights are freed, the Gemma families at full width,
   ``GEMMA_LAYERS`` deep (7 of gemma3's 26, 10 of recurrentgemma's 38;
   a ``reduced:`` line), each one model's shape as draft, target and PRM
   (seeded random bf16 weights, every RG-LRU ``lam`` overwritten so the state
   carries; 4 requests on 4 slots, at most 2 steps of 16 tokens, each run
   at a threshold calibrated among its own first-step selected tilted
   rewards): run gsi-gemma3 (gemma3-1b over bf16 pages) and run
   gsi-gemma3-int8-shared (int8 pages, shared scoring, the int8 draft)
   must both accept and fall back and launch their paged kernel attention
   layers x paged decode_step calls times (the gather 2 x draft phases
   with shared scoring), nothing else; run score-gemma3 puts its
   sequences, with prompts of 520-560 tokens so that the 512-key windows
   bind, through the four full-sequence calls (flash once per layer of
   each, the gather twice) and holds them against the decode path in fp32
   activations (the bf16 gap printed and required above the tolerance as
   a control, as score-rwkv does); then, once those weights are freed,
   the recurrentgemma-9b triple (about 17 GiB at 10 layers, the memory
   printed before and after): run gsi-rgemma (paged local layers beside
   dense RG-LRU state, prefix sharing off, checked; paged launches = its 6
   attention layers x paged decode_step calls) and run score-rgemma (flash
   once per attention layer of each call; the RG-LRU state prefill leaves
   against the one decode carries).
   Then, once those weights are freed, the cross-attention families at
   full width and depth, each one model's shape as draft, target and PRM
   (seeded random bf16 weights, seeded N(0, 1) sources): run agree-vision
   (llama-3.2-vision-11b, 40 layers, a cross layer every 5th, about 56.5
   GiB for the three) puts 3 prompts of 240 tokens over a (3, 6404, 4096)
   source through prefill, 16 dense decode_steps from its cache (the
   cross KV read back from there), forward, score and the PRM's
   reward_at_end, with flash launched once per attention call of each
   full-sequence call (causal and non-causal counted apart), the gather
   once and nothing else; then the same calls in fp32 activations over
   the same weights hold prefill and decode logits to forward's, score
   to forward's log-softmax and the reward to the PRM's decode path
   within CROSS_TOL (the bf16 gaps printed), and a second source must
   move the logits by ten times that; run gsi-vision serves 4 text-only
   requests (2 steps of 16 tokens, n 4) at a calibrated threshold on 4
   slots, seeded N(0, 1) cross KV written into each admitted slot (the
   engine takes no source; zero cross KV would hide a dropped cross
   layer), the first step's rewards under a second seed's cross KV
   required to move by more than 1e-2 as the control; it
   must accept and fall back, launches the paged kernel 40 x paged
   decode_step calls times and turns prefix sharing off, and prints its
   peak memory; then
   agree-seamless (its 12-layer encoder over (3, 1024, 1024) frames) and
   gsi-seamless the same way, and run t5 trains seamless-m4t-medium
   (lm_loss with a source, B 4 x S 512, 3 steps, fp32 AdamW) with flash's
   forward and backward each launched 36 x 3 times.
4b. agreement — a toy fp32 triple at temperature 0: paged (kernel) against
   dense (plain attention) serving on the card, bf16 pages under its fp32
   activations (the kernel's fp32-query, bf16-pool instance) on the card
   against the CPU, and int8 / fp8 pages with shared scoring on the card
   against the same engine on the CPU; then the
   toy models' forward, score, prefill and rewards on the card (head_dim 16
   and 40, a full/local stack with a window shorter than S) against the
   CPU; and a toy fp32 RWKV triple served dense and paged on the card
   commits the CPU's tokens, its forward, score, prefill state and rewards
   matching the CPU's.
5. profile — one engine step of (a) (at threshold 0.5, as it was profiled
   before it had its own threshold) and of (c), then two consecutive
   pipelined dispatches of (a)'s configuration (these three with the
   Qwen2.5-Math models cut to ``PROFILE_LAYERS`` layers, said on a
   ``reduced:`` line) (after the first, the
   window pump, dispatch, pump), one score-prm batch, one engine step of
   gsi-moe (cut to ``PROFILE_LAYERS``, said on a ``reduced:`` line, at
   threshold 0.5, so the MoE target's fallback runs) and one engine step
   of gsi-rwkv-shared (cut to ``PROFILE_LAYERS`` too), under
   ``torch.profiler`` (device activity only; each
   with the device's busy and idle share); a paged kernel's row counts its
   split and combine kernels together.

6. training — every attention layer's forward and backward through the
   flash kernels (the FlashAttention autograd Function): (t1) the
   Qwen2.5-Math-1.5B draft at full width and depth, bf16 weights and fp32
   AdamW state, B = 4, S = 512, a few steps on one fixed ``lm_batches``
   batch; (t2) ``prm_loss`` on the PRM-7B at full width, cut to 4 layers
   (said on a ``reduced:`` line); each with its launch counters zeroed
   just before and read just after (flash forward and backward launches =
   layers x steps, no other kernel), finite and falling losses, step time
   and tokens/s; (t3) the toy triple trained for 3 steps on the card and
   on the CPU from the same weights and batches, losses and parameters
   within tolerance; (t4) the serving CLI's ``--train-steps`` path:
   ``train_triple`` on the card, then GSI serving of synthetic problems,
   with falling losses, accuracy and an accept rate strictly between 0
   and 1 (run t5 runs in phase 4, with the cross-attention weights);
   then t3-rwkv and t3-gemma3, a reduced rwkv6-3b at hd 64 (decays
   overwritten) and a reduced gemma3-1b at hd 256 trained for 3 fp32
   steps on the card and on the CPU, held as t3; and runs t6-t10, 3 steps
   each at full width through the scan's and flash's forward and backward
   kernels (launches = their layers x steps, nothing else): rwkv6-3b at
   full depth (decays overwritten), gemma3-1b at full depth,
   recurrentgemma-9b at 12 layers (``lam`` overwritten), qwen2-moe-a2.7b
   at 4 and llama-3.2-vision-11b at 10 with a seeded source of 6,404
   patches (each cut said on a ``reduced:`` line).

The line before the last is ``{"kernels": [...]}``: every ported kernel
with its largest error in phase 3, its timings and its launch count from the
phase-4 run(s) of its path (the gather's row also carries its fp32-h
timings under ``fp32_h_*``, the paged rows their long-context timings
under ``long_*`` and the wrapper's host time per call under ``host_ms``,
the backward's row its draft-shape timings under ``draft_*``).
The last line is ``{"ok": true, "device": {...}}``.  ``--layers`` sets
the depth of runs (a), (d) and (b) (``QWEN_LAYERS`` by default, 0 for the
published 28; never a width, never run (c), score-prm, the RWKV runs or
the Gemma runs), whose threshold is then calibrated at that depth as the
MoE runs' is, and says so on a ``reduced:`` line; the MoE runs are
``MOE_LAYERS`` deep, the Gemma runs ``GEMMA_LAYERS``, the cross-attention
runs at full depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12                 # HBM3, H100 SXM data sheet
PEAK_OPS = {"torch.bfloat16": 989e12,      # dense tensor-core bf16
            "torch.float32": 67e12}        # fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
TOL = {"torch.float32": 2e-5,
       # the plain version casts the probabilities to bf16 before the P.V
       # product (as the reference does); the kernel keeps them in fp32.
       # The quantized pair computes in fp32 on both sides and differs by
       # the output's one bf16 rounding
       "torch.bfloat16": 2e-2}
# log-probs: both sides in fp32 from the same inputs (bf16 x bf16 products
# are exact in fp32); they differ in summation order over d and the vocab,
# an error that grows with the logits: 1e-3 absolute plus 1e-5 of the
# log-prob (the draft's tied std-1 embedding gives log-probs near -300)
LOGPROB_ATOL, LOGPROB_RTOL = 1e-3, 1e-5
# run score-prm against the decode path: two kernels (flash, with bf16
# probabilities, and paged decode, with fp32 ones) and GEMMs of other row
# counts round the bf16 activations of 28 layers at different points, each
# rounding a relative 2^-9, and the decode path's logits are themselves
# bf16 (half an ulp is 0.016 at |logit| 4-8).  The target's logits have a
# std near 1 (post-norm states over a 1/sqrt(d) unembedding).  Held to 0.1
# in log-probs (nats) and in logits, and to 0.01 in rewards (a sigmoid,
# slope at most 1/4, of a logit of the same scale)
LP_TOL, LOGIT_TOL, REWARD_TOL = 0.1, 0.1, 0.01
# the gather at recurrentgemma's shape with fp32 h (d 4096, tied std-1
# embeddings, so logits of std 64 and log-probs near -456), the input of
# score-rgemma's fp32 agreement: the kernel's three bf16 passes accumulate
# on the tensor cores, whose fp32 adds truncate over 256 k-steps a pass;
# measured against float64 log-probs it is 7.1e-3 off (plain fp32 1.0e-3,
# a first chip run, H100 80GB HBM3, 700 W), above LOGPROB_RTOL's 1e-5 of
# the log-prob; held to 2e-5 of it (a finding: a split accumulation is
# queued in ROADMAP).  Every other gather input keeps LOGPROB_RTOL
LOGPROB_TC_RTOL = 2e-5
# run score-rwkv against the decode path: the random-weight RWKV stack
# amplifies the two paths' different roundings from layer to layer, so in
# bf16 activations the 32-layer gap is of the order of a nat (the run
# prints it as a control and requires it above LP_TOL, which shows that
# the fp32 comparison is the one able to see a fault).  Both paths then
# run again with fp32 activations over the same bf16 weights and are held
# to score-prm's tolerances, and the state that prefill leaves in layer 0,
# which no depth amplifies, is held to the state decode carries to the
# same position within TOY_RTOL of its scale
# phase 4b, card against CPU in fp32: summation orders differ (cuBLAS and
# the kernels against the CPU's), 1e-4 of each output's scale
TOY_RTOL = 1e-4
# the toy RWKV triple's draft and target disagree (independent random
# weights), so its tilted rewards are negative: this threshold both accepts
# and rejects
TOY_RWKV_THRESHOLD = -2.0
# run gsi-rwkv-shared: at full width the draft and target (independent
# random weights) disagree too, so tilted rewards r + (log pi_B - log pi_S)
# / beta lie below the PRM's rewards; this threshold lies among the
# selected tilted rewards, so the run both accepts a draft candidate and
# falls back to the target
RWKV_THRESHOLD = -0.29
# run gsi-int8-shared: the full-width full-depth Qwen2.5-Math draft (tied
# std-1 embedding, nearly deterministic) and target (independent random
# weights) disagree by about 12 nats a token, so the selected tilted
# rewards lie near -10 (-10.75 to -8.45 in a chip run at threshold 0.5,
# which nothing reached, and accept rate 0.000 there over int8 pages in
# two runs); this threshold lies among them, so the run commits accepted
# draft candidates over int8 pages and falls back to the target.  Runs gsi
# and gsi-async take a threshold calibrated at their own depth
QWEN_INT8_THRESHOLD = -9.5
# depth of runs gsi, gsi-async and gsi-forced-fallback (widths never cut;
# `--layers` overrides it): at the published 28 they took 149 s of a
# 1173.8 s chip run (H100 80GB HBM3, 700 W), and the Gemma phase
# had pushed the script near its 1200 s limit; at 14 they took 99.4 s of
# a 1071.3 s run on a slower machine once the other families' training
# was added (same card and limit), so 7
QWEN_LAYERS = 7
# the SLO runs of phase 4 (gsi-slo, gsi-slo-async, gsi-slo-oneshot): the
# chunked runs' per-step prefill budget; the deadlines of the priority-1
# requests (r2's cannot be met, r4's is); the seed of the five prompts; r0's
# step budget: the other requests take the GSI config's 3, but at 3 r0
# (64 prompt tokens, prefilled in 4 steps) finishes before r1 (48 tokens,
# prefilled in 3 more) decodes, so no step would find both slots decoding
# and r2 would never have a victim; at 5 both decode after step 7 and r2
# pauses r1 with 2 of its steps left
SLO_CHUNK = 16
SLO_MISS_S, SLO_MEET_S = 1e-3, 600.0
SLO_PROMPT_SEED = 23
SLO_R0_STEPS = 5
# phase 5 profiles every engine step at this depth (the profiler's
# processing grows with the launches: at 28 layers the three Qwen profiles
# took 313 s of a chip run; at 14, with the gsi-moe step, the four took
# 237 s and the full-depth RWKV step 70 s of a run whose script took
# 1118.8 s of its 1200, H100 80GB HBM3, 700 W; at 7, with the fleet
# phase added at 7 too, the Qwen phases alone took 687.4 s of a run on the
# same card, the SLO runs 105 s, the fleet 144.7 s and the three Qwen
# profiles 91 s, so all three went to 4; at 4, with the cross-attention
# phase added, the five profiles took 82 s of a 1062.8 s run on a slower
# machine, so 2)
PROFILE_LAYERS = 2
# depth of the SLO runs and the warm-cache check (0: the published 28): at
# 28 layers they took 287 s of a chip run (H100 80GB HBM3, 700 W), at 14
# 192 s of the run above, at 4 61 s of that 1173.8 s run, so 2; widths
# are never cut
SLO_LAYERS = 2
# the fleet phase (replicas behind the router): its depth (widths never
# cut), the seed of its prompts (8: under rendezvous hashing the two
# groups' first pages go to replicas 0 and 1 of 2, and group 1's to the
# new replica 2 of 3, so add_replica moves one group; under mod to
# replicas 1 and 0), its preamble groups of FLEET_PER_GROUP requests each
# plus one held back for fleet-grow's second wave, the 33-token preamble
# (two full pages of 16 and one token), the GSI config's step budget and
# tokens, the int8 runs' request count, and the pages of every fleet
# engine (enough that no run evicts: hits are then predictable); at 4
# layers the phase took 98.2 s of that 1173.8 s run, so 2
FLEET_LAYERS = 2
FLEET_SEED = 8
FLEET_GROUPS, FLEET_PER_GROUP, FLEET_PREAMBLE = 2, 4, 33
FLEET_STEPS, FLEET_STEP_TOKENS = 3, 4
FLEET_INT8_REQUESTS = 4
FLEET_PAGES = 64
# runs gsi-moe and gsi-moe-async: the seed of their prompts, of the
# serving generator and of the MoE layer check's input; the depth of all
# three models (the published 24 and 28 took 106 s of that 1173.8 s
# chip run, 12 took 40.8 s of the 1062.8 s one; widths never cut)
MOE_SEED = 4
MOE_LAYERS = 6
# the MoE layer check, bf16 against fp32 from the same weights and the
# same bf16-rounded input, over the rows that both route to the same
# experts: the bf16 side rounds the router's weights and top-k weights,
# the gate and up products, their product and the output (2^-9 relative
# each, products accumulated in fp32 over d 2048 and ff 1408 terms): 3e-2
# of the output's scale.  A row that a near tie sends to another expert
# differs by that expert's whole contribution: its error is printed, and
# at least half the rows must route alike
MOE_TOL = 3e-2
# flash attention's backward kernel against its plain version.  fp32: both
# sides in fp32, summation orders differ: 1e-5 of the gradient's scale.
# bf16: the kernel rounds P and dS to bf16 before their products (2^-9
# relative each, summed over hundreds of keys) where the plain version
# keeps them in fp32 (the TMA/wgmma backward also forms dS from the bf16
# P), and both round dq, dk, dv to bf16 (half an ulp, 2^-9): 2e-2 of the
# gradient's scale (0.5% seen at S = 512)
BWD_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
# the WKV6 backward kernel against its plain version: dw, du and the
# initial state's gradient are fp32 on both sides, from the same inputs in
# other summation orders (1e-4 of each one's scale, as the forward's
# check); dr, dk and dv come back in r's dtype, and bf16 rounds them (half
# an ulp, 2^-9 of the value): 4e-3 of their scale
SCAN_BWD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 4e-3}


T0 = time.perf_counter()
CARD = "card not read"      # nvidia-smi's name and power limit (phase 1)


class SmokeFailure(Exception):
    pass


def elapsed(what):
    print(f"elapsed {time.perf_counter() - T0:.1f} s after {what}",
          flush=True)


def release(torch):
    """Free the device memory of a finished phase: the counting wrappers
    of its engines' models make reference cycles (model -> wrapper -> bound
    method -> model), which keep the engines, and through them the
    phase's weights, until the cycle collector runs; collect them, then
    return the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------
# Phase 3 helpers: main-path-shaped paged attention inputs
# ----------------------------------------------------------------------

def paged_case(torch, *, H, KV, dtype, seed, hd=128, ps=16, slots=4, n=4,
               nblk=32, span=2, lo=20, hi=190):
    """Inputs shaped like one layer's paged attention call on the main path.

    Pool: ``slots * nblk`` allocatable pages + ``slots * n * span`` scratch
    pages + 1 trash page, filled with random values (stale garbage
    everywhere).  Rows are ``slots * n`` candidate branches: each branch
    aliases its slot's committed pages below its write block (slot 1 shares
    slot 0's first three pages, as a prefix-cache hit does) and writes into
    its own scratch pages from there; unassigned columns and the extra
    table column point at the trash page.  Slot positions are drawn from
    [lo, hi) (the main path's ~200 by default; the long-context case takes
    440-500 in the engine's max_seq = 512 table), branches 3 apart.
    """
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = slots * nblk + slots * n * span + 1
    trash = P - 1
    kp = torch.randn((P, ps, KV, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, ps, KV, hd), generator=gen, device=dev).to(dtype)
    B = slots * n
    q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dtype)
    cpu = torch.Generator().manual_seed(seed)
    perm = torch.randperm(slots * nblk, generator=cpu)
    committed = perm.reshape(slots, nblk)
    committed[1, :3] = committed[0, :3]            # shared prefix pages
    slot_pos = torch.randint(lo, hi, (slots,), generator=cpu)
    pt = torch.full((B, nblk + 1), trash, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    scratch = slots * nblk
    for s in range(slots):
        base = int(slot_pos[s])
        blk0 = base // ps
        for j in range(n):
            b = s * n + j
            p = base + 3 * j                        # branches at their own
            pos[b] = p                              # progress in the step
            pt[b, :blk0] = committed[s, :blk0]
            for k in range(span):
                col = min(blk0 + k, nblk)
                pt[b, col] = scratch
                scratch += 1
    return q, kp, vp, pt.to(dev), pos.to(dev)


# the split plan's shapes beyond the main path's (B, H, KV, head_dim, page
# size, table columns, largest pos, window): B = KV = 1 (one (row, kv head)
# pair, 9 splits), G = 16, a window that leaves splits empty, the toys'
# head dims 8, 16 and 40, pages of 4, 8 and 32 rows, head_dim 256 (fp32
# pools of 32-row pages are cut into 16-row units); the largest pos of
# each sits in the trash column or near the table's end
SPLIT_SHAPES = {
    "b1kv1": (1, 7, 1, 128, 16, 33, 527, 0),
    "g16": (4, 32, 2, 64, 16, 33, 300, 0),
    "window": (8, 28, 4, 128, 16, 33, 527, 40),
    "hd8": (4, 8, 2, 8, 16, 12, 180, 0),
    "hd16-g1": (4, 4, 4, 16, 16, 12, 180, 8),
    "hd40-ps8": (4, 14, 2, 40, 8, 20, 150, 8),
    "ps4-g1": (3, 4, 4, 16, 4, 40, 150, 0),
    "hd256-ps32": (3, 14, 2, 256, 32, 10, 300, 0),
}


def split_case(torch, shape, qdt, pool, seed):
    """One paged call at ``SPLIT_SHAPES[shape]``: distinct random pages in
    every column but the last (the trash page), stale values everywhere,
    rows 0 and 1 sharing their first page, positions spread from the
    largest down to 0.  ``pool`` is a dtype or "int8" / "fp8" (codes and
    scales as the engine writes them)."""
    from repro_torch.kernels import quant
    B, H, KV, hd, ps, nblk1, top, window = SPLIT_SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = B * (nblk1 - 1) + 1
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(qdt)
    kp, vp = (torch.randn((P, ps, KV, hd), generator=gen, device="cuda")
              for _ in range(2))
    cpu = torch.Generator().manual_seed(seed)
    pt = torch.randperm(P - 1, generator=cpu)[:B * (nblk1 - 1)].reshape(
        B, nblk1 - 1)
    pt[min(1, B - 1), 0] = pt[0, 0]
    pt = torch.cat([pt, torch.full((B, 1), P - 1)], dim=1).int().cuda()
    pos = torch.linspace(top, 0, B).int().cuda()
    if not isinstance(pool, str):
        return (q, kp.to(pool), vp.to(pool), pt, pos), window
    codes = []
    for x in (kp, vp):
        sc = x.abs().amax(dim=(1, 3)).clamp(min=quant.EPS) / quant.QMAX[pool]
        codes += [quant.quantize_codes(x / sc[:, None, :, None],
                                       quant.pool_dtype(pool, qdt)), sc]
    return (q, codes[0], codes[2], codes[1], codes[3], pt, pos), window


def check_split_shapes(torch, fn, plain, name, instances):
    """``fn`` against ``plain`` at every :data:`SPLIT_SHAPES` entry for each
    (q dtype, pool) instance; returns the largest error."""
    worst = 0.0
    for qdt, pool in instances:
        errs = []
        for shape in SPLIT_SHAPES:
            args, window = split_case(torch, shape, qdt, pool,
                                      len(shape) + len(str(pool)))
            got = fn(*args, window=window)
            want = plain(*args, window=window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{name} {shape}: non-finite kernel output")
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[str(qdt)]
            check(err <= tol, f"{name} {shape} q={qdt} pools={pool}: error "
                  f"{err} > {tol}")
            errs.append(err)
        worst = max(worst, *errs)
        print(f"{name} at the split shapes ({', '.join(SPLIT_SHAPES)}), "
              f"q={str(qdt)[6:]} pools={str(pool).replace('torch.', '')}: "
              f"max_abs_err={max(errs):.3e} (tol {TOL[str(qdt)]:.0e})",
              flush=True)
    return worst


def live_rows(pt, pos, ps, window):
    """Unique physical pool rows the live positions of every row read."""
    rows, n_live = set(), 0
    nblk1 = pt.shape[1]
    for b in range(pt.shape[0]):
        p = int(pos[b])
        lo = max(0, p - window + 1) if window else 0
        hi = min(p, nblk1 * ps - 1)
        for kpos in range(lo, hi + 1):
            rows.add(int(pt[b, kpos // ps]) * ps + kpos % ps)
        n_live += hi - lo + 1
    return rows, n_live


def bound(arg_sets, window):
    """Least mean time per call the card could take over ``arg_sets`` (the
    sets :func:`time_ms` cycles through): the larger of the bytes each call
    must move (live K/V rows once, q, out, table, positions) over the HBM
    rate, and its operations over the peak rate for the dtype."""
    nbytes = ops = 0
    for q, kp, _, pt, pos in arg_sets:
        H, hd = q.shape[2:]
        ps, KV = kp.shape[1], kp.shape[2]
        esize = q.element_size()
        rows, n_live = live_rows(pt.cpu(), pos.cpu(), ps, window)
        nbytes += len(rows) * KV * hd * esize * 2 + 2 * q.numel() * esize \
            + pt.numel() * 4 + pos.numel() * 4
        ops += 4 * (H // KV) * KV * hd * n_live     # QK and PV, 2 flops each
    t_bytes = nbytes / len(arg_sets) / H100_BYTES_PER_S
    t_ops = ops / len(arg_sets) / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, arg_sets, iters=40, enqueue=False):
    """Mean ms per call with CUDA events, cycling through ``arg_sets``
    (together larger than the L2 cache, so K/V comes from HBM).

    Returns ``(device_ms, back_to_back_ms)``, and with ``enqueue`` also
    ``host_ms``.  ``device_ms`` enqueues every call behind a ~0.5 s device
    sleep, so the card runs them back to back whatever the host's per-call
    cost: the function's own time on the card (checked: the timed region
    must not have started when the host finished enqueueing).
    ``back_to_back_ms`` is the same loop without the sleep, where a host
    slower than the card shows up as the per-call time.  ``host_ms`` is the
    host clock's time per call of the queued loop: what one call costs the
    host, whatever the card does.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    out = []
    for queued in (True, False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(1_000_000_000)        # clock cycles
        start.record()
        count = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            for args in arg_sets:
                fn(*args)
                count += 1
        host_ms = (time.perf_counter() - t0) * 1e3 / count
        end.record()
        if queued:
            check(not start.query(), "timing: the host did not finish "
                  "enqueueing before the device sleep ended")
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / count)
        if queued:
            enqueue_ms = host_ms
    return (*out, enqueue_ms) if enqueue else tuple(out)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_device(torch):
    print("== phase 1: device", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    print(smi[0], flush=True)
    global CARD
    CARD = smi[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False "
          "torch.backends.cudnn.allow_tf32=False", flush=True)
    return smi[0]


def phase_build():
    print("== phase 2: build", flush=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        print(f"built {name}: {build.library_path(name).name}", flush=True)
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # the mangled name without its file prefix and arguments
                kernel = re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "",
                                line.split("'")[1]).split("EEv")[0]
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {kernel}: {line.strip()}", flush=True)
    print(f"build seconds: {secs:.2f}", flush=True)


def paged_sets(torch, make, budget):
    """Input sets from ``make(i)`` until their pools pass ``budget`` bytes
    (twice the L2 cache), so K/V comes from HBM when they are cycled."""
    sets = []
    while sum(s[1].numel() * s[1].element_size() * 2 for s in sets) < budget:
        sets.append(make(len(sets)))
    return sets


def gathered_kv(torch, q, k, v, pt, pos):
    """SDPA's inputs for one paged call: q (B, H, 1, hd) and K/V gathered
    through the table into (B, KV, S, hd), with the causal mask (the
    library yardstick's gather is not timed)."""
    B, _, _, hd = q.shape
    P, ps, KV = k.shape[:3]
    S = pt.shape[1] * ps
    rows = (pt.long()[:, :, None] * ps
            + torch.arange(ps, device="cuda")).reshape(B, S)
    kg = k.reshape(P * ps, KV, hd)[rows].transpose(1, 2).contiguous()
    vg = v.reshape(P * ps, KV, hd)[rows].transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None] <= pos[:, None].long())
    return q.transpose(1, 2).contiguous(), kg, vg, mask[:, None, None]


def time_paged(torch, name, fn, plain, sets, plain_sets, lib_sets, bounds,
               what, iters):
    """Time ``fn``, ``plain`` and SDPA over the cycled sets; print the
    device-only and the back-to-back lines; return the numbers."""
    ms, ms_host, enqueue_ms = time_ms(torch, lambda *a: fn(*a), sets,
                                      iters=iters, enqueue=True)
    plain_ms, plain_host = time_ms(torch, lambda *a: plain(*a), plain_sets,
                                   iters=1)
    library_ms, library_host = time_ms(torch, sdpa, lib_sets, iters=5)
    bound_ms, bound_by = bounds
    print(f"{name} timing ({what}; kernel {len(sets)} input sets cycled past"
          f" L2, plain {len(plain_sets)}, library {len(lib_sets)}), "
          f"device-only ms per call: kernel {ms:.4f}, bound {bound_ms:.6f} "
          f"({bound_by}, mean over the sets), plain {plain_ms:.4f}, library "
          f"(scaled_dot_product_attention over pre-gathered K/V) "
          f"{library_ms:.4f}", flush=True)
    print(f"{name} timing ({what}), back-to-back launches from the host "
          f"(host cost included), ms per call: kernel {ms_host:.4f}, plain "
          f"{plain_host:.4f}, library {library_host:.4f}; the wrapper's "
          f"host time per call (enqueue only) {enqueue_ms:.4f}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "back_to_back_ms": ms_host, "host_ms": enqueue_ms}


def print_plan(name, B, KV, nblk1, ps):
    from repro_torch.kernels.paged_attention import split_plan
    splits, bps = split_plan(B, KV, nblk1, ps)
    print(f"{name} split plan at B={B} KV={KV} table={nblk1} ps={ps}: "
          f"{splits} splits of {bps} logical blocks, {B * KV * splits} "
          f"blocks", flush=True)


def phase_kernels(torch):
    print("== phase 3: paged_attention vs its plain version", flush=True)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    max_err = 0.0
    shapes = {"target": (28, 4), "draft": (12, 2)}
    # (q dtype, pool dtype): fp32 queries over bf16 pools are the
    # kernel's widening instance (kv_dtype="bf16" under fp32 activations)
    pairs = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.float32, torch.bfloat16))
    # the main path's positions (~200), and the long-context case (440-509
    # in the engine's max_seq = 512 table)
    spans = {"": (20, 190, 0), " long": (440, 500, 1000)}
    for tag, (H, KV) in shapes.items():
        print_plan("paged_attention", 16, KV, 33, 16)
        for span, (lo, hi, off) in spans.items():
            for dtype, pool in pairs:
                for window in (0, 64):
                    q, kp, vp, pt, pos = paged_case(
                        torch, H=H, KV=KV, dtype=dtype,
                        seed=H + window + off, lo=lo, hi=hi)
                    kp, vp = kp.to(pool), vp.to(pool)
                    got = paged_attention_cuda(q, kp, vp, pt, pos,
                                               window=window)
                    want = paged_attention_plain(q, kp, vp, pt, pos,
                                                 window=window)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()),
                          f"{tag}: non-finite kernel output")
                    err = (got.float() - want.float()).abs().max().item()
                    tol = TOL[str(dtype)]
                    print(f"paged_attention {tag}{span} H={H} KV={KV} hd=128"
                          f" ps=16 rows={q.shape[0]} table={pt.shape[1]} "
                          f"pos<={int(pos.max())} q={str(dtype)[6:]} pools="
                          f"{str(pool)[6:]} window={window}: max_abs_err="
                          f"{err:.3e} (tol {tol:.0e})", flush=True)
                    check(err <= tol, f"paged_attention {tag}{span} {dtype} "
                          f"over {pool} window {window}: error {err} > {tol}")
                    max_err = max(max_err, err)
    max_err = max(max_err, check_split_shapes(
        torch, paged_attention_cuda, paged_attention_plain,
        "paged_attention", pairs))

    # timing at the target's main-path shape, bf16, full attention; then
    # the long-context case
    H, KV = shapes["target"]
    row = {}
    for span, (lo, hi, off) in spans.items():
        sets = paged_sets(torch, lambda i: paged_case(
            torch, H=H, KV=KV, dtype=torch.bfloat16, seed=100 + i + off,
            lo=lo, hi=hi), 2 * L2_BYTES)
        # few enough calls that the launch queue never fills in the sleep
        got = time_paged(
            torch, f"paged_attention{span}", paged_attention_cuda,
            paged_attention_plain, sets, sets,
            [gathered_kv(torch, *s) for s in sets], bound(sets, 0),
            f"target shape, bf16, pos<={max(int(s[4].max()) for s in sets)}",
            iters=20)
        row.update({("long_" if span else "") + k: v
                    for k, v in got.items()})
    # launches are read from the main path's run (phase 4), not from here
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:172",
            "launches": 0, "max_abs_err": max_err, **row}


def deq(torch, pool, sc, dtype):
    """A code pool dequantized to ``dtype`` (page scale per (page, head))."""
    return (pool.float() * sc[:, None, :, None]).to(dtype)


def quant_case(torch, *, H, KV, dtype, kv, seed, lo=20, hi=190, hd=128):
    """:func:`paged_case` over code pools, quantized as the engine writes
    them: each (page, kv head) of the N(0, 1) pools, scaled by a random
    factor in [0.25, 2), gets the scale amax / QMAX and codes in range.  The
    same table (stale rows, a shared prefix, scratch pages, the trash
    column)."""
    from repro_torch.kernels import quant
    q, kp, vp, pt, pos = paged_case(torch, H=H, KV=KV, dtype=dtype,
                                    seed=seed, lo=lo, hi=hi, hd=hd)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    out = []
    for pool in (kp, vp):
        fp = pool.float() * (0.25 + 1.75 * torch.rand(
            (pool.shape[0], 1, KV, 1), generator=gen, device="cuda"))
        sc = fp.abs().amax(dim=(1, 3)).clamp(min=quant.EPS) / quant.QMAX[kv]
        out += [quant.quantize_codes(fp / sc[:, None, :, None],
                                     quant.pool_dtype(kv, dtype)), sc]
    return q, out[0], out[2], out[1], out[3], pt, pos


def bound_quant(arg_sets, window):
    """:func:`bound` for the quantized kernel: one byte per code, plus the
    two fp32 scales of every page a live position reads."""
    nbytes = ops = 0
    for q, kp, _, _, _, pt, pos in arg_sets:
        H, hd = q.shape[2:]
        ps, KV = kp.shape[1], kp.shape[2]
        rows, n_live = live_rows(pt.cpu(), pos.cpu(), ps, window)
        pages = {r // ps for r in rows}
        nbytes += len(rows) * KV * hd * 2 + len(pages) * KV * 4 * 2 \
            + 2 * q.numel() * q.element_size() + pt.numel() * 4 \
            + pos.numel() * 4
        ops += 4 * (H // KV) * KV * hd * n_live
    t_bytes = nbytes / len(arg_sets) / H100_BYTES_PER_S
    t_ops = ops / len(arg_sets) / PEAK_OPS[str(arg_sets[0][0].dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels_quant(torch):
    print("== phase 3: paged_attention_quant vs its plain version",
          flush=True)
    from repro_torch.kernels.paged_attention import (
        paged_attention_quant_cuda, paged_attention_quant_plain)
    max_err = 0.0
    shapes = {"target": (28, 4), "draft": (12, 2)}
    spans = {"": (20, 190, 0), " long": (440, 500, 1000)}
    for tag, (H, KV) in shapes.items():
        for span, (lo, hi, off) in spans.items():
            for kv in ("int8", "fp8"):
                for dtype in (torch.bfloat16, torch.float32):
                    for window in (0, 64):
                        args = quant_case(torch, H=H, KV=KV, dtype=dtype,
                                          kv=kv, seed=H + window + len(kv)
                                          + off, lo=lo, hi=hi)
                        got = paged_attention_quant_cuda(*args,
                                                         window=window)
                        want = paged_attention_quant_plain(*args,
                                                           window=window)
                        torch.cuda.synchronize()
                        check(bool(torch.isfinite(got).all()),
                              f"{tag} {kv}: non-finite kernel output")
                        err = (got.float() - want.float()).abs().max().item()
                        tol = TOL[str(dtype)]
                        print(f"paged_attention_quant {tag}{span} H={H} "
                              f"KV={KV} hd=128 ps=16 rows={args[0].shape[0]}"
                              f" table={args[5].shape[1]} pos<="
                              f"{int(args[6].max())} {kv} q={str(dtype)[6:]}"
                              f" window={window}: max_abs_err={err:.3e} "
                              f"(tol {tol:.0e})", flush=True)
                        check(err <= tol, f"paged_attention_quant {tag}{span}"
                              f" {kv} {dtype} window {window}: error {err} > "
                              f"{tol}")
                        max_err = max(max_err, err)
    max_err = max(max_err, check_split_shapes(
        torch, paged_attention_quant_cuda, paged_attention_quant_plain,
        "paged_attention_quant",
        ((torch.bfloat16, "int8"), (torch.float32, "int8"),
         (torch.bfloat16, "fp8"), (torch.float32, "fp8"))))

    # timing at the int8 run's target shape: bf16 queries over int8 codes;
    # then the long-context case
    H, KV = shapes["target"]
    row = {}
    for span, (lo, hi, off) in spans.items():
        sets = paged_sets(torch, lambda i: quant_case(
            torch, H=H, KV=KV, dtype=torch.bfloat16, kv="int8",
            seed=200 + i + off, lo=lo, hi=hi), 2 * L2_BYTES)
        # at most a few hundred launches per timed loop, so the launch
        # queue never fills during the device sleep: the kernel cycles all
        # the sets; the plain version (~35 launches a call) a quarter of
        # them; SDPA sets (gathered bf16 K/V, about 17 MB each) six, past
        # L2 on their own
        lib_sets = [gathered_kv(torch, q, deq(torch, kp, ks, q.dtype),
                                deq(torch, vp, vs, q.dtype), pt, pos)
                    for q, kp, vp, ks, vs, pt, pos in sets[:6]]
        got = time_paged(
            torch, f"paged_attention_quant{span}", paged_attention_quant_cuda,
            paged_attention_quant_plain, sets, sets[:len(sets) // 4],
            lib_sets, bound_quant(sets, 0),
            f"target shape, bf16 q over int8 codes, "
            f"pos<={max(int(s[6].max()) for s in sets)}", iters=10)
        row.update({("long_" if span else "") + k: v
                    for k, v in got.items()})
    return {"name": "paged_attention_quant", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention_quant.cu",
            "replaces": "src/repro/kernels/paged_attention.py:121",
            "launches": 0, "max_abs_err": max_err, **row}


def bound_logprob(torch, h, w, vocab):
    """Least time for one call: h, W (once each), labels and the output
    over the HBM rate, against the products' flops over the peak rate they
    run at.  bf16 W: 2 * T * d * vocab flops at the bf16 tensor-core rate
    with bf16 h; with fp32 h, the function the kernel computes, fp32 math
    over bf16 W, is three bf16 products (h split into three bf16 parts, a
    bf16 x bf16 product being exact in fp32): 3 * 2 * T * d * vocab at the
    bf16 rate, which is also below the 2 * T * d * vocab fp32 CUDA-core
    count it replaced (4.165 ms at the target's shape).  fp32 W: the fp32
    rate."""
    T, d = h.shape[0] * h.shape[1], h.shape[2]
    nbytes = h.numel() * h.element_size() + w.numel() * w.element_size() \
        + T * 4 + T * 4
    passes = 3 if (h.dtype, w.dtype) == (torch.float32,
                                         torch.bfloat16) else 1
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = passes * 2 * T * d * vocab / PEAK_OPS[str(w.dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa(q, k, v, m):
    """The library yardstick: scaled_dot_product_attention with grouped kv
    heads over pre-gathered K/V."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                          enable_gqa=True)


def logprob_inputs(torch, *, T, d, V, hdtype, tied, seed):
    """Post-norm-like hidden states (N(0,1)), a weight at the model's init
    scale (untied unembedding: std 1/sqrt(d), row-major (d, V); tied: the
    embedding's std 1, passed as the transpose of a row-major (V, d)
    matrix), labels in [0, V) with 0 among them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((4 * 4, T // 16, d), generator=gen,
                    device="cuda").to(hdtype)
    if tied:
        w = torch.randn((V, d), generator=gen, device="cuda").bfloat16().T
    else:
        w = (torch.randn((d, V), generator=gen, device="cuda")
             * d ** -0.5).bfloat16()
    labels = torch.randint(0, V, (4 * 4, T // 16), generator=gen,
                           device="cuda")
    labels[0, 0] = 0
    return h, w, labels


def phase_kernels_logprob(torch):
    print("== phase 3: logprob_gather vs its plain version", flush=True)
    from repro_torch.configs import qwen25_math
    from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                    logprob_gather_plain)
    from repro_torch.models.common import padded_vocab
    tgt, dft = qwen25_math.TARGET, qwen25_math.DRAFT
    T = 4 * 4 * 16              # slots x n x max_step_tokens
    cases = [("target", tgt, torch.float32, False),
             ("target", tgt, torch.bfloat16, False),
             ("draft", dft, torch.bfloat16, True)]
    max_err = 0.0
    for tag, cfg, hdt, tied in cases:
        V = padded_vocab(cfg)
        h, w, labels = logprob_inputs(torch, T=T, d=cfg.d_model, V=V,
                                      hdtype=hdt, tied=tied, seed=cfg.d_model)
        labels.clamp_(max=cfg.vocab_size - 1)
        got = logprob_gather_cuda(h, w, labels, cfg.vocab_size)
        want = logprob_gather_plain(h, w, labels, cfg.vocab_size)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite log-probs")
        diff = (got - want).abs()
        err = diff.max().item()
        over = (diff - LOGPROB_ATOL - LOGPROB_RTOL * want.abs()).max().item()
        print(f"logprob_gather {tag} T={T} d={cfg.d_model} V={V} vocab="
              f"{cfg.vocab_size} h={str(hdt)[6:]} w=bfloat16 "
              f"{'tied (embedding.T, strided)' if tied else 'row-major'}: "
              f"max_abs_err={err:.3e} (tol {LOGPROB_ATOL:.0e} + "
              f"{LOGPROB_RTOL:.0e} x |log-prob|), log-probs in "
              f"[{want.min().item():.2f}, {want.max().item():.2f}]",
              flush=True)
        check(over <= 0, f"logprob_gather {tag} {hdt}: error {err} over "
              f"the tolerance")
        max_err = max(max_err, err)

    row = {"name": "logprob_gather", "route": "cuda",
           "source": "src/repro_torch/csrc/logprob_gather.cu",
           "replaces": "src/repro/kernels/logprob_gather.py:69",
           "launches": 0, "max_abs_err": max_err}
    # bf16 h (scoring, RWKV shared scoring) fills the row's main fields;
    # fp32 h (shared scoring over quantized pools) its fp32_h_* fields
    for hdt in (torch.bfloat16, torch.float32):
        h, w, labels = logprob_inputs(torch, T=T, d=tgt.d_model,
                                      V=tgt.vocab_size, hdtype=hdt,
                                      tied=False, seed=7)
        got = time_logprob(torch, f"target T={T} d={tgt.d_model} V="
                           f"{tgt.vocab_size}, h={str(hdt)[6:]}, w=bfloat16",
                           h, w, labels, tgt.vocab_size)
        pre = "" if hdt == torch.bfloat16 else "fp32_h_"
        row.update({pre + k: v for k, v in got.items()})
    return row


def time_logprob(torch, what, h, w, labels, vocab):
    """Time the gather, its plain version and the library's two calls
    (``h @ W``, then ``-cross_entropy``) on one input; print them beside
    the bound and return them as a kernel row's fields."""
    import torch.nn.functional as F
    from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                    logprob_gather_plain)
    ms, ms_host = time_ms(
        torch, lambda a, b, c: logprob_gather_cuda(a, b, c, vocab),
        [(h, w, labels)], iters=5)
    plain_ms, _ = time_ms(
        torch, lambda a, b, c: logprob_gather_plain(a, b, c, vocab),
        [(h, w, labels)], iters=2)
    library_ms, _ = time_ms(
        torch, lambda a, b, c: -F.cross_entropy(
            (a.reshape(-1, a.shape[-1]) @ b.to(a.dtype)).float(), c,
            reduction="none"), [(h, w, labels.reshape(-1))], iters=3)
    bound_ms, bound_by = bound_logprob(torch, h, w, vocab)
    print(f"logprob_gather timing ({what}), device-only ms per call: kernel "
          f"{ms:.4f}, bound {bound_ms:.4f} ({bound_by}), plain "
          f"{plain_ms:.4f}, library (h @ W, then -cross_entropy: two calls) "
          f"{library_ms:.4f}; back to back from the host: kernel "
          f"{ms_host:.4f}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def flash_case(torch, *, B, S, H, KV, dtype, seed, hd=128, Sk=None):
    """q (B,S,H,hd), k/v (B,Sk,KV,hd) (Sk defaults to S): N(0, 1), as
    rope'd projections of normed hidden states are about."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Sk = S if Sk is None else Sk
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def live_pairs(S, Sk, window, causal):
    """(query, key) pairs a call computes: every one of S x Sk when not
    causal, else those with key <= query (and within the window)."""
    if not causal:
        return S * Sk
    return sum(min(i + 1, window) if window else i + 1 for i in range(S))


def bound_flash(q, k, window, causal=True):
    """Least time for one call: 4 * hd flops per live (query head, key)
    pair at the tensor-core (bf16) or CUDA-core (fp32) rate, against q, k,
    v and the output moved once at the HBM rate."""
    B, S, H, hd = q.shape
    ops = 4 * B * H * hd * live_pairs(S, k.shape[1], window, causal)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels_flash(torch):
    print("== phase 3: flash_attention vs its plain version", flush=True)
    from repro_torch.kernels.flash_attention import (LOG2E,
                                                     flash_attention_cuda,
                                                     flash_attention_plain,
                                                     uses_hopper_kernel)
    max_err = 0.0
    shapes = {"target": (28, 4), "draft": (12, 2)}
    # bf16 at hd 128 runs the TMA/wgmma kernel: 128-key tiles, 2 x (64 // G)
    # = 18 or 20 positions a block.  fp32 runs the CUDA-core kernel and
    # bf16 at hd 40 and 16 (the toy models' head dims) the mma.sync one:
    # 64-key tiles, 64 // G positions.  Window 8 is shorter than every
    # query and key tile, so late rows' first tile is wholly masked.
    # S = 1000 is a multiple of no tile.
    cases = [(tag, H, KV, 128, dtype)
             for tag, (H, KV) in shapes.items()
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(f"toy G={H // KV}", H, KV, hd, torch.bfloat16)
              for H, KV in ((28, 4), (4, 4)) for hd in (40, 16)]
    for tag, H, KV, hd, dtype in cases:
        check(uses_hopper_kernel(dtype, hd) == (dtype == torch.bfloat16
                                                and hd == 128),
              f"flash {tag} hd={hd} {dtype}: unexpected kernel choice")
        for window in (0, 8):
            q, k, v = flash_case(torch, B=4, S=1000, H=H, KV=KV, hd=hd,
                                 dtype=dtype, seed=H + hd % 128 + window)
            got = flash_attention_cuda(q, k, v, window=window)
            want, want_lse = flash_attention_plain(q, k, v, window=window,
                                                   return_lse=True)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"flash {tag}: non-finite kernel output")
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[str(dtype)]
            lse_text = ""
            if uses_hopper_kernel(dtype, hd):
                # asked for its log-sum-exp, the kernel's output is the same
                # bits; the base-2 log-sum-exp within 1e-3 (natural units)
                # of the plain one (fp32 sums of exp2 in another order)
                with_lse, lse = flash_attention_cuda(q, k, v, window=window,
                                                     return_lse=True)
                torch.cuda.synchronize()
                same = torch.equal(got, with_lse)
                lse_err = (lse / LOG2E - want_lse).abs().max().item()
                lse_text = (f"; with its log-sum-exp the output is bitwise "
                            f"the same: {same}, lse max_abs_err="
                            f"{lse_err:.3e} (tol 1e-3)")
                check(same, f"flash_attention {tag} window {window}: the "
                      f"output differs when the log-sum-exp is asked for")
                check(lse_err <= 1e-3, f"flash_attention {tag} window "
                      f"{window}: log-sum-exp error {lse_err} > 1e-3")
                del with_lse, lse
            print(f"flash_attention {tag} B=4 S=1000 H={H} KV={KV} "
                  f"hd={hd} {str(dtype)[6:]} causal window={window}: "
                  f"max_abs_err={err:.3e} (tol {tol:.0e}){lse_text}",
                  flush=True)
            check(err <= tol, f"flash_attention {tag} hd={hd} {dtype} "
                  f"window {window}: error {err} > {tol}")
            max_err = max(max_err, err)
            del q, k, v, got, want, want_lse

    # timing at a scoring shape: B = 4, S = 1024, the target's heads, bf16
    H, KV = shapes["target"]
    sets = [flash_case(torch, B=4, S=1024, H=H, KV=KV, dtype=torch.bfloat16,
                       seed=300 + i) for i in range(2)]   # 67 MB each
    got = time_flash(torch, f"B=4 S=1024 H={H} KV={KV} hd=128 bf16 causal",
                     sets, iters=20)
    del sets
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "launches": 0, "max_abs_err": max_err, **got}


def time_flash(torch, what, sets, iters, causal=True):
    """Time the flash kernel, its plain version and SDPA (``is_causal`` as
    ``causal``, ``enable_gqa``, over (B, H, S, hd) copies) cycling over
    ``sets``; print them beside the bound and return them as a kernel
    row's fields."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    ms, ms_host = time_ms(torch, lambda *a: flash_attention_cuda(
        *a, causal=causal), sets, iters=iters)
    plain_ms, plain_host = time_ms(
        torch, lambda *a: flash_attention_plain(*a, causal=causal), sets,
        iters=1)
    lib_sets = [[t.transpose(1, 2).contiguous() for t in st] for st in sets]
    library_ms, library_host = time_ms(
        torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), lib_sets,
        iters=iters)
    bound_ms, bound_by = bound_flash(sets[0][0], sets[0][1], 0, causal)
    print(f"flash_attention timing ({what}, {len(sets)} input sets), "
          f"device-only ms per call: kernel {ms:.4f}, bound {bound_ms:.4f} "
          f"({bound_by}), plain {plain_ms:.4f}, library "
          f"(scaled_dot_product_attention is_causal={causal} enable_gqa, "
          f"(B,H,S,hd)) "
          f"{library_ms:.4f}; back to back from the host: kernel "
          f"{ms_host:.4f}, plain {plain_host:.4f}, library "
          f"{library_host:.4f}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def bound_flash_bwd(q, k, window, causal=True):
    """Least time for one backward call: five products of 2 * hd flops per
    live (query head, key) pair (2.5 times the forward's count) at the
    tensor-core (bf16) or CUDA-core (fp32) rate, against q, k, v, the
    output and its gradient read once and dq, dk, dv written once at the
    HBM rate."""
    B, S, H, hd = q.shape
    ops = 5 * 2 * B * H * hd * live_pairs(S, k.shape[1], window, causal)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bwd_case(torch, *, B, S, H, KV, hd, dtype, window, seed,
                   causal=True, Sk=None):
    """(q, k, v, out, dout) and the backward's keyword arguments: q, k, v
    (Sk keys, default S) and dO N(0, 1) in ``dtype``; where the TMA/wgmma
    backward takes the inputs, out and the base-2 log-sum-exp from the
    forward kernel (as a train step passes them), else out from the plain
    forward.  Both backwards see the same out."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain, uses_hopper_bwd_kernel)
    q, k, v = flash_case(torch, B=B, S=S, H=H, KV=KV, hd=hd, dtype=dtype,
                         seed=seed, Sk=Sk)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    if uses_hopper_bwd_kernel(dtype, hd):
        out, lse = flash_attention_cuda(q, k, v, window=window,
                                        causal=causal, return_lse=True)
        return (q, k, v, out, dout), {"lse": lse}
    return (q, k, v, flash_attention_plain(q, k, v, window=window,
                                           causal=causal), dout), {}


def time_flash_bwd(torch, tag, S, H, KV, hd=128, causal=True, Sk=None,
                   B=4, window=0):
    """Device ms per call of the backward kernel, its plain version and
    SDPA's backward at (B, S queries, Sk keys (default S), H, KV, hd,
    bf16, ``causal``, ``window``), and the bound; two input sets cycled
    (about 50 MB each at the target's heads).  SDPA takes a window as a
    boolean mask; its time is None where no backend takes the shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _live, flash_attention_bwd_cuda, flash_attention_bwd_plain)
    cases = [flash_bwd_case(torch, B=B, S=S, H=H, KV=KV, hd=hd,
                            dtype=torch.bfloat16, window=window,
                            seed=400 + i, causal=causal, Sk=Sk)
             for i in range(2)]
    sets = [(*args, i) for i, (args, _) in enumerate(cases)]
    kw = {"causal": causal, "window": window}
    ms, ms_host = time_ms(torch, lambda q, k, v, o, d, i:
                          flash_attention_bwd_cuda(q, k, v, o, d, **kw,
                                                   **cases[i][1]),
                          sets, iters=10 if hd < 256 else 4)
    plain_ms, _ = time_ms(torch, lambda *a: flash_attention_bwd_plain(
        *a, **kw), [args for args, _ in cases], iters=2 if hd < 256 else 1)
    Sk = S if Sk is None else Sk
    mask = _live(S, Sk, causal, window, "cuda") if window else None
    what = "a boolean window mask" if window else f"is_causal={causal}"
    try:
        lib_sets = []
        for (q, k, v, _, dout), _ in cases:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True)
            lib_sets.append((out, qt, kt, vt,
                             dout.transpose(1, 2).contiguous()))
        library_ms, library_host = time_ms(
            torch, lambda o, a, b, c, d: torch.autograd.grad(
                o, (a, b, c), d, retain_graph=True), lib_sets,
            iters=10 if hd < 256 else 4)
        library, library_host = f"{library_ms:.4f}", f"{library_host:.4f}"
    except RuntimeError as e:        # no SDPA backend takes the shape
        library_ms, library_host = None, "none"
        library = f"none ({str(e).splitlines()[0]})"
    bound_ms, bound_by = bound_flash_bwd(cases[0][0][0], cases[0][0][1],
                                         window, causal)
    print(f"flash_attention_bwd timing, {tag} (B={B} S={S} Sk={Sk} H={H} "
          f"KV={KV} hd={hd} bf16 causal={causal} window={window}), "
          f"device-only ms per call: kernel {ms:.4f}, "
          f"bound {bound_ms:.4f} ({bound_by}), plain {plain_ms:.4f}, "
          f"library (the backward of scaled_dot_product_attention "
          f"{what} enable_gqa, (B,H,S,hd), alone) {library}; "
          f"back to back from the host: kernel {ms_host:.4f}, library "
          f"{library_host}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_kernels_flash_bwd(torch):
    print("== phase 3: flash_attention_bwd vs its plain version", flush=True)
    from repro_torch.kernels.flash_attention import (
        bwd_split_plan, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        uses_hopper_bwd_kernel)
    # the training shapes: the draft's heads at S - 1 = 511 positions (what
    # run t1 trains) and the target/PRM's at 512, bf16 hd 128 through the
    # TMA/wgmma backward (the forward kernel's out and log-sum-exp); the
    # draft's heads at hd 64 with a window of 8, shorter than every tile;
    # the toy triple's fp32 heads (hd 16 and 40, G = 2, the CUDA-core
    # kernels), causal and with window 8, shorter than every 32-query and
    # 64-key tile, so late rows' first tiles are wholly masked
    cases = [("draft", 12, 2, 128, torch.bfloat16, 0, 511),
             ("target", 28, 4, 128, torch.bfloat16, 0, 512),
             ("draft hd=64", 12, 2, 64, torch.bfloat16, 8, 511)]
    cases += [(f"toy hd={hd}", 4, 2, hd, torch.float32, w, 200)
              for hd in (16, 40) for w in (0, 8)]
    max_err = 0.0
    for tag, H, KV, hd, dtype, window, S in cases:
        hopper = uses_hopper_bwd_kernel(dtype, hd)
        check(hopper == (dtype == torch.bfloat16),
              f"flash_attention_bwd {tag}: unexpected kernel choice")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        route = ("TMA/wgmma (flash_attention_bwd_hopper.cu), plan (chunk, "
                 f"runs) on {sms} SMs "
                 f"{bwd_split_plan(4, S, S, H, KV, window=window, sms=sms)}"
                 if hopper else "mma.sync / CUDA cores "
                 "(flash_attention_bwd.cu)")
        args, kw = flash_bwd_case(torch, B=4, S=S, H=H, KV=KV, hd=hd,
                                  dtype=dtype, window=window,
                                  seed=H + hd + window)
        got = flash_attention_bwd_cuda(*args, window=window, **kw)
        again = flash_attention_bwd_cuda(*args, window=window, **kw)
        want = flash_attention_bwd_plain(*args, window=window)
        torch.cuda.synchronize()
        tol = BWD_TOL[str(dtype)]
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == dtype and g.shape == w.shape
                  and bool(torch.isfinite(g).all()),
                  f"flash_attention_bwd {tag}: bad {name}")
            err = (g.float() - w.float()).abs().max().item()
            scale = max(w.float().abs().max().item(), 1.0)
            check(err <= tol * scale, f"flash_attention_bwd {tag} {name}: "
                  f"error {err} > {tol} x {scale}")
            errs.append(f"{name} {err:.3e} (scale {scale:.2f})")
            max_err = max(max_err, err)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"flash_attention_bwd {tag} B=4 S={S} H={H} KV={KV} hd={hd} "
              f"{str(dtype)[6:]} causal window={window}: route {route}; "
              f"max_abs_err {', '.join(errs)} (tol {tol:.0e} x scale); two "
              f"calls bitwise equal: {same}", flush=True)
        check(same, f"flash_attention_bwd {tag}: two calls differ")
        del args, kw, got, again, want

    # timing at both training shapes (B = 4, bf16, hd 128)
    target = time_flash_bwd(torch, "target", 512, 28, 4)
    draft = time_flash_bwd(torch, "draft", 511, 12, 2)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_hopper.cu",
            "replaces": "src/repro/models/attention.py:57 (no Pallas "
                        "kernel: the reference's training differentiates "
                        "this einsum attention through XLA)",
            "launches": 0, "max_abs_err": max_err, **target,
            **{f"draft_{k}": v for k, v in draft.items()},
            "other_source": "src/repro_torch/csrc/flash_attention_bwd.cu "
                            "(fp32, bf16 head_dim 16 and 40)"}


# the decays' ends under models/rwkv.py:_decay's clamp of log(-log w) to
# [-8, 4]: exp(-e^4), about 1.8e-24 a step, and exp(-e^-8), about 0.99966
FAST_DECAY, SLOW_DECAY = math.exp(-math.exp(4.0)), math.exp(-math.exp(-8.0))


def rwkv_case(torch, *, B, T, H, hd, dtype, seed, decays="spread"):
    """r, k, v N(0, 1) in ``dtype`` (as normed projections are about);
    decays spread in (0.45, 0.999), at one clamp end (``fast``, ``slow``)
    or ``mixed`` element by element between the two; u N(0, 0.3^2); a
    non-zero fp32 initial state."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = (randn(B, T, H, hd).to(dtype) for _ in range(3))
    shape = (B, T, H, hd)
    uni = torch.rand(shape, generator=gen, device="cuda")
    w = {"spread": lambda: 0.45 + 0.549 * uni,
         "fast": lambda: torch.full(shape, FAST_DECAY, device="cuda"),
         "slow": lambda: torch.full(shape, SLOW_DECAY, device="cuda"),
         "mixed": lambda: torch.where(uni < 0.5, FAST_DECAY, SLOW_DECAY)
         }[decays]()
    return r, k, v, w, 0.3 * randn(H, hd), 0.1 * randn(B, H, hd, hd)


def scan_err(torch, tag, got, want):
    """Largest error of the kernel's (out, state) against the plain
    version's, checked against 1e-4 of each one's scale (both sides compute
    in fp32 from the same inputs, in other summation orders)."""
    errs, worst = [], 0.0
    for name, g, w in zip(("out", "state"), got, want):
        check(bool(torch.isfinite(g).all()),
              f"rwkv6_scan {tag}: non-finite {name}")
        err = (g - w).abs().max().item() if w.numel() else 0.0
        scale = w.abs().max().item() if w.numel() else 0.0
        errs.append(f"{name} max_abs_err={err:.3e} (tol 1e-4 x "
                    f"{scale:.2f})")
        check(err <= 1e-4 * max(scale, 1.0), f"rwkv6_scan {tag}: {name} "
              f"error {err} over 1e-4 x {scale}")
        worst = max(worst, err)
    return worst, ", ".join(errs)


def check_rwkv_forms(torch):
    """The scan beyond phase 3's timed shapes: clamp-end and mixed decays,
    the plan's most segments, the in-place decode form, determinism, a CUDA
    graph and two streams.  Returns the largest error against the plain
    version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,
                                                rwkv6_scan_plain, scan_plan)
    worst = 0.0
    for i, (tag, B, T, H, decays) in enumerate((
            ("decode, mixed decays", 16, 1, 40, "mixed"),
            ("shared scoring, fast decays", 16, 17, 40, "fast"),
            ("full sequence, fast decays", 4, 1024, 40, "fast"),
            ("full sequence, slow decays", 4, 1024, 40, "slow"),
            ("full sequence, mixed decays", 4, 1024, 40, "mixed"),
            ("one head", 1, 4096, 1, "mixed"))):
        args = rwkv_case(torch, B=B, T=T, H=H, hd=64, dtype=torch.bfloat16,
                         seed=600 + i, decays=decays)
        err, text = scan_err(torch, tag, rwkv6_scan_cuda(*args),
                             rwkv6_scan_plain(*args))
        worst = max(worst, err)
        print(f"rwkv6_scan {tag} B={B} T={T} H={H} hd=64 bf16 plan "
              f"{scan_plan(B, T, H, 64)}: {text}", flush=True)
    # the in-place decode form, half the rows frozen
    r, k, v, w, u, s0 = rwkv_case(torch, B=16, T=1, H=40, hd=64,
                                  dtype=torch.bfloat16, seed=610)
    live = torch.arange(16, device="cuda") % 2 == 0
    state = s0.clone()
    out = ops.rwkv6_scan_(r, k, v, w, u, state, live)
    want_out, want_s = rwkv6_scan_cuda(r, k, v, w, u, s0)
    plain_out, plain_s = rwkv6_scan_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    frozen = torch.equal(state[~live], s0[~live])
    same = torch.equal(state[live], want_s[live]) and torch.equal(
        out, want_out)
    err, text = scan_err(torch, "in-place decode", (out, state), (
        plain_out, torch.where(live[:, None, None, None], plain_s, s0)))
    worst = max(worst, err)
    print(f"rwkv6_scan in-place decode B=16 H=40, 8 rows frozen: frozen "
          f"rows bitwise unchanged={frozen}, live rows and out bitwise the "
          f"out-of-place kernel's={same}; {text}", flush=True)
    check(frozen and same, "rwkv6_scan in-place decode: a frozen row moved "
          "or a live row differs from the out-of-place kernel")
    # two calls, a graph replay and two streams, at the split shape
    args = rwkv_case(torch, B=4, T=1024, H=40, hd=64, dtype=torch.bfloat16,
                     seed=620)
    first = rwkv6_scan_cuda(*args)
    again = rwkv6_scan_cuda(*args)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rwkv6_scan_cuda(*args)
    fresh = rwkv_case(torch, B=4, T=1024, H=40, hd=64, dtype=torch.bfloat16,
                      seed=621)
    for dst, src in zip(args, fresh):
        dst.copy_(src)
    graph.replay()
    eager = rwkv6_scan_cuda(*args)
    torch.cuda.synchronize()
    replayed = all(torch.equal(a, b) for a, b in zip(captured, eager))
    del graph, captured
    sets = [fresh, rwkv_case(torch, B=2, T=600, H=40, hd=64,
                             dtype=torch.bfloat16, seed=622)]
    streams = [torch.cuda.Stream() for _ in sets]
    torch.cuda.synchronize()
    outs = []
    for _ in range(2):
        for stream, a in zip(streams, sets):
            with torch.cuda.stream(stream):
                outs.append(rwkv6_scan_cuda(*a))
    torch.cuda.synchronize()
    for j, got in enumerate(outs):
        err, _ = scan_err(torch, "two streams", got,
                          rwkv6_scan_plain(*sets[j % 2]))
        worst = max(worst, err)
    print(f"rwkv6_scan B=4 T=1024 plan {scan_plan(4, 1024, 40, 64)}: two "
          f"calls bitwise equal={bitwise}; a CUDA graph replay over new "
          f"inputs bitwise the eager call={replayed}; two streams at once "
          f"(T 1024 and 600) within 1e-4 of the plain version", flush=True)
    check(bitwise and replayed, "rwkv6_scan: two calls or a graph replay "
          "differ from the eager call")
    return worst


def bound_rwkv(r):
    """Least time for one call: r, k, v, w, u and the output moved once and
    the state read and written once, over the HBM rate, against the flops
    the recurrence needs at the fp32 rate.  Per (row, step, head): the u
    term sum_k r[k] u[k] k[k] is one dot product (3 hd flops), so the output
    sum_k r[k] S[k, n] + (that) v[n] takes 2 hd^2 + 2 hd, and the update
    w[k] S[k, n] + k[k] v[n] takes 3 hd^2: 5 hd^2 + 5 hd in all."""
    B, T, H, hd = r.shape
    nbytes = B * T * H * hd * (3 * r.element_size() + 4 + 4) + H * hd * 4 \
        + 2 * B * H * hd * hd * 4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = B * T * H * (5 * hd * hd + 5 * hd) / PEAK_OPS["torch.float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels_rwkv(torch):
    print("== phase 3: rwkv6_scan vs its plain version", flush=True)
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,
                                                rwkv6_scan_plain, scan_plan)
    # rwkv6-3b's heads (H = 40, hd = 64, bf16 r/k/v) at its three call
    # shapes, and a toy model's (hd = 32, fp32)
    cases = [("decode (4 slots x n = 4)", 16, 1, 40, 64, torch.bfloat16),
             ("shared scoring (16 + 1 feeds)", 16, 17, 40, 64,
              torch.bfloat16),
             ("full sequence", 4, 1024, 40, 64, torch.bfloat16),
             ("toy", 4, 300, 4, 32, torch.float32)]
    max_err, row = 0.0, None
    for i, (tag, B, T, H, hd, dtype) in enumerate(cases):
        args = rwkv_case(torch, B=B, T=T, H=H, hd=hd, dtype=dtype,
                         seed=400 + i)
        err, text = scan_err(torch, tag, rwkv6_scan_cuda(*args),
                             rwkv6_scan_plain(*args))
        max_err = max(max_err, err)
        print(f"rwkv6_scan {tag} B={B} T={T} H={H} hd={hd} "
              f"{str(dtype)[6:]} plan {scan_plan(B, T, H, hd)}: {text}",
              flush=True)
        if dtype != torch.bfloat16:
            continue
        # time at the main paths' shapes over input sets cycled past L2
        # (a decode step finds its state in device memory, not in L2)
        sets = [args]
        while len(sets) < 2 or sum(
                a[5].numel() * 4 + a[3].numel() * 4 for a in sets) \
                < 2 * L2_BYTES:
            sets.append(rwkv_case(torch, B=B, T=T, H=H, hd=hd, dtype=dtype,
                                  seed=500 + 10 * i + len(sets)))
        ms, ms_host, host_ms = time_ms(
            torch, lambda *a: rwkv6_scan_cuda(*a), sets, iters=20,
            enqueue=True)
        bound_ms, bound_by = bound_rwkv(args[0])
        plain = "not timed (about 6 launches a step)"
        plain_ms = None
        if T <= 17:
            plain_ms, _ = time_ms(torch, lambda *a: rwkv6_scan_plain(*a),
                                  sets[:2], iters=1)
            plain = f"{plain_ms:.4f}"
        print(f"rwkv6_scan timing, {tag} B={B} T={T} H={H} hd={hd} bf16 "
              f"({len(sets)} input sets cycled past L2), device-only ms per "
              f"call: kernel {ms:.4f}, bound {bound_ms:.6f} ({bound_by}), "
              f"plain {plain}, library: no single PyTorch call computes "
              f"WKV6; back to back from the host: kernel {ms_host:.4f}; "
              f"the wrapper's host time per call {host_ms:.4f}",
              flush=True)
        if row is None:            # the decode shape: most launches
            row = {"name": "rwkv6_scan", "route": "cuda",
                   "source": "src/repro_torch/csrc/rwkv6_scan.cu",
                   "replaces": "src/repro/kernels/rwkv6_scan.py:56",
                   "launches": 0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "host_ms": host_ms}
        del sets
    row["max_abs_err"] = max(max_err, check_rwkv_forms(torch))
    return row


def bound_rwkv_bwd(r):
    """Least time for one backward call: r, k, v, w and dO read and dr,
    dk, dv, dw written once, u and du, the state, its cotangent and the
    initial state's gradient moved once, over the HBM rate, against the
    flops at the fp32 rate.  Per (row, step, head): the state recompute
    S <- w S + k v^T and the update dS <- r dO^T + w dS take 3 hd^2 each,
    dr = S dO, dk = dS v, dv = dS^T k and dw = rowsum(dS * S) 2 hd^2 each;
    the u terms (v . dO, sum_k r u k, the three bonus terms and du) about
    16 hd: 14 hd^2 + 16 hd in all."""
    B, T, H, hd = r.shape
    nbytes = B * T * H * hd * (6 * r.element_size() + 4 * 4) \
        + 2 * H * hd * 4 + 3 * B * H * hd * hd * 4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = B * T * H * (14 * hd * hd + 16 * hd) / PEAK_OPS["torch.float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wall_ms(torch, fn, args, reps=1):
    """ms per call of ``fn(*args)`` with CUDA events around ``reps`` calls
    enqueued back to back after a warm-up: for a plain version whose
    thousands of small launches keep the host busier than the card."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels_rwkv_bwd(torch):
    """Phase 3 for the WKV6 backward kernel: rwkv6-3b's training shape
    (B 4, T 512, H 40, hd 64, bf16 r/k/v, spread decays), a ragged T 509
    with decays at both clamp ends and mixed, B = H = 1 at T 4096 with
    decays near 1 and a toy hd 32 in fp32, each with a non-zero initial
    state and a non-zero cotangent on the final state, against
    ``rwkv6_scan_bwd_plain`` at ``SCAN_BWD_TOL`` and twice bitwise; then
    timed at the training shape beside its bound and the plain version.
    Returns its kernel row."""
    print("== phase 3: rwkv6_scan_bwd vs its plain version", flush=True)
    from repro_torch.kernels.rwkv6_scan import (BWD_SEGMENT,
                                                rwkv6_scan_bwd_cuda,
                                                rwkv6_scan_bwd_plain)
    cases = [("training shape", 4, 512, 40, 64, torch.bfloat16, "spread"),
             ("ragged, fast decays", 4, 509, 40, 64, torch.bfloat16, "fast"),
             ("ragged, slow decays", 4, 509, 40, 64, torch.bfloat16, "slow"),
             ("ragged, mixed decays", 4, 509, 40, 64, torch.bfloat16,
              "mixed"),
             ("one head, decays near 1", 1, 4096, 1, 64, torch.bfloat16,
              "slow"),
             ("toy", 4, 300, 4, 32, torch.float32, "spread")]
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    max_err = 0.0

    def inputs(B, T, H, hd, dtype, decays, seed):
        args = rwkv_case(torch, B=B, T=T, H=H, hd=hd, dtype=dtype,
                         seed=seed, decays=decays)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        dout = torch.randn((B, T, H, hd), generator=gen, device="cuda")
        dstate = torch.randn((B, H, hd, hd), generator=gen, device="cuda")
        return (*args, dout, dstate)

    for i, (tag, B, T, H, hd, dtype, decays) in enumerate(cases):
        args = inputs(B, T, H, hd, dtype, decays, 800 + i)
        got = rwkv6_scan_bwd_cuda(*args)
        again = rwkv6_scan_bwd_cuda(*args)
        want = rwkv6_scan_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for j, (name, g, w) in enumerate(zip(names, got, want)):
            check(g.dtype == w.dtype and g.shape == w.shape
                  and bool(torch.isfinite(g).all()),
                  f"rwkv6_scan_bwd {tag}: bad {name}")
            tol = SCAN_BWD_TOL[str(dtype)] if j < 3 else 1e-4
            err = (g.float() - w.float()).abs().max().item()
            scale = max(w.float().abs().max().item(), 1.0)
            check(err <= tol * scale, f"rwkv6_scan_bwd {tag} {name}: error "
                  f"{err} > {tol} x {scale}")
            errs.append(f"{name} {err:.3e} (tol {tol:.0e} x {scale:.2f})")
            max_err = max(max_err, err)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"rwkv6_scan_bwd {tag} B={B} T={T} H={H} hd={hd} "
              f"{str(dtype)[6:]} {decays} decays, non-zero state and "
              f"final-state cotangent: max_abs_err {', '.join(errs)}; two "
              f"calls bitwise equal: {same}", flush=True)
        check(same, f"rwkv6_scan_bwd {tag}: two calls differ")
        del args, got, again, want
    # timing at the training shape, two input sets cycled (83 MB each)
    B, T, H, hd = 4, 512, 40, 64
    sets = [inputs(B, T, H, hd, torch.bfloat16, "spread", 820 + i)
            for i in range(2)]
    ms, ms_host = time_ms(torch, lambda *a: rwkv6_scan_bwd_cuda(*a), sets,
                          iters=5)
    scratch = rwkv6_scan_bwd_cuda.scratch_bytes     # what the call allocated
    plain_ms = wall_ms(torch, rwkv6_scan_bwd_plain, sets[0])
    bound_ms, bound_by = bound_rwkv_bwd(sets[0][0])
    print(f"rwkv6_scan_bwd timing, training shape B={B} T={T} H={H} hd={hd}"
          f" bf16, device-only ms per call: kernel {ms:.4f}, bound "
          f"{bound_ms:.4f} ({bound_by}), plain {plain_ms:.4f} (back to back"
          f" from the host: about 20 launches a step), library: no single "
          f"PyTorch call computes the WKV6 backward; back to back from the "
          f"host: kernel {ms_host:.4f}; checkpoint scratch "
          f"{scratch / 1e6:.1f} MB (fp32 states every {BWD_SEGMENT} steps)",
          flush=True)
    del sets
    return {"name": "rwkv6_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
            "replaces": "src/repro/models/rwkv.py:92 (no Pallas kernel: "
                        "the reference's training differentiates this "
                        "plain scan through XLA)",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "scratch_bytes": scratch}


# the Gemma families' attention shapes at head_dim 256: query heads, kv
# heads and each family's sliding window
GEMMA_SHAPES = {"gemma3": (4, 1, 512), "rgemma": (16, 1, 2048)}


def phase_kernels_gemma(torch, rows):
    """Phase 3 at the Gemma families' shapes (head_dim 256; gemma3's 4
    query heads over 1 kv head, recurrentgemma's 16 over 1): flash
    attention (bf16 through the 256-wide TMA/wgmma kernel, fp32 through
    the CUDA-core kernel; causal with no window and with each family's
    window over a sequence it binds), paged and int8 paged attention
    (bf16 and fp32 queries, windows 0 and 64) and the gather at both
    vocabularies (tied bf16 W, bf16 and fp32 h), each against its plain
    version, then timed beside its bound, the plain version and the
    library call.  The timings go into each kernel's row of ``rows`` under
    the shape's prefix (``gemma3_ms`` and the like); ``max_abs_err`` takes
    the largest error."""
    print("== phase 3: the Gemma shapes (head_dim 256) vs the plain "
          "versions", flush=True)
    from repro_torch.configs import gemma3_1b, recurrentgemma_9b
    from repro_torch.kernels.flash_attention import (LOG2E,
                                                     flash_attention_cuda,
                                                     flash_attention_plain,
                                                     uses_hopper_kernel)
    from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                    logprob_gather_plain)
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_plain,
        paged_attention_quant_cuda, paged_attention_quant_plain)
    from repro_torch.models.common import padded_vocab
    by = {r["name"]: r for r in rows}

    def err_of(name, got, want, tol, text):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name} {text}: non-finite "
              f"kernel output")
        err = (got.float() - want.float()).abs().max().item()
        print(f"{name} {text}: max_abs_err={err:.3e} (tol {tol:.0e})",
              flush=True)
        check(err <= tol, f"{name} {text}: error {err} > {tol}")
        by[name]["max_abs_err"] = max(by[name]["max_abs_err"], err)

    for tag, (H, KV, win) in GEMMA_SHAPES.items():
        # flash: a window that binds needs S > window
        for dtype in (torch.bfloat16, torch.float32):
            check(uses_hopper_kernel(dtype, 256) == (dtype == torch.bfloat16),
                  f"flash {tag} {dtype}: unexpected kernel choice")
            for window in (0, win):
                B, S = (4, 1000) if window < 1000 else (2, window + 88)
                q, k, v = flash_case(torch, B=B, S=S, H=H, KV=KV, hd=256,
                                     dtype=dtype, seed=S + H + window)
                got = flash_attention_cuda(q, k, v, window=window)
                want, lse = flash_attention_plain(q, k, v, window=window,
                                                  return_lse=True)
                text = (f"{tag} B={B} S={S} H={H} KV={KV} hd=256 "
                        f"{str(dtype)[6:]} causal window={window}")
                err_of("flash_attention", got, want, TOL[str(dtype)], text)
                if dtype == torch.bfloat16:
                    again, lse2 = flash_attention_cuda(
                        q, k, v, window=window, return_lse=True)
                    torch.cuda.synchronize()
                    lse_err = (lse2 / LOG2E - lse).abs().max().item()
                    check(torch.equal(again, got) and lse_err <= 1e-3,
                          f"flash {text}: with its log-sum-exp the output "
                          f"differs or the lse is off by {lse_err}")
                del q, k, v, got, want, lse
        # paged and int8 paged over the engine's pages at decode positions
        for dtype in (torch.bfloat16, torch.float32):
            for window in (0, 64):
                q, kp, vp, pt, pos = paged_case(torch, H=H, KV=KV, hd=256,
                                                dtype=dtype, seed=H + window)
                err_of("paged_attention",
                       paged_attention_cuda(q, kp, vp, pt, pos,
                                            window=window),
                       paged_attention_plain(q, kp, vp, pt, pos,
                                             window=window),
                       TOL[str(dtype)], f"{tag} H={H} KV={KV} hd=256 "
                       f"q={str(dtype)[6:]} window={window}")
                args = quant_case(torch, H=H, KV=KV, hd=256, dtype=dtype,
                                  kv="int8", seed=H + window + 1)
                err_of("paged_attention_quant",
                       paged_attention_quant_cuda(*args, window=window),
                       paged_attention_quant_plain(*args, window=window),
                       TOL[str(dtype)], f"{tag} H={H} KV={KV} hd=256 int8 "
                       f"q={str(dtype)[6:]} window={window}")

    # the gather at both vocabularies, tied bf16 embeddings read through
    # their transpose's strides, as the models pass them.  Tied std-1
    # embeddings over post-norm states give logits of std sqrt(d) (64 at
    # d 4096) and log-probs near -450, where two fp32 summation orders over
    # d and the vocabulary differ by more than at the Qwen shapes: the
    # kernel and the plain version are each held to the exact log-probs
    # (float64 products and sums over the same inputs) with the stated
    # tolerance, and their difference is printed
    T = 4 * 4 * 16
    for tag, cfg in (("gemma3", gemma3_1b.CONFIG),
                     ("rgemma", recurrentgemma_9b.CONFIG)):
        V = padded_vocab(cfg)
        for hdt in (torch.bfloat16, torch.float32):
            h, w, labels = logprob_inputs(torch, T=T, d=cfg.d_model, V=V,
                                          hdtype=hdt, tied=True,
                                          seed=cfg.d_model + 1)
            labels.clamp_(max=cfg.vocab_size - 1)
            got = logprob_gather_cuda(h, w, labels, cfg.vocab_size)
            want = logprob_gather_plain(h, w, labels, cfg.vocab_size)
            logits = (h.double().reshape(T, -1)
                      @ w.double())[:, :cfg.vocab_size]
            exact = (logits.gather(1, labels.reshape(T, 1).long())[:, 0]
                     - torch.logsumexp(logits, dim=-1)).reshape(labels.shape)
            del logits
            torch.cuda.synchronize()
            rtol = LOGPROB_TC_RTOL if (tag, hdt) == (
                "rgemma", torch.float32) else LOGPROB_RTOL
            tol = LOGPROB_ATOL + rtol * exact.abs()
            errs = {side: (t.double() - exact).abs()
                    for side, t in (("kernel", got), ("plain", want))}
            err = (got - want).abs().max().item()
            print(f"logprob_gather {tag} T={T} d={cfg.d_model} V={V} vocab="
                  f"{cfg.vocab_size} h={str(hdt)[6:]} w=bfloat16 tied: "
                  f"against the float64 log-probs max_abs_err kernel "
                  f"{errs['kernel'].max().item():.3e}, plain "
                  f"{errs['plain'].max().item():.3e} (tol {LOGPROB_ATOL:.0e}"
                  f" + {rtol:.0e} x |log-prob|); kernel against "
                  f"plain {err:.3e}; log-probs in [{exact.min().item():.2f},"
                  f" {exact.max().item():.2f}]", flush=True)
            check(bool(torch.isfinite(got).all())
                  and all(bool((e <= tol).all()) for e in errs.values()),
                  f"logprob_gather {tag} {hdt}: an error against the "
                  f"float64 log-probs over the tolerance")
            by["logprob_gather"]["max_abs_err"] = max(
                by["logprob_gather"]["max_abs_err"], err)
            if hdt == torch.float32 and tag == "rgemma":
                continue            # the rgemma runs score only bf16 h
            got = time_logprob(torch, f"{tag} T={T} d={cfg.d_model} V="
                               f"{cfg.vocab_size}, h={str(hdt)[6:]}, tied "
                               f"bf16 w", h, w, labels, cfg.vocab_size)
            pre = f"{tag}_" + ("fp32_h_" if hdt == torch.float32 else "")
            by["logprob_gather"].update({pre + k: v for k, v in got.items()})
            del h, w, labels

    # timings: flash at B = 4, S = 1024, causal; the paged kernels at the
    # main path's positions, bf16 q over bf16 pages and over int8 codes,
    # about 400 calls a timed loop (two launches each: more would fill the
    # launch queue behind the device sleep; one kv head's int8 pools take
    # twice as many sets past L2 as bf16 ones)
    for tag, (H, KV, _) in GEMMA_SHAPES.items():
        sets = [flash_case(torch, B=4, S=1024, H=H, KV=KV, hd=256,
                           dtype=torch.bfloat16, seed=400 + i + H)
                for i in range(4)]
        got = time_flash(torch, f"{tag}: B=4 S=1024 H={H} KV={KV} hd=256 "
                         f"bf16 causal", sets, iters=10)
        by["flash_attention"].update(
            {f"{tag}_{k}": v for k, v in got.items()})
        del sets
        sets = paged_sets(torch, lambda i: paged_case(
            torch, H=H, KV=KV, hd=256, dtype=torch.bfloat16,
            seed=500 + i + H), 2 * L2_BYTES)
        got = time_paged(
            torch, f"paged_attention {tag}", paged_attention_cuda,
            paged_attention_plain, sets, sets[:len(sets) // 4],
            [gathered_kv(torch, *st) for st in sets[:8]], bound(sets, 0),
            f"{tag} H={H} KV={KV} hd=256, bf16, "
            f"pos<={max(int(st[4].max()) for st in sets)}",
            iters=max(1, 400 // len(sets)))
        by["paged_attention"].update(
            {f"{tag}_{k}": v for k, v in got.items()})
        del sets
        sets = paged_sets(torch, lambda i: quant_case(
            torch, H=H, KV=KV, hd=256, dtype=torch.bfloat16, kv="int8",
            seed=600 + i + H), 2 * L2_BYTES)
        lib_sets = [gathered_kv(torch, q, deq(torch, kp, ks, q.dtype),
                                deq(torch, vp, vs, q.dtype), pt, pos)
                    for q, kp, vp, ks, vs, pt, pos in sets[:6]]
        got = time_paged(
            torch, f"paged_attention_quant {tag}",
            paged_attention_quant_cuda, paged_attention_quant_plain, sets,
            sets[:len(sets) // 4], lib_sets, bound_quant(sets, 0),
            f"{tag} H={H} KV={KV} hd=256, bf16 q over int8 codes, "
            f"pos<={max(int(st[6].max()) for st in sets)}",
            iters=max(1, 400 // len(sets)))
        by["paged_attention_quant"].update(
            {f"{tag}_{k}": v for k, v in got.items()})
        del sets, lib_sets


def phase_kernels_gemma_bwd(torch, rows):
    """Phase 3 for flash attention's backward at head_dim 256 (the Gemma
    families' training heads): bf16 through ``flash_attention_bwd_hopper.
    cu``'s head_dim-256 kernels (the forward's log-sum-exp, dQ over 32-key
    tiles, dK/dV blocks of 64 keys under the plan at that tile, a block's
    two warpgroups splitting each item), fp32 through
    ``flash_attention_bwd.cu``'s (the output's head dims split over two
    blocks): gemma3's 4 query heads over 1 at B 2, S 1024, causal and with
    its window of 512; recurrentgemma's 16 over 1 at B 1, S 4096 with its
    window of 2048 and at B 2, S 1024 (where 2048 does not bind); a window
    of 8, shorter than every tile, over a ragged S 300; fp32 at S 200 for
    both families.  Each against ``flash_attention_bwd_plain`` at
    ``BWD_TOL``, twice bitwise, its route printed; at each bf16 shape the
    forward's base-2 log-sum-exp over ``LOG2E`` against the plain natural
    one (within 1e-3); the four bf16 training shapes timed
    beside the bound, the plain version and SDPA's backward.  The timings
    go into the backward's row of ``rows`` under each shape's tag."""
    print("== phase 3: flash_attention_bwd at head_dim 256 vs its plain "
          "version", flush=True)
    from repro_torch.kernels.flash_attention import (
        LOG2E, bwd_keys, bwd_split_plan, flash_attention_bwd_cuda,
        flash_attention_bwd_plain, flash_attention_plain,
        uses_hopper_bwd_kernel)
    row = {r["name"]: r for r in rows}["flash_attention_bwd"]
    bf16 = torch.bfloat16
    cases = [("gemma3", 2, 1024, 4, 1, bf16, 0, True),
             ("gemma3-window", 2, 1024, 4, 1, bf16, 512, True),
             ("rgemma-window", 1, 4096, 16, 1, bf16, 2048, True),
             ("rgemma", 2, 1024, 16, 1, bf16, 0, True),
             ("gemma3 window=8", 2, 300, 4, 1, bf16, 8, False),
             ("gemma3 fp32", 2, 200, 4, 1, torch.float32, 0, False),
             ("rgemma fp32 window=8", 1, 200, 16, 1, torch.float32, 8,
              False)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tag, B, S, H, KV, dtype, window, timed in cases:
        hopper = uses_hopper_bwd_kernel(dtype, 256)
        check(hopper == (dtype == bf16),
              f"flash_attention_bwd {tag}: unexpected kernel choice")
        plan = bwd_split_plan(B, S, S, H, KV, window=window, sms=sms,
                              keys=bwd_keys(256))
        route = ("TMA/wgmma (flash_attention_bwd_hopper.cu, head_dim 256: "
                 "dQ over 32-key tiles, dK/dV blocks of 64 keys, P^T and "
                 "dS^T exchanged between a block's warpgroups), plan "
                 f"(chunk, runs) on {sms} SMs {plan}"
                 if hopper else "CUDA cores, 16-query and 32-key tiles "
                 "(flash_attention_bwd.cu), the output's 256 head dims split"
                 " over 2 blocks in the dK/dV and dQ kernels, the query "
                 f"heads over {H // KV} dK/dV blocks")
        args, kw = flash_bwd_case(torch, B=B, S=S, H=H, KV=KV, hd=256,
                                  dtype=dtype, window=window,
                                  seed=900 + S + H + window)
        lse_note = ""
        if hopper:
            _, lse = flash_attention_plain(*args[:3], window=window,
                                           return_lse=True)
            # natural units, as phase 3's forward checks (fp32 sums of
            # exp2 in another order)
            lse_err = (kw["lse"] / LOG2E - lse).abs().max().item()
            check(lse_err <= 1e-3, f"flash_attention {tag}: the forward's "
                  f"log-sum-exp differs from the plain one by {lse_err}")
            lse_note = (f"; the forward's base-2 log-sum-exp / LOG2E within "
                        f"{lse_err:.2e} of the plain one (tol 1e-3)")
            del lse
        got = flash_attention_bwd_cuda(*args, window=window, **kw)
        again = flash_attention_bwd_cuda(*args, window=window, **kw)
        want = flash_attention_bwd_plain(*args, window=window)
        torch.cuda.synchronize()
        tol = BWD_TOL[str(dtype)]
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == dtype and g.shape == w.shape
                  and bool(torch.isfinite(g).all()),
                  f"flash_attention_bwd {tag}: bad {name}")
            err = (g.float() - w.float()).abs().max().item()
            scale = max(w.float().abs().max().item(), 1.0)
            check(err <= tol * scale, f"flash_attention_bwd {tag} {name}: "
                  f"error {err} > {tol} x {scale}")
            errs.append(f"{name} {err:.3e} (scale {scale:.2f})")
            row["max_abs_err"] = max(row["max_abs_err"], err)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"flash_attention_bwd {tag} B={B} S={S} H={H} KV={KV} hd=256 "
              f"{str(dtype)[6:]} causal window={window}: route {route}; "
              f"max_abs_err {', '.join(errs)} (tol {tol:.0e} x scale); two "
              f"calls bitwise equal: {same}{lse_note}", flush=True)
        check(same, f"flash_attention_bwd {tag}: two calls differ")
        del args, kw, got, again, want
        if timed:
            row.update({f"{tag}_{k}": v for k, v in time_flash_bwd(
                torch, tag, S, H, KV, hd=256, B=B, window=window).items()})


# non-causal flash attention at the cross-attention and encoder families'
# shapes: tag -> (B, Sq, Sk, H, KV, hd); the backward is checked and timed
# at all three (runs t5 and t10 train them).  Their limit, elementwise:
# CROSS_RTOL of the value (four bf16 ulps at most: each side rounds its
# own fp32 result to bf16, and the plain forward rounds P first) plus a
# floor for values near zero, CROSS_STD of the forward's standard
# deviation or CROSS_BWD_MAX of the largest gradient (the backward rounds
# P and dS, terms of that size, to bf16 before they cancel).  A run of
# this script (H100 80GB HBM3, 700 W) used 0.490-0.655 of it in the
# forward and 0.178-0.467 in the backward (0.202-0.313 at llama-vision's
# shape), on N(0, 1) inputs and the tail case alike; a dropped tail or
# padding let in uses more than ten times it on the tail case (held on
# the CPU by
# tests/test_torch_cuda.py::test_cross_tail_case_fails_a_faulty_tail)
CROSS_SHAPES = {"llama-cross": (4, 512, 6404, 32, 8, 128),
                "seamless-enc": (4, 1024, 1024, 16, 16, 64),
                "seamless-cross": (4, 512, 1024, 16, 16, 64)}
CROSS_BWD = ("llama-cross", "seamless-enc", "seamless-cross")
CROSS_RTOL, CROSS_STD, CROSS_BWD_MAX = 2 ** -5, 2e-2, 5e-3


def cross_tail_case(torch, *, B, S, Sk, H, KV, hd, seed, tail=4):
    """``flash_case`` in bf16 with every query's softmax decided by the
    last ``tail`` keys: q's first lane 8 and each key's first lane set so
    that the tail scores about 1, every other key about 10, below a key of
    zeros (a tile's zero-filled padding).  Dropping the tail, or letting
    the padding into the softmax, moves the output by about its size."""
    q, k, v = flash_case(torch, B=B, S=S, Sk=Sk, H=H, KV=KV, hd=hd,
                         dtype=torch.bfloat16, seed=seed)
    lane = hd ** 0.5 / 8.0              # score = 8 * lane * k0 / sqrt(hd)
    q[..., 0] = 8.0
    k[:, :Sk - tail, :, 0] = -10.0 * lane
    k[:, Sk - tail:, :, 0] = -1.0 * lane
    return q, k, v


def cross_limit_used(got, want, *, bwd=False):
    """The largest share of the cross checks' limit that ``got`` uses
    (above 1 fails): ``CROSS_RTOL`` of each value plus ``CROSS_STD`` of
    ``want``'s standard deviation, or for gradients (``bwd``)
    ``CROSS_BWD_MAX`` of their largest."""
    g, w = got.float(), want.float()
    floor = CROSS_BWD_MAX * w.abs().max() if bwd else CROSS_STD * w.std()
    return ((g - w).abs() / (CROSS_RTOL * w.abs() + floor)).max().item()


def phase_kernels_cross(torch, rows):
    """Phase 3 at the cross and encoder shapes: flash attention with
    ``causal=False`` (bf16 through the TMA/wgmma kernel; llama-vision's
    cross layers at Sk = 6404, 100 full 64-key tiles and a tail of 4,
    seamless's encoder at Sq = Sk = 1024 and its cross layers at 512 over
    1024) against its plain version within the cross checks' limit, on
    N(0, 1) inputs and on the tail case (whose softmax the last 4 keys
    decide), its log-sum-exp asked for giving the same bits, then timed
    beside the operation bound, the plain version and SDPA
    (``is_causal=False``, ``enable_gqa``); the backward at the seamless
    shapes against its plain version on both inputs, twice bitwise, then
    timed beside SDPA's backward.  Timings go into the flash rows of
    ``rows`` under the shape's tag; ``max_abs_err`` takes the largest
    error."""
    print("== phase 3: non-causal flash attention at the cross-attention "
          "and encoder shapes vs the plain versions", flush=True)
    from repro_torch.kernels.flash_attention import (
        LOG2E, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain, uses_hopper_bwd_kernel,
        uses_hopper_kernel)
    by = {r["name"]: r for r in rows}
    bf16 = torch.bfloat16
    for tag, (B, Sq, Sk, H, KV, hd) in CROSS_SHAPES.items():
        check(uses_hopper_kernel(bf16, hd), f"flash {tag}: unexpected "
              f"kernel choice")
        for inputs in ("N(0, 1)", "tail case"):
            text = (f"{tag} B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                    f"bf16 causal=False, {inputs}")
            if inputs == "tail case":
                q, k, v = cross_tail_case(torch, B=B, S=Sq, Sk=Sk, H=H,
                                          KV=KV, hd=hd, seed=Sq + Sk + H)
            else:
                q, k, v = flash_case(torch, B=B, S=Sq, Sk=Sk, H=H, KV=KV,
                                     hd=hd, dtype=bf16, seed=Sq + Sk + H)
            got = flash_attention_cuda(q, k, v, causal=False)
            again, lse = flash_attention_cuda(q, k, v, causal=False,
                                              return_lse=True)
            want, want_lse = flash_attention_plain(q, k, v, causal=False,
                                                   return_lse=True)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"flash {text}: "
                  f"non-finite kernel output")
            err = (got.float() - want.float()).abs().max().item()
            used = cross_limit_used(got, want)
            lse_err = (lse / LOG2E - want_lse).abs().max().item()
            same = torch.equal(got, again)
            print(f"flash_attention {text}: max_abs_err={err:.3e}, "
                  f"{used:.3f} of the limit ({CROSS_RTOL:.4f} x |value| + "
                  f"{CROSS_STD:.0e} x std {want.float().std().item():.3e})"
                  f"; with its log-sum-exp the output is bitwise the same: "
                  f"{same}, lse max_abs_err={lse_err:.3e} (tol 1e-3)",
                  flush=True)
            check(used <= 1, f"flash {text}: error {err} past the limit "
                  f"({used:.3f} of it)")
            check(same and lse_err <= 1e-3, f"flash {text}: with its "
                  f"log-sum-exp the output differs or the lse is off by "
                  f"{lse_err}")
            by["flash_attention"]["max_abs_err"] = max(
                by["flash_attention"]["max_abs_err"], err)
            del got, again, lse, want, want_lse
            if tag not in CROSS_BWD:
                del q, k, v
                continue
            check(uses_hopper_bwd_kernel(bf16, hd), f"flash_attention_bwd "
                  f"{text}: unexpected kernel choice")
            out, lse = flash_attention_cuda(q, k, v, causal=False,
                                            return_lse=True)
            gen = torch.Generator(device="cuda").manual_seed(Sq + Sk + hd)
            dout = torch.randn(q.shape, generator=gen,
                               device="cuda").to(bf16)
            args = (q, k, v, out, dout)
            got = flash_attention_bwd_cuda(*args, causal=False, lse=lse)
            again = flash_attention_bwd_cuda(*args, causal=False, lse=lse)
            want = flash_attention_bwd_plain(*args, causal=False)
            torch.cuda.synchronize()
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                check(g.dtype == bf16 and g.shape == w.shape
                      and bool(torch.isfinite(g).all()),
                      f"flash_attention_bwd {text}: bad {name}")
                err = (g.float() - w.float()).abs().max().item()
                used = cross_limit_used(g, w, bwd=True)
                check(used <= 1, f"flash_attention_bwd {text} {name}: "
                      f"error {err} past the limit ({used:.3f} of it)")
                errs.append(f"{name} {err:.3e}, {used:.3f} of the limit "
                            f"(largest {w.float().abs().max().item():.3e})")
                by["flash_attention_bwd"]["max_abs_err"] = max(
                    by["flash_attention_bwd"]["max_abs_err"], err)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"flash_attention_bwd {text}: max_abs_err "
                  f"{'; '.join(errs)} (limit {CROSS_RTOL:.4f} x |value| + "
                  f"{CROSS_BWD_MAX:.0e} x largest); two calls bitwise "
                  f"equal: {same}", flush=True)
            check(same, f"flash_attention_bwd {text}: two calls differ")
            del q, k, v, out, lse, dout, args, got, again, want
        sets = [flash_case(torch, B=B, S=Sq, Sk=Sk, H=H, KV=KV, hd=hd,
                           dtype=bf16, seed=700 + i + H) for i in range(2)]
        timed = time_flash(torch, f"{tag} B={B} Sq={Sq} Sk={Sk} H={H} "
                           f"KV={KV} hd={hd} bf16 causal=False", sets,
                           iters=10, causal=False)
        by["flash_attention"].update(
            {f"{tag}_{key}": val for key, val in timed.items()})
        del sets
        if tag in CROSS_BWD:
            timed = time_flash_bwd(torch, tag, Sq, H, KV, hd=hd,
                                   causal=False, Sk=Sk)
            by["flash_attention_bwd"].update(
                {f"{tag}_{key}": val for key, val in timed.items()})


def instrument(torch, model, tag, acc):
    """Count ``model``'s paged decode steps and time each one (host clock
    around the call, and CUDA events on the stream)."""
    orig = model.decode_step
    acc[tag] = {"calls": 0, "paged_calls": 0, "host_s": 0.0, "events": [],
                "layers": len(model.layers),
                "attn_layers": kernel_layers(model, "paged_attention")}

    def timed(cache, tokens, positions, **kw):
        rec = acc[tag]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = orig(cache, tokens, positions, **kw)
        b.record()
        rec["host_s"] += time.perf_counter() - t0
        rec["events"].append((a, b))
        rec["calls"] += 1
        rec["paged_calls"] += kw.get("pt") is not None
        return out

    model.decode_step = timed


def kernel_layers(model, kernel):
    """Launches of ``kernel`` in one full-sequence call (flash attention,
    the WKV6 scan) or one paged ``decode_step`` (the paged kernels) of
    ``model``: one per attention layer for the paged kernels (a cross
    layer's self half included) and for flash, which a cross layer's cross
    step launches once more and a config's encoder once per layer of its
    own (it runs in every full-sequence call of a cross stack); one per
    RWKV layer for the scan; an RG-LRU layer runs neither."""
    if kernel == "rwkv6_scan":
        return sum(k == "rwkv" for k in model.kinds)
    n = sum(k in ("full", "local", "cross") for k in model.kinds)
    if kernel == "flash_attention":
        cross = model.kinds.count("cross")
        n += cross + (model.cfg.encoder_layers if cross else 0)
    return n


def counters(torch):
    """The launch-counting wrapper of every kernel, by kernel name."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.logprob_gather import logprob_gather_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_quant_cuda)
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_bwd_cuda,
                                                rwkv6_scan_cuda)
    return {"paged_attention": paged_attention_cuda,
            "paged_attention_quant": paged_attention_quant_cuda,
            "logprob_gather": logprob_gather_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "rwkv6_scan": rwkv6_scan_cuda,
            "rwkv6_scan_bwd": rwkv6_scan_bwd_cuda}


def only(launches, **want):
    """True iff the kernels in ``want`` launched exactly as many times as
    it says and every other kernel not at all."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def serve_run(torch, name, cfgs, params, g, count, seed, acc, sync=True,
              cross_kv=None, **kw):
    """Serve ``count`` requests through a fresh engine (paged unless ``kw``
    says otherwise), lock-step or pipelined (``sync``), with every launch
    counter zeroed just before and read just after, and seeded cross KV
    written at each admission where ``cross_kv`` gives a seed
    (:func:`seed_cross_kv`); returns the result."""
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine, gsi_engine
    from repro_torch.models import scoring
    engine = GSIServingEngine(*cfgs, *params, g, mode="gsi", max_seq=512,
                              device="cuda",
                              **{"paged": True, "page_size": 16, **kw})
    if cross_kv is not None:
        seed_cross_kv(torch, engine, cross_kv)
    rec = acc.setdefault(name, {})
    for tag, model in (("draft", engine.draft), ("target", engine.target),
                       ("prm", engine.prm)):
        instrument(torch, model, tag, rec)
    phases = {"draft": 0}
    draft_phase = engine._draft_phase

    def counted(*a, **k):
        phases["draft"] += 1
        return draft_phase(*a, **k)

    engine._draft_phase = counted
    scores = {"calls": 0, "layers": 0}
    score_candidates = gsi_engine.score_candidates

    def scored(model, *a, **k):
        scores["calls"] += 1
        scores["layers"] += len(model.layers)
        return score_candidates(model, *a, **k)

    gsi_engine.score_candidates = scored
    seen = []                       # (h dtype, w dtype, h shape) per call
    gather = scoring.ops.logprob_gather

    def observed(h, w, labels, vocab_size):
        seen.append((str(h.dtype)[6:], str(w.dtype)[6:], tuple(h.shape)))
        return gather(h, w, labels, vocab_size)

    scoring.ops.logprob_gather = observed
    prompts = serve.random_prompts(count, seed=seed,
                                   vocab=cfgs[0].vocab_size, lo=24, hi=72)
    wrappers = counters(torch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    try:
        res = serve.serve(engine, prompts, capacity=4, seed=seed, sync=sync)
    finally:
        scoring.ops.logprob_gather = gather
        gsi_engine.score_candidates = score_candidates
    launches = {k: fn.launches for k, fn in wrappers.items()}
    torch.cuda.synchronize()
    res.update(name=name, launches=launches, draft_phases=phases["draft"],
               score_calls=scores["calls"], score_layers=scores["layers"],
               prompts=prompts,
               gather_inputs=sorted(set(seen)), count=count,
               mem=engine.cache_memory_report(4),
               prefix_cache=engine.prefix_cache)
    del engine
    return res


def report_run(name, res, rec, vocab):
    """Print one run's numbers and check its requests and rewards."""
    import numpy as np
    mem = res["mem"]
    print(f"run {name}: requests finished {res['finished']}/{res['count']}, "
          f"engine steps {res['steps']}, draft phases {res['draft_phases']},"
          f" generated tokens {res['tokens']}, wall {res['wall_s']:.2f} s, "
          f"tokens/s {res['tokens_per_s']:.2f}, accept rate "
          f"{res['accept_rate']:.3f}, draft tokens {res['draft_tokens']}, "
          f"target tokens {res['target_tokens']}, prefix {res['prefix']}",
          flush=True)
    total = mem["num_pages"] + mem["scratch_pages"] + 1
    if mem["bytes_per_page"]:          # an engine with paged layers
        print(f"run {name}: page pool [{mem['kv_dtype']}] {total} pages x "
              f"{mem['bytes_per_page'] + mem['scale_bytes_per_page']} B = "
              f"{mem['paged_pool_bytes'] / 2 ** 30:.3f} GiB; capacity "
              f"{mem['capacity_pages']} pages, {mem['capacity_tokens']} "
              f"tokens, {mem['capacity_bytes']} B (payload "
              f"{mem['bytes_per_page']} B + "
              f"scales {mem['scale_bytes_per_page']} B per page; "
              f"{mem['fp_bytes_per_page']} B at the activation dtype)",
              flush=True)
    for tag, r in rec.items():
        stream_s = sum(a.elapsed_time(b) for a, b in r["events"]) / 1e3
        print(f"run {name}: {tag} decode_step calls {r['calls']} (paged "
              f"{r['paged_calls']}), host {r['host_s']:.2f} s, stream "
              f"{stream_s:.2f} s", flush=True)
    print(f"run {name}: kernel launches {res['launches']}", flush=True)
    check(res["finished"] == res["count"],
          f"{name}: {res['finished']} of {res['count']} requests finished")
    for rid in res["ids"]:
        r = res["responses"][rid]
        check(r.finish_reason in ("eos", "low_reward", "max_steps"),
              f"{rid}: no finish reason")
        toks = r.tokens
        check(toks.size > 0 and toks.min() >= 0 and toks.max() < vocab,
              f"{rid}: tokens out of range")
    rw = np.concatenate([np.ravel(a) for a in res["stats"].raw_rewards])
    check(np.isfinite(rw).all() and rw.min() >= 0 and rw.max() <= 1,
          f"{name}: PRM rewards not finite in [0,1]")


def fmt_stats(stats):
    """``pipeline_stats()`` on one line: every key, floats to 4 places."""
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in stats.items())


def check_pipelined(sync, pipe, names=("gsi", "gsi-async")):
    """Run gsi-async against run gsi (or the runs ``names`` says): the
    same tokens, finish reasons, engine steps, decisions and prefix
    counters, bit for bit, and the same paged-attention launches; the
    pipeline overlapped host work."""
    base, piped = names
    def outcome(res):
        st = res["stats"]
        return ({r: (res["responses"][r].tokens.tolist(),
                     res["responses"][r].finish_reason,
                     res["responses"][r].engine_steps) for r in res["ids"]},
                res["steps"], st.accepted, st.decisions, st.draft_tokens,
                st.target_tokens, res["prefix"])

    stats = pipe["pipeline"]
    print(f"run {piped} against run {base} (one process): tokens/s "
          f"{pipe['tokens_per_s']:.2f} vs {sync['tokens_per_s']:.2f}, wall "
          f"{pipe['wall_s']:.2f} s vs {sync['wall_s']:.2f} s, engine steps "
          f"{pipe['steps']} vs {sync['steps']}; pipeline_stats "
          + fmt_stats(stats), flush=True)
    check(outcome(pipe) == outcome(sync),
          f"{piped}: tokens, finish reasons, engine steps, decisions or "
          f"prefix counters differ from run {base}'s")
    check(pipe["launches"]["paged_attention"]
          == sync["launches"]["paged_attention"],
          f"{piped}: {pipe['launches']['paged_attention']} paged launches"
          f", run {base} {sync['launches']['paged_attention']}")
    check(stats["sync"] is False and stats["overlap_host_s"] > 0,
          f"{piped}: no host work overlapped a step ({stats})")
    print(f"run {piped}: tokens, finish reasons, engine steps, accepted "
          f"and decision counts, prefix stats and paged launches identical "
          f"to run {base}", flush=True)


def phase_main(torch, layers):
    print("== phase 4: main paths at full Qwen2.5-Math width", flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import param_specs, random_params

    full = serve.build_triple("qwen2.5-math")
    cfgs = serve.build_triple("qwen2.5-math", layers=layers)
    if layers and layers < full[0].num_layers:
        print(f"reduced: runs gsi, gsi-async and gsi-forced-fallback cut "
              f"to {layers} "
              f"layers in all three models (published "
              f"{full[0].num_layers}); widths unchanged; run gsi-int8-shared"
              f" at full depth", flush=True)
    for c in full:
        print(f"model {c.name}: layers={c.num_layers} d={c.d_model} "
              f"heads={c.num_heads}/{c.num_kv_heads} hd={c.head_dim} "
              f"ffn={c.d_ff} vocab={c.vocab_size} "
              f"tied={c.tie_embeddings} params~{c.param_count() / 1e9:.2f}B",
              flush=True)
    t0 = time.perf_counter()
    params = [random_params(c, i, "cuda") for i, c in enumerate(full)]
    cut = [{k: p[k] for k in param_specs(c)} for p, c in zip(params, cfgs)]
    torch.cuda.synchronize()
    print(f"random bf16 weights on the card: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    gcfg = GSIConfig(n=4, beta=20.0, threshold_u=0.5, temperature=0.7,
                     max_step_tokens=16, max_steps=4, min_step_reward=0.0)
    # run gsi's threshold: its first engine step admits the first 4 of its
    # 6 prompts (4 slots), so one step of those 4 with the same seed draws
    # the same candidates
    g_gsi = dataclasses.replace(gcfg, threshold_u=step_threshold(
        torch, "gsi", cfgs, cut, gcfg, serve.random_prompts(
            6, seed=0, vocab=cfgs[0].vocab_size, lo=24, hi=72)[:4], 0))
    # (name, triple, gsi config, requests, seed, options); the bf16-page
    # runs may be cut in depth, the int8 run never is
    runs = [("gsi", cfgs, cut, g_gsi, 6, 0, {}),
            # run gsi again through the pipelined scheduler
            ("gsi-async", cfgs, cut, g_gsi, 6, 0, {"sync": False}),
            # no tilted reward reaches 1e9: every row rejects, the
            # target fallback must run
            ("gsi-forced-fallback", cfgs, cut,
             dataclasses.replace(gcfg, threshold_u=1e9, max_steps=2), 2, 1,
             {}),
            ("gsi-int8-shared", full, params,
             dataclasses.replace(gcfg, threshold_u=QWEN_INT8_THRESHOLD), 5,
             2, {"kv_dtype": "int8", "shared_scoring": True,
                 "quantize_draft": True})]
    acc, results = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, c3, p3, g, count, seed, kw in runs:
        res = serve_run(torch, name, c3, p3, g, count, seed, acc, **kw)
        results[name] = res
        report_run(name, res, acc[name], full[0].vocab_size)
        elapsed(f"run {name}")

    def paged_layer_calls(name):
        return sum(r["layers"] * r["paged_calls"] for r in acc[name].values())

    for name in ("gsi", "gsi-async", "gsi-forced-fallback"):
        got, want = results[name]["launches"], paged_layer_calls(name)
        check(want > 0 and only(got, paged_attention=want),
              f"{name}: launches {got}; want paged_attention = layers x "
              f"paged decode_step calls = {want} and no other kernel")
    q = results["gsi-int8-shared"]
    got, want = q["launches"], paged_layer_calls("gsi-int8-shared")
    print(f"run gsi-int8-shared: paged_attention_quant launches "
          f"{got['paged_attention_quant']}, layers x paged decode_step calls "
          f"{want}; logprob_gather launches {got['logprob_gather']}, 2 x "
          f"draft phases {2 * q['draft_phases']}; vocab-gather inputs (h, w,"
          f" h shape) {q['gather_inputs']}", flush=True)
    check(want > 0 and q["draft_phases"] > 0
          and only(got, paged_attention_quant=want,
                   logprob_gather=2 * q["draft_phases"]),
          f"gsi-int8-shared: launches {got}; want paged_attention_quant = "
          f"layers x paged decode_step calls = {want}, logprob_gather = 2 x"
          f" draft phases = {2 * q['draft_phases']}, no other kernel")
    for name, threshold, pages in (
            ("gsi", g_gsi.threshold_u, "bf16"),
            ("gsi-int8-shared", QWEN_INT8_THRESHOLD, "int8")):
        stats = results[name]["stats"]
        tilted = torch.cat([torch.as_tensor(t).flatten()
                            for t in stats.tilted_rewards])
        print(f"run {name}: threshold {threshold}; decisions "
              f"{stats.decisions}: accepted {stats.accepted} (a draft "
              f"candidate committed over {pages} pages), rejected "
              f"{stats.decisions - stats.accepted} (target fallback); "
              f"selected tilted rewards in [{tilted.min().item():.4f}, "
              f"{tilted.max().item():.4f}], median "
              f"{tilted.median().item():.4f}", flush=True)
        check(0 < stats.accepted < stats.decisions,
              f"{name}: {stats.accepted} of {stats.decisions} decisions "
              f"accepted; the run must take both the accept and the "
              f"fallback branch")
    check_pipelined(results["gsi"], results["gsi-async"])
    fallback = results["gsi-forced-fallback"]
    check(fallback["target_tokens"] > 0 and fallback["accept_rate"] == 0.0,
          "forced-fallback run: the target fallback did not run")
    print(f"target fallback ran: {fallback['target_tokens']} target tokens, "
          f"accept rate {fallback['accept_rate']}", flush=True)
    fp, i8 = results["gsi"]["mem"], q["mem"]
    keys = ("capacity_pages", "capacity_tokens", "capacity_bytes",
            "bytes_per_page", "scale_bytes_per_page", "fp_bytes_per_page")
    print("capacity, bf16 pages (run gsi) vs int8 pages (run "
          "gsi-int8-shared): " + ", ".join(
              f"{k} {fp[k]} vs {i8[k]}" for k in keys)
          + f"; bytes per page ratio "
          f"{(fp['bytes_per_page'] + fp['scale_bytes_per_page']) / (i8['bytes_per_page'] + i8['scale_bytes_per_page']):.4f}",
          flush=True)
    scored = phase_score(torch, "score-prm", full, params, results["gsi"],
                         "flash_attention",
                         tols=(LP_TOL, REWARD_TOL, LOGIT_TOL))
    print(f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    launches = {
        "paged_attention": sum(results[n]["launches"]["paged_attention"]
                               for n in ("gsi", "gsi-async",
                                         "gsi-forced-fallback")),
        "paged_attention_quant": got["paged_attention_quant"],
        "logprob_gather": got["logprob_gather"]
        + scored["logprob_gather"],
        "flash_attention": scored["flash_attention"]}
    print(f"logprob_gather launches over its runs: gsi-int8-shared "
          f"{got['logprob_gather']} + score-prm {scored['logprob_gather']}",
          flush=True)
    elapsed("run score-prm")
    launches["paged_attention"] += phase_slo(torch, params)
    fleet = phase_fleet(torch, params)
    for key, n in fleet.items():
        launches[key] += n
    print(f"launches over the runs of phase 4 so far, the fleet's "
          f"included: {launches}", flush=True)
    elapsed("the fleet runs")
    # the profiler's processing costs about as much as the step itself,
    # per launch: the three Qwen engine-step profiles run at
    # PROFILE_LAYERS layers so that the script keeps well inside its time
    depth = min(PROFILE_LAYERS, min(c.num_layers for c in cfgs))
    prof_cfgs = serve.build_triple("qwen2.5-math", layers=depth)
    prof_params = [{k: p[k] for k in param_specs(c)}
                   for p, c in zip(params, prof_cfgs)]
    print(f"reduced: phase 5's engine-step profiles of runs gsi, "
          f"gsi-int8-shared and gsi-async cut to {depth} layers in all "
          f"three models (published {full[0].num_layers}); widths "
          f"unchanged; the score-prm batch profiled at full depth",
          flush=True)
    phase_profile(torch, [("gsi", prof_cfgs, prof_params, {}),
                          ("gsi-int8-shared", prof_cfgs, prof_params,
                           runs[3][6])], gcfg)
    phase_profile_pipelined(torch, prof_cfgs, prof_params, gcfg)
    phase_profile_scoring(torch, full, params, results["gsi"])
    del params, cut
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# Phase 4: SLO serving (chunked prefill, priority preemption, deadlines,
# token streams) and the warm prefix cache
# ----------------------------------------------------------------------

def slo_requests(vocab):
    """The five requests of the SLO runs: ``id -> (prompt, priority,
    deadline_s, step budget)``; r3 is r0's first 32 tokens (two pages) and
    24 of its own, so its admission gets a prefix hit."""
    import numpy as np
    from repro_torch.launch import serve
    p = serve.random_prompts(5, seed=SLO_PROMPT_SEED, vocab=vocab, lo=64,
                             hi=64)
    return {"r0": (p[0], 0, None, SLO_R0_STEPS),
            "r1": (p[1][:48], 0, None, None),
            "r2": (p[2][:40], 1, SLO_MISS_S, None),
            "r3": (np.concatenate([p[0][:32], p[3][:24]]), 0, None, None),
            "r4": (p[4][:40], 1, SLO_MEET_S, None)}


def slo_engine(torch, cfgs, params, g, rec, capacity=2):
    """A paged bf16 engine (pages of 16 rows, prefix cache on, max_seq
    512) whose three models' decode steps are counted into ``rec``."""
    from repro_torch.serving import GSIServingEngine
    engine = GSIServingEngine(*cfgs, *params, g, mode="gsi", max_seq=512,
                              device="cuda", paged=True, page_size=16)
    for tag, model in (("draft", engine.draft), ("target", engine.target),
                       ("prm", engine.prm)):
        instrument(torch, model, tag, rec)
    return engine


def live_tilted(engine, into):
    """Record, at every materialized step, each live row's tilted rewards
    (at temperature 0 the n candidates are one, so any is the selected)."""
    materialize = engine.materialize

    def recorded(ticket):
        res = materialize(ticket)
        into.extend(res.tilted[~res.done_prev, 0].tolist())
        return res

    engine.materialize = recorded


def gap_threshold(label, first, count):
    """The midpoint of the widest gap between the sorted first-step
    selected tilted rewards ``first`` (one per request, ``count`` of
    them), printed under ``label``: any run that repeats those first steps
    accepts one and rejects another there."""
    vals = sorted(first)
    check(len(vals) == count, f"{label} calibration: {len(vals)} first "
          f"decisions for {count} requests")
    gap, lo = max((b - a, a) for a, b in zip(vals, vals[1:]))
    threshold = lo + gap / 2
    print(f"{label}: first-step selected tilted rewards "
          f"{[round(v, 4) for v in vals]}; threshold {threshold:.4f} (the "
          f"midpoint of their widest gap, {gap:.4f})", flush=True)
    return threshold


def slo_threshold(torch, cfgs, params, g, reqs):
    """A threshold among the runs' own selected tilted rewards: one engine
    step of the five prompts (one slot each) gives every request's first
    decision, which no threshold changes (temperature 0, the prompt alone
    as context); the midpoint of the widest gap between two of them makes
    every run accept at least one first step and reject at least one."""
    from repro_torch.serving import GSIScheduler
    engine = slo_engine(torch, cfgs, params, g, {}, capacity=5)
    first = []
    live_tilted(engine, first)
    sched = GSIScheduler(engine, capacity=5)
    for rid, (prompt, _, _, _) in reqs.items():
        sched.submit(prompt, request_id=rid, max_steps=1)
    sched.run(torch.Generator(device="cuda").manual_seed(0))
    del sched, engine
    return gap_threshold("SLO runs", first, len(reqs))


def slo_run(torch, name, cfgs, params, g, reqs, acc, *, sync, chunk,
            staged):
    """Serve the five requests through ``GSIScheduler.step`` with every
    launch counter zeroed just before and read just after.  ``staged``:
    r0, r1 and r3 at the start, r2 and r4 (priority 1) once neither slot
    is free or mid-prefill; otherwise all five at the start, priority 0.
    Every request carries its deadline and a ``TokenStream``."""
    from repro_torch.serving import GSIScheduler, TokenStream
    rec = acc.setdefault(name, {})
    engine = slo_engine(torch, cfgs, params, g, rec)
    tilted = []
    live_tilted(engine, tilted)
    sched = GSIScheduler(engine, capacity=2, sync=sync, chunk_tokens=chunk,
                         collect_stats=True)
    streams = {}

    def submit(rid, at=0.0):
        prompt, prio, deadline, steps = reqs[rid]
        streams[rid] = TokenStream()
        sched.submit(prompt, request_id=rid, max_steps=steps,
                     arrival_time=at, priority=prio if staged else 0,
                     deadline_s=deadline, stream=streams[rid])

    gen = torch.Generator(device="cuda").manual_seed(0)
    wrappers = counters(torch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    late = ["r2", "r4"] if staged else []
    for rid in ("r0", "r1", "r3") if staged else ("r0", "r1", "r3", "r2",
                                                  "r4"):
        submit(rid)
    calls = late_at = 0
    while sched.queue or sched.pool.num_live or sched.has_pending:
        sched.step(gen)
        calls += 1
        check(calls < 200, f"{name}: not drained after {calls} steps")
        if late and sched.pool.num_live == 2 and not sched._prefill:
            now = sched._now()
            for rid in late:
                submit(rid, now)
            late, late_at = [], calls
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    check(not late, f"{name}: no step found both slots decoding")
    out = sched.responses
    tokens = sum(r.num_tokens for r in out.values())
    return {"name": name, "engine": engine, "sched": sched, "out": out,
            "streams": {rid: list(s) for rid, s in streams.items()},
            "launches": launches, "wall_s": wall, "tokens": tokens,
            "tokens_per_s": tokens / wall, "steps": sched.engine_steps,
            "late_at": late_at, "tilted": tilted, "stats": sched.stats,
            "prefix": sched.prefix_stats()}


def slo_report(torch, res, rec, vocab, reqs):
    """Print one SLO run's numbers and hold it to the checks every run
    shares: tokens, finish reasons, streams, deadline accounting, prefix
    hits, page conservation and launches."""
    import numpy as np
    name, out, st = res["name"], res["out"], res["stats"]
    pool = res["engine"].pager
    print(f"run {name}: requests finished {len(out)}/{len(reqs)}, engine "
          f"steps {res['steps']}, generated tokens {res['tokens']}, wall "
          f"{res['wall_s']:.2f} s, tokens/s {res['tokens_per_s']:.2f} "
          f"({CARD})" + (f"; r2 and r4 submitted after step "
                         f"{res['late_at']}" if res["late_at"] else ""),
          flush=True)
    print(f"run {name}: counters preemptions {st.preemptions}, resumes "
          f"{st.resumes}, deadline_misses {st.deadline_misses}, "
          f"prefill_commit_max {st.prefill_commit_max}, decisions "
          f"{st.decisions}, accepted {st.accepted}, prefix {res['prefix']}",
          flush=True)
    t = np.asarray(res["tilted"])
    print(f"run {name}: selected tilted rewards of {t.size} decisions in "
          f"[{t.min():.4f}, {t.max():.4f}], median {np.median(t):.4f}",
          flush=True)
    for prio in sorted({r.priority for r in out.values()}):
        cls = [r for r in out.values() if r.priority == prio]
        ttft = np.asarray([r.ttft for r in cls])
        tpot = np.asarray([r.tpot for r in cls])
        print(f"run {name}: priority {prio} ({len(cls)} requests): TTFT "
              f"median {np.median(ttft):.4f} s, max {ttft.max():.4f} s; "
              f"TPOT median {np.median(tpot) * 1e3:.2f} ms, max "
              f"{tpot.max() * 1e3:.2f} ms ({CARD})", flush=True)
    for tag, r in rec.items():
        stream_s = sum(a.elapsed_time(b) for a, b in r["events"]) / 1e3
        print(f"run {name}: {tag} decode_step calls {r['calls']} (paged "
              f"{r['paged_calls']}), host {r['host_s']:.2f} s, stream "
              f"{stream_s:.2f} s", flush=True)
    print(f"run {name}: kernel launches {res['launches']}", flush=True)
    check(set(out) == set(reqs), f"{name}: finished {sorted(out)}")
    for rid, r in out.items():
        toks = r.tokens
        check(r.finish_reason in ("eos", "low_reward", "max_steps")
              and toks.size > 0 and toks.min() >= 0 and toks.max() < vocab,
              f"{name} {rid}: reason {r.finish_reason!r}, tokens {toks}")
        events = res["streams"][rid]
        steps = [e.step for e in events[:-1]]
        got = np.concatenate([np.asarray(e.tokens, np.int32)
                              for e in events])
        check(events and events[-1].final
              and events[-1].finish_reason == r.finish_reason
              and not any(e.final for e in events[:-1])
              and all(a < b for a, b in zip(steps, steps[1:]))
              and got.tolist() == toks.tolist(),
              f"{name} {rid}: its stream does not reassemble its response")
    missed = sum(r.deadline_missed for r in out.values())
    check(st.deadline_misses >= 1 and st.deadline_misses == missed,
          f"{name}: deadline_misses {st.deadline_misses}, responses past "
          f"their deadline {missed}")
    check(st.prefix_hits >= 1, f"{name}: no prefix hit")
    check(0 < st.accepted < st.decisions,
          f"{name}: {st.accepted} of {st.decisions} decisions accepted; the"
          f" run must take both the accept and the fallback branch")
    check(pool.num_free + pool.num_referenced + pool.num_cached
          == pool.num_pages,
          f"{name}: pages free {pool.num_free} + referenced "
          f"{pool.num_referenced} + cached {pool.num_cached} != "
          f"{pool.num_pages}")
    want = sum(r["layers"] * r["paged_calls"] for r in rec.values())
    check(want > 0 and only(res["launches"], paged_attention=want),
          f"{name}: launches {res['launches']}; want paged_attention = "
          f"layers x paged decode_step calls = {want} and no other kernel")
    print(f"run {name}: streams reassemble every response; deadline misses "
          f"{missed}; pages conserved ({pool.num_free} free + "
          f"{pool.num_referenced} referenced + {pool.num_cached} cached = "
          f"{pool.num_pages}); paged_attention launches {want} = layers x "
          f"paged decode_step calls, no other kernel", flush=True)


def canon_snapshot(snap):
    """A snapshot as {token path: {leaf: row}}, independent of page ids."""
    import numpy as np
    paths = []
    for i in range(len(snap["pages"])):
        path, j = [], i
        while j != -1:
            path.append(tuple(int(t) for t in snap["chunks"][j]))
            j = int(snap["parents"][j])
        paths.append(tuple(reversed(path)))
    return {path: {k: np.asarray(a)[i] for k, a in snap["leaves"].items()}
            for i, path in enumerate(paths)}


def slo_warm_cache(torch, cfgs, params, g, reqs, one, acc):
    """Save run gsi-slo-oneshot's radix cache to an ``.npz``, load it into
    a fresh engine on the same weights (rows bitwise equal, pages
    conserved), and serve r0 alone for one step: a prefix hit and
    gsi-slo-oneshot's first step."""
    import tempfile
    import numpy as np
    from repro_torch.serving import GSIScheduler
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cache.npz"
        t0 = time.perf_counter()
        snap = one["engine"].save_cache(one["sched"].state, path)
        saved_s = time.perf_counter() - t0
        size = path.stat().st_size
        rec = acc.setdefault("warm-cache", {})
        engine = slo_engine(torch, cfgs, params, g, rec)
        sched = GSIScheduler(engine, capacity=2)
        t0 = time.perf_counter()
        sched.state = engine.load_cache(sched.state, str(path))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    pool = engine.pager
    check(snap["pages"].size > 0 and pool.num_cached == snap["pages"].size,
          f"warm cache: {snap['pages'].size} pages saved, "
          f"{pool.num_cached} cached after the load")
    check(pool.num_free + pool.num_referenced + pool.num_cached
          == pool.num_pages, "warm cache: pages not conserved by the load")
    a, b = canon_snapshot(snap), canon_snapshot(engine.save_cache(
        sched.state))
    check(a.keys() == b.keys() and all(
        a[p].keys() == b[p].keys() and all(
            a[p][k].dtype == b[p][k].dtype and np.array_equal(a[p][k],
                                                              b[p][k])
            for k in a[p]) for p in a),
          "warm cache: restored page rows differ from the saved ones")
    print(f"warm cache: saved {snap['pages'].size} pages "
          f"({len(snap['leaves'])} pools, {size} B .npz) in {saved_s:.2f} s,"
          f" loaded in {load_s:.2f} s ({CARD}); restored rows bitwise "
          f"equal, pages conserved ({pool.num_free} free + "
          f"{pool.num_cached} cached = {pool.num_pages})", flush=True)
    wrappers = counters(torch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    sched.submit(reqs["r0"][0], request_id="r0", max_steps=1)
    sched.run(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    got = sched.responses["r0"].steps[0].tolist()
    want = one["out"]["r0"].steps[0].tolist()
    hit = sched.prefix_stats()["hit_tokens"]
    print(f"warm cache: r0 alone, one step: prefix hit tokens {hit}, first "
          f"step {'the same as' if got == want else 'NOT'} run "
          f"gsi-slo-oneshot's; kernel launches {launches}", flush=True)
    check(hit > 0, "warm cache: r0 got no prefix hit from the restore")
    check(got == want, f"warm cache: r0's first step {got} != run "
          f"gsi-slo-oneshot's {want}")
    paged = sum(r["layers"] * r["paged_calls"] for r in rec.values())
    check(only(launches, paged_attention=paged),
          f"warm cache: launches {launches}; want paged_attention = {paged}")
    del sched, engine
    return launches["paged_attention"]


def phase_slo(torch, params):
    """Phase 4's SLO runs at full Qwen2.5-Math width (``SLO_LAYERS`` deep)
    and the warm-cache check; returns their paged_attention launches."""
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import param_specs
    full = serve.build_triple("qwen2.5-math")
    cfgs = serve.build_triple("qwen2.5-math", layers=SLO_LAYERS)
    print(f"== phase 4: SLO runs at full Qwen2.5-Math width "
          f"({cfgs[0].num_layers} layers)", flush=True)
    if cfgs[0].num_layers < full[0].num_layers:
        print(f"reduced: runs gsi-slo, gsi-slo-async, gsi-slo-oneshot and "
              f"the warm-cache check cut to {cfgs[0].num_layers} layers in "
              f"all three models (published {full[0].num_layers}); widths "
              f"unchanged", flush=True)
    cut = [{k: p[k] for k in param_specs(c)} for p, c in zip(params, cfgs)]
    g = GSIConfig(n=4, beta=20.0, temperature=0.0, max_step_tokens=16,
                  max_steps=3, eos_token_id=-1, min_step_reward=-1e9)
    reqs = slo_requests(full[0].vocab_size)
    print("SLO requests: " + ", ".join(
        f"{rid} {p.size} tokens, priority {pr}, deadline_s {dl}, budget "
        f"{st or g.max_steps}" for rid, (p, pr, dl, st) in reqs.items()),
        flush=True)
    g = dataclasses.replace(g, threshold_u=slo_threshold(
        torch, cfgs, cut, g, reqs))
    acc, runs = {}, {}
    for name, sync, chunk, staged in (
            ("gsi-slo", True, SLO_CHUNK, True),
            ("gsi-slo-async", False, SLO_CHUNK, True),
            ("gsi-slo-oneshot", True, 0, False)):
        runs[name] = slo_run(torch, name, cfgs, cut, g, reqs, acc,
                             sync=sync, chunk=chunk, staged=staged)
        slo_report(torch, runs[name], acc[name], full[0].vocab_size, reqs)
        elapsed(f"run {name}")
    base = runs["gsi-slo"]["out"]
    for name, res in runs.items():
        st = res["stats"]
        check(all(res["out"][r].tokens.tolist() == base[r].tokens.tolist()
                  and res["out"][r].finish_reason == base[r].finish_reason
                  for r in reqs),
              f"{name}: tokens or finish reasons differ from run gsi-slo's")
        if name == "gsi-slo-oneshot":
            check(st.prefill_commit_max > SLO_CHUNK,
                  f"{name}: prefill_commit_max {st.prefill_commit_max}")
        else:
            check(st.prefill_commit_max <= SLO_CHUNK,
                  f"{name}: prefill_commit_max {st.prefill_commit_max} > "
                  f"{SLO_CHUNK}")
            check(st.preemptions >= 1 and st.resumes == st.preemptions,
                  f"{name}: preemptions {st.preemptions}, resumes "
                  f"{st.resumes}")
    print("SLO runs: every request's tokens and finish reason identical in "
          "runs gsi-slo, gsi-slo-async and gsi-slo-oneshot; "
          "prefill_commit_max " + ", ".join(
              f"{n} {r['stats'].prefill_commit_max}" for n, r in runs.items())
          + f"; preempted " + ", ".join(
              f"{n} {[r for r, x in res['out'].items() if x.preemptions]}"
              for n, res in runs.items()), flush=True)
    launches = sum(r["launches"]["paged_attention"] for r in runs.values())
    launches += slo_warm_cache(torch, cfgs, cut, g, reqs,
                               runs["gsi-slo-oneshot"], acc)
    elapsed("the warm-cache check")
    runs.clear()
    del cut
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# Phase 4: the replica fleet (router, thread-per-replica loop, migration)
# ----------------------------------------------------------------------

def fleet_prompts(vocab):
    """``FLEET_GROUPS`` preamble groups of ``FLEET_PER_GROUP + 1`` prompts
    (a 33-token preamble and a tail of 2-6 tokens, no reserved token), as
    ``benchmarks/common.py``'s ``shared_prefix_prompts`` lays them out:
    returns the first wave (the groups in blocks), each prompt's group and
    the held-back next request of every group."""
    import numpy as np
    rng = np.random.default_rng(FLEET_SEED)
    allowed = np.arange(3, vocab)
    pres = [rng.choice(allowed, FLEET_PREAMBLE) for _ in range(FLEET_GROUPS)]
    wave, groups, nxt = [], [], []
    for g, pre in enumerate(pres):
        for i in range(FLEET_PER_GROUP + 1):
            tail = rng.choice(allowed, int(rng.integers(2, 7)))
            p = np.concatenate([pre, tail]).astype(np.int32)
            if i < FLEET_PER_GROUP:
                wave.append(p)
                groups.append(g)
            else:
                nxt.append(p)
    return wave, groups, nxt


def fleet_budgets(count, max_steps):
    """The reference benchmark's step budgets, cycling short to long."""
    cycle = [1, 2, max(3, max_steps - 1), max_steps]
    return [cycle[i % len(cycle)] for i in range(count)]


def fleet_engines(torch, cfgs, params, g, count, **kw):
    """``count`` paged engines (pages of 16 rows, prefix cache on, mode
    gsi) over the one shared set of weights, each model's decode_step
    counted per engine into ``engine.fleet_calls`` (paged calls and
    layers), the draft phases into ``engine.fleet_phases``."""
    from repro_torch.serving import GSIServingEngine
    engines = []
    for _ in range(count):
        eng = GSIServingEngine(*cfgs, *params, g, mode="gsi", max_seq=128,
                               device="cuda", paged=True, page_size=16,
                               num_pages=FLEET_PAGES, **kw)
        eng.fleet_calls = {}
        eng.fleet_phases = [0]
        for tag, model in (("draft", eng.draft), ("target", eng.target),
                           ("prm", eng.prm)):
            def counted(*a, _orig=model.decode_step, _tag=tag, _eng=eng,
                        _layers=len(model.layers), **k):
                calls = _eng.fleet_calls.setdefault(_tag, [0, _layers])
                calls[0] += k.get("pt") is not None
                return _orig(*a, **k)
            model.decode_step = counted

        def phased(*a, _orig=eng._draft_phase, _eng=eng, **k):
            _eng.fleet_phases[0] += 1
            return _orig(*a, **k)
        eng._draft_phase = phased
        engines.append(eng)
    return engines


def fleet_threshold(torch, label, cfgs, params, g, prompts, **kw):
    """One calibration step of ``prompts`` (a slot each) on a throwaway
    engine gives every request's first decision; the midpoint of the widest
    gap between two of them (``gap_threshold``) makes every run of these
    requests accept a first step and reject one."""
    from repro_torch.serving import GSIScheduler, GSIServingEngine
    engine = GSIServingEngine(*cfgs, *params, g, mode="gsi", max_seq=128,
                              device="cuda", paged=True, page_size=16, **kw)
    first = []
    live_tilted(engine, first)
    sched = GSIScheduler(engine, capacity=len(prompts))
    for i, p in enumerate(prompts):
        sched.submit(p, request_id=f"c{i}", max_steps=1)
    sched.run(torch.Generator(device="cuda").manual_seed(0))
    del sched, engine
    return gap_threshold(label, first, len(prompts))


def fleet_run(torch, name, engines, requests, *, grow=None, **router_kw):
    """Serve ``requests`` (id -> (prompt, budget)) through a new
    ``ReplicaRouter`` over ``engines`` (capacity 1 a replica), with every
    launch counter zeroed just before and read just after; each replica's
    steps timed and the stream they ran on recorded.  ``grow = (engine,
    more)``: after the drain, ``add_replica(engine)`` and a second drain
    of ``more``."""
    from repro_torch.serving import ReplicaRouter
    for eng in engines + ([grow[0]] if grow else []):
        eng.fleet_calls.clear()
        eng.fleet_phases[0] = 0
    router = ReplicaRouter(engines, capacity=1, **router_kw)
    timing = {}

    def timed(rep):
        step = rep.scheduler.step

        def run_step(gen):
            t0 = time.perf_counter()
            out = step(gen)
            rec = timing.setdefault(rep.index, {"s": 0.0, "streams": set()})
            rec["s"] += time.perf_counter() - t0
            rec["streams"].add(torch.cuda.current_stream().cuda_stream)
            return out
        rep.scheduler.step = run_step

    for rep in router.replicas:
        timed(rep)
    wrappers = counters(torch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for rid, (prompt, budget) in requests.items():
        router.submit(prompt, request_id=rid, max_steps=budget)
    router.run(FLEET_SEED)
    moved = predicted = None
    if grow:
        engine, more = grow
        predicted = fleet_predict_moves(router)
        moved = router.add_replica(engine)
        timed(router.replicas[-1])
        for rid, (prompt, budget) in more.items():
            router.submit(prompt, request_id=rid, max_steps=budget)
        router.run(FLEET_SEED + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    out = router.responses
    tokens = sum(r.num_tokens for r in out.values())
    return {"name": name, "router": router, "out": out, "wall_s": wall,
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "launches": launches, "timing": timing, "moved": moved,
            "predicted": predicted, "stats": router.stats,
            "prefix": router.prefix_stats(),
            "engines": list(router.replicas)}


def fleet_predict_moves(router):
    """What ``add_replica`` must move, from the host's radix trees before
    it runs: the groups whose rendezvous winner over the grown fleet is the
    new replica, and the cached pages of their subtrees."""
    from repro_torch.serving import preamble_rendezvous
    import numpy as np
    new = router.num_replicas
    groups = pages = 0
    for rep in router.replicas:
        pager = rep.engine.pager
        for chunk in pager.index.groups():
            if preamble_rendezvous(np.asarray(chunk, np.int32),
                                   new + 1) != new:
                continue
            stack = [pager.index.root.children[chunk]]
            if stack[0].page not in pager.cached:
                continue
            groups += 1
            while stack:
                node = stack.pop()
                pages += node.page in pager.cached
                stack.extend(node.children.values())
    return {"groups_moved": groups, "pages_moved": pages}


def fleet_report(torch, res, vocab, ids):
    """Print one fleet run's numbers and hold it to the checks every run
    shares: requests finished with tokens in range, accept and fallback
    both taken, pages conserved on every replica, and launches exact (the
    paged kernel, or the quantized kernel and the gather, layers x paged
    decode_step calls summed over the replicas)."""
    name, router, out, st = res["name"], res["router"], res["out"], \
        res["stats"]
    px = res["prefix"]
    print(f"run {name}: {router.num_replicas} replica(s), requests "
          f"finished {len(out)}/{len(ids)}, engine steps "
          f"{router.engine_steps} (busiest replica "
          f"{router.engine_steps_max}), generated tokens {res['tokens']}, "
          f"wall {res['wall_s']:.2f} s, tokens/s {res['tokens_per_s']:.2f}, "
          f"decisions {st.decisions}, accepted {st.accepted} ({CARD})",
          flush=True)
    print(f"run {name}: routing {router.routing}; prefix hits "
          f"{px['hits']} of {px['queries']} admissions, per replica "
          + ", ".join(f"r{i} {p['hits']}/{p['queries']} (hit tokens "
                      f"{p['hit_tokens']})"
                      for i, p in enumerate(px["per_replica"]))
          + "; routed " + ", ".join(f"r{r.index} {r.routed}"
                                    for r in router.replicas), flush=True)
    steps = {i: t["s"] for i, t in sorted(res["timing"].items())}
    if router.threaded:
        print(f"run {name}: threaded fleet wall {res['wall_s']:.2f} s "
              f"against its replicas' step times "
              + " + ".join(f"r{i} {s:.2f}" for i, s in steps.items())
              + f" = {sum(steps.values()):.2f} s ({CARD})", flush=True)
    print(f"run {name}: kernel launches {res['launches']}", flush=True)
    check(set(ids) <= set(out), f"{name}: finished {sorted(out)}")
    for rid in ids:
        r = out[rid]
        toks = r.tokens
        check(r.finish_reason in ("eos", "low_reward", "max_steps")
              and toks.size > 0 and toks.min() >= 0 and toks.max() < vocab,
              f"{name} {rid}: reason {r.finish_reason!r}, tokens {toks}")
    check(0 < st.accepted < st.decisions,
          f"{name}: {st.accepted} of {st.decisions} decisions accepted; the"
          f" run must take both the accept and the fallback branch")
    for rep in router.replicas:
        pool = rep.engine.pager
        check(pool.num_free + pool.num_referenced + pool.num_cached
              == pool.num_pages and pool.evicted == 0,
              f"{name} replica {rep.index}: pages not conserved or evicted")
    want = sum(layers * calls for rep in router.replicas
               for calls, layers in rep.engine.fleet_calls.values())
    phases = sum(rep.engine.fleet_phases[0] for rep in router.replicas)
    if router.kv_dtype == "int8":
        ok = only(res["launches"], paged_attention_quant=want,
                  logprob_gather=2 * phases)
        what = (f"paged_attention_quant = {want} and logprob_gather = 2 x "
                f"draft phases = {2 * phases}")
    else:
        ok = only(res["launches"], paged_attention=want)
        what = f"paged_attention = {want}"
    check(want > 0 and ok, f"{name}: launches {res['launches']}; want "
          f"{what} (layers x paged decode_step calls summed over the "
          f"replicas) and no other kernel")
    if router.threaded:
        streams = [res["timing"][i]["streams"] for i in steps]
        handles = [h for s in streams for h in s]
        check(len(steps) == router.num_replicas
              and all(len(s) == 1 for s in streams)
              and len(set(handles)) == len(handles) and 0 not in handles,
              f"{name}: replica streams {streams}; want one distinct, "
              f"non-default stream per replica")
        print(f"run {name}: replica streams {handles}, distinct and not the"
              f" default stream", flush=True)


def phase_fleet(torch, params):
    """Phase 4's fleet runs at full Qwen2.5-Math width (``FLEET_LAYERS``
    deep); returns their launches of the paged kernels and the gather."""
    import numpy as np
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import param_specs
    from repro_torch.serving import preamble_hash, preamble_rendezvous
    t_phase = time.perf_counter()
    full = serve.build_triple("qwen2.5-math")
    cfgs = serve.build_triple("qwen2.5-math", layers=FLEET_LAYERS)
    vocab = full[0].vocab_size
    print(f"== phase 4: the replica fleet at full Qwen2.5-Math width "
          f"({cfgs[0].num_layers} layers)", flush=True)
    if cfgs[0].num_layers < full[0].num_layers:
        print(f"reduced: runs fleet-single, fleet-affinity, fleet-rr, "
              f"fleet-async, fleet-grow, fleet-int8-async and "
              f"fleet-int8-single cut to {cfgs[0].num_layers} layers in all "
              f"three models (published {full[0].num_layers}); widths "
              f"unchanged", flush=True)
    cut = [{k: p[k] for k in param_specs(c)} for p, c in zip(params, cfgs)]
    g = GSIConfig(n=4, beta=20.0, temperature=0.0,
                  max_step_tokens=FLEET_STEP_TOKENS, max_steps=FLEET_STEPS,
                  eos_token_id=-1, min_step_reward=-1e9)
    wave, groups, nxt = fleet_prompts(vocab)
    budgets = fleet_budgets(len(wave), FLEET_STEPS)
    reqs = {f"f{i}": (p, m) for i, (p, m) in enumerate(zip(wave, budgets))}
    more = {f"next{gi}": (p, FLEET_STEPS) for gi, p in enumerate(nxt)}
    print("fleet requests: " + ", ".join(
        f"{rid} group {gr} {p.size} tokens budget {m}"
        for (rid, (p, m)), gr in zip(reqs.items(), groups))
        + "; next wave " + ", ".join(f"{rid} {p.size} tokens"
                                     for rid, (p, _) in more.items()),
        flush=True)
    # the CPU's predictions: affinity keeps each group on one replica
    # (one cold miss a group); round robin over blocks misses once per
    # (group, replica) pair; rendezvous moves the groups the new replica
    # wins
    first = [p[:16] for p in wave[::FLEET_PER_GROUP]]
    rr_pairs = {(gr, i % 2) for i, gr in enumerate(groups)}
    want_hits = {"fleet-single": len(wave) - FLEET_GROUPS,
                 "fleet-affinity": len(wave) - FLEET_GROUPS,
                 "fleet-rr": len(wave) - len(rr_pairs),
                 "fleet-async": len(wave) - FLEET_GROUPS}
    moving = [gi for gi, c in enumerate(first)
              if preamble_rendezvous(c, 3) == 2]
    print(f"fleet predictions (host): groups' first pages hash (mod, 2) to "
          f"{[preamble_hash(c, 2) for c in first]}, rendezvous over 2 to "
          f"{[preamble_rendezvous(c, 2) for c in first]} and over 3 to "
          f"{[preamble_rendezvous(c, 3) for c in first]}; prefix hits "
          f"{want_hits}; fleet-grow moves groups {moving}", flush=True)
    check(moving and len(moving) < FLEET_GROUPS,
          f"fleet-grow: groups {moving} move; FLEET_SEED must move at "
          f"least one group and keep one")
    threshold = fleet_threshold(torch, "fleet runs", cfgs, cut, g, wave)
    g = dataclasses.replace(g, threshold_u=threshold)
    engines = fleet_engines(torch, cfgs, cut, g, 3)
    runs = {}
    for name, engs, kw in (
            ("fleet-single", engines[:1], dict(threaded=False)),
            ("fleet-affinity", engines[:2], dict(skew=None,
                                                 threaded=False)),
            ("fleet-rr", engines[:2], dict(policy="round_robin",
                                           threaded=False)),
            ("fleet-async", engines[:2], dict(skew=None, sync=False,
                                              threaded=True))):
        runs[name] = fleet_run(torch, name, engs, reqs, **kw)
        fleet_report(torch, runs[name], vocab, list(reqs))
    runs["fleet-grow"] = grow = fleet_run(
        torch, "fleet-grow", engines[:2], reqs, grow=(engines[2], more),
        skew=None, hash_tier="rendezvous", threaded=False)
    fleet_report(torch, grow, vocab, list(reqs) + list(more))
    elapsed("the bf16 fleet runs")
    base = runs["fleet-single"]["out"]
    for name, res in runs.items():
        check(all(res["out"][r].tokens.tolist() == base[r].tokens.tolist()
                  for r in reqs),
              f"{name}: tokens differ from run fleet-single's")
        if name in want_hits:
            check(res["prefix"]["hits"] == want_hits[name],
                  f"{name}: {res['prefix']['hits']} prefix hits, predicted "
                  f"{want_hits[name]}")
    check(runs["fleet-affinity"]["prefix"]["hits"]
          > runs["fleet-rr"]["prefix"]["hits"],
          "fleet-affinity: no more prefix hits than round robin")
    moved, predicted = grow["moved"], grow["predicted"]
    router = grow["router"]
    print(f"run fleet-grow: add_replica moved {moved}, the host predicted "
          f"{predicted}; the next requests went to replicas "
          f"{[router.replica_of(r) for r in more]}", flush=True)
    check(moved == predicted and moved["groups_moved"] == len(moving)
          and moved["pages_moved"] > 0,
          f"fleet-grow: moved {moved}, predicted {predicted} "
          f"({len(moving)} groups)")
    new = router.replicas[-1]
    check(all(router.replica_of(f"next{gi}") == new.index for gi in moving)
          and new.scheduler.prefix_stats()["hits"] == len(moving),
          f"fleet-grow: the moved groups' next requests did not all hit on "
          f"the new replica ({new.scheduler.prefix_stats()})")
    print("fleet runs: every request's tokens identical in runs "
          "fleet-single, fleet-affinity, fleet-rr, fleet-async and "
          "fleet-grow; prefix hits " + ", ".join(
              f"{n} {r['prefix']['hits']}" for n, r in runs.items())
          + " as predicted; the moved group hit on the new replica",
          flush=True)
    launches = {"paged_attention": sum(r["launches"]["paged_attention"]
                                       for r in runs.values())}
    runs.clear()
    del engines, grow, router, new
    # int8 pages, shared scoring and the int8 draft: a threaded fleet of 2
    # against one replica
    q8 = dict(kv_dtype="int8", shared_scoring=True, quantize_draft=True)
    ids8 = [f"f{i}" for i in range(FLEET_INT8_REQUESTS // 2)] + [
        f"f{FLEET_PER_GROUP + i}" for i in range(FLEET_INT8_REQUESTS // 2)]
    reqs8 = {rid: reqs[rid] for rid in ids8}
    g8 = dataclasses.replace(g, threshold_u=fleet_threshold(
        torch, "fleet int8 runs", cfgs, cut, g,
        [p for p, _ in reqs8.values()], **q8))
    engines = fleet_engines(torch, cfgs, cut, g8, 3, **q8)
    for name, engs, kw in (
            ("fleet-int8-async", engines[:2], dict(skew=None, sync=False,
                                                   threaded=True)),
            ("fleet-int8-single", engines[2:], dict(threaded=False))):
        runs[name] = fleet_run(torch, name, engs, reqs8, **kw)
        fleet_report(torch, runs[name], vocab, ids8)
    a, b = runs["fleet-int8-async"]["out"], runs["fleet-int8-single"]["out"]
    check(all(a[r].tokens.tolist() == b[r].tokens.tolist() for r in ids8),
          "fleet-int8-async: tokens differ from run fleet-int8-single's")
    print("fleet int8 runs: every request's tokens identical in the "
          "threaded 2-replica fleet and one replica", flush=True)
    for key in ("paged_attention_quant", "logprob_gather"):
        launches[key] = sum(r["launches"][key] for r in runs.values())
    print(f"fleet phase: {time.perf_counter() - t_phase:.1f} s ({CARD}); "
          f"launches {launches}", flush=True)
    runs.clear()
    del engines, cut
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# Phase 4: GSI with the mixture-of-experts target (qwen2-moe)
# ----------------------------------------------------------------------

def moe_layer_bytes(cfg):
    """Bytes one bf16 MoE FFN layer must read at decode: the router, every
    laid-out expert's three matrices (the batched product reads all of
    them, padding experts included) and the shared experts' three."""
    from repro_torch.models.moe import padded_experts
    d, ff = cfg.d_model, cfg.moe_d_ff
    e = padded_experts(cfg)
    return 2 * (d * e + e * 3 * d * ff
                + 3 * d * cfg.num_shared_experts * ff)


def seed_cross_kv(torch, engine, seed):
    """Make ``engine.admit`` write seeded N(0, 1) values into the admitted
    slots' ``ck``/``cv`` in every cross layer of the three models.  The
    engine takes no source, so they are otherwise zero and every cross step
    outputs 0, which a dropped cross layer would match; with them the
    engine's cross path (branching the cross KV, each branch's and shared
    scoring's cross step over it, row resets) moves the rewards.  A slot's
    values depend on (seed, slot) alone, so a run and its calibration see
    the same ones."""
    import numpy as np
    admit = engine.admit

    def admitted(state, mask, *a, **k):
        state = admit(state, mask, *a, **k)
        for slot in np.nonzero(np.asarray(mask, bool))[0].tolist():
            gen = torch.Generator(device="cuda").manual_seed(
                1000 * seed + slot)
            for name in sorted(state["caches"]):
                for layer in state["caches"][name]:
                    for leaf in ("ck", "cv") if "ck" in layer else ():
                        row = layer[leaf][slot]
                        row.copy_(torch.randn(row.shape, generator=gen,
                                              device="cuda"))
        return state

    engine.admit = admitted


def first_step_rewards(torch, cfgs, params, g, prompts, seed, cross_kv=None,
                       **kw):
    """A run's first-step selected tilted rewards, one per prompt: one
    engine step of the same prompts with the same seed, slots and engine
    options ``kw`` draws the same candidates as the run's first step (no
    threshold changes a first step); ``cross_kv`` seeds the slots' cross
    KV as :func:`serve_run` does."""
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine, gsi_engine
    engine = GSIServingEngine(*cfgs, *params, dataclasses.replace(
        g, max_steps=1), mode="gsi", max_seq=512, device="cuda",
        **{"paged": True, "page_size": 16, **kw})
    if cross_kv is not None:
        seed_cross_kv(torch, engine, cross_kv)
    first = []
    select = gsi_engine.gsi_select

    def recorded(*a, **k):
        dec = select(*a, **k)
        if not first:
            first.extend(dec.selected_tilted.tolist())
        return dec

    gsi_engine.gsi_select = recorded
    try:
        serve.serve(engine, prompts, capacity=len(prompts), seed=seed)
    finally:
        gsi_engine.gsi_select = select
    del engine
    return first


def step_threshold(torch, label, cfgs, params, g, prompts, seed, **kw):
    """A threshold among a run's own first-step selected tilted rewards
    (:func:`first_step_rewards`): the midpoint of the widest gap between
    two rows' selected values makes the run accept at least one step and
    fall back on another."""
    return gap_threshold(f"run {label} calibration", first_step_rewards(
        torch, cfgs, params, g, prompts, seed, **kw), len(prompts))


def moe_layer_check(torch, cfg, params, rows):
    """Layer 0 of the MoE target on the card at ``rows`` tokens (the
    decode_step rows of runs gsi-moe): the bf16 layer twice (bitwise
    equal), against the same layer in fp32 from the same weights and the
    same bf16-rounded input; the share of routed slots dropped; its time
    against the bytes it must read."""
    from repro_torch.models import moe
    p = {k.split(".", 3)[3]: v for k, v in params.items()
         if k.startswith("layers.0.ffn.")}
    gen = torch.Generator(device="cuda").manual_seed(MOE_SEED)
    x = torch.randn((rows, 1, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    y = moe.moe_ffn(cfg, p, x)[0]
    check(torch.equal(y, moe.moe_ffn(cfg, p, x)[0]),
          "MoE layer: two bf16 calls on the same input differ")
    p32 = {k: v.float() for k, v in p.items()}
    want = moe.moe_ffn(cfg, p32, x.float())[0]
    scale = want.abs().max()
    diff = (y.float() - want).abs().amax(dim=(1, 2)) / scale     # per row
    xf = x.reshape(rows, cfg.d_model)
    e16 = moe._route(cfg, p["router"], xf)[1].sort(dim=1).values
    e32 = moe._route(cfg, p32["router"], xf.float())[1].sort(dim=1).values
    e_pad = p["router"].shape[1]
    cap = moe._capacity(cfg, rows, e_pad)
    counts = torch.bincount(e16.flatten(), minlength=e_pad)
    dropped = int((counts - cap).clamp(min=0).sum().item())
    slots = rows * cfg.experts_per_token
    same = (e16 == e32).all(dim=1)
    err, n_same = diff.max().item(), int(same.sum().item())
    err_same = diff[same].max().item() if n_same else 0.0
    check(torch.isfinite(y).all().item() and 2 * n_same >= rows
          and err_same < MOE_TOL,
          f"MoE layer: bf16 against fp32, {n_same} of {rows} rows routed "
          f"alike, largest error over them {err_same:.3e} of the output's "
          f"scale; tolerance {MOE_TOL}")
    # about 70 launches a call: 8 calls stay inside the launch queue, so
    # the host finishes enqueueing before the device sleep ends
    dev_ms, b2b_ms, host_ms = time_ms(
        torch, lambda a: moe.moe_ffn(cfg, p, a), [(x,)], iters=8,
        enqueue=True)
    nbytes = moe_layer_bytes(cfg)
    bound = nbytes / H100_BYTES_PER_S * 1e3
    print(f"MoE layer (layer 0 of {cfg.name}, T = {rows} rows, bf16): "
          f"largest error against fp32 {err_same:.4e} of the output's "
          f"scale over the {n_same} of {rows} rows routed to the same "
          f"experts, {err:.4e} over all (max |y| {scale.item():.4f}); "
          f"routed slots dropped {dropped} of {slots} = "
          f"{dropped / slots:.4f} (capacity {cap} per expert, {e_pad} laid "
          f"out, {cfg.num_experts} real); two calls bitwise equal",
          flush=True)
    print(f"MoE layer time: device {dev_ms:.4f} ms a call, back to back "
          f"{b2b_ms:.4f} ms, host {host_ms:.4f} ms; bound {bound:.4f} ms "
          f"(bytes: {nbytes:,} B a layer over {H100_BYTES_PER_S:.3g} B/s; "
          f"x {cfg.num_layers} layers = {nbytes * cfg.num_layers:,} B, "
          f"{bound * cfg.num_layers:.2f} ms a decode_step); "
          f"{dev_ms / bound:.2f}x the bound", flush=True)
    return {"err": err_same, "dropped": dropped / slots, "ms": dev_ms,
            "bound_ms": bound}


def phase_moe(torch):
    """Runs gsi-moe and gsi-moe-async at qwen2-moe's full width,
    ``MOE_LAYERS`` deep (the Qwen2.5-Math draft and PRM around the
    qwen2-moe-a2.7b target),
    one MoE layer bf16 against fp32, and one profiled engine step; returns
    the paged_attention launches."""
    print("== phase 4: GSI with the mixture-of-experts target at full "
          "qwen2-moe-a2.7b width", flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import param_specs, random_params
    cfgs = serve.build_triple("qwen2-moe", layers=MOE_LAYERS)
    print(f"reduced: runs gsi-moe and gsi-moe-async cut to {MOE_LAYERS} "
          f"layers in all three models (published "
          + ", ".join(str(c.num_layers)
                      for c in serve.build_triple("qwen2-moe"))
          + "); widths unchanged", flush=True)
    for c in cfgs:
        moe_note = (f" experts={c.num_experts} (laid out "
                    f"{param_specs(c)['layers.0.ffn.router'].shape[1]}) "
                    f"top-{c.experts_per_token} shared="
                    f"{c.num_shared_experts} expert_ffn={c.moe_d_ff} "
                    f"capacity_factor={c.capacity_factor}"
                    if c.num_experts else f" ffn={c.d_ff}")
        print(f"model {c.name}: layers={c.num_layers} d={c.d_model} "
              f"heads={c.num_heads}/{c.num_kv_heads} hd={c.head_dim}"
              f"{moe_note} vocab={c.vocab_size} tied={c.tie_embeddings} "
              f"params~{c.param_count() / 1e9:.2f}B (as laid out "
              f"{sum(math.prod(s.shape) for s in param_specs(c).values()) / 1e9:.2f}B)",
              flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = [random_params(c, i, "cuda") for i, c in enumerate(cfgs)]
    torch.cuda.synchronize()
    print(f"random bf16 weights on the card: "
          f"{time.perf_counter() - t0:.1f} s; memory_allocated after the "
          f"weights {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    g = GSIConfig(n=4, beta=20.0, temperature=0.7, max_step_tokens=16,
                  max_steps=2, min_step_reward=0.0)
    count = 4
    prompts = serve.random_prompts(count, seed=MOE_SEED,
                                   vocab=cfgs[0].vocab_size, lo=24, hi=72)
    g = dataclasses.replace(g, threshold_u=step_threshold(
        torch, "gsi-moe", cfgs, params, g, prompts, MOE_SEED))
    elapsed("the MoE calibration step")
    acc, results = {}, {}
    for name, sync in (("gsi-moe", True), ("gsi-moe-async", False)):
        res = serve_run(torch, name, cfgs, params, g, count, MOE_SEED, acc,
                        sync=sync)
        results[name] = res
        report_run(name, res, acc[name], cfgs[0].vocab_size)
        for tag, r in acc[name].items():
            stream = sum(a.elapsed_time(b) for a, b in r["events"])
            print(f"run {name}: {tag} ({r['layers']} layers) per "
                  f"decode_step: host {1e3 * r['host_s'] / r['calls']:.2f} "
                  f"ms, stream {stream / r['calls']:.2f} ms over "
                  f"{r['calls']} calls", flush=True)
        want = sum(r["layers"] * r["paged_calls"] for r in acc[name].values())
        got = res["launches"]
        print(f"run {name}: paged_attention launches "
              f"{got['paged_attention']}, layers x paged decode_step calls "
              f"{want} (" + ", ".join(
                  f"{t} {r['layers']} x {r['paged_calls']}"
                  for t, r in acc[name].items()) + ")", flush=True)
        check(want > 0 and only(got, paged_attention=want),
              f"{name}: launches {got}; want paged_attention = layers x "
              f"paged decode_step calls = {want} and no other kernel")
        elapsed(f"run {name}")
    stats = results["gsi-moe"]["stats"]
    print(f"run gsi-moe: threshold {g.threshold_u:.4f}; decisions "
          f"{stats.decisions}: accepted {stats.accepted} (a draft candidate "
          f"committed), rejected {stats.decisions - stats.accepted} (the MoE "
          f"target's fallback); accept rate "
          f"{results['gsi-moe']['accept_rate']:.3f}, tokens/s "
          f"{results['gsi-moe']['tokens_per_s']:.2f}", flush=True)
    check(0 < stats.accepted < stats.decisions,
          f"gsi-moe: {stats.accepted} of {stats.decisions} decisions "
          f"accepted; the run must take both the accept and the fallback "
          f"branch")
    check(results["gsi-moe"]["target_tokens"] > 0,
          "gsi-moe: the MoE target's fallback generated no token")
    check_pipelined(results["gsi-moe"], results["gsi-moe-async"],
                    names=("gsi-moe", "gsi-moe-async"))
    rows = count * g.n
    layer = moe_layer_check(torch, cfgs[1], params[1], rows)
    elapsed("the MoE layer check")
    print(f"max_memory_allocated (MoE phase) "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    # as the Qwen engine-step profiles: PROFILE_LAYERS deep, and at
    # threshold 0.5, which no selected tilted reward reaches, so the
    # profiled step runs the MoE target's fallback
    depth = min(PROFILE_LAYERS, min(c.num_layers for c in cfgs))
    print(f"reduced: phase 5's engine-step profile of run gsi-moe cuts "
          f"all three models to {depth} layers (runs gsi-moe and "
          f"gsi-moe-async {MOE_LAYERS}); widths unchanged", flush=True)
    prof = serve.build_triple("qwen2-moe", layers=depth)
    phase_profile(torch, [("gsi-moe", prof, [
        {k: p[k] for k in param_specs(c)} for p, c in zip(params, prof)],
        {})], dataclasses.replace(g, threshold_u=0.5))
    launches = sum(r["launches"]["paged_attention"]
                   for r in results.values())
    del params
    results.clear()
    torch.cuda.empty_cache()
    return {"paged_attention": launches, "layer": layer}


def carry_decays(torch, params, seed):
    """Overwrite every RWKV layer's ``decay_base`` in ``params`` (in place)
    with a seeded uniform in [-6, -0.5], so that the base decays
    w = exp(-exp(decay_base)) lie in about (0.54, 0.9975) and the WKV state
    carries from token to token (at the seeded init they lie in about
    [2e-24, 1.2e-4]).  Returns the range of the base decays as stored."""
    gen = torch.Generator().manual_seed(seed)
    ws = []
    for name, t in params.items():
        if name.endswith(".tm.decay_base"):
            t.copy_(torch.empty(t.shape).uniform_(-6.0, -0.5, generator=gen))
            ws.append(torch.exp(-torch.exp(t.float())))
    return min(w.min().item() for w in ws), max(w.max().item() for w in ws)


def toy_rwkv_triple():
    """The reduced ``rwkv6-3b`` (fp32, d 128, 4 heads of 32, vocab 64) as a
    2-layer draft, a 3-layer target and the target's PRM."""
    from repro_torch.config import get_config, reduced_config
    draft = reduced_config(get_config("rwkv6-3b"), vocab=64)
    target = dataclasses.replace(draft, name="rwkv6-3b-smoke-target",
                                 num_layers=3)
    prm = dataclasses.replace(target, name="rwkv6-3b-smoke-prm",
                              reward_head=True)
    return draft, target, prm


def phase_rwkv(torch):
    """Runs gsi-rwkv-shared and score-rwkv at rwkv6-3b's full width and
    depth, then one engine step under the profiler."""
    print("== phase 4: RWKV-6 runs at full rwkv6-3b width and depth",
          flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import param_specs, random_params
    cfgs = serve.build_triple("rwkv6-3b")
    for c in cfgs:
        print(f"model {c.name}: layers={c.num_layers} d={c.d_model} "
              f"heads={c.num_heads} hd={c.rwkv_head_dim} ffn={c.d_ff} "
              f"vocab={c.vocab_size} tied={c.tie_embeddings} "
              f"params~{c.param_count() / 1e9:.2f}B", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = [random_params(c, i, "cuda") for i, c in enumerate(cfgs)]
    ranges = [carry_decays(torch, p, 50 + i)
              for i, p in enumerate(params)]
    torch.cuda.synchronize()
    print(f"random bf16 weights on the card: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    print(f"decays: every layer's decay_base overwritten with U[-6, -0.5] "
          f"(seeded); base w = exp(-exp(decay_base)) in "
          f"[{min(r[0] for r in ranges):.4f}, "
          f"{max(r[1] for r in ranges):.4f}] over the three models, before "
          f"the data-dependent LoRA term", flush=True)
    gcfg = GSIConfig(n=4, beta=20.0, threshold_u=RWKV_THRESHOLD,
                     temperature=0.7, max_step_tokens=16, max_steps=4,
                     min_step_reward=0.0)
    kw = {"paged": False, "shared_scoring": True}
    acc = {}
    res = serve_run(torch, "gsi-rwkv-shared", cfgs, params, gcfg, 4, 3, acc,
                    **kw)
    rec = acc["gsi-rwkv-shared"]
    report_run("gsi-rwkv-shared", res, rec, cfgs[0].vocab_size)
    print(f"run gsi-rwkv-shared: cache_memory_report(4) {res['mem']}",
          flush=True)
    stats = res["stats"]
    tilted = torch.cat([torch.as_tensor(t).flatten()
                        for t in stats.tilted_rewards])
    print(f"run gsi-rwkv-shared: threshold {RWKV_THRESHOLD}; decisions "
          f"{stats.decisions}: accepted {stats.accepted} (a draft candidate "
          f"committed over the frozen state), rejected "
          f"{stats.decisions - stats.accepted} (target fallback); tilted "
          f"rewards in [{tilted.min().item():.4f}, "
          f"{tilted.max().item():.4f}]", flush=True)
    check(0 < stats.accepted < stats.decisions,
          f"gsi-rwkv-shared: {stats.accepted} of {stats.decisions} decisions "
          f"accepted; the run must take both the accept and the fallback "
          f"branch")
    steps = sum(r["layers"] * r["calls"] for r in rec.values())
    want = steps + res["score_layers"]
    got = res["launches"]
    print(f"run gsi-rwkv-shared: rwkv6_scan launches {got['rwkv6_scan']}, "
          f"layers x decode_step calls {steps} "
          f"({ {t: r['calls'] for t, r in rec.items()} }) + layers x "
          f"score_candidates calls {res['score_layers']} "
          f"({res['score_calls']} calls) = {want}; logprob_gather launches "
          f"{got['logprob_gather']}, score_candidates calls "
          f"{res['score_calls']}; vocab-gather inputs (h, w, h shape) "
          f"{res['gather_inputs']}", flush=True)
    check(res["score_calls"] == 2 * res["draft_phases"] > 0
          and only(got, rwkv6_scan=want, logprob_gather=res["score_calls"]),
          f"gsi-rwkv-shared: launches {got}; want rwkv6_scan = {want}, "
          f"logprob_gather = {res['score_calls']} score_candidates calls "
          f"(2 x {res['draft_phases']} draft phases), no other kernel")
    elapsed("run gsi-rwkv-shared")
    scored = phase_score(torch, "score-rwkv", cfgs, params, res,
                         "rwkv6_scan", agree_dtype="float32",
                         tols=(LP_TOL, REWARD_TOL, LOGIT_TOL))
    elapsed("run score-rwkv")
    print(f"max_memory_allocated (RWKV phase) "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    depth = min(PROFILE_LAYERS, cfgs[0].num_layers)
    print(f"reduced: phase 5's engine-step profile of run gsi-rwkv-shared "
          f"cuts all three models to {depth} layers (published "
          f"{cfgs[0].num_layers}); widths unchanged", flush=True)
    prof = serve.build_triple("rwkv6-3b", layers=depth)
    phase_profile(torch, [("gsi-rwkv-shared", prof, [
        {k: p[k] for k in param_specs(c)} for p, c in zip(params, prof)],
        kw)], gcfg)
    del params
    torch.cuda.empty_cache()
    return {"rwkv6_scan": got["rwkv6_scan"] + scored["rwkv6_scan"],
            "logprob_gather": got["logprob_gather"]
            + scored["logprob_gather"]}


# runs gsi-gemma3, gsi-gemma3-int8-shared, gsi-rgemma and their scoring
# runs: the seed of their prompts, of the serving generator and of the
# RG-LRU decays; their GSI config (4 requests on 4 slots, at most 2 steps
# of 16 tokens); the length of score-gemma3's prompts, which puts its
# sequences past gemma3's 512-key window
GEMMA_SEED = 6
GEMMA_REQUESTS = 4
GEMMA_LONG = (520, 560)
# the Gemma runs' depth, about a quarter of the published 26 and 38
# (widths never cut): at full depth the five runs took 268 s of a 1062.8 s
# chip run (H100 80GB HBM3, 700 W, a slower machine) once the
# cross-attention phase was added, at 13 and 19 layers 142.3 s of a
# 1071.3 s run (same card and limit) once the other families' training
# was added; 7 layers keep gemma3's 5 local : 1 global pattern once and a
# local remainder layer, 10 keep recurrentgemma's 3 (recurrent,
# recurrent, local) blocks and a recurrent remainder
GEMMA_LAYERS = {"gemma3": 7, "recurrentgemma": 10}


def carry_lru(torch, params, seed):
    """Overwrite every RG-LRU layer's ``lam`` in ``params`` (in place) with
    a seeded U[-9, -4], so that the state carries: a = exp(-8 softplus(lam)
    r) lies in about [0.93, 0.9995] at r = 0.5 (at the seeded init, lam the
    logit of U[0.9, 0.999], it lies in about [e^-28, e^-9]).  Returns the
    range of a at r = 0.5 as stored."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(seed)
    lo, hi = 1.0, 0.0
    for name, t in params.items():
        if name.endswith(".rec.lam"):
            t.copy_(torch.empty(t.shape).uniform_(-9.0, -4.0, generator=gen))
            a = torch.exp(-4.0 * F.softplus(t.float()))
            lo, hi = min(lo, a.min().item()), max(hi, a.max().item())
    return lo, hi


def family_serve(torch, name, cfgs, params, g, acc, cross_kv=None, **kw):
    """One serving run of a Gemma or cross-attention triple at a threshold
    calibrated among its own first-step selected tilted rewards (with
    ``cross_kv``, seeded cross KV written into every admitted slot, and
    the first step's rewards under the next seed's as the control, which
    must differ by more than 1e-2); checks that it both accepts and falls
    back,
    that the paged kernel of its pool dtype launched attention layers
    (a cross layer's self half included) x paged decode_step calls times
    and the gather once per score_candidates call (2 x draft phases) with
    shared scoring, nothing else, and that a hybrid or cross stack turned
    prefix sharing off."""
    from repro_torch.launch import serve
    prompts = serve.random_prompts(GEMMA_REQUESTS, seed=GEMMA_SEED,
                                   vocab=cfgs[0].vocab_size, lo=24, hi=72)
    first = first_step_rewards(torch, cfgs, params, g, prompts, GEMMA_SEED,
                               cross_kv=cross_kv, **kw)
    if cross_kv is not None:
        other = first_step_rewards(torch, cfgs, params, g, prompts,
                                   GEMMA_SEED, cross_kv=cross_kv + 1, **kw)
        moved = max(abs(a - b) for a, b in zip(first, other))
        print(f"run {name}: seeded N(0, 1) cross KV in every admitted "
              f"slot; first-step selected tilted rewards "
              f"{[round(r, 4) for r in first]}, under the next seed's "
              f"cross KV {[round(r, 4) for r in other]} (control: moved "
              f"{moved:.4f}, must pass 1e-2)", flush=True)
        check(moved > 1e-2, f"{name}: other cross KV moved the first "
              f"step's rewards by only {moved}")
    g = dataclasses.replace(g, threshold_u=gap_threshold(
        f"run {name} calibration", first, len(prompts)))
    res = serve_run(torch, name, cfgs, params, g, GEMMA_REQUESTS,
                    GEMMA_SEED, acc, cross_kv=cross_kv, **kw)
    rec = acc[name]
    report_run(name, res, rec, cfgs[0].vocab_size)
    for tag, r in rec.items():
        stream = sum(a.elapsed_time(b) for a, b in r["events"])
        print(f"run {name}: {tag} ({r['layers']} layers, {r['attn_layers']}"
              f" attention) per decode_step: host "
              f"{1e3 * r['host_s'] / r['calls']:.2f} ms, stream "
              f"{stream / r['calls']:.2f} ms over {r['calls']} calls",
              flush=True)
    stats = res["stats"]
    print(f"run {name}: threshold {g.threshold_u:.4f}; decisions "
          f"{stats.decisions}: accepted {stats.accepted}, rejected "
          f"{stats.decisions - stats.accepted} (target fallback); accept "
          f"rate {res['accept_rate']:.3f}, tokens/s "
          f"{res['tokens_per_s']:.2f}; prefix sharing "
          f"{'on' if res['prefix_cache'] else 'off'}", flush=True)
    check(0 < stats.accepted < stats.decisions,
          f"{name}: {stats.accepted} of {stats.decisions} decisions "
          f"accepted; the run must take both the accept and the fallback "
          f"branch")
    hybrid = any(k in ("recurrent", "cross") for k in cfgs[0].layer_pattern)
    check(res["prefix_cache"] == (not hybrid)
          and (not hybrid or res["prefix"]["hits"] == 0),
          f"{name}: prefix sharing {res['prefix_cache']}, hits "
          f"{res['prefix']['hits']}; a hybrid or cross stack must turn it "
          f"off")
    paged = "paged_attention_quant" if kw.get("kv_dtype") == "int8" \
        else "paged_attention"
    want = sum(r["attn_layers"] * r["paged_calls"] for r in rec.values())
    gathers = res["score_calls"] if kw.get("shared_scoring") else 0
    got = res["launches"]
    print(f"run {name}: {paged} launches {got[paged]}, attention layers x "
          f"paged decode_step calls {want} (" + ", ".join(
              f"{t} {r['attn_layers']} x {r['paged_calls']}"
              for t, r in rec.items()) + f"); logprob_gather launches "
          f"{got['logprob_gather']}, score_candidates calls "
          f"{res['score_calls']} (draft phases {res['draft_phases']}); "
          f"vocab-gather inputs (h, w, h shape) {res['gather_inputs']}",
          flush=True)
    check(want > 0 and only(got, **{paged: want, "logprob_gather": gathers})
          and (not gathers or gathers == 2 * res["draft_phases"]),
          f"{name}: launches {got}; want {paged} = {want}, logprob_gather "
          f"= {gathers}, no other kernel")
    elapsed(f"run {name}")
    return res


def long_prompts(res, vocab):
    """Run ``res`` with its prompts replaced by seeded prompts of
    :data:`GEMMA_LONG` tokens, its committed tokens kept: sequences past
    gemma3's 512-key window for the full-sequence passes."""
    from repro_torch.launch import serve
    lo, hi = GEMMA_LONG
    out = dict(res, name=f"{res['name']} (prompts of {lo}-{hi} tokens)")
    out["prompts"] = serve.random_prompts(len(res["prompts"]),
                                          seed=GEMMA_SEED + 1, vocab=vocab,
                                          lo=lo, hi=hi)
    return out


def phase_gemma(torch):
    """The Gemma families at full width, ``GEMMA_LAYERS`` deep: runs
    gsi-gemma3 (bf16 pages), gsi-gemma3-int8-shared (int8 pages, shared
    scoring, the int8 draft) and score-gemma3 (sequences of 550-600
    tokens), then, once those weights are freed, gsi-rgemma (paged local
    layers beside dense RG-LRU state, prefix sharing off) and
    score-rgemma.  Returns the launches of each kernel over the five
    runs."""
    print("== phase 4: the Gemma families at full gemma3-1b and "
          "recurrentgemma-9b width", flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import param_specs, random_params
    g = GSIConfig(n=4, beta=20.0, temperature=0.7, max_step_tokens=16,
                  max_steps=2, min_step_reward=0.0)
    total = dict.fromkeys(("paged_attention", "paged_attention_quant",
                           "logprob_gather", "flash_attention"), 0)
    for family in ("gemma3", "recurrentgemma"):
        cfgs = serve.build_triple(family, layers=GEMMA_LAYERS[family])
        print(f"reduced: the {family} runs cut to {GEMMA_LAYERS[family]} "
              f"layers in all three models (published "
              f"{serve.build_triple(family)[0].num_layers}); widths "
              f"unchanged", flush=True)
        for c in cfgs:
            laid = sum(math.prod(s.shape) for s in param_specs(c).values())
            print(f"model {c.name}: layers={c.num_layers} pattern="
                  f"{'/'.join(c.layer_pattern)} window={c.window_size} d="
                  f"{c.d_model} heads={c.num_heads}/{c.num_kv_heads} hd="
                  f"{c.head_dim} ffn={c.d_ff} lru_width={c.lru_width} vocab="
                  f"{c.vocab_size} tied={c.tie_embeddings} params~"
                  f"{c.param_count() / 1e9:.2f}B (as laid out "
                  f"{laid / 1e9:.2f}B)", flush=True)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = [random_params(c, i, "cuda") for i, c in enumerate(cfgs)]
        ranges = [carry_lru(torch, p, 60 + i) for i, p in enumerate(params)]
        torch.cuda.synchronize()
        print(f"random bf16 weights of the {family} triple on the card: "
              f"{time.perf_counter() - t0:.1f} s; memory_allocated before "
              f"{before / 2 ** 30:.2f} GiB, after "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        if any(lo <= hi for lo, hi in ranges):
            print(f"RG-LRU decays: every lam overwritten with U[-9, -4] "
                  f"(seeded); a = exp(-8 softplus(lam) r) at r = 0.5 in "
                  f"[{min(r[0] for r in ranges):.4f}, "
                  f"{max(r[1] for r in ranges):.4f}]", flush=True)
        acc = {}
        if family == "gemma3":
            res = family_serve(torch, "gsi-gemma3", cfgs, params, g, acc)
            total["paged_attention"] += res["launches"]["paged_attention"]
            int8 = family_serve(torch, "gsi-gemma3-int8-shared", cfgs,
                                params, g, acc, kv_dtype="int8",
                                shared_scoring=True, quantize_draft=True)
            total["paged_attention_quant"] += \
                int8["launches"]["paged_attention_quant"]
            total["logprob_gather"] += int8["launches"]["logprob_gather"]
            scored = phase_score(
                torch, "score-gemma3", cfgs, params,
                long_prompts(res, cfgs[0].vocab_size), "flash_attention",
                agree_dtype="float32", tols=(LP_TOL, REWARD_TOL, LOGIT_TOL))
        else:
            res = family_serve(torch, "gsi-rgemma", cfgs, params, g, acc)
            total["paged_attention"] += res["launches"]["paged_attention"]
            scored = phase_score(
                torch, "score-rgemma", cfgs, params, res, "flash_attention",
                agree_dtype="float32", tols=(LP_TOL, REWARD_TOL, LOGIT_TOL))
        total["flash_attention"] += scored["flash_attention"]
        total["logprob_gather"] += scored["logprob_gather"]
        elapsed(f"the {family} runs")
        print(f"max_memory_allocated ({family} runs) "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        del params, res, acc
        release(torch)
    return total


# phase_cross: the seed of its sources and prompts; the agreement runs'
# prompts, prompt tokens and decode steps; their tolerance in fp32
# activations over the bf16 weights (logits and log-probs; rewards) for
# both sides of every comparison running fp32 products in other orders
# (flash's CUDA-core kernel in the full-sequence calls, the dense decode
# einsum in decode): 1e-5 seen in llama-vision's logits of scale 5 in a
# first chip run (H100 80GB HBM3, 700 W), where LOGIT_TOL's 0.1 would be
# of the order of what a second source moves (0.15: a random N(0, 1)
# source's 6,404 keys get a near-uniform softmax, so a cross layer adds
# about their mean); run t5's steps.  gsi-vision runs on 4 slots: its
# peak was 70.26 GiB of the card's 80 in a first chip run (H100 80GB
# HBM3, 700 W): 56.51 GiB of weights and 0.195 GiB of cross KV a row and
# model, of which a draft phase holds 4 x (1 + n) rows a model
CROSS_SEED = 9
CROSS_AGREE = (3, 240, 16)
CROSS_TOL = 1e-3
CROSS_TRAIN_STEPS = 3


def cross_source(torch, cfg, B, seed):
    """A seeded N(0, 1) source of the config's length, bf16 on the card:
    patch embeddings (B, cross_source_seq, d) or frame embeddings (B,
    encoder_seq, d), what the stubbed frontends would hand over."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    S = cfg.encoder_seq or cfg.cross_source_seq
    return torch.randn((B, S, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)


def cross_calls(torch, target, prm, toks, src):
    """The model-level calls of a cross family on one batch: prefill of
    the prompt, decode steps from its cache (cross KV read back from
    there), forward over prompt and steps, score and the PRM's reward at
    the end, all with ``src``.  Returns each call's output."""
    B, S = toks.shape
    P = S - CROSS_AGREE[2]
    pf, cache = target.prefill(toks[:, :P], source=src, max_seq=S)
    dec = [target.decode_step(cache, toks[:, t:t + 1],
                              torch.full((B,), t, device="cuda"))
           for t in range(P, S)]
    logits = target.forward(toks, source=src)[0]
    lengths = torch.full((B,), S, device="cuda")
    return {"prefill": pf, "decode": torch.stack(dec, dim=1),
            "forward": logits, "score": target.score(toks, source=src),
            "reward": prm.reward_at_end(toks, lengths, source=src)}


def cross_agreement(torch, label, cfgs, params):
    """llama-vision's or seamless's target and PRM at full width and depth
    on one batch of CROSS_AGREE's prompts over a seeded source: the calls
    of :func:`cross_calls` counted in bf16 (flash once per attention call
    of each full-sequence call, split into causal and non-causal launches;
    the gather once; the paged kernels never: decode here is dense), then
    held in fp32 activations over the same weights: prefill and decode
    logits to forward's, score to forward's log-softmax, the reward to the
    PRM's decode path; the bf16 gaps printed as the control that the fp32
    comparison is the one able to see a fault.  A second source must move
    forward's logits by far more than the tolerance, CROSS_TOL (a dropped
    cross layer would not).  Returns the launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.rewards import PRM
    B, P, T = CROSS_AGREE
    cfg = cfgs[1]
    V = cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(CROSS_SEED)
    toks = torch.randint(3, V, (B, P + T), generator=gen, device="cuda")
    src = cross_source(torch, cfg, B, CROSS_SEED)
    target = Model(cfg, params[1])
    prm = PRM(cfgs[2], params[2], device="cuda")
    flash = {True: 0, False: 0}
    dispatch = ops.flash_attention

    def split(q, k, v, *, causal=True, **kw):
        flash[bool(causal)] += 1
        return dispatch(q, k, v, causal=causal, **kw)

    wrappers = counters(torch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    ops.flash_attention = split
    t0 = time.perf_counter()
    try:
        out = cross_calls(torch, target, prm, toks, src)
        torch.cuda.synchronize()
    finally:
        ops.flash_attention = dispatch
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    per_call = kernel_layers(target, "flash_attention")
    want = 3 * per_call + kernel_layers(prm.model, "flash_attention")
    cross = target.kinds.count("cross")
    print(f"run {label}: {B} prompts of {P} tokens over a source of "
          f"{tuple(src.shape)}, {T} dense decode_steps, forward, score and "
          f"reward_at_end over {P + T} tokens (bf16): wall {wall:.2f} s; "
          f"kernel launches {launches}; flash per full-sequence call "
          f"{per_call} ({len(target.kinds)} self-attention, {cross} cross"
          f", {cfg.encoder_layers if cross else 0} encoder), 4 calls: want "
          f"{want}; flash causal {flash[True]}, non-causal {flash[False]}",
          flush=True)
    check(only(launches, flash_attention=want, logprob_gather=1)
          and flash[True] + flash[False] == want
          and flash[False] == 4 * (cross + cfg.encoder_layers),
          f"{label}: launches {launches}, flash causal {flash[True]} "
          f"non-causal {flash[False]}; want flash_attention = {want}, "
          f"logprob_gather = 1, no other kernel")
    for name, t in out.items():
        check(bool(torch.isfinite(t).all()), f"{label}: {name} not finite")
    check(out["score"].shape == (B, P + T - 1) and out["reward"].shape == (B,)
          and float(out["reward"].min()) >= 0
          and float(out["reward"].max()) <= 1,
          f"{label}: bad score or reward shapes, or rewards outside [0, 1]")

    def gaps(o):
        full = o["forward"][..., :V].float()
        lsm = torch.log_softmax(full[:, :-1], dim=-1).gather(
            -1, toks[:, 1:, None])[..., 0]
        return {"prefill": (o["prefill"][:, :V].float()
                            - full[:, P - 1]).abs().max().item(),
                "decode": (o["decode"][..., :V].float()
                           - full[:, P:]).abs().max().item(),
                "score": (o["score"] - lsm).abs().max().item()}

    bf16 = gaps(out)
    print(f"run {label} control (bf16 activations, the counted run): "
          f"prefill logits vs forward {bf16['prefill']:.5f}, decode steps "
          f"from the prefill cache vs forward {bf16['decode']:.5f}, score "
          f"vs forward's log-softmax {bf16['score']:.5f}; the agreement "
          f"below runs in float32 activations", flush=True)
    del out
    fp32 = [dataclasses.replace(c, dtype="float32") for c in cfgs]
    target = Model(fp32[1], params[1])
    prm = PRM(fp32[2], params[2], device="cuda")
    out = cross_calls(torch, target, prm, toks, src)
    err = gaps(out)
    _, cache = prm.model.prefill(toks[:, :-1], source=src, max_seq=P + T)
    _, h = prm.model.decode_step(cache, toks[:, -1:],
                                 torch.full((B,), P + T - 1, device="cuda"),
                                 return_hidden=True)
    err["reward"] = (out["reward"]
                     - prm.model.reward_from_hidden(h)).abs().max().item()
    del cache, h
    other = target.forward(toks, source=cross_source(
        torch, cfg, B, CROSS_SEED + 1))[0][..., :V]
    moved = (other - out["forward"][..., :V]).abs().max().item()
    full = out["forward"][..., :V]
    print(f"run {label} (float32 activations over the bf16 weights): "
          f"prefill last-token logits vs forward max_abs_err="
          f"{err['prefill']:.2e}, {T} decode steps from the prefill cache "
          f"vs forward {err['decode']:.2e}, logits in "
          f"[{full.min().item():.2f}, {full.max().item():.2f}]; score vs "
          f"forward's log-softmax {err['score']:.2e}; reward_at_end vs the "
          f"PRM's decode path {err['reward']:.2e}, rewards "
          f"{[round(x, 4) for x in out['reward'].tolist()]} (tol "
          f"{CROSS_TOL:.0e} each); control: a second source moves "
          f"forward's logits by {moved:.4f} (required above "
          f"{10 * CROSS_TOL:.0e})", flush=True)
    for what, e in err.items():
        check(e <= CROSS_TOL, f"{label}: {what} error {e} > {CROSS_TOL}")
    check(moved > 10 * CROSS_TOL, f"{label}: a second source moved the "
          f"logits by only {moved}")
    del out, other, target, prm, src
    release(torch)
    return launches


def phase_cross(torch):
    """The cross-attention families at full width and depth, each one
    model's shape as draft, target and PRM (seeded random bf16 weights):
    llama-3.2-vision-11b (run agree-vision, then gsi-vision) and, once
    those weights are freed, seamless-m4t-medium (agree-seamless,
    gsi-seamless and the train step t5 with a source).  The GSI runs serve
    text-only requests, as the reference's engine does, with seeded
    N(0, 1) cross KV written into each admitted slot (else zero, so every
    cross step would output 0) and a second seed's as the control.
    Returns the launches of each kernel over the runs."""
    print("== phase 4: the cross-attention families at full "
          "llama-3.2-vision-11b and seamless-m4t-medium width and depth",
          flush=True)
    import numpy as np
    from repro_torch.config import GSIConfig
    from repro_torch.data.lm import lm_batches
    from repro_torch.launch import serve
    from repro_torch.models import param_specs, random_params
    t_phase = time.perf_counter()
    g = GSIConfig(n=4, beta=20.0, temperature=0.7, max_step_tokens=16,
                  max_steps=2, min_step_reward=0.0)
    total = dict.fromkeys(("paged_attention", "logprob_gather",
                           "flash_attention", "flash_attention_bwd"), 0)
    for family in ("llama-vision", "seamless"):
        cfgs = serve.build_triple(family)
        c = cfgs[0]
        laid = sum(math.prod(s.shape) for s in param_specs(c).values())
        print(f"model {c.name}: layers={c.num_layers} pattern="
              f"{'/'.join(c.layer_pattern)} encoder_layers="
              f"{c.encoder_layers} source="
              f"{c.encoder_seq or c.cross_source_seq} d={c.d_model} heads="
              f"{c.num_heads}/{c.num_kv_heads} hd={c.head_dim} ffn="
              f"{c.d_ff} vocab={c.vocab_size} params~"
              f"{c.param_count() / 1e9:.2f}B (as laid out {laid / 1e9:.2f}B)"
              f", three of them (the PRM with a reward head)", flush=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = [random_params(c, i, "cuda") for i, c in enumerate(cfgs)]
        torch.cuda.synchronize()
        print(f"random bf16 weights of the {family} triple on the card: "
              f"{time.perf_counter() - t0:.1f} s; memory_allocated "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        agree = cross_agreement(torch, f"agree-{family}", cfgs, params)
        elapsed(f"run agree-{family}")
        acc = {}
        name = "gsi-vision" if family == "llama-vision" else "gsi-seamless"
        res = family_serve(torch, name, cfgs, params, g, acc,
                           cross_kv=CROSS_SEED)
        print(f"max_memory_allocated ({family} runs) "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        for k in total:
            total[k] += agree[k] + res["launches"][k]
        del params, res, acc
        release(torch)
        if family == "seamless":
            cfg = cfgs[0]
            batch = next(lm_batches(cfg.vocab_size, 4, 512, seed=0))
            rng = np.random.default_rng(CROSS_SEED)
            batch["source"] = rng.standard_normal(
                (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            t5 = train_run(torch, "t5", cfg, batch, lr=T1_LR,
                           steps=CROSS_TRAIN_STEPS)
            for k in ("flash_attention", "flash_attention_bwd"):
                total[k] += t5[k]
            elapsed("run t5")
        release(torch)
    print(f"phase_cross seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return total


def finished_sequences(torch, res):
    """Prompt plus committed tokens of every request of a run, PAD-padded
    into one (B, S) batch on the card, with their lengths and the shortest
    prompt's length."""
    import numpy as np
    seqs = [np.concatenate([p, res["responses"][rid].tokens]).astype(
        np.int64) for p, rid in zip(res["prompts"], res["ids"])]
    width = max(s.size for s in seqs)
    toks = np.zeros((len(seqs), width), np.int64)
    for i, s in enumerate(seqs):
        toks[i, :s.size] = s
    lengths = np.array([s.size for s in seqs])
    prompt = min(p.size for p in res["prompts"])
    return (torch.from_numpy(toks).cuda(), torch.from_numpy(lengths).cuda(),
            prompt)


def scoring_models(full, params):
    """The full-width triple over the weights already on the card (no
    copy): draft and target models and the PRM."""
    from repro_torch.models import Model
    from repro_torch.rewards import PRM
    return (Model(full[0], params[0]), Model(full[1], params[1]),
            PRM(full[2], params[2], device="cuda"))


def scoring_batch(draft, target, prm, toks, lengths, prompt):
    """A scoring run's four full-sequence calls."""
    prefill = target.prefill(toks[:, :prompt], max_seq=prompt + 8)
    return (prefill, target.score(toks), draft.score(toks),
            prm.reward_at_end(toks, lengths))


def teacher_forced(torch, model, toks, *, keep=(), hidden_at=None,
                   state_at=None):
    """Feed ``toks`` one position at a time through paged ``decode_step``
    (the decode path: the paged kernel in every attention layer, the scan
    at T = 1 in every RWKV layer, from an empty cache, identity block
    table).  Returns the log-prob of each next token (B, S-1), the logits
    at the positions in ``keep`` (and, under ``"state"``, a copy of every
    layer's cache right after position ``state_at``), and the final hidden
    state of row b at position ``hidden_at[b]``."""
    B, S = toks.shape
    ps = 16
    nblk = -(-S // ps)
    cache = model.init_cache(B, S, pages=B * nblk, page_size=ps)
    pt = torch.arange(B * nblk, dtype=torch.int32,
                      device="cuda").reshape(B, nblk)
    vocab = model.cfg.vocab_size
    lp = torch.zeros((B, S - 1), device="cuda")
    kept, hid = {}, None
    rows = torch.arange(B, device="cuda")
    for t in range(S):
        pos = torch.full((B,), t, device="cuda")
        logits, h = model.decode_step(cache, toks[:, t:t + 1], pos,
                                      return_hidden=True, pt=pt)
        if t in keep:
            kept[t] = logits.float()
        if t == state_at:
            kept["state"] = [{k: v.clone() for k, v in layer.items()}
                             for layer in cache]
        if t + 1 < S:
            lsm = torch.log_softmax(logits[:, :vocab].float(), dim=-1)
            lp[:, t] = lsm[rows, toks[:, t + 1]]
        if hidden_at is not None:
            hid = h if hid is None else hid
            hid = torch.where((hidden_at == t)[:, None], h, hid)
    return lp, kept, hid


def phase_score(torch, run, full, params, served, kernel, *,
                agree_dtype=None, tols=(None, None, None)):
    """Run ``run``: the sequences a serving run finished (``served``),
    through the full-width full-depth target's prefill and score, the
    draft's score and the PRM's reward_at_end, with every launch counter
    zeroed just before and read just after: ``kernel`` (flash attention or
    the WKV6 scan) once per layer of its kind in each call
    (:func:`kernel_layers`), the gather once per score and nothing else.
    Then each result against the decode path on the card, held to ``tols``
    (log-probs, rewards, logits); with ``agree_dtype`` both sides of that
    comparison run again with activations of that dtype over the same
    weights, and the counted run's own gap must exceed the log-prob
    tolerance (the control that shows the comparison needs them)."""
    print(f"== phase 4: run {run} (full-sequence passes at full width)",
          flush=True)
    draft, target, prm = scoring_models(full, params)
    toks, lengths, prompt = finished_sequences(torch, served)
    B, S = toks.shape
    print(f"run {run}: {B} sequences of run {served['name']}, lengths "
          f"{lengths.tolist()}, padded to {S}; prefill of the first "
          f"{prompt} tokens (the shortest prompt)", flush=True)
    wrappers = counters(torch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    (pf_logits, pf_cache), lp_t, lp_d, r_end = scoring_batch(
        draft, target, prm, toks, lengths, prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    calls = {"target.prefill": kernel_layers(target, kernel),
             "target.score": kernel_layers(target, kernel),
             "draft.score": kernel_layers(draft, kernel),
             "prm.reward_at_end": kernel_layers(prm.model, kernel)}
    want = sum(calls.values())
    print(f"run {run}: wall {wall:.3f} s for the four calls; kernel "
          f"launches {launches}; {kernel} wanted = layers summed over the "
          f"full-sequence calls {calls} = {want}; logprob_gather wanted = 2"
          f" score calls", flush=True)
    check(only(launches, **{kernel: want, "logprob_gather": 2}),
          f"{run}: launches {launches}; want {kernel} = {want}, "
          f"logprob_gather = 2, no other kernel")
    for name, t in (("target.score", lp_t), ("draft.score", lp_d),
                    ("prm.reward_at_end", r_end),
                    ("target.prefill logits", pf_logits)):
        check(bool(torch.isfinite(t).all()), f"{run}: {name} not finite")
    check(lp_t.shape == (B, S - 1) and lp_d.shape == (B, S - 1)
          and r_end.shape == (B,) and float(r_end.min()) >= 0
          and float(r_end.max()) <= 1, f"{run}: bad output shapes or "
          f"rewards outside [0, 1]")

    live = torch.arange(S - 1, device="cuda")[None] < (lengths - 1)[:, None]
    lp_tol, reward_tol, logit_tol = tols
    if agree_dtype is not None:
        # control: the counted run's own target.score against the decode
        # path at the same activation dtype
        lp_ctrl, _, _ = teacher_forced(torch, target, toks)
        err_ctrl = (lp_t - lp_ctrl)[live].abs().max().item()
        print(f"{run} control ({target.cfg.dtype} activations, the counted "
              f"run): target.score log-probs vs the decode path "
              f"max_abs_err={err_ctrl:.5f} over {int(live.sum())} tokens; "
              f"the agreement below runs in {agree_dtype} activations, "
              f"where the log-prob tol is {lp_tol}", flush=True)
        check(math.isfinite(err_ctrl) and err_ctrl > lp_tol,
              f"{run} control: the {target.cfg.dtype} gap {err_ctrl} is "
              f"within {lp_tol}, so the comparison needs no "
              f"{agree_dtype} activations")
        del pf_cache
        draft, target, prm = scoring_models(
            [dataclasses.replace(c, dtype=agree_dtype) for c in full],
            params)
        (pf_logits, pf_cache), lp_t, lp_d, r_end = scoring_batch(
            draft, target, prm, toks, lengths, prompt)
    # the same functions through the decode path (paged attention or the
    # scan at T = 1, state carried in the cache)
    recurrent = target.kinds[0] in ("rwkv", "recurrent")
    lp_dec, kept, _ = teacher_forced(
        torch, target, toks, keep=(prompt - 1, prompt),
        state_at=prompt - 1 if recurrent else None)
    _, _, h_end = teacher_forced(torch, prm.model, toks,
                                 hidden_at=lengths - 1)
    r_dec = prm.model.reward_from_hidden(h_end)
    # (d) the state prefill leaves (the scan over T = prompt) against the
    # state decode carried to the same position (the scan at T = 1, written
    # into the cache step by step), read before a step moves it on; an
    # attention layer's dense prefill rows and its decode pages share no
    # leaf name and are not compared here
    state_errs = []
    for i, (got, want) in enumerate(zip(pf_cache, kept.get("state", ()))):
        for key in sorted(got.keys() & want.keys()):
            err = (got[key].float() - want[key].float()).abs().max().item()
            scale = max(want[key].float().abs().max().item(), 1.0)
            state_errs.append((i, key, err / scale))
    step = target.decode_step(pf_cache, toks[:, prompt:prompt + 1],
                              torch.full((B,), prompt, device="cuda"))
    V = full[1].vocab_size
    err_lp = (lp_t - lp_dec)[live].abs().max().item()
    err_r = (r_end - r_dec).abs().max().item()
    err_pf = (pf_logits[:, :V] - kept[prompt - 1][:, :V]).abs().max().item()
    err_step = (step[:, :V].float() - kept[prompt][:, :V]).abs().max().item()
    print(f"{run} vs the decode path on the same tokens "
          f"({target.cfg.dtype} activations): (a) "
          f"target.score log-probs max_abs_err={err_lp:.5f} (tol "
          f"{lp_tol}) over {int(live.sum())} tokens, log-probs in "
          f"[{lp_t[live].min().item():.2f}, {lp_t[live].max().item():.2f}]; "
          f"(b) prm.reward_at_end max_abs_err={err_r:.5f} (tol {reward_tol})"
          f", rewards {[round(x, 4) for x in r_end.tolist()]}; (c) prefill "
          f"last-token logits max_abs_err={err_pf:.5f}, one decode_step "
          f"from the prefill cache {err_step:.5f} (tol {logit_tol}), logits "
          f"in [{kept[prompt - 1][:, :V].min().item():.2f}, "
          f"{kept[prompt - 1][:, :V].max().item():.2f}]", flush=True)
    check(err_lp <= lp_tol, f"{run} (a): log-prob error {err_lp}")
    check(err_r <= reward_tol, f"{run} (b): reward error {err_r}")
    check(err_pf <= logit_tol and err_step <= logit_tol,
          f"{run} (c): prefill logits error {err_pf}, decode from the "
          f"prefill cache {err_step}")
    if state_errs:
        # layer 0 sees no depth amplification: 1e-4 of its scale
        first = {key: f"{e:.2e}" for i, key, e in state_errs if i == 0}
        worst = max(state_errs, key=lambda x: x[2])
        print(f"{run} (d): prefill state vs decode state after {prompt} "
              f"tokens, error / scale: layer 0 {first} (tol {TOY_RTOL}); "
              f"largest over the {len(pf_cache)} layers {worst[2]:.2e} "
              f"(layer {worst[0]} {worst[1]})", flush=True)
        check(all(e <= TOY_RTOL for i, _, e in state_errs if i == 0),
              f"{run} (d): layer 0 state differs: {first}")
    del pf_cache, draft, target, prm
    torch.cuda.empty_cache()
    return launches


def phase_profile_scoring(torch, full, params, gsi_res):
    """One score-prm batch under torch.profiler: wall and device busy
    time, the top device operations and the flash kernel's and the vocab
    gather's shares."""
    from torch.profiler import ProfilerActivity, profile
    print("== phase 5: where one score-prm batch's time goes", flush=True)
    draft, target, prm = scoring_models(full, params)
    toks, lengths, prompt = finished_sequences(torch, gsi_res)
    scoring_batch(draft, target, prm, toks, lengths, prompt)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scoring_batch(draft, target, prm, toks, lengths, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print("score-prm batch: device time not measured (the profiler saw "
              "no device activity)", flush=True)
        return
    busy = sum(r[0] for r in rows) / 1e6
    flash = sum(r[0] for r in rows if "flash_" in r[2]) / 1e6
    gather = sum(r[0] for r in rows if "logprob_" in r[2]) / 1e6
    print(f"score-prm batch: wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"device idle share {1 - busy / wall:.3f}, flash kernel "
          f"{flash * 1e3:.2f} ms = {100 * flash / busy:.1f}% of busy, "
          f"vocab gather (partials and merge) {gather * 1e3:.2f} ms = "
          f"{100 * gather / busy:.1f}% of busy", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / 1e3:10.2f} ms  {count:7d} calls  "
              f"{100 * dev_us / 1e6 / busy:5.1f}%  {key[:90]}", flush=True)


def device_rows(torch, prof):
    """(device us, calls, name) of every device-side event of a profile,
    and the device's busy seconds.  Host ops are not recorded: recording
    them slowed the host-bound step under the profiler and their
    processing took minutes per step."""
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return rows, sum(r[0] for r in rows) / 1e6


def phase_profile_pipelined(torch, cfgs, params, gcfg):
    """Two consecutive pipelined dispatches of the gsi configuration (4
    slots, n = 4, the prompts of phase_profile): the first ``step``
    admits and dispatches step 1 (a warm-up, then a synchronize); the
    profiled window is pump (materialize and retire step 1), dispatch
    step 2, and the pump that drains it (``flush``: step 1's harvest
    while step 2 runs, then step 2's materialize and harvest), so it
    holds one step's device work, as the lock-step profile does.  Prints
    the device's busy and idle share under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.serving import GSIScheduler, GSIServingEngine
    print("== phase 5: where a pipelined dispatch's time goes (gsi, "
          "sync=False)", flush=True)
    eng = GSIServingEngine(*cfgs, *params, gcfg, mode="gsi", max_seq=512,
                           device="cuda", paged=True, page_size=16)
    sched = GSIScheduler(eng, capacity=4, sync=False)
    for p in serve.random_prompts(4, seed=5, vocab=cfgs[0].vocab_size,
                                  lo=24, hi=72):
        sched.submit(p)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sched.step(gen)                          # admit and dispatch (warm-up)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step(gen)
        sched.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy = device_rows(torch, prof)
    check(sched.engine_steps == 2 and not sched.has_pending,
          f"pipelined profile: {sched.engine_steps} engine steps")
    print(f"pipelined pump, dispatch, pump (gsi): wall {wall:.3f} s, "
          f"device busy {busy:.3f} s, device "
          f"idle share {1 - busy / wall:.3f}; pipeline_stats "
          + fmt_stats(sched.pipeline_stats())
          if rows else "pipelined dispatches: device time not measured (the "
          "profiler saw no device activity)", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        print(f"  {dev_us / 1e3:10.2f} ms  {count:7d} calls  "
              f"{100 * dev_us / 1e6 / max(busy, 1e-12):5.1f}%  "
              f"{key[:90]}", flush=True)
    del sched, eng
    elapsed("the pipelined profile of gsi")


def phase_profile(torch, configs, gcfg):
    """One engine step (4 slots, n=4, prompts 24-72 tokens) of each
    configuration under torch.profiler: device time by kernel and the
    device's idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine
    for name, cfgs, params, kw in configs:
        print(f"== phase 5: where one engine step's time goes ({name})",
              flush=True)
        eng = GSIServingEngine(*cfgs, *params, gcfg, mode="gsi",
                               max_seq=512, device="cuda",
                               **{"paged": True, "page_size": 16, **kw})
        prompts = serve.random_prompts(4, seed=5, vocab=cfgs[0].vocab_size,
                                       lo=24, hi=72)
        width = max(p.size for p in prompts)
        packed = [list(p) + [0] * (width - p.size) for p in prompts]
        state = eng.admit(eng.fresh_state(4), np.ones(4, bool),
                          np.asarray(packed, np.int32))
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, _ = eng.step_decode(state, gen)       # warm-up step
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, res = eng.step_decode(state, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows, busy = device_rows(torch, prof)
        fell_back = not bool(res.accept.all())
        print(f"engine step ({name}): wall {wall:.3f} s, device busy "
              f"{busy:.3f} s, device idle share {1 - busy / wall:.3f} "
              f"(fallback ran: {fell_back})" if rows else
              "engine step: device time not measured (the profiler saw no "
              "device activity)", flush=True)
        for dev_us, count, key in sorted(rows, reverse=True)[:12]:
            print(f"  {dev_us / 1e3:10.2f} ms  {count:7d} calls  "
                  f"{100 * dev_us / 1e6 / max(busy, 1e-12):5.1f}%  "
                  f"{key[:90]}", flush=True)
        # each kernel row's device kernels: the paged kernels' split and
        # combine kernels count together, and the scan's one-step, ring
        # and fix-up kernels
        for kernel, names in (
                ("paged_attention", ("paged_attention_kernel",
                                     "paged_attention_combine_kernel")),
                ("paged_attention_quant", ("paged_attention_quant_",)),
                ("logprob_gather", ("logprob_",)),
                ("rwkv6_scan", ("rwkv6_step_kernel", "rwkv6_scan_kernel",
                                "rwkv6_scan_fixup_kernel"))):
            mine = [r for r in rows if any(n in r[2] for n in names)]
            if mine:
                us = sum(r[0] for r in mine)
                print(f"  {kernel}: {us / 1e3:.2f} ms over "
                      f"{sum(r[1] for r in mine)} device launches ("
                      + ", ".join(f"{n} {sum(r[1] for r in mine if n in r[2])}"
                                  for n in names)
                      + f") = {100 * us / 1e6 / max(busy, 1e-12):.1f}% of "
                      f"busy", flush=True)
        del eng, state
        elapsed(f"the profile of {name}")


def toy_serve(torch, cfgs, params, g, prompts, device, **kw):
    """Serve ``prompts`` on ``device``; tokens per request, accept rate and
    mean PRM reward."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine
    eng = GSIServingEngine(*cfgs, *[{k: t.to(device) for k, t in p.items()}
                                    for p in params], g, max_seq=96,
                           page_size=8, device=device, **kw)
    res = serve.serve(eng, prompts, capacity=2, seed=0)
    rw = np.concatenate([np.ravel(a) for a in res["stats"].raw_rewards])
    return ([res["responses"][r].tokens.tolist() for r in res["ids"]],
            res["accept_rate"], float(rw.mean()))


def phase_agreement(torch):
    """Toy fp32 triple at temperature 0: paged serving (the kernel) and
    dense serving (plain attention) commit the same tokens; int8 and fp8
    pages with shared scoring commit on the card what they commit on the
    CPU (or, should an upstream last-ulp difference move one code across a
    rounding boundary, stay within the reference's quantized-drift bounds:
    accept rate within 0.35, mean reward within 5%)."""
    print("== phase 4b: toy fp32 agreement on the card", flush=True)
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    cfgs = serve.toy_triple(vocab=64)
    params = [random_params(c, 10 + i, "cpu") for i, c in enumerate(cfgs)]
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
                  temperature=0.0, threshold_u=0.3, min_step_reward=-1.0)
    prompts = serve.random_prompts(5, seed=3, vocab=64, lo=3, hi=20)
    paged = toy_serve(torch, cfgs, params, g, prompts, "cuda", paged=True)
    dense = toy_serve(torch, cfgs, params, g, prompts, "cuda", paged=False)
    same = paged[0] == dense[0]
    print(f"toy paged vs dense: {len(paged[0])} requests, "
          f"{sum(map(len, paged[0]))} tokens, identical={same}", flush=True)
    check(same, "paged and dense serving committed different tokens")
    from repro_torch.kernels.logprob_gather import logprob_gather_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_quant_cuda)
    # kv_dtype="bf16" under fp32 activations: fp32 queries over bf16 pages,
    # K and V widened in the kernel; the CPU promotes the same way
    before = paged_attention_cuda.launches
    card = toy_serve(torch, cfgs, params, g, prompts, "cuda", paged=True,
                     kv_dtype="bf16")
    launched = paged_attention_cuda.launches - before
    cpu = toy_serve(torch, cfgs, params, g, prompts, "cpu", paged=True,
                    kv_dtype="bf16")
    same = card[0] == cpu[0]
    print(f"toy bf16 pages under fp32 activations, card vs CPU: "
          f"{sum(map(len, card[0]))} tokens, identical={same}, accept "
          f"{card[1]:.3f} vs {cpu[1]:.3f}, paged_attention launches "
          f"{launched}", flush=True)
    check(launched > 0, "toy bf16 pages: the card run did not launch the "
          "paged kernel")
    check(same, "toy bf16 pages: card and CPU committed different tokens")
    for kv in ("int8", "fp8"):
        kw = dict(paged=True, kv_dtype=kv, shared_scoring=True)
        before = (paged_attention_quant_cuda.launches,
                  logprob_gather_cuda.launches)
        card = toy_serve(torch, cfgs, params, g, prompts, "cuda", **kw)
        check(paged_attention_quant_cuda.launches > before[0]
              and logprob_gather_cuda.launches > before[1],
              f"toy {kv}: the card run did not launch both kernels")
        cpu = toy_serve(torch, cfgs, params, g, prompts, "cpu", **kw)
        same = card[0] == cpu[0]
        print(f"toy {kv} shared scoring, card vs CPU: "
              f"{sum(map(len, card[0]))} tokens, identical={same}, accept "
              f"{card[1]:.3f} vs {cpu[1]:.3f}, mean reward {card[2]:.6f} vs "
              f"{cpu[2]:.6f}", flush=True)
        if not same:
            check(abs(card[1] - cpu[1]) <= 0.35
                  and abs(card[2] - cpu[2]) <= 0.05 * max(abs(cpu[2]), 1e-3),
                  f"toy {kv}: tokens differ and the drift exceeds the bounds")
            print(f"toy {kv}: tokens differ; accept and reward drift within "
                  f"the bounds", flush=True)


def phase_agreement_full(torch):
    """Toy fp32 models: forward, score, prefill (logits and caches) and the
    PRM's rewards on the card (the flash kernel in every layer, head_dim 16
    and 40, and a full/local stack whose window 8 is shorter than S) match
    the same calls on the CPU (plain versions)."""
    print("== phase 4b: toy full-sequence passes, card vs CPU", flush=True)
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import serve
    from repro_torch.models import Model, random_params
    from repro_torch.rewards import PRM
    draft, target, prm_cfg = serve.toy_triple(vocab=64)
    stack = dataclasses.replace(draft, name="sx-full-local", num_layers=3,
                                layer_pattern=("full", "local"),
                                window_size=8)
    toks = np.random.default_rng(4).integers(3, 64, (3, 77))
    lengths = np.array([77, 40, 9])

    def close(tag, got, want):
        want = want.float()
        err = (got.float().cpu() - want).abs().max().item()
        scale = max(want.abs().max().item(), 1.0)
        print(f"toy {tag}: max_abs_err={err:.3e} (tol {TOY_RTOL:.0e} x "
              f"{scale:.2f})", flush=True)
        check(err <= TOY_RTOL * scale, f"toy {tag}: card and CPU differ")

    for i, cfg in enumerate((draft, target, stack, prm_cfg)):
        params = random_params(cfg, 20 + i, "cpu")
        cpu, card = Model(cfg, params), Model(cfg, params, device="cuda")
        tc, tg = torch.from_numpy(toks), torch.from_numpy(toks).cuda()
        before = flash_attention_cuda.launches
        tag = f"{cfg.name} (hd {cfg.head_dim}, {cfg.layer_pattern})"
        V = cfg.vocab_size                # padded columns hold -1e30
        close(f"{tag} forward", card.forward(tg)[0][..., :V],
              cpu.forward(tc)[0][..., :V])
        close(f"{tag} score", card.score(tg), cpu.score(tc))
        lg, cache = card.prefill(tg[:, :50], max_seq=64)
        lc, cache_c = cpu.prefill(tc[:, :50], max_seq=64)
        close(f"{tag} prefill logits", lg[:, :V], lc[:, :V])
        close(f"{tag} prefill caches",
              torch.cat([c[k].flatten() for c in cache for k in "kv"]),
              torch.cat([c[k].flatten() for c in cache_c for k in "kv"]))
        if cfg.reward_head:
            got = PRM(cfg, params, device="cuda").reward_at_end(tg, lengths)
            want = PRM(cfg, params, device="cpu").reward_at_end(tc, lengths)
            close(f"{tag} reward_at_end", got, want)
        torch.cuda.synchronize()
        check(flash_attention_cuda.launches - before
              >= 3 * cfg.num_layers, f"toy {tag}: the flash kernel did not "
              f"run in every layer")


def phase_agreement_rwkv(torch):
    """The toy RWKV triple in fp32 (decays overwritten so the state
    carries): served at temperature 0 on the card, dense and paged (with
    shared scoring), it commits the CPU's tokens; the toy target's and
    PRM's forward, score, prefill (logits and state leaves) and rewards on
    the card match the CPU."""
    print("== phase 4b: toy RWKV triple, card vs CPU", flush=True)
    import numpy as np
    from repro_torch.config import GSIConfig
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    from repro_torch.launch import serve
    from repro_torch.models import Model, random_params
    from repro_torch.rewards import PRM
    cfgs = toy_rwkv_triple()
    params = [random_params(c, 30 + i, "cpu") for i, c in enumerate(cfgs)]
    for i, p in enumerate(params):
        carry_decays(torch, p, 60 + i)
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
                  temperature=0.0, threshold_u=TOY_RWKV_THRESHOLD,
                  min_step_reward=-1.0)
    prompts = serve.random_prompts(5, seed=3, vocab=64, lo=3, hi=20)
    for kw in ({"paged": False}, {"paged": True, "shared_scoring": True}):
        before = rwkv6_scan_cuda.launches
        card = toy_serve(torch, cfgs, params, g, prompts, "cuda", **kw)
        check(rwkv6_scan_cuda.launches > before,
              f"toy RWKV {kw}: the card run did not launch the scan")
        cpu = toy_serve(torch, cfgs, params, g, prompts, "cpu", **kw)
        same = card[0] == cpu[0]
        print(f"toy RWKV {kw}, card vs CPU: {sum(map(len, card[0]))} "
              f"tokens, identical={same}, accept {card[1]:.3f} vs "
              f"{cpu[1]:.3f}, mean reward {card[2]:.6f} vs {cpu[2]:.6f}",
              flush=True)
        check(same, f"toy RWKV {kw}: card and CPU committed different "
              f"tokens")

    def close(tag, got, want):
        want = want.float()
        err = (got.float().cpu() - want).abs().max().item()
        scale = max(want.abs().max().item(), 1.0)
        print(f"toy RWKV {tag}: max_abs_err={err:.3e} (tol {TOY_RTOL:.0e} "
              f"x {scale:.2f})", flush=True)
        check(err <= TOY_RTOL * scale, f"toy RWKV {tag}: card and CPU "
              f"differ")

    toks = np.random.default_rng(4).integers(3, 64, (3, 77))
    lengths = np.array([77, 40, 9])
    tc, tg = torch.from_numpy(toks), torch.from_numpy(toks).cuda()
    for cfg, p in zip(cfgs[1:], params[1:]):
        cpu, card = Model(cfg, p), Model(cfg, p, device="cuda")
        V = cfg.vocab_size
        before = rwkv6_scan_cuda.launches
        close(f"{cfg.name} forward", card.forward(tg)[0][..., :V],
              cpu.forward(tc)[0][..., :V])
        close(f"{cfg.name} score", card.score(tg), cpu.score(tc))
        lg, state = card.prefill(tg[:, :50])
        lc, state_c = cpu.prefill(tc[:, :50])
        close(f"{cfg.name} prefill logits", lg[:, :V], lc[:, :V])
        for key in state[0]:
            close(f"{cfg.name} prefill state {key}",
                  torch.cat([c[key].flatten() for c in state]),
                  torch.cat([c[key].flatten() for c in state_c]))
        if cfg.reward_head:
            close(f"{cfg.name} reward_at_end",
                  PRM(cfg, p, device="cuda").reward_at_end(tg, lengths),
                  PRM(cfg, p, device="cpu").reward_at_end(tc, lengths))
        torch.cuda.synchronize()
        check(rwkv6_scan_cuda.launches - before >= 3 * cfg.num_layers,
              f"toy RWKV {cfg.name}: the scan did not run in every layer")


# phase 6, training: steps of (t1) and (t2), each on one fixed batch, and
# their peak learning rates.  Adam's first steps move every weight by
# about the rate: at 1e-3 the 2B-parameter PRM's rewards saturated in one
# step (loss 0.84 -> 5.7 in a chip run) and the draft's loss rose before
# it fell.  bf16 weights of std ~0.02 move only by steps above half an
# ulp (~6e-5): t1 takes 1e-4; t2's uniform random labels leave nothing
# to learn but their mean, so it takes 1e-5 (the zero-initialised head
# bias and the smallest weights move)
TRAIN_STEPS = 4
T1_LR, T2_LR = 1e-4, 1e-5
# (t4): the toy triple trained as the serving CLI's --train-steps does
TOY_TRAIN_STEPS = 300
# (t4) serves its trained toy triple at the reference CLI's threshold
TOY_SERVE_THRESHOLD = 0.5


def train_run(torch, tag, cfg, batch, *, lr, prm=False, seed=0,
              steps=TRAIN_STEPS, prepare=None):
    """``steps`` steps of a fresh :class:`Trainer` (seeded random bf16
    weights, ``prepare(params)`` applied to them under no_grad when given,
    fp32 AdamW state, peak rate ``lr``, warmup 1) on one fixed batch (with
    a ``source`` for a cross stack), with every launch counter zeroed just
    before and read just after; prints the losses, the step time and the
    memory, checks the losses are finite and fall and that flash's forward
    and backward each launched once per attention call of a step and the
    WKV6 scan's forward and backward once per RWKV layer of a step
    (:func:`kernel_layers`) times ``steps``, nothing else, and returns the
    launches."""
    from repro_torch.config import TrainConfig
    from repro_torch.train import Trainer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainConfig(learning_rate=lr, warmup_steps=1,
                                  total_steps=steps, seed=seed),
                 prm=prm, device="cuda")
    if prepare is not None:
        with torch.no_grad():
            prepare(tr.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tr.params.values())
    print(f"run {tag}: {cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"ffn={cfg.d_ff} vocab={cfg.vocab_size}: {n_params / 1e9:.3f}B "
          f"{cfg.param_dtype} parameters and fp32 AdamW state, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wrappers = counters(torch)
    for fn in wrappers.values():
        fn.launches = 0
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.step(batch)
        losses.append(float(m["loss"]))          # synchronizes the device
        secs.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    B, S = batch["tokens"].shape
    tokens = B * (S - 1)
    step_s = sum(secs[1:]) / (len(secs) - 1)
    print(f"run {tag}: B={B} S={S} losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad norm "
          f"{float(m['grad_norm']):.4f}; step seconds "
          f"{', '.join(f'{x:.4f}' for x in secs)} (first includes its "
          f"warm-up); steady step {step_s:.4f} s, {tokens / step_s:.1f} "
          f"tokens/s (training); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; kernel "
          f"launches {launches}", flush=True)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{tag}: losses {losses} not finite and falling")
    flash = kernel_layers(tr.model, "flash_attention") * steps
    scan = kernel_layers(tr.model, "rwkv6_scan") * steps
    check(only(launches, flash_attention=flash, flash_attention_bwd=flash,
               rwkv6_scan=scan, rwkv6_scan_bwd=scan),
          f"{tag}: launches {launches}; want flash_attention = "
          f"flash_attention_bwd = attention calls x steps = {flash}, "
          f"rwkv6_scan = rwkv6_scan_bwd = RWKV layers x steps = {scan}, no "
          f"other kernel")
    del tr, m
    torch.cuda.empty_cache()
    return launches


def toy_train_agreement(torch):
    """(t3) The toy fp32 triple trained for 3 steps on the card and on the
    CPU from the same weights and batches: losses within TOY_RTOL of their
    scale, parameters too, plus 5% of the summed learning rates (Adam's
    m / sqrt(v) turns rounding differences in near-zero gradients into
    step-sized ones)."""
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticReasoningTask
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    from repro_torch.train import Trainer
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=20, total_steps=600)
    for i, cfg in enumerate(serve.toy_triple()):
        prm = bool(cfg.reward_head)
        task = SyntheticReasoningTask(seed=40 + i)
        batches = [task.prm_batch(32, 64) if prm else task.lm_batch(32, 64)
                   for _ in range(3)]
        params = random_params(cfg, 50 + i, "cpu")
        before = flash_attention_bwd_cuda.launches
        runs = []
        for dev in ("cuda", "cpu"):
            tr = Trainer(cfg, tcfg, prm=prm, params=params, device=dev)
            hist = tr.fit(iter(batches), 3, log_every=1)
            runs.append(([h["loss"] for h in hist], tr.params))
        (card_l, card_p), (cpu_l, cpu_p) = runs
        check(flash_attention_bwd_cuda.launches - before
              == 3 * cfg.num_layers, f"toy {cfg.name}: the backward kernel "
              f"did not run once per layer and step")
        loss_err = max(abs(a - b) for a, b in zip(card_l, cpu_l))
        loss_scale = max(max(abs(x) for x in cpu_l), 1.0)
        slack = 0.05 * sum(float(tr.opt.lr_fn(n)) for n in (1, 2, 3))
        worst = 0.0
        for k, p in cpu_p.items():
            err = (card_p[k].detach().cpu() - p.detach()).abs().max().item()
            scale = max(p.detach().abs().max().item(), 1.0)
            worst = max(worst, err / (TOY_RTOL * scale + slack))
        print(f"run t3 {cfg.name} ({'prm_loss' if prm else 'lm_loss'}), "
              f"card vs CPU over 3 steps: losses "
              f"{', '.join(f'{x:.6f}' for x in card_l)} vs "
              f"{', '.join(f'{x:.6f}' for x in cpu_l)}, max error "
              f"{loss_err:.3e} (tol {TOY_RTOL:.0e} x {loss_scale:.2f}); "
              f"parameters at {worst:.3f} of their tolerance", flush=True)
        check(loss_err <= TOY_RTOL * loss_scale,
              f"t3 {cfg.name}: card and CPU losses differ")
        check(worst <= 1.0, f"t3 {cfg.name}: card and CPU parameters "
              f"differ")


def toy_train_serve(torch):
    """(t4) The serving CLI's --train-steps path on the card: the toy
    triple trained on the synthetic task by ``train_triple``, then GSI
    serving of task problems through the scheduler (the reference CLI's
    task settings)."""
    import numpy as np
    from repro_torch.config import GSIConfig
    from repro_torch.data import SyntheticReasoningTask
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.launch import serve
    from repro_torch.serving import GSIServingEngine
    task = SyntheticReasoningTask(seed=0)
    cfgs = serve.toy_triple()
    before = flash_attention_bwd_cuda.launches
    t0 = time.perf_counter()
    *params, hist = serve.train_triple(
        task, *cfgs, steps_draft=TOY_TRAIN_STEPS // 2,
        steps_target=TOY_TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    bwd = flash_attention_bwd_cuda.launches - before
    want = sum(c.num_layers * n for c, n in zip(
        cfgs, (TOY_TRAIN_STEPS // 2, TOY_TRAIN_STEPS, TOY_TRAIN_STEPS)))
    for cfg, h in zip(cfgs, hist):
        print(f"run t4: trained {cfg.name} for {h[-1]['step'] + 1} steps: "
              f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}", flush=True)
        check(h[-1]["loss"] < h[0]["loss"], f"t4 {cfg.name}: loss did not "
              f"fall")
    print(f"run t4: training {train_s:.1f} s, flash_attention_bwd launches "
          f"{bwd} (layers x steps {want})", flush=True)
    check(bwd == want, f"t4: {bwd} backward launches, want {want}")
    g = GSIConfig(n=4, beta=20.0, threshold_u=TOY_SERVE_THRESHOLD,
                  max_step_tokens=8, max_steps=8)
    engine = GSIServingEngine(*cfgs, *params, g, device="cuda", max_seq=128,
                              paged=True, page_size=16)
    problems = [task.sample_problem() for _ in range(16)]
    res = serve.serve(engine, [np.asarray(p.prompt, np.int32)
                               for p in problems], capacity=8, seed=1)
    st = res["stats"]
    acc = serve.accuracy(task, problems, res)
    print(f"run t4: served {res['finished']}/{len(problems)} synthetic "
          f"problems at threshold {TOY_SERVE_THRESHOLD}: accuracy "
          f"{acc:.3f}, accept rate {res['accept_rate']:.3f} ({st.accepted} "
          f"of {st.decisions} decisions), engine steps {res['steps']}, "
          f"tokens/s {res['tokens_per_s']:.1f}", flush=True)
    check(res["finished"] == len(problems), "t4: not every request finished")
    check(0 < st.accepted < st.decisions, f"t4: {st.accepted} of "
          f"{st.decisions} decisions accepted; the run must take both "
          f"branches")


# runs t6-t10: the other families at full width, 3 steps each on one fixed
# batch at t1's rate; each at the depth that fits one card beside its
# fp32 AdamW state (12 bytes a parameter: bf16 weight and gradient, fp32 m
# and v) and the optimizer's fp32 temporaries of the largest weight (six
# of recurrentgemma's 1.05e9-entry embedding are about 23.5 GiB: at 12
# layers t8 ran out of the card's memory in AdamW's update, 71.42 GiB
# allocated, H100 80GB HBM3, 700 W): (config name, layers (0: the
# published depth), batch, sequence)
FAMILY_TRAIN_STEPS = 3
FAMILY_RUNS = {"t6": ("rwkv6-3b", 0, 4, 512),
               "t7": ("gemma3-1b", 0, 2, 1024),
               "t8": ("recurrentgemma-9b", 9, 2, 1024),
               "t9": ("qwen2-moe-a2.7b", 4, 4, 512),
               "t10": ("llama-3.2-vision-11b", 10, 2, 512)}
FAMILY_SEED = 12


def family_train(torch):
    """Runs t6-t10 (``FAMILY_RUNS``) through :func:`train_run`: rwkv6-3b
    with every decay overwritten (:func:`carry_decays`) so that the WKV
    state carries, the Gemma families' head_dim 256 (gemma3's window of
    512 binds at S 1024 in its 22 local layers; recurrentgemma's ``lam``
    overwritten by :func:`carry_lru`), the MoE target and llama-vision
    with a seeded N(0, 1) source of 6,404 patch embeddings.  Returns the
    launches summed over the runs."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.data.lm import lm_batches
    total = {}
    for tag, (name, layers, B, S) in FAMILY_RUNS.items():
        full = get_config(name)
        cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
        if layers:
            print(f"reduced: run {tag} cuts {name} to {layers} layers "
                  f"(published {full.num_layers}): at full depth its "
                  f"{full.param_count() / 1e9:.2f}B parameters x 12 B of "
                  f"bf16 weight and gradient and fp32 AdamW state are "
                  f"{full.param_count() * 12 / 2 ** 30:.1f} GiB, more than "
                  f"the card's 80 GB beside the activations and AdamW's "
                  f"fp32 temporaries; at {layers} "
                  f"{cfg.param_count() * 12 / 2 ** 30:.1f} GiB; widths "
                  f"unchanged", flush=True)
        print(f"run {tag}: {name} at {cfg.num_layers} layers, pattern "
              f"{'/'.join(cfg.layer_pattern)}, "
              f"{cfg.param_count() / 1e9:.3f}B parameters by param_count, "
              f"about {cfg.param_count() * 12 / 2 ** 30:.1f} GiB of weights, "
              f"gradients and AdamW state; B {B} x S {S}", flush=True)
        batch = next(lm_batches(cfg.vocab_size, B, S, seed=FAMILY_SEED))
        prepare = None
        if name == "rwkv6-3b":
            def prepare(params):
                lo, hi = carry_decays(torch, params, FAMILY_SEED)
                print(f"run t6: decay_base overwritten, base decays in "
                      f"[{lo:.4f}, {hi:.4f}]", flush=True)
        if name == "recurrentgemma-9b":
            def prepare(params):
                lo, hi = carry_lru(torch, params, FAMILY_SEED)
                print(f"run t8: lam overwritten, a at r = 0.5 in "
                      f"[{lo:.4f}, {hi:.4f}]", flush=True)
        if cfg.cross_source_seq:
            rng = np.random.default_rng(FAMILY_SEED)
            batch["source"] = rng.standard_normal(
                (B, cfg.cross_source_seq, cfg.d_model)).astype(np.float32)
        got = train_run(torch, tag, cfg, batch, lr=T1_LR,
                        steps=FAMILY_TRAIN_STEPS, prepare=prepare)
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        release(torch)
        elapsed(f"run {tag}")
    return total


def family_train_agreement(torch):
    """Runs t3-rwkv and t3-gemma3: a reduced rwkv6-3b at head_dim 64
    (decays overwritten) and a reduced gemma3-1b at head_dim 256 (windows
    of 8 that S 64 crosses), fp32, trained for 3 steps on the card and on
    the CPU from the same weights and batches, held as run t3 holds the
    toy triple: losses within TOY_RTOL of their scale, parameters too plus
    5% of the summed learning rates; the family's backward kernel launched
    once per layer and step."""
    from repro_torch.config import TrainConfig, get_config, reduced_config
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_cuda
    from repro_torch.models import random_params
    from repro_torch.train import Trainer
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=20, total_steps=600)
    rwkv = dataclasses.replace(reduced_config(get_config("rwkv6-3b")),
                               num_heads=2, rwkv_head_dim=64)
    gemma = dataclasses.replace(
        reduced_config(get_config("gemma3-1b")), num_layers=3,
        layer_pattern=("local", "local", "full"), window_size=8, d_model=64,
        num_heads=4, num_kv_heads=1, head_dim=256, d_ff=96)
    for tag, cfg, kernel in (("t3-rwkv", rwkv, rwkv6_scan_bwd_cuda),
                             ("t3-gemma3", gemma, flash_attention_bwd_cuda)):
        batches = [next(lm_batches(cfg.vocab_size, 8, 64, seed=60 + i))
                   for i in range(3)]
        params = random_params(cfg, 61, "cpu")
        if tag == "t3-rwkv":
            carry_decays(torch, params, 62)
        before = kernel.launches
        runs = []
        for dev in ("cuda", "cpu"):
            tr = Trainer(cfg, tcfg, params=params, device=dev)
            hist = tr.fit(iter(batches), 3, log_every=1)
            runs.append(([h["loss"] for h in hist], tr.params))
        (card_l, card_p), (cpu_l, cpu_p) = runs
        check(kernel.launches - before == 3 * cfg.num_layers,
              f"{tag}: the backward kernel did not run once per layer and "
              f"step")
        loss_err = max(abs(a - b) for a, b in zip(card_l, cpu_l))
        loss_scale = max(max(abs(x) for x in cpu_l), 1.0)
        slack = 0.05 * sum(float(tr.opt.lr_fn(n)) for n in (1, 2, 3))
        worst = 0.0
        for k, p in cpu_p.items():
            err = (card_p[k].detach().cpu() - p.detach()).abs().max().item()
            scale = max(p.detach().abs().max().item(), 1.0)
            worst = max(worst, err / (TOY_RTOL * scale + slack))
        hd = cfg.rwkv_head_dim if tag == "t3-rwkv" else cfg.head_dim
        print(f"run {tag} {cfg.name} (d {cfg.d_model}, {cfg.num_layers} "
              f"layers, hd {hd}, fp32), card vs CPU over 3 steps: losses "
              f"{', '.join(f'{x:.6f}' for x in card_l)} vs "
              f"{', '.join(f'{x:.6f}' for x in cpu_l)}, max error "
              f"{loss_err:.3e} (tol {TOY_RTOL:.0e} x {loss_scale:.2f}); "
              f"parameters at {worst:.3f} of their tolerance", flush=True)
        check(loss_err <= TOY_RTOL * loss_scale,
              f"{tag}: card and CPU losses differ")
        check(worst <= 1.0, f"{tag}: card and CPU parameters differ")


def phase_train(torch):
    """Phase 6: training at full width, the toy triple and the reduced
    rwkv6 and gemma3 card against CPU, the serving CLI's train-then-serve
    path, and the other families' runs t6-t10."""
    print("== phase 6: training (the flash backward kernel in every "
          "attention layer)", flush=True)
    import numpy as np
    from repro_torch.configs import qwen25_math
    from repro_torch.data.lm import lm_batches
    t0 = time.perf_counter()
    dft = qwen25_math.DRAFT
    batch = next(lm_batches(dft.vocab_size, 4, 512, seed=0))
    t1 = train_run(torch, "t1", dft, batch, lr=T1_LR)
    elapsed("run t1")
    prm = dataclasses.replace(qwen25_math.PRM, num_layers=4)
    print(f"reduced: run t2 cuts {prm.name} to {prm.num_layers} layers "
          f"(published {qwen25_math.PRM.num_layers}): at full depth its "
          f"AdamW state alone, about 7.6e9 parameters x 12 B (fp32 m and v,"
          f" bf16 weight and gradient), is 91 GB, more than the card's "
          f"80 GB; widths unchanged", flush=True)
    rng = np.random.default_rng(1)
    toks = next(lm_batches(prm.vocab_size, 4, 512, seed=1))["tokens"]
    mask = np.zeros(toks.shape, np.float32)
    mask[:, 15::16] = 1.0                         # step ends every 16 tokens
    prm_batch = {"tokens": toks,
                 "reward_labels": rng.uniform(0, 1, toks.shape).astype(
                     np.float32),
                 "reward_mask": mask}
    t2 = train_run(torch, "t2", prm, prm_batch, lr=T2_LR, prm=True)
    elapsed("run t2")
    toy_train_agreement(torch)
    elapsed("run t3")
    family_train_agreement(torch)
    elapsed("runs t3-rwkv and t3-gemma3")
    toy_train_serve(torch)
    elapsed("run t4")
    families = family_train(torch)
    print(f"phase 6 seconds: {time.perf_counter() - t0:.1f}", flush=True)
    return {k: t1[k] + t2[k] + families.get(k, 0) for k in t1}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=QWEN_LAYERS,
                    help="depth of the bf16-page runs' three models (0 = "
                         "the published 28)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({src}); run from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    try:
        phase_device(torch)
        phase_build()
        rows = [phase_kernels(torch), phase_kernels_quant(torch),
                phase_kernels_logprob(torch), phase_kernels_flash(torch),
                phase_kernels_flash_bwd(torch), phase_kernels_rwkv(torch),
                phase_kernels_rwkv_bwd(torch)]
        phase_kernels_gemma(torch, rows)
        phase_kernels_gemma_bwd(torch, rows)
        phase_kernels_cross(torch, rows)
        elapsed("phases 1-3")
        launches = phase_main(torch, args.layers)
        release(torch)
        print(f"device memory after the Qwen phases: "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
              f"allocated", flush=True)
        elapsed("the Qwen runs")
        moe = phase_moe(torch)
        release(torch)
        print(f"paged_attention launches over its runs: Qwen2.5-Math "
              f"{launches['paged_attention']} + qwen2-moe "
              f"{moe['paged_attention']}", flush=True)
        launches["paged_attention"] += moe["paged_attention"]
        elapsed("the MoE runs")
        rwkv = phase_rwkv(torch)
        release(torch)
        elapsed("the RWKV runs")
        launches["rwkv6_scan"] = rwkv["rwkv6_scan"]
        launches["logprob_gather"] += rwkv["logprob_gather"]
        gemma = phase_gemma(torch)
        elapsed("the Gemma runs")
        print(f"launches over the Gemma runs: {gemma}", flush=True)
        for name, n in gemma.items():
            launches[name] += n
        cross = phase_cross(torch)
        elapsed("the cross-attention runs")
        print(f"launches over the cross-attention runs: {cross}", flush=True)
        phase_agreement(torch)
        phase_agreement_full(torch)
        phase_agreement_rwkv(torch)
        elapsed("phase 4b")
        train = phase_train(torch)
        launches["flash_attention"] += train["flash_attention"]
        launches["flash_attention_bwd"] = train["flash_attention_bwd"]
        launches["rwkv6_scan"] += train["rwkv6_scan"]
        launches["rwkv6_scan_bwd"] = train["rwkv6_scan_bwd"]
        print(f"flash_attention launches over its paths: score-prm and the "
              f"Gemma scoring runs "
              f"{launches['flash_attention'] - train['flash_attention']} + "
              f"training {train['flash_attention']} + the cross-attention "
              f"runs {cross['flash_attention']} (t5 "
              f"{cross['flash_attention_bwd']} of them)", flush=True)
        for name, n in cross.items():
            launches[name] += n
        for row in rows:
            row["launches"] = launches[row["name"]]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke seconds: {time.perf_counter() - T0:.1f}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
