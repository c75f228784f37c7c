#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases, each fatal on failure (exit code 1, no result line):
  1. card and build: the card's name and power limit, torch/CUDA
     versions, the build of every kernel from ``src/repro_torch/csrc``,
     and a structural check of the SASS (``cuobjdump -sass``) of the five
     kernels, all tile_kernel instances (#2 and #4, which share a
     library, told apart by their output type): asynchronous
     global->shared copies and a wait on them in every 16-byte instance,
     and int8 tensor-core MMAs (IMMA) in every instance;
  2. kernels: each hand-written kernel against its plain PyTorch version
     on the card, bit-exact, at the smollm-135m layer shapes and every M
     the later phases give it (#3 also against #2, at nbuf 2 and 3), and
     on the very inputs it is timed on, and also at ragged shapes that
     cut across the tile kernels' K split and column tiles, and #2, #3
     and #4 on plane pairs whose bits overlap (read as pos - neg = 0),
     #2 also on unaligned planes (its byte-copy instance);
     the device time per call (CUDA-graph replay, weights rotated through
     more memory than the L2 cache holds) at decode M=4, for #1 and #5
     also at prefill M=64, for #4 at M=128 with #1 beside it at M=128,
     the plain version's time, the bound, #3's time against #2's on the
     same planes, and for #5 the time of one PyTorch matmul computing
     the same function;
  3. serving: the port's ContinuousBatcher on full-size smollm-135m
     (seeded random weights, 4 slots, s_max 256, 8 requests), its decode
     step one captured CUDA graph and its prefill one per bucket, with
     kernel #1's launch count = 210 x (decode steps + prefill batches)
     and 210 in every fill batch, every fill after a bucket's first a
     replay; the same requests through the same batcher with its graphs
     switched off (eager), whose tokens must equal the captured ones and
     whose caches after the first fill must equal them bit for bit (every
     batcher phase below checks the same); both decode-step medians, both
     prefill times per fill batch, both tok/s, the capture times and the
     pool bytes; and one replayed and one eager decode step under
     torch.profiler (device-busy time over the device rows, #1's, busy
     over the unprofiled median);
  4. token identity: the captured batcher against the port's
     generate(), greedy, under act_scale="per_row" (here and in every
     later identity check, requests of at most 6 new tokens);
  5. stored planes: a prepare_weights=True batcher under
     blocked/cuda/bitplane_u8, then execute_packed on its planes for every
     quantized weight of 2 layers at M=4 and M=128 == execute on the
     folded ternary weights, through the packed kernels;
  6. the near-memory baseline: the batcher under exact/cuda on phase 3's
     requests, captured and eager as in phase 3, kernel #5's launch count
     = 210 x (decode steps + prefill batches) with #1 not launched, a
     profiled replay and eager step (#5's device time), and captured ==
     generate() under act_scale="per_row";
  7. streaming stored planes: a prepare_weights=True batcher under
     blocked/cuda_stream/bitplane_u8 (planes stored in layout 1), then
     execute_packed under the blocked and exact stream specs for every
     quantized weight of layers 0 and 29 at M in {1, 4, 8, 128} == the
     */cuda/bitplane_u8 specs == execute on the folded weights (#1/#5),
     with kernel #3 (and #4 at M=128) launched; #4's launch count in the
     kernels line is that of phases 5 and 7 together;
  8. capacity: a captured batcher (2 slots, s_max 16, per_row) over a mix
     in which one request fills its slot to s_max while another still
     decodes (the freed slot rides on as a dead lane); the reference's
     token counts and truncation flags, tokens == generate(), no device
     assert;
  9. quantized KV caches: phase 3's requests, captured and eager, under
     cache_dtype int8 and ternary (tokens equal, #1 launched 210 x
     steps), per_row batchers == generate() under the same cache_dtype,
     step medians and tok/s beside phase 3's, the cache bytes per slot;
 10. the looped baseline (fused=False, greedy, per_row, eager) over 4
     requests of at most 6 new tokens: tokens == generate(), one host sync per prefill and per
     active slot a step, its step median beside phase 3's;
 11. full-size starcoder2-7b (32 layers, d 4608, seeded random weights)
     with an int8 cache, captured and eager (tokens equal, #1 launched
     224 x steps): step median, tok/s, capture time, peak memory, and a
     profiled replayed step (device-busy time, #1's share). The
     kernel phase also bit-checks and times #1 and #5 at one
     starcoder2-7b layer's 7 shapes at M=4 ("starcoder2_7b" in the
     kernels line), #5 beside torch.mm;
 12. full-size mamba2-780m (48 layers, d 1536, seeded random weights,
     f32 SSM caches): phase 3's requests captured and eager (tokens
     equal, #1 launched 96 x steps: w_in and w_out of every layer, no
     other kernel), per_row batcher == generate(), step medians, tok/s,
     capture time, the SSM cache bytes per slot, peak memory and a
     profiled replayed step;
 13. full-size zamba2-2.7b (54 mamba layers, d 2560, the shared attention
     block every 6 layers), the same run under the bf16 and then the
     int8 KV cache (#1 launched 171 x steps: 2 x 54 + 7 x 9), both step
     medians side by side; then phase 8's capacity mix on zamba2 at smoke
     width through the captured step. The kernel phase bit-checks #1 at
     every (K, N) of phases 12 and 13 (N = 6448, 10448) at M in {1, 4,
     16, 64} and times it at one mamba2 and one zamba2 layer's two calls
     ("mamba2_780m", "zamba2_2_7b" in the kernels line);
 14. the moe family at full width, depth cut: deepseek-v2-236b (MLA, 160
     experts top-6 with 2 shared; 2 of its 60 layers) and grok-1-314b (GQA,
     8 experts top-2; 2 of its 64 layers), seeded random weights, the
     published widths checked against the config: 4 requests (4 slots,
     s_max 128, 1-16 prompt tokens, 8 new) captured and eager (tokens
     equal, #1 launched 6 and 4 x layers x steps, no other kernel, cache
     storage kept) under deepseek's bf16 and int8 MLA caches and grok's
     bf16 KV cache, the exact cache bytes per slot, the peak memory, the
     (token, expert) assignments a batched prefill drops under the
     config's capacity factor, a per_row batcher == generate() under the
     capacity factor n_experts / top_k (nothing drops), a profiled
     replayed step (busy, idle share, #1's share) and the same requests
     under mode "off". The kernel phase bit-checks #1 at every (K, N) of
     both at M in {1, 4, 16, 64} and times one layer's calls of each
     ("deepseek_v2_236b", "grok_1_314b" in the kernels line);
 15. (run after phase 16) full-size whisper-large-v3 (32 encoder and 32
     decoder layers, d 1280,
     nothing cut), seeded random weights and seeded frame embeddings (4,
     1500, 1280) for 4 requests: run_encoder (#1 launched 224 a run, the
     median of 3); a 4-row prompt of 8 tokens, 8 new each, through
     make_jit_serve_step(enc=) (captured) and serve_step (eager): tokens
     equal, #1 launched 352 in the prefill and every step (the cross K/V
     recomputed from enc each step, as in the reference) and nothing else,
     cache storage kept, the exact KV bytes per slot; generate(enc=) under
     per_row (6 new tokens), rows together == each alone; a profiled replayed step; the
     step under mode "off"; the batcher (no enc, as the reference's) on 4
     token requests, captured == eager;
 16. llava-next-34b at full width, 8 of its 60 layers (the whole model is
     69 GB in bf16): forward with seeded patches (1, 2880, 1024) and 16
     tokens (logits (1, 2896, 64000) finite, #1 launched 57 a run, the
     median of 3 and the peak memory), then phase 14's batcher checks
     under the bf16 KV cache. The kernel phase bit-checks #1 at both
     models' (K, N) (and llava's projector) at M in 1-16, 32, 64 and at
     the prefill-scale M in {1500, 1501, 2896, 2897}, whisper's also at
     {6000, 6001}, the projector's at 2880 (the plain version over row
     slices), and times one layer's calls of each at M=4 and at M=6000
     (whisper's encoder run) and M=2896 (llava's forward), against the
     bytes bound and the operations bound ("whisper_large_v3",
     "whisper_large_v3_prefill", "llava_next_34b", "llava_next_34b_prefill"
     in the kernels line);
 17. training: full-size smollm-135m (bf16, remat, the CiM spec)
     through the port's Trainer, whose step is make_jit_train_step's
     captured CUDA graph, for 20 steps at batch 8 x seq 128
     (seeded params, TokenPipeline seed 0, lr 3e-4 warmup_cosine(20, 20),
     checkpoints every 10 steps, a failure injected at step 15) under
     torch.use_deterministic_algorithms: losses and grad norms finite,
     the loss falling (last 5 steps' mean below the first 5's), steps
     0-4 bit-equal to 5 eager make_train_step steps from the same seed,
     one restart, the replayed steps 10-14 bit-equal to their first
     pass, #1 launched 420 times in every step through the replays (the
     forward's 210 dense layers and remat's recompute) and no other MAC
     kernel; one step under exact/cuda (#5 420 times); the captured and
     eager step medians and training tokens/s, the capture time, the
     checkpoint save time, the peak memory, a profiled replay (idle
     share), and the launcher's main() for 3 steps. The kernel phase
     bit-checks #1 and #5 at the training M in {1024, 1023} at the four
     (K, N) of its layers and times one layer's 7 calls of #1 at M=1024
     ("smollm_135m_train" in the kernels line);
 18. training the ssm and hybrid families: mamba2-780m at full width
     and 12 of 48 layers (bf16, remat, the CiM spec) through the Trainer
     as in phase 17 (20 steps, checkpoints every 10, a failure at 15), the
     phase leaving deterministic mode to Trainer.run(): losses and grad
     norms finite, the loss falling, steps 10-14 replayed bit-equal, #1
     launched 48 times in every step (24 forward + 24 remat) and no
     other MAC kernel, steps 0-4 bit-equal to 5 eager steps; one
     exact/cuda step (#5 48 times) and one under mode "off" (its grad
     norm), the captured and eager step medians, tokens/s, capture time,
     peak memory and a profiled replay; then full-size zamba2-2.7b: 3
     steps of make_jit_train_step, finite losses, #1 279 times a step
     (171 + 108: only the mamba layers sit under remat), step ms, capture
     time and peak memory. The kernel phase bit-checks #1 at M in {1024, 1023}
     at every (K, N) of phases 12 and 13 (#5 at mamba2's) and times one
     mamba2 and one zamba2 layer's calls at M=1024 ("mamba2_780m_train",
     "zamba2_2_7b_train" in the kernels line);
 19. the front door: full-size smollm-135m (per_row,
     blocked/cuda: #1 on every dense layer) behind the port's FrontDoor,
     2 replicas x 4 slots, s_max 256, both on the one card (their steps
     serialized by the device's lock), on 127.0.0.1 port 0, over real
     TCP, HTTP and WebSocket, built by the launcher's build_frontdoor:
     (a) phase 3's 8 requests streamed concurrently, each == the port's
     generate(); (b) one request cancelled after 2 tokens while another
     streams: the survivor exact, the cancelled one a greedy prefix; (c)
     a one-shot POST /v1/generate exact; (d) 12 requests at once (6
     WebSocket, 6 HTTP) against a queue limit of 4: at least one
     queue_full and one HTTP 429, the served ones exact; (e) /stats counts
     the completed, cancelled and rejected requests and reads in_flight 0,
     every replica has host_syncs == decode_steps + prefill_batches and
     replayed its decode graph, and #1 launched 210 x the decode steps and
     fill batches summed over the replicas (counts at 0 before (a)), no
     other kernel; then a warm pass of (a)'s requests after
     tracker.reset(): TTFT, per-token latency, queue wait and e2e at p50
     and p99 and goodput; (f) the same traffic through a door with a
     Profiler on a file, read back: one serve.decode_step event per decode
     step, one serve.prefill per fill batch, one frontdoor.request per
     request, tokens == (a)'s, the replayed steps' wall_us median beside
     phase 3's captured step median; (g) the launcher's
     main(["--serve-http", "--selftest", "--replicas", "2", "--port",
     "0"]) at full size;
 20. the hardware model and the calibrate -> replay loop:
     (a) eager execute / execute_packed calls under the profiler at
     smollm-135m's 4 layer (K, N) and M in {1, 2, 4, 8} and {64, 128, 512,
     1024}, a warm-up and 5 timed calls each, through blocked/cuda (#1),
     exact/cuda (#5), blocked/cuda/bitplane_u8 (#2 at decode M, #4 above)
     and blocked/cuda_stream/bitplane_u8 (#3, #4 above) on stored planes,
     fitted by profile.calibrate (fixed_us, us_per_mmac, us_per_mb,
     residual_pct per kernel and shape class); (b) phase 3's 8 requests
     through a profiled captured batcher of full-size smollm-135m (its
     tokens == phase 3's), the engine fit with the kernel model of (a),
     and a holdout run of 4 other requests replayed through simulate:
     decode steps, fills and tokens equal the holdout's, and the p50 step
     within 25% of the measured one; (c) hw.project of a 4-row decode of
     smollm-135m on each paper technology x CiM-I/CiM-II with the table:
     the analytic CiM time beside the fitted kernels' time, and the
     holdout replayed with its MACs in 8T-SRAM CiM-I arrays; (d) the tile
     sweep: autotune of blocked/cuda and exact/cuda at (4, 576, 1536) and
     (1024, 576, 1536) and of blocked/cuda_stream/bitplane_u8 at the
     first, every candidate grid bit-equal to the plain version and
     launched as installed, the winners against launch_plan's grid, the
     winners installed again from a calibration table without timing, a
     batcher captured with them giving phase 3's tokens, the cache
     cleared.
 21. tensor-parallel serving: launch.mesh.spawn_tp starts 3
     gloo ranks, every one on cuda:0 (the kernels already built); each
     probes which collectives gloo takes on CUDA tensors, then serves
     full-size smollm-135m on its shard (3 heads and 1 kv head, d_ff 512,
     vocab 16384) over phase 3's requests, eagerly, with the launch
     counts at 0 just before: tokens == phase 3's, #1 launched 210 x
     (steps + fills) in the rank, the row-parallel K shards (wo 192,
     w_down 512) whole blocks; the same under compress_tp on the same
     requests cut to 3 new tokens each (its greedy prefix against the
     exact path is printed), with one MAX all-reduce more per
     row-parallel layer and forward a step, and every row-parallel MAC
     of its first fill and step within ranks * amax/127 * 1.5 of the
     exact sum of the same partials and not equal to it; execute_tp through #1 at
     wo's and w_down's shapes (M 1, 4, 64, 128) and execute_packed_tp
     through #2/#4 and #3/#4 at (576, 1536) and (1536, 576) (M 4, 128),
     each bit-equal to execute / execute_packed on the same operands; and,
     on phase 3's requests through an exact TP batcher whose every fill
     also runs the compressed forward on copies of its fresh caches, each
     request's first-token top-2 logit margin beside the compressed
     logits' error there, and per row-parallel layer one rounding step
     (amax/127) over the median |partial|. A rank's failure or a run past
     TP_TIMEOUT_S fails the script; the eager TP step median is printed
     beside phase 3's eager step.
 22. the other families over 2 gloo ranks on cuda:0:
     mamba2-780m and zamba2-2.7b at full width and 6 of 48 and 54
     layers, whisper-large-v3 at full width and 4 of 32 layers (its
     decoder, as the batcher serves it; 10 of its 20 heads a rank),
     deepseek-v2-236b at full width and 1 of 60 layers and llava-next-34b
     (28 of 56 heads, 4 of 8 kv heads a rank) at full width and 2 of 60
     layers, first served single-device
     (eager) on phase 3's requests (request i at most 2, 3, 4 or 5 new
     tokens by i % 4, TP_FAMILY_MAX_NEW, so a fill lands beside live
     slots, which is checked), then in every rank, each rank making
     the seeded tree on the card in turn, holding it on the host and
     moving only its shard (whole SSM heads, MLA heads with the latent
     whole, whole experts, whisper's encoder and cross attention and
     llava's projector placed too; whisper and llava on phase 14's four
     requests): tokens == the single device's, #1
     launched macs_per_step x
     (steps + fills) and macs_per_step in every fill, a decode step's
     collectives at 2 slots those of each step and fill at 4 slots;
     mamba2-780m in mode "off"
     with its greedy prefix and largest first-fill logit difference
     against the single device printed; the eager TP step beside the
     eager single-device step, per family.
 23. the analysis contracts (repro_torch.analysis): the CLI
     ``python -m repro_torch.analysis --check --json`` in a subprocess
     beside the rest of the phase, exit 0 with every combination that
     skips on the CPU (the cuda and cuda_stream points) audited here;
     serve.fused_decode_step.cim's step at full size (phase 3's seeded
     params) on CUDA tensors at 4 and 8 slots: its contract's rules, 0
     host syncs, 0 host->device copies, one op count, #1 launched 210
     times a call and no other kernel; one eager step and one replay of
     it captured, under torch.cuda.set_sync_debug_mode("error"); and the
     contracts' SASS pins on the SASS phase 1 read (int8 tensor-core MMAs
     and no float ones in every instance of #2 and #3, #3's asynchronous
     copies and their wait); one "analysis:" line.
 25. (run before 24) data-parallel training: launch.mesh.spawn_mesh
     starts a (2, 1) data mesh, 2 gloo ranks on cuda:0, each running
     full-size smollm-135m (bf16, remat, CiM, blocked/cuda) through
     Trainer(mesh=) on its 4 rows of phase 17's global batch (8 x 128):
     the eager data-parallel step (per-tensor activation statistics and
     the gradients' mean over the data group), 2 steps, the checkpoint
     at step 2 written by rank 0; first, in this process, deepseek-v2-236b
     at full width (2 of 60 layers, per_row): one forward of 4 x 16
     tokens in 2 routing groups == the forwards of its row blocks at
     one group, bit for bit, and 2 eager single-device make_train_step
     steps of smollm-135m on the same batches, freed before the ranks
     start. Checked: step 0's loss, and the data-parallel forward's loss
     of the single device's params at every step, within rtol 1e-3 of
     the single device's loss, later losses within rtol 1e-2; step 0's
     grad norm within rtol 1e-3; after step 0 every weight within lr/10
     plus one bf16 step of the weight, and 100 x its weights past lr/10
     within those of a control step (one device's step on rank 0's rows
     alone, taken in rank 0 before the Trainer); the mean |delta param|
     within lr/10 at every step; the params bit-equal on both ranks
     after every step; #1 launched 420 times a step in every rank and no
     other kernel; the last checkpoint restored bit for bit by a
     single-device Trainer on cuda:0 that then takes a step. Printed:
     max and mean |delta|, the weights past lr/10, step 0's moved
     activation codes, the single device's loss of its unmoved params on
     the later batches (what the later losses' bound is read against),
     and on lines of their own the eager data-parallel step, the
     gradient all-reduce's ms, collectives a step and peak memory a rank.
 26. (run after 25, before 24) tensor-parallel training:
     launch.mesh.spawn_mesh starts a (1, 3) mesh, 3 gloo ranks on
     cuda:0, each holding its shards of full-size smollm-135m (bf16,
     remat, CiM, blocked/cuda; 3 of 9 heads, 1 of 3 kv heads, the MLP's
     512 of 1536 and 16384 of the 49152 vocabulary a rank) and running
     Trainer(mesh=) on phase 17's global batch (8 x 128): the eager step
     with the model axis's collectives inside autograd, 2 steps, the
     checkpoint at step 2 gathered whole and written by rank 0. It reuses
     phase 25's single-device steps (their losses, grad norms and the
     params after each, kept on disk until this phase ends). Checked:
     step 0's loss equal to the single device's bit for bit; step 0's
     grad norm within rtol 1e-3; after step 0 every weight (gathered
     whole) within lr/10 plus one bf16 step of the single device's; the
     replicated leaves bit-equal on the 3 ranks after every step; #1
     launched 420 times a step in every rank and no other kernel; the
     gathered checkpoint restored bit for bit by a single-device Trainer
     on cuda:0. Printed: the TP step beside the single device's,
     collectives a step by name, peak memory a rank and the phase's
     seconds.
 27. (run after 26, before 24) tensor-parallel training of the encdec
     and vlm families: launch.mesh.spawn_mesh starts one (1, 2) mesh, 2
     gloo ranks on cuda:0, which train in turn (the first freed before
     the second) whisper-large-v3 (2 of 32 encoder and 2 of 32 decoder
     layers, full width: d 1280, 10 of 20 heads and 25933 of the 51866
     vocabulary a rank; 2 x 64 tokens with 2 x 1500 seeded frames) and
     llava-next-34b (1 of 60 layers, full width: 28 of 56 heads, 4 of 8
     kv heads, the MLP's 10240 of 20480, the projector's 3584 of 7168
     columns and 32000 of the 64000 vocabulary a rank; 1 x (2880 seeded
     patches + 16 tokens)), bf16, remat, CiM, blocked/cuda, 2 steps each
     through Trainer(mesh=, batch_transform=), eager; whisper's
     checkpoint at step 2 gathered whole and written by rank 0. Before
     the spawn, this process runs each config's 2 eager single-device
     steps (files in a temp dir) and frees them. Checked, per family:
     step 0's loss equal to the single device's bit for bit, step 0's
     grad norm within rtol 1e-3; after step 0 every weight (gathered
     whole) within lr/10 plus one bf16 step of the single device's; the
     replicated leaves (the encoder's norms
     and positions among them) bit-equal on both ranks after every step;
     #1 launched 58 (whisper: 7 x 2 encoder layers + 2 x 11 x 2 remat
     decoder layers) or 15 (llava: 2 x 7 + the projector) times a step in
     every rank and no other kernel; whisper's gathered checkpoint
     restored bit for bit by a single-device Trainer on cuda:0. Printed:
     the losses and grad norms beside the single device's, the TP step
     beside the single device's, collectives a step by name, peak memory
     a rank and the phase's seconds.
 24. (run last) the front door over tensor-parallel replicas:
     full-size smollm-135m (per_row, blocked/cuda) behind the launcher's
     build_frontdoor with --tp 3 and 2 replicas: six gloo processes on
     cuda:0, one (1, 3) mesh per replica (make_replica_meshes), each
     replica driven from the door's process through its proxy
     (serve.frontdoor.tp_replica); 4 of phase 19's requests (6 new
     tokens each) streamed concurrently == the prefix of phase 19's
     generate(); one cancelled after 2 tokens
     while another streams on the other replica; /stats carries mesh
     {"data": 2, "model": 3}, one host sync per step and fill and #1
     launched 210 x (steps + fills) in every rank (the ranks agree each
     step), the cancel on its replica and in no rank's slot table; TTFT,
     per-token p50/p99 and goodput on lines of their own; the stop's time
     and no rank process alive after it.
 28. (run after 24) the launch/ twins (launch_phase): started first, in
     processes of their own, three production-mesh cells through
     lower_cell on the meta device (the dryrun CLI: smollm-135m train_4k,
     deepseek-v2-236b decode_32k; the hillclimb CLI: that decode cell
     with --fsdp and phase 20's table) and the four examples/torch
     scripts on the card (train_ternary_lm.py --steps 3), each exit 0
     with its key line; meanwhile one eager make_train_step step of
     phase 17's smollm-135m under op_analysis.record on the card (#1's
     420 launches with their (M, K, N)) and the same step dry on the meta
     device: FLOPs by dtype and #1's calls equal; the predicted peak
     beside torch.cuda.max_memory_allocated, the roofline's largest term
     beside phase 17's captured-step median (the roofline fraction),
     hillclimb.score_cell of a 4-row smollm-135m decode on phase 20's
     table beside #1's measured time of a decode step; the FSDP cell's
     resident bytes below and all-gather bytes above the plain cell's;
     each cell's bottleneck and terms. One "launch" JSON line.
It then prints a JSON line of phase 20's fits, replay error,
projections and winners, a JSON line of phase 28's findings, the card
line, a JSON line of per-kernel
numbers (``tp_launches``: rank 0's launches in phase 21, #1 on its
served path, #2-#4 in its execute_packed_tp calls; ``tp_family_launches``:
#1's in rank 0 per arch of phase 22; ``dp_launches``: #1's in rank 0 of
phase 25; ``tp_train_launches``: #1's in rank 0 per arch of phases 26
and 27), a line of
each phase's seconds and the script's, and last the result
line. Without CUDA, or without ``src/repro_torch`` beside
it, it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12     # H100 SXM dense int8 tensor-core peak
# the five kernels: wrapper name -> (source, the Pallas kernel it replaces)
KERNELS = {
    "ternary_cim_matmul": ("src/repro_torch/csrc/ternary_mac.cu",
                           "src/repro/kernels/ternary_mac.py:72"),
    "packed_cim_matmul_decode": ("src/repro_torch/csrc/packed_mac.cu",
                                 "src/repro/kernels/packed_mac.py:176"),
    "packed_cim_matmul_decode_stream": ("src/repro_torch/csrc/packed_stream.cu",
                                        "src/repro/kernels/packed_mac.py:307"),
    "packed_cim_matmul": ("src/repro_torch/csrc/packed_mac.cu",
                          "src/repro/kernels/packed_mac.py:94"),
    "ternary_exact_matmul": ("src/repro_torch/csrc/ternary_exact.cu",
                             "src/repro/kernels/ternary_mac.py:134"),
}
# one smollm-135m decoder layer's quantized dense layers: (name, K, N)
LAYER_SHAPES = (("q", 576, 576), ("k", 576, 192), ("v", 576, 192),
                ("o", 576, 576), ("gate", 576, 1536), ("up", 576, 1536),
                ("down", 1536, 576))
# one starcoder2-7b decoder layer's (d 4608, 36/4 heads of 128, d_ff
# 18432): 301.9 M weight codes, the first realistic width
SC7B_SHAPES = (("q", 4608, 4608), ("k", 4608, 512), ("v", 4608, 512),
               ("o", 4608, 4608), ("gate", 4608, 18432), ("up", 4608, 18432),
               ("down", 18432, 4608))
# one mamba2-780m layer's quantized dense layers (d 1536, d_inner 3072:
# in_proj to 2 x 3072 + 2 x 128 + 48 heads = 6448) and one zamba2-2.7b
# layer's (d 2560, d_inner 5120: 2 x 5120 + 2 x 64 + 80 heads = 10448)
MAMBA2_SHAPES = (("w_in", 1536, 6448), ("w_out", 3072, 1536))
ZAMBA2_SHAPES = (("w_in", 2560, 10448), ("w_out", 5120, 2560))
# every (K, N) #1 meets in phases 12 and 13 (zamba2's shared block: q/k/v/o
# 2560 -> 2560, MLP 2560 <-> 10240), at the M they give it: decode 1-4
# rows, generate()'s prefill up to 16, the batched prefill 4 x 16
SSM_CHECK_SHAPES = tuple((k, n) for _, k, n in MAMBA2_SHAPES + ZAMBA2_SHAPES) + (
    (2560, 2560), (2560, 10240), (10240, 2560))
SSM_CHECK_M = (1, 4, 16, 64)
# one deepseek-v2-236b layer's quantized dense layers (d 5120, 128 heads of
# 128 + 64 rope, kv_lora 512, the 2 shared experts' MLP of 2 x 1536) and one
# grok-1-314b layer's (d 6144, 48/8 heads of 128); the routed experts are
# plain products, not #1's
DEEPSEEK_SHAPES = (("wq", 5120, 24576), ("w_dkv", 5120, 576), ("wo", 16384, 5120),
                   ("gate", 5120, 3072), ("up", 5120, 3072), ("down", 3072, 5120))
GROK_SHAPES = (("wq", 6144, 6144), ("wk", 6144, 1024), ("wv", 6144, 1024),
               ("wo", 6144, 6144))
MOE_CHECK_SHAPES = tuple(dict.fromkeys((k, n) for _, k, n in DEEPSEEK_SHAPES + GROK_SHAPES))
# one whisper-large-v3 block's quantized dense layers (d 1280, 20 heads of
# 64, d_ff 5120): the encoder's self-attention and the decoder's self and
# cross attention share the q/k/v/o shapes. The unembedding (1280, 51866)
# runs under mode "off", not through #1
WHISPER_SHAPES = (("q", 1280, 1280), ("k", 1280, 1280), ("v", 1280, 1280),
                  ("o", 1280, 1280), ("gate", 1280, 5120), ("up", 1280, 5120),
                  ("down", 5120, 1280))
# one llava-next-34b decoder layer's (its Yi-34B backbone: d 7168, 56/8
# heads of 128, d_ff 20480); the projector is (1024, 7168)
LLAVA_SHAPES = (("q", 7168, 7168), ("k", 7168, 1024), ("v", 7168, 1024),
                ("o", 7168, 7168), ("gate", 7168, 20480), ("up", 7168, 20480),
                ("down", 20480, 7168))
LLAVA_PROJECTOR = (1024, 7168)
ENCDEC_VLM_CHECK_SHAPES = tuple(dict.fromkeys(
    (k, n) for _, k, n in WHISPER_SHAPES + LLAVA_SHAPES)) + (LLAVA_PROJECTOR,)
# M of the #1 checks at the whisper/llava widths, every M their phases
# give it: up to 64, decode (4 slots, 1 row in generate()), the batcher's
# prefill (4 slots x a pow2 bucket <= 16), generate()'s one prompt of
# 1-16 tokens, phase 15's prompts of 8 tokens (4 rows, 1 row); then the
# prefill-scale M at every whisper and llava (K,N): whisper's encoder and
# cross K/V at 1500 rows a request, llava's forward at 2880 image + 16
# text rows; at whisper's (K,N) also 4 requests' 6000 rows (the encoder
# run and the cross K/V of every captured step), at the projector's its
# 2880 image rows. 1501, 2897 and 6001 leave the last 32-row tile partial
ENCDEC_VLM_CHECK_M = tuple(range(1, 17)) + (32, 64)
PREFILL_CHECK_M = (1500, 1501, 2896, 2897)
WHISPER_ENC_M = 4 * 1500
LLAVA_FORWARD_M = 2896
PATH_CHECK_M = dict.fromkeys(((k, n) for _, k, n in WHISPER_SHAPES),
                             (WHISPER_ENC_M, WHISPER_ENC_M + 1))
PATH_CHECK_M[LLAVA_PROJECTOR] = (2880,)
# the layer shapes, then ragged ones that cut across #1's and #5's K split
# and column tiles: K=16 (one block), N=8 (half a tile), 37 blocks of 16
# (prime: no split divides it) by N=200 (12.5 tiles)
CHECK_SHAPES = ((576, 576), (576, 192), (576, 1536), (1536, 576),
                (16, 8), (40, 33), (592, 200))
# M of the kernel checks: every M the serving phases launch (decode 4
# slots; prefill 4 x pow2 bucket <= 64; generate() of one prompt of 1-16
# tokens; the stored-plane phase's 4 and 128), plus a ragged 200
CHECK_M = tuple(range(1, 17)) + (32, 64, 128, 200)
# M of the overlapping-plane checks of #2, #3 and #4
OVERLAP_M = (1, 4, 8, 9, 128)
# the prefill M at which #1 and #5 are also timed: the largest that
# phase 3's prefill gives them (4 slots x a 16-token bucket)
TIMED_PREFILL_M = 64
# the M at which #4 is timed (phases 5 and 7 run it there), #1 beside it
TIMED_PLANES_M = 128
L2_BUDGET = 96 << 20         # weight bytes rotated per timing, > the 50 MB L2
# phase 17 trains full-size smollm-135m at the reference launcher's
# defaults: batch 8 x seq 128, so #1 and #5 meet M = 1024 rows at the four
# (K, N) of its layers; 1023 leaves the last 32-row tile partial
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 20
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ
TRAIN_CHECK_M = (TRAIN_M, TRAIN_M - 1)
TRAIN_CHECK_SHAPES = ((576, 576), (576, 192), (576, 1536), (1536, 576))
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 10, 15
# phase 18 trains mamba2-780m and zamba2-2.7b at the same batch: #1 meets
# M = 1024 at every (K, N) of phases 12 and 13, #5 at mamba2's (its
# exact/cuda step)
TRAIN_EXACT_SSM_SHAPES = tuple((k, n) for _, k, n in MAMBA2_SHAPES)
# the kernel phase's per-model timings: tag -> model
MODEL_TAGS = {"starcoder2_7b": "starcoder2-7b", "mamba2_780m": "mamba2-780m",
              "zamba2_2_7b": "zamba2-2.7b", "deepseek_v2_236b": "deepseek-v2-236b",
              "grok_1_314b": "grok-1-314b", "whisper_large_v3": "whisper-large-v3",
              "whisper_large_v3_prefill": "whisper-large-v3",
              "llava_next_34b": "llava-next-34b",
              "llava_next_34b_prefill": "llava-next-34b",
              "smollm_135m_train": "smollm-135m",
              "mamba2_780m_train": "mamba2-780m", "zamba2_2_7b_train": "zamba2-2.7b"}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:6.1f}s] {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def graph_ms(torch, calls, reps: int = 5) -> float:
    """Median device time per call of ``calls`` (zero-arg launches),
    captured back to back in one CUDA graph and replayed ``reps`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls[:3]:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def plane_bytes(k: int, n: int) -> int:
    """Bytes of the (M1, M2) planes that a (K, N) weight needs: 2 planes
    of 2 bytes per 16-deep K block per column (the canonical K and N pads
    are never read)."""
    return 2 * 2 * -(-k // 16) * n


def bound_parts(in_bytes: int, out_bytes: int, m: int, k: int, n: int,
                dots: int = 2):
    """(bytes ms, operations ms) of one call: its bytes (each input read
    once, the output written once) over HBM bandwidth, and the ternary
    matmul's operations (``dots`` full dots of 2 ops per MAC: a signed
    and a magnitude dot for the CiM MAC, one for the exact dot) over the
    int8 tensor-core peak. The bound is the larger."""
    return ((in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
            2 * dots * m * k * n / INT8_OPS_PER_S * 1e3)


def wrappers(tm, pm):
    return {name: getattr(tm if name.startswith("ternary") else pm, name)
            for name in KERNELS}


def counts(tm, pm):
    return {name: fn.launches for name, fn in wrappers(tm, pm).items()}


def reset_counts(tm, pm):
    for fn in wrappers(tm, pm).values():
        fn.launches = 0


# the SASS check: kernel -> (library stem, output type of its instances
# as mangled: "i" int32_t, "f" float); every kernel is tile_kernel
# instances and must hold IMMA; #2 and #4 share packed_mac
SASS_CHECKS = {
    "packed_cim_matmul_decode_stream": ("packed_stream", "i"),
    "packed_cim_matmul_decode": ("packed_mac", "i"),
    "packed_cim_matmul": ("packed_mac", "f"),
    "ternary_cim_matmul": ("ternary_mac", "f"),
    "ternary_exact_matmul": ("ternary_exact", "f"),
}
SASS_OPS = ("LDGSTS", "UBLKCP", "UTMALDG", "LDGDEPBAR", "DEPBAR", "SYNCS", "IMMA")
# each checked kernel's SASS per instance, as check_sass read it: phase 23
# applies the analysis contracts' SASS pins to it
SASS_TEXT = {}


def tile_args(name: str):
    """(MT, CW, OutT code) of a tile_kernel<Mac, Src, MT, CW, OutT, RING>
    instance, from its mangled name, whose template arguments read
    ...ELi<MT>ELi<CW>E<OutT>Li<RING>EE... (OutT "i" for int32_t, "f" for
    float)."""
    found = re.search(r"ELi(\d+)ELi(\d+)E([a-z])Li\d+EE", name)
    if not found:
        fail(f"cannot read the template arguments of {name}")
    return int(found.group(1)), int(found.group(2)), found.group(3)


def copy_width(name: str) -> int:
    """The copy width CW of a tile_kernel instance (:func:`tile_args`)."""
    return tile_args(name)[1]


def short_name(name: str) -> str:
    """A kernel's mangled name without its namespace and parameter list:
    the template arguments of a tile_kernel instance, e.g.
    ``NS_6CimMacENS_9PlanePairELi32ELi16EfLi3E``."""
    if "tile_kernelI" in name:
        return name.split("tile_kernelI", 1)[1].split("EEv", 1)[0]
    return name[-48:]


def check_sass(nvcc: str, libs: dict) -> dict:
    """What each checked kernel's SASS (``cuobjdump -sass``) must hold, in
    every compiled instance: asynchronous global->shared copies (LDGSTS
    for cp.async, UBLKCP or UTMALDG for TMA) and a wait on them
    (LDGDEPBAR/DEPBAR, or SYNCS for an mbarrier) -- the counterpart of
    the Pallas stream kernel's pin of 2 dma_start and 1 dma_wait -- except
    in the byte-copy instances of #1, #4 and #5 (copy width 1, taken only
    where a pointer, stride or extent is not a multiple of 16 bytes); and
    int8 tensor-core MMAs (IMMA). #2's instances are the 8-row int32
    ones of packed_mac, #4's the float ones. Returns the opcode counts per
    kernel and instance."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        fail(f"cuobjdump not found beside {nvcc}")
    found, sass = {}, {}
    for kernel, (stem, out_type) in SASS_CHECKS.items():
        if stem not in sass:
            res = subprocess.run([cuobjdump, "-sass", str(libs[stem])],
                                 capture_output=True, text=True, timeout=120)
            if res.returncode != 0:
                fail(f"cuobjdump -sass failed: {res.stderr.strip()}")
            sass[stem] = res.stdout
        found[kernel] = {}
        for part in sass[stem].split("Function : ")[1:]:
            name = part.split(None, 1)[0]
            if "tile_kernel" not in name or tile_args(name)[2] != out_type:
                continue
            if kernel == "packed_cim_matmul_decode" and tile_args(name)[0] != 8:
                fail(f"{kernel} {name}: #2 compiles 8-row tiles only")
            ops = {op: part.count(op) for op in SASS_OPS}
            if kernel == "packed_cim_matmul_decode_stream" and copy_width(name) != 16:
                fail(f"{kernel} {name}: the stream kernel compiles 16-byte copies only")
            if copy_width(name) > 1:
                if not (ops["LDGSTS"] or ops["UBLKCP"] or ops["UTMALDG"]):
                    fail(f"{kernel} {name}: no asynchronous global->shared copy")
                if not (ops["LDGDEPBAR"] or ops["DEPBAR"] or ops["SYNCS"]):
                    fail(f"{kernel} {name}: no wait on its asynchronous copies")
            if not ops["IMMA"]:
                fail(f"{kernel} {name}: no int8 tensor-core MMA (IMMA)")
            found[kernel][name] = ops
            SASS_TEXT.setdefault(kernel, {})[name] = part
        if not found[kernel]:
            fail(f"no {kernel} instance (output type {out_type}) in the SASS "
                 f"of {libs[stem]}")
    return found


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def kernel_phase(torch, tm, pm, tern_mod, decode_m_max, dev):
    g = torch.Generator(device=dev).manual_seed(1234)

    def tern(shape):
        return torch.randint(-1, 2, shape, generator=g, device=dev, dtype=torch.int8)

    def canonical_planes(w, width=None):
        k, n = w.shape
        width = -(-n // 128) * 128 if width is None else width
        wz = torch.zeros((-(-k // 256) * 256, width), dtype=torch.int8, device=dev)
        wz[:k, :n] = w
        return tern_mod.pack_ternary(wz, axis=0)

    errs = {name: 0.0 for name in KERNELS}

    def check(name, got, want, what):
        err = (got.to(torch.float64) - want.to(torch.float64)).abs().max().item() \
            if got.numel() else 0.0
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            fail(f"{name} disagrees with its plain version at {what}: max |err| {err}")
        errs[name] = max(errs[name], err)

    for k, n in CHECK_SHAPES:
        w = tern((k, n))
        p1, p2 = canonical_planes(w)
        wi = tern_mod.interleave_planes(p1, p2)   # plane layout 1
        u1, u2 = canonical_planes(w, n + 5)       # unaligned: #2's byte copies
        for m in CHECK_M:
            x = tern((m, k))
            what = f"M={m} K={k} N={n}"
            check("ternary_cim_matmul", tm.ternary_cim_matmul(x, w),
                  tm.ternary_cim_matmul_plain(x, w), what)
            check("ternary_exact_matmul", tm.ternary_exact_matmul(x, w),
                  tm.exact_matmul_plain(x, w), what)
            for cim in (True, False):
                plain = pm.packed_matmul_plain(x, p1, p2, n_out=n, cim=cim)
                if m <= decode_m_max:
                    decode = pm.packed_cim_matmul_decode(x, p1, p2, n_out=n, cim=cim)
                    check("packed_cim_matmul_decode", decode,
                          plain.to(torch.int32), f"{what} cim={cim}")
                    check("packed_cim_matmul_decode",
                          pm.packed_cim_matmul_decode(x, u1, u2, n_out=n, cim=cim),
                          plain.to(torch.int32), f"{what} cim={cim} unaligned planes")
                    want = pm.stream_matmul_plain(x, wi, n_out=n, cim=cim)
                    for nbuf in (2, 3):
                        got = pm.packed_cim_matmul_decode_stream(
                            x, wi, n_out=n, cim=cim, nbuf=nbuf)
                        tag = f"{what} cim={cim} nbuf={nbuf}"
                        check("packed_cim_matmul_decode_stream", got,
                              want.to(torch.int32), tag)
                        if not torch.equal(got, decode):
                            fail(f"stream kernel != decode kernel at {tag}")
                else:
                    check("packed_cim_matmul",
                          pm.packed_cim_matmul(x, p1, p2, n_out=n, cim=cim),
                          plain, f"{what} cim={cim}")
        # planes whose bits overlap: a weight with both set is pos - neg = 0
        q1 = torch.randint(0, 256, p1.shape, generator=g, device=dev, dtype=torch.uint8)
        q2 = torch.randint(0, 256, p1.shape, generator=g, device=dev, dtype=torch.uint8)
        qi = tern_mod.interleave_planes(q1, q2)
        for m in OVERLAP_M:
            x = tern((m, k))
            for cim in (True, False):
                what = f"overlapping planes M={m} K={k} N={n} cim={cim}"
                plain = pm.packed_matmul_plain(x, q1, q2, n_out=n, cim=cim)
                if m > decode_m_max:
                    check("packed_cim_matmul",
                          pm.packed_cim_matmul(x, q1, q2, n_out=n, cim=cim), plain, what)
                    continue
                check("packed_cim_matmul_decode",
                      pm.packed_cim_matmul_decode(x, q1, q2, n_out=n, cim=cim),
                      plain.to(torch.int32), what)
                for nbuf in (2, 3):
                    check("packed_cim_matmul_decode_stream",
                          pm.packed_cim_matmul_decode_stream(x, qi, n_out=n, cim=cim,
                                                             nbuf=nbuf),
                          plain.to(torch.int32), f"{what} nbuf={nbuf}")
        torch.cuda.synchronize()
    for k, n in SSM_CHECK_SHAPES + MOE_CHECK_SHAPES:
        w = tern((k, n))
        for m in SSM_CHECK_M:
            x = tern((m, k))
            check("ternary_cim_matmul", tm.ternary_cim_matmul(x, w),
                  tm.ternary_cim_matmul_plain(x, w), f"M={m} K={k} N={n}")
        del w
        torch.cuda.synchronize()
    log(f"kernels: #1 bit-exact at the mamba2/zamba2 widths (K,N) in "
        f"{list(SSM_CHECK_SHAPES)} and the deepseek-v2/grok-1 widths "
        f"{list(MOE_CHECK_SHAPES)}, M in {list(SSM_CHECK_M)} (tolerance 0)")
    # the whisper/llava widths, also at prefill-scale M: the kernel runs at
    # the full (M, K, N), its plain version over slices of x's rows
    # (ternary_mac.PLAIN_SLICE_BYTES), since at once it would not fit
    t0 = time.perf_counter()
    for k, n in ENCDEC_VLM_CHECK_SHAPES:
        w = tern((k, n))
        for m in ENCDEC_VLM_CHECK_M + PREFILL_CHECK_M + PATH_CHECK_M.get((k, n), ()):
            x = tern((m, k))
            check("ternary_cim_matmul", tm.ternary_cim_matmul(x, w),
                  tm.ternary_cim_matmul_plain(x, w), f"M={m} K={k} N={n}")
            del x
        del w
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # phase 17's training M: every dense layer of a smollm-135m train step,
    # #1 under the CiM spec, #5 under exact/cuda
    for k, n in TRAIN_CHECK_SHAPES:
        w = tern((k, n))
        for m in TRAIN_CHECK_M:
            x = tern((m, k))
            what = f"M={m} K={k} N={n}"
            check("ternary_cim_matmul", tm.ternary_cim_matmul(x, w),
                  tm.ternary_cim_matmul_plain(x, w), what)
            check("ternary_exact_matmul", tm.ternary_exact_matmul(x, w),
                  tm.exact_matmul_plain(x, w), what)
        torch.cuda.synchronize()
    log(f"kernels: #1 and #5 bit-exact at phase 17's training M in "
        f"{list(TRAIN_CHECK_M)}, (K,N) in {list(TRAIN_CHECK_SHAPES)} (tolerance 0)")
    # phase 18's: every dense layer of a mamba2-780m or zamba2-2.7b train
    # step under the CiM spec, mamba2's also under exact/cuda
    t0 = time.perf_counter()
    for k, n in SSM_CHECK_SHAPES:
        w = tern((k, n))
        for m in TRAIN_CHECK_M:
            x = tern((m, k))
            what = f"M={m} K={k} N={n}"
            check("ternary_cim_matmul", tm.ternary_cim_matmul(x, w),
                  tm.ternary_cim_matmul_plain(x, w), what)
            if (k, n) in TRAIN_EXACT_SSM_SHAPES:
                check("ternary_exact_matmul", tm.ternary_exact_matmul(x, w),
                      tm.exact_matmul_plain(x, w), what)
        del w
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"kernels: #1 bit-exact at phase 18's training M in {list(TRAIN_CHECK_M)}, "
        f"(K,N) in {list(SSM_CHECK_SHAPES)}, #5 too at "
        f"{list(TRAIN_EXACT_SSM_SHAPES)} (tolerance 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"kernels: #1 bit-exact at the whisper-large-v3/llava-next-34b widths "
        f"(K,N) in {list(ENCDEC_VLM_CHECK_SHAPES)}, M in "
        f"{list(ENCDEC_VLM_CHECK_M + PREFILL_CHECK_M)}, and also at "
        + ", ".join(f"{kn} M in {list(ms)}" for kn, ms in PATH_CHECK_M.items())
        + f" (tolerance 0; plain version over row slices of <= "
        f"{tm.PLAIN_SLICE_BYTES >> 30} GiB of intermediates) in "
        f"{time.perf_counter() - t0:.1f} s")
    log("kernels: #1, #2, #3, #4 and #5 bit-exact against their plain versions "
        f"at (K,N) in {list(CHECK_SHAPES)}, M in {list(CHECK_M)} (#2 and #3 at "
        f"M <= {decode_m_max}, #2 also on unaligned planes, #3 at nbuf 2 and 3 "
        f"and == #2, #4 above), cim on and off, and #2, #3 and #4 on overlapping "
        f"planes at M in {list(OVERLAP_M)} (tolerance 0)")

    # the library yardstick of #5: one PyTorch matmul of the same values
    # (bf16 in, f32 out where this torch has it on CUDA, else f32 with
    # TF32 off), exact as the kernel is since every sum is a small integer
    mm_dtype = torch._C._dispatch_has_kernel_for_dispatch_key("aten::mm.dtype", "CUDA")
    if mm_dtype:
        lib_name = "torch.mm(bf16, bf16, out_dtype=float32)"
        lib_dt = torch.bfloat16

        def library(a, b):
            return torch.mm(a, b, out_dtype=torch.float32)
    else:
        lib_name = "torch.matmul(float32, float32), TF32 off"
        lib_dt = torch.float32
        library = torch.matmul

    # timing: one decoder layer's 7 calls, each at its own (K, N); #1 and
    # #5 also at prefill M (TIMED_PREFILL_M), as "prefill_ms"; #1 also at
    # #4's M (TIMED_PLANES_M), as "cim_at_planes_m"; #1 and #5 also at
    # starcoder2-7b's layer (M=4), as "starcoder2_7b"; #1 at each later
    # model's layer, at M=4 and for whisper and llava also at their
    # prefill M (bit-checked on the timed inputs, like every timed shape;
    # at prefill M the plain version runs once per timing, over row slices)
    per_kernel = {}
    cim_at_planes_m = None
    stream_vs_decode = None
    for name, m, shapes, tag in (
            ("ternary_cim_matmul", 4, LAYER_SHAPES, None),
            ("ternary_exact_matmul", 4, LAYER_SHAPES, None),
            ("ternary_cim_matmul", TIMED_PREFILL_M, LAYER_SHAPES, "prefill"),
            ("ternary_exact_matmul", TIMED_PREFILL_M, LAYER_SHAPES, "prefill"),
            ("packed_cim_matmul_decode", 4, LAYER_SHAPES, None),
            ("packed_cim_matmul_decode_stream", 4, LAYER_SHAPES, None),
            ("packed_cim_matmul", TIMED_PLANES_M, LAYER_SHAPES, None),
            ("ternary_cim_matmul", TIMED_PLANES_M, LAYER_SHAPES, "planes_m"),
            ("ternary_cim_matmul", 4, SC7B_SHAPES, "starcoder2_7b"),
            ("ternary_exact_matmul", 4, SC7B_SHAPES, "starcoder2_7b"),
            ("ternary_cim_matmul", 4, MAMBA2_SHAPES, "mamba2_780m"),
            ("ternary_cim_matmul", 4, ZAMBA2_SHAPES, "zamba2_2_7b"),
            ("ternary_cim_matmul", 4, DEEPSEEK_SHAPES, "deepseek_v2_236b"),
            ("ternary_cim_matmul", 4, GROK_SHAPES, "grok_1_314b"),
            ("ternary_cim_matmul", 4, WHISPER_SHAPES, "whisper_large_v3"),
            ("ternary_cim_matmul", WHISPER_ENC_M, WHISPER_SHAPES,
             "whisper_large_v3_prefill"),
            ("ternary_cim_matmul", 4, LLAVA_SHAPES, "llava_next_34b"),
            ("ternary_cim_matmul", LLAVA_FORWARD_M, LLAVA_SHAPES,
             "llava_next_34b_prefill"),
            ("ternary_cim_matmul", TRAIN_M, LAYER_SHAPES, "smollm_135m_train"),
            ("ternary_cim_matmul", TRAIN_M, MAMBA2_SHAPES, "mamba2_780m_train"),
            ("ternary_cim_matmul", TRAIN_M, ZAMBA2_SHAPES, "zamba2_2_7b_train")):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "decode_ms": None}
        t_bytes = t_ops = 0.0
        for label, k, n in shapes:
            x = tern((m, k))
            extra = ""
            if name.startswith("ternary"):
                per = k * n
                copies = max(1, min(2048, L2_BUDGET // per))
                ws = torch.randint(-1, 2, (copies, k, n), generator=g, device=dev,
                                   dtype=torch.int8)
                fn = getattr(tm, name)
                ref = tm.ternary_cim_matmul_plain if name == "ternary_cim_matmul" \
                    else tm.exact_matmul_plain
                calls = [lambda c=c: fn(x, ws[c]) for c in range(copies)]
                # at prefill-scale M one plain call takes seconds: time one
                plain = [lambda: ref(x, ws[0])] * (1 if m > 1024 else 10)
                want = plain[0]()
                dots = 2 if name == "ternary_cim_matmul" else 1
                tb, to = bound_parts(m * k + k * n, 4 * m * n, m, k, n, dots)
                if name == "ternary_exact_matmul":
                    xl, wl = x.to(lib_dt), ws.to(lib_dt)
                    if not torch.equal(library(xl, wl[0]), want):
                        fail(f"{lib_name} != the exact kernel's function at {label}")
                    t_l = graph_ms(torch, [lambda c=c: library(xl, wl[c])
                                           for c in range(copies)])
                    tot["library_ms"] = (tot["library_ms"] or 0.0) + t_l
                    extra = f", {lib_name} {t_l * 1e3:.2f} us"
                    del xl, wl
            else:
                rows, cols = -(-k // 256) * 32, -(-n // 128) * 128
                per = 2 * rows * cols
                copies = max(1, min(2048, L2_BUDGET // per))
                pos = torch.randint(0, 256, (copies, rows, cols), generator=g,
                                    device=dev, dtype=torch.uint8)
                neg = torch.randint(0, 256, (copies, rows, cols), generator=g,
                                    device=dev, dtype=torch.uint8) & ~pos
                tb, to = bound_parts(m * k + plane_bytes(k, n), 4 * m * n, m, k, n)
                if name == "packed_cim_matmul_decode_stream":
                    # the canonical layout-1 planes, and #2 on the same bytes
                    wi = tern_mod.interleave_planes(pos, neg)
                    views = [tern_mod.deinterleave_planes(wi[c]) for c in range(copies)]
                    del pos, neg
                    calls = [lambda c=c: pm.packed_cim_matmul_decode_stream(
                        x, wi[c], n_out=n) for c in range(copies)]
                    twins = [lambda c=c: pm.packed_cim_matmul_decode(
                        x, *views[c], n_out=n) for c in range(copies)]
                    plain = [lambda: pm.stream_matmul_plain(x, wi[0], n_out=n)] * 10
                    want = plain[0]().to(torch.int32)
                    if not torch.equal(twins[0](), want):
                        fail(f"#2 on the de-interleaved timed planes at {label}")
                    t_d = graph_ms(torch, twins)
                    tot["decode_ms"] = (tot["decode_ms"] or 0.0) + t_d
                    del twins, views
                else:
                    decode = m <= decode_m_max
                    fn = pm.packed_cim_matmul_decode if decode else pm.packed_cim_matmul
                    calls = [lambda c=c: fn(x, pos[c], neg[c], n_out=n)
                             for c in range(copies)]
                    plain = [lambda: pm.packed_matmul_plain(x, pos[0], neg[0], n_out=n)] * 10
                    want = plain[0]().to(torch.int32 if decode else torch.float32)
            check(name, calls[0](), want, f"the timed inputs {label} M={m}")
            t_k = graph_ms(torch, calls)
            t_p = graph_ms(torch, plain, reps=1 if len(plain) == 1 else 5)
            if name == "packed_cim_matmul_decode_stream":
                extra = f", #2 on the same planes {t_d * 1e3:.2f} us"
            log(f"{name} {label} M={m} K={k} N={n}: {t_k * 1e3:.2f} us/call "
                f"(plain {t_p * 1e3:.2f} us, bound {max(tb, to) * 1e3:.3f} us"
                f"{extra}, {copies} weight copies rotated)")
            tot["ms"] += t_k
            tot["plain_ms"] += t_p
            t_bytes += tb
            t_ops += to
            del calls, plain
        pk = dict(tot, bound_ms=max(t_bytes, t_ops), m=m,
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
        if tag == "prefill":
            per_kernel[name].update(
                prefill_ms=pk["ms"], prefill_m=m, prefill_plain_ms=pk["plain_ms"],
                prefill_bound_ms=pk["bound_ms"], prefill_library_ms=pk["library_ms"])
        elif tag == "planes_m":
            cim_at_planes_m = {f: pk[f] for f in ("m", "ms", "plain_ms", "bound_ms")}
        elif tag in MODEL_TAGS:
            per_kernel[name][tag] = dict({f: pk[f] for f in (
                "m", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                bytes_ms=t_bytes, ops_ms=t_ops)
        else:
            per_kernel[name] = dict(pk, prefill_ms=None)
        extra = ""
        if pk["library_ms"] is not None:
            extra = f", {lib_name} {pk['library_ms']:.4f} ms"
        if pk["decode_ms"] is not None:
            stream_vs_decode = pk["decode_ms"] / pk["ms"]
            extra = (f", #2 on the same planes {pk['decode_ms']:.4f} ms: "
                     f"stream_vs_decode {stream_vs_decode:.3f}, two instances of "
                     "tile_kernel that differ only in the weight source "
                     "(Interleaved vs PlanePair)")
        if tag == "planes_m":
            extra = (f"; #4 on the same shapes at M={m} "
                     f"{per_kernel['packed_cim_matmul']['ms']:.4f} ms")
        layer = f"one {MODEL_TAGS[tag]} layer's" if tag in MODEL_TAGS else "one layer's"
        log(f"{name}: {layer} {len(shapes)} calls at M={m}: {pk['ms']:.4f} ms "
            f"(plain {pk['plain_ms']:.4f} ms, bound {pk['bound_ms']:.5f} ms "
            f"by {pk['bound_by']}: bytes {t_bytes:.5f} ms, operations {t_ops:.5f} ms; "
            f"{100 * pk['bound_ms'] / pk['ms']:.1f}% of the bound{extra})")
    torch.cuda.empty_cache()
    return per_kernel, errs, {"library_call": lib_name,
                              "stream_vs_decode": stream_vs_decode,
                              "cim_at_planes_m": cim_at_planes_m}


# ---------------------------------------------------------------------------
# phases 3-5: the port's serving path
# ---------------------------------------------------------------------------


def make_requests(Request, vocab, seed, n=8):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = [1, 16] + list(rng.integers(1, 17, n - 2))
    return [Request(i, [int(t) for t in rng.integers(1, vocab, lens)],
                    max_new=int(rng.integers(8, 17)))
            for i, lens in enumerate(lengths)]


def four_requests(Request, vocab, seed=7):
    """Phase 11's and 14's requests: 4 prompts of 1, 16 and two random
    lengths in 1-16 tokens, 8 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = [1, 16] + list(rng.integers(1, 17, 2))
    return [Request(i, [int(t) for t in rng.integers(1, vocab, n)], max_new=8)
            for i, n in enumerate(lengths)]


def drive(torch, batcher, reqs, fills=None, counter=None, after_first_fill=None):
    """Run the batcher to completion; returns (seconds, decode-step ms).
    Each fill runs on its own before its step (it ends in the fill's one
    fetch), so it is timed alone: with a list ``fills``, each appends
    (ms, whether it built a new bucket's prefill step, the launches of
    ``counter()`` it moved). ``after_first_fill()`` runs after the first
    fill, outside the timed window. A decode step in the iteration of a
    fill is not in the step ms (the first one is the decode capture), as
    when the fill ran inside the step."""
    for r in reqs:
        batcher.submit(r)
    fill = batcher._fill_slots if batcher.fused else batcher._fill_slots_looped
    torch.cuda.synchronize()
    step_ms, aside = [], 0.0
    t0 = time.perf_counter()
    while batcher.queue or any(r is not None for r in batcher.slot_req):
        pb = batcher.prefill_batches
        nb = len(getattr(batcher, "_prefill_steps", ()))
        c0 = counter() if counter else None
        ts = time.perf_counter()
        fill()
        filled = batcher.prefill_batches != pb
        if filled and fills is not None:
            fills.append(((time.perf_counter() - ts) * 1e3,
                          len(getattr(batcher, "_prefill_steps", ())) != nb,
                          counter() - c0 if counter else None))
        if filled and pb == 0 and after_first_fill is not None:
            ta = time.perf_counter()
            after_first_fill()
            aside += time.perf_counter() - ta
        ts = time.perf_counter()
        batcher.step()  # ends in the step's one host fetch
        if not filled:
            step_ms.append((time.perf_counter() - ts) * 1e3)
    return time.perf_counter() - t0 - aside, step_ms


def profile_step(torch, step, top=6, drain=False, host=True):
    """One call of ``step`` (a batcher's ``step``, or a serve step) under
    torch.profiler (CUPTI), after a first call that fills the slots (and,
    for a captured step, captures it); the call after it is timed between
    two CUDA events. The wall time ends where ``step`` returns (a batcher
    step ends in its host fetch) or, with ``drain``, for a call that
    returns before its kernels end, after a device synchronize.
    Returns a dict: wall ms under the profiler; device-busy ms,
    the sum over the device-side rows (kernels, copies) only; the sum
    over all rows, which also counts each kernel again under the host op
    that launched it (the figure PR 14 recorded); the top device rows;
    (ms, launches) of the MAC kernels; the next step's device span in ms.
    Device time 0 means the profiler saw no device activity. ``host=False``
    traces the device alone (a train step's tens of thousands of host ops
    take the profiler tens of seconds to summarize; the device rows are
    the same)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        if drain:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step()
    end.record()
    end.synchronize()
    rows, all_rows = [], 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        all_rows += dev_us / 1e3
        if dev_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    mac = [r for r in rows if "tile_kernel" in r[2]]
    return {"wall_ms": wall, "busy_ms": sum(r[0] for r in rows),
            "all_rows_ms": all_rows, "top": rows[:top],
            "mac_ms": sum(r[0] for r in mac), "mac_launches": sum(r[1] for r in mac),
            "span_ms": start.elapsed_time(end)}


def busy_line(prof, median) -> str:
    """A :func:`profile_step` result against the unprofiled median of the
    same call: device-busy, #1's share, the idle share, the CUDA-event
    span of the next call and the top device rows."""
    return (f"{prof['busy_ms']:.3f} ms device-busy, of which #1 {prof['mac_ms']:.3f} ms "
            f"x{prof['mac_launches']} ({100 * prof['mac_ms'] / prof['busy_ms']:.1f}%); "
            f"busy over the unprofiled median {median:.2f} ms: "
            f"{100 * prof['busy_ms'] / median:.1f}% (idle share "
            f"{100 * (1 - prof['busy_ms'] / median):.1f}%); the next call spans "
            f"{prof['span_ms']:.3f} ms between CUDA events; top device time: "
            + "; ".join(f"{k[:100]} {ms:.3f} ms x{n}" for ms, n, k in prof["top"]))


def profiled(prof) -> dict:
    """A :func:`profile_step` result for the --out JSON."""
    return dict({k: v for k, v in prof.items() if k != "top"},
                top=[[k[:120], ms, n] for ms, n, k in prof["top"]])


def macs_per_step(cfg) -> int:
    """MAC launches per decode step or prefill batch of the batcher, one
    per quantized dense layer: 7 per decoder layer (210 for smollm-135m;
    the batcher serves whisper-large-v3 without cross attention and
    llava-next-34b's token stream, so 7 for theirs too), 2 per mamba
    layer (w_in, w_out: 96 for mamba2-780m), 7 per application of
    zamba2's shared block (2 x 54 + 7 x 9 = 171); per moe layer the
    attention's projections (MLA's wq, w_dkv, wo; GQA's 4) and the shared
    experts' MLP where there is one: 6 per deepseek-v2 layer, 4 per
    grok-1 layer (the routed experts are plain products)."""
    if cfg.family == "moe":
        return ((3 if cfg.mla else 4) + (3 if cfg.n_shared_experts else 0)) * cfg.n_layers
    if cfg.family in ("dense", "encdec", "vlm"):
        return 7 * cfg.n_layers
    shared = cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    return 2 * cfg.n_layers + 7 * shared


def serve_counted(torch, tm, pm, batcher, reqs, vocab, kernel, label, fills=None,
                  after_first_fill=None):
    """Drive ``batcher`` over ``reqs`` with every launch count at 0 just
    before; fail unless every request finished with tokens in range, one
    host sync per step, ``kernel`` launched macs_per_step x (decode steps
    + prefill batches) and macs_per_step in every fill batch, no other
    kernel launched, and every cache leaf kept its storage. ``fills`` and
    ``after_first_fill``: :func:`drive`'s. Returns (counts, stats,
    seconds, step ms)."""
    from repro_torch.models import transformer as T

    ptrs = [a.data_ptr() for a in T.cache_leaves(batcher.caches)]
    per_step = macs_per_step(batcher.cfg)
    fills = [] if fills is None else fills
    reset_counts(tm, pm)
    secs, step_ms = drive(torch, batcher, reqs, fills=fills,
                          counter=lambda: counts(tm, pm)[kernel],
                          after_first_fill=after_first_fill)
    got = counts(tm, pm)
    st = batcher.stats()
    if not all(r.done for r in reqs):
        fail(f"{label}: not every request finished")
    if st["host_syncs"] != st["decode_steps"] + st["prefill_batches"]:
        fail(f"{label}: host_syncs {st}")
    steps = st["decode_steps"] + st["prefill_batches"]
    if [a.data_ptr() for a in T.cache_leaves(batcher.caches)] != ptrs:
        fail(f"{label}: a cache leaf changed its storage")
    if got[kernel] != per_step * steps:
        fail(f"{label}: {kernel} launched {got[kernel]} times, expected "
             f"{per_step} x {steps}")
    if any(n != per_step for _, _, n in fills):
        fail(f"{label}: {kernel} launches per fill batch {[n for _, _, n in fills]}, "
             f"expected {per_step}")
    others = {k: v for k, v in got.items() if k != kernel and v}
    if others:
        fail(f"{label}: other kernels launched {others}")
    for r in reqs:
        if not r.generated or not all(0 <= t < vocab for t in r.generated):
            fail(f"{label}: request {r.rid} tokens {r.generated}")
    return got, st, secs, step_ms


def serving_line(reqs, st, secs, step_ms) -> str:
    toks = sum(len(r.generated) for r in reqs)
    return (f"{len(reqs)} requests, {toks} tokens in {secs:.3f} s = "
            f"{toks / secs:.1f} tok/s; {st['decode_steps']} decode steps at "
            f"{statistics.median(step_ms):.2f} ms median (mean "
            f"{statistics.fmean(step_ms):.2f}), {st['prefill_batches']} prefill "
            f"batches, {st['host_syncs']} host syncs")


def fmt_ms(value) -> str:
    """A time in ms for a log line; "none" where nothing was timed."""
    return "none" if value is None else f"{value:.2f} ms"


def fill_numbers(fills) -> dict:
    """:func:`drive`'s fill records: the median ms of the fills that
    reused a bucket's step (replays, where captured), and of the fills
    that built one (warm-up and capture, where captured)."""
    again = [ms for ms, new, _ in fills if not new]
    first = [ms for ms, new, _ in fills if new]
    return {"prefill_ms": statistics.median(again) if again else None,
            "first_fill_ms": statistics.median(first) if first else None,
            "fills": len(fills), "buckets": len(first)}


def prefill_graphs(batcher, label) -> dict:
    """Fail unless every prefill step of a captured batcher holds a graph
    and every fill after a bucket's first was a replay; returns the
    prefill graphs' capture time, pool bytes and replays beside the
    decode graph's."""
    steps = [step for _, step in batcher._prefill_steps.values()]
    replays = sum(step.replays for step in steps)
    if not steps or any(step.graph is None for step in steps) or (
            replays != batcher.prefill_batches - len(steps)):
        fail(f"{label}: {len(steps)} prefill steps, graphs "
             f"{[step.graph is not None for step in steps]}, {replays} replays over "
             f"{batcher.prefill_batches} fills")
    return {"prefill_capture_s": batcher.prefill_capture_seconds,
            "prefill_pool_bytes": sum(step.pool_bytes for step in steps),
            "prefill_graphs": len(steps), "prefill_replays": replays,
            "decode_capture_s": batcher.capture_seconds,
            "decode_pool_bytes": batcher._decode.pool_bytes}


def serve_captured_and_eager(torch, tm, pm, params, cfg, spec, kernel, label, dev,
                             cache_dtype=None, n_slots=4, s_max=256,
                             requests=lambda Request, vocab: make_requests(
                                 Request, vocab, seed=0)):
    """Phase 3's (or 6's, 9's, 11's, ...) serving: the same requests
    (phase 3's 8 by default) through a batcher whose decode step and
    per-bucket prefills are captured CUDA graphs (the main path, counted)
    and through one with every graph switched off (eager); fails unless
    the decode step and every bucket's prefill were captured, every fill
    after a bucket's first replayed, both give the same tokens, and the
    caches after the first fill are bit-equal. Returns (counts of the
    captured run, stats, log line, numbers)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ContinuousBatcher, Request

    runs = {}
    for graphed in (True, False):
        batcher = ContinuousBatcher(params, cfg, n_slots=n_slots, s_max=s_max,
                                    exec_spec=spec, seed=0, device=dev,
                                    cache_dtype=cache_dtype)
        batcher.graphed = graphed
        reqs = requests(Request, cfg.vocab)
        what = label if graphed else f"{label} (eager)"
        fills, first = [], []
        got, st, secs, step_ms = serve_counted(
            torch, tm, pm, batcher, reqs, cfg.vocab, kernel, what, fills=fills,
            after_first_fill=lambda b=batcher: first.extend(
                a.clone() for a in T.cache_leaves(b.caches)))
        graphs = None
        if graphed:
            if batcher._decode.graph is None or batcher.capture_seconds is None:
                fail(f"{label}: the decode step was not captured")
            graphs = prefill_graphs(batcher, label)
        runs[graphed] = (got, st, secs, step_ms, reqs, graphs, fills, first)
        del batcher   # its graphs' memory pool goes before the next batcher's
    tokens = {g: [r.generated for r in runs[g][4]] for g in runs}
    if tokens[True] != tokens[False]:
        fail(f"{label}: captured tokens {tokens[True]} != eager {tokens[False]}")
    if not all(torch.equal(a, b) for a, b in zip(runs[True][7], runs[False][7])):
        fail(f"{label}: the caches after the first fill differ, captured and eager")
    got, st, secs, step_ms, reqs, graphs, fills, _ = runs[True]
    _, st_e, secs_e, step_ms_e, reqs_e, _, fills_e, _ = runs[False]
    toks = sum(len(r.generated) for r in reqs)
    capture_s = graphs["decode_capture_s"] + graphs["prefill_capture_s"]
    pf, pf_e = fill_numbers(fills), fill_numbers(fills_e)
    numbers = {"captured_step_ms": statistics.median(step_ms),
               "eager_step_ms": statistics.median(step_ms_e),
               "captured_tok_s": toks / secs, "eager_tok_s": toks / secs_e,
               "captured_tok_s_without_capture": toks / (secs - capture_s),
               "capture_s": graphs["decode_capture_s"], "tokens": toks,
               "generated": tokens[True],
               "decode_steps": st["decode_steps"],
               "prefill_batches": st["prefill_batches"],
               "captured_prefill": pf, "eager_prefill": pf_e, **graphs}
    line = (f"captured: {serving_line(reqs, st, secs, step_ms)}; decode capture "
            f"{graphs['decode_capture_s']:.3f} s (warm-up step included, not in the "
            f"step median; {graphs['decode_pool_bytes'] / 1e6:.1f} MB added to the "
            f"batcher's graph pool), {graphs['prefill_graphs']} prefill graphs captured "
            f"in {graphs['prefill_capture_s']:.3f} s ({graphs['prefill_pool_bytes'] / 1e6:.1f}"
            f" MB added to the pool), {graphs['prefill_replays']} fills replayed "
            f"({numbers['captured_tok_s_without_capture']:.1f} tok/s without the "
            f"captures); prefill per fill batch {fmt_ms(pf['prefill_ms'])} median over "
            f"the replays (first fill of a bucket {fmt_ms(pf['first_fill_ms'])}); "
            f"eager (graphs off): {serving_line(reqs_e, st_e, secs_e, step_ms_e)}; "
            f"prefill per fill batch {fmt_ms(pf_e['prefill_ms'])} (first of a bucket "
            f"{fmt_ms(pf_e['first_fill_ms'])}); captured step "
            f"{numbers['eager_step_ms'] / numbers['captured_step_ms']:.2f}x faster; "
            f"tokens identical, caches after the first fill bit-equal")
    return got, st, line, numbers


# the token-identity checks' requests are cut to this many new tokens each
# (generate() runs each request alone, eagerly)
IDENTITY_MAX_NEW = 6


def token_identity(torch, batcher, reqs, params, cfg, generate, spec, label):
    for r in reqs:
        r.max_new = min(r.max_new, IDENTITY_MAX_NEW)
    drive(torch, batcher, reqs)
    if batcher.capture_seconds is None:
        fail(f"{label}: the decode step was not captured")
    for r in reqs:
        solo = generate(params, [r.prompt], cfg, max_new=r.max_new,
                        s_max=batcher.s_max, exec_spec=spec,
                        device=batcher.device)[0].tolist()
        if solo != r.generated:
            fail(f"{label}: request {r.rid} (prompt {len(r.prompt)}) "
                 f"fused {r.generated} != generate {solo}")
    log(f"{label}: captured batcher == generate() for {len(reqs)} requests (at most "
        f"{IDENTITY_MAX_NEW} new tokens each) "
        f"({sum(len(r.generated) for r in reqs)} tokens, prompt lengths "
        f"{[len(r.prompt) for r in reqs]}), act_scale=per_row")


def profile_line(torch, params, cfg, spec, mac, numbers, dev) -> dict:
    """Profile one replayed decode step of a captured batcher and one
    step of the same batcher with the graph off (4 slots, 4 requests),
    log both with busy over the unprofiled median step of ``numbers``
    (phase 3's or 6's), and return the numbers."""
    from repro_torch.serve.engine import ContinuousBatcher, Request

    out = {}
    for graphed, median in ((True, numbers["captured_step_ms"]),
                            (False, numbers["eager_step_ms"])):
        batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, exec_spec=spec,
                                    device=dev)
        batcher.graphed = graphed
        for r in make_requests(Request, cfg.vocab, seed=3, n=4):
            batcher.submit(r)
        p = profile_step(torch, batcher.step)
        if graphed and batcher.capture_seconds is None:
            fail("profiled step: the decode step was not captured")
        what = "replayed" if graphed else "eager"
        if p["busy_ms"] > 0:
            log(f"profiled {what} decode step (4 slots): {p['wall_ms']:.2f} ms wall "
                f"under the profiler, {p['busy_ms']:.3f} ms device-busy (device "
                f"rows; all rows {p['all_rows_ms']:.3f} ms), of which the MAC kernel "
                f"{mac} {p['mac_ms']:.3f} ms x{p['mac_launches']}; busy over the "
                f"unprofiled median {what} step {median:.2f} ms: "
                f"{100 * p['busy_ms'] / median:.1f}% (idle share "
                f"{100 * (1 - p['busy_ms'] / median):.1f}%); the next {what} step "
                f"spans {p['span_ms']:.3f} ms between CUDA events; top device time: "
                + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for ms, n, k in p["top"]))
        else:
            log(f"profiled {what} decode step: {p['wall_ms']:.2f} ms wall; device "
                f"time not measured (the profiler recorded no device activity); "
                f"the next step spans {p['span_ms']:.3f} ms between CUDA events")
        out[what] = {k: v for k, v in p.items() if k != "top"}
    return out


def serving_phases(torch, tm, pm, card, dev):
    from repro_torch import api
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import ContinuousBatcher, Request, generate

    cfg = get_config("smollm-135m")
    if (cfg.n_layers, cfg.d_model, cfg.vocab) != (30, 576, 49152):
        fail(f"not the full-size smollm-135m config: {cfg}")
    params = T.init_params(cfg, seed=0, device=dev)

    # phase 3: the main path, its decode step one captured CUDA graph,
    # beside the same batcher with the graph switched off
    main_counts, st, cim_line, cim_numbers = serve_captured_and_eager(
        torch, tm, pm, params, cfg, None, "ternary_cim_matmul", "serving", dev)
    log(f"serving smollm-135m (30 layers, d 576, vocab 49152, bf16, mode cim) "
        f"on {card}: {cim_line}; kernel #1 launches "
        f"{main_counts['ternary_cim_matmul']} = 210 x "
        f"{st['decode_steps'] + st['prefill_batches']} (captured run)")
    cim_numbers["profiled"] = profile_line(torch, params, cfg, None, "#1", cim_numbers, dev)
    logits, _ = T.decode_step(params, torch.tensor([[5, 17, 33]], device=dev),
                              T.init_caches(cfg, 1, 16, device=dev), 0, cfg)
    if logits.shape != (1, 3, cfg.vocab) or not torch.isfinite(logits).all():
        fail(f"decode_step logits {tuple(logits.shape)} not finite")

    # phase 4: token identity under per-row activation scales
    row_cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    batcher = ContinuousBatcher(params, row_cfg, n_slots=4, s_max=256, device=dev)
    token_identity(torch, batcher, make_requests(Request, cfg.vocab, seed=1, n=6),
                   params, row_cfg, generate, None, "token identity")

    # phase 5: the stored-plane path
    spec = api.CiMExecSpec("blocked", "cuda", "bitplane_u8")
    reset_counts(tm, pm)
    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, exec_spec=spec,
                                prepare_weights=True, device=dev)
    reqs = make_requests(Request, cfg.vocab, seed=2, n=4)
    drive(torch, batcher, reqs)
    if not all(r.done for r in reqs):
        fail("stored planes: not every request finished")
    g = torch.Generator(device=dev).manual_seed(5)
    from repro_torch.quant.prepare import tree_paths

    folded = dict(tree_paths(batcher.params))
    dense = api.CiMExecSpec("blocked", "cuda")
    checked = 0
    for path, planes in sorted(batcher.packed.items()):
        for layer in (0, cfg.n_layers - 1):
            one = planes.layer(layer)
            w = folded[path][layer]
            codes = (w / torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-12))
            for m in (4, 128):
                x = torch.randint(-1, 2, (m, one.k), generator=g, device=dev).float()
                got = api.execute_packed(spec, x, one)
                ref = api.execute(dense, x, codes.float())
                if not torch.equal(got, ref):
                    fail(f"stored planes: execute_packed != execute for {path} "
                         f"layer {layer} M={m}")
                checked += 1
    plane_counts = counts(tm, pm)
    if plane_counts["packed_cim_matmul_decode"] <= 0 or plane_counts["packed_cim_matmul"] <= 0:
        fail(f"stored planes: packed kernels not launched {plane_counts}")
    log(f"stored planes: execute_packed == execute bit for bit on {checked} "
        f"(weight, layer, M) cases; launches {plane_counts}")

    # phase 6: the near-memory baseline, every dense layer through #5
    nm = api.CiMExecSpec("exact", "cuda")
    nm_counts, st, nm_line, nm_numbers = serve_captured_and_eager(
        torch, tm, pm, params, cfg, nm, "ternary_exact_matmul", "NM serving", dev)
    log(f"NM baseline serving (exact/cuda, the same 8 requests) on {card}: "
        f"{nm_line}; kernel #5 launches {nm_counts['ternary_exact_matmul']} = 210 x "
        f"{st['decode_steps'] + st['prefill_batches']} (captured run), #1 none")
    nm_numbers["profiled"] = profile_line(torch, params, cfg, nm, "#5", nm_numbers, dev)
    batcher = ContinuousBatcher(params, row_cfg, n_slots=4, s_max=256,
                                exec_spec=nm, device=dev)
    token_identity(torch, batcher, make_requests(Request, cfg.vocab, seed=4, n=4),
                   params, row_cfg, generate, nm, "NM token identity")

    # phase 7: stored planes in layout 1 through the stream kernel
    stream = api.CiMExecSpec("blocked", "cuda_stream", "bitplane_u8")
    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, exec_spec=stream,
                                prepare_weights=True, device=dev)
    if batcher.cfg.quant.exec_spec.name != "blocked/auto/none":
        fail(f"stream planes: in-model spec {batcher.cfg.quant.exec_spec.name}")
    reqs = make_requests(Request, cfg.vocab, seed=2, n=4)
    serve_counted(torch, tm, pm, batcher, reqs, cfg.vocab, "ternary_cim_matmul",
                  "stream-spec serving")
    bad = sorted(p for p, pl in batcher.packed.items() if pl.layout_version != 1)
    if bad or not batcher.packed:
        fail(f"stream planes: not stored in layout 1: {bad}")
    folded = dict(tree_paths(batcher.params))
    cases = []
    for path, planes in sorted(batcher.packed.items()):
        for layer in (0, cfg.n_layers - 1):
            one = planes.layer(layer)
            w = folded[path][layer]
            codes = (w / torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-12))
            for m in (1, 4, 8, 128):
                x = torch.randint(-1, 2, (m, one.k), generator=g, device=dev).float()
                cases.append((path, layer, m, one, codes.float(), x))
    reset_counts(tm, pm)
    got = {}
    for path, layer, m, one, _, x in cases:
        for f in ("blocked", "exact"):
            got[path, layer, m, f] = api.execute_packed(
                api.CiMExecSpec(f, "cuda_stream", "bitplane_u8"), x, one)
    stream_counts = counts(tm, pm)
    if (stream_counts["packed_cim_matmul_decode_stream"] <= 0
            or stream_counts["packed_cim_matmul"] <= 0):
        fail(f"stream planes: kernels #3/#4 not launched {stream_counts}")
    for path, layer, m, one, codes, x in cases:
        for f in ("blocked", "exact"):
            twin = api.execute_packed(api.CiMExecSpec(f, "cuda", "bitplane_u8"), x, one)
            ref = api.execute(api.CiMExecSpec(f, "cuda"), x, codes)
            out = got[path, layer, m, f]
            if not (torch.equal(out, twin) and torch.equal(out, ref)):
                fail(f"stream planes: {f}/cuda_stream != {f}/cuda planes or dense "
                     f"for {path} layer {layer} M={m}")
    log(f"stream planes: {len(batcher.packed)} weights stored in layout 1; "
        f"execute_packed under blocked|exact/cuda_stream == */cuda/bitplane_u8 == "
        f"execute (#1/#5) bit for bit on {2 * len(cases)} (weight, layer, M, "
        f"formulation) cases; launches {stream_counts}")
    capacity = capacity_phase(torch, params, row_cfg, dev)
    kvq = kv_cache_phases(torch, tm, pm, params, cfg, row_cfg, card, cim_numbers, dev)
    looped = looped_phase(torch, tm, pm, params, row_cfg, card, cim_numbers, dev)
    launches = {"ternary_cim_matmul": main_counts["ternary_cim_matmul"],
                "packed_cim_matmul_decode": plane_counts["packed_cim_matmul_decode"],
                "packed_cim_matmul_decode_stream":
                    stream_counts["packed_cim_matmul_decode_stream"],
                "packed_cim_matmul": (plane_counts["packed_cim_matmul"]
                                      + stream_counts["packed_cim_matmul"]),
                "ternary_exact_matmul": nm_counts["ternary_exact_matmul"]}
    return launches, {"cim": cim_numbers, "nm": nm_numbers, "capacity": capacity,
                      "kv_cache": kvq, "looped": looped}


# ---------------------------------------------------------------------------
# phases 8-11: capacity, quantized KV caches, the looped baseline and
# starcoder2-7b
# ---------------------------------------------------------------------------

# the CPU tests' capacity mix scaled to s_max 16: request 0 fills its slot at
# s_max while request 2 still decodes, so slot 0 rides on as a dead lane
# whose cache write the step clamps to its row's last slot. Both prefill
# to a 4-slot bucket: request 0 gets 1 + (16 - 4) = 13 tokens of 100 and
# request 2 13 of 14 (both truncated), request 1 its 2 (the reference's
# counts and flags for this mix)
CAPACITY_MIX = (([11, 12, 13], 100), ([14], 2), ([15, 16], 14))
CAPACITY_WANT = ([13, 2, 13], [True, False, True])
# per-slot cache bytes of full-size smollm-135m at s_max 256: 30 layers x
# 256 positions x k and v x (bf16 2D | int8 D + 4 | ternary D/2 + 4), D 192
KV_BYTES_PER_SLOT = {"bf16": 5_898_240, "int8": 3_010_560, "ternary": 1_536_000}


def cache_bytes(T, caches) -> int:
    return sum(a.numel() * a.element_size() for a in T.cache_leaves(caches))


def capacity_phase(torch, params, row_cfg, dev, label="capacity") -> dict:
    """Phase 8 (and its zamba2 twin): a captured batcher (2 slots, s_max
    16, per_row) over CAPACITY_MIX; fails unless the step was captured,
    the mix finishes (no device assert) with the reference's counts and
    flags, and each request's tokens == generate()."""
    from repro_torch.serve.engine import ContinuousBatcher, Request, generate

    batcher = ContinuousBatcher(params, row_cfg, n_slots=2, s_max=16, device=dev)
    reqs = [Request(i, list(p), max_new=m) for i, (p, m) in enumerate(CAPACITY_MIX)]
    secs, _ = drive(torch, batcher, reqs)
    torch.cuda.synchronize()
    if batcher.capture_seconds is None:
        fail(f"{label}: the decode step was not captured")
    got = ([len(r.generated) for r in reqs], [r.truncated for r in reqs])
    if got != CAPACITY_WANT or not all(r.done for r in reqs):
        fail(f"{label}: token counts and truncation flags {got}, expected "
             f"{CAPACITY_WANT}")
    for r in reqs:
        solo = generate(params, [r.prompt], row_cfg, max_new=len(r.generated),
                        s_max=16, device=dev)[0].tolist()
        if solo != r.generated:
            fail(f"{label}: request {r.rid} batcher {r.generated} != generate {solo}")
    log(f"{label}: captured batcher (2 slots, s_max 16, per_row) served "
        f"{[(len(p), m) for p, m in CAPACITY_MIX]} (prompt, max_new) to "
        f"{got[0]} tokens, truncated {got[1]}, with slot 0 a dead lane at s_max "
        f"while request 2 decoded; no device assert; tokens == generate(); "
        f"{batcher.stats()}, {secs:.3f} s")
    return {"tokens": got[0], "truncated": got[1], "stats": batcher.stats()}


def kv_cache_phases(torch, tm, pm, params, cfg, row_cfg, card, bf16, dev) -> dict:
    """Phase 9: phase 3's requests through captured and eager batchers
    under cache_dtype int8 and ternary (tokens equal, #1 launched 210 x
    steps), then per_row batchers == generate() under the same
    cache_dtype; step medians and tok/s beside phase 3's bf16 (``bf16``),
    and the cache bytes per slot."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ContinuousBatcher, Request, generate

    out = {}
    for cd in ("int8", "ternary"):
        qcfg = cfg.replace(quant=dataclasses.replace(cfg.quant, cache_dtype=cd))
        caches = T.init_caches(qcfg, 4, 256, device=dev)
        per_slot = cache_bytes(T, caches) // 4
        del caches
        if per_slot != KV_BYTES_PER_SLOT[cd]:
            fail(f"{cd} cache: {per_slot} bytes per slot, expected {KV_BYTES_PER_SLOT[cd]}")
        got, st, line, numbers = serve_captured_and_eager(
            torch, tm, pm, params, cfg, None, "ternary_cim_matmul",
            f"{cd} cache serving", dev, cache_dtype=cd)
        ratio = KV_BYTES_PER_SLOT["bf16"] / per_slot
        log(f"{cd} KV cache serving smollm-135m on {card}: {line}; kernel #1 launches "
            f"{got['ternary_cim_matmul']} = {7 * cfg.n_layers} x "
            f"{st['decode_steps'] + st['prefill_batches']}; captured step "
            f"{numbers['captured_step_ms']:.2f} ms against bf16's "
            f"{bf16['captured_step_ms']:.2f} ms, {numbers['captured_tok_s']:.1f} tok/s "
            f"against {bf16['captured_tok_s']:.1f}; {per_slot} cache bytes per slot "
            f"at s_max 256 against bf16's {KV_BYTES_PER_SLOT['bf16']} ({ratio:.3f}x)")
        qrow = row_cfg.replace(quant=dataclasses.replace(row_cfg.quant, cache_dtype=cd))
        batcher = ContinuousBatcher(params, row_cfg, n_slots=4, s_max=256,
                                    cache_dtype=cd, device=dev)
        token_identity(torch, batcher, make_requests(Request, cfg.vocab, seed=1, n=4),
                       params, qrow, generate, None, f"{cd} cache token identity")
        out[cd] = dict(numbers, bytes_per_slot=per_slot, launches=got["ternary_cim_matmul"])
    return out


# phase 10's requests are cut to this many new tokens each (at 8-16 its
# 14 eager decode steps took ~19 s on an H100 80GB HBM3 at 700 W)
LOOPED_MAX_NEW = 6


def looped_phase(torch, tm, pm, params, row_cfg, card, fused, dev) -> dict:
    """Phase 10: the looped baseline (fused=False, greedy, per_row) over 4
    requests of at most LOOPED_MAX_NEW new tokens, eager: tokens == generate(), one host sync per prefill and
    per active slot a step (= the tokens served), one prefill batch per
    request, #1 launched 210 x (4 slots x decode steps + prefills); its
    step median beside the fused step's (phase 3, ``fused``)."""
    from repro_torch.serve.engine import ContinuousBatcher, Request, generate

    batcher = ContinuousBatcher(params, row_cfg, n_slots=4, s_max=256, fused=False,
                                device=dev)
    reqs = make_requests(Request, row_cfg.vocab, seed=6, n=4)
    for r in reqs:
        r.max_new = min(r.max_new, LOOPED_MAX_NEW)
    reset_counts(tm, pm)
    secs, step_ms = drive(torch, batcher, reqs)
    got = counts(tm, pm)
    st = batcher.stats()
    toks = sum(len(r.generated) for r in reqs)
    if not all(r.done for r in reqs) or batcher.capture_seconds is not None:
        fail(f"looped: not every request finished, or a graph was captured {st}")
    if st["host_syncs"] != toks or st["prefill_batches"] != len(reqs):
        fail(f"looped: {st}, expected {toks} host syncs (one per token) and "
             f"{len(reqs)} prefill batches")
    per_step = 7 * row_cfg.n_layers
    want = per_step * (4 * st["decode_steps"] + st["prefill_batches"])
    if got["ternary_cim_matmul"] != want or sum(got.values()) != want:
        fail(f"looped: launches {got}, expected #1 only, {want} times")
    for r in reqs:
        solo = generate(params, [r.prompt], row_cfg, max_new=r.max_new, s_max=256,
                        device=dev)[0].tolist()
        if solo != r.generated:
            fail(f"looped: request {r.rid} {r.generated} != generate {solo}")
    median = statistics.median(step_ms)
    log(f"looped baseline (fused=False, per_row, eager) on {card}: "
        f"{serving_line(reqs, st, secs, step_ms)}; tokens == generate(); host syncs "
        f"= tokens; #1 launches {want} = {per_step} x (4 x {st['decode_steps']} + "
        f"{st['prefill_batches']}); step {median:.2f} ms against the fused step's "
        f"{fused['captured_step_ms']:.2f} ms captured, {fused['eager_step_ms']:.2f} ms "
        f"eager (phase 3, 8 requests)")
    return {"step_ms": median, "tok_s": toks / secs, "tokens": toks, **st}


def starcoder2_phase(torch, tm, pm, card, dev) -> dict:
    """Phase 11: full-size starcoder2-7b (seeded random weights) through
    captured and eager batchers with an int8 KV cache: 4 slots, s_max
    128, 4 requests of 1-16 prompt tokens and 8 new tokens; tokens equal,
    #1 launched 224 x (decode steps + prefill batches); step median,
    tok/s, capture time and the peak device memory; then one replayed
    step under the profiler."""
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config

    cfg = get_config("starcoder2-7b")
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab, cfg.tie_embeddings)
    if shape != (32, 4608, 36, 4, 128, 18432, 49152, False) or not (
            10.0e9 < cfg.param_count() < 10.2e9):
        fail(f"not the full-size starcoder2-7b config: {shape}, "
             f"{cfg.param_count()} params")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    got, st, line, numbers = serve_captured_and_eager(
        torch, tm, pm, params, cfg, None, "ternary_cim_matmul",
        "starcoder2-7b serving", dev, cache_dtype="int8", n_slots=4, s_max=128,
        requests=four_requests)
    peak = torch.cuda.max_memory_allocated()
    from repro_torch.serve.engine import ContinuousBatcher, Request

    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=128, cache_dtype="int8",
                                device=dev)
    for r in four_requests(Request, cfg.vocab):
        batcher.submit(r)
    prof = profile_step(torch, batcher.step)
    if batcher.capture_seconds is None:
        fail("starcoder2-7b profiled step: the decode step was not captured")
    del batcher
    median = numbers["captured_step_ms"]
    log(f"starcoder2-7b profiled replayed decode step (4 slots): {prof['busy_ms']:.3f} ms "
        f"device-busy, of which #1 {prof['mac_ms']:.3f} ms x{prof['mac_launches']}; "
        f"busy over the unprofiled median step {median:.2f} ms: "
        f"{100 * prof['busy_ms'] / median:.1f}%; the next step spans "
        f"{prof['span_ms']:.3f} ms between CUDA events; top device time: "
        + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for ms, n, k in prof["top"]))
    numbers["profiled"] = {k: v for k, v in prof.items() if k != "top"}
    log(f"starcoder2-7b (32 layers, d 4608, 36/4 heads of 128, d_ff 18432, vocab "
        f"49152, untied, {cfg.param_count() / 1e9:.2f} B params, {n_bytes / 1e9:.2f} "
        f"GB bf16, initialized in {init_s:.1f} s at a peak of {init_peak / 1e9:.2f} GB) "
        f"with an int8 KV cache on {card}: {line}; kernel #1 launches "
        f"{got['ternary_cim_matmul']} = 224 x "
        f"{st['decode_steps'] + st['prefill_batches']}; peak device memory while "
        f"serving {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    return dict(numbers, param_bytes=n_bytes, init_s=init_s, init_peak_bytes=init_peak,
                peak_bytes=peak, launches=got["ternary_cim_matmul"])


# phases 12 and 13: the full-size config's fields, the reference's band of
# param_count (tests/test_models.py), and the cache bytes per slot at
# s_max 256 under each cache dtype run: the SSM leaves are f32 and do not
# grow with s_max (mamba2: conv 48 x 3 x 3328 x 4 B = 1,916,928, state
# 48 x 48 x 64 x 128 x 4 B = 75,497,472; zamba2: 3,400,704 + 70,778,880);
# zamba2's KV stack is 9 applications x k, v x 256 positions x (bf16 2D |
# int8 D + 4 B), D = 32 x 80
SSM_ARCHS = {
    "mamba2-780m": dict(
        fields=dict(n_layers=48, d_model=1536, ssm_d_inner=3072, ssm_n_heads=48,
                    ssm_head_dim=64, ssm_state=128, vocab=50280, tie_embeddings=False),
        band=(0.6e9, 1.0e9), ssm_bytes=77_414_400, kv_bytes={"bf16": 0}),
    "zamba2-2.7b": dict(
        fields=dict(n_layers=54, d_model=2560, ssm_d_inner=5120, ssm_n_heads=80,
                    ssm_head_dim=64, ssm_state=64, vocab=32000, tie_embeddings=False,
                    n_heads=32, n_kv_heads=32, resolved_head_dim=80, d_ff=10240,
                    hybrid_attn_every=6),
        band=(2.0e9, 3.4e9), ssm_bytes=74_179_584,
        kv_bytes={"bf16": 23_592_960, "int8": 11_814_912}),
}


def ssm_family_phase(torch, tm, pm, card, dev, arch) -> dict:
    """Phases 12 (mamba2-780m) and 13 (zamba2-2.7b) at full width and depth
    (seeded random weights): for each cache dtype of SSM_ARCHS (the SSM
    leaves f32 under all), phase 3's 8 requests through captured and
    eager batchers (4 slots, s_max 256; tokens equal, #1 launched
    macs_per_step x steps, no other kernel, cache storage kept), the
    cache bytes per slot, the peak memory, and a per_row batcher ==
    generate() on 4 requests; then one replayed bf16-cache step under the
    profiler."""
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import ContinuousBatcher, Request, generate

    want = SSM_ARCHS[arch]
    cfg = get_config(arch)
    fields = {f: getattr(cfg, f) for f in want["fields"]}
    lo, hi = want["band"]
    if fields != want["fields"] or not lo < cfg.param_count() < hi:
        fail(f"not the full-size {arch} config: {fields}, {cfg.param_count()} params")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    per_step = macs_per_step(cfg)
    out = {"param_bytes": n_bytes, "init_s": init_s, "macs_per_step": per_step}
    for cd, kv_bytes in want["kv_bytes"].items():
        qcfg = cfg.replace(quant=dataclasses.replace(cfg.quant, cache_dtype=cd))
        caches = T.init_caches(qcfg, 4, 256, device=dev)
        ssm_caches = caches[0] if cfg.family == "hybrid" else caches
        per_slot, ssm_slot = cache_bytes(T, caches) // 4, cache_bytes(T, ssm_caches) // 4
        if (per_slot, ssm_slot) != (want["ssm_bytes"] + kv_bytes, want["ssm_bytes"]) or any(
                a.dtype != torch.float32 for a in T.cache_leaves(ssm_caches)):
            fail(f"{arch} {cd} cache: {per_slot} bytes per slot ({ssm_slot} SSM), "
                 f"expected {want['ssm_bytes']} SSM (f32) + {kv_bytes} KV")
        del caches, ssm_caches
        torch.cuda.reset_peak_memory_stats()
        got, st, line, numbers = serve_captured_and_eager(
            torch, tm, pm, params, cfg, None, "ternary_cim_matmul",
            f"{arch} {cd} serving", dev, cache_dtype=cd)
        peak = torch.cuda.max_memory_allocated()
        log(f"{arch} {cd} cache on {card}: {line}; kernel #1 launches "
            f"{got['ternary_cim_matmul']} = {per_step} x "
            f"{st['decode_steps'] + st['prefill_batches']}; {per_slot} cache bytes per "
            f"slot at s_max 256 ({ssm_slot} of them the f32 SSM conv and state); peak "
            f"device memory while serving {peak / 1e9:.2f} GB")
        row_cfg = qcfg.replace(quant=dataclasses.replace(qcfg.quant, act_scale="per_row"))
        batcher = ContinuousBatcher(params, row_cfg, n_slots=4, s_max=256, device=dev)
        token_identity(torch, batcher, make_requests(Request, cfg.vocab, seed=1, n=4),
                       params, row_cfg, generate, None, f"{arch} {cd} token identity")
        del batcher
        out[cd] = dict(numbers, bytes_per_slot=per_slot, ssm_bytes_per_slot=ssm_slot,
                       peak_bytes=peak, launches=got["ternary_cim_matmul"])
    if len(want["kv_bytes"]) > 1:
        log(f"{arch} captured step by cache: " + "; ".join(
            f"{cd} {out[cd]['captured_step_ms']:.2f} ms ({out[cd]['captured_tok_s']:.1f} "
            f"tok/s, {out[cd]['bytes_per_slot']} B/slot)" for cd in want["kv_bytes"]))
    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, device=dev)
    for r in make_requests(Request, cfg.vocab, seed=3, n=4):
        batcher.submit(r)
    prof = profile_step(torch, batcher.step, top=10)
    if batcher.capture_seconds is None:
        fail(f"{arch} profiled step: the decode step was not captured")
    del batcher
    median = out["bf16"]["captured_step_ms"]
    log(f"{arch} profiled replayed decode step (4 slots, bf16 cache): "
        f"{prof['busy_ms']:.3f} ms device-busy, of which #1 {prof['mac_ms']:.3f} ms "
        f"x{prof['mac_launches']} ({100 * prof['mac_ms'] / prof['busy_ms']:.1f}%); busy "
        f"over the unprofiled median step {median:.2f} ms: "
        f"{100 * prof['busy_ms'] / median:.1f}% (idle share "
        f"{100 * (1 - prof['busy_ms'] / median):.1f}%); the next step spans "
        f"{prof['span_ms']:.3f} ms between CUDA events; top device time: "
        + "; ".join(f"{k[:100]} {ms:.3f} ms x{n}" for ms, n, k in prof["top"]))
    out["profiled"] = {k: v for k, v in prof.items() if k != "top"}
    out["profiled"]["top"] = [[k[:120], ms, n] for ms, n, k in prof["top"]]
    # the same requests with mode "off" (bf16 matmuls, no ternarization):
    # what the step costs without the quantized dense layers, i.e. the
    # recurrence, conv, gating, norms and attention around them
    off = cfg.replace(quant=dataclasses.replace(cfg.quant, mode="off"))
    batcher = ContinuousBatcher(params, off, n_slots=4, s_max=256, device=dev)
    secs, step_ms = drive(torch, batcher, make_requests(Request, cfg.vocab, seed=0))
    if batcher.capture_seconds is None or not all(r is None for r in batcher.slot_req):
        fail(f"{arch} mode off: the step was not captured or a request did not finish")
    del batcher
    batcher = ContinuousBatcher(params, off, n_slots=4, s_max=256, device=dev)
    for r in make_requests(Request, cfg.vocab, seed=3, n=4):
        batcher.submit(r)
    prof_off = profile_step(torch, batcher.step, top=10)
    del batcher
    out["mode_off"] = {"captured_step_ms": statistics.median(step_ms),
                       "busy_ms": prof_off["busy_ms"],
                       "top": [[k[:120], ms, n] for ms, n, k in prof_off["top"]]}
    log(f"{arch} with mode off (bf16 matmuls, no ternarization, bf16 cache): captured "
        f"step {out['mode_off']['captured_step_ms']:.2f} ms median against "
        f"{median:.2f} ms under mode cim; profiled replayed step "
        f"{prof_off['busy_ms']:.3f} ms device-busy; top device time: "
        + "; ".join(f"{k[:100]} {ms:.3f} ms x{n}" for ms, n, k in prof_off["top"]))
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"{arch} ({cfg.param_count() / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB, "
        f"initialized in {init_s:.1f} s): phase wall time {out['wall_s']:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


# phases 14 and 16: the moe family and llava, whole models that do not fit
# one 80 GB card (472 GB, 629 GB and 69 GB in bf16). The published widths
# of each config (checked against it before the cut), the depth it is cut
# to, and the exact cache bytes per slot at s_max 128 by cache dtype
# (deepseek: layers x 128 x (512 + 64) codes at 2, 1 or 1/2 bytes, plus 2
# f32 scales a position for the quantized caches; grok and llava: layers
# x k, v x 128 x 8 heads x 128 x 2 bytes), and the cache dtypes served.
# llava's cut: 60 layers are 34.4 B params, 69 GB in bf16, which leaves
# no room on the card for a step's ternarized copies; 8 layers are 5.39 B
CUT_ARCHS = {
    "deepseek-v2-236b": dict(
        fields=dict(n_layers=60, d_model=5120, n_heads=128, mla=True, kv_lora_rank=512,
                    q_lora_rank=0, qk_rope_head_dim=64, qk_nope_head_dim=128,
                    v_head_dim=128, n_experts=160, n_shared_experts=2, top_k=6,
                    expert_d_ff=1536, vocab=102400, tie_embeddings=False,
                    moe_capacity_factor=1.25),
        layers=2, cache_bytes={"bf16": 294_912, "int8": 149_504, "ternary": 75_776},
        served=("bf16", "int8")),
    "grok-1-314b": dict(
        fields=dict(n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, mla=False,
                    resolved_head_dim=128, n_experts=8, n_shared_experts=0, top_k=2,
                    expert_d_ff=32768, vocab=131072, tie_embeddings=False,
                    moe_capacity_factor=1.25),
        layers=2, cache_bytes={"bf16": 1_048_576}, served=("bf16",)),
    "llava-next-34b": dict(
        fields=dict(n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
                    resolved_head_dim=128, d_ff=20480, vocab=64000,
                    n_image_tokens=2880, d_vision=1024, rope_theta=5e6,
                    tie_embeddings=False),
        layers=8, cache_bytes={"bf16": 4_194_304}, served=("bf16",)),
}


def prefill_drops(torch, params, cfg, reqs, dev) -> dict:
    """Serve ``reqs``' first step (their batched prefill, then one decode
    step) through an eager batcher under ``cfg``'s own capacity factor,
    counting with ``moe.route`` the (token, expert) assignments each MoE
    block dropped; returns the prefill's and the decode step's totals
    over the layers, and the assignments routed."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import ContinuousBatcher

    seen = []
    block = moe.moe_block

    def counted(p, x, c):
        keep = moe.route(p, x.reshape(-1, x.shape[-1]), c)[2]
        seen.append((x.shape[0] * x.shape[1], (~keep).sum(), keep.numel()))
        return block(p, x, c)

    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=128, device=dev)
    batcher.graphed = False   # moe.route below counts in Python, eagerly
    for r in reqs:
        batcher.submit(r)
    moe.moe_block = counted
    try:
        batcher.step()
    finally:
        moe.moe_block = block
    del batcher
    out = {"prefill": 0, "decode": 0, "prefill_assignments": 0}
    for tokens, dropped, routed in seen:
        kind = "prefill" if tokens > 4 else "decode"
        out[kind] += int(dropped)
        if kind == "prefill":
            out["prefill_assignments"] += routed
    return out


def batcher_checks(torch, tm, pm, card, dev, arch, params, cfg, row_cfg, served,
                   out) -> None:
    """The batcher part of phases 14 and 16, into ``out``: per cache dtype
    of ``served``, phase 11's 4 requests through captured and eager
    batchers (4 slots, s_max 128; tokens equal, #1 launched
    macs_per_step x steps, no other kernel, cache storage kept) with the
    peak memory; a ``row_cfg`` (per_row) batcher == generate(); a
    profiled replayed step (busy, idle share, #1's share); the same
    requests under mode "off", captured and profiled."""
    from repro_torch.serve.engine import ContinuousBatcher, Request, generate

    per_step = macs_per_step(cfg)
    for cd in served:
        torch.cuda.reset_peak_memory_stats()
        got, st, line, numbers = serve_captured_and_eager(
            torch, tm, pm, params, cfg, None, "ternary_cim_matmul",
            f"{arch} {cd} serving", dev, cache_dtype=cd, n_slots=4, s_max=128,
            requests=four_requests)
        peak = torch.cuda.max_memory_allocated()
        log(f"{arch} ({cfg.n_layers} layers) {cd} cache on {card}: {line}; kernel #1 "
            f"launches {got['ternary_cim_matmul']} = {per_step} x "
            f"{st['decode_steps'] + st['prefill_batches']}; "
            f"{out['bytes_per_slot'][cd]} cache bytes per slot at s_max 128; peak "
            f"device memory while serving {peak / 1e9:.2f} GB")
        out[cd] = dict(numbers, peak_bytes=peak, launches=got["ternary_cim_matmul"])
    batcher = ContinuousBatcher(params, row_cfg, n_slots=4, s_max=128, device=dev)
    token_identity(torch, batcher, four_requests(Request, cfg.vocab, seed=1), params,
                   row_cfg, generate, None, f"{arch} token identity" + (
                       f" (capacity factor {row_cfg.moe_capacity_factor:g})"
                       if cfg.n_experts else ""))
    del batcher
    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=128, device=dev)
    for r in four_requests(Request, cfg.vocab, seed=3):
        batcher.submit(r)
    prof = profile_step(torch, batcher.step, top=10)
    if batcher.capture_seconds is None:
        fail(f"{arch} profiled step: the decode step was not captured")
    del batcher
    median = out["bf16"]["captured_step_ms"]
    log(f"{arch} profiled replayed decode step (4 slots, bf16 cache): "
        f"{busy_line(prof, median)}")
    out["profiled"] = profiled(prof)
    # mode "off": bf16 dense matmuls and no ternarization anywhere; what is
    # left is the attention (MLA or GQA), for moe the routing and the
    # float64 expert products over the raw weights, and the float64
    # unembedding
    off = cfg.replace(quant=dataclasses.replace(cfg.quant, mode="off"))
    batcher = ContinuousBatcher(params, off, n_slots=4, s_max=128, device=dev)
    secs, step_ms = drive(torch, batcher, four_requests(Request, cfg.vocab))
    if batcher.capture_seconds is None or not all(r is None for r in batcher.slot_req):
        fail(f"{arch} mode off: the step was not captured or a request did not finish")
    del batcher
    batcher = ContinuousBatcher(params, off, n_slots=4, s_max=128, device=dev)
    for r in four_requests(Request, cfg.vocab, seed=3):
        batcher.submit(r)
    prof_off = profile_step(torch, batcher.step, top=10)
    del batcher
    out["mode_off"] = {"captured_step_ms": statistics.median(step_ms),
                       "busy_ms": prof_off["busy_ms"],
                       "top": [[k[:120], ms, n] for ms, n, k in prof_off["top"]]}
    log(f"{arch} with mode off (bf16 dense matmuls, no ternarization, bf16 cache): "
        f"captured step {out['mode_off']['captured_step_ms']:.2f} ms median against "
        f"{median:.2f} ms under mode cim; profiled replayed step "
        f"{prof_off['busy_ms']:.3f} ms device-busy; top device time: "
        + "; ".join(f"{k[:100]} {ms:.3f} ms x{n}" for ms, n, k in prof_off["top"]))


def cut_model_phase(torch, tm, pm, card, dev, arch) -> dict:
    """Phase 14 or 16 for one arch of CUT_ARCHS: the published widths
    checked, the depth cut, seeded random weights, the exact cache bytes
    per slot; for llava :func:`vlm_forward`; :func:`batcher_checks` with
    a per_row batcher (moe: under the capacity factor n_experts / top_k);
    for moe the drops of a batched prefill under the config's capacity
    factor."""
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import Request

    want = CUT_ARCHS[arch]
    full = get_config(arch)
    fields = {f: getattr(full, f) for f in want["fields"]}
    if fields != want["fields"]:
        fail(f"{arch}: not the published widths: {fields}")
    cfg = full.replace(n_layers=want["layers"])
    t_phase = time.perf_counter()
    log(f"{arch}: published widths {fields}; {full.param_count() / 1e9:.2f} B params "
        f"({full.active_param_count() / 1e9:.1f} B active, "
        f"{2 * full.param_count() / 1e9:.1f} GB in bf16) over {full.n_layers} layers, "
        f"cut to {cfg.n_layers} layers for one 80 GB card: {cfg.param_count() / 1e9:.2f} "
        f"B params, widths unchanged")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    per_step = macs_per_step(cfg)
    out = {"n_layers": cfg.n_layers, "full_n_layers": full.n_layers,
           "param_bytes": n_bytes, "init_s": init_s, "init_peak_bytes": init_peak,
           "macs_per_step": per_step}
    out["bytes_per_slot"] = {}
    for cd, expect in want["cache_bytes"].items():
        qcfg = cfg.replace(quant=dataclasses.replace(cfg.quant, cache_dtype=cd))
        caches = T.init_caches(qcfg, 4, 128, device=dev)
        out["bytes_per_slot"][cd] = per_slot = cache_bytes(T, caches) // 4
        del caches
        if per_slot != expect:
            fail(f"{arch} {cd} cache: {per_slot} bytes per slot, expected {expect}")
    if cfg.family == "vlm":
        out["forward"] = vlm_forward(torch, tm, pm, params, cfg, card, dev)
    row_cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    if cfg.n_experts:
        row_cfg = row_cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.top_k)
    batcher_checks(torch, tm, pm, card, dev, arch, params, cfg, row_cfg,
                   want["served"], out)
    if cfg.n_experts:
        out["drops"] = drops = prefill_drops(torch, params, cfg,
                                             four_requests(Request, cfg.vocab), dev)
        if drops["decode"]:
            fail(f"{arch}: a decode step of 4 tokens dropped {drops['decode']} "
                 f"assignments")
        log(f"{arch} under the config's capacity factor {cfg.moe_capacity_factor}: "
            f"the batched prefill of phase 14's 4 requests (4 slots x a 16-token "
            f"bucket, left pad routed like real tokens) dropped {drops['prefill']} of "
            f"{drops['prefill_assignments']} (token, expert) assignments over "
            f"{cfg.n_layers} layers; the decode step after it none")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"{arch} ({cfg.n_layers} of {full.n_layers} layers, {n_bytes / 1e9:.2f} GB of "
        f"weights, initialized in {init_s:.1f} s at a peak of {init_peak / 1e9:.2f} GB): "
        f"phase wall time {out['wall_s']:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


def expect_launches(tm, pm, n: int, label: str) -> None:
    """Fail unless #1 was launched ``n`` times since the counts were set to
    0, and no other kernel."""
    got = counts(tm, pm)
    others = {k: v for k, v in got.items() if k != "ternary_cim_matmul" and v}
    if got["ternary_cim_matmul"] != n or others:
        fail(f"{label}: launches {got}, expected #1 x {n} and nothing else")


def vlm_forward(torch, tm, pm, params, cfg, card, dev) -> dict:
    """Phase 16's forward: seeded patches (1, n_image_tokens, d_vision) in
    bf16 and 16 text tokens; logits (1, n_image_tokens + 16, vocab),
    finite; #1 launched 1 + 7 x layers times a run (the projector, then
    every decoder layer's dense layers at M = n_image_tokens + 16) and no
    other kernel; the median of 3 runs and the peak memory."""
    from repro_torch.models import transformer as T

    g = torch.Generator(device=dev).manual_seed(16)
    patches = torch.randn((1, cfg.n_image_tokens, cfg.d_vision), generator=g,
                          device=dev).to(torch.bfloat16)
    tokens = torch.randint(1, cfg.vocab, (1, 16), generator=g, device=dev)
    n = 1 + macs_per_step(cfg)
    shape = (1, cfg.n_image_tokens + 16, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        reset_counts(tm, pm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = T.forward(params, tokens, cfg, patches=patches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        expect_launches(tm, pm, n, "llava forward")
        if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
            fail(f"llava forward: logits {tuple(logits.shape)}, want {shape} finite")
        del logits
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(torch, lambda: T.forward(params, tokens, cfg, patches=patches),
                        top=10, drain=True)
    log(f"llava-next-34b ({cfg.n_layers} layers) forward on {card}: patches "
        f"{tuple(patches.shape)} bf16 + 16 tokens -> logits {shape}, finite; #1 "
        f"launched {n} = 1 + 7 x {cfg.n_layers} times a run at M = "
        f"{cfg.n_image_tokens} and {shape[1]}, no other kernel; "
        f"{statistics.median(ms):.2f} ms median of 3 runs ({', '.join(f'{t:.2f}' for t in ms)}); "
        f"peak device memory {peak / 1e9:.2f} GB")
    log(f"llava-next-34b profiled forward: {busy_line(prof, statistics.median(ms))}")
    return {"ms": statistics.median(ms), "runs_ms": ms, "launches": n,
            "peak_bytes": peak, "m": shape[1], "profiled": profiled(prof)}


# phase 15: whisper-large-v3 at full size, nothing cut: the published
# widths, the reference's param_count (tests/test_torch_encdec.py) and the
# bf16 KV bytes a slot at s_max 128 (32 layers x k, v x 128 x 20 heads x
# 64 x 2 bytes)
WHISPER_FIELDS = dict(n_layers=32, n_encoder_layers=32, d_model=1280, n_heads=20,
                      n_kv_heads=20, resolved_head_dim=64, d_ff=5120, vocab=51866,
                      encoder_seq=1500, tie_embeddings=False)
WHISPER_PARAMS = 2_020_213_760
WHISPER_KV_BYTES_PER_SLOT = 20_971_520


def whisper_phase(torch, tm, pm, card, dev) -> dict:
    """Phase 15: full-size whisper-large-v3, seeded random weights and 4
    requests' seeded frame embeddings (4, 1500, 1280) bf16, standing in
    for the reference's stubbed conv frontend. ``run_encoder`` 3 times
    (#1 launched 7 x 32 a run, no other kernel; the median); a 4-row
    prompt of 8 tokens and 8 new tokens each through
    ``make_jit_serve_step(enc=)`` (captured) and through ``serve_step``
    (eager) on caches of their own: #1 launched 11 x 32 in the prefill
    and in every step and nothing else, tokens equal, cache storage
    kept, the exact bytes per slot; ``generate(enc=)`` under per_row, the
    4 rows together == each row alone (its own encoder run); a profiled
    replayed step; the step under mode "off"; the batcher (no enc, as
    the reference's) on 4 token-only requests, captured == eager."""
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve import engine as E

    cfg = get_config("whisper-large-v3")
    fields = {f: getattr(cfg, f) for f in WHISPER_FIELDS}
    if fields != WHISPER_FIELDS or cfg.param_count() != WHISPER_PARAMS:
        fail(f"not the full-size whisper-large-v3 config: {fields}, "
             f"{cfg.param_count()} params")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    g = torch.Generator(device=dev).manual_seed(15)
    frames = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=g,
                         device=dev).to(torch.bfloat16)
    if frames.shape[0] * frames.shape[1] != WHISPER_ENC_M:
        fail(f"whisper frames {tuple(frames.shape)}: not the M = {WHISPER_ENC_M} "
             f"the kernel phase checked and timed")
    prompt = torch.randint(1, cfg.vocab, (4, 8), generator=g, device=dev)
    enc_macs, step_macs = 7 * cfg.n_encoder_layers, 11 * cfg.n_layers
    out = {"param_bytes": n_bytes, "init_s": init_s, "macs_per_step": step_macs,
           "encoder_launches": enc_macs}

    enc_ms = []
    for _ in range(3):
        reset_counts(tm, pm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = T.run_encoder(params, frames, cfg)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
        expect_launches(tm, pm, enc_macs, "whisper encoder")
    if enc.shape != frames.shape or enc.dtype != frames.dtype or not bool(
            torch.isfinite(enc).all()):
        fail(f"whisper encoder output {tuple(enc.shape)} {enc.dtype} is not finite "
             f"of the frames' shape")
    out["encoder_ms"] = statistics.median(enc_ms)
    log(f"whisper-large-v3 encoder on {card}: 4 x {cfg.encoder_seq} frames, #1 "
        f"launched {enc_macs} = 7 x {cfg.n_encoder_layers} times a run at M = "
        f"{4 * cfg.encoder_seq}, no other kernel; {out['encoder_ms']:.2f} ms median "
        f"of 3 runs ({', '.join(f'{t:.2f}' for t in enc_ms)})")
    prof = profile_step(torch, lambda: T.run_encoder(params, frames, cfg), top=10,
                        drain=True)
    out["encoder_profiled"] = profiled(prof)
    log(f"whisper-large-v3 profiled encoder run: {busy_line(prof, out['encoder_ms'])}")

    def serve(step, caches, qcfg, macs, label):
        """The prompt's prefill (eager), then 7 steps through ``step``;
        returns the tokens (4, 8), each step's ms and #1's launches summed
        over the counts read after the prefill and after every step."""
        reset_counts(tm, pm)
        logits, _ = E.prefill(params, prompt, caches, qcfg, enc)
        expect_launches(tm, pm, macs, f"{label} prefill")
        launched = counts(tm, pm)["ternary_cim_matmul"]
        tok = E.sample(logits, None)
        toks, ms = [tok], []
        for i in range(7):
            reset_counts(tm, pm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = step(tok, caches, prompt.shape[1] + i)
            tok = E.sample(logits[:, -1:], None)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            expect_launches(tm, pm, macs, f"{label} step {i}")
            launched += counts(tm, pm)["ternary_cim_matmul"]
            toks.append(tok)
        return torch.cat(toks, dim=1), ms, launched

    runs = {}
    for graphed in (True, False):
        caches = T.init_caches(cfg, 4, 128, device=dev)
        per_slot = cache_bytes(T, caches) // 4
        if per_slot != WHISPER_KV_BYTES_PER_SLOT:
            fail(f"whisper cache: {per_slot} bytes per slot, expected "
                 f"{WHISPER_KV_BYTES_PER_SLOT}")
        ptrs = [a.data_ptr() for a in T.cache_leaves(caches)]
        if graphed:
            jit = E.make_jit_serve_step(cfg)
            step = lambda tok, c, i: jit(params, tok, c, i, enc=enc)  # noqa: E731
        else:
            step = lambda tok, c, i: E.serve_step(params, tok, c, i, cfg,  # noqa: E731
                                                  enc=enc)
        label = "whisper captured" if graphed else "whisper eager"
        toks, ms, launched = serve(step, caches, cfg, step_macs, label)
        if [a.data_ptr() for a in T.cache_leaves(caches)] != ptrs:
            fail(f"{label}: a cache leaf changed its storage")
        runs[graphed] = (toks, ms, caches, step, launched)
    if not torch.equal(runs[True][0], runs[False][0]):
        fail(f"whisper: captured tokens {runs[True][0].tolist()} != eager "
             f"{runs[False][0].tolist()}")
    cap_ms, eager_ms = runs[True][1], runs[False][1]
    # launches: the eager prefill and the 7 captured steps after it
    out["captured"] = {"step_ms": statistics.median(cap_ms[1:]),
                       "first_call_ms": cap_ms[0], "launches": runs[True][4]}
    out["eager"] = {"step_ms": statistics.median(eager_ms)}
    out["bytes_per_slot"] = WHISPER_KV_BYTES_PER_SLOT
    log(f"whisper-large-v3 serving with the encoder output on {card}: a 4-row prompt "
        f"of 8 tokens, 8 new tokens each; #1 launched {step_macs} = 11 x "
        f"{cfg.n_layers} times in the prefill and in every step (self q/k/v/o, "
        f"cross q/k/v/o with k and v at M = {4 * cfg.encoder_seq}, MLP), no other "
        f"kernel; captured (make_jit_serve_step(enc=)) step "
        f"{out['captured']['step_ms']:.2f} ms median of 6 replays (first call, "
        f"warm-up and capture, {cap_ms[0]:.1f} ms); eager (serve_step) "
        f"{out['eager']['step_ms']:.2f} ms median of 7; tokens identical "
        f"{runs[True][0].tolist()}; cache storage kept; {per_slot} bf16 KV bytes per "
        f"slot at s_max 128")

    caches, step = runs[True][2], runs[True][3]
    tok = runs[True][0][:, -1:]
    prof = profile_step(torch, lambda: step(tok, caches, 15), top=10, drain=True)
    median = out["captured"]["step_ms"]
    out["profiled"] = profiled(prof)
    log(f"whisper-large-v3 profiled replayed step (4 rows, with enc): "
        f"{busy_line(prof, median)}")
    del runs, caches, step, jit

    # mode "off": bf16 dense matmuls (the cross K/V projections included),
    # no ternarization
    off = cfg.replace(quant=dataclasses.replace(cfg.quant, mode="off"))
    caches = T.init_caches(off, 4, 128, device=dev)
    jit_off = E.make_jit_serve_step(off)
    _, off_ms, _ = serve(lambda tok, c, i: jit_off(params, tok, c, i, enc=enc),
                         caches, off, 0, "whisper mode off")
    out["mode_off"] = {"captured_step_ms": statistics.median(off_ms[1:])}
    log(f"whisper-large-v3 with mode off (bf16 dense matmuls, no ternarization): "
        f"captured step {out['mode_off']['captured_step_ms']:.2f} ms median against "
        f"{median:.2f} ms under mode cim")
    del caches, jit_off

    # per_row: no activation scale couples the rows, so each row served
    # alone (its own encoder run) gives the batched rows' tokens
    row_cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    batched = E.generate(params, prompt, row_cfg, max_new=IDENTITY_MAX_NEW, s_max=128,
                         device=dev, enc=T.run_encoder(params, frames, row_cfg))
    for i in range(4):
        solo = E.generate(params, prompt[i:i + 1], row_cfg, max_new=IDENTITY_MAX_NEW,
                          s_max=128,
                          device=dev, enc=T.run_encoder(params, frames[i:i + 1], row_cfg))
        if not torch.equal(solo[0], batched[i]):
            fail(f"whisper per_row: row {i} alone {solo[0].tolist()} != batched "
                 f"{batched[i].tolist()}")
    log(f"whisper-large-v3 generate(enc=) under act_scale=per_row: the 4 rows "
        f"together == each row alone with its own encoder run "
        f"({batched.tolist()})")

    got, st, line, numbers = serve_captured_and_eager(
        torch, tm, pm, params, cfg, None, "ternary_cim_matmul",
        "whisper-large-v3 batcher", dev, n_slots=4, s_max=128, requests=four_requests)
    out["batcher"] = dict(numbers, launches=got["ternary_cim_matmul"])
    log(f"whisper-large-v3 batcher (token requests, no enc: the decoder without "
        f"cross attention, as the reference's batcher) on {card}: {line}; kernel #1 "
        f"launches {got['ternary_cim_matmul']} = {macs_per_step(cfg)} x "
        f"{st['decode_steps'] + st['prefill_batches']}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"whisper-large-v3 (32 + 32 layers, {cfg.param_count() / 1e9:.3f} B params, "
        f"{n_bytes / 1e9:.2f} GB of weights, initialized in {init_s:.1f} s): peak "
        f"device memory {out['peak_bytes'] / 1e9:.2f} GB; phase wall time "
        f"{out['wall_s']:.1f} s")
    del params, enc
    torch.cuda.empty_cache()
    return out


def zamba2_capacity(torch, dev) -> dict:
    """Phase 8's capacity mix on zamba2 at smoke width (seeded random
    weights, per_row) through the captured step."""
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config

    cfg = get_config("zamba2-2.7b", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    return capacity_phase(torch, T.init_params(cfg, seed=0, device=dev), cfg, dev,
                          label="zamba2 capacity")


# ---------------------------------------------------------------------------
# phase 17: training
# ---------------------------------------------------------------------------


def eager_reference(torch, cfg, opt, pipe, dev, n=5) -> dict:
    """``n`` eager make_train_step steps from the Trainer's seed-0 state on
    pipeline batches 0..n-1, under deterministic mode as Trainer.run()
    sets it (and as it was after): the losses and grad norms that the
    captured Trainer's first steps must equal bit for bit, the eager step
    times (the first includes its warm-up) and the peak memory."""
    from repro_torch.train.train_step import init_train_state, make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, seed=0, device=dev)
    step_fn = make_train_step(cfg, opt)
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {"losses": [], "grad_norms": [], "secs": []}
    try:
        for i in range(n):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(i).items()}
            state, m = step_fn(state, batch)
            vals = torch.stack([m["loss"], m["grad_norm"]]).cpu().tolist()
            out["secs"].append(time.perf_counter() - t0)
            out["losses"].append(vals[0])
            out["grad_norms"].append(vals[1])
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["step_ms"] = statistics.median(out["secs"][1:]) * 1e3
    del state, step_fn
    torch.cuda.empty_cache()
    return out


def check_against_eager(log_, ref, label) -> None:
    """Fail unless the captured Trainer's first len(ref) steps equal the
    eager reference's losses and grad norms bit for bit."""
    n = len(ref["losses"])
    got = [(m["loss"], m["grad_norm"]) for m in log_[:n]]
    want = list(zip(ref["losses"], ref["grad_norms"]))
    if got != want:
        fail(f"{label}: the captured steps 0-{n - 1} {got} != eager make_train_step's "
             f"{want}")


def graph_line(captured) -> str:
    """A captured train step's capture time, pool bytes and replays."""
    return (f"one CUDA graph (make_jit_train_step), captured in "
            f"{captured.capture_seconds:.3f} s (warm-up step included), "
            f"{captured.pool_bytes / 1e9:.3f} GB added to its pool, "
            f"{captured.replays} replays")


def train_phase(torch, tm, pm, card, dev) -> dict:
    """Phase 17: full-size smollm-135m (30 layers, d 576, vocab 49152,
    bf16, remat, the CiM spec: all its config's) trained from seed-0
    params on TokenPipeline(seed 0) at the reference launcher's defaults
    (batch 8, seq 128, lr 3e-4 under warmup_cosine(20, 20)) for 20 steps
    through the port's Trainer, checkpoints every 10 steps into a
    temporary directory and a failure injected at step 15: every loss and
    grad norm finite, the mean loss of the last 5 steps below the first
    5's, one restart, steps 10-14 replayed with the losses of their first
    pass (the phase runs under torch.use_deterministic_algorithms), #1
    launched 420 times in every step (210 dense layers, then remat's
    recompute), counted through the replays, and no other MAC kernel. The
    Trainer runs make_jit_train_step: the step is one captured CUDA
    graph, and its first 5 losses and grad norms must equal 5 eager
    make_train_step steps' from the same seed bit for bit (run first).
    Then one step under exact/cuda (#5 420 times, loss finite), the
    captured and eager step medians and tokens/s, the capture time, the
    checkpoint save time, the peak memory, one profiled replay (device
    busy, idle share), and the launcher's main() for 3 steps on the
    card."""
    import tempfile
    import warnings

    from repro_torch.core.execution import CiMExecSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import FailureInjector, TrainConfig, Trainer

    cfg = get_config("smollm-135m")
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab, cfg.tie_embeddings,
             cfg.dtype, cfg.remat, cfg.quant.mode)
    if shape != (30, 576, 9, 3, 64, 1536, 49152, True, "bfloat16", True, "cim"):
        fail(f"not the full-size smollm-135m training config: {shape}")
    per_step = 2 * macs_per_step(cfg)   # the forward, then remat's recompute
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    opt = AdamWConfig(lr=3e-4, schedule=warmup_cosine(20, TRAIN_STEPS))
    ref = eager_reference(torch, cfg, opt, pipe, dev)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt_dir, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer = Trainer(cfg, opt, TrainConfig(
                num_steps=TRAIN_STEPS, ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY,
                log_every=5), pipe, seed=0,
                failure_injector=FailureInjector([TRAIN_FAIL_AT]), device=dev)
            inner, per_call = trainer.step_fn, []

            def counted(state, batch):
                before = counts(tm, pm)
                out = inner(state, batch)
                per_call.append({k: v - before[k] for k, v in counts(tm, pm).items()})
                return out

            trainer.step_fn = counted
            reset_counts(tm, pm)
            t0 = time.perf_counter()
            log_ = trainer.run()
            run_s = time.perf_counter() - t0
            got = counts(tm, pm)
            peak = torch.cuda.max_memory_allocated()
            # the checkpoint save: blocking part (device-to-host copies) and
            # the whole commit
            t0 = time.perf_counter()
            fut = ckpt.save(ckpt_dir, 99, trainer.state, async_=True)
            save_block_s = time.perf_counter() - t0
            fut.result()
            save_s = time.perf_counter() - t0
            ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, "step_00000099",
                                                      "arrays.npz"))
            latest = ckpt.latest_step(ckpt_dir)
        finally:
            torch.use_deterministic_algorithms(False)
    det_warnings = sorted({str(w.message).split(".")[0][:120] for w in caught
                           if "deterministic" in str(w.message)})
    captured = inner.captured
    if captured is None or captured.graph is None:
        fail("training: the Trainer's step was not captured")
    check_against_eager(log_, ref, "training")
    want = dict.fromkeys(got, 0)
    want["ternary_cim_matmul"] = per_step
    bad = [i for i, c in enumerate(per_call) if c != want]
    if bad:
        fail(f"training: step calls {bad} launched {per_call[bad[0]]}, expected {want}")
    if got["ternary_cim_matmul"] != per_step * len(per_call):
        fail(f"training: #1 launched {got['ternary_cim_matmul']} times over "
             f"{len(per_call)} steps")
    steps = [m["step"] for m in log_]
    # steps 0-14, the failure at 15, then 10-19 from the checkpoint at 10
    replayed = list(range(TRAIN_CKPT_EVERY, TRAIN_FAIL_AT))
    restarts = trainer.restarts
    if restarts != 1 or steps != list(range(TRAIN_FAIL_AT)) + list(
            range(TRAIN_CKPT_EVERY, TRAIN_STEPS)):
        fail(f"training: restarts {restarts}, steps {steps}")
    if latest != 99 or len(per_call) != len(steps):
        fail(f"training: LATEST {latest}, {len(per_call)} step calls for {len(steps)} steps")
    for m in log_:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            fail(f"training: step {m['step']} loss {m['loss']} grad norm {m['grad_norm']}")
    first = {}
    for m in log_:
        first.setdefault(m["step"], m)
    again = log_[TRAIN_FAIL_AT:TRAIN_FAIL_AT + len(replayed)]
    for m in again:
        a = first[m["step"]]
        if (m["loss"], m["grad_norm"]) != (a["loss"], a["grad_norm"]):
            fail(f"training: replayed step {m['step']} loss {m['loss']!r} grad norm "
                 f"{m['grad_norm']!r} != first pass {a['loss']!r} {a['grad_norm']!r}")
    losses = [first[i]["loss"] for i in range(TRAIN_STEPS)]
    head, tail = statistics.fmean(losses[:5]), statistics.fmean(losses[-5:])
    if not tail < head:
        fail(f"training: the loss did not fall: first 5 {head:.4f}, last 5 {tail:.4f}")
    secs = [m["sec"] for m in log_[1:]]
    step_ms = statistics.median(secs) * 1e3
    tok_s = TRAIN_M / (step_ms / 1e3)
    log(f"training smollm-135m (full size, bf16, remat, CiM spec; batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}) on {card}: {len(steps)} steps in "
        f"{run_s:.1f} s ({TRAIN_STEPS} + {len(replayed)} replayed after the failure at "
        f"step {TRAIN_FAIL_AT}, restarts {restarts}); loss "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; first 5 mean {head:.4f} -> last 5 mean {tail:.4f}; steps 0-4 == 5 "
        f"eager make_train_step steps (loss and grad norm, bit for bit); replayed "
        f"steps {replayed} == their first pass (bit for bit); #1 launched "
        f"{per_step} in each of the {len(per_call)} step calls "
        f"({got['ternary_cim_matmul']} in all, counted through the replays), no "
        f"other MAC kernel; deterministic-mode warnings: {det_warnings or 'none'}")
    log(f"training: {graph_line(captured)}; captured step median {step_ms:.2f} ms "
        f"(mean {statistics.fmean(secs) * 1e3:.2f}, first step with the capture "
        f"{log_[0]['sec'] * 1e3:.1f} ms) = {tok_s:.0f} training tokens/s; eager "
        f"make_train_step median {ref['step_ms']:.2f} ms of steps 2-5 = "
        f"{TRAIN_M / (ref['step_ms'] / 1e3):.0f} tokens/s, peak "
        f"{ref['peak_bytes'] / 1e9:.2f} GB; checkpoint "
        f"save {save_block_s * 1e3:.1f} ms blocking (device-to-host) and "
        f"{save_s * 1e3:.1f} ms committed ({ckpt_bytes / 1e9:.3f} GB npz); peak device "
        f"memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated) on {card}")

    # one step under the near-memory baseline: every dense layer through #5
    state = trainer.state
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(TRAIN_STEPS).items()}
    nm_cfg = cfg.replace(quant=dataclasses.replace(
        cfg.quant, exec_spec=CiMExecSpec(formulation="exact", backend="cuda")))
    nm_step = make_train_step(nm_cfg, opt)
    reset_counts(tm, pm)
    t0 = time.perf_counter()
    _, nm = nm_step(state, batch)
    nm_loss = float(nm["loss"])
    nm_ms = (time.perf_counter() - t0) * 1e3
    nm_got = counts(tm, pm)
    nm_want = dict.fromkeys(nm_got, 0)
    nm_want["ternary_exact_matmul"] = per_step
    if nm_got != nm_want or not math.isfinite(nm_loss):
        fail(f"training under exact/cuda: launches {nm_got}, loss {nm_loss}")
    log(f"training: one step under exact/cuda: loss {nm_loss:.4f}, #5 launched "
        f"{per_step}, no other MAC kernel, {nm_ms:.1f} ms on {card}")

    # one profiled replay of the main path (three more steps on the state)
    host_batch = {k: torch.from_numpy(v) for k, v in pipe.batch(TRAIN_STEPS).items()}
    prof = profile_step(torch, lambda: inner(state, host_batch), drain=True, host=False)
    log(f"training: one profiled replay on {card}: " + busy_line(prof, step_ms))

    # the launcher, in process, on the card
    t0 = time.perf_counter()
    if launch_train.main(["--arch", "smollm-135m", "--steps", "3", "--quant", "cim"]) != 0:
        fail("training: the launcher failed")
    cli_s = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    log(f"training: the launcher (3 steps on cuda) in {cli_s:.1f} s; phase 17 wall "
        f"time {wall:.1f} s on {card}")
    numbers = {"capture_s": captured.capture_seconds, "pool_bytes": captured.pool_bytes,
               "replays": captured.replays, "eager": ref}
    del trainer, state, inner, counted, captured
    torch.cuda.empty_cache()
    return {"losses": losses, "replayed": [m["loss"] for m in again],
            "restarts": restarts, "step_ms": step_ms, "tokens_per_s": tok_s, **numbers,
            "launches": got["ternary_cim_matmul"], "launches_per_step": per_step,
            "save_blocking_s": save_block_s, "save_s": save_s, "ckpt_bytes": ckpt_bytes,
            "peak_bytes": peak, "nm_loss": nm_loss, "nm_ms": nm_ms,
            "profiled": profiled(prof), "cli_s": cli_s, "wall_s": wall,
            "deterministic_warnings": det_warnings}


# ---------------------------------------------------------------------------
# phase 18: training the ssm and hybrid families
# ---------------------------------------------------------------------------


# phase 18's mamba2-780m depth: its full width at 12 of 48 layers (at 48
# each checkpoint write and read moves ~8.5 GB; 24 before phase 28)
SSM_TRAIN_LAYERS = 12


def ssm_train_phase(torch, tm, pm, card, dev) -> dict:
    """Phase 18: mamba2-780m at full width (d 1536, vocab 50280, bf16,
    remat, the CiM spec: its config's, checked as phase 12 does) and
    SSM_TRAIN_LAYERS of its 48 layers, trained as phase 17 trains
    smollm-135m: seed-0 params, TokenPipeline
    seed 0 at batch 8 x seq 128, lr 3e-4 under warmup_cosine(20, 20), 20
    steps through the port's Trainer, checkpoints every 10 steps and a
    failure injected at step 15. The phase does not touch deterministic
    mode: Trainer.run() sets it and restores it, and the phase fails
    unless it is off again after the run. Every loss and grad norm
    finite, the last 5 steps' mean loss below the first 5's, one restart,
    steps 10-14 replayed bit-equal, #1 launched 2 x 48 = 96 times in
    every step (remat checkpoints each mamba layer) and no other MAC
    kernel, counted through the replays of the Trainer's captured step
    (make_jit_train_step), whose first 5 losses and grad norms must equal
    5 eager make_train_step steps' bit for bit. Then one step under
    exact/cuda (#5 192 times) and the same step under mode "off" (its
    grad norm beside the CiM ones), the captured and eager step medians,
    training tokens/s, the capture time and peak memory, one profiled
    replay. Then full-size zamba2-2.7b: 3 steps of make_jit_train_step
    (one captured graph; its in-place AdamW holds one copy of the 19.4 GB
    of f32 moments, where make_train_step's held two and peaked at 64-65
    GB) at the same batch, finite losses, #1 171 + 2 x 54 = 279 times a
    step (only the mamba layers sit under remat; the shared attention
    block does not, as in the reference), the step times, capture time
    and peak memory."""
    import tempfile
    import warnings

    from repro_torch.core.execution import CiMExecSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.train_step import (init_train_state, make_jit_train_step,
                                              make_train_step)
    from repro_torch.train.trainer import FailureInjector, TrainConfig, Trainer

    def full_size(arch):
        cfg = get_config(arch)
        want = dict(SSM_ARCHS[arch]["fields"], dtype="bfloat16", remat=True)
        got = {f: getattr(cfg, f) for f in want}
        if got != want or cfg.quant.mode != "cim":
            fail(f"not the full-size {arch} training config: {got}, {cfg.quant.mode}")
        return cfg

    t_phase = time.perf_counter()
    cfg = full_size("mamba2-780m").replace(n_layers=SSM_TRAIN_LAYERS)
    per_step = 2 * macs_per_step(cfg)   # the forward, then remat's recompute
    if per_step != 2 * 2 * SSM_TRAIN_LAYERS:
        fail(f"mamba2 training: {per_step} MACs a step, expected {4 * SSM_TRAIN_LAYERS}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    opt = AdamWConfig(lr=3e-4, schedule=warmup_cosine(20, TRAIN_STEPS))
    ref = eager_reference(torch, cfg, opt, pipe, dev)
    torch.cuda.reset_peak_memory_stats()
    if torch.are_deterministic_algorithms_enabled():
        fail("mamba2 training: deterministic mode is on before the Trainer runs")
    with tempfile.TemporaryDirectory() as ckpt_dir, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = Trainer(cfg, opt, TrainConfig(
            num_steps=TRAIN_STEPS, ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY,
            log_every=5), pipe, seed=0,
            failure_injector=FailureInjector([TRAIN_FAIL_AT]), device=dev)
        inner, per_call = trainer.step_fn, []

        def counted(state, batch):
            before = counts(tm, pm)
            out = inner(state, batch)
            per_call.append({k: v - before[k] for k, v in counts(tm, pm).items()})
            return out

        trainer.step_fn = counted
        reset_counts(tm, pm)
        t0 = time.perf_counter()
        log_ = trainer.run()
        run_s = time.perf_counter() - t0
        got = counts(tm, pm)
        peak = torch.cuda.max_memory_allocated()
        ckpt_bytes = sum(os.path.getsize(os.path.join(root, f))
                         for root, _, files in os.walk(ckpt_dir) for f in files)
    if torch.are_deterministic_algorithms_enabled():
        fail("mamba2 training: Trainer.run() left deterministic mode on")
    det_warnings = sorted({str(w.message).split(".")[0][:120] for w in caught
                           if "deterministic" in str(w.message)})
    captured = inner.captured
    if captured is None or captured.graph is None:
        fail("mamba2 training: the Trainer's step was not captured")
    check_against_eager(log_, ref, "mamba2 training")
    want = dict.fromkeys(got, 0)
    want["ternary_cim_matmul"] = per_step
    bad = [i for i, c in enumerate(per_call) if c != want]
    if bad:
        fail(f"mamba2 training: step calls {bad} launched {per_call[bad[0]]}, "
             f"expected {want}")
    if got["ternary_cim_matmul"] != per_step * len(per_call):
        fail(f"mamba2 training: #1 launched {got['ternary_cim_matmul']} times over "
             f"{len(per_call)} steps")
    steps = [m["step"] for m in log_]
    replayed = list(range(TRAIN_CKPT_EVERY, TRAIN_FAIL_AT))
    if trainer.restarts != 1 or steps != list(range(TRAIN_FAIL_AT)) + list(
            range(TRAIN_CKPT_EVERY, TRAIN_STEPS)) or len(per_call) != len(steps):
        fail(f"mamba2 training: restarts {trainer.restarts}, steps {steps}, "
             f"{len(per_call)} step calls")
    for m in log_:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            fail(f"mamba2 training: step {m['step']} loss {m['loss']} grad norm "
                 f"{m['grad_norm']}")
    first = {}
    for m in log_:
        first.setdefault(m["step"], m)
    again = log_[TRAIN_FAIL_AT:TRAIN_FAIL_AT + len(replayed)]
    for m in again:
        a = first[m["step"]]
        if (m["loss"], m["grad_norm"]) != (a["loss"], a["grad_norm"]):
            fail(f"mamba2 training: replayed step {m['step']} loss {m['loss']!r} grad "
                 f"norm {m['grad_norm']!r} != first pass {a['loss']!r} {a['grad_norm']!r}")
    losses = [first[i]["loss"] for i in range(TRAIN_STEPS)]
    head, tail = statistics.fmean(losses[:5]), statistics.fmean(losses[-5:])
    if not tail < head:
        fail(f"mamba2 training: the loss did not fall: first 5 {head:.4f}, "
             f"last 5 {tail:.4f}")
    secs = [m["sec"] for m in log_[1:]]
    step_ms = statistics.median(secs) * 1e3
    tok_s = TRAIN_M / (step_ms / 1e3)
    log(f"training mamba2-780m (full width, {cfg.n_layers} of 48 layers, bf16, remat, "
        f"CiM spec; batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}) on {card}: {len(steps)} steps in "
        f"{run_s:.1f} s ({TRAIN_STEPS} + {len(replayed)} replayed after the failure at "
        f"step {TRAIN_FAIL_AT}, restarts {trainer.restarts}); loss "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; first 5 mean {head:.4f} -> last 5 mean {tail:.4f}; steps 0-4 == 5 "
        f"eager make_train_step steps (loss and grad norm, bit for bit); replayed "
        f"steps {replayed} == their first pass (bit for bit) with deterministic "
        f"mode set by Trainer.run() alone (off again after it); #1 launched "
        f"{per_step} in each of the {len(per_call)} step calls "
        f"({got['ternary_cim_matmul']} in all, counted through the replays), no "
        f"other MAC kernel; deterministic-mode warnings: {det_warnings or 'none'}")
    log(f"mamba2 training: {graph_line(captured)}; captured step median "
        f"{step_ms:.2f} ms (mean {statistics.fmean(secs) * 1e3:.2f}, first step with "
        f"the capture {log_[0]['sec'] * 1e3:.1f} ms) = {tok_s:.0f} training "
        f"tokens/s; eager make_train_step median {ref['step_ms']:.2f} ms of steps 2-5 "
        f"= {TRAIN_M / (ref['step_ms'] / 1e3):.0f} tokens/s, peak "
        f"{ref['peak_bytes'] / 1e9:.2f} GB; grad norms "
        + " ".join(f"{first[i]['grad_norm']:.3f}" for i in range(TRAIN_STEPS))
        + f"; checkpoints on disk at the end {ckpt_bytes / 1e9:.2f} GB; peak device "
        f"memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated) on {card}")

    # one step under the near-memory baseline: every dense layer through #5
    state = trainer.state
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(TRAIN_STEPS).items()}
    nm_cfg = cfg.replace(quant=dataclasses.replace(
        cfg.quant, exec_spec=CiMExecSpec(formulation="exact", backend="cuda")))
    nm_step = make_train_step(nm_cfg, opt)
    reset_counts(tm, pm)
    t0 = time.perf_counter()
    _, nm = nm_step(state, batch)
    nm_loss = float(nm["loss"])
    nm_ms = (time.perf_counter() - t0) * 1e3
    nm_got = counts(tm, pm)
    nm_want = dict.fromkeys(nm_got, 0)
    nm_want["ternary_exact_matmul"] = per_step
    if nm_got != nm_want or not math.isfinite(nm_loss):
        fail(f"mamba2 training under exact/cuda: launches {nm_got}, loss {nm_loss}")
    log(f"mamba2 training: one step under exact/cuda: loss {nm_loss:.4f}, #5 launched "
        f"{per_step}, no other MAC kernel, {nm_ms:.1f} ms on {card}")
    # the same step under mode "off": the grad norm without the CiM STE
    off_cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, mode="off"))
    reset_counts(tm, pm)
    _, off = make_train_step(off_cfg, opt)(state, batch)
    off_loss, off_norm = float(off["loss"]), float(off["grad_norm"])
    if any(counts(tm, pm).values()) or not math.isfinite(off_norm):
        fail(f"mamba2 training under mode off: launches {counts(tm, pm)}, grad norm "
             f"{off_norm}")
    log(f"mamba2 training: the same step under mode off: loss {off_loss:.4f}, grad norm "
        f"{off_norm:.3f} (under exact/cuda {float(nm['grad_norm']):.3f}), no MAC kernel")
    host_batch = {k: torch.from_numpy(v) for k, v in pipe.batch(TRAIN_STEPS).items()}
    prof = profile_step(torch, lambda: inner(state, host_batch), drain=True, host=False)
    log(f"mamba2 training: one profiled replay on {card}: " + busy_line(prof, step_ms))
    graph_numbers = {"capture_s": captured.capture_seconds,
                     "pool_bytes": captured.pool_bytes, "replays": captured.replays,
                     "eager": ref}
    del trainer, state, nm_step, inner, counted, captured
    torch.cuda.empty_cache()
    out = {"mamba2_780m": {
        "losses": losses, "replayed": [m["loss"] for m in again], "restarts": 1,
        "step_ms": step_ms, "tokens_per_s": tok_s, "run_s": run_s,
        "launches": got["ternary_cim_matmul"], "launches_per_step": per_step,
        "grad_norms": [first[i]["grad_norm"] for i in range(TRAIN_STEPS)],
        "ckpt_bytes": ckpt_bytes, "peak_bytes": peak, "nm_loss": nm_loss,
        "nm_ms": nm_ms, "nm_grad_norm": float(nm["grad_norm"]), "off_loss": off_loss,
        "off_grad_norm": off_norm, "profiled": profiled(prof),
        "deterministic_warnings": det_warnings, **graph_numbers}}

    # zamba2-2.7b: 3 steps of make_jit_train_step (it fits the card: see
    # the docstring)
    cfg = full_size("zamba2-2.7b")
    z_per_step = macs_per_step(cfg) + 2 * cfg.n_layers
    if z_per_step != 279:
        fail(f"zamba2 training: {z_per_step} MACs a step, expected 279")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    step_fn = make_jit_train_step(cfg, opt)
    z_losses, z_secs, z_launches = [], [], 0
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
        reset_counts(tm, pm)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss, gnorm = torch.stack([metrics["loss"], metrics["grad_norm"]]).cpu().tolist()
        z_secs.append(time.perf_counter() - t0)
        z_got = counts(tm, pm)
        z_launches += z_got["ternary_cim_matmul"]
        z_want = dict.fromkeys(z_got, 0)
        z_want["ternary_cim_matmul"] = z_per_step
        if z_got != z_want:
            fail(f"zamba2 training: step {i} launched {z_got}, expected {z_want}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"zamba2 training: step {i} loss {loss} grad norm {gnorm}")
        z_losses.append(loss)
    z_peak = torch.cuda.max_memory_allocated()
    z_ms = statistics.median(z_secs[1:]) * 1e3
    z_graph = step_fn.captured
    if z_graph.graph is None or z_graph.replays != 2:
        fail(f"zamba2 training: the step was not captured and replayed "
             f"({z_graph.replays} replays)")
    log(f"training zamba2-2.7b (full size, bf16, remat, CiM spec; batch {TRAIN_BATCH} "
        f"x seq {TRAIN_SEQ}) on {card}: 3 steps of make_jit_train_step "
        f"({graph_line(z_graph)}), loss "
        + " ".join(f"{v:.4f}" for v in z_losses)
        + f"; #1 launched {z_per_step} in each step (171 forward + 108 remat; "
        f"{z_launches} in all), no other MAC kernel; step {z_secs[0] * 1e3:.1f}, "
        + ", ".join(f"{v * 1e3:.1f}" for v in z_secs[1:])
        + f" ms (median of the last 2 {z_ms:.1f} ms = {TRAIN_M / (z_ms / 1e3):.0f} "
        f"training tokens/s); state initialized in {init_s * 1e3:.1f} ms; peak device "
        f"memory {z_peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    z_numbers = {"capture_s": z_graph.capture_seconds, "pool_bytes": z_graph.pool_bytes}
    del state, step_fn, z_graph
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"phase 18 wall time {wall:.1f} s on {card}")
    out["zamba2_2_7b"] = {"losses": z_losses, "step_ms": z_ms,
                          "secs": z_secs, "launches": z_launches,
                          "launches_per_step": z_per_step,
                          "peak_bytes": z_peak, "init_s": init_s, **z_numbers}
    out["wall_s"] = wall
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# phase 19: the front door (HTTP + WebSocket) over two replicas
# ---------------------------------------------------------------------------

# two replicas of phase 3's batcher behind the front door; the burst of
# (d) is 12 requests at once against an admission cap of 4
DOOR_REPLICAS, DOOR_SLOTS, DOOR_S_MAX = 2, 4, 256
BURST, BURST_LIMIT = 12, 4


def door_args(**kw):
    """The launcher's parsed arguments for ``launch.serve.build_frontdoor``:
    its defaults, phase 19's shape, and ``kw``."""
    ns = dict(slots=DOOR_SLOTS, s_max=DOOR_S_MAX, temperature=0.0, seed=0,
              loop_decode=False, prepare_weights=False, profile=None,
              replicas=DOOR_REPLICAS, pace_us=0.0, queue_limit=64,
              host="127.0.0.1", port=0, tp=1, compress_tp=False)
    ns.update(kw)
    return argparse.Namespace(**ns)


def fmt_s(value) -> str:
    """A time in s for a log line; "none" where nothing was timed."""
    return "none" if value is None else f"{value:.3f} s"


def pct_line(block) -> str:
    """p50/p99 of an SLO aggregate of /stats, in ms."""
    return f"p50 {block['p50'] / 1e3:.2f} / p99 {block['p99'] / 1e3:.2f} ms (n {block['n']})"


def door_replicas(door, label) -> list:
    """Fail unless every replica of ``door`` kept one host sync per step
    and fill batch and replayed its decode graph; returns each replica's
    stats with its capture times."""
    out = []
    for w in door.router.workers:
        b = w.batcher
        st = b.stats()
        if st["host_syncs"] != st["decode_steps"] + st["prefill_batches"]:
            fail(f"{label}: replica {w.name} host_syncs {st}")
        if b._decode.graph is None or b._decode.replays <= 0:
            fail(f"{label}: replica {w.name}'s decode graph was not captured and "
                 f"replayed ({b._decode.replays} replays)")
        out.append(dict(st, name=w.name, decode_replays=b._decode.replays,
                        decode_capture_s=b.capture_seconds,
                        prefill_capture_s=b.prefill_capture_seconds,
                        prefill_graphs=len(b._prefill_steps)))
    return out


def frontdoor_phase(torch, tm, pm, card, dev, phase3_step_ms) -> dict:
    """Phase 19: full-size smollm-135m (per_row, blocked/cuda: #1 on every
    dense layer) behind the front door, 2 replicas x 4 slots on the one
    card, over real TCP, HTTP and WebSocket (see the module docstring)."""
    import asyncio
    import tempfile

    from repro_torch import api
    from repro_torch.launch import serve as launch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.profile import read_trace
    from repro_torch.serve.engine import Request, generate
    from repro_torch.serve.frontdoor import WSClient, http_json

    t_phase = time.perf_counter()
    cfg = get_config("smollm-135m")
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    spec = api.CiMExecSpec("blocked", "cuda")
    params = T.init_params(cfg, seed=0, device=dev)
    reqs = [(r.prompt, r.max_new) for r in make_requests(Request, cfg.vocab, seed=0)]
    t0 = time.perf_counter()
    want = [generate(params, [p], cfg, max_new=m, s_max=DOOR_S_MAX, exec_spec=spec,
                     device=dev)[0].tolist() for p, m in reqs]
    generate_s = time.perf_counter() - t0

    def check(ok, what):
        if not ok:
            fail(f"front door: {what}")

    async def stream_all(door):
        conns = [await WSClient.connect(door.host, door.port) for _ in reqs]
        res = await asyncio.gather(*[ws.generate(p, m) for ws, (p, m) in zip(conns, reqs)])
        for ws in conns:
            await ws.close()
        return [r["tokens"] for r in res]

    async def oneshot(door, i):
        return await http_json(door.host, door.port, "POST", "/v1/generate",
                               {"prompt": reqs[i][0], "max_new": reqs[i][1]})

    async def main_traffic(door):
        out = {}
        # (a) phase 3's 8 requests streamed concurrently
        out["a"] = await stream_all(door)
        # (b) a cancel after 2 tokens while another request streams
        w1 = await WSClient.connect(door.host, door.port)
        w2 = await WSClient.connect(door.host, door.port)
        out["victim"], out["survivor"] = await asyncio.gather(
            w1.generate(reqs[0][0], DOOR_S_MAX - 16, cancel_after=2),
            w2.generate(*reqs[1]))
        await w1.close()
        await w2.close()
        # (c) one-shot POST
        out["oneshot"] = await oneshot(door, 2)
        # (d) 12 requests at once, 6 over WebSocket and 6 over HTTP,
        # against an admission cap of 4
        door.router.queue_limit = BURST_LIMIT
        conns = [await WSClient.connect(door.host, door.port) for _ in range(BURST // 2)]

        async def ws_one(ws, i):
            try:
                return ("ws", i, (await ws.generate(*reqs[i]))["tokens"])
            except RuntimeError as e:
                return ("ws", i, getattr(e, "payload", {}).get("error"))

        async def http_one(i):
            status, body = await oneshot(door, i)
            return ("http", i, body["tokens"] if status == 200 else status)

        out["burst"] = await asyncio.gather(
            *[ws_one(ws, 2 * j % len(reqs)) for j, ws in enumerate(conns)],
            *[http_one((2 * j + 1) % len(reqs)) for j in range(BURST // 2)])
        for ws in conns:
            await ws.close()
        door.router.queue_limit = 64
        _, out["stats"] = await http_json(door.host, door.port, "GET", "/stats")
        # the SLOs of a warm pass: (a)'s requests again, every graph built
        door.tracker.reset()
        out["warm"] = await stream_all(door)
        _, out["warm_stats"] = await http_json(door.host, door.port, "GET", "/stats")
        return out

    async def run(args, body):
        door, profiler = launch.build_frontdoor(args, cfg, params, spec, dev)
        await door.start()
        try:
            out = await body(door)
        finally:
            await door.stop()
            if profiler is not None:
                profiler.close()
        for w in door.router.workers:
            check(w.load == 0, f"replica {w.name} still has load")
        return door, out

    # (a)-(e): the main path, counted from 0
    torch.cuda.synchronize()
    reset_counts(tm, pm)
    t0 = time.perf_counter()
    door, out = asyncio.run(run(door_args(), main_traffic))
    door_s = time.perf_counter() - t0
    got = counts(tm, pm)
    check(out["a"] == want, f"streams != generate(): {out['a']} vs {want}")
    check(out["warm"] == want, "the warm pass's streams != generate()")
    victim, survivor = out["victim"], out["survivor"]
    check(survivor["tokens"] == want[1] and not survivor["done"]["cancelled"],
          f"survivor {survivor}")
    ref0 = want[0]
    if len(victim["tokens"]) > len(ref0):
        ref0 = generate(params, [reqs[0][0]], cfg, max_new=len(victim["tokens"]),
                        s_max=DOOR_S_MAX, exec_spec=spec, device=dev)[0].tolist()
    check(victim["done"]["cancelled"] and 2 <= len(victim["tokens"]) < DOOR_S_MAX - 16
          and victim["tokens"] == ref0[:len(victim["tokens"])], f"cancelled {victim}")
    status, body = out["oneshot"]
    check(status == 200 and body["tokens"] == want[2], f"one-shot {status} {body}")
    served = [(kind, i, r) for kind, i, r in out["burst"] if isinstance(r, list)]
    ws_full = sum(kind == "ws" and r == "queue_full" for kind, _, r in out["burst"])
    http_429 = sum(kind == "http" and r == 429 for kind, _, r in out["burst"])
    check(ws_full >= 1 and http_429 >= 1 and len(served) + ws_full + http_429 == BURST
          and len(served) <= BURST_LIMIT, f"burst {out['burst']}")
    check(all(r == want[i] for _, i, r in served), "a burst request's tokens != generate()")
    stats = out["stats"]
    reqs_block = stats["slo"]["requests"]
    check(reqs_block["completed"] == len(reqs) + 2 + len(served)
          and reqs_block["cancelled"] == 1 and reqs_block["rejected"] == ws_full + http_429
          and stats["router"]["in_flight"] == 0, f"/stats {reqs_block} {stats['router']}")
    replicas = door_replicas(door, "front door")
    steps = sum(r["decode_steps"] + r["prefill_batches"] for r in replicas)
    per_step = macs_per_step(cfg)
    check(got["ternary_cim_matmul"] == per_step * steps,
          f"#1 launched {got['ternary_cim_matmul']} times, expected {per_step} x {steps}")
    check(not {k: v for k, v in got.items() if k != "ternary_cim_matmul" and v},
          f"other kernels launched {got}")
    warm = out["warm_stats"]["slo"]
    del door
    log(f"front door, full-size smollm-135m (per_row, blocked/cuda), {DOOR_REPLICAS} "
        f"replicas x {DOOR_SLOTS} slots, s_max {DOOR_S_MAX}, on {card}: (a) 8 "
        f"concurrent WebSocket streams == generate() ({sum(map(len, want))} tokens; "
        f"generate() took {generate_s:.1f} s eagerly); (b) cancelled after "
        f"{len(victim['tokens'])} tokens (a greedy prefix), survivor exact; (c) one-shot "
        f"POST exact; (d) burst of {BURST} at queue-limit {BURST_LIMIT}: {len(served)} "
        f"served exact, {ws_full} queue_full over WebSocket, {http_429} HTTP 429; (e) "
        f"/stats {reqs_block}, in_flight 0; #1 launched {got['ternary_cim_matmul']} = "
        f"{per_step} x {steps} (decode steps + fill batches over both replicas), no other "
        f"kernel; replicas "
        + "; ".join(f"{r['name']}: {r['decode_steps']} decode steps ({r['decode_replays']} "
                    f"replays), {r['prefill_batches']} fills, {r['host_syncs']} host syncs, "
                    f"decode capture {fmt_s(r['decode_capture_s'])}, {r['prefill_graphs']} "
                    f"prefill graphs in {fmt_s(r['prefill_capture_s'])}" for r in replicas)
        + f"; traffic (a)-(d) and the warm pass {door_s:.1f} s")
    log(f"front door SLOs of the warm pass (8 concurrent streams, every graph built; "
        f"/stats after tracker.reset()) on {card}: TTFT {pct_line(warm['slo_us']['ttft'])}; "
        f"per-token latency {pct_line(warm['slo_us']['tok_latency'])}; queue wait "
        f"{pct_line(warm['slo_us']['queue_wait'])}; e2e {pct_line(warm['slo_us']['e2e'])}; "
        f"goodput {warm['goodput_tok_s']:.1f} tok/s ({warm['tokens_out']} tokens in "
        f"{warm['uptime_s']:.3f} s)")

    # (f) the same traffic with a profiler on a file
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "door.jsonl")
        reset_counts(tm, pm)
        pdoor, pout = asyncio.run(run(door_args(profile=path), stream_all))
        events = read_trace(path)
    pgot = counts(tm, pm)
    check(pout == want, "the profiled run's streams != the unprofiled run's")
    preplicas = door_replicas(pdoor, "profiled front door")
    kinds = {k: [e for e in events if e.entry_point == k]
             for k in ("serve.decode_step", "serve.prefill", "frontdoor.request")}
    check(len(kinds["serve.decode_step"]) == sum(r["decode_steps"] for r in preplicas)
          and len(kinds["serve.prefill"]) == sum(r["prefill_batches"] for r in preplicas)
          and len(kinds["frontdoor.request"]) == len(reqs)
          and len(events) == sum(map(len, kinds.values())),
          f"trace events {[(k, len(v)) for k, v in kinds.items()]} against {preplicas}")
    psteps = sum(r["decode_steps"] + r["prefill_batches"] for r in preplicas)
    check(pgot["ternary_cim_matmul"] == per_step * psteps,
          f"profiled: #1 launched {pgot['ternary_cim_matmul']}, expected {per_step} x {psteps}")
    # a replica's step 0 is its decode capture; the rest are replays
    replays = [e for e in kinds["serve.decode_step"] if e.meta["step"] > 0]
    replay_us = [e.wall_us for e in replays]
    prefill_us = [e.wall_us for e in kinds["serve.prefill"]]
    replay_ms = statistics.median(replay_us) / 1e3
    dispatch_ms = statistics.median(e.dispatch_us for e in replays) / 1e3
    del pdoor
    log(f"profiled front door (same traffic, one Profiler on a JSON-lines file) on {card}: "
        f"{len(events)} events read back = {len(kinds['serve.decode_step'])} decode steps "
        f"+ {len(kinds['serve.prefill'])} fills + {len(reqs)} requests; tokens == the "
        f"unprofiled run's; #1 {pgot['ternary_cim_matmul']} = {per_step} x {psteps}; "
        f"replayed decode step wall_us median {replay_ms:.2f} ms (n {len(replay_us)}; "
        f"dispatch median {dispatch_ms:.2f} ms) beside phase 3's captured step median {phase3_step_ms:.2f} ms; fill wall_us "
        f"median {statistics.median(prefill_us) / 1e3:.2f} ms (n {len(prefill_us)}, first "
        f"fills of a bucket included)")

    # (g) the launcher's own selftest at full size
    t0 = time.perf_counter()
    rc = launch.main(["--serve-http", "--selftest", "--replicas", "2", "--port", "0"])
    check(rc == 0, f"the launcher's --selftest returned {rc}")
    selftest_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"launcher: main(['--serve-http', '--selftest', '--replicas', '2', '--port', "
        f"'0']) at full size returned 0 in {selftest_s:.1f} s; phase 19 wall time "
        f"{wall:.1f} s on {card}")
    return {"launches": got["ternary_cim_matmul"], "launches_per_step": per_step,
            "requests": reqs, "generated": want,
            "replicas": replicas, "stats": stats, "warm": warm,
            "profiled": {"replicas": preplicas, "decode_replay_ms": replay_ms,
                         "decode_wall_us": replay_us, "prefill_wall_us": prefill_us,
                         "events": len(events)},
            "phase3_step_ms": phase3_step_ms, "generate_s": generate_s,
            "traffic_s": door_s, "selftest_s": selftest_s, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 20: the hardware model and the calibrate -> replay loop
# ---------------------------------------------------------------------------

# the M of the calibration sweep: the decode class, then the prefill class
CALIB_M = (1, 2, 4, 8, 64, 128, 512, 1024)
CALIB_REPEATS = 5
# one smollm-135m layer's distinct (K, N)
CALIB_SHAPES = tuple(dict.fromkeys((k, n) for _, k, n in LAYER_SHAPES))
# the tile sweep's shapes: smollm-135m's gate/up at decode and training M
SWEEP_SHAPES = ((4, 576, 1536), (1024, 576, 1536))
# the reference's full-size bound on the replayed p50 decode step
# (benchmarks/bench_calibrate.py ERROR_BOUND_PCT["full"])
REPLAY_BOUND_PCT = 25.0
# which kernel a (spec, shape class) fit times
FIT_KERNELS = {"blocked/cuda/none": ("#1", "#1"), "exact/cuda/none": ("#5", "#5"),
               "blocked/cuda/bitplane_u8": ("#2", "#4"),
               "blocked/cuda_stream/bitplane_u8": ("#3", "#4")}


def calibration_phase(torch, tm, pm, card, dev, phase3_tokens) -> dict:
    """Phase 20: (a) calls of the four served specs under the profiler
    at smollm-135m's layer shapes and decode / prefill M, each timed as
    the device time of a CUDA-graph replay (``graph_kernel_events``: the
    captured step it predicts pays no host dispatch), fitted by
    ``profile.calibrate``; (b) the engine fit on a profiled captured
    batcher (phase 3's requests), replayed against a holdout run (4 other
    requests): exact step, fill and token counts, p50 step within
    REPLAY_BOUND_PCT; (c) ``hw.project`` of a 4-row decode on the paper's
    arrays beside the fitted kernels, and the holdout replayed with the
    MACs in 8T-SRAM CiM-I arrays; (d) the tile sweep of #1, #5 and #3,
    every candidate bit-equal to the plain version, the winners installed
    again from a calibration table, a new captured batcher with them
    installed giving phase 3's tokens."""
    import types

    from repro_torch import hw
    from repro_torch import profile as P
    from repro_torch.core import execution as X
    from repro_torch.core import ternary as tern
    from repro_torch.kernels import plan as kp
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import ShapeCell, get_config
    from repro_torch.quant.prepare import _canonicalize_packed
    from repro_torch.serve.engine import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    X.clear_tile_cache()
    specs = {name: X.CiMExecSpec(*name.split("/")) for name in FIT_KERNELS}

    # (a) the kernel sweep, with the profiler on
    prof = P.Profiler()
    g = torch.Generator(device=dev).manual_seed(20)
    for k, n in CALIB_SHAPES:
        w = torch.randint(-1, 2, (k, n), generator=g, device=dev).to(torch.bfloat16)
        p1, p2 = tern.pack_ternary(w.to(torch.int8), axis=0)
        one = torch.ones(n, device=dev)
        stored = {name: _canonicalize_packed({"w": (p1, p2, one)}, spec, dev)["w"]
                  for name, spec in specs.items() if spec.packing == "bitplane_u8"}
        for m in CALIB_M:
            x = torch.randint(-1, 2, (m, k), generator=g, device=dev).to(torch.bfloat16)
            for name, spec in specs.items():
                if name in stored:
                    call = (lambda s=spec, pl=stored[name], a=x: X.execute_packed(s, a, pl))
                else:
                    call = (lambda s=spec, a=x, b=w: X.execute(s, a, b))
                call()  # warm-up, not recorded
                prev = P.set_profiler(prof)
                try:
                    with X.graph_kernel_events():
                        for _ in range(CALIB_REPEATS):
                            call()
                finally:
                    P.set_profiler(prev)
    kernel_events = list(prof.events)
    want = len(CALIB_SHAPES) * len(CALIB_M) * len(specs) * CALIB_REPEATS
    if len(kernel_events) != want:
        fail(f"calibration: {len(kernel_events)} kernel events, expected {want}")
    kernel_table = P.calibrate(kernel_events, backend="cuda",
                               default_spec="blocked/cuda/none")
    keys = {f"{s}|{c}" for s in FIT_KERNELS for c in ("decode", "prefill")}
    if set(kernel_table.kernels) != keys:
        fail(f"calibration: kernel fits {sorted(kernel_table.kernels)}")
    fits = {}
    for key, fit in sorted(kernel_table.kernels.items()):
        spec_name, cls = key.split("|")
        kernel = FIT_KERNELS[spec_name][cls == "prefill"]
        values = (fit.fixed_us, fit.us_per_mmac, fit.us_per_mb, fit.residual_pct)
        if not all(math.isfinite(v) and v >= 0 for v in values) or fit.n_events != (
                len(CALIB_SHAPES) * 4 * CALIB_REPEATS):
            fail(f"calibration: fit {key} {fit}")
        fits[key] = dict(dataclasses.asdict(fit), kernel=kernel)
        log(f"calibration fit {kernel} ({key}, {fit.n_events} graph-timed calls at M "
            f"{[m for m in CALIB_M if (m <= 8) == (cls == 'decode')]}, K,N "
            f"{list(CALIB_SHAPES)}) on {card}: fixed_us {fit.fixed_us}, us_per_mmac "
            f"{fit.us_per_mmac}, us_per_mb {fit.us_per_mb} ({fit.bytes_per_weight} B "
            f"a weight), residual_pct {fit.residual_pct}")

    # (b) the engine fit and the holdout replay
    cfg = get_config("smollm-135m")
    params = T.init_params(cfg, seed=0, device=dev)
    cfgs = {cfg.name: cfg}
    kernel_model = P.make_kernel_model(kernel_table, cfgs)

    def serve(reqs, label):
        sprof = P.Profiler()
        batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, seed=0,
                                    device=dev, profile=sprof)
        for r in reqs:
            batcher.submit(r)
        batcher.run()
        if batcher._decode.graph is None:
            fail(f"calibration {label}: the decode step was not captured")
        if not all(r.done for r in reqs):
            fail(f"calibration {label}: not every request finished")
        return batcher, sprof.events, [list(r.generated) for r in reqs]

    _, fit_events, fit_tokens = serve(make_requests(Request, cfg.vocab, seed=0), "fit run")
    if fit_tokens != phase3_tokens:
        fail(f"calibration: the profiled fit run's tokens {fit_tokens} != phase 3's")
    table = dataclasses.replace(kernel_table,
                                engines=P.fit_engines(fit_events, kernel_model))
    engine = table.engine_fit(cfg.name)
    hold_b, hold_events, hold_tokens = serve(four_requests(Request, cfg.vocab), "holdout")
    reqs = P.requests_from_trace(hold_events)
    pred = P.simulate(table, cfg.name, reqs, n_slots=4, s_max=256,
                      kernel_model=kernel_model)
    cmp = P.compare_to_measured(pred, hold_events)
    tokens = sum(len(t) for t in hold_tokens)
    counts_ok = (pred["decode_steps"] == hold_b.decode_steps == cmp["measured_steps"]
                 and pred["prefill_batches"] == hold_b.prefill_batches
                 and pred["tokens"] == tokens)
    share = kernel_model(cfg.name, 4)
    log(f"calibration replay on {card}: engine fit (phase 3's 8 requests, "
        f"{engine.n_decode} decode steps, {engine.n_prefill} fills): decode_fixed_us "
        f"{engine.decode_fixed_us}, prefill_us {engine.prefill_us}, residual_pct "
        f"{engine.residual_pct}; the kernel model's share of a 4-slot step "
        f"{share:.1f} us (210 graph-fitted #1 calls) beside the fit run's measured "
        f"median step {statistics.median(e.wall_us for e in fit_events if e.entry_point == 'serve.decode_step'):.1f} us; "
        f"holdout (4 requests): predicted {pred['decode_steps']} decode steps, "
        f"{pred['prefill_batches']} fills, {pred['tokens']} tokens against measured "
        f"{hold_b.decode_steps}, {hold_b.prefill_batches}, {tokens}; p50 step "
        f"predicted {cmp['predicted_p50_us']} us, measured {cmp['measured_p50_us']} us: "
        f"error {cmp['p50_error_pct']}% (bound {REPLAY_BOUND_PCT}%); tok/s predicted "
        f"{cmp['predicted_tok_s']}, measured {cmp['measured_tok_s']} (event time, "
        f"captures included)")
    if not counts_ok:
        fail(f"calibration: replayed counts {pred['decode_steps']}, "
             f"{pred['prefill_batches']}, {pred['tokens']} != the holdout's "
             f"{hold_b.decode_steps}, {hold_b.prefill_batches}, {tokens}")
    if not cmp["p50_error_pct"] <= REPLAY_BOUND_PCT:
        fail(f"calibration: replayed p50 error {cmp['p50_error_pct']}% > "
             f"{REPLAY_BOUND_PCT}%: {cmp}")

    # (c) the paper's arrays against the card
    cell = ShapeCell("decode_b4", "decode", 256, 4)
    projections = {}
    for tech in hw.PAPER_TECHNOLOGIES:
        for design in ("CiM-I", "CiM-II"):
            r = hw.project(cfg, cell, hw.ArraySpec(technology=tech, design=design),
                           calibration=table)
            cal = r["calibrated"]
            if not (r["time_ns"] > 0 and cal["time_us"] > 0
                    and math.isfinite(cal["cim_speedup_vs_host"])):
                fail(f"calibration: projection {tech}/{design} {r}")
            projections[f"{tech}/{design}"] = {
                "time_ns": r["time_ns"], "tok_s": r["tok_s"],
                "energy_pj": r["energy_pj"],
                "iso_capacity_speedup": r["iso_capacity"]["speedup"],
                "calibrated_time_us": cal["time_us"], "calibrated_tok_s": cal["tok_s"],
                "cim_speedup_vs_host": cal["cim_speedup_vs_host"]}
            log(f"projection smollm-135m decode, batch 4, {tech}/{design}: analytic CiM "
                f"{r['time_ns']:.1f} ns a forward ({r['tok_s']:.0f} tok/s, "
                f"{r['iso_capacity']['speedup']:.2f}x the iso-capacity NM); the fitted "
                f"kernels on {card}: {cal['time_us']:.1f} us ({cal['tok_s']:.0f} tok/s); "
                f"cim_speedup_vs_host {cal['cim_speedup_vs_host']:.1f}")
    array_model = P.make_array_kernel_model(
        cfgs, hw.ArraySpec(technology="8T-SRAM", design="CiM-I"))
    apred = P.simulate(table, cfg.name, reqs, n_slots=4, s_max=256,
                       kernel_model=array_model)
    if (apred["decode_steps"], apred["tokens"]) != (pred["decode_steps"], pred["tokens"]):
        fail(f"calibration: the array replay's counts {apred}")
    log(f"holdout replayed with its MACs in 8T-SRAM/CiM-I arrays (the fitted "
        f"per-step fixed cost kept): {apred['tok_s']} tok/s, p50 step "
        f"{apred['p50_step_us']} us; with the fitted kernels {pred['tok_s']} tok/s, "
        f"p50 {pred['p50_step_us']} us; the array share of a 4-slot step "
        f"{array_model(cfg.name, 4):.2f} us against {share:.1f} us")

    # (d) the tile sweep
    sweep_specs = ((specs["blocked/cuda/none"], SWEEP_SHAPES),
                   (specs["exact/cuda/none"], SWEEP_SHAPES),
                   (specs["blocked/cuda_stream/bitplane_u8"], SWEEP_SHAPES[:1]))
    sms = kp.device_sms(dev)
    winners, sweep = {}, {}
    for spec, shapes in sweep_specs:
        report = X.autotune(spec, shapes=shapes, repeats=CALIB_REPEATS)
        for m, k, n in shapes:
            cls = X.shape_class(m)
            x = torch.randint(-1, 2, (m, k), generator=g, device=dev).to(torch.int8)
            w = torch.randint(-1, 2, (k, n), generator=g, device=dev).to(torch.int8)
            if spec.packing == "bitplane_u8":
                p1, p2 = tern.pack_ternary(w, axis=0)
                plain = pm.packed_matmul_plain(x, p1, p2, n_out=n)
                run = lambda: X.execute_packed(spec, x.float(), p1, p2)  # noqa: E731
                wrapper = pm.packed_cim_matmul_decode_stream
            else:
                plain = (tm.ternary_cim_matmul_plain(x, w) if spec.formulation == "blocked"
                         else tm.exact_matmul_plain(x, w))
                run = lambda: X.execute(spec, x.float(), w.float())  # noqa: E731
                wrapper = (tm.ternary_cim_matmul if spec.formulation == "blocked"
                           else tm.ternary_exact_matmul)
            for tiles in X.tile_candidates(spec, cls, k):
                X.autotune(spec, calibration=types.SimpleNamespace(
                    tile_winners={spec.name: {cls: tiles}}))
                if not torch.equal(run(), plain):
                    fail(f"tile sweep: {spec.name} at {(m, k, n)} on grid {tiles} "
                         f"differs from the plain version")
                if (wrapper.last_plan.rows, wrapper.last_plan.cluster) != tiles[:2]:
                    fail(f"tile sweep: {spec.name} launched {wrapper.last_plan}, "
                         f"installed {tiles}")
            entry = report[cls]
            winners.setdefault(spec.name, {})[cls] = entry["tiles"]
            sweep[f"{spec.name}|{cls}"] = {
                "shape": [m, k, n], "winner": list(entry["tiles"]), "us": entry["us"],
                "default": list(entry["default"]), "default_us": entry["default_us"],
                "candidates": entry["candidates"]}
            log(f"tile sweep {spec.name} at (M, K, N) = {(m, k, n)} on {card}: winner "
                f"{entry['tiles']} {entry['us']} us a call, launch_plan's "
                f"{entry['default']} {entry['default_us']} us "
                f"({entry['default_us'] / entry['us']:.3f}x); every candidate (us): "
                f"{entry['candidates']}; all {len(entry['candidates'])} bit-equal to "
                f"the plain version")
    X.clear_tile_cache()
    table = dataclasses.replace(table, tile_winners=winners)
    for spec, shapes in sweep_specs:
        report = X.autotune(spec, calibration=table)
        for m, k, n in shapes:
            cls = X.shape_class(m)
            got = report[cls]
            if got["tiles"] != tuple(winners[spec.name][cls]) or got["us"] is not None:
                fail(f"tile sweep: calibration installed {got} for {spec.name}/{cls}")
            want = kp.tuned_plan(m, k, n, sms, winner=winners[spec.name][cls],
                                 rows=8 if spec.packing == "bitplane_u8" else None)
            if X.kernel_plan(spec, m, k, n, sms, rows=want.rows) != want:
                fail(f"tile sweep: {spec.name}/{cls} plan after install")
    tuned = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, seed=0, device=dev)
    treqs = make_requests(Request, cfg.vocab, seed=0)
    for r in treqs:
        tuned.submit(r)
    tuned.run()
    tuned_tokens = [list(r.generated) for r in treqs]
    if tuned._decode.graph is None or tuned_tokens != phase3_tokens:
        fail("tile sweep: a batcher captured with the winners installed does not "
             "give phase 3's tokens")
    X.clear_tile_cache()
    wall = time.perf_counter() - t_phase
    log(f"tile sweep: winners {winners} installed again from a calibration table "
        f"without timing; a batcher captured with them gives phase 3's tokens; "
        f"cache cleared. Phase 20 wall time {wall:.1f} s on {card}")
    return {"fits": fits, "engine": dataclasses.asdict(engine),
            "kernel_share_us_at_4": share, "replay": cmp,
            "predicted": {k: v for k, v in pred.items() if k != "graph"},
            "array_replay": {k: v for k, v in apred.items() if k != "graph"},
            "projections": projections, "winners": {s: {c: list(t) for c, t in v.items()}
                                                    for s, v in winners.items()},
            "sweep": sweep, "table": table.to_json(), "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 21: tensor-parallel serving over 3 gloo ranks on the one card
# ---------------------------------------------------------------------------

TP_DEGREE = 3
# smollm-135m's row-parallel layers at tp=3: (name, K, N); each rank's K
# shard (192, 512) must be whole 16-row blocks
TP_ROW_SHAPES = (("wo", 576, 576), ("w_down", 1536, 576))
TP_ROW_M = (1, 4, 64, 128)
# the stored planes split over N: gate/up and down; #2 at M 4, #4 at 128,
# #3 (cuda_stream) at 4 (its prefill delegate #4 at 128)
TP_PLANE_SHAPES = ((576, 1536), (1536, 576))
TP_PLANE_M = (4, 128)
TP_TIMEOUT_S = 400.0
# the --compress-tp leg serves phase 3's requests cut to this many new
# tokens each (its readings, the greedy prefix, the collectives a step and
# the first fill's and step's per-call bounds, need no more; at 8-16 it
# took 28 steps, ~48 s on an H100 80GB HBM3 at 700 W)
TP_COMPRESS_MAX_NEW = 3
# the collectives gloo was asked to run on CUDA tensors
GLOO_PROBES = ("all_reduce sum f32", "all_reduce sum bf16", "all_reduce sum int32",
               "all_reduce max f32", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single")


def gloo_probe(torch, mesh, dev) -> dict:
    """Which collectives gloo takes on CUDA tensors here: each probe's
    result checked against its expected value, or the error it raised."""
    import torch.distributed as dist

    n, r, g = mesh.size, mesh.rank, mesh.group
    out = {}

    def ones(dtype=torch.float32, k=4):
        return torch.full((k,), float(r + 1), device=dev).to(dtype)

    def run(name):
        want_sum = float(n * (n + 1) // 2)
        if name.startswith("all_reduce"):
            dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                     "int32": torch.int32}[name.split()[-1]]
            x = ones(dtype)
            op = dist.ReduceOp.MAX if " max " in name else dist.ReduceOp.SUM
            dist.all_reduce(x, op=op, group=g)
            return bool((x.float() == (n if op == dist.ReduceOp.MAX else want_sum)).all())
        if name == "broadcast":
            x = ones()
            dist.broadcast(x, src=0, group=g)
            return bool((x == 1).all())
        if name == "all_gather":
            parts = [torch.empty(4, device=dev) for _ in range(n)]
            dist.all_gather(parts, ones(), group=g)
            return all(bool((p == i + 1).all()) for i, p in enumerate(parts))
        if name == "all_gather_into_tensor":
            o = torch.empty(4 * n, device=dev)
            dist.all_gather_into_tensor(o, ones(), group=g)
            return bool((o.view(n, 4)[:, 0] == torch.arange(1, n + 1, device=dev)).all())
        if name == "reduce_scatter_tensor":
            o = torch.empty(4, device=dev)
            dist.reduce_scatter_tensor(o, ones(k=4 * n), group=g)
            return bool((o == want_sum).all())
        o = torch.empty(n, device=dev)
        dist.all_to_all_single(o, ones(k=n), group=g)
        return bool((o == torch.arange(1, n + 1, device=dev)).all())

    for name in GLOO_PROBES:
        try:
            out[name] = "ok" if run(name) else "wrong result"
        except RuntimeError as e:   # a collective gloo refuses on CUDA tensors
            out[name] = f"refused: {str(e).splitlines()[0][:120]}"
        dist.barrier(group=g)
    return out


def tp_compressed_layers(torch, params, cfg, mesh, dev) -> list:
    """The first fill and decode step of a ``compress_tp`` batcher on
    phase 3's requests, every row-parallel MAC (``layers.
    execute_row_shard``) also run exact on the same operands: per call,
    (went compressed, max |compressed - exact|, the bound ranks *
    amax/127 * 1.5 with amax the shared scale's, bit-equal, one rounding
    step amax/127 over the median |partial| of this rank)."""
    from repro_torch.dist import collectives as C
    from repro_torch.models import layers
    from repro_torch.serve.engine import ContinuousBatcher, Request

    real_row, real_psum = layers.execute_row_shard, C.compressed_psum_int8
    amax, calls = [], []

    def psum(x, group, generator):
        top = float(C.all_reduce(x.abs().amax().reshape(1), group, op="max"))
        # one rounding step against the typical size of this rank's partials
        amax.append((top, top / 127.0 / max(float(x.abs().median()), 1e-30)))
        return real_psum(x, group, generator)

    def row(spec, x_t, w_rows, mesh, *, compressed=False, generator=None):
        got = real_row(spec, x_t, w_rows, mesh, compressed=compressed,
                       generator=generator)
        exact = real_row(spec, x_t, w_rows, mesh)
        top, ratio = amax.pop() if compressed else (0.0, 0.0)
        calls.append((compressed, float((got - exact).abs().max()),
                      mesh.size * top / 127.0 * 1.5, torch.equal(got, exact), ratio))
        return got

    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, seed=0, device=dev,
                                mesh=mesh, compress_tp=True)
    for r in make_requests(Request, cfg.vocab, seed=0):
        batcher.submit(r)
    layers.execute_row_shard, C.compressed_psum_int8 = row, psum
    try:
        batcher.step()
    finally:
        layers.execute_row_shard, C.compressed_psum_int8 = real_row, real_psum
    st = batcher.stats()
    return calls, st["decode_steps"] + st["prefill_batches"]


def tp_rank(mesh, phase3_tokens) -> dict:
    """Phase 21 on one rank (``launch.mesh.spawn_tp`` runs it on each):
    the gloo probe; full-size smollm-135m served eagerly on the rank's
    shard over phase 3's requests, with the launch counts at 0 just
    before, tokens == phase 3's, #1 launched 210 x (steps + fills) and
    the row-parallel K shards whole blocks; the same under
    ``compress_tp``, with one MAX all-reduce more per row-parallel layer
    and every row-parallel MAC of its first fill and step within its
    bound of the exact sum (:func:`tp_compressed_layers`); ``execute_tp`` through #1 and ``execute_packed_tp``
    through #2/#4 and #3/#4, each bit-equal to ``execute`` /
    ``execute_packed`` on the same operands. Raises on any failure
    (``spawn_tp`` then ends every rank and raises)."""
    import torch

    from repro_torch.core import execution as X
    from repro_torch.dist import collectives as C
    from repro_torch.kernels import packed_mac as pm
    from repro_torch.kernels import ternary_mac as tm
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.quant.prepare import prepare_for_spec
    from repro_torch.serve.engine import ContinuousBatcher, Request

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"phase 21 rank {mesh.rank}: {what}")

    dev = torch.device("cuda", 0)
    out = {"gloo": gloo_probe(torch, mesh, dev)}
    cfg = get_config("smollm-135m")
    params = T.init_params(cfg, seed=0, device=dev)
    per_step = macs_per_step(cfg)
    runs = {}
    for compress in (False, True):
        batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, seed=0,
                                    device=dev, mesh=mesh, compress_tp=compress)
        check(not batcher.graphed, "a TP batcher's steps must run eagerly")
        reqs = make_requests(Request, cfg.vocab, seed=0)
        if compress:
            for r in reqs:
                r.max_new = min(r.max_new, TP_COMPRESS_MAX_NEW)
        fills = []
        reset_counts(tm, pm)
        C.reset_counts()
        secs, step_ms = drive(torch, batcher, reqs, fills=fills,
                              counter=lambda: counts(tm, pm)["ternary_cim_matmul"])
        got, st = counts(tm, pm), batcher.stats()
        steps = st["decode_steps"] + st["prefill_batches"]
        check(all(r.done for r in reqs), "not every request finished")
        check(got["ternary_cim_matmul"] == per_step * steps
              and all(n == per_step for _, _, n in fills)
              and not any(v for k, v in got.items() if k != "ternary_cim_matmul"),
              f"launches {got} over {steps} steps and fills {fills}")
        runs[compress] = {
            "tokens": [r.generated for r in reqs], "stats": st, "secs": secs,
            "step_ms": step_ms, "fill_ms": [ms for ms, _, _ in fills],
            "launches": got["ternary_cim_matmul"], "steps": steps, "per_step": per_step,
            "collectives": dict(C.COUNTS)}
        if not compress:
            blocks = batcher.params["blocks"]
            out["row_shards"] = {name: tuple(blocks[part][name].w.shape[-2:])
                                 for part, name in (("attn", "wo"), ("mlp", "w_down"))}
            out["local_heads"] = (batcher.cfg.n_heads, batcher.cfg.n_kv_heads)
            out["cache_shape"] = tuple(batcher.caches.k.shape)
        del batcher
    check(runs[False]["tokens"] == phase3_tokens,
          f"TP tokens {runs[False]['tokens']} != phase 3's {phase3_tokens}")
    check(all(k % 16 == 0 for k, _ in out["row_shards"].values()),
          f"row-parallel K shards {out['row_shards']} are not whole blocks")
    out["serve"], out["compressed"] = runs[False], runs[True]
    # the compressed path: one MAX all-reduce (the shared scale) more per
    # row-parallel layer and forward than the exact path, the same gathers,
    # a step or fill (it serves fewer tokens: TP_COMPRESS_MAX_NEW); every
    # row-parallel MAC of a fill and a step within its bound of the exact
    # sum of the same partials, and not bit-equal to it
    ex, co = runs[False], runs[True]
    check(co["collectives"]["all_reduce"] * ex["steps"]
          == (ex["collectives"]["all_reduce"] + 2 * cfg.n_layers * ex["steps"]) * co["steps"]
          and co["collectives"]["all_gather"] * ex["steps"]
          == ex["collectives"]["all_gather"] * co["steps"],
          f"compressed collectives {co['collectives']} over {co['steps']} steps and fills "
          f"against exact {ex['collectives']} over {ex['steps']}")
    calls, fwd = tp_compressed_layers(torch, params, cfg, mesh, dev)
    check(fwd >= 2 and len(calls) == 2 * cfg.n_layers * fwd
          and all(c and err <= bound and not same for c, err, bound, same, _ in calls),
          f"compressed row-parallel MACs over {fwd} forwards: {calls}")
    out["compressed_layers"] = {
        "calls": len(calls), "forwards": fwd,
        "max_err_over_bound": max(err / bound for _, err, bound, _, _ in calls),
        # per row-parallel layer (wo and w_down alternate in each layer)
        "step_over_median": {kind: [c[4] for c in calls[i::2]]
                             for i, kind in enumerate(("wo", "w_down"))}}
    out["first_token"] = tp_first_token_margins(torch, params, cfg, mesh, dev)

    # the explicit TP functions, bit-equal to one device's on the same
    # operands; only the TP calls' launches are counted
    g = torch.Generator(device=dev).manual_seed(21)
    launched = dict.fromkeys(KERNELS, 0)

    def tp_call(fn):
        before = counts(tm, pm)
        got = fn()
        for k, v in counts(tm, pm).items():
            launched[k] += v - before[k]
        return got

    rows = []
    spec = X.CiMExecSpec("blocked", "cuda")
    for name, k, n in TP_ROW_SHAPES:
        w = torch.randint(-1, 2, (k, n), generator=g, device=dev).to(torch.bfloat16)
        for m in TP_ROW_M:
            x = torch.randint(-1, 2, (m, k), generator=g, device=dev).to(torch.float32)
            got = tp_call(lambda: X.execute_tp(spec, x, w, mesh))
            check(torch.equal(got, X.execute(spec, x, w)),
                  f"execute_tp {name} M={m} differs")
            rows.append(f"{name} M={m}")
    explicit_tp = dict(launched)
    launched.update(dict.fromkeys(KERNELS, 0))
    planes_checked = []
    for name in ("blocked/cuda/bitplane_u8", "blocked/cuda_stream/bitplane_u8"):
        pspec = X.CiMExecSpec(*name.split("/"))
        for k, n in TP_PLANE_SHAPES:
            w = {"wq": torch.randint(-1, 2, (k, n), generator=g, device=dev).to(torch.bfloat16)}
            shard = prepare_for_spec(w, pspec, mesh=mesh)[1]["wq"]
            whole = prepare_for_spec(w, pspec)[1]["wq"]
            for m in TP_PLANE_M:
                x = torch.randint(-1, 2, (m, k), generator=g, device=dev).to(torch.float32)
                got = tp_call(lambda: X.execute_packed_tp(pspec, x, shard, mesh))
                check(torch.equal(got, X.execute_packed(pspec, x, whole)),
                      f"execute_packed_tp {name} ({k}, {n}) M={m} differs")
                planes_checked.append(f"{name.split('/')[1]} ({k}, {n}) M={m}")
    check(launched["packed_cim_matmul_decode"] and launched["packed_cim_matmul"]
          and launched["packed_cim_matmul_decode_stream"]
          and explicit_tp["ternary_cim_matmul"] == len(rows),
          f"TP calls launched {explicit_tp}, {launched}")
    out["explicit"] = {"execute_tp": rows, "execute_packed_tp": planes_checked,
                       "launches_tp": explicit_tp, "launches_packed": dict(launched)}
    torch.cuda.synchronize()
    return out


def tp_phase(torch, card, phase3) -> dict:
    """Phase 21: full-size smollm-135m served over TP_DEGREE gloo ranks on
    the one card (``launch.mesh.spawn_tp``, every rank on cuda:0, the
    kernels already built by phase 1), phase 3's requests, eager (gloo's
    collectives cannot be captured); tokens == phase 3's, #1 launched in
    every rank 210 x (steps + fills), the row-parallel K shards whole
    blocks; the compressed path's greedy-prefix agreement with the exact
    one; the explicit TP functions through #1-#4, bit-equal. A rank's
    failure or a run past TP_TIMEOUT_S fails the script. The eager TP
    step is timed beside phase 3's eager single-device step: three ranks
    share one card, so it is a record, not a speed-up."""
    from repro_torch.launch.mesh import spawn_tp

    import gc

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()   # the ranks' memory comes from the same card
    try:
        out = spawn_tp(tp_rank, TP_DEGREE, phase3["generated"], timeout=TP_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"tensor-parallel serving: {e}")
    out["wall_s"] = time.perf_counter() - t_phase
    log("tp: gloo on CUDA tensors: " + "; ".join(f"{k}: {v}" for k, v in out["gloo"].items()))
    exact, comp = out["serve"], out["compressed"]
    prefix = [next((i for i, (a, b) in enumerate(zip(c, e)) if a != b), len(c))
              for c, e in zip(comp["tokens"], exact["tokens"])]
    out["compressed_prefix"] = prefix
    tp_ms = statistics.median(exact["step_ms"])
    out["numbers"] = {
        "tp_eager_step_ms": tp_ms,
        "tp_compressed_eager_step_ms": statistics.median(comp["step_ms"]),
        "single_eager_step_ms": phase3["eager_step_ms"],
        "single_captured_step_ms": phase3["captured_step_ms"],
        "tp_fill_ms": statistics.median(exact["fill_ms"]),
        "tp_tok_s": sum(map(len, exact["tokens"])) / exact["secs"],
        "collectives_per_step": {k: v / exact["steps"]
                                 for k, v in exact["collectives"].items()}}
    num = out["numbers"]
    log(f"tp: full-size smollm-135m over {TP_DEGREE} gloo ranks on {card} "
        f"(heads {out['local_heads'][0]}, kv heads {out['local_heads'][1]} a rank; "
        f"cache leaf {out['cache_shape']}; row-parallel K shards {out['row_shards']}): "
        f"tokens == phase 3's for all {len(exact['tokens'])} requests; "
        f"{exact['stats']['decode_steps']} decode steps, "
        f"{exact['stats']['prefill_batches']} fills, {exact['stats']['host_syncs']} host "
        f"syncs; #1 launched {exact['launches']} = {exact['per_step']} x {exact['steps']} "
        f"in rank 0 (and "
        f"checked in every rank); eager TP step {tp_ms:.2f} ms median against phase 3's "
        f"eager single-device step {phase3['eager_step_ms']:.2f} ms (captured "
        f"{phase3['captured_step_ms']:.2f} ms); fill {num['tp_fill_ms']:.2f} ms median; "
        f"{num['tp_tok_s']:.1f} tok/s; collectives per step or fill "
        f"{num['collectives_per_step']}")
    log(f"tp: --compress-tp ({TP_COMPRESS_MAX_NEW} new tokens a request at most): "
        f"{sum(map(len, comp['tokens']))} tokens in {comp['steps']} steps and fills, greedy "
        f"prefix shared with the exact path per request {prefix} (of "
        f"{[len(t) for t in comp['tokens']]}); step {num['tp_compressed_eager_step_ms']:.2f}"
        f" ms median; {comp['collectives']} collectives (one MAX all-reduce a "
        f"row-parallel layer more than the exact path's {exact['collectives']}); "
        f"its {out['compressed_layers']['calls']} row-parallel MACs over "
        f"{out['compressed_layers']['forwards']} forwards each within its bound of the "
        f"exact sum and not equal to it, largest error / bound "
        f"{out['compressed_layers']['max_err_over_bound']:.4f}")
    ratios = out["compressed_layers"]["step_over_median"]
    first = out["first_token"]
    margins = [m for _, m, _, _ in first]
    out["numbers"]["first_token"] = {
        "margins": margins, "compressed_errors": [e for _, _, e, _ in first],
        "argmax_moved": [moved for _, _, _, moved in first],
        "step_over_median": {k: (min(v), statistics.median(v), max(v))
                             for k, v in ratios.items()}}
    log(f"tp: --compress-tp at each request's first token (rid, exact top-2 logit "
        f"margin, max |compressed - exact| logit, argmax moved): "
        + "; ".join(f"{rid} {m:.4g} {e:.4g} {moved}" for rid, m, e, moved in first)
        + f"; one rounding step amax/127 over the median |partial| of a rank, "
        f"(min, median, max) over the first fill's and step's layers: "
        + "; ".join(f"{k} ({min(v):.3g}, {statistics.median(v):.3g}, {max(v):.3g})"
                    for k, v in ratios.items()))
    ex = out["explicit"]
    log(f"tp: execute_tp == execute bit for bit through #1 at {ex['execute_tp']} "
        f"(launches {ex['launches_tp']}); execute_packed_tp == execute_packed through "
        f"#2/#4 and #3/#4 at {ex['execute_packed_tp']} (launches {ex['launches_packed']}); "
        f"phase wall time {out['wall_s']:.1f} s")
    return out


def tp_first_token_margins(torch, params, cfg, mesh, dev) -> list:
    """Why ``--compress-tp`` parts at the first token: phase 3's requests
    through an exact TP batcher, up to its last fill, whose every fill
    also runs, on copies of the fresh caches, the compressed forward of
    the same inputs. Per request, at the fill that samples its first
    token: the exact logits' top-2 margin, the compressed logits' largest
    difference from them, and whether the argmax moved. Returns [(rid,
    margin, error, moved)]."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ContinuousBatcher, Request

    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, seed=0, device=dev,
                                mesh=mesh)
    comp_cfg = batcher.cfg.replace(quant=dataclasses.replace(batcher.cfg.quant,
                                                             tp_reduce="int8"))
    real, out = T.decode_step, []

    def step(params_, tokens, caches, index, cfg_, start=None, enc=None):
        if isinstance(index, int) and index == 0:   # a fill: the fresh caches
            copies = T.map_caches(lambda leaf: leaf.clone(), caches)
            comp = real(params_, tokens, copies, 0, comp_cfg, start=start)[0][:, -1]
            exact, caches = real(params_, tokens, caches, 0, cfg_, start=start)
            fill = batcher._fill_host[1].numpy()
            for s, req in enumerate(batcher.slot_req):
                if fill[s] and req is not None:
                    top2 = exact[s, -1].float().topk(2).values
                    out.append((req.rid, float(top2[0] - top2[1]),
                                float((comp[s].float() - exact[s, -1].float()).abs().max()),
                                int(comp[s].argmax()) != int(exact[s, -1].argmax())))
            return exact, caches
        return real(params_, tokens, caches, index, cfg_, start=start, enc=enc)

    for r in make_requests(Request, cfg.vocab, seed=0):
        batcher.submit(r)
    T.decode_step = step
    try:
        while batcher.queue:     # every request's first token is a fill's
            batcher.step()
    finally:
        T.decode_step = real
    return sorted(out)


# ---------------------------------------------------------------------------
# phase 22: the ssm, hybrid and moe families over 2 gloo ranks on the one card
# ---------------------------------------------------------------------------

TP_FAMILY_DEGREE = 2
# arch -> layers served (None: full depth); mamba2-780m and zamba2-2.7b at
# full width and 6 of 48 and 54 layers (zamba2: one application of the
# shared block, every hybrid_attn_every = 6; 12 before phase 27), which
# keeps the script within its time limit beside phases 26-27; deepseek-v2
# at full width and 1 of its 60 layers (2 before phase 26: two ranks' host
# trees of ~17 GB each); whisper's decoder (the batcher takes no enc) at
# full width and 4 of its 32 layers (8 before phase 27), over its tree
# with the encoder and cross attention placed too; llava at
# full width and 2 of its 60 layers (2.04 B parameters, 4.08 GB a rank,
# of which the untied vocabulary tables are 0.92 B)
TP_FAMILY_ARCHS = {"mamba2-780m": 6, "zamba2-2.7b": 6, "deepseek-v2-236b": 1,
                   "whisper-large-v3": 4, "llava-next-34b": 2}
# the archs served on phase 11's and 14's four requests (4 prompts, 8 new
# tokens: 8 decode steps and a fill, where phase 3's 8 requests take 25
# and 3), which keeps the script within its time limit
TP_FAMILY_FOUR = ("whisper-large-v3", "llava-next-34b")
# the new tokens request i of phase 3's takes at most in phase 22:
# TP_FAMILY_MAX_NEW[i % 4] (uncapped before phase 28); staggered, so the
# requests end on different steps and a fill lands in a slot beside live
# ones (the TP per-slot state and cache reset of a refill)
TP_FAMILY_MAX_NEW = (2, 3, 4, 5)
TP_FAMILY_TIMEOUT_S = 600.0


def tp_family_cfg(arch, mode="cim"):
    from repro_torch.models.layers import QuantConfig
    from repro_torch.models.registry import get_config

    cfg = get_config(arch)
    if TP_FAMILY_ARCHS[arch]:
        cfg = cfg.replace(n_layers=TP_FAMILY_ARCHS[arch])
    return cfg.replace(quant=QuantConfig(mode="off")) if mode == "off" else cfg


def tp_family_requests(Request, arch, vocab):
    """Phase 22's requests of ``arch``: phase 3's, request i at most
    TP_FAMILY_MAX_NEW[i % 4] new tokens, or four_requests for
    TP_FAMILY_FOUR."""
    if arch in TP_FAMILY_FOUR:
        return four_requests(Request, vocab)
    reqs = make_requests(Request, vocab, seed=0)
    for i, r in enumerate(reqs):
        r.max_new = min(r.max_new, TP_FAMILY_MAX_NEW[i % len(TP_FAMILY_MAX_NEW)])
    return reqs


def refilled_mid_stream(arch, reqs, stats, n_slots=4) -> bool:
    """Whether a fill of phase 22's run landed beside live slots: fills
    that each start from an empty batch number ceil(requests / slots),
    so one more means a refill mid-stream (TP_FAMILY_FOUR's four requests
    fill once)."""
    return arch in TP_FAMILY_FOUR or stats["prefill_batches"] > -(-len(reqs) // n_slots)


def first_fill_logits(torch, params, cfg, dev, mesh=None):
    """Phase 3's first 4 prompts left-padded into one batch and prefilled
    through ``decode_step`` on a batcher's params and caches (the rank's
    shard under ``mesh``): the last column's logits (4, V) as float32."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ContinuousBatcher, Request

    prompts = [r.prompt for r in make_requests(Request, cfg.vocab, seed=0)[:4]]
    batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=256, device=dev, mesh=mesh)
    s_pad = max(map(len, prompts))
    tokens = torch.zeros((4, s_pad), dtype=torch.int64)
    for i, p in enumerate(prompts):
        tokens[i, s_pad - len(p):] = torch.tensor(p)
    start = torch.tensor([s_pad - len(p) for p in prompts])
    with torch.no_grad():
        logits, _ = T.decode_step(batcher.params, tokens.to(dev), batcher.caches, 0,
                                  batcher.cfg, start=start.to(dev))
    return logits[:, -1].float().cpu()


def tp_family_rank(mesh, singles, dev_name="cuda") -> dict:
    """Phase 22 on one rank: per arch of TP_FAMILY_ARCHS, the whole seeded
    tree made on the card one rank at a time and held on the host, the
    rank's shard cut there and moved (``ContinuousBatcher(mesh=)``); its
    requests (``tp_family_requests``) served eagerly with the launch counts
    at 0 just before:
    tokens == the single device's, #1 launched macs_per_step x (steps +
    fills) and macs_per_step in every fill; the collectives of a decode
    step at 2 slots, times the steps and fills, equal to the 4-slot run's;
    mamba2-780m also in mode "off" (tokens
    and the first fill's logits, held by the parent). Raises on any
    failure."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    from repro_torch.kernels import packed_mac as pm
    from repro_torch.kernels import ternary_mac as tm
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ContinuousBatcher, Request

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"phase 22 rank {mesh.rank}: {what}")

    dev = torch.device(dev_name, 0) if dev_name == "cuda" else torch.device(dev_name)
    out = {}
    for arch in TP_FAMILY_ARCHS:
        cfg = tp_family_cfg(arch)
        for turn in range(mesh.size):
            # one rank at a time makes the whole tree on the card and keeps
            # it on the host: never two whole copies on the card at once
            if turn == mesh.rank:
                card = T.init_params(cfg, seed=0, device=dev)
                host = _host_tree(card)
                del card
                _free(torch)
            dist.barrier(group=mesh.group)
        per_step = macs_per_step(cfg)
        batcher = ContinuousBatcher(host, cfg, n_slots=4, s_max=256, seed=0, device=dev,
                                    mesh=mesh)
        check(not batcher.graphed, f"{arch}: a TP batcher's steps must run eagerly")
        reqs = tp_family_requests(Request, arch, cfg.vocab)
        fills = []
        reset_counts(tm, pm)
        C.reset_counts()
        secs, step_ms = drive(torch, batcher, reqs, fills=fills,
                              counter=lambda: counts(tm, pm)["ternary_cim_matmul"])
        got, st = counts(tm, pm), batcher.stats()
        steps = st["decode_steps"] + st["prefill_batches"]
        tokens = [r.generated for r in reqs]
        check(tokens == singles[arch]["tokens"],
              f"{arch}: TP tokens {tokens} != the single device's {singles[arch]['tokens']}")
        check(refilled_mid_stream(arch, reqs, st),
              f"{arch}: no fill beside live slots ({st['prefill_batches']} fills of "
              f"{len(reqs)} requests)")
        check(got["ternary_cim_matmul"] == per_step * steps
              and all(n == per_step for _, _, n in fills)
              and not any(v for k, v in got.items() if k != "ternary_cim_matmul"),
              f"{arch}: launches {got} over {steps} steps and fills {fills}")
        rec = {"tokens": tokens, "stats": st, "secs": secs, "step_ms": step_ms,
               "fill_ms": [ms for ms, _, _ in fills], "launches": got["ternary_cim_matmul"],
               "steps": steps, "per_step": per_step, "collectives": dict(C.COUNTS),
               "local": {k: getattr(batcher.cfg, k) for k in (
                   ("n_heads",) if cfg.family == "moe"
                   else ("n_heads", "n_kv_heads") if cfg.family in ("encdec", "vlm")
                   else ("ssm_n_heads", "ssm_d_inner")
                   + (("n_heads",) if cfg.family == "hybrid" else ()))},
               "cache_shapes": [tuple(leaf.shape) for leaf in T.cache_leaves(batcher.caches)]}
        del batcher
        _free(torch)
        # a decode step at 2 slots runs the collectives of every step and
        # fill of the 4-slot run (their totals over its forwards)
        b = ContinuousBatcher(host, cfg, n_slots=2, s_max=256, seed=0, device=dev,
                              mesh=mesh)
        for i in range(2):
            b.submit(Request(i, [1 + i, 2], max_new=4))
        b.step()                     # the fill and the first decode step
        C.reset_counts()
        b.step()                     # a decode step alone
        two = dict(C.COUNTS)
        del b
        _free(torch)
        check(rec["collectives"] == {k: v * steps for k, v in two.items()},
              f"{arch}: a 2-slot decode step's collectives {two} against the 4-slot "
              f"run's {rec['collectives']} over {steps} steps and fills")
        rec["step_collectives"] = two
        if arch == "mamba2-780m":
            off = tp_family_cfg(arch, "off")
            b = ContinuousBatcher(host, off, n_slots=4, s_max=256, seed=0, device=dev,
                                  mesh=mesh)
            reqs = tp_family_requests(Request, arch, cfg.vocab)
            secs_off, step_ms_off = drive(torch, b, reqs)
            rec["off"] = {"tokens": [r.generated for r in reqs], "secs": secs_off,
                          "step_ms": step_ms_off,
                          "logits": first_fill_logits(torch, host, off, dev, mesh)}
            del b
            _free(torch)
        out[arch] = rec
        del host
        _free(torch)
    return out


def _free(torch) -> None:
    """Free what a dropped batcher held now: its steps' closures make a
    reference cycle, which only the collector breaks."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _host_tree(tree):
    return {k: _host_tree(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}


def tp_family_phase(torch, card, dev) -> dict:
    """Phase 22: full-width mamba2-780m and zamba2-2.7b (6 layers each),
    whisper-large-v3 (its decoder, 4 of 32 layers) and full-width
    deepseek-v2-236b (1 of 60 layers) and llava-next-34b (2 of 60) served over
    TP_FAMILY_DEGREE gloo
    ranks on the one card (``tp_family_rank``), phase 3's requests
    (whisper and llava: four_requests), eager; first the same requests
    single-device, eager, on the same
    seeded weights (and mamba2-780m in mode "off", with its first fill's
    logits). A rank's failure or a run past TP_FAMILY_TIMEOUT_S fails the
    script. The eager TP step is printed beside the eager single-device
    step: two ranks share one card, so it is a record, not a speed-up."""
    from repro_torch.launch.mesh import spawn_tp
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    singles = {}
    for arch in TP_FAMILY_ARCHS:
        cfg = tp_family_cfg(arch)
        params = T.init_params(cfg, seed=0, device=dev)
        modes = ("cim", "off") if arch == "mamba2-780m" else ("cim",)
        for mode in modes:
            mcfg = tp_family_cfg(arch, mode)
            batcher = ContinuousBatcher(params, mcfg, n_slots=4, s_max=256, seed=0,
                                        device=dev)
            batcher.graphed = False
            reqs = tp_family_requests(Request, arch, cfg.vocab)
            secs, step_ms = drive(torch, batcher, reqs)
            rec = {"tokens": [r.generated for r in reqs], "secs": secs, "step_ms": step_ms,
                   "stats": batcher.stats()}
            del batcher
            _free(torch)
            if mode == "off":
                rec["logits"] = first_fill_logits(torch, params, mcfg, dev)
                singles[arch]["off"] = rec
            else:
                singles[arch] = rec
        del params
        _free(torch)
    try:
        out = spawn_tp(tp_family_rank, TP_FAMILY_DEGREE,
                       {a: {"tokens": s["tokens"]} for a, s in singles.items()},
                       dev.type, timeout=TP_FAMILY_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"tensor-parallel serving of the other families: {e}")
    out["wall_s"] = time.perf_counter() - t_phase
    numbers = {}
    for arch in TP_FAMILY_ARCHS:
        tp, one = out[arch], singles[arch]
        tp_ms, one_ms = statistics.median(tp["step_ms"]), statistics.median(one["step_ms"])
        numbers[arch] = {"tp_eager_step_ms": tp_ms, "single_eager_step_ms": one_ms,
                         "tp_fill_ms": statistics.median(tp["fill_ms"]),
                         "tp_tok_s": sum(map(len, tp["tokens"])) / tp["secs"],
                         "collectives_per_step": {k: v / tp["steps"]
                                                  for k, v in tp["collectives"].items()},
                         "step_collectives": tp["step_collectives"]}
        log(f"tp families: {arch} ({tp_family_cfg(arch).n_layers} layers) over "
            f"{TP_FAMILY_DEGREE} gloo ranks on {card} (a rank's widths {tp['local']}; "
            f"cache leaves {tp['cache_shapes']}): tokens == the single device's for all "
            f"{len(tp['tokens'])} requests; {tp['stats']['decode_steps']} decode steps, "
            f"{tp['stats']['prefill_batches']} fills; #1 launched {tp['launches']} = "
            f"{tp['per_step']} x {tp['steps']} in rank 0 (and checked in every rank); "
            f"eager TP step {tp_ms:.2f} ms median against the eager single-device step "
            f"{one_ms:.2f} ms; fill {numbers[arch]['tp_fill_ms']:.2f} ms median; "
            f"{numbers[arch]['tp_tok_s']:.1f} tok/s; collectives per step or fill "
            f"{numbers[arch]['collectives_per_step']}; a decode step's at 2 slots "
            f"{tp['step_collectives']}, the same")
    off_tp, off_one = out["mamba2-780m"]["off"], singles["mamba2-780m"]["off"]
    prefix = [next((i for i, (a, b) in enumerate(zip(t, o)) if a != b), len(o))
              for t, o in zip(off_tp["tokens"], off_one["tokens"])]
    logit_diff = float((torch.as_tensor(off_tp["logits"]) - off_one["logits"]).abs().max())
    numbers["mamba2-780m"]["off"] = {
        "greedy_prefix": prefix, "max_logit_diff": logit_diff,
        "tp_eager_step_ms": statistics.median(off_tp["step_ms"]),
        "single_eager_step_ms": statistics.median(off_one["step_ms"])}
    log(f"tp families: mamba2-780m mode \"off\" over {TP_FAMILY_DEGREE} ranks: greedy "
        f"prefix with the single device per request {prefix} (of "
        f"{[len(t) for t in off_one['tokens']]}); first fill's logits differ by at most "
        f"{logit_diff:.6g}; eager TP step {numbers['mamba2-780m']['off']['tp_eager_step_ms']:.2f}"
        f" ms against {numbers['mamba2-780m']['off']['single_eager_step_ms']:.2f} ms; "
        f"phase wall time {out['wall_s']:.1f} s")
    out["numbers"] = numbers
    for arch in TP_FAMILY_ARCHS:
        out[arch].pop("off", None)
    return out


# ---------------------------------------------------------------------------
# phase 23: the analysis contracts on the card
# ---------------------------------------------------------------------------

# the slot counts of the full-size step's audit (one op count across them)
ANALYSIS_SLOTS = (4, 8)
# the CLI's own time limit (its TP combinations spawn gloo ranks)
ANALYSIS_CLI_TIMEOUT_S = 300


def analysis_phase(torch, tm, pm, card, dev) -> dict:
    """Phase 23: repro_torch.analysis on the card. The CLI (``python -m
    repro_torch.analysis --check --json``) runs in a subprocess beside the
    rest: it must exit 0, and every contract combination that skips on
    the CPU (the cuda and cuda_stream points) must be audited here. (a)
    serve.fused_decode_step.cim's step at full size (phase 3's seeded
    smollm-135m params, mode "cim", s_max 256) on CUDA tensors at
    n_slots 4 and 8: the contract's rules, 0 host syncs, 0 host->device
    copies, one op count across both, #1 launched 210 times a call and
    no other kernel; (b) one eager step and one replay of the step
    captured (serve.graph.CapturedStep) under
    torch.cuda.set_sync_debug_mode("error"); (c) the contracts' SASS pins
    on the SASS check_sass read (every instance of #2 and #3 on int8
    tensor cores, #3's asynchronous copies and their wait)."""
    import tempfile

    from repro_torch.analysis import op_audit as O
    from repro_torch.analysis.contracts import (
        get_trace_contract,
        registered_trace_contracts,
    )
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import fused_step_point
    from repro_torch.serve.graph import CapturedStep

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="analysis-")
    report_path = os.path.join(tmp, "report.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--json",
         report_path], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        # (a) the full-size step, audited on the card
        cfg = get_config("smollm-135m")
        if cfg.quant.mode != "cim" or cfg.n_layers != 30:
            fail(f"phase 23 needs full-size smollm-135m in mode cim: {cfg}")
        params = T.init_params(cfg, seed=0, device=dev)
        point = get_trace_contract("serve.fused_decode_step.cim")
        build = fused_step_point("cim", s_max=256, cfg=cfg, params=params, device=dev)
        ops, kernels = {}, {}
        for n in ANALYSIS_SLOTS:
            fn, args = build(n_slots=n)
            trace = O.trace_ops(fn, args)
            found = O.check_trace(trace, point.contract, point.name)
            if found:
                fail(f"analysis: {point.name} at n_slots={n} on the card: "
                     + "; ".join(f"{f.rule}: {f.message}" for f in found))
            syncs = sum(O.is_host_sync(r) for r in trace)
            h2d = sum(O.is_host_to_device(r) for r in trace)
            ops[n], kernels[n] = O.total_ops(trace), O.kernel_launches(trace)
            if syncs or h2d:
                fail(f"analysis: {syncs} host syncs, {h2d} host->device copies "
                     f"in the full-size step at n_slots={n}")
            if kernels[n] != {"ternary_cim_mac": 210}:
                fail(f"analysis: the full-size step launched {kernels[n]}, "
                     f"not #1 210 times, at n_slots={n}")
        if len(set(ops.values())) != 1:
            fail(f"analysis: the full-size step's op count varies with n_slots: {ops}")
        audit_s = time.perf_counter() - t0

        # (b) no synchronizing call in an eager step nor in a replay
        fn, args = build(n_slots=ANALYSIS_SLOTS[0])
        p, tokens, caches, positions, start, gen = args
        step = CapturedStep(lambda tok, pos, st: fn(p, tok, caches, pos, st, gen)[0],
                            [tokens, positions, start], dev)
        step()                    # warm-up and capture (a capture syncs)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = fn(*args)[0]
            replayed = step()
        except RuntimeError as e:
            fail(f"analysis: a synchronizing call in the step under sync debug "
                 f"mode: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if eager.shape != replayed.shape or step.replays != 1:
            fail(f"analysis: eager {tuple(eager.shape)} / replayed "
                 f"{tuple(replayed.shape)} tokens, {step.replays} replays")
        del step

        # (c) the SASS pins on the SASS check_sass read
        texts = {wrappers(tm, pm)[k].entry: v for k, v in SASS_TEXT.items()}
        pinned = [q for q in registered_trace_contracts() if q.contract.sass_pins]
        sass_found = [f for q in pinned for f in O.check_sass(q.contract, q.name, texts)]
        if sass_found:
            fail("analysis: SASS pins: " + "; ".join(f.message for f in sass_found))
        n_pins = sum(len(q.contract.sass_pins) for q in pinned)

        # (d) the CLI
        out, _ = cli.communicate(timeout=ANALYSIS_CLI_TIMEOUT_S)
    except BaseException:
        cli.kill()
        cli.wait()
        raise
    if cli.returncode != 0:
        fail(f"analysis: python -m repro_torch.analysis --check exited "
             f"{cli.returncode}:\n{out[-4000:]}")
    with open(report_path) as f:
        report = json.load(f)
    combo_skips = {name: [s for s in meta["skipped"] if not s.startswith("sass ")]
                   for name, meta in report["contracts"].items()}
    if any(combo_skips.values()) or len(report["contracts"]) != 13:
        fail(f"analysis: contracts not audited on the card: "
             f"{ {k: v for k, v in combo_skips.items() if v} }")
    secs = time.perf_counter() - t0
    counts = {name: sorted(set(meta["op_counts"].values()))
              for name, meta in report["contracts"].items()}
    sass_skips = sum(len(meta["skipped"]) for meta in report["contracts"].values())
    log(f"analysis: {len(report['contracts'])} contracts, "
        f"{report['summary']['total']} findings, {sass_skips} skips (SASS pins, "
        f"applied here: {n_pins} pins over {sum(len(v) for v in texts.values())} "
        f"instances); full-size step ops {ops} by n_slots, #1 "
        f"{kernels[ANALYSIS_SLOTS[0]]['ternary_cim_mac']} a call, 0 host syncs, 0 "
        f"host->device copies, no sync under debug mode; CLI --check 0, op counts "
        f"{counts}; audit {audit_s:.1f} s, phase {secs:.1f} s on {card}")
    return {"ops": {str(k): v for k, v in ops.items()}, "cli_op_counts": counts,
            "findings": report["summary"]["total"], "sass_pins": n_pins,
            "audit_s": audit_s, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 24: the front door over tensor-parallel replicas
# ---------------------------------------------------------------------------

# 2 replicas x 3 ranks, six gloo processes on the one card (3 is the
# smallest degree that splits smollm-135m's 9 heads and 3 kv heads), and
# phase 19's first DOOR_TP_STREAMS requests
DOOR_TP_REPLICAS, DOOR_TP = 2, 3
DOOR_TP_STREAMS = 4
# new tokens a stream (phase 19's max_new capped: its generate() tokens'
# prefix), which keeps the script within its time limit
DOOR_TP_MAX_NEW = 6
# the replicas' command timeout (launch.serve.TP_TIMEOUT_S for the phase)
DOOR_TP_TIMEOUT_S = 300.0


def frontdoor_tp_phase(torch, card, dev, phase19) -> dict:
    """Phase 24: full-size smollm-135m (per_row, blocked/cuda) behind the
    front door over DOOR_TP_REPLICAS replicas, each a rank group of
    DOOR_TP gloo processes on the one card, built by the launcher's
    build_frontdoor (``--serve-http --tp``): (a) phase 19's first
    requests (at most DOOR_TP_MAX_NEW new tokens) streamed concurrently
    == the prefix of phase 19's generate(); (b) one
    request cancelled after 2 tokens while another streams on the other
    replica; /stats: the mesh, one host sync per step and fill in rank 0,
    #1 launched macs_per_step x (steps + fills) in every rank of every
    replica (their counts start at 0 with the processes) and no other
    kernel, the cancel on its replica and in no rank's slot table; the
    SLOs of (a); the stop's time, and no rank process alive after it."""
    import asyncio
    import multiprocessing

    from repro_torch import api
    from repro_torch.launch import serve as launch
    from repro_torch.models.registry import get_config
    from repro_torch.serve.frontdoor import WSClient, http_json

    t_phase = time.perf_counter()
    cfg = get_config("smollm-135m")
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    spec = api.CiMExecSpec("blocked", "cuda")
    reqs = [(p, min(m, DOOR_TP_MAX_NEW)) for p, m in phase19["requests"][:DOOR_TP_STREAMS]]
    want = [w[:m] for w, (_, m) in zip(phase19["generated"], reqs)]
    per_step = macs_per_step(cfg)

    def check(ok, what):
        if not ok:
            fail(f"front door over TP replicas: {what}")

    async def traffic(door):
        out = {}
        t0 = time.perf_counter()
        conns = [await WSClient.connect(door.host, door.port) for _ in reqs]
        res = await asyncio.gather(*[ws.generate(p, m) for ws, (p, m) in zip(conns, reqs)])
        for ws in conns:
            await ws.close()
        out["a"], out["a_s"] = res, time.perf_counter() - t0
        _, out["a_stats"] = await http_json(door.host, door.port, "GET", "/stats")
        w1 = await WSClient.connect(door.host, door.port)
        w2 = await WSClient.connect(door.host, door.port)
        out["victim"], out["survivor"] = await asyncio.gather(
            w1.generate(reqs[0][0], DOOR_S_MAX - 16, cancel_after=2),
            w2.generate(*reqs[1]))
        await w1.close()
        await w2.close()
        _, out["stats"] = await http_json(door.host, door.port, "GET", "/stats")
        return out

    saved = launch.TP_TIMEOUT_S
    launch.TP_TIMEOUT_S = DOOR_TP_TIMEOUT_S
    try:
        t0 = time.perf_counter()
        door, _ = launch.build_frontdoor(
            door_args(replicas=DOOR_TP_REPLICAS, tp=DOOR_TP), cfg, None, spec, dev)
        start_s = time.perf_counter() - t0
        replicas = [w.batcher for w in door.router.workers]
        procs = [p for rep in replicas for p in rep.procs]

        async def run():
            await door.start()
            try:
                return await traffic(door)
            finally:
                ts = time.perf_counter()
                await door.stop()
                stop_s.append(time.perf_counter() - ts)

        stop_s = []
        out = asyncio.run(run())
    except (RuntimeError, TimeoutError) as e:
        fail(f"front door over TP replicas: {e}")
    finally:
        launch.TP_TIMEOUT_S = saved
    alive = [p.pid for p in procs if p.is_alive()]
    check(not alive and not set(procs) & set(multiprocessing.active_children()),
          f"rank processes {alive} alive after door.stop()")
    got = [r["tokens"] for r in out["a"]]
    check(got == want, f"streams {got} != the prefix of phase 19's generate() {want}")
    victim, survivor = out["victim"], out["survivor"]
    check(survivor["tokens"] == want[1] and not survivor["done"]["cancelled"],
          f"survivor {survivor}")
    n = min(len(victim["tokens"]), len(want[0]))
    check(victim["done"]["cancelled"] and n >= 2
          and len(victim["tokens"]) < DOOR_S_MAX - 16
          and victim["tokens"][:n] == want[0][:n], f"cancelled {victim}")
    check(victim["done"]["replica"] != survivor["done"]["replica"],
          f"victim and survivor on one replica: {victim['done']} {survivor['done']}")
    stats = out["stats"]
    check(stats["mesh"] == {"data": DOOR_TP_REPLICAS, "model": DOOR_TP},
          f"/stats mesh {stats['mesh']}")
    check(stats["slo"]["requests"]["cancelled"] == 1
          and stats["slo"]["requests"]["completed"] == len(reqs) + 1
          and stats["router"]["in_flight"] == 0, f"/stats {stats['slo']['requests']}")
    rows = {}
    for r in stats["router"]["replicas"]:
        steps = r["decode_steps"] + r["prefill_batches"]
        launches = r["launches"]
        check(r["tp"] == DOOR_TP and r["failed"] is None and len(r["rank_slots"]) == DOOR_TP
              and all(slot is None for slots in r["rank_slots"] for slot in slots),
              f"replica {r['name']}: {r}")
        check(r["host_syncs"] == steps, f"replica {r['name']} host syncs {r}")
        check(launches["ternary_cim_matmul"] == per_step * steps
              and not any(v for k, v in launches.items() if k != "ternary_cim_matmul"),
              f"replica {r['name']}: launches {launches} over {steps} steps and fills "
              f"(every rank agreed)")
        rows[r["name"]] = {k: r[k] for k in ("decode_steps", "prefill_batches", "host_syncs",
                                             "completed", "cancelled", "ranks")}
        rows[r["name"]]["launches"] = launches["ternary_cim_matmul"]
    hit = rows[victim["done"]["replica"]]
    check(hit["cancelled"] == 1, f"the cancel is not on replica {victim['done']['replica']}: "
          f"{rows}")
    slo = out["a_stats"]["slo"]
    wall = time.perf_counter() - t_phase
    log(f"front door over TP replicas: full-size smollm-135m (per_row, blocked/cuda), "
        f"{DOOR_TP_REPLICAS} replicas x tp {DOOR_TP} ({DOOR_TP_REPLICAS * DOOR_TP} gloo "
        f"processes on {card}), {DOOR_SLOTS} slots, s_max {DOOR_S_MAX}: started in "
        f"{start_s:.1f} s; (a) {len(reqs)} concurrent WebSocket streams == the prefix of "
        f"phase 19's generate() ({sum(map(len, want))} tokens in {out['a_s']:.1f} s); "
        f"(b) cancelled "
        f"after {len(victim['tokens'])} tokens on {victim['done']['replica']} (a greedy "
        f"prefix), survivor exact on {survivor['done']['replica']}; /stats mesh "
        f"{stats['mesh']}; per replica (rank 0; every rank agreed each step) "
        + "; ".join(f"{name}: {r['decode_steps']} decode steps, {r['prefill_batches']} "
                    f"fills, {r['host_syncs']} host syncs, #1 {r['launches']} = {per_step} "
                    f"x {r['decode_steps'] + r['prefill_batches']}, completed "
                    f"{r['completed']}, cancelled {r['cancelled']}, world ranks {r['ranks']}"
                    for name, r in rows.items())
        + f"; door.stop() {stop_s[0]:.2f} s, no rank process alive after it")
    log(f"front door over TP replicas, SLOs of (a) on {card}: TTFT "
        f"{pct_line(slo['slo_us']['ttft'])}")
    log(f"front door over TP replicas, per-token latency of (a): "
        f"{pct_line(slo['slo_us']['tok_latency'])}")
    log(f"front door over TP replicas, goodput of (a): {slo['goodput_tok_s']:.1f} tok/s "
        f"({slo['tokens_out']} tokens in {slo['uptime_s']:.3f} s); phase 24 wall time "
        f"{wall:.1f} s")
    return {"replicas": rows, "mesh": stats["mesh"], "slo": slo, "start_s": start_s,
            "traffic_a_s": out["a_s"], "stop_s": stop_s[0], "wall_s": wall,
            "launches_per_step": per_step}


# ---------------------------------------------------------------------------
# phase 25: data-parallel training
# ---------------------------------------------------------------------------

# the data ranks of phase 25 (each takes TRAIN_BATCH / DP_DATA rows)
DP_DATA = 2
# steps the ranks take through the Trainer (and the single device); its one
# checkpoint is the one it writes at its end, at step DP_STEPS (2 steps, not
# 3, keep the script within its time limit)
DP_STEPS = 2
DP_TIMEOUT_S = 400.0
# phase 25's full-width deepseek-v2 grouped dispatch: 2 of 60 layers,
# DP_MOE_ROWS x DP_MOE_SEQ tokens in DP_DATA routing groups
DP_MOE_LAYERS, DP_MOE_ROWS, DP_MOE_SEQ = 2, 4, 16
# the loss bounds against one device's: step 0, and the data-parallel
# forward's loss of the single device's params at every step, at the
# cross-package CiM training bound of the CPU tests; the data-parallel
# run's own later losses, whose params have moved apart by bf16 rounding
# steps, at DP_TRAJ_RTOL (through 30 CiM layers a moved code moves the
# codes after it: on the CPU the f32 per-tensor 30-layer smoke model's
# step-1 losses part by 2.5e-3, the per_row one's by 1e-7)
DP_LOSS_RTOL = 1e-3
DP_TRAJ_RTOL = 1e-2
# step 0's grad norm against one device's: the two sum a bf16 gradient of
# 4 + 4 rows and of 8 rows in other orders (3.4e-4 apart on the H100)
DP_NORM_RTOL = 1e-3
# step 0's weights past lr/10 of the single device's, times this, stay
# within the control's: one device's step on a rank's rows alone (no
# collective of the data axis; on the H100 1,330 against 4,886,022)
DP_CONTROL_MARGIN = 100


def dp_setup():
    """Phase 25's config (full-size smollm-135m, its config's bf16, remat
    and CiM), pipeline and optimizer (phase 17's)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine

    cfg = get_config("smollm-135m")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    return cfg, pipe, AdamWConfig(lr=3e-4, schedule=warmup_cosine(20, TRAIN_STEPS))


def tree_digest(torch, leaves):
    """One int64 a tensor leaf: its bytes as integers, weighted by a fixed
    sequence and summed modulo 2^64 on the device (exact in any order):
    two leaves differ in a bit -> their digests differ (but by chance)."""
    out = []
    for t in leaves:
        flat = t.detach().reshape(-1)
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        v = flat.view(ints[flat.element_size()]).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device, dtype=torch.int64)
        out.append((v * (w * 6364136223846793005 + 1442695040888963407)).sum())
    return torch.stack(out).cpu().tolist()


def state_leaves(torch, state):
    """The tensors of a TrainState: params, the Adam step and moments."""
    from repro_torch.optim.adamw import tree_leaves

    return (list(tree_leaves(state.params)) + [state.opt.step]
            + list(tree_leaves(state.opt.mu)) + list(tree_leaves(state.opt.nu)))


def forward_codes(torch, params, batch, cfg, mesh=None):
    """The activation codes of every per-tensor ternarization of one
    no-grad forward (int8, on the host, in call order): a data rank's
    over its rows, under ``data_parallel``."""
    import importlib

    from repro_torch.core import ternary as tern
    from repro_torch.dist import sharding as shd

    ts = importlib.import_module("repro_torch.train.train_step")
    real, codes = tern.ternarize, []

    def spy(x, axis=None, factor=tern.TWN_THRESHOLD_FACTOR, reduce=None):
        t, scale = real(x, axis, factor, reduce)
        if axis is None:
            codes.append(t.to(torch.int8).cpu())
        return t, scale

    tern.ternarize = spy
    try:
        with torch.no_grad():
            if mesh is None:
                ts.loss_fn(params, batch, cfg)
            else:
                with shd.data_parallel(mesh):
                    ts.loss_fn(params, shd.batch_shard(batch, mesh), cfg)
    finally:
        tern.ternarize = real
    return codes


def param_gap(torch, params, want, lr) -> dict:
    """|delta| of ``params`` (a tree on the card) against ``want`` (the
    same leaves on the host), in float32: max, mean, the weights past
    lr/10 and past lr/10 plus one bf16 step of the weight, the count."""
    from repro_torch.optim.adamw import tree_leaves

    worst = total = beyond = past = 0.0
    n = 0
    for p, w in zip(tree_leaves(params), want):
        w = w.to(p.device).to(torch.float32)
        d = (p.detach().to(torch.float32) - w).abs()
        # the spacing of bf16 at the single device's weight
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
        worst = max(worst, float(d.max()))
        total += float(d.sum())
        n += d.numel()
        beyond += float((d > lr / 10).sum())
        past += float((d > lr / 10 + ulp).sum())
    return {"max": worst, "mean": total / n, "beyond_lr10": beyond,
            "beyond_lr10_ulp": past, "n": n}


def dp_single(torch, dev, tmp) -> dict:
    """Phase 25 (a)'s single device: step 0's forward codes and the
    control (the seed-0 params' loss on batches 1..), then DP_STEPS eager
    make_train_step steps from the Trainer's seed-0 state on the
    pipeline's batches 0.. under deterministic mode, the params after each
    saved to ``tmp`` for the ranks; losses, step times, peak memory."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.train_step import init_train_state, loss_fn, make_train_step

    cfg, pipe, opt = dp_setup()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, seed=0, device=dev)
    batch0 = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(0).items()}
    codes_path = os.path.join(tmp, "codes.pt")
    torch.save(forward_codes(torch, state.params, batch0, cfg), codes_path)
    # the control: the loss of the unmoved params on the later batches (a
    # step that moved nothing would read these)
    with torch.no_grad():
        control = [float(loss_fn(state.params, {k: torch.from_numpy(v).to(dev) for k, v in
                                                pipe.batch(i).items()}, cfg)[0])
                   for i in range(1, DP_STEPS)]
    step_fn = make_train_step(cfg, opt)
    out = {"losses": [], "secs": [], "params": [], "codes": codes_path, "control": control}
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i in range(DP_STEPS):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss, norm = torch.stack([m["loss"], m["grad_norm"]]).tolist()
            out["secs"].append(time.perf_counter() - t0)
            out["losses"].append(loss)
            out.setdefault("grad_norms", []).append(norm)
            path = os.path.join(tmp, f"params_{i}.pt")
            torch.save([p.detach().cpu() for p in tree_leaves(state.params)], path)
            out["params"].append(path)
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["step_ms"] = statistics.median(out["secs"][1:]) * 1e3
    del state, step_fn
    _free(torch)
    return out


def dp_rank(mesh, single, ckpt_dir, dev_name="cuda") -> dict:
    """Phase 25 on one data rank (``launch.mesh.spawn_mesh``, every rank on
    cuda:0): the Trainer under the mesh (``Trainer(mesh=)``: the eager
    data-parallel step) from the seed-0 state for DP_STEPS steps, its
    checkpoints into ``ckpt_dir`` (rank 0 writes). Before it, not counted:
    step 0's forward codes against the single device's rows. The launch
    counts at 0 just before ``run()``; in every step call: #1 launched
    2 x macs_per_step and no other kernel, the collectives, the gradient
    bucket's all-reduce time, then (outside the step's time) the params'
    digest gathered over the data group (bit-equal on every rank) and,
    in rank 0, every weight against the single device's after the same
    step (after step 0 each within lr/10 plus one bf16 step of the
    weight). Raises on any failure."""
    import importlib

    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import packed_mac as pm
    from repro_torch.kernels import ternary_mac as tm
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.train.trainer import TrainConfig, Trainer

    ts = importlib.import_module("repro_torch.train.train_step")

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"phase 25 data rank {mesh.data_rank}: {what}")

    dev = torch.device(dev_name, 0) if dev_name == "cuda" else torch.device(dev_name)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg, pipe, opt = dp_setup()
    per_step = 2 * macs_per_step(cfg)
    trainer = Trainer(cfg, opt, TrainConfig(
        num_steps=DP_STEPS, ckpt_dir=ckpt_dir, ckpt_every=DP_STEPS + 1, log_every=1),
        pipe, seed=0, device=dev, mesh=mesh)
    check(trainer.step_fn.graphed is False, "the data-parallel step must run eagerly")
    # step 0's codes against the single device's rows of them
    batch0 = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(0).items()}
    mine = forward_codes(torch, trainer.state.params, batch0, cfg, mesh)
    theirs = torch.load(single["codes"])
    rows = TRAIN_BATCH // mesh.data
    r0 = mesh.data_rank * rows
    check(len(mine) == len(theirs), f"{len(mine)} per-tensor calls, the single device "
          f"{len(theirs)}")
    moved = torch.tensor([sum(int((a != b[r0:r0 + rows]).sum()) for a, b in zip(mine, theirs))
                          + 0.0, sum(a.numel() for a in mine) + 0.0], dtype=torch.float64)
    moved = C.all_reduce(moved, mesh.data_group)
    del mine, theirs
    # the gradient bucket's all-reduce, timed
    real_bucket, bucket_ms = C.bucket_mean, []

    def timed_bucket(tensors, group):
        sync()
        t0 = time.perf_counter()
        out = real_bucket(tensors, group)
        sync()
        bucket_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    C.bucket_mean = timed_bucket
    inner, per_call, secs, collectives, deltas, digests = trainer.step_fn, [], [], [], [], []
    bad = []

    def cross_loss(step):
        """The data-parallel forward's loss (no grad) of the single
        device's params before ``step`` on the step's batch: the single
        device's loss of the step where the forward is consistent."""
        if step == 0:
            params = trainer.state.params
        else:
            found = iter(torch.load(single["params"][step - 1]))
            params = tree_map(lambda p: next(found).to(dev), trainer.state.params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(step).items()}
        with torch.no_grad(), shd.data_parallel(mesh):
            loss, _ = ts.loss_fn(params, shd.batch_shard(batch, mesh), cfg)
        return float(C.all_reduce(loss.reshape(1), mesh.data_group)) / mesh.data

    # before the run (not counted): the forward against the single device's
    cross = [cross_loss(step) for step in range(DP_STEPS)]
    control = None
    if mesh.data_rank == 0:
        # the control, a step that skips every collective of the data axis:
        # one device's step from the seed-0 state on this rank's rows alone,
        # against the single device's params after step 0 as step 0 is
        # (the other rank waits at its first collective meanwhile)
        fresh = init_train_state(cfg, seed=0, device=dev)
        wrong, m = make_train_step(cfg, opt)(fresh, shd.batch_shard(batch0, mesh))
        control = dict(param_gap(torch, wrong.params, torch.load(single["params"][0]), opt.lr),
                       grad_norm=float(m["grad_norm"]))
        del fresh, wrong

    def counted(state, batch):
        # records only: a raise inside the step is a node failure to the
        # Trainer, which would restore this rank alone
        before = counts(tm, pm)
        C.reset_counts()
        sync()
        t0 = time.perf_counter()
        out = inner(state, batch)
        sync()
        secs.append(time.perf_counter() - t0)
        step = len(secs) - 1
        per_call.append({k: v - before[k] for k, v in counts(tm, pm).items()})
        collectives.append(dict(C.COUNTS))
        mine = tree_digest(torch, tree_leaves(state.params))
        every = [None] * mesh.data
        dist.all_gather_object(every, mine, group=mesh.data_group)
        digests.append(all(d == mine for d in every))
        if mesh.data_rank == 0:
            gap = param_gap(torch, state.params, torch.load(single["params"][step]), opt.lr)
            # after one step the two runs' gradients differ by bf16 sums in
            # another order only: every weight within lr/10 and a rounding
            # step of bf16 storage, and far fewer weights past lr/10 than
            # the control's (``dp_report``; later steps move apart through
            # 30 CiM layers: the mean is held there, each weight printed)
            if step == 0 and gap["beyond_lr10_ulp"]:
                bad.append(f"step 0: {int(gap['beyond_lr10_ulp'])} weights past lr/10 plus "
                           f"one bf16 step of the single device's")
            deltas.append(gap)
        return out

    trainer.step_fn = counted
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(tm, pm)
    try:
        log_ = trainer.run()
    finally:
        C.bucket_mean = real_bucket
    got = counts(tm, pm)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    check(trainer.restarts == 0 and len(secs) == DP_STEPS,
          f"{trainer.restarts} restarts, {len(secs)} step calls")
    check(all(digests), f"the params differ between the data ranks after steps "
          f"{[i for i, ok in enumerate(digests) if not ok]}")
    check(not bad, "; ".join(bad[:4]))
    check(all(d["mean"] <= opt.lr / 10 for d in deltas),
          f"mean |delta param| {[d['mean'] for d in deltas]} past lr/10")
    want = dict.fromkeys(got, 0)
    want["ternary_cim_matmul"] = per_step
    check(len(per_call) == DP_STEPS and all(c == want for c in per_call),
          f"launches per step call {per_call}, expected {want}")
    check(got["ternary_cim_matmul"] == per_step * DP_STEPS, f"launches {got}")
    final = tree_digest(torch, state_leaves(torch, trainer.state))
    return {"log": [(m["step"], m["loss"], m["grad_norm"]) for m in log_],
            "cross": cross, "secs": secs, "bucket_ms": bucket_ms, "collectives": collectives,
            "launches": got["ternary_cim_matmul"], "per_step": per_step,
            "moved": moved.tolist(), "deltas": deltas, "peak_bytes": peak,
            "final_digest": final, "rows": rows, "control": control}


def dp_moe_groups(torch, tm, pm, dev) -> dict:
    """Phase 25 (f): full-width deepseek-v2-236b (DP_MOE_LAYERS of 60
    layers, bf16, per_row so that no statistic couples the rows) seeded on
    the card: one ``forward`` of DP_MOE_ROWS x DP_MOE_SEQ tokens under
    ``enable_activation_sharding(batch_divisor=DP_DATA)`` (DP_DATA routing
    groups, each its own capacity) against ``torch.cat`` of the forwards
    of its row blocks at one group each, bit for bit; #1's launches in
    the grouped forward."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config

    cfg = get_config("deepseek-v2-236b")
    cfg = cfg.replace(n_layers=DP_MOE_LAYERS,
                      quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(25)
    tokens = torch.randint(0, cfg.vocab, (DP_MOE_ROWS, DP_MOE_SEQ), generator=g, device=dev)
    n = DP_MOE_ROWS // DP_DATA
    with torch.no_grad():
        shd.enable_activation_sharding(batch_divisor=DP_DATA)
        try:
            reset_counts(tm, pm)
            sync_t = time.perf_counter()
            grouped = T.forward(params, tokens, cfg)
            torch.cuda.synchronize()
            grouped_ms = (time.perf_counter() - sync_t) * 1e3
            got = counts(tm, pm)
        finally:
            shd.disable_activation_sharding()
        halves = torch.cat([T.forward(params, tokens[i * n:(i + 1) * n], cfg)
                            for i in range(DP_DATA)])
        whole = T.forward(params, tokens, cfg)
    if not torch.equal(grouped, halves):
        fail(f"deepseek-v2 grouped dispatch: the {DP_DATA}-group forward differs from its "
             f"row blocks' by up to {float((grouped - halves).abs().max())}")
    per_forward = macs_per_step(cfg)
    if got["ternary_cim_matmul"] != per_forward or any(
            v for k, v in got.items() if k != "ternary_cim_matmul"):
        fail(f"deepseek-v2 grouped forward: launches {got}, expected #1 {per_forward}")
    out = {"launches": got["ternary_cim_matmul"], "grouped_ms": grouped_ms,
           "vs_one_group_max_abs": float((grouped - whole).abs().max()),
           "secs": time.perf_counter() - t0}
    del params, grouped, halves, whole
    _free(torch)
    return out


def dp_report(out, single, losses, card, opt):
    """Log phase 25's rank results beside the single device's and fail
    past the loss bounds; returns the DP step median (ms) and step 0's
    collectives."""
    moved, n_codes = out["moved"]
    norms = [n for _, _, n in out["log"]]
    log(f"data parallel: losses " + " ".join(f"{v:.6f}" for v in losses)
        + ", grad norms " + " ".join(f"{v:.6f}" for v in norms)
        + "; the single device's losses " + " ".join(f"{v:.6f}" for v in single["losses"])
        + ", grad norms " + " ".join(f"{v:.6f}" for v in single["grad_norms"])
        + "; the data-parallel forward's loss of the single device's params on each "
        "step's batch " + " ".join(f"{v:.6f}" for v in out["cross"])
        + "; control: the single device's loss of its unmoved params on the later "
        "batches " + " ".join(f"{v:.6f}" for v in single["control"]))
    ctl = out["control"]
    log(f"data parallel: the control, one device's step on rank 0's {out['rows']} rows "
        f"alone (no collective of the data axis): grad norm {ctl['grad_norm']:.6f} against "
        f"the single device's {single['grad_norms'][0]:.6f} (the data-parallel step's "
        f"{norms[0]:.6f}); its params against the single device's after step 0: |delta| max "
        f"{ctl['max']:.3g}, mean {ctl['mean']:.3g}, weights past lr/10 "
        f"{int(ctl['beyond_lr10'])}, past lr/10 + one bf16 step {int(ctl['beyond_lr10_ulp'])}"
        f" (the data-parallel step's {int(out['deltas'][0]['beyond_lr10'])}, "
        f"{int(out['deltas'][0]['beyond_lr10_ulp'])})")
    dp_ms = statistics.median(out["secs"][1:]) * 1e3
    coll = out["collectives"][0]
    per_step = out["per_step"]
    log(f"data parallel: full-size smollm-135m (bf16, remat, CiM, blocked/cuda; global batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}) over a ({DP_DATA}, 1) mesh, {DP_DATA} gloo ranks on "
        f"{card}, {out['rows']} rows each, {DP_STEPS} steps through Trainer(mesh=): "
        f"|delta param| against the single device max "
        + " ".join(f"{d['max']:.3g}" for d in out["deltas"]) + ", mean "
        + " ".join(f"{d['mean']:.3g}" for d in out["deltas"]) + " (bound lr/10 = "
        + f"{opt.lr / 10:.3g}), weights past lr/10 "
        + " ".join(f"{int(d['beyond_lr10'])}" for d in out["deltas"])
        + ", past lr/10 + one bf16 step of the weight "
        + " ".join(f"{int(d['beyond_lr10_ulp'])}" for d in out["deltas"])
        + f" of {out['deltas'][0]['n']} (step 0's held at 0); "
        f"step 0's per-tensor activation codes moved {int(moved)} of {int(n_codes)}; params "
        f"bit-equal on every rank after every step; #1 launched {per_step} in every step in "
        f"every rank ({out['launches']} in rank 0), no other kernel")
    log(f"data parallel: eager data-parallel step median {dp_ms:.2f} ms of the steps after "
        f"step 0 (all: " + " ".join(f"{s * 1e3:.1f}" for s in out["secs"])
        + f" ms) against the eager single-device step {single['step_ms']:.2f} ms ("
        + " ".join(f"{s * 1e3:.1f}" for s in single["secs"]) + " ms); gradient all-reduce "
        f"(one f32 bucket) " + " ".join(f"{v:.1f}" for v in out["bucket_ms"])
        + f" ms; collectives a step {coll}; peak memory a rank (rank 0) "
        f"{out['peak_bytes'] / 1e9:.2f} GB, the single device's {single['peak_bytes'] / 1e9:.2f}"
        f" GB; on {card}")
    bad = [i for i, (a, b) in enumerate(zip(losses, single["losses"]))
           if not abs(a - b) <= (DP_TRAJ_RTOL if i else DP_LOSS_RTOL) * abs(b)]
    bad += [i for i, (a, b) in enumerate(zip(out["cross"], single["losses"]))
            if not abs(a - b) <= DP_LOSS_RTOL * abs(b)]
    if bad:
        fail(f"data-parallel training: losses of steps {sorted(set(bad))} past their "
             f"bounds (step 0 and the forward of the single device's params rtol "
             f"{DP_LOSS_RTOL}, later steps {DP_TRAJ_RTOL})")
    if not abs(norms[0] - single["grad_norms"][0]) <= DP_NORM_RTOL * single["grad_norms"][0]:
        fail(f"data-parallel training: step 0's grad norm {norms[0]} against the single "
             f"device's {single['grad_norms'][0]} (rtol {DP_NORM_RTOL})")
    if not out["deltas"][0]["beyond_lr10"] * DP_CONTROL_MARGIN <= ctl["beyond_lr10"]:
        fail(f"data-parallel training: step 0 left {int(out['deltas'][0]['beyond_lr10'])} "
             f"weights past lr/10 of the single device's, the control "
             f"{int(ctl['beyond_lr10'])} (margin {DP_CONTROL_MARGIN})")
    return dp_ms, coll


def dp_phase(torch, tm, pm, card, dev, tmp) -> dict:
    """Phase 25: full-size smollm-135m (bf16, remat, CiM, blocked/cuda: its
    config's) trained over a (DP_DATA, 1) data mesh, DP_DATA gloo ranks on
    cuda:0, TRAIN_BATCH / DP_DATA rows of phase 17's global batch each
    (``dp_rank``): first, in this process, the full-width deepseek-v2
    grouped dispatch (``dp_moe_groups``) and DP_STEPS eager single-device
    steps on the same batches (``dp_single``), freed before the ranks
    start; then the ranks: (a) step 0's loss, and at every step the
    data-parallel forward's loss of the single device's params before it
    on its batch, within DP_LOSS_RTOL of the single device's loss, the
    run's own later losses within DP_TRAJ_RTOL, step 0's grad norm within
    DP_NORM_RTOL, the mean |delta param| within lr/10 at every step and,
    after step 0, every weight within lr/10 plus one bf16 rounding step
    of the weight (each update is stored in bf16: a weight of 0.04 moves
    by 2.4e-4 = 8 x lr/10 when its rounding flips) and DP_CONTROL_MARGIN
    x the weights past lr/10 within the control step's (one device's
    step on rank 0's rows alone); max and mean |delta|, the weights past
    lr/10, step 0's moved activation codes and the single device's loss
    of its unmoved params on the later batches printed; (b)
    the params bit-equal on every rank after every step; (c) #1 launched
    420 times a step in every rank, no other kernel; (d) the eager
    data-parallel step, the gradient all-reduce, collectives a step and
    peak memory a rank; (e) the Trainer's last checkpoint (written at data
    DP_DATA) restored by a single-device Trainer on cuda:0 bit for bit,
    which then takes one step. A rank's failure or a run past
    DP_TIMEOUT_S fails the script. The single device's files go into
    ``tmp``, where phase 26 reads them (the result's "single")."""
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    moe = dp_moe_groups(torch, tm, pm, dev)
    log(f"data parallel (f): deepseek-v2-236b at full width ({DP_MOE_LAYERS} of 60 layers, "
        f"bf16, per_row) on {card}: one forward of {DP_MOE_ROWS} x {DP_MOE_SEQ} tokens in "
        f"{DP_DATA} routing groups == torch.cat of its {DP_DATA} row blocks' one-group "
        f"forwards, bit for bit ({moe['grouped_ms']:.1f} ms); its logits differ from one "
        f"group over all rows by up to {moe['vs_one_group_max_abs']:.4g}; #1 launched "
        f"{moe['launches']} in the grouped forward, no other kernel; {moe['secs']:.1f} s")
    single = dp_single(torch, dev, tmp)
    ckpt_dir = os.path.join(tmp, "ckpt")
    try:
        out = spawn_mesh(dp_rank, DP_DATA, 1,
                         {k: single[k] for k in ("codes", "params")}, ckpt_dir,
                         dev.type, timeout=DP_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"data-parallel training: {e}")
    cfg, pipe, opt = dp_setup()
    losses = [loss for _, loss, _ in out["log"]]
    if [s for s, _, _ in out["log"]] != list(range(DP_STEPS)):
        fail(f"data-parallel training: steps {out['log']}")
    dp_ms, coll = dp_report(out, single, losses, card, opt)
    # (e) the data-2 checkpoint on one device
    # made without the directory (no restore at construction), then
    # restored once through restore(device=); it writes no checkpoint
    trainer = Trainer(cfg, opt, TrainConfig(num_steps=DP_STEPS + 1), pipe, seed=0,
                      device=dev)
    t0 = time.perf_counter()
    trainer.train_cfg.ckpt_dir = ckpt_dir
    start = trainer.restore(device=dev)
    trainer.train_cfg.ckpt_dir = None
    restored = tree_digest(torch, state_leaves(torch, trainer.state))
    restore_s = time.perf_counter() - t0
    if start != DP_STEPS or restored != out["final_digest"]:
        fail(f"elastic restore: step {start}, the restored state's digest "
             f"{'==' if restored == out['final_digest'] else '!='} data rank 0's")
    reset_counts(tm, pm)
    after = trainer.run()
    got = counts(tm, pm)
    per_step = out["per_step"]
    if ([m["step"] for m in after] != [DP_STEPS] or not math.isfinite(after[0]["loss"])
            or got["ternary_cim_matmul"] != per_step):
        fail(f"elastic restore: the step after it {after}, launches {got}")
    del trainer
    _free(torch)
    wall = time.perf_counter() - t_phase
    log(f"data parallel (e): the Trainer's checkpoint at step {DP_STEPS} (written at data "
        f"{DP_DATA}) restored by a single-device Trainer on {dev} bit for bit in "
        f"{restore_s:.1f} s, then step {DP_STEPS}: loss {after[0]['loss']:.6f}, #1 launched "
        f"{got['ternary_cim_matmul']}; phase 25 wall time {wall:.1f} s")
    return {"losses": losses, "single_losses": single["losses"], "deltas": out["deltas"],
            "cross_losses": out["cross"], "grad_norms": [n for _, _, n in out["log"]],
            "single_grad_norms": single["grad_norms"], "control_losses": single["control"],
            "control_step": out["control"],
            "moved_codes": out["moved"][0], "codes": out["moved"][1], "dp_step_ms": dp_ms,
            "dp_secs": out["secs"], "single_step_ms": single["step_ms"],
            "single_secs": single["secs"], "bucket_ms": out["bucket_ms"],
            "collectives_per_step": coll, "peak_bytes_rank": out["peak_bytes"],
            "single_peak_bytes": single["peak_bytes"], "launches": out["launches"],
            "launches_per_step": per_step, "restore_s": restore_s,
            "after_restore_loss": after[0]["loss"], "moe": moe, "wall_s": wall,
            "single": single}


# ---------------------------------------------------------------------------
# phase 26: tensor-parallel training
# ---------------------------------------------------------------------------

# the model ranks of phase 26: 3 split smollm-135m's 9 heads and 3 kv
# heads, its MLP's 1536 and its vocabulary's 49152
TP_TRAIN_MODEL = 3
TP_TRAIN_TIMEOUT_S = 400.0


def replicated_leaves(tree, layout):
    """The leaves of a params-shaped ``tree`` that ``layout`` keeps whole
    on every model rank."""
    from repro_torch.optim.adamw import tree_leaves

    return [t for t, sp in zip(tree_leaves(tree), tree_leaves(layout)) if sp is None]


def tp_train_rank(mesh, single, ckpt_dir, dev_name="cuda") -> dict:
    """Phase 26 on one model rank (``launch.mesh.spawn_mesh``, (1,
    TP_TRAIN_MODEL), every rank on cuda:0): the Trainer under the mesh
    (``Trainer(mesh=)``: the eager step on the rank's shards) from the
    seed-0 state for DP_STEPS steps on phase 17's global batch, its
    checkpoint gathered whole into ``ckpt_dir`` (rank 0 writes). The
    launch counts at 0 just before ``run()``; in every step call: #1
    launched 2 x macs_per_step and no other kernel, the collectives by
    name, then (outside the step's time) the replicated leaves' digest
    gathered over the model group (bit-equal on every rank) and the
    params gathered whole, held in rank 0 against the single device's
    after the same step (phase 25's, ``single``; after step 0 every
    weight within lr/10 plus one bf16 step). Raises on any failure."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import packed_mac as pm
    from repro_torch.kernels import ternary_mac as tm
    from repro_torch.train.trainer import TrainConfig, Trainer

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"phase 26 model rank {mesh.rank}: {what}")

    dev = torch.device(dev_name, 0) if dev_name == "cuda" else torch.device(dev_name)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg, pipe, opt = dp_setup()
    per_step = 2 * macs_per_step(cfg)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, opt, TrainConfig(
        num_steps=DP_STEPS, ckpt_dir=ckpt_dir, ckpt_every=DP_STEPS + 1, log_every=1),
        pipe, seed=0, device=dev, mesh=mesh)
    init_s = time.perf_counter() - t0
    check(trainer.step_fn.graphed is False, "the tensor-parallel step must run eagerly")
    layout = shd.train_layout(cfg, mesh)
    local = shd.local_config(cfg, mesh)
    shapes = {"blocks/attn/wq": tuple(trainer.state.params["blocks"]["attn"]["wq"].shape),
              "blocks/mlp/w_down": tuple(trainer.state.params["blocks"]["mlp"]["w_down"].shape),
              "embed": tuple(trainer.state.params["embed"].shape)}
    inner, per_call, secs, collectives, deltas, digests = trainer.step_fn, [], [], [], [], []
    bad = []

    def counted(state, batch):
        # records only: a raise inside the step is a node failure to the
        # Trainer, which would restore this rank alone
        before = counts(tm, pm)
        C.reset_counts()
        sync()
        t = time.perf_counter()
        out = inner(state, batch)
        sync()
        secs.append(time.perf_counter() - t)
        step = len(secs) - 1
        per_call.append({k: v - before[k] for k, v in counts(tm, pm).items()})
        collectives.append(dict(C.COUNTS))
        mine = tree_digest(torch, replicated_leaves(state.params, layout))
        every = [None] * mesh.size
        dist.all_gather_object(every, mine, group=mesh.group)
        digests.append(all(d == mine for d in every))
        whole = shd.gather_tree(state.params, layout)
        if mesh.rank == 0:
            gap = param_gap(torch, whole, torch.load(single["params"][step]), opt.lr)
            if step == 0 and gap["beyond_lr10_ulp"]:
                bad.append(f"step 0: {int(gap['beyond_lr10_ulp'])} weights past lr/10 plus "
                           f"one bf16 step of the single device's")
            deltas.append(gap)
        del whole
        return out

    trainer.step_fn = counted
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(tm, pm)
    log_ = trainer.run()
    got = counts(tm, pm)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    check(trainer.restarts == 0 and len(secs) == DP_STEPS,
          f"{trainer.restarts} restarts, {len(secs)} step calls")
    check(all(digests), f"the replicated leaves differ between the model ranks after "
          f"steps {[i for i, ok in enumerate(digests) if not ok]}")
    check(not bad, "; ".join(bad[:4]))
    want = dict.fromkeys(got, 0)
    want["ternary_cim_matmul"] = per_step
    check(len(per_call) == DP_STEPS and all(c == want for c in per_call),
          f"launches per step call {per_call}, expected {want}")
    check(got["ternary_cim_matmul"] == per_step * DP_STEPS, f"launches {got}")
    final = tree_digest(torch, state_leaves(torch, shd.gather_state(trainer.state, cfg, mesh)))
    return {"log": [(m["step"], m["loss"], m["grad_norm"]) for m in log_],
            "secs": secs, "collectives": collectives, "launches": got["ternary_cim_matmul"],
            "per_step": per_step, "deltas": deltas, "peak_bytes": peak,
            "final_digest": final, "init_s": init_s, "shapes": shapes,
            "local": {k: getattr(local, k) for k in ("n_heads", "n_kv_heads")}}


def tp_train_phase(torch, tm, pm, card, dev, single, tmp) -> dict:
    """Phase 26: full-size smollm-135m (bf16, remat, CiM, blocked/cuda: its
    config's) trained over a (1, TP_TRAIN_MODEL) mesh, TP_TRAIN_MODEL gloo
    ranks on cuda:0 (``tp_train_rank``), on phase 17's global batch, held
    against phase 25's DP_STEPS eager single-device steps (``single``,
    its files in ``tmp``): step 0's loss bit for bit, step 0's grad norm
    within DP_NORM_RTOL, after step 0 every weight within lr/10 plus one
    bf16 step (checked in rank 0), the replicated leaves bit-equal on the
    ranks after every step, #1 launched 420 times a step in every rank
    and no other kernel; the gathered checkpoint at step DP_STEPS
    restored by a single-device Trainer on cuda:0 bit for bit. A rank's
    failure or a run past TP_TRAIN_TIMEOUT_S fails the script."""
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    ckpt_dir = os.path.join(tmp, "tp_ckpt")
    try:
        out = spawn_mesh(tp_train_rank, 1, TP_TRAIN_MODEL, {"params": single["params"]},
                         ckpt_dir, dev.type, timeout=TP_TRAIN_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"tensor-parallel training: {e}")
    cfg, pipe, opt = dp_setup()
    if [st for st, _, _ in out["log"]] != list(range(DP_STEPS)):
        fail(f"tensor-parallel training: steps {out['log']}")
    losses = [loss for _, loss, _ in out["log"]]
    norms = [n for _, _, n in out["log"]]
    tp_ms = statistics.median(out["secs"][1:]) * 1e3
    coll = out["collectives"][0]
    log(f"tensor parallel training: full-size smollm-135m (bf16, remat, CiM, blocked/cuda; "
        f"global batch {TRAIN_BATCH} x {TRAIN_SEQ}) over a (1, {TP_TRAIN_MODEL}) mesh, "
        f"{TP_TRAIN_MODEL} gloo ranks on {card} (a rank's heads {out['local']}, shards "
        f"{out['shapes']}), {DP_STEPS} steps through Trainer(mesh=): losses "
        + " ".join(f"{v:.6f}" for v in losses) + ", grad norms "
        + " ".join(f"{v:.6f}" for v in norms) + " against the single device's (phase 25) "
        + " ".join(f"{v:.6f}" for v in single["losses"]) + ", "
        + " ".join(f"{v:.6f}" for v in single["grad_norms"]) + "; |delta param| (gathered "
        "whole) max " + " ".join(f"{d['max']:.3g}" for d in out["deltas"]) + ", mean "
        + " ".join(f"{d['mean']:.3g}" for d in out["deltas"]) + ", weights past lr/10 "
        + " ".join(f"{int(d['beyond_lr10'])}" for d in out["deltas"])
        + ", past lr/10 + one bf16 step "
        + " ".join(f"{int(d['beyond_lr10_ulp'])}" for d in out["deltas"])
        + f" of {out['deltas'][0]['n']} (step 0's held at 0); replicated leaves bit-equal on "
        f"every rank after every step; #1 launched {out['per_step']} in every step in every "
        f"rank ({out['launches']} in rank 0), no other kernel")
    log(f"tensor parallel training: eager TP step median {tp_ms:.2f} ms of the steps after "
        f"step 0 (all: " + " ".join(f"{v * 1e3:.1f}" for v in out["secs"])
        + f" ms) against the eager single-device step {single['step_ms']:.2f} ms; collectives "
        f"a step {coll}; peak memory a rank (rank 0) {out['peak_bytes'] / 1e9:.2f} GB, the "
        f"single device's {single['peak_bytes'] / 1e9:.2f} GB; a rank's Trainer made in "
        f"{out['init_s']:.1f} s; on {card}")
    if losses[0] != single["losses"][0]:
        fail(f"tensor-parallel training: step 0's loss {losses[0]!r} != the single device's "
             f"{single['losses'][0]!r}")
    if not abs(norms[0] - single["grad_norms"][0]) <= DP_NORM_RTOL * single["grad_norms"][0]:
        fail(f"tensor-parallel training: step 0's grad norm {norms[0]} against the single "
             f"device's {single['grad_norms'][0]} (rtol {DP_NORM_RTOL})")
    bad = [i for i, (a, b) in enumerate(zip(losses, single["losses"]))
           if i and not abs(a - b) <= DP_TRAJ_RTOL * abs(b)]
    if bad:
        fail(f"tensor-parallel training: losses of steps {bad} past rtol {DP_TRAJ_RTOL}")
    # the gathered checkpoint on one device, restored once through
    # restore(device=) by a Trainer made without the directory
    trainer = Trainer(cfg, opt, TrainConfig(num_steps=DP_STEPS + 1), pipe, seed=0, device=dev)
    t0 = time.perf_counter()
    trainer.train_cfg.ckpt_dir = ckpt_dir
    start = trainer.restore(device=dev)
    restored = tree_digest(torch, state_leaves(torch, trainer.state))
    restore_s = time.perf_counter() - t0
    if start != DP_STEPS or restored != out["final_digest"]:
        fail(f"tensor-parallel elastic restore: step {start}, the restored state's digest "
             f"{'==' if restored == out['final_digest'] else '!='} the ranks' gathered one")
    del trainer
    _free(torch)
    wall = time.perf_counter() - t_phase
    log(f"tensor parallel training: the checkpoint at step {DP_STEPS} (gathered whole at "
        f"model {TP_TRAIN_MODEL}) restored by a single-device Trainer on {dev} bit for bit in "
        f"{restore_s:.1f} s; phase 26 wall time {wall:.1f} s")
    return {"losses": losses, "grad_norms": norms, "single_losses": single["losses"],
            "single_grad_norms": single["grad_norms"], "deltas": out["deltas"],
            "tp_step_ms": tp_ms, "tp_secs": out["secs"], "single_step_ms": single["step_ms"],
            "collectives_per_step": coll, "peak_bytes_rank": out["peak_bytes"],
            "launches": out["launches"], "launches_per_step": out["per_step"],
            "restore_s": restore_s, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 27: tensor-parallel training of the encdec and vlm families
# ---------------------------------------------------------------------------

# the model ranks of phase 27: 2 split whisper-large-v3's 20 heads, MLP
# 5120 and vocabulary 51866, and llava-next-34b's 56 heads, 8 kv heads,
# MLP 20480, vocabulary 64000 and projector's 7168 columns
TP_FAMILY_TRAIN_MODEL = 2
TP_FAMILY_TRAIN_TIMEOUT_S = 600.0
# arch: (decoder layers, encoder layers, global batch rows, tokens a row),
# full width at cut depth; whisper's rows carry 1500 frames each, llava's
# its 2880 patches before the tokens
# (whisper at 4 + 4 layers before phase 28)
TP_FAMILY_TRAIN = {"whisper-large-v3": (2, 2, 2, 64), "llava-next-34b": (1, 0, 1, 16)}


def tp_family_train_setup(arch):
    """Phase 27's config of ``arch`` (its full width and config's bf16,
    remat and CiM; the depth of TP_FAMILY_TRAIN), pipeline and optimizer
    (phase 17's)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine

    layers, enc, rows, seq = TP_FAMILY_TRAIN[arch]
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=layers, n_encoder_layers=enc or cfg.n_encoder_layers)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=rows, seed=0))
    return cfg, pipe, AdamWConfig(lr=3e-4, schedule=warmup_cosine(20, TRAIN_STEPS))


def family_inputs(cfg):
    """The Trainer's ``batch_transform`` of ``cfg``'s family: whisper's
    ``frames`` (rows, encoder_seq, d_model) or llava's ``patches`` (rows,
    n_image_tokens, d_vision), f32 normals from a generator seeded by the
    batch's token sum: every rank, and a replay, makes the same ones."""
    import numpy as np

    key, shape = (("frames", (cfg.encoder_seq, cfg.d_model)) if cfg.family == "encdec"
                  else ("patches", (cfg.n_image_tokens, cfg.d_vision)))

    def add(batch):
        tokens = np.asarray(batch["tokens"], dtype=np.int64)
        rng = np.random.default_rng(int(tokens.sum()))
        return dict(batch, **{key: rng.standard_normal(
            (tokens.shape[0],) + shape, dtype=np.float32)})

    return add


def family_train_launches(cfg) -> int:
    """#1's launches in one train step of whisper or llava, one per
    quantized dense call: a decoder layer's q/k/v/o and gate/up/down, and
    whisper's cross q/k/v/o, twice under remat (the forward and the
    recompute); 7 for each of whisper's encoder layers, which run once
    (no remat, as the reference's scan); llava's projector once. The
    unembedding is plain (quantize_unembed off)."""
    dec = 7 + (4 if cfg.family == "encdec" else 0)
    n = dec * cfg.n_layers * (2 if cfg.remat else 1)
    if cfg.family == "encdec":
        n += 7 * cfg.n_encoder_layers
    return n + (1 if cfg.family == "vlm" else 0)


def tp_family_train_single(torch, dev, tmp) -> dict:
    """Phase 27's single device, for each family in turn: DP_STEPS eager
    make_train_step steps from the seed-0 state on the pipeline's batches
    with their frames or patches, under deterministic mode, the params
    after step 0 saved to ``tmp`` for the ranks (what their weight check
    reads); losses, grad norms, step times, peak memory. Each family is
    freed before the next."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.train_step import init_train_state, make_train_step

    out = {}
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    for arch in TP_FAMILY_TRAIN:
        cfg, pipe, opt = tp_family_train_setup(arch)
        add = family_inputs(cfg)
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, seed=0, device=dev)
        step_fn = make_train_step(cfg, opt)
        rec = {"losses": [], "grad_norms": [], "secs": [], "params": []}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for i in range(DP_STEPS):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in add(pipe.batch(i)).items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                loss, norm = torch.stack([m["loss"], m["grad_norm"]]).tolist()
                rec["secs"].append(time.perf_counter() - t0)
                rec["losses"].append(loss)
                rec["grad_norms"].append(norm)
                if i == 0:
                    path = os.path.join(tmp, f"{arch}_params_0.pt")
                    torch.save([p.detach().cpu() for p in tree_leaves(state.params)], path)
                    rec["params"].append(path)
                del batch, m
        finally:
            torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["step_ms"] = statistics.median(rec["secs"][1:]) * 1e3
        rec["n_params"] = sum(p.numel() for p in tree_leaves(state.params))
        out[arch] = rec
        del state, step_fn
    _free(torch)
    return out


def tp_family_train_rank(mesh, single, ckpt_dir, dev_name="cuda") -> dict:
    """Phase 27 on one model rank (``launch.mesh.spawn_mesh``, (1,
    TP_FAMILY_TRAIN_MODEL), every rank on cuda:0): for each family in
    turn (the first freed before the second), the Trainer under the mesh
    with its frames or patches (``Trainer(mesh=, batch_transform=)``)
    from the seed-0 state for DP_STEPS steps; whisper's checkpoint
    gathered whole into ``ckpt_dir`` (rank 0 writes). The launch counts
    at 0 just before ``run()``; in every step call: #1 launched
    family_train_launches times and no other kernel, the collectives by
    name, then (outside the step's time) the replicated leaves' digest
    gathered over the model group (bit-equal on every rank) and, after
    step 0, the params gathered whole, held in rank 0 against the single
    device's (every weight within lr/10 plus one bf16 step). Raises on
    any failure."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import packed_mac as pm
    from repro_torch.kernels import ternary_mac as tm
    from repro_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device(dev_name, 0) if dev_name == "cuda" else torch.device(dev_name)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    for arch in TP_FAMILY_TRAIN:
        def check(ok, what):
            if not ok:
                raise RuntimeError(f"phase 27 {arch} model rank {mesh.rank}: {what}")

        cfg, pipe, opt = tp_family_train_setup(arch)
        per_step = family_train_launches(cfg)
        if dev.type == "cuda":
            torch.empty((), device=dev)   # the allocator of a fresh rank, before its reset
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        save = ckpt_dir if cfg.family == "encdec" else None
        trainer = Trainer(cfg, opt, TrainConfig(
            num_steps=DP_STEPS, ckpt_dir=save, ckpt_every=DP_STEPS + 1, log_every=1),
            pipe, seed=0, batch_transform=family_inputs(cfg), device=dev, mesh=mesh)
        init_s = time.perf_counter() - t0
        check(trainer.step_fn.graphed is False, "the tensor-parallel step must run eagerly")
        layout = shd.train_layout(cfg, mesh)
        local = shd.local_config(cfg, mesh)
        p = trainer.state.params
        names = (("enc_blocks/attn/wq", "blocks/cross/wk", "blocks/mlp/w_down", "embed")
                 if cfg.family == "encdec" else
                 ("blocks/attn/wk", "blocks/mlp/w_down", "projector", "unembed"))
        shapes = {}
        for name in names:
            leaf = p
            for part in name.split("/"):
                leaf = leaf[part]
            shapes[name] = tuple(leaf.shape)
        inner, per_call, secs, collectives, deltas, digests, bad = (
            trainer.step_fn, [], [], [], [], [], [])

        def counted(state, batch):
            # records only: a raise inside the step is a node failure to
            # the Trainer, which would restore this rank alone
            before = counts(tm, pm)
            C.reset_counts()
            sync()
            t = time.perf_counter()
            res = inner(state, batch)
            sync()
            secs.append(time.perf_counter() - t)
            step = len(secs) - 1
            per_call.append({k: v - before[k] for k, v in counts(tm, pm).items()})
            collectives.append(dict(C.COUNTS))
            mine = tree_digest(torch, replicated_leaves(state.params, layout))
            every = [None] * mesh.size
            dist.all_gather_object(every, mine, group=mesh.group)
            digests.append(all(d == mine for d in every))
            if step == 0:
                whole = shd.gather_tree(state.params, layout)
                if mesh.rank == 0:
                    gap = param_gap(torch, whole, torch.load(single[arch]["params"][0]),
                                    opt.lr)
                    if gap["beyond_lr10_ulp"]:
                        bad.append(f"step 0: {int(gap['beyond_lr10_ulp'])} weights past "
                                   f"lr/10 plus one bf16 step of the single device's")
                    deltas.append(gap)
                del whole
            return res

        trainer.step_fn = counted
        reset_counts(tm, pm)
        log_ = trainer.run()
        got = counts(tm, pm)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        check(trainer.restarts == 0 and len(secs) == DP_STEPS,
              f"{trainer.restarts} restarts, {len(secs)} step calls")
        check(all(digests), f"the replicated leaves differ between the model ranks after "
              f"steps {[i for i, ok in enumerate(digests) if not ok]}")
        check(not bad, "; ".join(bad[:4]))
        want = dict.fromkeys(got, 0)
        want["ternary_cim_matmul"] = per_step
        check(len(per_call) == DP_STEPS and all(c == want for c in per_call),
              f"launches per step call {per_call}, expected {want}")
        check(got["ternary_cim_matmul"] == per_step * DP_STEPS, f"launches {got}")
        final = None
        if save is not None:
            final = tree_digest(torch, state_leaves(
                torch, shd.gather_state(trainer.state, cfg, mesh)))
        out[arch] = {
            "log": [(m["step"], m["loss"], m["grad_norm"]) for m in log_], "secs": secs,
            "collectives": collectives, "launches": got["ternary_cim_matmul"],
            "per_step": per_step, "deltas": deltas, "peak_bytes": peak,
            "final_digest": final, "init_s": init_s, "shapes": shapes,
            "local": {k: getattr(local, k) for k in ("n_heads", "n_kv_heads")},
            "wall_s": time.perf_counter() - t0}
        del trainer, inner, counted, p, layout
        if dev.type == "cuda":
            import gc

            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    return out


def tp_family_train_phase(torch, tm, pm, card, dev, tmp) -> dict:
    """Phase 27: whisper-large-v3 (2 of 32 encoder and decoder layers)
    and llava-next-34b (1 of 60 layers) at full width (bf16, remat, CiM,
    blocked/cuda: their configs') trained over a (1,
    TP_FAMILY_TRAIN_MODEL) mesh, TP_FAMILY_TRAIN_MODEL gloo ranks on
    cuda:0 (``tp_family_train_rank``, one spawn for both), held against
    DP_STEPS eager single-device steps of each run first in this process
    (``tp_family_train_single``, its files in ``tmp``): step 0's loss bit
    for bit, step 0's grad norm within DP_NORM_RTOL, after step 0 every
    weight within lr/10 plus one bf16 step (checked in rank 0; step 1's
    loss is printed beside the single device's, unbounded: from step 0's
    bf16 rounding on, CiM codes flip apart: 1.0% on llava on an NVIDIA
    H100 80GB HBM3 at 700 W), the replicated leaves bit-equal on the
    ranks after every step, #1 launched family_train_launches times a
    step in every rank and no other kernel; whisper's gathered checkpoint
    at step DP_STEPS restored by a single-device Trainer on cuda:0 bit
    for bit. A rank's failure or a run past TP_FAMILY_TRAIN_TIMEOUT_S
    fails the script."""
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    single = tp_family_train_single(torch, dev, tmp)
    single_s = time.perf_counter() - t0
    ckpt_dir = os.path.join(tmp, "tp_family_ckpt")
    t0 = time.perf_counter()
    try:
        out = spawn_mesh(tp_family_train_rank, 1, TP_FAMILY_TRAIN_MODEL,
                         {a: {"params": r["params"]} for a, r in single.items()},
                         ckpt_dir, dev.type, timeout=TP_FAMILY_TRAIN_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"tensor-parallel training of the encdec and vlm families: {e}")
    spawn_s = time.perf_counter() - t0
    result = {}
    for arch, run in out.items():
        one = single[arch]
        cfg, pipe, opt = tp_family_train_setup(arch)
        if [st for st, _, _ in run["log"]] != list(range(DP_STEPS)):
            fail(f"{arch} tensor-parallel training: steps {run['log']}")
        losses = [loss for _, loss, _ in run["log"]]
        norms = [n for _, _, n in run["log"]]
        tp_ms = statistics.median(run["secs"][1:]) * 1e3
        coll = run["collectives"][0]
        rows, seq = TP_FAMILY_TRAIN[arch][2:]
        gap = run["deltas"][0]
        extra = (f"{rows} x {cfg.encoder_seq} frames, {cfg.n_encoder_layers} of 32 encoder "
                 f"and {cfg.n_layers} of 32 decoder layers" if cfg.family == "encdec" else
                 f"{rows} x {cfg.n_image_tokens} patches before the tokens, {cfg.n_layers} "
                 f"of 60 layers")
        log(f"tensor parallel training, {arch} (full width, bf16, remat, CiM, blocked/cuda; "
            f"global batch {rows} x {seq} tokens, {extra}; {one['n_params'] / 1e9:.3f} G "
            f"params) over a (1, {TP_FAMILY_TRAIN_MODEL}) mesh, {TP_FAMILY_TRAIN_MODEL} gloo "
            f"ranks on {card} (a rank's heads {run['local']}, shards {run['shapes']}), "
            f"{DP_STEPS} steps through Trainer(mesh=, batch_transform=): losses "
            + " ".join(f"{v:.6f}" for v in losses) + ", grad norms "
            + " ".join(f"{v:.6f}" for v in norms) + " against the single device's "
            + " ".join(f"{v:.6f}" for v in one["losses"]) + ", "
            + " ".join(f"{v:.6f}" for v in one["grad_norms"]) + "; after step 0 |delta "
            f"param| (gathered whole) max {gap['max']:.3g}, mean {gap['mean']:.3g}, weights "
            f"past lr/10 {int(gap['beyond_lr10'])}, past lr/10 + one bf16 step "
            f"{int(gap['beyond_lr10_ulp'])} of {gap['n']} (held at 0); replicated leaves "
            f"bit-equal on every rank after every step; #1 launched {run['per_step']} in "
            f"every step in every rank ({run['launches']} in rank 0), no other kernel")
        log(f"tensor parallel training, {arch}: eager TP step {tp_ms:.2f} ms after step 0 "
            f"(all: " + " ".join(f"{v * 1e3:.1f}" for v in run["secs"])
            + f" ms) against the eager single-device step {one['step_ms']:.2f} ms (all: "
            + " ".join(f"{v * 1e3:.1f}" for v in one["secs"]) + f" ms); collectives a step "
            f"{coll}; peak memory a rank (rank 0) {run['peak_bytes'] / 1e9:.2f} GB, the "
            f"single device's {one['peak_bytes'] / 1e9:.2f} GB; a rank's Trainer made in "
            f"{run['init_s']:.1f} s; on {card}")
        if losses[0] != one["losses"][0]:
            fail(f"{arch} tensor-parallel training: step 0's loss {losses[0]!r} != the "
                 f"single device's {one['losses'][0]!r}")
        if not abs(norms[0] - one["grad_norms"][0]) <= DP_NORM_RTOL * one["grad_norms"][0]:
            fail(f"{arch} tensor-parallel training: step 0's grad norm {norms[0]} against "
                 f"the single device's {one['grad_norms'][0]} (rtol {DP_NORM_RTOL})")
        result[arch] = {
            "losses": losses, "grad_norms": norms, "single_losses": one["losses"],
            "single_grad_norms": one["grad_norms"], "deltas": run["deltas"],
            "tp_step_ms": tp_ms, "tp_secs": run["secs"], "single_step_ms": one["step_ms"],
            "single_secs": one["secs"], "collectives_per_step": coll,
            "peak_bytes_rank": run["peak_bytes"], "single_peak_bytes": one["peak_bytes"],
            "launches": run["launches"], "launches_per_step": run["per_step"]}
        if run["final_digest"] is None:
            continue
        # the gathered checkpoint on one device, restored once through
        # restore(device=) by a Trainer made without the directory
        trainer = Trainer(cfg, opt, TrainConfig(num_steps=DP_STEPS + 1), pipe, seed=0,
                          batch_transform=family_inputs(cfg), device=dev)
        t0 = time.perf_counter()
        trainer.train_cfg.ckpt_dir = ckpt_dir
        start = trainer.restore(device=dev)
        restored = tree_digest(torch, state_leaves(torch, trainer.state))
        restore_s = time.perf_counter() - t0
        if start != DP_STEPS or restored != run["final_digest"]:
            fail(f"{arch} tensor-parallel elastic restore: step {start}, the restored "
                 f"state's digest {'==' if restored == run['final_digest'] else '!='} the "
                 f"ranks' gathered one")
        del trainer
        _free(torch)
        result[arch]["restore_s"] = restore_s
        log(f"tensor parallel training, {arch}: the checkpoint at step {DP_STEPS} (gathered "
            f"whole at model {TP_FAMILY_TRAIN_MODEL}) restored by a single-device Trainer on "
            f"{dev} bit for bit in {restore_s:.1f} s")
    wall = time.perf_counter() - t_phase
    log(f"tensor parallel training of the encdec and vlm families: single-device steps "
        f"{single_s:.1f} s, the ranks {spawn_s:.1f} s (a rank: whisper "
        f"{out['whisper-large-v3']['wall_s']:.1f} s, llava {out['llava-next-34b']['wall_s']:.1f}"
        f" s); phase 27 wall time {wall:.1f} s")
    result["wall_s"] = wall
    return result


# ---------------------------------------------------------------------------
# phase 28: the dry run, roofline, op accounting and hillclimb
# ---------------------------------------------------------------------------

# the examples/torch twins at their smallest settings: script, arguments,
# the line each must print
LAUNCH_EXAMPLES = (
    ("quickstart.py", (), "kernel == functional model: True"),
    ("cim_array_demo.py", (), "CiM output = min(a,8)-min(b,8) = 7"),
    ("serve_ternary.py", (), "served 10 requests"),
    ("train_ternary_lm.py", ("--steps", "3"), "final loss"),
)
# the production-mesh cells phase 28 costs, each in a process of its own:
# (tag, module, arguments, the JSON file it writes)
LAUNCH_CELLS = (
    ("smollm_train", "repro_torch.launch.dryrun",
     ("--arch", "smollm-135m", "--shape", "train_4k"), "smollm-135m__train_4k__16x16.json"),
    ("deepseek_decode", "repro_torch.launch.dryrun",
     ("--arch", "deepseek-v2-236b", "--shape", "decode_32k"),
     "deepseek-v2-236b__decode_32k__16x16.json"),
    ("deepseek_decode_fsdp", "repro_torch.launch.hillclimb",
     ("--arch", "deepseek-v2-236b", "--shape", "decode_32k", "--name", "fsdp", "--fsdp",
      "--calibration", "{table}"), "deepseek-v2-236b__decode_32k__fsdp.json"),
)
LAUNCH_TIMEOUT_S = 300


def launch_phase(torch, tm, pm, card, dev, training, calibration, per_kernel) -> dict:
    """Phase 28: the port's launch/ twins. Started first, in processes of
    their own beside the rest: (c) three production-mesh cells through
    lower_cell (the dryrun CLI: smollm-135m train_4k and deepseek-v2-236b
    decode_32k; the hillclimb CLI: that decode cell with --fsdp and phase
    20's table as --calibration), and (d) the four examples/torch scripts
    on the card (train_ternary_lm.py --steps 3), each exit 0 with its key
    line. Here: (a) one eager make_train_step step of phase 17's
    smollm-135m (8 x 128, remat, CiM) on the card under op_analysis.record
    (#1 launched 420 times, each launch recorded with its (M, K, N)), and
    the same step through lower_cell on the meta device at mesh (1, 1):
    FLOPs by dtype equal, #1's calls equal (420); the predicted peak
    beside torch.cuda.max_memory_allocated of the eager step (and that
    less what the process held beside the step's arguments before it:
    earlier phases' tensors), and the
    roofline's largest term beside phase 17's captured-step median (their
    ratio the step's roofline fraction); (b) hillclimb.score_cell of a
    4-row smollm-135m decode on phase 20's table (from its to_json())
    beside the measured #1 time of a decode step (the kernel phase's
    layer time x layers). Checked after (c): every cell ok, the FSDP
    cell's resident bytes below and its all-gather bytes above the
    cell without FSDP. One "launch" JSON line."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import hillclimb, op_analysis
    from repro_torch.launch.dryrun import lower_cell, tree_bytes
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import ShapeCell, get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.profile.calibrate import CalibrationTable
    from repro_torch.train.train_step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    tmp = tempfile.mkdtemp(prefix="launch-phase-")
    table_path = os.path.join(tmp, "table.json")
    with open(table_path, "w") as f:
        json.dump(calibration["table"], f)
    procs = {}
    try:
        for tag, module, args, _ in LAUNCH_CELLS:
            argv = [a.format(table=table_path) for a in args] + ["--out", tmp]
            procs[tag] = subprocess.Popen(
                [sys.executable, "-m", module, *argv], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for script, args, _ in LAUNCH_EXAMPLES:
            procs[script] = subprocess.Popen(
                [sys.executable, os.path.join(root, "examples", "torch", script), *args],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)

        # (a) one eager step counted on the card, and again on the meta device
        cfg = get_config("smollm-135m")
        opt = AdamWConfig(lr=3e-4, schedule=warmup_cosine(20, TRAIN_STEPS))
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
        state = init_train_state(cfg, seed=0, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(0).items()}
        step = make_train_step(cfg, opt)
        step(state, batch)      # warm: the first call's one-time work is not the step's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what the process holds beside the step's arguments (earlier phases')
        held = torch.cuda.memory_allocated() - tree_bytes((state.params, state.opt, batch))
        reset_counts(tm, pm)
        rec = op_analysis.record(step, state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        got = counts(tm, pm)
        cost = op_analysis.analyze(rec.trace)
        shapes = sorted({r.info[:3] for r in rec.trace if r.is_kernel})
        per_step = 2 * macs_per_step(cfg)
        want = dict.fromkeys(got, 0)
        want["ternary_cim_matmul"] = per_step
        if got != want or dict(cost.kernel_calls) != {"ternary_cim_mac": per_step}:
            fail(f"launch: the eager step launched {got}, recorded {dict(cost.kernel_calls)}")
        if not shapes or any(len(s) != 3 for s in shapes):
            fail(f"launch: kernel launches recorded without their shapes: {shapes}")
        del rec, state, batch
        torch.cuda.empty_cache()
        dry = lower_cell("smollm-135m", ShapeCell("phase17", "train", TRAIN_SEQ, TRAIN_BATCH),
                         mesh=AbstractMesh((1, 1), ("data", "model")), verbose=False)
        if not dry.ok:
            fail(f"launch: the dry run of phase 17's step failed: {dry.error}")
        cuda_flops = {k: v for k, v in sorted(cost.flops_by_dtype.items())}
        meta_flops = {k: v for k, v in sorted(dry.op_cost["flops_by_dtype"].items())}
        if cuda_flops != meta_flops or dry.op_cost["kernel_calls"] != dict(cost.kernel_calls):
            fail(f"launch: FLOPs by dtype on cuda {cuda_flops} != meta {meta_flops}, or "
                 f"kernel calls {dict(cost.kernel_calls)} != {dry.op_cost['kernel_calls']}")
        roof = dry.roofline
        terms = {"compute": roof["t_compute_s"], "memory": roof["t_memory_s"],
                 "collective": roof["t_collective_s"]}
        largest = max(terms.values())
        measured_s = training["step_ms"] / 1e3
        predicted_peak = dry.memory["peak_bytes"]
        log(f"launch: phase 17's step (smollm-135m, {TRAIN_BATCH} x {TRAIN_SEQ}, remat, "
            f"CiM) eager on cuda and dry on meta: FLOPs by dtype equal {cuda_flops}; #1 "
            f"{per_step} calls on both, launched at (M, K, N) {shapes}; HBM bytes "
            f"{cost.hbm_bytes:.4g} (cuda) / {dry.op_cost['hbm_bytes']:.4g} (meta); "
            f"predicted peak {predicted_peak / 1e9:.3f} GB (arguments "
            f"{dry.memory['argument_bytes'] / 1e9:.3f} + step "
            f"{dry.memory['step_peak_bytes'] / 1e9:.3f}) against "
            f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB of the eager step, "
            f"of which {held / 1e9:.3f} GB the process held beside the step's arguments "
            f"before it: the step's own {(peak - held) / 1e9:.3f} GB "
            f"({predicted_peak / (peak - held):.3f}x); roofline terms {terms} (f64 "
            f"{roof['t_compute_f64_s']:.4g} s), the largest ({roof['bottleneck']}) "
            f"{largest * 1e3:.3f} ms against phase 17's captured-step median "
            f"{training['step_ms']:.2f} ms: roofline fraction {largest / measured_s:.4f}; "
            f"the dry step took {dry.seconds:.1f} s on the host; {card}")

        # (b) the calibrated score beside the measured #1 time of a decode step
        table = CalibrationTable.from_json(calibration["table"])
        decode = ShapeCell("decode_4", "decode", 256, 4)
        score = hillclimb.score_cell("smollm-135m", decode, table, spec="blocked/cuda/none")
        layer_ms = per_kernel["ternary_cim_matmul"]["ms"]
        measured_us = layer_ms * cfg.n_layers * 1e3
        log(f"launch: score_cell(smollm-135m, 4-row decode) on phase 20's table: "
            f"{score['predicted_us']:.1f} us ({score['layers']} layer kinds, "
            f"{'trusted' if score['trusted'] else 'UNTRUSTED'}, worst residual "
            f"{score['worst_residual_pct']:.1f}%) against the measured #1 time of a decode "
            f"step {measured_us:.1f} us ({layer_ms:.4f} ms a layer x {cfg.n_layers} "
            f"layers): {score['predicted_us'] / measured_us:.3f}x; {card}")

        # (c) and (d): the processes started first
        outs = {}
        for tag, proc in procs.items():
            try:
                outs[tag] = proc.communicate(timeout=LAUNCH_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                fail(f"launch: {tag} ran past {LAUNCH_TIMEOUT_S} s")
            if proc.returncode != 0:
                fail(f"launch: {tag} exited {proc.returncode}:\n{outs[tag][-3000:]}")
        for script, _, line in LAUNCH_EXAMPLES:
            if line not in outs[script]:
                fail(f"launch: {script} did not print {line!r}:\n{outs[script][-2000:]}")
        cells = {}
        for tag, _, _, name in LAUNCH_CELLS:
            with open(os.path.join(tmp, name)) as f:
                cells[tag] = json.load(f)
            if not cells[tag]["ok"] or not cells[tag]["roofline"]:
                fail(f"launch: cell {tag} failed: {cells[tag]['error']}")
        plain, fsdp = cells["deepseek_decode"], cells["deepseek_decode_fsdp"]
        gathered = lambda c: c["roofline"]["coll_breakdown"].get("all-gather", 0.0)
        if not (fsdp["memory"]["argument_bytes"] < plain["memory"]["argument_bytes"]
                and fsdp["memory"]["param_bytes"] < plain["memory"]["param_bytes"]
                and gathered(fsdp) > gathered(plain)):
            fail(f"launch: FSDP did not lower the resident bytes ({fsdp['memory']} against "
                 f"{plain['memory']}) or raise the all-gather bytes ({gathered(fsdp)} "
                 f"against {gathered(plain)})")
        for tag, c in cells.items():
            r = c["roofline"]
            log(f"launch: {tag} ({c['mesh_name']}, dry, {c['seconds']:.1f} s on the host): "
                f"bottleneck {r['bottleneck']}, Tc {r['t_compute_s']:.4g} s (f64 "
                f"{r['t_compute_f64_s']:.4g}), Tm {r['t_memory_s']:.4g} s, Tx "
                f"{r['t_collective_s']:.4g} s; coll {r['coll_breakdown']}; memory "
                f"{c['memory']}" + (f"; calibrated {c['calibrated']}" if c.get("calibrated")
                                    else ""))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    found = {
        "phase17_step": {"flops_by_dtype": cuda_flops, "kernel_calls": per_step,
                         "hbm_bytes_cuda": cost.hbm_bytes,
                         "hbm_bytes_meta": dry.op_cost["hbm_bytes"],
                         "predicted_peak_bytes": predicted_peak, "measured_peak_bytes": peak,
                         "held_beside_arguments_bytes": held,
                         "roofline_terms_s": terms, "measured_step_s": measured_s,
                         "roofline_fraction": largest / measured_s,
                         "dry_seconds": dry.seconds},
        "calibrated": {"score": score, "measured_decode_mac_us": measured_us},
        "cells": {tag: {"roofline": c["roofline"], "memory": c["memory"],
                        "seconds": c["seconds"], "calibrated": c.get("calibrated")}
                  for tag, c in cells.items()},
        "examples": sorted(s for s, _, _ in LAUNCH_EXAMPLES), "wall_s": wall}
    log(f"launch: phase 28 wall time {wall:.1f} s on {card}")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the per-kernel numbers to this JSON file")
    ap.add_argument("--phase", choices=["27"], default=None,
                    help="build the kernels, then run this one phase alone and exit "
                         "without the result lines (a rehearsal of a self-contained "
                         "phase; the full check is the run without it)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs an NVIDIA GPU")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import ternary as tern_mod
    from repro_torch.kernels import DECODE_M_MAX, _build
    from repro_torch.kernels import packed_mac as pm
    from repro_torch.kernels import ternary_mac as tm

    t_script = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[name] = round(time.perf_counter() - t, 1)

    card = card_line()
    log(f"card: {card}; {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.2f} s "
        f"(nvcc, one process per source)")
    entry = ""
    for line in str(_build.last_build.get("log", "")).splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = found.group(1)
        elif line.startswith("=="):
            log("  " + line.strip())
        elif "registers" in line:
            log(f"  {short_name(entry)}: {line.split(':', 1)[-1].strip()}")
    sass = check_sass(_build.nvcc_path(), libs)
    phase_s["1"] = round(time.perf_counter() - t0, 1)
    for kernel, instances in sass.items():
        log(f"{kernel} SASS: " + "; ".join(
            f"{short_name(name)}: {ops}" for name, ops in sorted(instances.items())))

    if args.phase == "27":
        with tempfile.TemporaryDirectory() as family_tmp:
            timed("27", tp_family_train_phase, torch, tm, pm, card, torch.device("cuda"),
                  family_tmp)
        log(f"phase seconds: {json.dumps(phase_s)}; the script "
            f"{time.perf_counter() - t_script:.1f} s on {card}")
        return 0
    per_kernel, errs, extra = timed("2", kernel_phase, torch, tm, pm, tern_mod, DECODE_M_MAX,
                                    torch.device("cuda"))
    launches, serving = timed("3-10", serving_phases, torch, tm, pm, card,
                              torch.device("cuda"))
    serving["starcoder2_7b"] = timed("11", starcoder2_phase, torch, tm, pm, card,
                                     torch.device("cuda"))
    for arch in SSM_ARCHS:
        tag = arch.replace("-", "_").replace(".", "_")
        serving[tag] = timed(f"12-13 {arch}", ssm_family_phase, torch, tm, pm, card,
                             torch.device("cuda"), arch)
        per_kernel["ternary_cim_matmul"][tag].update(
            launches=serving[tag]["bf16"]["launches"],
            launches_per_step=serving[tag]["macs_per_step"])
    serving["capacity_zamba2"] = timed("13 capacity", zamba2_capacity, torch,
                                       torch.device("cuda"))
    for arch in CUT_ARCHS:
        tag = arch.replace("-", "_").replace(".", "_")
        serving[tag] = timed(f"14/16 {arch}", cut_model_phase, torch, tm, pm, card,
                             torch.device("cuda"), arch)
        per_kernel["ternary_cim_matmul"][tag].update(
            launches=serving[tag]["bf16"]["launches"],
            launches_per_step=serving[tag]["macs_per_step"])
    serving["whisper_large_v3"] = whisper = timed("15", whisper_phase, torch, tm, pm, card,
                                                  torch.device("cuda"))
    per_kernel["ternary_cim_matmul"]["whisper_large_v3"].update(
        launches=whisper["captured"]["launches"],
        launches_per_step=whisper["macs_per_step"])
    serving["training"] = training = timed("17", train_phase, torch, tm, pm, card,
                                           torch.device("cuda"))
    per_kernel["ternary_cim_matmul"]["smollm_135m_train"].update(
        launches=training["launches"], launches_per_step=training["launches_per_step"])
    serving["training_ssm"] = ssm_training = timed(
        "18", ssm_train_phase, torch, tm, pm, card, torch.device("cuda"))
    per_kernel["ternary_cim_matmul"]["mamba2_780m_train"].update(
        launches=ssm_training["mamba2_780m"]["launches"],
        launches_per_step=ssm_training["mamba2_780m"]["launches_per_step"])
    per_kernel["ternary_cim_matmul"]["zamba2_2_7b_train"].update(
        launches=ssm_training["zamba2_2_7b"]["launches"],
        launches_per_step=ssm_training["zamba2_2_7b"]["launches_per_step"])
    serving["frontdoor"] = timed(
        "19", frontdoor_phase, torch, tm, pm, card, torch.device("cuda"),
        serving["cim"]["captured_step_ms"])
    calibration = timed("20", calibration_phase, torch, tm, pm, card, torch.device("cuda"),
                        serving["cim"]["generated"])
    serving["tp"] = tp = timed("21", tp_phase, torch, card, serving["cim"])
    serving["tp_families"] = tp_families = timed("22", tp_family_phase, torch, card,
                                                 torch.device("cuda"))
    serving["analysis"] = timed("23", analysis_phase, torch, tm, pm, card,
                                torch.device("cuda"))
    # phase 26 reads phase 25's single-device files: one directory for both
    with tempfile.TemporaryDirectory() as dp_tmp:
        serving["data_parallel"] = dp = timed("25", dp_phase, torch, tm, pm, card,
                                              torch.device("cuda"), dp_tmp)
        serving["tp_training"] = tpt = timed("26", tp_train_phase, torch, tm, pm, card,
                                             torch.device("cuda"), dp.pop("single"), dp_tmp)
    with tempfile.TemporaryDirectory() as family_tmp:
        serving["tp_family_training"] = tpf = timed(
            "27", tp_family_train_phase, torch, tm, pm, card, torch.device("cuda"),
            family_tmp)
    serving["frontdoor_tp"] = timed("24", frontdoor_tp_phase, torch, card,
                                    torch.device("cuda"), serving["frontdoor"])
    launch = timed("28", launch_phase, torch, tm, pm, card, torch.device("cuda"),
                   training, calibration, per_kernel)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        pk = per_kernel[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": pk["ms"], "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
            "bound_by": pk["bound_by"], "library_ms": pk["library_ms"],
            "prefill_ms": pk["prefill_ms"],
            "tp_launches": (tp["serve"]["launches"] if name == "ternary_cim_matmul"
                            else tp["explicit"]["launches_packed"][name]),
            "tp_family_launches": ({arch: tp_families[arch]["launches"]
                                    for arch in TP_FAMILY_ARCHS}
                                   if name == "ternary_cim_matmul" else None),
            "dp_launches": (dp["launches"] if name == "ternary_cim_matmul" else None),
            "tp_train_launches": ({"smollm-135m": tpt["launches"],
                                   **{arch: tpf[arch]["launches"] for arch in TP_FAMILY_TRAIN}}
                                  if name == "ternary_cim_matmul" else None),
            **{tag: pk.get(tag) for tag in MODEL_TAGS},
        })
    result = {"kernels": kernels}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(result, card=card, timed_at_m={
                k: v["m"] for k, v in per_kernel.items()}, prefill={
                k: {f: v[f] for f in v if f.startswith("prefill")}
                for k, v in per_kernel.items() if v["prefill_ms"] is not None},
                sass=sass, serving=serving, calibration=calibration,
                **extra), f, indent=1)
    print(json.dumps({"calibration": {k: calibration[k] for k in (
        "fits", "engine", "replay", "projections", "winners")}}), flush=True)
    print(json.dumps({"launch": launch}), flush=True)
    log(f"phase seconds: {json.dumps(phase_s)}; the script "
        f"{time.perf_counter() - t_script:.1f} s to here on {card}")
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
