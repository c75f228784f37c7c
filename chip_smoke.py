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
     generate(), greedy, under act_scale="per_row";
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
     requests: tokens == generate(), one host sync per prefill and per
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
     experts top-6 with 2 shared; 4 of its 60 layers) and grok-1-314b (GQA,
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
     per_row, rows together == each alone; a profiled replayed step; the
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
 18. (run last) training the ssm and hybrid families: full-size
     mamba2-780m (bf16, remat, the CiM spec) through the Trainer as in
     phase 17 (20 steps, checkpoints every 10, a failure at 15), the
     phase leaving deterministic mode to Trainer.run(): losses and grad
     norms finite, the loss falling, steps 10-14 replayed bit-equal, #1
     launched 192 times in every step (96 forward + 96 remat) and no
     other MAC kernel, steps 0-4 bit-equal to 5 eager steps; one
     exact/cuda step (#5 192 times) and one under mode "off" (its grad
     norm), the captured and eager step medians, tokens/s, capture time,
     peak memory and a profiled replay; then full-size zamba2-2.7b: 3
     steps of make_jit_train_step, finite losses, #1 279 times a step
     (171 + 108: only the mamba layers sit under remat), step ms, capture
     time and peak memory. The kernel phase bit-checks #1 at M in {1024, 1023}
     at every (K, N) of phases 12 and 13 (#5 at mamba2's) and times one
     mamba2 and one zamba2 layer's calls at M=1024 ("mamba2_780m_train",
     "zamba2_2_7b_train" in the kernels line).
It then prints the card line, a JSON line of per-kernel numbers, and
last the result line. Without CUDA, or without ``src/repro_torch`` beside
it, it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
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


def token_identity(torch, batcher, reqs, params, cfg, generate, spec, label):
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
    log(f"{label}: captured batcher == generate() for {len(reqs)} requests "
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


def looped_phase(torch, tm, pm, params, row_cfg, card, fused, dev) -> dict:
    """Phase 10: the looped baseline (fused=False, greedy, per_row) over 4
    requests, eager: tokens == generate(), one host sync per prefill and
    per active slot a step (= the tokens served), one prefill batch per
    request, #1 launched 210 x (4 slots x decode steps + prefills); its
    step median beside the fused step's (phase 3, ``fused``)."""
    from repro_torch.serve.engine import ContinuousBatcher, Request, generate

    batcher = ContinuousBatcher(params, row_cfg, n_slots=4, s_max=256, fused=False,
                                device=dev)
    reqs = make_requests(Request, row_cfg.vocab, seed=6, n=4)
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
        layers=4, cache_bytes={"bf16": 589_824, "int8": 299_008, "ternary": 151_552},
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
    batched = E.generate(params, prompt, row_cfg, max_new=8, s_max=128, device=dev,
                         enc=T.run_encoder(params, frames, row_cfg))
    for i in range(4):
        solo = E.generate(params, prompt[i:i + 1], row_cfg, max_new=8, s_max=128,
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


def ssm_train_phase(torch, tm, pm, card, dev) -> dict:
    """Phase 18: full-size mamba2-780m (48 layers, d 1536, vocab 50280,
    bf16, remat, the CiM spec: its config's, checked as phase 12 does)
    trained as phase 17 trains smollm-135m: seed-0 params, TokenPipeline
    seed 0 at batch 8 x seq 128, lr 3e-4 under warmup_cosine(20, 20), 20
    steps through the port's Trainer, checkpoints every 10 steps and a
    failure injected at step 15. The phase does not touch deterministic
    mode: Trainer.run() sets it and restores it, and the phase fails
    unless it is off again after the run. Every loss and grad norm
    finite, the last 5 steps' mean loss below the first 5's, one restart,
    steps 10-14 replayed bit-equal, #1 launched 2 x 96 = 192 times in
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
    cfg = full_size("mamba2-780m")
    per_step = 2 * macs_per_step(cfg)   # the forward, then remat's recompute
    if per_step != 192:
        fail(f"mamba2 training: {per_step} MACs a step, expected 192")
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
    log(f"training mamba2-780m (full size, bf16, remat, CiM spec; batch "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the per-kernel numbers to this JSON file")
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
    for kernel, instances in sass.items():
        log(f"{kernel} SASS: " + "; ".join(
            f"{short_name(name)}: {ops}" for name, ops in sorted(instances.items())))

    per_kernel, errs, extra = kernel_phase(torch, tm, pm, tern_mod, DECODE_M_MAX,
                                           torch.device("cuda"))
    launches, serving = serving_phases(torch, tm, pm, card, torch.device("cuda"))
    serving["starcoder2_7b"] = starcoder2_phase(torch, tm, pm, card, torch.device("cuda"))
    for arch in SSM_ARCHS:
        tag = arch.replace("-", "_").replace(".", "_")
        serving[tag] = ssm_family_phase(torch, tm, pm, card, torch.device("cuda"), arch)
        per_kernel["ternary_cim_matmul"][tag].update(
            launches=serving[tag]["bf16"]["launches"],
            launches_per_step=serving[tag]["macs_per_step"])
    serving["capacity_zamba2"] = zamba2_capacity(torch, torch.device("cuda"))
    for arch in CUT_ARCHS:
        tag = arch.replace("-", "_").replace(".", "_")
        serving[tag] = cut_model_phase(torch, tm, pm, card, torch.device("cuda"), arch)
        per_kernel["ternary_cim_matmul"][tag].update(
            launches=serving[tag]["bf16"]["launches"],
            launches_per_step=serving[tag]["macs_per_step"])
    serving["whisper_large_v3"] = whisper = whisper_phase(torch, tm, pm, card,
                                                          torch.device("cuda"))
    per_kernel["ternary_cim_matmul"]["whisper_large_v3"].update(
        launches=whisper["captured"]["launches"],
        launches_per_step=whisper["macs_per_step"])
    serving["training"] = training = train_phase(torch, tm, pm, card,
                                                 torch.device("cuda"))
    per_kernel["ternary_cim_matmul"]["smollm_135m_train"].update(
        launches=training["launches"], launches_per_step=training["launches_per_step"])
    serving["training_ssm"] = ssm_training = ssm_train_phase(
        torch, tm, pm, card, torch.device("cuda"))
    per_kernel["ternary_cim_matmul"]["mamba2_780m_train"].update(
        launches=ssm_training["mamba2_780m"]["launches"],
        launches_per_step=ssm_training["mamba2_780m"]["launches_per_step"])
    per_kernel["ternary_cim_matmul"]["zamba2_2_7b_train"].update(
        launches=ssm_training["zamba2_2_7b"]["launches"],
        launches_per_step=ssm_training["zamba2_2_7b"]["launches_per_step"])

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        pk = per_kernel[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": pk["ms"], "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
            "bound_by": pk["bound_by"], "library_ms": pk["library_ms"],
            "prefill_ms": pk["prefill_ms"],
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
                sass=sass, serving=serving,
                **extra), f, indent=1)
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
