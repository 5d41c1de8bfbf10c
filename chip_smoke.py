#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ATLAS on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out records.json]

Phases, each of which raises on failure (the script then exits non-zero):

  device   the card's name and power limit (nvidia-smi), torch and nvcc
  build    nvcc-builds the CUDA kernels from src/repro_torch/kernels/csrc;
           records each attention, forest and scan kernel's registers and
           spills (ptxas -v; fails unless all 18 forest instances, the
           rwkv6 instance of each head_dim in both dtypes and the 32
           attention instances (head_dims 32, 64, 128, 160) are there, or
           if the bf16 flash instance at head_dim 160 spills) and
           the tensor-core
           instructions (HMMA/HGMMA) cuobjdump finds in the bf16 flash and
           SSD kernels' SASS, and fails if it finds none in either
  kernels  each forest kernel against its plain torch version and the
           numpy mirror (torch.equal), on the grouped-inference test cases,
           a Tree (T=1, D=6) and a fat flush (M=2, R=4096, T=24, D=5); at
           1, 13 and 4096 rows, and after the slice phase at the brokered
           run's mean flush size (~308 rows), the CUDA-event time of a call,
           the kernel's own device time under torch.profiler, the plain
           version's time, the bound, the device time of one trivial launch
           (the launch floor) and the whole host call against the numpy
           mirror; the host time of each step of a 13-row decision
  fit      the 1000-node map_heavy baseline run, then R.F. fitted on its
           trace on the card and on the CPU: equal parameters
  slice    the §5 protocol (compare("fifo")) on the card at 1000 nodes with
           invariant checking, then the same ATLAS run behind the batched
           BrokerPredictor; zero violations, exactly 1,681 forest_infer and
           1,368 forest_infer_grouped launches, equal metrics, and every probability either run served equal to
           the numpy mirror on the same rows and parameters
  parity   100-node ATLAS runs under the baseline chaos and under the
           kitchen_sink scenario (where ATLAS predicts failures), each with
           the predictor on the card, on the CPU and behind the
           BrokerPredictor on the card, from the same trained parameters:
           equal metrics
  trace    the 1000-node ATLAS run, scalar and brokered, under
           torch.profiler: the card's idle share and the kernels' own
           device times
  attn_kernels
           each attention kernel against its plain version in float32 and
           bf16 (2e-3 / 2e-2): flash at nemo's and zamba2's prefill shapes,
           a ragged S, a window with D=64, a right-aligned non-causal
           case, whisper's encoder (S = Skv = 1500, D=64, non-causal),
           cross-attention to fewer keys than queries, qwen3's group of
           16 and stablelm-12b's prefill (head_dim 160); decode at both
           serving caches, with ragged kv_len, with a window, at qwen3's
           group of 16, against whisper's 1500-row static cross cache and
           at stablelm-12b's last step (head_dim 160).  Times the kernel,
           its plain version and PyTorch's scaled_dot_product_attention (a
           yardstick only) by CUDA events, and the kernel's own device time
           under torch.profiler
  serve_parity
           the smoke-reduced mistral-nemo-12b (float32, TF32 off): prefill
           2x16 then 8 greedy decode steps on the card through the kernels,
           on the card through the plain versions and on the CPU through
           the plain versions: every attention call within 1e-4 of its
           plain version, tokens equal, logits within 4x the card-plain vs
           CPU gap; the same for stablelm-12b's smoke config at 2 layers
           with head_dim 160 put back
  serve    mistral-nemo-12b at full width, its depth cut 40 -> 20 layers
           (SERVE_DEPTH), bf16, seeded weights: 4 requests of 1024 prompt
           tokens, 64 generated each (one prefill, 63 decode steps), through
           launch/serve.py's generate; exactly 20 flash and 1,260 decode
           launches; the same tokens teacher-forced
           through the plain versions on the card; a second run with every
           attention call held to its plain version on the same inputs
           (2e-2); a plain-vs-plain chunking control and layer 0's softmax
           saturation; prefill s, decode tok/s, peak memory, and the decode
           loop's idle share under torch.profiler
  serve_stablelm12b
           stablelm-12b (head_dim 160) whole, bf16, seeded weights, serve's
           traffic through generate: exactly 40 flash and 2,520 decode
           launches, finite logits, token ids in range; a second run with
           every attention call held to its plain version (2e-2; a row
           where they disagree is settled in float64); weights and peak
           memory, prefill s, decode tok/s and 16 profiled decode steps
  scan_kernels
           the RWKV6 and Mamba2 scan kernels against their plain versions in
           float32 and bf16 (y 5e-3 / 5e-2, the float32 state 1e-3): the
           serving prefill shape, tests/test_kernels.py's scan cases, a
           ragged S = 1000, S = 1, 63, 65 and 4096, and strong decays (the
           model's RWKV decay with exact zeros; Mamba2's A down to -50); the
           sequence in two calls with the state carried equals one call
           (bitwise, but within the tolerances for the chunked bf16 Mamba2
           kernel, whose chunk boundaries move with the cut); the kernel
           timed by CUDA events at every case, at the serving shape by
           scan_timing, which adds its own device time under
           torch.profiler; the plain version timed at the serving shape (no
           single PyTorch call computes either recurrence)
  recurrent_serve_parity
           the smoke-reduced rwkv6-1.6b and zamba2-1.2b, as serve_parity:
           every kernel call within 1e-4 of its plain version, tokens equal
           on card-kernel, card-plain and CPU, logits within 4x the
           card-plain vs CPU gap
  serve_rwkv6, serve_zamba2
           each model at full width, its depth cut to half (SERVE_DEPTH:
           rwkv6 24 -> 12, zamba2 38 -> 18 layers, three periods), bf16,
           seeded weights, the traffic of serve (4 x (1024 + 64) tokens)
           through generate; exactly 12 rwkv6_scan launches, and 18
           mamba2_ssd + 3 flash + 189 decode launches; the same tokens
           teacher-forced through the plain
           versions (the logit gap reported; tokens held where the top-2
           margin exceeds twice it); a second run with every kernel call held
           to its plain version (bf16 tolerances); prefill s, decode tok/s,
           ms per step, peak memory, each kernel's device time in a profiled
           prefill and the decode loop's idle share
  family_serve_parity
           serve_parity for the smoke-reduced deepseek-moe-16b,
           qwen3-moe-235b-a22b, llama-3.2-vision-90b (its cross blocks'
           gates, zero at init, opened to 0.5) and whisper-large-v3, with
           seeded media (normal x 0.02) for the last two
  serve_moe, serve_qwen3, serve_vlm, serve_whisper
           deepseek-moe-16b (14 of 28 layers), qwen3-moe-235b-a22b (4 of
           94 layers), llama-3.2-vision-90b (10 of 100 layers: two periods
           of four self blocks and a cross block; gates opened, 1024 seeded
           media tokens a request) and whisper-large-v3 (16 of 32 decoder
           layers, the 32 encoder layers whole; 1500 seeded frames and a
           64-token prompt a request) at full width,
           bf16, seeded weights, the traffic of serve: exactly the derived
           flash and decode launches (28 / 1,764; 4 / 252; 10 / 630; 96 /
           4,032); the same
           tokens teacher-forced through the plain versions; a second run
           with every attention call held to its plain version (2e-2; a
           row where they disagree is settled in float64); prefill s,
           decode tok/s, ms per step, peak memory, the decode loop's idle
           share and device operations per step; for MoE the (token,
           expert) pairs a prefill drops at capacity_factor 1.25
  cv       the paper's §4.1.3 table on the card: cross_validate of each of
           the six models (k = 5, max_n = 12000) on the map dataset of
           fit's 1000-node trace, on the card and on the CPU on the same
           rows: the forest family's metrics equal, GLM's and N.N.'s within
           0.005; time_ms per model, the GLM and N.N. fits' share of the
           card's CV time and the device operations of one fit of each
           (torch.profiler); forest_infer launched
  sweep    the §5 fleet sweep at 150 nodes (fifo and atlas-fifo x 1 seed
           x baseline and kitchen_sink, map_heavy, per-node hazard) four
           times: serial on the card, broker on the card with a model
           registry, a 2-worker spawn process pool on the card, and serial
           on the CPU in a spawned process alongside the card runs; spec,
           cells, aggregates and rankings equal, broker dispatches,
           kitchen_sink ATLAS predictions and both forest kernels' launches
           above 0; each run's wall time
  drift    one drift-aware ATLAS run (drift=True) in parity's 100-node
           kitchen_sink cell, the predictor on the card and on the CPU from
           the same trained start: equal metrics, refresher trio and
           refresh events, with refreshes above 0
  search   the scenario-search smoke configuration (8 evaluations x 1
           seed, 20 nodes, the smoke workload, invariants on) through
           run_search on the card and on the CPU: equal results apart from
           provenance, no invariant violation
  serve_async
           the sweep's baseline cells (fifo and atlas-fifo x 1 seed, 500
           nodes, map_heavy, per-node hazard) four times: the broker
           executor, the async executor (an AsyncBroker on the card), the
           async executor under benchmarks/chaos_smoke.py's fault shape with
           the request timeout at least 4x the clean run's longest wait,
           and the async executor on the CPU in a spawned process; spec,
           cells, aggregates and rankings equal, perf.broker equal across
           the card runs, faults injected and retried with no fallback,
           every probability the card runs served equal to the numpy
           mirror, forest_infer_grouped launched exactly once per server
           dispatch; walls and longest waits
  online_bench
           python -m repro_torch.online.bench's run_bench_sizes on the
           card at the paper's fleet and 1000 nodes (12,000 rows, 12
           clients, map_heavy / bursty_tt), open loop on inproc/poisson,
           inproc/bursty and tcp/poisson: every mode's outputs equal the
           numpy mirror, rows/s above 0, forest_infer launched exactly
           once per predictor dispatch of the scalar mode and
           forest_infer_grouped once per flush dispatch; rows/s, open-loop
           p50/p95/p99 and SLO violations, whether the CLI's tail budget
           held, the tcp serializer
  obs      the telemetry layer, after serve_async: (a) compare("fifo") on
           the slice's config with obs_path, on the card: metrics apart
           from "obs" equal slice's, exactly 1,681 forest_infer launches
           (the last ATLAS frame's predictor dispatches too), both frame
           files byte-equal to the same run's on the CPU (spawned
           alongside); (b) serve_async's spec through the broker executor
           with obs_dir and the async executor with obs_dir and obs_live
           to a separate python -m repro_torch.obs.live process, /delta
           polled mid-run: SWEEP.json without perf.obs equal to
           serve_async's broker bytes, every cell a source with frames on
           /snapshot, the polled seqs gapless, their replay through a fresh
           TelemetryCollector equal to the live aggregates, observed
           flushes = forest_infer_grouped launches = dispatches; the flush
           wall latency (p50, p99) and row histograms; (c)
           benchmarks/obs_overhead.py's paired-median CPU-time estimator on
           the 1000-node ATLAS run, in a spawned process of its own as the
           benchmark runs: the NDJSON sink gated at 5 % (31 pairs, any of 3
           attempts), the live tcp sink's overhead recorded, not gated; the
           wall clock's reading of both kept beside
  train_kernels
           flash_attention, rwkv6_scan and mamba2_ssd under autograd at
           the training microbatches' shapes, bf16 (attention also at the
           vlm's and whisper's non-causal cross-attention, whisper's
           1500 x 1500 encoder and stablelm-12b's head geometry at head_dim
           160): each Function's forward torch.equal to
           the bare kernel and within the kernel's tolerance of the plain
           version, its gradients within TRAIN_GRAD_TOL of autograd
           through the plain version; times of forward + backward, the
           plain version's and SDPA's
  train_step, train_step_rwkv6, train_step_zamba2, train_step_moe,
  train_step_whisper
           stablelm-1.6b (8 steps) and rwkv6-1.6b (3 steps) at full width
           and depth; zamba2-1.2b (18 of 38 layers) and whisper-large-v3
           (16 of 32 encoder and decoder layers; 1500 seeded frames a
           sequence; from the reference's draw with the attention fan-in
           fixed, the first gradient norm by depth from both draws
           recorded) at full width, 2 steps each; deepseek-moe-16b at full
           width cut to 4 layers (3 steps, bf16 moments); through
           make_train_step:
           launches equal to the derived counts, every gradient leaf
           finite and not all zero, the first loss within TRAIN_LOSS_RTOL
           of the plain versions'; losses on the stream and on a fixed
           batch, step times, peak memory, a profiled step's idle share;
           for MoE the aux loss and the pairs dropped a step; for
           stablelm-1.6b the init witness (_init_witness), whose loss must
           fall
  train_vlm
           the smoke-reduced llama-3.2-vision-90b in bf16, gates opened,
           with bf16 and with float32 media: 3 steps through the kernels
           against 3 through the plain versions, exact launches, losses
           within TRAIN_LOSS_RTOL
  train_elastic
           repro_torch.launch.train.main on stablelm-1.6b at full width
           cut to 4 layers (ATLAS on; --layers 4, for the time limit: each
           checkpoint is ~6 GB instead of 16.4): committed steps,
           launches, the bytes and seconds of
           each checkpoint save and restore, a restore with its digests
           checked
  compression
           optim/compression.py's compress, decompress and
           compressed_psum (one process) on the card torch.equal to the
           CPU, float32 and bf16

  examples the five examples/torch_*.py (quickstart, hadoop_sim,
           fleet_sweep, serve_atlas, chaos_train) on the card, each a
           process of its own, all at once, at small arguments, while the
           dry run's grid finishes: every exit code 0 and each one's result
           line printed
  dryrun   launch/dryrun.py's grid on pod16x16 (40 cells), traced on
           meta in DRYRUN_JOBS spawned processes while the training phases
           and the examples run: no cell in error or refused (32 ok),
           skipped exactly the long_500k cells of the full-attention archs;
           each cell's trace_s, FLOPs and temporaries
  dryrun_cells
           DRYRUN_CELLS on one card (mesh h100x1), each dry-run first (its
           global batch cut to a power of two where the whole step does not
           fit 80 GB), then run for real through the kernels under the same
           counting mode: launches equal to ops.launch_counts() and to the
           dry run's, the arguments' bytes equal to the dry run's, FLOPs
           equal on meta and on the card, the predicted peak (arguments +
           temporaries) within DRYRUN_PEAK_TOL of max_memory_allocated,
           every output finite; that run's step s and TFLOP/s (the
           counting mode's host work included)
  sharded  the decode kernel's partial mode: nemo's and stablelm-12b's
           caches (bf16) with ragged kv_len and slices with no live key,
           and zamba2 decode_32k's shared-attention window cache (B=128,
           4096 rows, H=Hkv=32, D=64) at its real kv_len, each cut into
           1, 2 and 4 slices, with and without a window: each slice's
           (o, m, l) against the plain partial, the merged slices against
           the whole-cache kernel and the plain version (ATTN_TOL); per
           slice count one slice's CUDA-event and device ms, the plain
           partial's and the bound (launch/cost.py).  Then build_cell's
           stablelm-1.6b x train_4k (8 sequences) and x prefill_32k (2
           sequences) and zamba2-1.2b x decode_32k through
           parallel/partition.py:run_cell on the (1, 1) mesh h100x1 over
           NCCL (the kv_seq-sharded decode through the partial mode), each
           against the unpartitioned step on the same arguments: the same
           launches (the partial mode's in place of the whole-cache
           decode's); loss, grad norm, two leaves' first moments and
           updated weights within TRAIN_LOSS_RTOL; next tokens equal,
           logits and the prefill's cache within ATTN_TOL

Earlier lines are JSON records; then the kernels line, the nvidia-smi line,
and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --timing {forest,scan,serve,decode} [--src DIR]

only times the forest kernels (forest_timing at TIMED_ROWS), the scan
kernels (scan_timing), serving's prefill and decode steps
(serve_timing) or the decode kernel's normal mode (decode_timing, with
the ptxas registers and spills of its instances), importing the port
from DIR (default: this
checkout's src/), and prints the timing as its last JSON line: run it on
an older tree from git archive and on this one in turns to compare two
versions on one card (--timing forest reads its bounds from DIR's
launch/cost.py, which trees from the dry-run slice on have).  Without a CUDA device, or without
the repository's src/ beside this file, it exits non-zero and prints no
result.  Imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

TIMED_ROWS = (1, 13, 4096)
N_TIMED = 100
FLEET = 1000
PARITY_FLEET = 100
SOURCES = {"forest_infer": "src/repro_torch/kernels/csrc/forest.cu",
           "forest_infer_grouped": "src/repro_torch/kernels/csrc/forest.cu",
           "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "decode_attention":
               "src/repro_torch/kernels/csrc/decode_attention.cu",
           "decode_attention_partial":
               "src/repro_torch/kernels/csrc/decode_attention.cu",
           "rwkv6_scan": "src/repro_torch/kernels/csrc/recurrence.cu",
           "mamba2_ssd": "src/repro_torch/kernels/csrc/recurrence.cu"}
REPLACES = {"forest_infer": "src/repro/kernels/forest.py:70",
            "forest_infer_grouped": "src/repro/kernels/forest.py:171",
            "flash_attention": "src/repro/kernels/flash_attention.py:91",
            "decode_attention": "src/repro/kernels/decode_attention.py:70",
            "decode_attention_partial":
                "src/repro/kernels/decode_attention.py:70",
            "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:52",
            "mamba2_ssd": "src/repro/kernels/mamba2_ssd.py:49"}
FOREST_KERNELS = ("forest_infer", "forest_infer_grouped")
# the 1000-node runs' forest launches: one per scored decision (compare)
# and one per broker flush (the brokered run)
SCALAR_LAUNCHES, BROKER_LAUNCHES = 1681, 1368
# the JAX package's "kitchen_sink" chaos scenario (repro/cluster/scenarios.py),
# as values: at 100 nodes ATLAS predicts failures under it and relocates
KITCHEN_SINK = dict(intensity=9.0, kill_tt=0.22, suspend_tt=0.12,
                    kill_dn=0.16, net_slow=0.22, net_drop=0.08,
                    burst_prob=0.10, burst_size=(4, 8), mean_outage=1100.0)

# the serving run: mistral-nemo-12b, 4 requests x (1024 prompt + 64 new)
SERVE_ARCH = "mistral-nemo-12b"
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 1024, 64
PROFILED_STEPS = 16
# (B, S, Skv, H, Hkv, D, causal, window); "main" is nemo's prefill shape,
# "zamba2" zamba2's shared attention in prefill, "whisper_encoder"
# whisper-large-v3's encoder over 30 s of audio, "cross" cross-attention to
# fewer keys than queries (llama-3.2-vision's 1024 media tokens, a
# 1088-token text), "qwen3" qwen3-moe's group of 16, "stablelm12b"
# stablelm-12b's prefill (head_dim 160)
FLASH_CASES = {"main": (4, 1024, 1024, 32, 8, 128, True, 0),
               "zamba2": (4, 1024, 1024, 32, 32, 64, True, 4096),
               "ragged": (4, 1000, 1000, 32, 8, 128, True, 0),
               "window": (4, 1024, 1024, 16, 4, 64, True, 256),
               "right_aligned": (4, 256, 1024, 32, 8, 128, False, 0),
               "whisper_encoder": (4, 1500, 1500, 20, 20, 64, False, 0),
               "cross": (4, 1088, 1024, 64, 8, 128, False, 0),
               "qwen3": (4, 1024, 1024, 64, 4, 128, True, 0),
               "stablelm12b": (4, 1024, 1024, 32, 8, 160, True, 0)}
# (B, Smax, H, Hkv, D, window, kv_len); "main" is nemo's last decode
# step's, "zamba2" zamba2's (its W = 1088-row window cache, full),
# "qwen3" qwen3-moe's last step (16 query heads per kv head, the decode
# kernel's DECODE_MAX_GROUP), "cross_static" whisper's static cross cache
# of 1500 encoder frames (kv_len = all of them), "stablelm12b"
# stablelm-12b's last step (head_dim 160)
DECODE_CASES = {"main": (4, 1088, 32, 8, 128, 0, (1088,) * 4),
                "zamba2": (4, 1088, 32, 32, 64, 4096, (1088,) * 4),
                "ragged": (4, 1088, 32, 8, 128, 0, (1025, 1088, 1, 530)),
                "window": (4, 1088, 32, 8, 128, 256, (1088, 700, 256, 3)),
                "qwen3": (4, 1088, 64, 4, 128, 0, (1088,) * 4),
                "cross_static": (4, 1500, 20, 20, 64, 0, (1500,) * 4),
                "stablelm12b": (4, 1088, 32, 8, 160, 0, (1088,) * 4)}
# the attention cases of the moe, vlm and audio families, reported in the
# kernels line beside "main" and "zamba2"
FAMILY_FLASH_CASES = ("whisper_encoder", "cross", "qwen3")
FAMILY_DECODE_CASES = ("qwen3", "cross_static")
# stablelm-12b, served whole through generate with serve's traffic: its
# head_dim, 160, is the one both attention kernels took last; the
# serve_parity phase adds its smoke config at 2 layers with head_dim 160
# put back (smoke_reduce sets 32)
HEAD160_ARCH = "stablelm-12b"
HEAD160_CASE = "stablelm12b"
HEAD160_SMOKE = dict(n_layers=2, head_dim=160)
ATTN_TOL = {"float32": 2e-3, "bfloat16": 2e-2}   # tests/test_kernels.py:17-19
# in a model's held run: the most output rows of one attention call that
# may disagree with the plain version, each then settled in float64
MAX_DISPUTED_ROWS = 64
ATTN_KERNELS = ("flash_attention", "decode_attention")
# the CUDA kernels' names (a profiler trace's kernel names contain them)
KERNEL_KINDS = ("flash_attention", "decode_attention", "rwkv6_scan",
                "mamba2_ssd")
# the moe, vlm and audio families, each served with serve's traffic
FAMILY_ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b",
                "llama-3.2-vision-90b", "whisper-large-v3")
# the served models' depths where they are cut, at full width: qwen3-moe
# (94 layers, 470 GB) and llama-3.2-vision-90b (100 layers, 175 GB) to fit
# one card and the time limit (vlm: two periods of four self blocks and one
# cross block); mistral-nemo-12b, rwkv6-1.6b, zamba2-1.2b (three periods of
# 6), deepseek-moe-16b and whisper-large-v3's decoder (its encoder stays
# whole) to half when an H100 run of the whole script passed its 1,200 s
# limit (they were served whole in 170-205 s of it); stablelm-12b
# (serve_stablelm12b) stays whole
SERVE_DEPTH = {"mistral-nemo-12b": 20, "rwkv6-1.6b": 12, "zamba2-1.2b": 18,
               "deepseek-moe-16b": 14, "qwen3-moe-235b-a22b": 4,
               "llama-3.2-vision-90b": 10, "whisper-large-v3": 16}
# whisper's decoder prompt: 64 tokens, with the 64 generated within its
# 448-token text context (each request also carries 1500 frames, 30 s of
# audio); the other families take serve's 1024
FAMILY_PROMPT = {"whisper-large-v3": 64}
# --timing serve: the archs and the timed runs of each (after a warm-up)
SERVE_TIMED = ("mistral-nemo-12b", "deepseek-moe-16b", "whisper-large-v3")
SERVE_TIMED_RUNS = 2
FAMILY_PHASE = {"deepseek-moe-16b": "serve_moe",
                "qwen3-moe-235b-a22b": "serve_qwen3",
                "llama-3.2-vision-90b": "serve_vlm",
                "whisper-large-v3": "serve_whisper"}
# the vlm cross blocks' tanh gates start at zero, which hides the cross
# attention and its MLP from the logits: every run opens them to this
CROSS_GATE = 0.5
MEDIA_SEED = 3
DEVICE_TIMED = 20    # calls profiled per case for a kernel's device time

# the recurrent serving runs, the same traffic as SERVE_ARCH's
RECURRENT_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")
SCAN_KERNELS = ("rwkv6_scan", "mamba2_ssd")
SERVE_PATH = {"rwkv6_scan": "serve_rwkv6", "mamba2_ssd": "serve_zamba2"}
# (B, S, H, Dh) and (B, S, H, P, N): "main" is the serving prefill's shape,
# k16/k64/k32 tests/test_kernels.py:86-155's cases, then a ragged S, the
# shortest sequence, both sides of a chunk boundary (the rwkv6 kernel stages
# 16 steps, the bf16 SSD kernel takes chunks of 64) and a long sequence;
# "*_strong" cases draw strong decays (_rwkv_inputs, _ssd_inputs)
RWKV_CASES = {"main": (4, 1024, 32, 64), "k16": (1, 64, 2, 16),
              "k64": (2, 128, 4, 64), "k32": (1, 256, 8, 32),
              "ragged": (4, 1000, 32, 64), "s1": (4, 1, 32, 64),
              "s63": (4, 63, 32, 64), "s65": (4, 65, 32, 64),
              "s4096": (1, 4096, 4, 64), "main_strong": (4, 1024, 32, 64),
              "s1_strong": (4, 1, 32, 64)}
SSD_CASES = {"main": (4, 1024, 64, 64, 64), "k16": (1, 64, 2, 16, 16),
             "k64": (2, 128, 4, 64, 64), "k32": (1, 256, 8, 32, 16),
             "ragged": (4, 1000, 64, 64, 64), "s1": (4, 1, 64, 64, 64),
             "s63": (4, 63, 64, 64, 64), "s65": (4, 65, 64, 64, 64),
             "s4096": (1, 4096, 4, 64, 64),
             "main_strong": (4, 1024, 64, 64, 64),
             "s1_strong": (4, 1, 64, 64, 64)}
SCAN_TOL = {"float32": 5e-3, "bfloat16": 5e-2}   # tests/test_kernels.py:105-110
STATE_TOL = 1e-3                                 # the float32 final state
SCAN_CUT = 77            # where a sequence is cut to carry the state

# the ATLAS phases after serving: the paper's predictor study and §5 sweep
# folds cut from the paper's 10 to 5 for the time limit
CV_FOLDS, CV_MAX_N = 5, 12000
CV_FOREST = ("Tree", "CTree", "R.F.", "Boost")   # bitwise card = CPU
CV_DENSE_TOL = 0.005                             # GLM, N.N.: float sums
# seeds cut from 2 to 1 for time: at 1000 nodes with per-node hazard the
# kitchen_sink ATLAS cell makes about 333,000 decisions, some 70 s on the
# card and 150 s on the CPU per run (PERF.md); with the training phases the
# script neared its time limit (1,065 s of 1,200 on an H100), so the fleet
# is cut to SWEEP_FLEET nodes too (the phase 310 s -> 133 s at 500 nodes;
# cut to 300 when the moe and audio training phases took the script to
# 1,058 s; to 150 when an H100 run of the script passed 1,200 s: at 100
# it took no less, 72 s against 59, since a smaller fleet takes the same
# workload longer and scores about as many rows)
SWEEP_FLEET = 150
SWEEP = dict(schedulers=("fifo", "atlas-fifo"), seeds=1,
             scenarios=("baseline", "kitchen_sink"), workloads=("map_heavy",),
             fleet_sizes=(SWEEP_FLEET,), hazard="per-node")
SWEEP_WORKERS = 2
SWEEP_KEYS = ("spec", "cells", "aggregates", "rankings")
# serve_async: the sweep's baseline half at SERVE_ASYNC_FLEET nodes
# (kitchen_sink's ATLAS cell stays in sweep only), served four ways.  Seeds
# cut from 2 to 1 for time: at 2 seeds the four runs took 39-54 s each on
# the card (1.87 M scored rows, 12,856 demand calls) and the phase 144 s
# (PERF.md); the fleet cut from FLEET to 500 nodes when an H100 run of the
# script passed 1,200 s (at 1000 nodes the card's three runs took 24-39 s
# each, at 500 11-19 s, and obs runs this spec twice more; at 300 they
# took as long as at 500)
SERVE_ASYNC_FLEET = 500
SERVE_ASYNC = dict(schedulers=("fifo", "atlas-fifo"), seeds=1,
                   scenarios=("baseline",), workloads=("map_heavy",),
                   fleet_sizes=(SERVE_ASYNC_FLEET,), hazard="per-node")
# the fault shape of benchmarks/chaos_smoke.py's parity plan; the request
# timeout is sized from the clean async run's longest wait (at least
# TIMEOUT_OVER_WAIT times it), the deadline is FAULT_BOUNDS' largest
CHAOS_PLAN = dict(seed=7, drop=0.12, delay=0.2, delay_s=(0.0005, 0.002),
                  duplicate=0.08, restart_after=(40,), max_events=24,
                  deadline_s=600.0)
TIMEOUT_OVER_WAIT = 4.0
MIN_TIMEOUT_S = 0.25
# online_bench: run_bench_sizes at the paper's fleet and at FLEET (whose
# candidate-set requests are 256 rows), the open loop on inproc/poisson,
# inproc/bursty and tcp/poisson
BENCH = dict(rows=12000, clients=12, workload="map_heavy",
             scenario="bursty_tt", impl=None)
BENCH_SIZES = (0, FLEET)
OPEN_CONFIGS = ("inproc_bursty", "inproc_poisson", "tcp_poisson")
# benchmarks/scenario_search.py --smoke
SEARCH_SMOKE = dict(budget=8, seeds=1, fleet_size=20, scenario="baseline",
                    workload="smoke", executor="serial",
                    check_invariants=True, min_samples=40, max_train=2000)
# obs: benchmarks/obs_overhead.py's paired-median CPU-time estimator and its
# gate (a 5 % budget, passed if any of 3 attempts lands inside it), on the
# 1000-node ATLAS run without invariant checking: 31 off/on pairs per attempt
# for the gated NDJSON sink, 3 for the live sink (recorded only).  On the
# card's machine a pair's delta spreads ~9 % of the run (on CPU time and on
# the wall clock alike) around a sink cost of ~3-4 %, so the median of the
# benchmark's 9 pairs strays past the budget in about a third of attempts
OBS_BUDGET = 0.05
OBS_ATTEMPTS = 3
OBS_PAIRS = {"ndjson": 31, "live_tcp": 3}

# training: launch/train.py's default global batch and sequence; the train
# steps run at full width (stablelm-1.6b 8 steps, the others 3 or 2:
# TRAIN_STEPS, cut for time), at full depth but where TRAIN_DEPTH cuts it:
# deepseek-moe-16b to 1 dense and 3 MoE layers (2.3 B parameters at ~20
# bytes each inside a step, ~45 GB; all 28 layers would be ~330 GB),
# zamba2-1.2b and whisper-large-v3 to about half; the kernels' training
# shapes are those steps' microbatches, and the vlm's cross-attention at
# llama-3.2-vision-90b's (accum 16: one sequence on 1024 media tokens),
# which the card cannot train whole, and stablelm-12b's head geometry (32 heads on 8, head_dim
# 160) at its microbatch (accum 8: 2 of the 16 sequences):
# (B, S, Skv, H, Hkv, D, causal, window) for attention,
# (B, S, H, Dh) for rwkv6, (B, S, H, P, N) for mamba2
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_ARCHS = ("stablelm-1.6b", "rwkv6-1.6b", "zamba2-1.2b",
               "deepseek-moe-16b", "whisper-large-v3")
TRAIN_PHASE = {"stablelm-1.6b": "train_step",
               "rwkv6-1.6b": "train_step_rwkv6",
               "zamba2-1.2b": "train_step_zamba2",
               "deepseek-moe-16b": "train_step_moe",
               "whisper-large-v3": "train_step_whisper"}
TRAIN_BATCH, TRAIN_SEQ = 16, 256
# zamba2-1.2b and whisper-large-v3 (6-11 s a step) cut from 3 steps to 2
# when an H100 run of the whole script passed its 1,200 s limit
TRAIN_STEPS = {"stablelm-1.6b": 8, "rwkv6-1.6b": 3, "zamba2-1.2b": 2,
               "deepseek-moe-16b": 3, "whisper-large-v3": 2}
# zamba2-1.2b (three periods of 6) and whisper-large-v3 (16 encoder and 16
# decoder layers) cut to about half when an H100 run of the whole script
# passed its 1,200 s limit (their steps took 6.0-11.1 s whole)
TRAIN_DEPTH = {"deepseek-moe-16b": 4, "zamba2-1.2b": 18,
               "whisper-large-v3": 16}
FAN_IN_FIXED = ("whisper-large-v3",)
TRAIN_FLASH_CASES = {"stablelm": (8, 256, 256, 32, 32, 64, True, 0),
                     "zamba2": (2, 256, 256, 32, 32, 64, True, 4096),
                     "vlm_cross": (1, 256, 1024, 64, 8, 128, False, 0),
                     "whisper_encoder": (2, 1500, 1500, 20, 20, 64, False,
                                         0),
                     "whisper_cross": (2, 256, 1500, 20, 20, 64, False, 0),
                     "stablelm12b": (2, 256, 256, 32, 8, 160, True, 0)}
# train_vlm: the smoke-reduced llama-3.2-vision-90b in bf16 with its gates
# opened, at the full config's accum_steps, with bf16 and with float32
# media (the data stream's default dtype)
TRAIN_VLM = "llama-3.2-vision-90b"
TRAIN_VLM_MEDIA = ("bfloat16", "float32")
# compression: a gradient-sized float32 and bf16 input, not a multiple of
# the block
COMPRESS_NUMEL = (1 << 24) + 77
TRAIN_RWKV = (8, 256, 32, 64)
TRAIN_SSD = (2, 256, 64, 64, 64)
# a gradient through the kernel's forward against autograd through the
# plain version: both backward passes differentiate the plain function in
# float32 and round once to bf16, but from forward values (the scans'
# chunk states, attention's recomputed softmax) that differ by the kernel's
# rounding, so each gradient is held to 2e-2 of its largest magnitude (bf16
# carries 8 significant bits: one rounding is within 2^-8 of the value)
TRAIN_GRAD_TOL = 2e-2
# the first step's loss through the kernels against the plain versions:
# the bf16 forward differs by the kernels' rounding in every layer
TRAIN_LOSS_RTOL = 5e-3
# the weights a partitioned train step updates, against the unpartitioned
# step's: rtol TRAIN_LOSS_RTOL and this atol (tests/test_sharding.py's pair)
TRAIN_PARAM_ATOL = 5e-4
# the first-step gradient norm cut to these depths (the audio family:
# this many encoder and decoder layers each), from two inits
# (_grad_norms_by_init)
WITNESS_DEPTHS = {"stablelm-1.6b": (2, 4, 8, 16, 24),
                  "whisper-large-v3": (1, 8, 16)}
# the archs whose train_step runs from the reference's draw with its
# attention projections at their full fan-in (_fan_in_d_model): from the
# reference's own init whisper-large-v3's first gradient norm is ~1e27 at
# full depth, whose square overflows float32 in AdamW's clip
# train_elastic: launch/train.py's flags for the phase; the depth cut to
# 4 of 24 layers when an H100 run of the script passed 1,200 s (at full
# depth each checkpoint is 16.4 GB: two saves of ~24 s and four restores
# of ~10 s made the phase 115 s)
ELASTIC = dict(steps=8, checkpoint_every=8, layers=4)
# dryrun: the grid of launch/dryrun.py on pod16x16, DRYRUN_JOBS cells at a
# time in spawned processes, traced while the training phases run;
# dryrun_cells: these cells on one card (h100x1), each after its own dry
# run, whole where that run's arguments plus temporaries fit the card's 80
# GB, else at the largest power-of-two global batch that fits
DRYRUN_JOBS = 4
DRYRUN_CELLS = (("zamba2-1.2b", "long_500k"), ("zamba2-1.2b", "decode_32k"),
                ("rwkv6-1.6b", "prefill_32k"), ("stablelm-1.6b", "train_4k"))
# the dry run's peak (arguments + temporaries) against the card's
# max_memory_allocated: the allocator rounds each block up, the cuBLAS
# workspace and the autograd engine's buffers are not counted
DRYRUN_PEAK_TOL = 0.25
# examples: the five examples/torch_*.py on the card (their default
# device), each a process of its own, all five at once, at the arguments of
# tests/test_torch_examples.py (hadoop_sim at --seeds 1 on the paper's
# workload, fleet_sweep and serve_atlas at their defaults); the line each
# must print
EXAMPLES = {"torch_quickstart": ("--steps", "6", "--d-model", "64",
                                 "--layers", "1", "--vocab", "256",
                                 "--hosts", "2"),
            "torch_hadoop_sim": ("--seeds", "1"),
            "torch_fleet_sweep": (),
            "torch_serve_atlas": (),
            "torch_chaos_train": ("--steps", "6", "--hosts", "2")}
EXAMPLE_MARK = {"torch_quickstart": "loss: ",
                "torch_hadoop_sim": "== paper claims vs this reproduction",
                "torch_fleet_sweep": "device=cuda",
                "torch_serve_atlas": "tok/s on CUDA",
                "torch_chaos_train": "final_loss"}
EXAMPLE_TIMEOUT_S = 300

# sharded: the partial mode on a cache cut along its sequence into
# SHARD_SLICES slices (a model axis of 1, 2 or 4): ((B, Smax, H, Hkv, D),
# kv_len).  nemo's serving cache and stablelm-12b's head_dim at ragged
# lengths (1 leaves every slice but the first empty); zamba2 decode_32k's
# shared-attention window cache, the one the sharded decode cell runs, at
# that cell's lengths (pos 32767 fills the 4096-row window) and with its
# one slice on h100x1 the kernels line's shape.  Each with and without a
# window (256 empties the first slices of the long sequences); then the
# partitioned steps of SHARD_CELLS on h100x1
SHARD_SLICES = (1, 2, 4)
SHARD_LENS = (1088, 700, 1, 300)
SHARD_DECODE_CASES = {"nemo": ((4, 1088, 32, 8, 128), SHARD_LENS),
                      "stablelm12b": ((4, 1088, 32, 8, 160), SHARD_LENS),
                      "zamba2": ((128, 4096, 32, 32, 64), (4096,) * 128)}
SHARD_MAIN = ("zamba2", 1)
SHARD_WINDOWS = (0, 256)
SHARD_CELLS = (("stablelm-1.6b", "train_4k", 8),
               ("stablelm-1.6b", "prefill_32k", 2),
               ("zamba2-1.2b", "decode_32k", None))
# the train cell's leaves whose first moment (the step's gradient) and
# updated weights are held against the unpartitioned step's
SHARD_TRAIN_LEAVES = (("embed", "embedding"), ("blocks", "attn", "wq"))

RECORDS: list = []
_T0 = time.perf_counter()


def emit(record: dict):
    """Keep and print one JSON record, stamped with the seconds since the
    script started ("at_s")."""
    record["at_s"] = time.perf_counter() - _T0
    RECORDS.append(record)
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


# ---------------------------------------------------------------- phases

def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "python": sys.version.split()[0]})
    return smi


def phase_build() -> dict:
    """Build the library; each attention, forest and scan kernel's
    registers and spills from the ptxas report (fails unless all 18 forest,
    every rwkv6 and every attention instance, head_dim 160's included, are
    there, or if the bf16 flash instance at head_dim 160 spills), and the
    tensor-core instructions
    in the bf16 flash and SSD kernels' SASS (fails if cuobjdump is there
    and finds none in either)."""
    from repro_torch.kernels import _build, attention
    from repro_torch.kernels import recurrence as rk
    t0 = time.perf_counter()
    lib = _build.load()
    seconds = time.perf_counter() - t0
    all_usage = _build.ptxas_usage(_build.ptxas_report().read_text())

    def kernels_of(kinds):
        return {m: u for m, u in all_usage.items()
                if any(k in m for k in kinds)}
    usage, forest_usage = kernels_of(ATTN_KERNELS), kernels_of(FOREST_KERNELS)
    scan_usage = kernels_of(SCAN_KERNELS)
    check(len(forest_usage) == 18, f"18 forest kernel instances (D = 1..8 "
          f"and run-time D, two kernels), ptxas saw {len(forest_usage)}")
    n_rwkv = 2 * len(rk.RWKV6_INSTANCE)
    seen = sum("rwkv6_scan_kernel" in m for m in scan_usage)
    check(seen == n_rwkv, f"{n_rwkv} rwkv6 instances (two dtypes), ptxas "
          f"saw {seen}")
    # flash: two kernels per head dim; decode: two dtypes x three group
    # buckets per head dim
    n_attn = len(attention.HEAD_DIMS) * (2 + 2 * 3)
    check(len(usage) == n_attn, f"{n_attn} attention kernel instances, "
          f"ptxas saw {len(usage)}")
    # the bf16 flash instance at head_dim 160 is compiled for one block an
    # SM so that its 80 accumulator floats a thread stay in registers
    d160 = {m: u for m, u in usage.items()
            if "flash_attention_mma_kernelILi160E" in m}
    check(len(d160) == 1 and not any(u.get("spill_stores", 0)
                                     for u in d160.values()),
          f"the bf16 flash kernel at head_dim 160 spills: {d160}")
    tc = _build.tensor_core_instructions()
    names = _build.demangle(set(usage) | set(forest_usage) | set(scan_usage)
                            | set(tc or {}))
    record = {"phase": "build", "seconds": seconds,
              "library": str(pathlib.Path(lib._name).relative_to(ROOT)),
              "attention_kernels": {names[m]: u for m, u in usage.items()},
              "forest_kernels": {names[m]: u
                                 for m, u in forest_usage.items()},
              "scan_kernels": {names[m]: u for m, u in scan_usage.items()}}
    if tc is None:
        record["tensor_core_instructions"] = "no cuobjdump in the toolkit"
    else:
        record["tensor_core_instructions"] = {
            names[m]: n for m, n in tc.items()
            if any(k in m for k in ATTN_KERNELS + SCAN_KERNELS)}
        for kernel in ("flash_attention_mma_kernel",
                       "mamba2_ssd_chunked_kernel"):
            counts = {names[m]: n for m, n in tc.items() if kernel in m}
            check(bool(counts) and all(counts.values()),
                  f"no tensor-core instruction in {kernel}'s SASS "
                  f"({counts})")
    emit(record)
    return record


def _data(n, f, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.rand(n) > 0.8).astype(np.float32)
    return X, y


def _time_ms(torch, fn, n=N_TIMED, warmup=10) -> float:
    """Median CUDA-event time of one call over n calls, after warm-up; each
    event pair brackets one call, host-side launch cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _forest_fixtures(torch, dev):
    """A Tree (T=1, D=6), two R.F.s (T=24, D=5) fitted on the card, and
    4096 rows of N_FEATURES random features."""
    from repro_torch.cluster.telemetry import N_FEATURES
    from repro_torch.ml import forest
    from repro_torch.ml.models import Tree
    Xt, yt = _data(2000, N_FEATURES, 20)
    tree = Tree(device=dev).fit(Xt, yt).params
    check(tree.feat_idx.shape == (1, 6), "Tree is T=1, D=6")
    rf = [forest.fit_oblivious_forest(Xt, t, n_trees=24, depth=5, seed=s,
                                      device=dev)
          for s, t in ((0, yt), (1, 1 - yt))]
    rows = np.random.RandomState(21).rand(4096, N_FEATURES).astype(np.float32)
    return tree, rf, rows


def _per_call_us(torch, fn, reps=20, inner=50) -> float:
    """Mean host time of one call of fn (perf_counter), over reps batches
    of inner calls; the card is synchronised between batches, outside the
    clock, so that queued work never holds an enqueue back."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / (reps * inner)


def forest_host_split(torch, dev, params, X) -> dict:
    """Host microseconds per call of each step of a scoring decision at
    X's rows, by perf_counter: the launcher's parts (checks, output, library
    lookup, device switch, stream lookup, the ctypes launch, the counter),
    the whole ``ops.forest_infer``, the host path's parts around it and the
    whole ``forest_predict`` against the numpy mirror.  Steps that only one
    version of the code has are timed where they exist, so the function
    also times the code before the staged path."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import forest as fk
    from repro_torch.ml import forest
    B, F = X.shape
    x = torch.from_numpy(X).to(dev)
    fi, th, lv = params.on(dev)
    T, D = fi.shape
    out = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _build.load()
    index = x.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the entry point takes pinned host buffers (none here) since the
    # staged host path; before it, it ended with the stream
    no_copies = (None, 0, None) if len(
        lib.forest_infer_launch.argtypes) == 13 else ()

    def device_context():
        with torch.cuda.device(dev):
            pass

    def model_checks():
        fk._check(fi, "feat_idx", torch.int32, (T, D), x.device)
        fk._check(th, "thresholds", torch.float32, (T, D), x.device)
        fk._check(lv, "leaves", torch.float32, (T, 1 << D), x.device)

    steps = {
        "check_x": lambda: fk._check_x(x),
        "check_model_tensors": model_checks,
        "torch_empty": lambda: torch.empty(B, dtype=torch.float32,
                                           device=dev),
        "build_load": _build.load,
        "device_context": device_context,
        "current_device": torch.cuda.current_device,
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
        "ctypes_launch": lambda: lib.forest_infer_launch(
            x.data_ptr(), B, F, fi.data_ptr(), th.data_ptr(), lv.data_ptr(),
            T, D, out.data_ptr(), *no_copies, stream),
        "launch_count": lambda: ops._count("forest_infer"),
        "ops_forest_infer": lambda: ops.forest_infer(x, fi, th, lv),
        "feat_idx_max": lambda: int(params.feat_idx.max()),
        "params_on": lambda: params.on(dev),
        "rows_h2d_pageable": lambda: torch.from_numpy(X).to(dev),
        "out_d2h_sync": lambda: out.cpu().numpy(),
        "forest_predict": lambda: forest.forest_predict(params, X,
                                                        device=dev),
        "numpy_mirror": lambda: forest.forest_predict_np(params, X),
    }
    if hasattr(fk, "_check_once"):
        named = (("feat_idx", fi), ("thresholds", th), ("leaves", lv))
        steps["check_model_once"] = lambda: fk._check_once(
            x, named, model_checks)
    if hasattr(forest, "_staging"):
        staged = forest._staging(dev)
        views = staged.views_for(B, F)
        host_words, host_out = views.host

        def d2h_pinned_sync():
            host_out.copy_(views.out, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
        steps.update({
            "check_width_cached": lambda: forest._check_width(params, F),
            "staging_views": lambda: staged.views_for(B, F),
            "fill_pinned": lambda: np.copyto(views.rows, X),
            "rows_h2d_pinned": lambda: views.x.view(-1).copy_(
                host_words, non_blocking=True),
            "out_d2h_pinned_sync": d2h_pinned_sync,
            "ops_forest_infer_staged": lambda: ops.forest_infer(
                views.x, fi, th, lv, out=views.out, host=views.host)})
    split = {name: _per_call_us(torch, fn) for name, fn in steps.items()}
    torch.cuda.synchronize()
    return {"rows": B, "us_per_call": split}


def phase_kernels(torch, dev):
    """Both forest kernels against their plain versions and the numpy
    mirror, bitwise, on the grouped-inference cases, a Tree and R.F. at
    TIMED_ROWS and the fat flush; then their times at TIMED_ROWS (see
    forest_timing) and the host split of a 13-row decision."""
    from repro_torch.ml import forest

    # the grouped-inference test fixtures, refit on the card
    X, y = _data(300, 12, 0)
    fx = {"a": forest.fit_oblivious_forest(X, y, n_trees=24, depth=5,
                                           seed=0, device=dev),
          "b": forest.fit_oblivious_forest(X, 1 - y, n_trees=24, depth=5,
                                           seed=1, device=dev),
          "c": forest.fit_oblivious_forest(X, y, n_trees=8, depth=3, seed=2,
                                           device=dev),
          "d": forest.fit_oblivious_forest(X, 1 - y, n_trees=16, depth=4,
                                           seed=3, device=dev)}
    cases = []
    for sizes in [(1,), (1, 1, 1), (7, 33), (1, 64, 2), (65, 1, 5, 12)]:
        cases.append([("ab"[i % 2], b) for i, b in enumerate(sizes)])
    cases += [[("a", 9), ("c", 31), ("d", 1), ("a", 59), ("c", 3)],
              [("a", 50), ("a", 1)], [("a", 5), ("b", 25), ("a", 30),
                                      ("b", 1)]]
    for i, case in enumerate(cases):
        Xq = _data(300, 12, 4 + i)[0]
        at, groups = 0, []
        for name, b in case:
            groups.append((fx[name], Xq[at:at + b]))
            at += b
        # the flush's own path: one model per segment, rows contiguous
        outs, passes = forest.forest_predict_grouped(groups, device=dev)
        check(passes == 1, "one fused pass per flush")
        for (p, r), o in zip(groups, outs):
            check(np.array_equal(o, forest.forest_predict_np(p, r)),
                  "forest_predict_grouped != numpy mirror")
        # the kernel itself, one segment per group (repeats included)
        _grouped_case(torch, dev, groups)

    # a Tree (T=1, D=6) and the fat flush (M=2, R=4096, T=24, D=5)
    tree, rf, rows = _forest_fixtures(torch, dev)
    for B in TIMED_ROWS:
        _single_case(torch, dev, tree, rows[:B])
        _single_case(torch, dev, rf[0], rows[:B])
    _grouped_case(torch, dev, [(rf[0], rows[:2048]), (rf[1], rows[2048:])])
    torch.cuda.synchronize()

    timing = {k: {} for k in FOREST_KERNELS}
    for B in TIMED_ROWS:
        for k, rec in forest_timing(torch, dev, rf, rows[:B]).items():
            timing[k][B] = rec
    split = forest_host_split(torch, dev, rf[0], rows[:13])
    emit({"phase": "kernels", "host_split": split})
    return timing


FOREST_HELD = {"cases": dict.fromkeys(FOREST_KERNELS, 0),
               "max_abs_err": dict.fromkeys(FOREST_KERNELS, 0.0)}


def _hold_forest(torch, kernel, got, plain, numpy_want):
    check(torch.equal(got, plain), f"{kernel}: kernel != plain version")
    check(np.array_equal(got.cpu().numpy(), numpy_want),
          f"{kernel}: kernel != numpy mirror")
    if got.numel():
        FOREST_HELD["max_abs_err"][kernel] = max(
            FOREST_HELD["max_abs_err"][kernel],
            float((got - plain).abs().max()))
    FOREST_HELD["cases"][kernel] += 1


def _grouped_case(torch, dev, groups):
    """Hold the grouped kernel on ``groups`` (one segment each); returns
    its arguments."""
    from repro_torch.kernels import ops
    from repro_torch.ml import forest
    packed = forest.pack_forests([p for p, _ in groups])
    x = np.concatenate([r for _, r in groups]).astype(np.float32)
    offsets = np.zeros(len(groups) + 1, np.int32)
    np.cumsum([r.shape[0] for _, r in groups], out=offsets[1:])
    args = (torch.from_numpy(x).to(dev),
            torch.from_numpy(offsets).to(dev), *packed.on(dev))
    got = ops.forest_infer_grouped(*args, impl="cuda")
    plain = ops.forest_infer_grouped(*args, impl="torch")
    want = np.concatenate([forest.forest_predict_np(p, r)
                           for p, r in groups])
    _hold_forest(torch, "forest_infer_grouped", got, plain, want)
    return args


def _single_case(torch, dev, params, x):
    from repro_torch.kernels import ops
    from repro_torch.ml import forest
    args = (torch.from_numpy(x).to(dev), *params.on(dev))
    _hold_forest(torch, "forest_infer", ops.forest_infer(*args, impl="cuda"),
                 ops.forest_infer(*args, impl="torch"),
                 forest.forest_predict_np(params, x))
    return args


def forest_timing(torch, dev, rf, rows) -> dict:
    """Both forest kernels at len(rows) rows of R.F. (T=24, D=5; the
    grouped kernel with M=2, the rows split in halves), held bitwise first:
    the median CUDA-event time of a call (host wrapper inside), the
    kernel's own device time under torch.profiler, the plain version's
    time, the bound, and the device and CUDA-event times of one trivial
    launch (torch.zeros(1)) as the launch floor.  Then the whole per-decision
    call (rows from the host to the card and back) against the numpy mirror
    on the host, by perf_counter.  Emits one record and returns
    {kernel: record}."""
    from repro_torch.launch import cost
    from repro_torch.cluster.telemetry import N_FEATURES
    from repro_torch.kernels import ops
    from repro_torch.ml import forest
    B = rows.shape[0]
    half = B // 2
    sargs = _single_case(torch, dev, rf[0], rows)
    gargs = _grouped_case(torch, dev, [(rf[0], rows[:half]),
                                       (rf[1], rows[half:])])
    floor = {"device_ms": _kernel_device_ms(
        torch, lambda: torch.zeros(1, device=dev), ""),
        "ms": _time_ms(torch, lambda: torch.zeros(1, device=dev))}
    t = {}
    for kernel, args, fn, M in (
            ("forest_infer", sargs, ops.forest_infer, 1),
            ("forest_infer_grouped", gargs, ops.forest_infer_grouped, 2)):
        bms, by = cost.bound_ms(*cost.forest_work(B, N_FEATURES, 24, 5, M,
                                                  24 * B))
        t[kernel] = {
            "ms": _time_ms(torch, lambda: fn(*args, impl="cuda")),
            "device_ms": _kernel_device_ms(
                torch, lambda: fn(*args, impl="cuda"), kernel + "_kernel"),
            "plain_ms": _time_ms(torch, lambda: fn(*args, impl="torch")),
            "bound_ms": bms, "bound_by": by, "launch_floor": floor}
    # the whole per-decision call: host rows -> card -> kernel -> host
    groups = [(rf[0], rows[:half]), (rf[1], rows[half:])]
    calls = {
        "forest_predict_call_ms": lambda: forest.forest_predict(
            rf[0], rows, device=dev),
        "numpy_mirror_host_ms": lambda: forest.forest_predict_np(rf[0], rows),
        "forest_predict_grouped_call_ms": lambda: (
            forest.forest_predict_grouped(groups, device=dev)),
        "grouped_numpy_host_ms": lambda: forest.forest_predict_grouped(
            groups, impl="numpy")}
    host = {name: _per_call_us(torch, fn, reps=10, inner=20) / 1e3
            for name, fn in calls.items()}
    emit({"phase": "kernels", "rows": B, **t, **host})
    return t


def phase_flush_kernels(torch, dev, rows_per_flush: int) -> dict:
    """Both forest kernels at the brokered run's mean flush size, as
    forest_timing (the grouped kernel's main-path shape)."""
    _, rf, rows = _forest_fixtures(torch, dev)
    return forest_timing(torch, dev, rf, rows[:rows_per_flush])


def _slice_config(fleet_size, device, chaos=None):
    from repro_torch.cluster import ChaosConfig, WorkloadConfig
    from repro_torch.cluster.experiment import ExperimentConfig
    # the JAX package's "map_heavy" workload shape and, by default, its
    # "baseline" scenario (repro/cluster/scenarios.py), as values
    return ExperimentConfig(
        workload=WorkloadConfig(n_single=64, n_chains=4, maps_range=(10, 24),
                                reduces_range=(1, 4)),
        chaos=ChaosConfig(**(chaos or {})), seed=0, check_invariants=True,
        fleet_size=fleet_size, device=device)


def _predictor_kw(cfg):
    return dict(algo=cfg.algo, seed=cfg.seed, min_samples=cfg.min_samples,
                max_train=cfg.max_train)


def _same_params(a, b) -> bool:
    for kind in ("map", "reduce"):
        ma, mb = a.model_for_kind(kind), b.model_for_kind(kind)
        if (ma is None) != (mb is None):
            return False
        if ma is not None and not all(
                np.array_equal(getattr(ma.params, f), getattr(mb.params, f))
                for f in ("feat_idx", "thresholds", "leaves")):
            return False
    return True


def phase_fit(torch, dev):
    from repro_torch.cluster.experiment import run_baseline
    from repro_torch.core.predictor import TaskPredictor
    cfg = _slice_config(FLEET, None)
    t0 = time.perf_counter()
    base, trace, _ = run_baseline("fifo", cfg)
    t_base = time.perf_counter() - t0
    check(base["invariant_violations"] == 0, "baseline invariant violations")
    data = trace.datasets()
    fitted, secs = {}, {}
    for where in (dev, "cpu"):
        p = TaskPredictor(**_predictor_kw(cfg), device=where)
        t0 = time.perf_counter()
        check(p.fit_datasets(*data), "predictor fitted")
        torch.cuda.synchronize()
        secs[str(where)] = time.perf_counter() - t0
        fitted[str(where)] = p
    gpu, cpu = fitted[str(dev)], fitted["cpu"]
    check(gpu.map_model.params.feat_idx.shape == (24, 5), "R.F. is T=24, D=5")
    check(_same_params(gpu, cpu), "card-fitted != CPU-fitted parameters")
    emit({"phase": "fit", "fleet_size": FLEET, "baseline_run_s": t_base,
          "map_rows": int(data[0][0].shape[0]),
          "reduce_rows": int(data[1][0].shape[0]),
          "fit_s": secs, "params_equal": True})
    return cfg, base, gpu, data


@contextlib.contextmanager
def _served(log: list):
    """Record every (params, rows, probabilities) a forest-family predictor
    serves while the block runs: what ``TaskPredictor.predict_batch``
    returns and what ``BrokerPredictor._flush`` hands to its memo.  The
    rows and probabilities are copied, since the broker reuses its
    buffers."""
    from repro_torch.core.predictor import TaskPredictor, forest_family_params
    from repro_torch.online.broker import BrokerPredictor

    def keep(model, X, out):
        params = forest_family_params(model)
        if params is not None and len(X):
            log.append((params, np.array(X, np.float32), np.array(out)))

    predict_batch, flush = TaskPredictor.predict_batch, BrokerPredictor._flush

    def tapped_predict_batch(self, kind, X):
        out = predict_batch(self, kind, X)
        keep(self.model_for_kind(kind), X, out)
        return out

    def tapped_flush(self, groups):
        outs = flush(self, groups)
        for (model, X), out in zip(groups, outs):
            keep(model, X, out)
        return outs

    TaskPredictor.predict_batch = tapped_predict_batch
    BrokerPredictor._flush = tapped_flush
    try:
        yield log
    finally:
        TaskPredictor.predict_batch = predict_batch
        BrokerPredictor._flush = flush


def _check_served(log: list, what: str) -> dict:
    """Every served probability against the clipped numpy mirror on the same
    rows and parameters, one mirror pass per distinct parameter set."""
    from repro_torch.ml.forest import forest_predict_np
    by_params: dict = {}
    for params, X, out in log:
        by_params.setdefault(id(params), (params, [], []))
        by_params[id(params)][1].append(X)
        by_params[id(params)][2].append(out)
    rows, below, lowest = 0, 0, 1.0
    for params, xs, outs in by_params.values():
        got = np.concatenate(outs)
        want = np.clip(forest_predict_np(params, np.concatenate(xs)),
                       0.0, 1.0).astype(np.float32)
        check(got.dtype == np.float32 and np.array_equal(got, want),
              f"{what}: a served probability != numpy mirror")
        rows += got.size
        below += int((got < 0.5).sum())
        lowest = min(lowest, float(got.min()))
    check(rows > 0, f"{what}: no probability served")
    return {"calls": len(log), "rows": rows, "models": len(by_params),
            "rows_below_half": below, "min_p": lowest}


def phase_slice(torch, dev, cfg, base_metrics, trained):
    """The §5 protocol, then the same ATLAS run behind the BrokerPredictor.
    The launch counts are zeroed before each run and read after it: the
    scalar path (compare) must launch forest_infer and the brokered run
    forest_infer_grouped, exactly SCALAR_LAUNCHES and BROKER_LAUNCHES
    times.  Returns the launches, the brokered run's mean rows per flush
    and compare's result."""
    from repro_torch.cluster.experiment import compare, run_scheduler
    from repro_torch.kernels import ops
    from repro_torch.online.broker import BrokerPredictor
    broker = BrokerPredictor(**_predictor_kw(cfg), device=dev)
    broker.load_snapshot(trained.snapshot())

    with _served([]) as scalar_log:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = compare("fifo", cfg)
        torch.cuda.synchronize()
        t_compare = time.perf_counter() - t0
        launches_compare = ops.launch_counts()
    with _served([]) as broker_log:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        brokered, _, _ = run_scheduler("atlas-fifo", cfg, broker)
        torch.cuda.synchronize()
        t_broker = time.perf_counter() - t0
        launches_broker = ops.launch_counts()
    check(launches_compare["forest_infer"] == SCALAR_LAUNCHES,
          f"compare launched forest_infer {launches_compare['forest_infer']}"
          f" times, not {SCALAR_LAUNCHES}")
    check(launches_broker["forest_infer_grouped"] == BROKER_LAUNCHES,
          f"the brokered run launched forest_infer_grouped "
          f"{launches_broker['forest_infer_grouped']} times, not "
          f"{BROKER_LAUNCHES}")

    base, atlas = result["base"], result["atlas"]
    for name, m in (("base", base), ("atlas", atlas), ("broker", brokered)):
        check(m["invariant_violations"] == 0, f"{name} invariant violations")
        check(m["invariant_checks"] > 0, f"{name} ran no invariant checks")
    check({k: v for k, v in base.items() if k not in (
        "job_exec_time_matched", "long_job_exec_time")} == base_metrics,
        "compare's baseline differs from the fit phase's")
    # run_scheduler adds sched_stats; compare adds the matched-job times
    extra = {"sched_stats", "job_exec_time_matched", "long_job_exec_time"}
    check(set(brokered) ^ set(atlas) <= extra, "metric keys differ")
    check({k: v for k, v in brokered.items() if k not in extra}
          == {k: v for k, v in atlas.items() if k not in extra},
          "BrokerPredictor run != TaskPredictor run")
    check(atlas["atlas"]["predictions"] > 0, "ATLAS made no predictions")
    t0 = time.perf_counter()
    served = {"scalar": _check_served(scalar_log, "compare"),
              "broker": _check_served(broker_log, "brokered run")}
    emit({"phase": "slice", "fleet_size": FLEET, "compare_s": t_compare,
          "broker_run_s": t_broker, "launches_compare": launches_compare,
          "launches_broker": launches_broker,
          "served_equal_numpy_mirror": served,
          "served_check_s": time.perf_counter() - t0,
          "broker": {"dispatches": broker.n_dispatches,
                     "rows": broker.n_rows_scored,
                     "memo_hits": broker.n_memo_hits,
                     "demand_calls": broker.n_demand_calls},
          "atlas": atlas["atlas"], "deltas": result["deltas"],
          "tasks_total": atlas["tasks_total"],
          "invariant_checks": atlas["invariant_checks"]})
    launches = {"forest_infer": launches_compare["forest_infer"],
                "forest_infer_grouped": launches_broker["forest_infer_grouped"]}
    return (launches, round(served["broker"]["rows"] / BROKER_LAUNCHES),
            result)


def phase_parity(torch, dev):
    """At 100 nodes, under the baseline chaos and under kitchen_sink: one
    CPU-fitted predictor's parameters scored on the card, on the CPU and
    behind the BrokerPredictor on the card give equal whole-run metrics.
    Under kitchen_sink ATLAS must predict failures, so the decisions do
    depend on the scores' values."""
    from repro_torch.cluster.experiment import run_baseline, run_scheduler
    from repro_torch.core.predictor import TaskPredictor
    from repro_torch.online.broker import BrokerPredictor
    out = {}
    for scenario, chaos in (("baseline", None), ("kitchen_sink", KITCHEN_SINK)):
        cfg = _slice_config(PARITY_FLEET, None, chaos)
        _, trace, _ = run_baseline("fifo", cfg)
        trained = TaskPredictor(**_predictor_kw(cfg), device="cpu")
        check(trained.fit(trace), f"{scenario}: parity predictor fitted")
        metrics, secs = {}, {}
        for run, cls, where in (("cuda", TaskPredictor, dev),
                                ("cpu", TaskPredictor, "cpu"),
                                ("cuda_broker", BrokerPredictor, dev)):
            p = cls(**_predictor_kw(cfg), device=where)
            p.load_snapshot(trained.snapshot())
            t0 = time.perf_counter()
            metrics[run], _, _ = run_scheduler(
                "atlas-fifo", dataclasses.replace(cfg, device=where), p)
            secs[run] = time.perf_counter() - t0
            check(metrics[run]["invariant_violations"] == 0,
                  f"{scenario} {run}: invariant violations")
        check(metrics["cuda"] == metrics["cpu"],
              f"{scenario}: CUDA run != CPU run")
        check(metrics["cuda_broker"] == metrics["cuda"],
              f"{scenario}: BrokerPredictor run != TaskPredictor run")
        atlas = metrics["cpu"]["atlas"]
        if chaos is not None:
            check(atlas["predicted_fail"] > 0,
                  f"{scenario}: ATLAS predicted no failure")
        out[scenario] = {"run_s": secs, "metrics_equal": True,
                         **{k: atlas[k] for k in (
                             "predictions", "predicted_fail", "relocations",
                             "penalties", "model_fits")}}
    emit({"phase": "parity", "fleet_size": PARITY_FLEET, **out})


def _device_time(prof) -> dict:
    """Device time by kind from a torch.profiler trace's raw events (as
    _serve_trace reads them): {kind: [n, us]}."""
    from torch.autograd import DeviceType
    kinds: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        kind = next((k for k in ("forest_infer_grouped", "forest_infer")
                     if k in name), "memcpy" if "emcpy" in name else "other")
        n_us = kinds.setdefault(kind, [0, 0.0])
        n_us[0] += 1
        n_us[1] += e.duration_ns() / 1e3
    return kinds


def phase_trace(torch, dev, cfg, trained):
    """The 1000-node ATLAS run again, scalar and brokered, under
    torch.profiler: the card's busy and idle share, and each kernel's own
    device time at the main path's shapes.  Profiling slows the host, so
    the idle share is an upper bound; the unprofiled walls are in slice."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cluster.experiment import run_scheduler
    from repro_torch.core.predictor import TaskPredictor
    from repro_torch.kernels import ops
    from repro_torch.online.broker import BrokerPredictor
    runs = {}
    for name, cls in (("scalar", TaskPredictor), ("broker", BrokerPredictor)):
        pred = cls(**_predictor_kw(cfg), device=dev)
        pred.load_snapshot(trained.snapshot())
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_scheduler("atlas-fifo", cfg, pred)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kinds = _device_time(prof)
        busy_s = sum(us for _, us in kinds.values()) / 1e6
        runs[name] = {
            "wall_s": wall, "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall if kinds else None,
            "device_us": {k: {"n": n, "total_us": us, "mean_us": us / n}
                          for k, (n, us) in kinds.items()},
            "launches": ops.launch_counts()}
    emit({"phase": "trace", "fleet_size": FLEET, **runs})
    # each kernel's own mean device time on the main path (None if the
    # profiler saw no device activity)
    return {k: runs[run]["device_us"].get(k, {}).get("mean_us")
            for k, run in (("forest_infer", "scalar"),
                           ("forest_infer_grouped", "broker"))}


# ---------------------------------------------------------------- serving

def _kernel_device_ms(torch, fn, kind: str, n=DEVICE_TIMED,
                      tries=3) -> float | None:
    """The mean device time of the kernels whose name contains ``kind``
    over n calls of fn under torch.profiler (after one warm-up call), per
    call.  Each call launches one such kernel; a trace that holds fewer
    than n of them (late in a long process the profiler can drop device
    events, which would understate the mean) is taken again, up to
    ``tries`` times, and None is returned if none was whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kind in e.name]
        if len(us) >= n:
            return sum(us) / n / 1e3
    return None


def phase_attn_kernels(torch, dev):
    """Each attention kernel against its plain version on the card, in
    float32 and bf16; times at every case by CUDA events: the kernel, the
    plain version and scaled_dot_product_attention on the same work (where
    it computes the same function: no window that hides a key); the
    kernel's own device time under torch.profiler."""
    from repro_torch.launch import cost
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = dict.fromkeys(ATTN_KERNELS, 0.0)
    timing: dict = {k: {} for k in ATTN_KERNELS}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def hold(kernel, case, dtype, got, plain):
        tol = ATTN_TOL[str(dtype).removeprefix("torch.")]
        err = float((got.float() - plain.float()).abs().max())
        ok = torch.allclose(got.float(), plain.float(), rtol=tol, atol=tol)
        check(ok and bool(torch.isfinite(got).all()),
              f"{kernel} {case} {dtype}: kernel != plain version "
              f"(max abs err {err})")
        max_err[kernel] = max(max_err[kernel], err)
        return err

    def sdpa(q, k, v, causal):
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for case, (B, S, Skv, H, Hkv, D, causal, window) in \
                FLASH_CASES.items():
            q = rand((B, S, H, D), dtype)
            k, v = rand((B, Skv, Hkv, D), dtype), rand((B, Skv, Hkv, D), dtype)
            kw = dict(causal=causal, window=window)
            got = ops.flash_attention(q, k, v, impl="cuda", **kw)
            plain = ops.flash_attention(q, k, v, impl="torch", **kw)
            rec = {"max_abs_err": hold("flash_attention", case, dtype, got,
                                       plain)}

            def kernel():
                return ops.flash_attention(q, k, v, impl="cuda", **kw)
            rec["ms"] = _time_ms(torch, kernel)
            rec["device_ms"] = _kernel_device_ms(torch, kernel,
                                                 "flash_attention")
            rec["plain_ms"] = _time_ms(
                torch, lambda: ops.flash_attention(q, k, v, impl="torch",
                                                   **kw), n=5, warmup=1)
            # SDPA's is_causal aligns queries left: the same function only
            # where S == Skv or nothing is masked
            same = (not window or window >= Skv) and (S == Skv or not causal)
            rec["library_ms"] = sdpa(q, k, v, causal) if same else None
            rec["bound_ms"], rec["bound_by"] = cost.bound_ms(
                *cost.flash_work(B, S, Skv, H, Hkv, D, causal, window, dname))
            timing["flash_attention"][f"{case}/{dname}"] = rec
            del q, k, v, got, plain
        for case, (B, Smax, H, Hkv, D, window, lens) in DECODE_CASES.items():
            q = rand((B, 1, H, D), dtype)
            k, v = rand((B, Smax, Hkv, D), dtype), rand((B, Smax, Hkv, D),
                                                        dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = ops.decode_attention(q, k, v, kv_len, window=window,
                                       impl="cuda")
            plain = ops.decode_attention(q, k, v, kv_len, window=window,
                                         impl="torch")
            rec = {"max_abs_err": hold("decode_attention", case, dtype, got,
                                       plain)}

            def kernel():
                return ops.decode_attention(q, k, v, kv_len, window=window,
                                            impl="cuda")
            rec["ms"] = _time_ms(torch, kernel)
            rec["device_ms"] = _kernel_device_ms(torch, kernel,
                                                 "decode_attention")
            rec["plain_ms"] = _time_ms(torch, lambda: ops.decode_attention(
                q, k, v, kv_len, window=window, impl="torch"), n=20)
            same = (not window or window >= Smax) and all(
                n == Smax for n in lens)
            rec["library_ms"] = sdpa(q, k, v, False) if same else None
            rec["bound_ms"], rec["bound_by"] = cost.bound_ms(
                *cost.decode_work(B, Smax, H, Hkv, D, window, lens, dname))
            timing["decode_attention"][f"{case}/{dname}"] = rec
    torch.cuda.synchronize()
    emit({"phase": "attn_kernels", "flash_cases": FLASH_CASES,
          "decode_cases": DECODE_CASES, "timing": timing,
          "max_abs_err": max_err})
    return timing, max_err


@contextlib.contextmanager
def _held_kernels(torch, errs: dict, tols: dict):
    """While the block runs, every call of a kernel named in ``tols`` that
    launches it is also computed by its plain version on the same inputs
    (before the caller sees the result) and each output is held to its
    tolerance, ``tols[name]`` holding one per output (a scan's y, then its
    float32 state).  The largest gap per output goes into ``errs``, the
    state's under ``<name>_state``.  The plain calls are not launches.

    An attention output row where kernel and plain version disagree is
    settled in float64 (``_attention_row_f64``): under the reference's
    init the serving models' softmax is saturated (scores ~10^3), and
    where a row's two best keys nearly tie, the float32 rounding of a
    score in either implementation moves the output by more than the
    bf16 tolerance.  Such a row passes only if every element of the
    kernel's is within the tolerance of the float64 answer; at most
    MAX_DISPUTED_ROWS rows a call, each counted in ``errs``
    (``<name>_disputed_rows``, and the largest gap of kernel and plain
    version to float64 there)."""
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in tols}

    def settle(name, args, kw, o, p, tol):
        """Check the rows of an attention call where o and p disagree
        against float64; returns how many there were."""
        bad = ~torch.isclose(o, p, rtol=tol, atol=tol)
        rows = torch.nonzero(bad.any(-1)).tolist()
        check(len(rows) <= MAX_DISPUTED_ROWS,
              f"{name}: {len(rows)} output rows != the plain version's in "
              f"one call")
        for b, s, h in rows:
            exact = _attention_row_f64(torch, name, args, kw, b, s, h)
            k_err = float((o[b, s, h].double() - exact).abs().max())
            p_err = float((p[b, s, h].double() - exact).abs().max())
            check(bool(torch.allclose(o[b, s, h].double(), exact, rtol=tol,
                                      atol=tol)),
                  f"{name} != its plain version in the model at row "
                  f"{(b, s, h)}, and {k_err} from float64 (the plain "
                  f"version {p_err})")
            for key, err in ((f"{name}_disputed_kernel_vs_f64", k_err),
                             (f"{name}_disputed_plain_vs_f64", p_err)):
                errs[key] = max(errs.get(key, 0.0), err)
        errs[f"{name}_disputed_rows"] = \
            errs.get(f"{name}_disputed_rows", 0) + len(rows)

    def tap(name, fn):
        def call(*args, impl=None, **kw):
            out = fn(*args, impl=impl, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            if impl is None and outs[0].is_cuda:
                plain = fn(*args, impl="torch", **kw)
                plains = plain if isinstance(plain, tuple) else (plain,)
                for i, (o, p, tol) in enumerate(zip(outs, plains,
                                                    tols[name])):
                    key = name if i == 0 else f"{name}_state"
                    o, p = o.float(), p.float()
                    err = float((o - p).abs().max())
                    same = bool(torch.allclose(o, p, rtol=tol, atol=tol))
                    if not same and name in ATTN_KERNELS:
                        settle(name, args, kw, o, p, tol)
                    else:
                        check(same, f"{key} != its plain version in the "
                              f"model (max abs err {err})")
                    errs[key] = max(errs.get(key, 0.0), err)
            return out
        return call

    for name, fn in saved.items():
        setattr(ops, name, tap(name, fn))
    try:
        yield errs
        unheld = sorted(set(tols) - set(errs))
        check(not unheld, f"no call of {unheld} was held to its plain "
              "version")
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _attention_row_f64(torch, name, args, kw, b, s, h):
    """Output row (b, s, h) of the attention call ``name(*args, **kw)``
    (flash_attention: q, k, v; decode_attention: q, k, v, kv_len),
    computed in float64 from the same bf16 or float32 inputs: the keys
    that query sees, their scores, softmax and weighted values."""
    q, k, v = args[:3]
    S, H, D = q.shape[1], q.shape[2], q.shape[3]
    Skv, Hkv = k.shape[1], k.shape[2]
    window = kw.get("window", 0)
    if name == "flash_attention":
        pos = s + Skv - S
        hi = min(Skv, pos + 1) if kw.get("causal", True) else Skv
        lo = max(0, pos - window + 1) if window else 0
    else:
        n = int(args[3][b])
        hi, lo = min(n, Skv), (max(0, n - window) if window else 0)
    hk = h // (H // Hkv)
    keys, vals = k[b, lo:hi, hk].double(), v[b, lo:hi, hk].double()
    p = torch.softmax(keys @ q[b, s, h].double() / D ** 0.5, dim=0)
    return p @ vals


def _expected_launches(cfg, decode_steps: int) -> dict:
    """The launches of one generate run of ``cfg``: every kernel's count,
    zero for those its family does not run."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import n_shared_invocations
    L = cfg.n_layers
    if cfg.family in ("dense", "moe", "vlm"):
        # one attention call per block: a vlm cross block's is the media
        # attention (prefill) and the static cross cache (decode)
        want = {"flash_attention": L, "decode_attention": L * decode_steps}
    elif cfg.family == "audio":
        # the encoder's blocks, and each decoder block's self and cross
        # attention
        want = {"flash_attention": cfg.enc_dec.n_enc_layers + 2 * L,
                "decode_attention": 2 * L * decode_steps}
    elif cfg.family == "ssm":
        want = {"rwkv6_scan": L}
    else:
        n = n_shared_invocations(cfg)
        want = {"mamba2_ssd": L, "flash_attention": n,
                "decode_attention": n * decode_steps}
    return {**dict.fromkeys(ops.KERNELS, 0), **want}


def _serve_parity(torch, dev, arch: str, **fields) -> dict:
    """One smoke-reduced arch in float32 from the same weights, ``fields``
    set on its smoke config (HEAD160_SMOKE): the card through the kernels,
    the card through the plain versions and the CPU through the plain
    versions (see phase_serve_parity)."""
    from repro_torch.configs import get_arch, smoke_reduce
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import ShardCtx, get_model
    from repro_torch.parallel.axes import tree_map
    cfg = dataclasses.replace(smoke_reduce(get_arch(arch)), **fields)
    model = get_model(cfg)
    cpu_params = model.init(0, device="cpu")
    _open_gates(cpu_params)
    card_params = tree_map(lambda t: t.to(dev), cpu_params)
    prompt = serve.prompts(2, 16, cfg.vocab_size, "cpu")
    media = _seeded_media(torch, model, 2, "cpu")
    card_media = None if media is None else media.to(dev)
    want = _expected_launches(cfg, 8)
    call_err: dict = {}
    ops.reset_launch_counts()
    with _held_kernels(torch, call_err, {
            k: (1e-4, 1e-4) for k, n in want.items() if n}):
        card = serve.generate(model, card_params, prompt.to(dev), 9,
                              device=dev, keep_logits=True, media=card_media)
    launches = ops.launch_counts()
    card_plain = serve.generate(model, card_params, prompt.to(dev), 9,
                                device=dev, keep_logits=True,
                                ctx=ShardCtx(impl="torch"), media=card_media)
    cpu = serve.generate(model, cpu_params, prompt, 9, device="cpu",
                         keep_logits=True, media=media)
    check(launches == want, f"{arch} serve_parity launches {launches}, "
          f"want {want}")
    check(np.array_equal(card["tokens"], cpu["tokens"])
          and np.array_equal(card_plain["tokens"], cpu["tokens"]),
          f"{arch} serve_parity: card tokens != CPU tokens")

    def gap(a, b):
        return (a["logits"].cpu() - b["logits"].cpu()).abs().amax(
            dim=(1, 2)).tolist()
    kernel_gap, plain_gap = gap(card, cpu), gap(card_plain, cpu)
    check(all(np.isfinite(kernel_gap)), f"{arch} serve_parity: logits not "
          "finite")
    check(max(kernel_gap) <= 4 * max(plain_gap) + 1e-4,
          f"{arch} serve_parity: card logits {max(kernel_gap)} from the "
          f"CPU's, the card's plain path {max(plain_gap)}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "head_dim": cfg.resolved_head_dim, "prompt": [2, 16],
            "decode_steps": 8,
            "kernel_call_max_abs_err": call_err,
            "logit_gap_kernels_vs_cpu": kernel_gap,
            "logit_gap_card_plain_vs_cpu": plain_gap,
            "logit_gap_kernels_vs_card_plain": gap(card, card_plain),
            "tokens_equal": True, "launches": launches}


def _open_gates(params):
    """Set the vlm cross blocks' gates (zero at init) to CROSS_GATE, in
    place; other families' parameters are left as they are."""
    for gate in ("gate_attn", "gate_mlp"):
        if "cross_blocks" in params:
            params["cross_blocks"][gate].fill_(CROSS_GATE)


def _seeded_media(torch, model, batch, dev):
    """The vlm and audio models' media for ``batch`` requests, normal x
    0.02 from a CPU generator seeded with MEDIA_SEED (the same on every
    device), in the config's dtype on ``dev``; None for the other
    families.  Not the reference CLI's constant media: with every key
    equal, any attention weights give the same output."""
    ms = model.media_struct(batch)
    if ms is None:
        return None
    gen = torch.Generator().manual_seed(MEDIA_SEED)
    return (0.02 * torch.randn(ms.shape, generator=gen)).to(dev, ms.dtype)


def phase_serve_parity(torch, dev):
    """The smoke-reduced mistral-nemo-12b in float32 with TF32 off, from
    the same weights: the card through the kernels, the card through the
    plain versions and the CPU through the plain versions.  Every
    attention call of the kernel run agrees with its plain version on the
    same inputs within 1e-4; the greedy tokens of the three runs are equal;
    the kernel run's logits are within four times the gap between the
    card's plain run and the CPU's.  That gap is float32 summation order
    (cuBLAS against the CPU's BLAS) amplified by the smoke model's
    saturated attention scores, and no kernel is in it.  The same for
    stablelm-12b's smoke config at 2 layers with its head_dim, 160, put
    back ("head_dim_160")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "serve_parity", **_serve_parity(torch, dev, SERVE_ARCH),
          "head_dim_160": _serve_parity(torch, dev, HEAD160_ARCH,
                                        **HEAD160_SMOKE)})


def phase_family_serve_parity(torch, dev):
    """serve_parity for the smoke-reduced deepseek-moe-16b,
    qwen3-moe-235b-a22b, llama-3.2-vision-90b (its gates opened) and
    whisper-large-v3, the last two with seeded media (float32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "family_serve_parity",
          **{arch: _serve_parity(torch, dev, arch)
             for arch in FAMILY_ARCHS}})


def _by_kind(events) -> tuple:
    """Device time by kind from (kernel name, us) pairs, {kind: [n, us]},
    and the ten kernel names that took the most device time."""
    kinds: dict = {}
    names: dict = {}
    for name, us in events:
        low = name.lower()
        kind = next((k for k in KERNEL_KINDS if k in name),
                    "memcpy" if "memcpy" in low or "memset" in low else
                    "gemm" if any(t in low for t in ("gemm", "nvjet",
                                                      "cutlass")) else
                    "other")
        n_us = kinds.setdefault(kind, [0, 0.0])
        n_us[0] += 1
        n_us[1] += us
        names[name[:80]] = names.get(name[:80], 0.0) + us
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return kinds, {n: us for n, us in top}


def _serve_trace(torch, prof) -> tuple:
    """Device time by kind from a torch.profiler trace (_by_kind), and the
    twelve host operations with the most time (inclusive, {name: {n,
    cpu_us}}), read from the raw events: a profiled MoE decode step
    launches ~4,000 kernels, and building the profiler's per-event Python
    objects (``events()``, ``key_averages()``) took longer than the steps
    took to run."""
    from torch.autograd import DeviceType
    device, host = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.duration_ns() / 1e3))
        else:
            n_us = host.setdefault(e.name()[:60], [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.duration_ns() / 1e3
    top = sorted(host.items(), key=lambda kv: -kv[1][1])[:12]
    return (*_by_kind(device),
            {name: {"n": n, "cpu_us": us} for name, (n, us) in top})


def _chunking_control(torch, model, params, prompt, max_len, plain0, dev):
    """The largest prefill-logit gap between two plain runs that differ only
    in the float32 chunking of the attention's online softmax (512 and 256
    positions): how far rounding order alone moves this model's logits."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ShardCtx
    saved = ops.flash_attention

    def rechunked(q, k, v, *, causal=True, window=0, impl=None):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_chunk=256, kv_chunk=256)
    ops.flash_attention = rechunked
    try:
        logits, _ = model.prefill(params, prompt, max_len=max_len,
                                  ctx=ShardCtx(impl="torch"), device=dev)
    finally:
        ops.flash_attention = saved
    return float((logits - plain0).abs().max())


def _attention_saturation(torch, cfg, params, prompt) -> dict:
    """How peaked layer 0's causal softmax is on the first prompt under the
    seeded weights: the score spread and the largest probability per
    (head, query)."""
    from repro_torch.models import layers as L
    from repro_torch.models.lm import unstack
    blk = unstack(params["blocks"])[0]
    S = prompt.shape[1]
    x = L.norm_apply(blk["ln1"], L.embed_apply(params["embed"], prompt[:1]))
    q, k, _ = L._qkv(blk["attn"], x)
    pos = torch.arange(S, device=prompt.device)[None]
    q = L.rope_apply(q, pos, cfg.rope_theta)[:, :, ::cfg.n_heads
                                             // cfg.n_kv_heads]
    k = L.rope_apply(k, pos, cfg.rope_theta)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / cfg.resolved_head_dim ** 0.5
    visible = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
    top = torch.softmax(s.masked_fill(~visible, float("-inf")), -1).amax(-1)
    return {"score_std": float(s[..., visible].std()),
            "mean_top_prob": float(top.mean()),
            "share_top_prob_above_0.9": float((top > 0.9).float().mean())}


def _teacher_forced(torch, model, params, prompt, res, dev,
                    media=None) -> tuple:
    """The tokens of ``res`` (a generate run with kept logits) fed through
    the plain versions on the card: prefill (with ``media``), then one
    decode step per token.  Per step, the largest logit gap to the kernel
    run; wherever the plain path's top-2 margin exceeds twice that gap the
    greedy token must be the same.  Returns the record and the plain prefill's logits."""
    from repro_torch.models import ShardCtx
    plain_ctx = ShardCtx(impl="torch")
    logits, tokens = res["logits"], res["tokens"]
    B, S = prompt.shape
    n_tokens = tokens.shape[1]
    tok = torch.from_numpy(tokens).to(dev)
    diffs, checked, equal = [], 0, 0
    t0 = time.perf_counter()
    ref_logits, cache = model.prefill(params, prompt, media=media,
                                      max_len=S + n_tokens, ctx=plain_ctx,
                                      device=dev)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    plain0 = ref_logits.clone()
    for step in range(n_tokens):
        if step:
            ref_logits, cache = model.decode(params, cache,
                                             tok[:, step - 1:step], pos,
                                             ctx=plain_ctx, device=dev)
            pos += 1
        diff = float((ref_logits - logits[step]).abs().max())
        top2 = ref_logits.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        decided = margin > 2 * diff
        same = ref_logits.argmax(-1).cpu().numpy() == tokens[:, step]
        check(bool(same[decided].all()),
              f"serve: step {step}: a greedy token differs from the plain "
              f"path's where its top-2 margin exceeds twice the logit gap "
              f"{diff}")
        diffs.append(diff)
        checked += int(decided.sum())
        equal += int(same.sum())
    torch.cuda.synchronize()
    return ({"max_logit_diff_per_step": diffs, "rows_decided": checked,
             "rows_equal_token": equal, "rows": B * n_tokens,
             "plain_s": time.perf_counter() - t0}, plain0)


def _profiled_serving(torch, model, params, prompt, max_len, dev,
                      media=None) -> dict:
    """A fresh prefill, then PROFILED_STEPS decode steps, each under
    torch.profiler: device time by kind, the top kernels, the top host ops,
    the device operations the host launches per step and the decode loop's
    idle share."""
    from torch.profiler import ProfilerActivity, profile
    B, S = prompt.shape
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits0, cache = model.prefill(params, prompt, media=media,
                                       max_len=max_len, device=dev)
        torch.cuda.synchronize()
    prefill_kinds, prefill_top, _ = _serve_trace(torch, prof)
    step_tok = logits0.argmax(-1)[:, None]
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            out, cache = model.decode(params, cache, step_tok, pos, device=dev)
            step_tok = out.argmax(-1)[:, None]
            pos += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds, decode_top, host_top = _serve_trace(torch, prof)
    busy_s = sum(us for _, us in kinds.values()) / 1e6

    def by_kind(kinds):
        return {k: {"n": n, "total_us": us, "mean_us": us / n}
                for k, (n, us) in kinds.items()}
    return {"profiled_decode": {
                "steps": PROFILED_STEPS, "wall_s": wall,
                "device_busy_s": busy_s,
                "idle_share": 1.0 - busy_s / wall if kinds else None,
                "device_ops_per_step": sum(
                    n for n, _ in kinds.values()) / PROFILED_STEPS,
                "device_us": by_kind(kinds),
                "top_kernels_us": decode_top, "top_host_ops": host_top},
            "profiled_prefill_device_us": by_kind(prefill_kinds),
            "profiled_prefill_top_kernels_us": prefill_top}


def _per_call_ms(record) -> dict:
    """Each kernel's own mean device time per launch on the main path, from
    the profiled prefill (flash, the scans) and decode (decode attention);
    None where the profiler saw none."""
    pre_us = record["profiled_prefill_device_us"]
    dec_us = record["profiled_decode"]["device_us"]
    out = {}
    for k in KERNEL_KINDS:
        kind = (dec_us if k == "decode_attention" else pre_us).get(k)
        out[k] = None if kind is None else kind["mean_us"] / 1e3
    return out


def _serve_setup(torch, dev, cfg, prompt_len=SERVE_PROMPT):
    """The model of ``cfg`` (full width) with seeded weights on the card
    (a vlm's gates opened), the serving prompt (SERVE_BATCH x
    ``prompt_len``), seeded media where the family takes it, and what that
    took."""
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    _open_gates(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    prompt = serve.prompts(SERVE_BATCH, prompt_len, cfg.vocab_size, dev)
    media = _seeded_media(torch, model, SERVE_BATCH, dev)
    torch.cuda.reset_peak_memory_stats()
    return model, params, prompt, media, init_s, weights_gb


def _serve_main_run(torch, dev, cfg, model, params, prompt,
                    media=None) -> tuple:
    """The main path: generate with the launch counts zeroed just before
    and read just after; exactly the expected launches, finite logits,
    tokens in range."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launch_counts()
    res = serve.generate(model, params, prompt, SERVE_TOKENS, device=dev,
                         keep_logits=True, media=media)
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _expected_launches(cfg, SERVE_TOKENS - 1)
    check(launches == want, f"serve {cfg.name}: launches {launches}, want "
          f"{want}")
    logits, tokens = res["logits"], res["tokens"]
    check(tuple(logits.shape) == (SERVE_TOKENS, SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"serve {cfg.name}: logits not finite")
    check(tokens.shape == (SERVE_BATCH, SERVE_TOKENS)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"serve {cfg.name}: token ids out of range")
    del res["cache"]
    return res, launches, peak_gb


def _serve_record(phase, cfg, init_s, weights_gb, peak_gb, res, launches,
                  prompt_len=SERVE_PROMPT):
    from repro_torch.models import param_count
    decoded = SERVE_BATCH * (SERVE_TOKENS - 1)
    return {"phase": phase, "arch": cfg.name, "params": param_count(cfg),
            "dtype": str(cfg.dtype).removeprefix("torch."),
            "requests": SERVE_BATCH, "prompt_tokens": prompt_len,
            "new_tokens": SERVE_TOKENS, "init_s": init_s,
            "weights_gb": weights_gb, "peak_memory_gb": peak_gb,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "decode_tok_s": decoded / res["decode_s"],
            "decode_step_ms": 1e3 * res["decode_s"] / (SERVE_TOKENS - 1),
            "launches": launches,
            "sample": res["tokens"][0, :16].tolist()}


def phase_serve(torch, dev):
    """mistral-nemo-12b at full width (the depth of SERVE_DEPTH) in bf16,
    seeded weights on the card: 4 x (1024 prompt + 64 generated) tokens
    through
    launch/serve.py's generate.  The launch counts are zeroed just before
    and read just after; then the same tokens go through the plain versions
    on the card (teacher-forced); a second run holds every attention call
    against its plain version on the same inputs; a control and the layer-0
    softmax measure how strongly rounding differences are amplified; then
    16 decode steps are profiled."""
    from repro_torch.launch import serve
    cfg = _family_config(SERVE_ARCH)
    model, params, prompt, _, init_s, weights_gb = _serve_setup(torch, dev,
                                                                cfg)
    res, launches, peak_gb = _serve_main_run(torch, dev, cfg, model, params,
                                             prompt)
    teacher, plain0 = _teacher_forced(torch, model, params, prompt, res, dev)

    # every attention call of a second run against its plain version on
    # the same inputs, at the bf16 tolerance (launches not counted)
    call_err: dict = {}
    tol = (ATTN_TOL["bfloat16"],)
    with _held_kernels(torch, call_err, {"flash_attention": tol,
                                         "decode_attention": tol}):
        again = serve.generate(model, params, prompt, SERVE_TOKENS,
                               device=dev)
    del again["cache"]
    max_len = SERVE_PROMPT + SERVE_TOKENS
    control_gap = _chunking_control(torch, model, params, prompt, max_len,
                                    plain0, dev)
    saturation = _attention_saturation(torch, cfg, params, prompt)
    record = {
        **_serve_record("serve", cfg, init_s, weights_gb, peak_gb, res,
                        launches),
        "teacher_forced": teacher,
        "attention_call_max_abs_err": call_err,
        "rerun_tokens_equal": bool(np.array_equal(again["tokens"],
                                                  res["tokens"])),
        "plain_chunking_control_prefill_logit_gap": control_gap,
        "layer0_attention": saturation,
        **_profiled_serving(torch, model, params, prompt, max_len, dev)}
    emit(record)
    del params, res
    torch.cuda.empty_cache()
    per_call = _per_call_ms(record)
    return launches, {k: per_call[k] for k in ("flash_attention",
                                               "decode_attention")}


def phase_serve_stablelm12b(torch, dev):
    """stablelm-12b (head_dim 160) at full width and depth in bf16, seeded
    weights on the card, serve's traffic (4 x (1024 prompt + 64
    generated) tokens) through launch/serve.py's generate: the launch
    counts zeroed just before and read just after, exactly 40 flash and
    2,520 decode launches, finite logits and token ids in range; a second
    run holds every attention call against its plain version on the same
    inputs (2e-2, a disagreeing row settled in float64); then 16 decode
    steps are profiled.  Weights and peak memory in GB.  Returns the
    launches and each attention kernel's own device time per call on this
    path."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    cfg = get_arch(HEAD160_ARCH)
    check(cfg.resolved_head_dim == 160 and cfg.n_layers == 40,
          f"{cfg.name}: head_dim {cfg.resolved_head_dim}, "
          f"{cfg.n_layers} layers")
    model, params, prompt, _, init_s, weights_gb = _serve_setup(torch, dev,
                                                                cfg)
    res, launches, peak_gb = _serve_main_run(torch, dev, cfg, model, params,
                                             prompt)
    call_err: dict = {}
    tol = (ATTN_TOL["bfloat16"],)
    with _held_kernels(torch, call_err, {"flash_attention": tol,
                                         "decode_attention": tol}):
        again = serve.generate(model, params, prompt, SERVE_TOKENS,
                               device=dev)
    del again["cache"]
    record = {
        **_serve_record("serve_stablelm12b", cfg, init_s, weights_gb,
                        peak_gb, res, launches),
        "head_dim": cfg.resolved_head_dim,
        "attention_call_max_abs_err": call_err,
        "rerun_tokens_equal": bool(np.array_equal(again["tokens"],
                                                  res["tokens"])),
        **_profiled_serving(torch, model, params, prompt,
                            SERVE_PROMPT + SERVE_TOKENS, dev)}
    emit(record)
    del params, res, again
    torch.cuda.empty_cache()
    per_call = _per_call_ms(record)
    return launches, {k: per_call[k] for k in ATTN_KERNELS}


# ---------------------------------------------------------------- recurrent

def _rwkv_inputs(torch, gen, B, S, H, Dh, dtype, dev, strong=False):
    """tests/test_kernels.py's distributions: r, k, v, state0 normal,
    w = sigmoid(2 z), u = 0.3 z; ``strong``: the model's own decay
    w = exp(-exp(clip(3 z, -20, 10))) (models/layers.py), exact zeros
    included."""
    r, k, v = (torch.randn((B, S, H, Dh), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    z = torch.randn((B, S, H, Dh), generator=gen, device=dev)
    w = (torch.exp(-torch.exp((3 * z).clamp(-20.0, 10.0))) if strong
         else torch.sigmoid(2 * z)).to(dtype)
    u = (0.3 * torch.randn((H, Dh), generator=gen, device=dev)).to(dtype)
    s0 = torch.randn((B, H, Dh, Dh), generator=gen, device=dev)
    return r, k, v, w, u, s0


def _ssd_inputs(torch, gen, B, S, H, P, N, dtype, dev, strong=False):
    """x, B, C, state0 normal, dt = softplus(z), A = -exp(0.5 z), as
    tests/test_kernels.py; ``strong``: A from -1 down to -50 across the
    heads (dt A far below where exp underflows)."""
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, H), generator=gen, device=dev)).to(dtype)
    A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device=dev))
    if strong:
        A = -torch.linspace(1.0, 50.0, H, device=dev)
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    s0 = torch.randn((B, H, P, N), generator=gen, device=dev)
    return x, dt, A, Bm, Cm, s0


def scan_timing(torch, dev) -> dict:
    """Each scan kernel at its serving prefill shape ("main"), in float32
    and bf16: the median CUDA-event time of a call (host wrapper inside)
    and the kernel's own device time under torch.profiler.  Runs against
    any src/ tree of the port, so two versions can be timed in turns in
    one chip call (``--timing scan --src``)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(1)
    out: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for kernel, inputs, fn, shape in (
                ("rwkv6_scan", _rwkv_inputs, ops.rwkv6_scan,
                 RWKV_CASES["main"]),
                ("mamba2_ssd", _ssd_inputs, ops.mamba2_ssd,
                 SSD_CASES["main"])):
            args = inputs(torch, gen, *shape, dtype, dev)

            def call():
                return fn(*args, impl="cuda")
            out[f"{kernel}/{dname}"] = {
                "ms": _time_ms(torch, call),
                "device_ms": _kernel_device_ms(torch, call, kernel)}
            del args
    torch.cuda.synchronize()
    return out


def decode_timing(torch, dev) -> dict:
    """The decode kernel's normal mode at every DECODE_CASES case, bf16 and
    float32: the median CUDA-event time of a call and the kernel's device
    time under torch.profiler; and each decode instance's registers and
    spills from the build's ptxas report.  Runs against any src/ tree of
    the port, so two versions can be timed in turns in one chip call
    (``--timing decode --src``)."""
    from repro_torch.kernels import _build, ops
    _build.load()
    usage = {m: u for m, u in _build.ptxas_usage(
        _build.ptxas_report().read_text()).items()
        if "decode_attention_kernel" in m}
    names = _build.demangle(set(usage))
    gen = torch.Generator(device=dev).manual_seed(1)
    out: dict = {"ptxas": {names[m]: u for m, u in usage.items()}}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for case, (B, Smax, H, Hkv, D, window, lens) in DECODE_CASES.items():
            q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, Smax, Hkv, D, generator=gen,
                            device=dev).to(dtype)
            v = torch.randn(B, Smax, Hkv, D, generator=gen,
                            device=dev).to(dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)

            def call():
                return ops.decode_attention(q, k, v, kv_len, window=window,
                                            impl="cuda")
            out[f"{case}/{dname}"] = {
                "ms": _time_ms(torch, call),
                "device_ms": _kernel_device_ms(torch, call,
                                               "decode_attention")}
            del q, k, v
    torch.cuda.synchronize()
    return out


def serve_timing(torch, dev) -> dict:
    """serve's traffic through launch/serve.py's generate for each arch
    of SERVE_TIMED (phase_serve's and phase_serve_family's configs and
    seeded weights): a warm-up run, then SERVE_TIMED_RUNS runs, each
    one's prefill s and decode ms a step on the host clock.  Runs against
    any src/ tree of the port, so two versions can be timed in turns in
    one chip call (``--timing serve --src``)."""
    from repro_torch.launch import serve
    out: dict = {}
    for arch in SERVE_TIMED:
        cfg = _family_config(arch)
        model, params, prompt, media, _, _ = _serve_setup(
            torch, dev, cfg, FAMILY_PROMPT.get(arch, SERVE_PROMPT))
        runs = []
        for _ in range(1 + SERVE_TIMED_RUNS):
            res = serve.generate(model, params, prompt, SERVE_TOKENS,
                                 device=dev, media=media)
            runs.append({"prefill_s": res["prefill_s"],
                         "decode_step_ms": 1e3 * res["decode_s"]
                         / (SERVE_TOKENS - 1)})
            del res
        out[arch] = runs[1:]
        del params, media
        torch.cuda.empty_cache()
    return out


def _carry(torch, fn, args, seq, cut):
    """One call, then the sequence cut at ``cut`` into two calls with the
    state carried; the positions in ``seq`` are the time-major inputs."""
    y, st = fn(*args, impl="cuda")
    first = [a[:, :cut].contiguous() if i in seq else a
             for i, a in enumerate(args)]
    y1, s1 = fn(*first, impl="cuda")
    rest = [a[:, cut:].contiguous() if i in seq else a
            for i, a in enumerate(args)]
    rest[-1] = s1
    y2, s2 = fn(*rest, impl="cuda")
    return (y, st), (torch.cat([y1, y2], 1), s2)


def phase_scan_kernels(torch, dev):
    """Each scan kernel against its plain version on the card, in float32
    and bf16, at every case of RWKV_CASES / SSD_CASES (the kernel's time by
    CUDA events at each but "main", the plain version's at "main");
    scan_timing's times at "main"; the state carried across two calls:
    bitwise equal to one
    call for rwkv6 in both dtypes and for mamba2 in float32, and for the
    chunked bf16 mamba2 (whose chunk boundaries move with the cut) within
    STATE_TOL and y within the bf16 tolerance."""
    from repro_torch.launch import cost
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = dict.fromkeys(SCAN_KERNELS, 0.0)
    state_err = dict.fromkeys(SCAN_KERNELS, 0.0)
    timing: dict = {k: {} for k in SCAN_KERNELS}
    plan = (("rwkv6_scan", RWKV_CASES, _rwkv_inputs, cost.rwkv6_work,
             ops.rwkv6_scan),
            ("mamba2_ssd", SSD_CASES, _ssd_inputs, cost.ssd_work,
             ops.mamba2_ssd))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        tol = SCAN_TOL[dname]
        for kernel, cases, inputs, work, fn in plan:
            for case, shape in cases.items():
                args = inputs(torch, gen, *shape, dtype, dev,
                              strong=case.endswith("_strong"))
                y, st = fn(*args, impl="cuda")
                py, pst = fn(*args, impl="torch")
                ey = float((y.float() - py.float()).abs().max())
                es = float((st - pst).abs().max())
                check(torch.allclose(y.float(), py.float(), rtol=tol,
                                     atol=tol)
                      and bool(torch.isfinite(y).all()),
                      f"{kernel} {case} {dname}: y != plain version (max "
                      f"abs err {ey})")
                check(torch.allclose(st, pst, rtol=STATE_TOL, atol=STATE_TOL),
                      f"{kernel} {case} {dname}: state != plain version "
                      f"(max abs err {es})")
                max_err[kernel] = max(max_err[kernel], ey)
                state_err[kernel] = max(state_err[kernel], es)
                rec = {"max_abs_err": ey, "state_max_abs_err": es}
                if case != "main":      # "main": scan_timing below
                    rec["ms"] = _time_ms(
                        torch, lambda: fn(*args, impl="cuda"), n=20,
                        warmup=3)
                else:
                    rec["plain_ms"] = _time_ms(
                        torch, lambda: fn(*args, impl="torch"), n=3,
                        warmup=1)
                rec["library_ms"] = None
                rec["bound_ms"], rec["bound_by"] = cost.bound_ms(
                    *work(*shape, dname))
                timing[kernel][f"{case}/{dname}"] = rec
                del args, y, st, py, pst
    for key, rec in scan_timing(torch, dev).items():
        kernel, dname = key.split("/")
        timing[kernel][f"main/{dname}"].update(rec)
    # the sequence in two calls, the state carried
    carry = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        one, two = _carry(torch, ops.rwkv6_scan, _rwkv_inputs(
            torch, gen, 2, 301, 4, 64, dtype, dev), (0, 1, 2, 3), SCAN_CUT)
        check(torch.equal(two[0], one[0]) and torch.equal(two[1], one[1]),
              f"rwkv6_scan {dname}: a carried state != one call")
        carry[f"rwkv6_scan/{dname}"] = "equal"
        one, two = _carry(torch, ops.mamba2_ssd, _ssd_inputs(
            torch, gen, 2, 301, 4, 32, 64, dtype, dev), (0, 1, 3, 4),
            SCAN_CUT)
        if dtype == torch.float32:
            check(torch.equal(two[0], one[0]) and torch.equal(two[1], one[1]),
                  "mamba2_ssd float32: a carried state != one call")
            carry["mamba2_ssd/float32"] = "equal"
        else:
            ey = float((two[0].float() - one[0].float()).abs().max())
            es = float((two[1] - one[1]).abs().max())
            check(torch.allclose(two[0].float(), one[0].float(),
                                 rtol=SCAN_TOL[dname], atol=SCAN_TOL[dname])
                  and torch.allclose(two[1], one[1], rtol=STATE_TOL,
                                     atol=STATE_TOL),
                  f"mamba2_ssd bf16: a carried state is {es} (y {ey}) from "
                  "one call")
            carry["mamba2_ssd/bfloat16"] = {"y_max_abs_err": ey,
                                            "state_max_abs_err": es}
    torch.cuda.synchronize()
    emit({"phase": "scan_kernels", "rwkv_cases": RWKV_CASES,
          "ssd_cases": SSD_CASES, "timing": timing, "max_abs_err": max_err,
          "state_max_abs_err": state_err, "state_carry": carry,
          "ops_per_element": {
              "rwkv6_scan": cost.RWKV_OPS_PER_ELEMENT,
              "mamba2_ssd (float32)": cost.SSD_OPS_PER_ELEMENT}})
    return timing, max_err, state_err


def phase_recurrent_serve_parity(torch, dev):
    """serve_parity for the smoke-reduced rwkv6-1.6b and zamba2-1.2b
    (float32, TF32 off for matmuls and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "recurrent_serve_parity",
          **{arch: _serve_parity(torch, dev, arch)
             for arch in RECURRENT_ARCHS}})


def phase_serve_recurrent(torch, dev, arch: str) -> tuple:
    """``arch`` at full width (the depth of SERVE_DEPTH) in bf16, seeded
    weights on the card, the traffic of phase_serve: the main run (exact
    launches), the same
    tokens teacher-forced through the plain versions (the logit gap
    reported, not held: zamba2's shared attention is saturated under the
    reference's init, as nemo's), a second run with every kernel call held
    to its plain version at the bf16 tolerances, and a profiled prefill and
    decode loop."""
    from repro_torch.launch import serve
    phase = "serve_" + arch.split("-")[0]
    cfg = _family_config(arch)
    model, params, prompt, _, init_s, weights_gb = _serve_setup(torch, dev,
                                                                cfg)
    res, launches, peak_gb = _serve_main_run(torch, dev, cfg, model, params,
                                             prompt)
    teacher, _ = _teacher_forced(torch, model, params, prompt, res, dev)
    call_err: dict = {}
    tols = {k: (SCAN_TOL["bfloat16"], STATE_TOL) for k in SCAN_KERNELS}
    tols.update({k: (ATTN_TOL["bfloat16"],)
                 for k in ("flash_attention", "decode_attention")})
    with _held_kernels(torch, call_err, {k: t for k, t in tols.items()
                                         if launches[k]}):
        again = serve.generate(model, params, prompt, SERVE_TOKENS,
                               device=dev)
    del again["cache"]
    max_len = SERVE_PROMPT + SERVE_TOKENS
    record = {
        **_serve_record(phase, cfg, init_s, weights_gb, peak_gb, res,
                        launches),
        "teacher_forced": teacher, "kernel_call_max_abs_err": call_err,
        "rerun_tokens_equal": bool(np.array_equal(again["tokens"],
                                                  res["tokens"])),
        **_profiled_serving(torch, model, params, prompt, max_len, dev)}
    emit(record)
    del params, res
    torch.cuda.empty_cache()
    return launches, _per_call_ms(record), call_err


def _family_config(arch: str):
    """``arch`` at its published widths, with the depth SERVE_DEPTH cuts
    it to."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    return cfg


@contextlib.contextmanager
def _moe_tap(torch, cfg):
    """While open, every call of layers.moe_apply also appends (pairs
    dropped, pairs) to the list it yields: the layer's router recomputed
    on its own input, outside autograd (what the layer computes is
    unchanged).  The one group and no chunking of these sizes are
    checked."""
    from repro_torch.models import layers as L
    m = cfg.moe
    counts: list = []
    saved = L.moe_apply

    def tap(p, x, cfg_, ctx=L.NO_SHARD, dropless=False):
        T = x.shape[0] * x.shape[1]
        check(ctx.n_groups == 1 and not dropless
              and (not m.chunk_tokens or T <= m.chunk_tokens),
              f"{cfg.name}: the drop count assumes one group and chunk")
        with torch.no_grad():
            _, _, topi = L.moe_route(p, x.reshape(1, T, -1), cfg_)
            count = torch.bincount(topi.reshape(-1), minlength=m.n_experts)
            C = L.moe_capacity(cfg_, T, False)
            counts.append((int((count - C).clamp(min=0).sum()),
                           T * m.top_k))
        return saved(p, x, cfg_, ctx, dropless)
    L.moe_apply = tap
    try:
        yield counts
    finally:
        L.moe_apply = saved


def _moe_drops(torch, cfg, model, params, prompt, dev) -> dict:
    """The (token, expert) pairs the capacity-bounded MoE layers of one
    prefill of the serving prompt drop, per layer (_moe_tap)."""
    from repro_torch.models import layers as L
    with _moe_tap(torch, cfg) as counts:
        model.prefill(params, prompt, max_len=prompt.shape[1], device=dev)
    dropped = [d for d, _ in counts]
    pairs = prompt.numel() * cfg.moe.top_k
    return {"capacity_factor": cfg.moe.capacity_factor,
            "slots_per_expert": L.moe_capacity(cfg, prompt.numel(), False),
            "pairs_per_layer": pairs, "dropped_per_layer": dropped,
            "dropped": sum(dropped),
            "dropped_share": sum(dropped) / (pairs * len(dropped))}


def phase_serve_family(torch, dev, arch: str) -> tuple:
    """``arch`` (FAMILY_ARCHS) at full width, bf16, seeded weights on the
    card (a vlm's gates opened; seeded media for vlm and audio), the
    traffic of phase_serve: the main run (exact launches), the same tokens
    teacher-forced through the plain versions, a second run with every
    attention call held to its plain version at the bf16 tolerance, a
    profiled prefill and decode loop; for MoE the pairs a prefill drops at
    capacity_factor, and the weight floor of a dropless decode step (it
    reads every expert)."""
    from repro_torch.launch import cost
    from repro_torch.launch import serve
    from repro_torch.models import active_param_count
    phase = FAMILY_PHASE[arch]
    cfg = _family_config(arch)
    prompt_len = FAMILY_PROMPT.get(arch, SERVE_PROMPT)
    seconds: dict = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    model, params, prompt, media, init_s, weights_gb = _serve_setup(
        torch, dev, cfg, prompt_len)
    lap("setup")
    res, launches, peak_gb = _serve_main_run(torch, dev, cfg, model, params,
                                             prompt, media)
    lap("main")
    teacher, _ = _teacher_forced(torch, model, params, prompt, res, dev,
                                 media)
    lap("teacher_forced")
    call_err: dict = {}
    tol = (ATTN_TOL["bfloat16"],)
    with _held_kernels(torch, call_err, {"flash_attention": tol,
                                         "decode_attention": tol}):
        again = serve.generate(model, params, prompt, SERVE_TOKENS,
                               device=dev, media=media)
    del again["cache"]
    lap("held")
    max_len = prompt_len + SERVE_TOKENS
    record = {
        **_serve_record(phase, cfg, init_s, weights_gb, peak_gb, res,
                        launches, prompt_len),
        "n_layers": cfg.n_layers, "active_params": active_param_count(cfg),
        "media": None if media is None else list(media.shape),
        "teacher_forced": teacher, "attention_call_max_abs_err": call_err,
        "rerun_tokens_equal": bool(np.array_equal(again["tokens"],
                                                  res["tokens"])),
        **_profiled_serving(torch, model, params, prompt, max_len, dev,
                            media)}
    lap("profiled")
    if cfg.family == "moe":
        record["moe_prefill"] = _moe_drops(torch, cfg, model, params, prompt,
                                           dev)
        record["decode_weight_floor_ms"] = \
            1e3 * weights_gb * 1e9 / cost.PEAK_BYTES_S
        lap("moe_drops")
    record["seconds"] = seconds
    emit(record)
    del params, res, again, media
    torch.cuda.empty_cache()
    return launches, _per_call_ms(record), call_err


# ---------------------------------------------------------------- the
# paper's predictor study and §5 evaluation

def _forest_launches(torch) -> dict:
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    return {k: counts[k] for k in FOREST_KERNELS}


def _device_ops(torch, fn) -> dict:
    """The device operations (kernels and copies) and their busy time in
    one call of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return {"device_ops": len(events), "wall_s": wall,
            "device_busy_s": sum(e.duration_ns() for e in events) / 1e9}


def phase_cv(torch, dev, smi, map_data) -> dict:
    """cross_validate of each of the six models on fit's 1000-node map
    dataset, on the card and on the CPU on the same rows (the same seed
    draws the same subsample and folds).  Returns the forest launches of
    the card's CV."""
    from repro_torch.kernels import ops
    from repro_torch.ml import models
    from repro_torch.ml.cv import cross_validate
    X, y = map_data
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = {name: cross_validate(name, X, y, k=CV_FOLDS, max_n=CV_MAX_N,
                                 device=dev) for name in models.ALL_MODELS}
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = _forest_launches(torch)
    check(launches["forest_infer"] > 0, "cv launched no forest_infer")
    t0 = time.perf_counter()
    cpu = {name: cross_validate(name, X, y, k=CV_FOLDS, max_n=CV_MAX_N,
                                device="cpu") for name in models.ALL_MODELS}
    cpu_s = time.perf_counter() - t0
    gaps = {}
    for name in models.ALL_MODELS:
        gaps[name] = max(abs(card[name][m] - cpu[name][m]) for m in (
            "accuracy", "precision", "recall", "error"))
        check(card[name]["n"] == cpu[name]["n"], f"cv {name}: rows differ")
        if name in CV_FOREST:
            check(gaps[name] == 0.0, f"cv {name}: card metrics != CPU's")
        else:
            check(gaps[name] <= CV_DENSE_TOL, f"cv {name}: card metrics "
                  f"{gaps[name]} from the CPU's (> {CV_DENSE_TOL})")
    # one fit of each dense model on a fold's rows, profiled on the card
    n = card["Glm"]["n"] * (CV_FOLDS - 1) // CV_FOLDS
    Xs = (X[:n] - X[:n].mean(0)) / (X[:n].std(0) + 1e-6)
    fits = {"Glm": _device_ops(
                torch, lambda: models._glm_fit(Xs, y[:n], device=dev)),
            "N.N.": _device_ops(
                torch, lambda: models._nn_fit(Xs, y[:n], device=dev))}
    dense_ms = card["Glm"]["time_ms"] + card["N.N."]["time_ms"]
    emit({"phase": "cv", "nvidia_smi": smi, "rows": card["Glm"]["n"],
          "features": int(X.shape[1]), "folds": CV_FOLDS,
          "card": card, "cpu": cpu, "card_s": card_s, "cpu_s": cpu_s,
          "max_metric_gap": gaps,
          "dense_fits_share_of_card_cv": dense_ms / (card_s * 1e3),
          "one_fit_on_card": {**fits, "rows": n},
          "launches": launches})
    return launches


def _cpu_sweep(spec_kw: dict, executor: str = "serial") -> tuple:
    """A sweep on the CPU, in a process of its own so that it overlaps the
    card runs: (result, wall seconds, log, fault stats of an async run)."""
    import torch
    from repro_torch.cluster.fleet import SweepSpec, run_sweep
    torch.set_num_threads(2)
    log: list = []
    stats = {} if executor == "async" else None
    t0 = time.perf_counter()
    result = run_sweep(SweepSpec(**spec_kw), executor=executor, device="cpu",
                       fault_stats=stats, log=log.append)
    return result, time.perf_counter() - t0, log, stats


def phase_sweep(torch, dev, smi) -> dict:
    """The §5 sweep at SWEEP_FLEET nodes under four executors; equal
    results.
    The CPU run goes in a spawned process alongside the three card runs.
    Returns the forest launches of the in-process card runs (the process
    pool's workers count their own, which the parent does not see)."""
    import concurrent.futures
    import multiprocessing
    import tempfile
    from repro_torch.cluster.fleet import SweepSpec, run_sweep
    from repro_torch.kernels import ops
    spec = SweepSpec(**SWEEP)
    runs, walls, launches, logs = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as registry, \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_run = pool.submit(_cpu_sweep, SWEEP)
        for name, kw in (
                ("serial", dict(executor="serial", device=dev)),
                ("broker", dict(executor="broker", registry=registry,
                                device=dev)),
                ("process", dict(executor="process", workers=SWEEP_WORKERS,
                                 device=dev))):
            logs[name] = []
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs[name] = run_sweep(spec, log=logs[name].append, **kw)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            launches[name] = _forest_launches(torch)
        t0 = time.perf_counter()
        runs["serial_cpu"], walls["serial_cpu"], logs["serial_cpu"], _ = \
            cpu_run.result()
        walls["waited_for_serial_cpu"] = time.perf_counter() - t0
    first = runs["serial"]
    for name, r in runs.items():
        for key in SWEEP_KEYS:
            check(r[key] == first[key], f"sweep {name}: {key} differs from "
                  "the serial card run's")
    broker = runs["broker"]["perf"]["broker"]
    check(broker["dispatches"] > 0, "sweep broker: no dispatch")
    for c in first["cells"]:
        if c["scenario"] == "kitchen_sink" and c["scheduler"] != "fifo":
            check(c["stats"]["predictions"] > 0,
                  f"sweep {c['cell_id']}: no prediction")
    check(launches["serial"]["forest_infer"] > 0,
          "sweep serial: no forest_infer launch")
    check(launches["broker"]["forest_infer_grouped"] > 0,
          "sweep broker: no forest_infer_grouped launch")
    emit({"phase": "sweep", "nvidia_smi": smi, "spec": first["spec"],
          "wall_s": walls, "launches": launches,
          "perf_broker": broker, "equal": list(SWEEP_KEYS),
          "rankings": first["rankings"],
          "atlas_stats": {c["cell_id"]: c["stats"] for c in first["cells"]
                          if c["scheduler"] != "fifo"},
          "log": logs})
    return {"sweep_serial": launches["serial"],
            "sweep_broker": launches["broker"]}


def phase_serve_async(torch, dev, smi) -> dict:
    """The §5 sweep's baseline cells at SERVE_ASYNC_FLEET nodes and one
    seed served
    four ways: (a) the broker executor, (b) the async executor (an
    AsyncBroker over inproc:// on the card), (c) the async executor under
    CHAOS_PLAN, its timeout sized from (b)'s longest wait, (d) the async
    executor on the CPU in a spawned process alongside.  Equal results,
    perf.broker equal across (a)-(c), faults injected and retried with no
    fallback, every probability the card runs served equal to the numpy
    mirror, and the grouped kernel launched once per server dispatch.
    Returns the clean async run's forest launches and the broker run's
    result."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.cluster.fleet import SweepSpec, run_sweep
    from repro_torch.kernels import ops
    from repro_torch.online.faults import FAULT_BOUNDS, FaultPlan
    spec = SweepSpec(**SERVE_ASYNC)
    runs, walls, launches, logs, faults, served = {}, {}, {}, {}, {}, {}

    def run(name, **kw):
        logs[name], log = [], []
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with _served(log):
            runs[name] = run_sweep(spec, device=dev, log=logs[name].append,
                                   **kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = _forest_launches(torch)
        served[name] = _check_served(log, f"serve_async {name}")

    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_run = pool.submit(_cpu_sweep, SERVE_ASYNC, "async")
        run("broker", executor="broker")
        faults["async"] = {}
        run("async", executor="async", fault_stats=faults["async"])
        wait = faults["async"]["max_request_wait_s"]
        timeout = max(TIMEOUT_OVER_WAIT * wait, MIN_TIMEOUT_S)
        check(timeout <= FAULT_BOUNDS["request_timeout_s"].hi,
              f"serve_async: the clean run waited {wait} s, too long for a "
              "timeout inside FAULT_BOUNDS")
        plan = FaultPlan(**CHAOS_PLAN, request_timeout_s=timeout).validate()
        faults["async_faulted"] = {}
        run("async_faulted", executor="async", fault_plan=plan,
            fault_stats=faults["async_faulted"])
        t0 = time.perf_counter()
        (runs["async_cpu"], walls["async_cpu"], logs["async_cpu"],
         faults["async_cpu"]) = cpu_run.result()
        walls["waited_for_async_cpu"] = time.perf_counter() - t0
    first = runs["broker"]
    for name, r in runs.items():
        for key in SWEEP_KEYS:
            check(r[key] == first[key], f"serve_async {name}: {key} differs "
                  "from the broker run's")
    for name in ("async", "async_faulted"):
        check(runs[name]["perf"] == first["perf"], f"serve_async {name}: "
              "perf.broker differs from the broker run's")
    broker = first["perf"]["broker"]
    check(broker["demand_calls"] > 0, "serve_async: no demand call")
    for name in ("broker", "async", "async_faulted"):
        check(launches[name]["forest_infer_grouped"] == broker["dispatches"],
              f"serve_async {name}: {launches[name]['forest_infer_grouped']}"
              f" forest_infer_grouped launches, {broker['dispatches']} "
              "dispatches")
    chaos = faults["async_faulted"]
    check(chaos["injected"]["events"] > 0, "serve_async: no fault injected")
    check(chaos["client_retries"] > 0, "serve_async: no client retry")
    check(chaos["fallbacks"] == 0, f"serve_async: {chaos['fallbacks']} "
          "fallbacks under the fault plan (a slow card path hidden as an "
          "outage)")
    for name in ("async", "async_cpu"):
        check(faults[name]["fallbacks"] == 0
              and faults[name]["client_retries"] == 0,
              f"serve_async {name}: retries or fallbacks in a clean run")
    emit({"phase": "serve_async", "nvidia_smi": smi, "spec": first["spec"],
          "wall_s": walls, "launches": launches, "perf_broker": broker,
          "equal": list(SWEEP_KEYS),
          "perf_equal_cpu": runs["async_cpu"].get("perf") == first["perf"],
          "fault_plan": plan.to_dict(), "fault_stats": faults,
          "longest_wait_s": {k: v["max_request_wait_s"]
                             for k, v in faults.items()},
          "served": served,
          "atlas_stats": {c["cell_id"]: c["stats"] for c in first["cells"]
                          if c["scheduler"] != "fifo"},
          "log": logs})
    return launches["async"], first


def _cpu_compare(cfg, obs_path: str) -> dict:
    """compare("fifo") with telemetry on the CPU, in a process of its own so
    that it overlaps the card runs."""
    import torch
    from repro_torch.cluster.experiment import compare
    torch.set_num_threads(2)
    return compare("fifo", dataclasses.replace(cfg, device="cpu",
                                               obs_path=obs_path))


class _DeltaPoller:
    """Chains ``/delta?since=<seq>`` on a live server while a run streams
    to it (benchmarks/live_overhead.py's poller): every entry once, the
    number of polls and resync replies."""

    def __init__(self, base_url: str):
        import threading
        self.base = base_url
        self.entries: list = []
        self.polls = 0
        self.resyncs = 0
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="delta-poller")

    def poll(self):
        since = self.entries[-1]["seq"] if self.entries else 0
        r = _get_json(f"{self.base}/delta?since={since}")
        self.polls += 1
        self.resyncs += bool(r.get("resync"))
        self.entries.extend(r["frames"])

    def _run(self):
        try:
            while not self._stop.is_set():
                self.poll()
                time.sleep(0.05)
        except Exception as e:          # surfaced by stop()
            self.error = e

    def start(self) -> "_DeltaPoller":
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)
        check(self.error is None, f"obs: the /delta poller failed: "
              f"{self.error!r}")
        self.poll()                     # the last entries, after the run


def _get_json(url: str):
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.load(r)


def _settle(seq, timeout=60.0):
    """Wait until ``seq()`` stops moving (every frame the producers sent
    has been folded) or ``timeout`` passes."""
    deadline = time.time() + timeout
    last = seq()
    while time.time() < deadline:
        time.sleep(0.25)
        now = seq()
        if now == last:
            return now
        last = now
    return last


def _device_name(torch, dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _overhead_child_ready(device: str) -> str:
    """Ready a fresh process for _obs_overhead: torch, the device and, on
    the card, the kernel library (no launch)."""
    import torch
    from repro_torch.ml.forest import warm_up
    dev = torch.device(device)
    warm_up(dev)
    return _device_name(torch, dev)


def _obs_overhead(cfg, snap: dict, sink: str, target: str, pairs: int,
                  gated: bool, device: str, warm: bool = True) -> dict:
    """benchmarks/obs_overhead.py's estimator on the card's ATLAS run, in a
    process of its own as the benchmark runs (the long chip_smoke process's
    heap and threads stay out of its times): off/on pairs back to back,
    the order alternating pair to pair, each sample timed after a
    gc.collect(); the overhead is the median of the per-pair deltas over
    the median off time, on CPU time (time.process_time, the benchmark's
    clock; the wall clock's reading, time.perf_counter, is kept beside it).
    Up to OBS_ATTEMPTS attempts; a gated measurement stops at
    the first within OBS_BUDGET (the caller checks the best).  ``sink``
    "ndjson" streams the on-runs' frames to files under the directory
    ``target``, "live_tcp" to the collector at the address ``target``; the
    predictor scores on ``device``; ``warm`` runs one off and one on sample
    first.  The on and off runs' metrics must be equal.
    Each pair's seconds on both clocks and full garbage collections are
    kept."""
    import gc
    import torch
    from repro_torch.cluster.experiment import run_scheduler
    from repro_torch.core.predictor import TaskPredictor
    dev = torch.device(device)
    counter = iter(range(1 << 30))

    def sample(on: bool):
        pred = TaskPredictor(**_predictor_kw(cfg), device=dev)
        pred.load_snapshot(snap)
        run_cfg = cfg
        if on and sink == "ndjson":
            run_cfg = dataclasses.replace(
                cfg, obs_path=f"{target}/{next(counter)}.ndjson")
        elif on:
            run_cfg = dataclasses.replace(cfg, obs_live_addr=target,
                                          obs_source=f"overhead_"
                                          f"{next(counter)}")
        gc.collect()
        full = gc.get_stats()[2]["collections"]
        c0, w0 = time.process_time(), time.perf_counter()
        metrics, _, _ = run_scheduler("atlas-fifo", run_cfg, pred)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = {"cpu": time.process_time() - c0,
                   "wall": time.perf_counter() - w0}
        return seconds, metrics, gc.get_stats()[2]["collections"] - full

    def median_delta(detail, clock: str = ""):
        """The median off seconds and the median on - off delta, on CPU
        time or, with clock "wall_", the wall clock."""
        return (statistics.median(d[f"off_{clock}s"] for d in detail),
                statistics.median(d[f"on_{clock}s"] - d[f"off_{clock}s"]
                                  for d in detail))

    if warm:
        sample(False)                               # warm both sides
        sample(True)
    attempts = []
    for _ in range(OBS_ATTEMPTS):
        detail = []
        for k in range(pairs):
            if k % 2 == 0:
                off, m_off, g_off = sample(False)
                on, m_on, g_on = sample(True)
            else:
                on, m_on, g_on = sample(True)
                off, m_off, g_off = sample(False)
            detail.append({"off_s": off["cpu"], "on_s": on["cpu"],
                           "off_wall_s": off["wall"],
                           "on_wall_s": on["wall"],
                           "full_gc": [g_off, g_on]})
        check({k: v for k, v in m_on.items() if k != "obs"} == m_off,
              "obs: telemetry changed the ATLAS run's results")
        wall_base, wall_added = median_delta(detail, "wall_")
        base, added = median_delta(detail)
        attempts.append({"seconds_off": base, "added_ms": added * 1e3,
                         "overhead_frac": added / base,
                         "overhead_frac_wall": wall_added / wall_base,
                         "frames": m_on["obs"]["frames"], "pairs": detail})
        if not gated or attempts[-1]["overhead_frac"] <= OBS_BUDGET:
            break
    best = min(attempts, key=lambda a: a["overhead_frac"])
    return {**{k: v for k, v in best.items() if k != "pairs"},
            "attempts": [a["overhead_frac"] for a in attempts],
            "attempts_wall": [a["overhead_frac_wall"] for a in attempts],
            "samples": [a["pairs"] for a in attempts], "pairs": pairs,
            "budget_frac": OBS_BUDGET if gated else None}


def _flush_latency(path) -> dict:
    """The broker's flush wall latency (p50, p99) and its histogram from
    its per-flush frames, through a BrokerObserver that keeps them all."""
    from repro_torch.obs import BrokerObserver, read_ndjson
    frames = read_ndjson(path)
    obs = BrokerObserver(latency_ring=max(len(frames), 1))
    for f in frames:
        obs.record_flush(f["rows"], f["requests"], f["dispatches"],
                         f["latency_ms"] / 1e3)
    summary = obs.summary()
    return {"flushes": len(frames),
            "flush_latency_ms": summary["flush_latency_ms"],
            "flush_latency_hist_ms": summary["flush_latency_hist_ms"],
            "flush_rows_hist": summary["flush_rows_hist"],
            "flush_rows_p50": summary["flush_rows_p50"]}


def phase_obs(torch, dev, smi, cfg, slice_result, trained,
              serve_async_broker) -> dict:
    """The telemetry layer on the card.  (a) compare("fifo") on the slice's
    config with obs_path: metrics apart from "obs" equal the slice phase's,
    exactly SCALAR_LAUNCHES forest_infer launches, the last ATLAS frame's
    predictor dispatches equal to them, and both frame files byte-equal to
    the same run's on the CPU (in a spawned process alongside).  (b) the
    serve_async spec through the broker executor with obs_dir and the
    async executor with obs_dir and obs_live to a separate
    ``python -m repro_torch.obs.live`` process, a poller chaining /delta
    mid-run: SWEEP.json without perf.obs equal to serve_async's broker
    bytes, every cell a source with frames on /snapshot, the polled seqs
    gapless, their replay through a fresh TelemetryCollector equal to the
    live aggregates, and the BrokerObserver's flushes equal to the grouped
    kernel's launches and the server's dispatches; the flush wall latency
    and row histograms.  (c) the NDJSON sink's overhead on the ATLAS run,
    gated at OBS_BUDGET, and the live tcp sink's beside it, not gated, in
    a process of its own (spawned at the start, readied during (a) and
    (b)).
    Returns the forest launches of (a) and (b)."""
    import concurrent.futures
    import multiprocessing
    import os
    import shutil
    import tempfile
    from repro_torch.cluster.experiment import compare
    from repro_torch.cluster.fleet import SweepSpec, run_sweep, sweep_json
    from repro_torch.kernels import ops
    from repro_torch.obs import TelemetryCollector, read_ndjson
    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    consumer = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.obs.live", "--device", str(dev),
         "--listen", "tcp://127.0.0.1:0", "--http", "127.0.0.1:0"],
        stdout=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    overhead_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        overhead_ready = overhead_pool.submit(_overhead_child_ready,
                                              str(dev))
        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            cpu_run = pool.submit(_cpu_compare, cfg,
                                  str(tmp / "cpu" / "slice.ndjson"))
            # (a)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            result = compare("fifo", dataclasses.replace(
                cfg, obs_path=str(tmp / "card" / "slice.ndjson")))
            torch.cuda.synchronize()
            t_compare = time.perf_counter() - t0
            launches_a = _forest_launches(torch)
            check(launches_a["forest_infer"] == SCALAR_LAUNCHES,
                  f"obs: compare launched forest_infer "
                  f"{launches_a['forest_infer']} times, not "
                  f"{SCALAR_LAUNCHES}")
            for run in ("base", "atlas"):
                check({k: v for k, v in result[run].items() if k != "obs"}
                      == slice_result[run], f"obs: compare's {run} metrics "
                      "differ from the slice phase's")
            check(result["deltas"] == slice_result["deltas"],
                  "obs: compare's deltas differ from the slice phase's")
            atlas_frames = read_ndjson(tmp / "card" / "slice__atlas.ndjson")
            last = [f for f in atlas_frames if f["type"] == "frame"][-1]
            check(last["pred"]["dispatches"] == SCALAR_LAUNCHES,
                  f"obs: the last frame counts {last['pred']['dispatches']}"
                  f" predictor dispatches, not {SCALAR_LAUNCHES}")
            # (b); the consumer's address is read after the broker run,
            # which overlaps its start-up
            spec = SweepSpec(**SERVE_ASYNC)
            want = sweep_json(serve_async_broker)
            runs, walls, launches_b, flush_lat = {}, {}, {}, {}
            addrs, poller = {}, None
            for name in ("broker", "async"):
                obs_dir = tmp / name
                kw = dict(executor=name)
                if name == "async":
                    addrs = json.loads(consumer.stdout.readline())
                    kw["obs_live"] = addrs["listen"]
                    poller = _DeltaPoller(addrs["http"]).start()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                runs[name] = run_sweep(spec, device=dev, obs_dir=str(obs_dir),
                                       log=lambda *a, **k: None, **kw)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
                launches_b[name] = _forest_launches(torch)
                block = runs[name]["perf"].pop("obs")
                check(sweep_json(runs[name]) == want, f"obs {name}: "
                      "SWEEP.json without perf.obs != serve_async's bytes")
                cell_ids = {c["cell_id"] for c in runs[name]["cells"]}
                check(set(block["cells"]) == cell_ids,
                      f"obs {name}: a cell without a roll-up")
                flushes = block["broker"]["broker.flushes"]
                dispatches = runs[name]["perf"]["broker"]["dispatches"]
                grouped = launches_b[name]["forest_infer_grouped"]
                check(flushes == grouped == dispatches > 0,
                      f"obs {name}: {flushes} observed flushes, {grouped} "
                      f"grouped launches, {dispatches} dispatches")
                flush_lat[name] = _flush_latency(obs_dir / "broker.ndjson")
                check(flush_lat[name]["flushes"] == flushes,
                      f"obs {name}: broker.ndjson frames != flushes")
                runs[name]["perf"]["obs"] = block
            seq = _settle(lambda: _get_json(addrs["http"] + "/snapshot")
                          ["seq"])
            poller.stop()
            snap = _get_json(addrs["http"] + "/snapshot")
            check(snap["seq"] == seq, "obs: frames still arriving")
            sources = {n: a["frames"] for n, a in snap["aggregates"].items()}
            check(set(sources) == cell_ids and all(sources.values()),
                  f"obs: /snapshot sources {sources} != the cells {cell_ids}")
            seqs = [e["seq"] for e in poller.entries]
            check(poller.resyncs == 0 and seqs == list(range(1, seq + 1)),
                  f"obs: polled deltas not gapless ({len(seqs)} entries, "
                  f"{poller.resyncs} resyncs, seq {seq})")
            replay = TelemetryCollector()
            for e in poller.entries:
                replay.ingest(e["frame"], source=e["source"])
            check(json.loads(json.dumps(replay.aggregates()))
                  == snap["aggregates"],
                  "obs: the polled deltas' replay != the live aggregates")
            t0 = time.perf_counter()
            cpu_result = cpu_run.result()
            waited_cpu = time.perf_counter() - t0
        check(cpu_result == result, "obs: card compare != CPU compare")
        for run in ("base", "atlas"):
            name = f"slice__{run}.ndjson"
            check((tmp / "card" / name).read_bytes()
                  == (tmp / "cpu" / name).read_bytes(),
                  f"obs: the card's {name} != the CPU's")
        t_ab = time.perf_counter() - t_phase
        # (c), in the process readied during (a) and (b)
        check(overhead_ready.result() == _device_name(torch, dev),
              "obs: the overhead process sees another device")
        run_cfg = dataclasses.replace(cfg, check_invariants=False,
                                      device=None)
        weights = trained.snapshot()
        (tmp / "overhead").mkdir()
        ndjson = overhead_pool.submit(
            _obs_overhead, run_cfg, weights, "ndjson", str(tmp / "overhead"),
            OBS_PAIRS["ndjson"], True, str(dev)).result()
        check(ndjson["overhead_frac"] <= OBS_BUDGET,
              f"obs: the NDJSON sink costs {ndjson['overhead_frac']:.2%} of "
              f"the ATLAS run in all {len(ndjson['attempts'])} attempts "
              f"(budget {OBS_BUDGET:.0%}; on the wall clock "
              f"{ndjson['attempts_wall']})")
        live = overhead_pool.submit(
            _obs_overhead, run_cfg, weights, "live_tcp", addrs["listen"],
            OBS_PAIRS["live_tcp"], False, str(dev), False).result()
    finally:
        overhead_pool.shutdown(cancel_futures=True)
        consumer.terminate()
        consumer.wait(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "obs", "nvidia_smi": smi, "fleet_size": FLEET,
          "compare_s": t_compare, "cpu_compare_waited_s": waited_cpu,
          "frames": {run: result[run]["obs"] for run in ("base", "atlas")},
          "frames_equal_cpu": True, "launches_compare": launches_a,
          "sweep": {"spec": runs["broker"]["spec"], "wall_s": walls,
                    "launches": launches_b,
                    "perf_obs_broker": runs["broker"]["perf"]["obs"]
                    ["broker"], "flush": flush_lat,
                    "sweep_equal_serve_async": True},
          "live": {"sources": sources, "seq": seq,
                   "polls": poller.polls, "delta_entries": len(seqs),
                   "frames_per_s": snap["health"]["frames_per_s"],
                   "gapless": True, "replay_equal": True},
          "overhead": {"ndjson": ndjson, "live_tcp": live},
          "phase_s": {"a_b": t_ab, "total": time.perf_counter() - t_phase}})
    return {k: launches_a[k] + launches_b["broker"][k]
            + launches_b["async"][k] for k in FOREST_KERNELS}


def phase_online_bench(torch, dev, smi) -> dict:
    """The online load bench on the card (run_bench_sizes at BENCH_SIZES,
    BENCH): every mode's outputs equal the numpy mirror, rows/s above 0,
    forest_infer launched once per predictor dispatch of run_scalar and
    forest_infer_grouped once per broker, saturated and open-loop flush
    dispatch.  Returns the forest launches."""
    from repro_torch.kernels import ops
    from repro_torch.online import bench, transport
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = bench.run_bench_sizes(BENCH_SIZES, device=dev, **BENCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _forest_launches(torch)
    sizes = summary["per_fleet_size"]
    check(sorted(sizes, key=int) == [str(n) for n in BENCH_SIZES],
          "online_bench: fleet sizes")
    scalar_dispatches = grouped_dispatches = 0
    record = {}
    for size, s in sizes.items():
        check(s["parity"] is True, f"online_bench n{size}: scalar, broker "
              "or saturated outputs != numpy mirror")
        check(sorted(s["open_loop"]) == list(OPEN_CONFIGS),
              f"online_bench n{size}: open-loop configs")
        for mode in ("scalar", "broker", "saturated"):
            check(s[mode]["rows_per_s"] > 0, f"online_bench n{size}: no "
                  f"{mode} throughput")
        check(s["scalar"]["rows"] == BENCH["rows"], "online_bench rows")
        # predict_batch once per request, then once per row
        scalar_dispatches += s["scalar"]["dispatches"] + s["scalar"]["rows"]
        grouped_dispatches += (s["broker"]["dispatches"]
                               + s["saturated"]["dispatches"])
        tails = {}
        for cfg, r in s["open_loop"].items():
            check(r["parity"] is True, f"online_bench n{size} {cfg}: "
                  "outputs != numpy mirror")
            check(r["rows_per_s"] > 0, f"online_bench n{size} {cfg}: no "
                  "throughput")
            grouped_dispatches += r["dispatches"]
            lm = r["latency_ms"]
            tails[cfg] = bool(lm["p99"] <= max(10.0 * lm["p50"],
                                               bench.P99_FLOOR_MS))
        record[size] = {
            "request_sizes": list(bench.request_sizes(int(size))),
            "requests": s["scalar"]["requests"],
            "rows_per_s": {m: s[m]["rows_per_s"]
                           for m in ("scalar", "broker", "saturated")},
            "per_decision_rows_per_s": s["scalar"]["per_decision_rows_per_s"],
            "broker": {k: s["broker"][k] for k in (
                "dispatches", "flushes", "max_flush_rows", "latency_ms")},
            "open_loop": {cfg: {k: r[k] for k in (
                "rate_rps", "requests", "rows_per_s", "latency_ms",
                "slo_violation_rate", "flushes", "max_flush_rows",
                "flush_causes")} for cfg, r in s["open_loop"].items()},
            "tail_budget_held": tails, "speedup": s["speedup"],
            "dispatch_reduction": s["dispatch_reduction"]}
    check(launches["forest_infer"] == scalar_dispatches,
          f"online_bench: {launches['forest_infer']} forest_infer launches, "
          f"{scalar_dispatches} predictor dispatches")
    check(launches["forest_infer_grouped"] == grouped_dispatches,
          f"online_bench: {launches['forest_infer_grouped']} "
          f"forest_infer_grouped launches, {grouped_dispatches} dispatches")
    emit({"phase": "online_bench", "nvidia_smi": smi, "wall_s": wall,
          "config": {**BENCH, "fleet_sizes": list(BENCH_SIZES)},
          "tcp_serializer": ("msgpack" if transport.msgpack is not None
                             else "json"),
          "parity": True, "launches": launches, "per_fleet_size": record})
    return launches


def phase_drift(torch, dev, smi) -> dict:
    """A drift-aware ATLAS run in parity's 100-node kitchen_sink cell, the
    predictor on the card and on the CPU from one CPU-trained start."""
    from repro_torch.cluster.experiment import run_baseline, run_scheduler
    from repro_torch.core.predictor import TaskPredictor
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(
        _slice_config(PARITY_FLEET, "cpu", KITCHEN_SINK), drift=True)
    _, trace, _ = run_baseline("fifo", cfg)
    trained = TaskPredictor(**_predictor_kw(cfg), device="cpu")
    check(trained.fit(trace), "drift: predictor fitted")
    metrics, events, secs = {}, {}, {}
    for run, where in (("cuda", dev), ("cpu", "cpu")):
        pred = TaskPredictor(**_predictor_kw(cfg), device=where)
        pred.load_snapshot(trained.snapshot())
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        metrics[run], _, sim = run_scheduler(
            "atlas-fifo", dataclasses.replace(cfg, device=where), pred)
        secs[run] = time.perf_counter() - t0
        if run == "cuda":
            launches = _forest_launches(torch)
        events[run] = sim.scheduler.refresher.events
        check(metrics[run]["invariant_violations"] == 0,
              f"drift {run}: invariant violations")
    check(metrics["cuda"] == metrics["cpu"], "drift: card run != CPU run")
    check(events["cuda"] == events["cpu"], "drift: refresh events differ")
    atlas = metrics["cuda"]["atlas"]
    check(atlas["refreshes"] > 0, "drift: no refresh")
    check(launches["forest_infer"] > 0, "drift: no forest_infer launch")
    emit({"phase": "drift", "nvidia_smi": smi, "fleet_size": PARITY_FLEET,
          "run_s": secs, "metrics_equal": True, "atlas": atlas,
          "events": {e: sum(x["event"] == e for x in events["cuda"])
                     for e in ("promote", "rollback", "skip")},
          "launches": launches})
    return launches


def phase_search(torch, dev, smi) -> dict:
    """The scenario-search smoke configuration on the card and on the
    CPU: equal results apart from provenance."""
    from repro_torch.cluster.search import SearchConfig, run_search
    from repro_torch.kernels import ops
    results, secs = {}, {}
    for run, where in (("cuda", dev), ("cpu", "cpu")):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results[run] = run_search(SearchConfig(**SEARCH_SMOKE), device=where,
                                  log=lambda *a, **k: None)
        secs[run] = time.perf_counter() - t0
        if run == "cuda":
            launches = _forest_launches(torch)
        results[run].pop("provenance")
    check(results["cuda"] == results["cpu"], "search: card != CPU result")
    evals = results["cuda"]["evals"]
    check(len(evals) == SEARCH_SMOKE["budget"], "search: evaluations missing")
    check(sum(e["violations"] for e in evals) == 0,
          "search: invariant violations")
    check(sum(e["checks"] for e in evals) > 0, "search: no invariant check")
    check(launches["forest_infer"] > 0, "search: no forest_infer launch")
    emit({"phase": "search", "nvidia_smi": smi, "run_s": secs,
          "regrets": [e["regret"] for e in evals],
          "best": {k: results["cuda"]["best"][k]
                   for k in ("i", "origin", "regret")},
          "launches": launches})
    return launches


# ---------------------------------------------------------------- training

def _train_cases(torch):
    """The three training kernels' cases: (kernel, shape, the Function's
    entry in ops, the plain version, the input maker, the work)."""
    from repro_torch.launch import cost
    from repro_torch.kernels import ops, ref

    def flash_inputs(gen, B, S, Skv, H, Hkv, D, causal, window, dtype, dev):
        q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, Skv, Hkv, D), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        return q, k, v

    out = []
    for name, case in TRAIN_FLASH_CASES.items():
        causal, window = case[6], case[7]
        out.append(("flash_attention", name, case,
                    lambda q, k, v, c=causal, w=window: ops.flash_attention(
                        q, k, v, causal=c, window=w),
                    lambda q, k, v, c=causal, w=window: ref.flash_attention_ref(
                        q, k, v, causal=c, window=w),
                    lambda gen, dt, dev, case=case: flash_inputs(
                        gen, *case, dt, dev),
                    lambda dname, case=case: cost.flash_work(*case,
                                                             dname)))
    out.append(("rwkv6_scan", "rwkv6", TRAIN_RWKV, ops.rwkv6_scan,
                ref.rwkv6_scan_ref,
                lambda gen, dt, dev: _rwkv_inputs(torch, gen, *TRAIN_RWKV,
                                                  dt, dev),
                lambda dname: cost.rwkv6_work(*TRAIN_RWKV, dname)))
    out.append(("mamba2_ssd", "zamba2", TRAIN_SSD, ops.mamba2_ssd,
                ref.mamba2_ssd_ref,
                lambda gen, dt, dev: _ssd_inputs(torch, gen, *TRAIN_SSD,
                                                 dt, dev),
                lambda dname: cost.ssd_work(*TRAIN_SSD, dname)))
    return out


def _outputs_and_grads(torch, fn, args, cots):
    """fn(*args)'s outputs and the gradients of sum(out * cot) with respect
    to every argument, through autograd."""
    leaves = [a.detach().requires_grad_() for a in args]
    with torch.enable_grad():
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
        grads = torch.autograd.grad(loss, leaves)
    return [o.detach() for o in outs], list(grads)


def phase_train_kernels(torch, dev):
    """The three training kernels under autograd at the training shapes,
    bf16: the Function's forward (the kernel; a launch per chunk for the
    scans) torch.equal to the bare kernel call on the whole input and
    within the kernel's bf16 tolerance of the plain version's outputs
    (attention ATTN_TOL; a scan's y SCAN_TOL, its final state STATE_TOL),
    and its gradients (the plain backward from the kernel's forward) within
    TRAIN_GRAD_TOL of autograd through the plain version on the same
    inputs and cotangents, each gradient relative to its largest plain
    magnitude; the shapes of TRAIN_FLASH_CASES (causal self-attention,
    the vlm's and whisper's non-causal cross-attention to more keys than
    queries, whisper's 1500 x 1500 encoder).  The plain backward keeps the
    float32 scores of a call: 360 MB at the encoder's shape.  Attention's
    backward recomputes the plain forward (in one block, where the plain
    version walks 512 x 512 chunks), so its gradients are the plain
    version's up to that chunking: its kernel is seen by the output check
    alone.  Times by CUDA events: the Function's forward alone and
    forward + backward (the plain backward's share is the difference),
    autograd through the plain version, and for attention
    scaled_dot_product_attention's forward + backward (a yardstick)."""
    from repro_torch.launch import cost
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(3)
    dtype, dname = torch.bfloat16, "bfloat16"
    timing, max_err, fwd_max = {}, {}, {}
    for kernel, case, shape, fn, plain, inputs, work in _train_cases(torch):
        args = inputs(gen, dtype, dev)
        with torch.no_grad():
            bare = fn(*args)
        bare = bare if isinstance(bare, tuple) else (bare,)
        cots = [torch.randn(o.shape, generator=gen, device=dev)
                for o in bare]
        outs, grads = _outputs_and_grads(torch, fn, args, cots)
        check(all(torch.equal(o, b) for o, b in zip(outs, bare)),
              f"{kernel} {case}: the Function's forward != the bare kernel")
        pouts, pgrads = _outputs_and_grads(torch, plain, args, cots)
        # attention's output at ATTN_TOL; a scan's y at SCAN_TOL and its
        # float32 final state at STATE_TOL (the scans' chunks launched from
        # the previous chunk's state)
        tols = ((ATTN_TOL[dname],) if kernel == "flash_attention"
                else (SCAN_TOL[dname], STATE_TOL))
        fwd_err = []
        for i, (o, p, tol) in enumerate(zip(outs, pouts, tols)):
            err = float((o.float() - p.float()).abs().max())
            check(bool(torch.isfinite(o).all()) and torch.allclose(
                o.float(), p.float(), rtol=tol, atol=tol),
                f"{kernel} {case}: output {i} is {err} from the plain "
                f"version's (tolerance {tol})")
            fwd_err.append(err)
        fwd_max[kernel] = max(fwd_max.get(kernel, 0.0), *fwd_err)
        errs = []
        for i, (g, p) in enumerate(zip(grads, pgrads)):
            scale = float(p.float().abs().max())
            err = float((g.float() - p.float()).abs().max())
            check(bool(torch.isfinite(g).all())
                  and err <= TRAIN_GRAD_TOL * max(scale, 1e-30),
                  f"{kernel} {case}: gradient {i} is {err} from the plain "
                  f"version's (largest {scale})")
            errs.append(err / max(scale, 1e-30))
        max_err[kernel] = max(max_err.get(kernel, 0.0), max(errs))

        def fwd():
            leaves = [a.detach().requires_grad_() for a in args]
            with torch.enable_grad():
                return fn(*leaves)

        def fwd_bwd(f=fn):
            _outputs_and_grads(torch, f, args, cots)
        rec = {"shape": shape, "max_abs_err": fwd_err,
               "relative_grad_err": errs,
               "forward_ms": _time_ms(torch, fwd, n=10, warmup=2),
               "ms": _time_ms(torch, fwd_bwd, n=10, warmup=2),
               "plain_ms": _time_ms(torch, lambda: fwd_bwd(plain), n=3,
                                    warmup=1)}
        rec["plain_backward_share"] = 1.0 - rec["forward_ms"] / rec["ms"]
        rec["bound_ms"], rec["bound_by"] = cost.bound_ms(*work(dname))
        rec["library_ms"] = None
        if kernel == "flash_attention":
            qkv = [a.transpose(1, 2) for a in args]

            def sdpa(causal=shape[6]):
                leaves = [a.detach().requires_grad_() for a in qkv]
                with torch.enable_grad():
                    o = F.scaled_dot_product_attention(
                        *leaves, is_causal=causal, enable_gqa=True)
                    torch.autograd.grad(o.float().sum(), leaves)
            rec["library_ms"] = _time_ms(torch, sdpa, n=10, warmup=2)
        timing[f"{kernel}/{case}"] = rec
        del args, bare, outs, grads, pouts, pgrads
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"phase": "train_kernels", "dtype": dname,
          "grad_tolerance": TRAIN_GRAD_TOL, "timing": timing,
          "max_abs_err": fwd_max, "max_relative_grad_err": max_err})
    return timing, fwd_max, max_err


def _train_launches(cfg, steps: int) -> dict:
    """Launches of ``steps`` train steps of ``cfg`` at TRAIN_BATCH x
    TRAIN_SEQ: every layer's kernels run once in the forward and once more
    when the layer is recomputed in the backward (remat "full"), per
    microbatch; the scans launch once per chunk of their sequence."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.lm import n_shared_invocations
    from repro_torch.models.steps import n_microbatches
    per = n_microbatches(cfg, TRAIN_BATCH) * (1 if cfg.remat == "none"
                                              else 2) * steps
    if cfg.family in ("dense", "moe", "vlm"):
        # one attention a layer: self, or a vlm cross block's to the media
        want = {"flash_attention": cfg.n_layers * per}
    elif cfg.family == "audio":
        # the encoder's self-attention, the decoder's self and cross
        want = {"flash_attention": (cfg.enc_dec.n_enc_layers
                                    + 2 * cfg.n_layers) * per}
    else:
        chunks = TRAIN_SEQ // ref.divisor_chunk(
            TRAIN_SEQ, ref.RWKV_CHUNK if cfg.family == "ssm"
            else ref.SSD_CHUNK)
        if cfg.family == "ssm":
            want = {"rwkv6_scan": cfg.n_layers * chunks * per}
        else:
            want = {"mamba2_ssd": cfg.n_layers * chunks * per,
                    "flash_attention": n_shared_invocations(cfg) * per}
    return {**dict.fromkeys(ops.KERNELS, 0), **want}


def _train_profile(torch, step_fn, state, batch) -> dict:
    """One more step under torch.profiler (device activity only): the
    card's idle share over it and its device time by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a recurrent step launches ~10^5 kernels: read the raw device events,
    # without building the profiler's per-event Python objects
    kinds, top = _by_kind(
        (e.name(), e.duration_ns() / 1e3)
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA)
    busy = sum(us for _, us in kinds.values()) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if kinds else None,
            "device_us": {k: {"n": n, "total_us": us}
                          for k, (n, us) in kinds.items()},
            "top_kernels_us": top}


def _first_gradients(torch, state, grad_norm, opt) -> dict:
    """What the first step's Adam moments say of its gradients: after one
    step m = (1 - b1) g_c and v = (1 - b2) g_c^2, g_c the gradient scaled by
    the clip, min(1, grad_clip / |g|).  The leaves whose gradient is not
    finite or all zero; the five largest gradient norms by leaf; and the
    share of elements whose clipped gradient is below Adam's eps, which move
    less than lr / 2 (at count 1 an element moves lr |g_c| / (|g_c| +
    eps))."""
    from repro_torch.parallel.axes import tree_leaves_with_path
    scale = min(1.0, opt.grad_clip / max(grad_norm, 1e-9)) \
        if opt.grad_clip > 0 else 1.0
    check(scale > 0, f"the first gradient norm {grad_norm} leaves AdamW's "
          "clip nothing of it")
    out = {"not_finite": [], "all_zero": [], "clip_scale": scale}
    norms, damped, total = {}, 0, 0
    for path, mom in tree_leaves_with_path(state["opt"]["m"]):
        name = "/".join(path)
        g_c = mom / (1 - opt.b1)
        if not bool(torch.isfinite(g_c).all()):
            out["not_finite"].append(name)
        elif not bool(g_c.any()):
            out["all_zero"].append(name)
        norms[name] = float(g_c.norm()) / scale
        damped += int((g_c.abs() < opt.eps).sum())
        total += g_c.numel()
    out["largest_norms"] = dict(sorted(norms.items(),
                                       key=lambda kv: -kv[1])[:5])
    out["adam_damped_share"] = damped / total
    return out


def _batch_loss(torch, cfg, params, tokens, ctx=None, media=None) -> float:
    """The train step's loss of ``tokens`` (and ``media``) at ``params``
    without a step: the microbatches' mean, under no_grad (the bare
    kernels, or the plain versions with ``ctx``)."""
    from repro_torch.models.layers import NO_SHARD
    from repro_torch.models.steps import n_microbatches, train_loss
    B = tokens.shape[0]
    A = n_microbatches(cfg, B)
    mbs = [None] * A if media is None else media.reshape(
        A, B // A, *media.shape[1:])
    with torch.no_grad():
        return float(sum(
            train_loss(cfg, params, mb.long(), ctx or NO_SHARD, media=md)[0]
            for mb, md in zip(tokens.reshape(A, B // A, -1), mbs)) / A)


def _fan_in_d_model(cfg, params):
    """Rescale, in place, seeded attention projections (self and cross, in
    every stacked block tree) from the reference's fan-in (the
    second-to-last axis, repro/parallel/axes.py:199: the heads of
    wq/wk/wv, the head dim of wo) to the fan-in of all their input axes
    (d_model; heads x head_dim for wo), the draw a 2-d (d_in, d_out)
    projection gets."""
    for stack in ("blocks", "enc_blocks", "dec_blocks"):
        for kind in ("attn", "xattn"):
            attn = params.get(stack, {}).get(kind)
            if attn is None:
                continue
            for name in ("wq", "wk", "wv"):    # (L, d_model, heads, hd)
                attn[name].mul_((attn[name].shape[-2] / cfg.d_model) ** 0.5)
            attn["wo"].mul_(attn["wo"].shape[-3] ** -0.5)   # (L, h, hd, d)


def _at_depth(cfg, depth: int):
    """``cfg`` with ``depth`` layers (the audio family: ``depth`` encoder
    and ``depth`` decoder layers)."""
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=depth, enc_dec=dataclasses.
                                   replace(cfg.enc_dec, n_enc_layers=depth))
    return dataclasses.replace(cfg, n_layers=depth)


def _cut_depth(cfg, params, depth: int):
    """``cfg`` and ``params`` cut to their first ``depth`` layers
    (_at_depth)."""
    from repro_torch.parallel.axes import tree_map
    stacks = (("enc_blocks", "dec_blocks") if cfg.family == "audio"
              else ("blocks",))
    return _at_depth(cfg, depth), {
        **params, **{k: tree_map(lambda t: t[:depth], params[k])
                     for k in stacks}}


def _first_grad_norm(torch, cfg, params, tokens, depth: int,
                     media=None) -> float:
    """The first step's gradient norm of ``cfg`` cut to its first
    ``depth`` layers (_cut_depth): the microbatches' gradients summed in
    float32 and divided by their count, as make_train_step does; the norm
    in float64 (its square can overflow float32)."""
    from repro_torch.models.steps import n_microbatches, train_loss
    from repro_torch.parallel.axes import tree_leaves, tree_unflatten
    cut, sub = _cut_depth(cfg, params, depth)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(sub)]
    B = tokens.shape[0]
    A = n_microbatches(cut, B)
    mds = [None] * A if media is None else media.reshape(
        A, B // A, *media.shape[1:])
    acc = [torch.zeros(p.shape, device=p.device) for p in leaves]
    for mb, md in zip(tokens.reshape(A, B // A, -1), mds):
        with torch.enable_grad():
            loss, aux = train_loss(cut, tree_unflatten(sub, leaves),
                                   mb.long(), media=md)
            grads = torch.autograd.grad(loss + aux, leaves,
                                        allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g.float())
    return float(torch.sqrt(sum(((a.double() / A) ** 2).sum()
                                for a in acc)))


def _grad_norms_by_init(torch, cfg, params, tokens, media=None) -> dict:
    """The first step's gradient norm at WITNESS_DEPTHS[cfg's arch] from
    the reference's init and from the same draw with its attention
    projections at the fan-in of their input axes; ``params`` is left
    rescaled (_fan_in_d_model).  Not counted in the launches."""
    depths = WITNESS_DEPTHS[cfg.name]
    norms = {}
    for init in ("reference", "fan_in_d_model"):
        if init == "fan_in_d_model":
            _fan_in_d_model(cfg, params)
        norms[init] = {d: _first_grad_norm(torch, cfg, params, tokens, d,
                                           media) for d in depths}
    return {"depths": list(depths), "first_grad_norm": norms}


def _init_witness(torch, dev, cfg, opt, batches) -> dict:
    """Why the loss of TRAIN_ARCH does not fall from the reference's init,
    measured: _grad_norms_by_init; then the train steps again from the
    second init, with the loss of batch 0 before each step and after the
    last.  Held: that run's loss falls from the first step to the last
    (the train path learns), on the stream and on batch 0.  Not counted
    in the launches."""
    from repro_torch.models.steps import init_train_state, make_train_step
    state = init_train_state(cfg, 0, opt, device=dev)
    witness = _grad_norms_by_init(torch, cfg, state["params"], batches[0])
    step_fn, _ = make_train_step(cfg, opt)
    losses, fixed = [], []
    for s in range(TRAIN_STEPS[cfg.name]):
        fixed.append(_batch_loss(torch, cfg, state["params"], batches[0]))
        state, m = step_fn(state, {"tokens": batches[s]})
        losses.append(float(m["loss"]))
    fixed.append(_batch_loss(torch, cfg, state["params"], batches[0]))
    del state
    torch.cuda.empty_cache()
    check(losses[-1] < losses[0] and fixed[-1] < fixed[0],
          f"train {cfg.name}: from the fan-in-d_model init the loss did not "
          f"fall (stream {losses}, batch 0 {fixed})")
    return {**witness, "fan_in_d_model_losses": losses,
            "fan_in_d_model_batch0_losses": fixed}


def _train_config(arch: str):
    """``arch`` at its published widths, cut to TRAIN_DEPTH where one card
    cannot hold a step of it whole."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if arch in TRAIN_DEPTH:
        cfg = _at_depth(cfg, TRAIN_DEPTH[arch])
    return cfg


def _train_opt(cfg, steps: int):
    """The trainer's AdamWConfig(warmup_steps=5, total_steps=steps), with
    bf16 moments where the config keeps them (cfg.opt_dtype)."""
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(warmup_steps=5, total_steps=steps,
                       moment_dtype="bf16" if cfg.opt_dtype == "bf16"
                       else "fp32")


def phase_train_step(torch, dev, arch: str) -> tuple:
    """``arch`` at full width (the depth of _train_config; bf16 weights,
    the config's moments) on the card: TRAIN_STEPS[arch] train steps of
    launch/train.py's global batch (16 x 256, the config's accum_steps;
    the audio family's 1500 frames a sequence from _seeded_media) from
    seeded weights under the trainer's AdamWConfig (_train_opt); the
    launch counts zeroed just before each step and read just after (the
    loss of batch 0 before each step and after the last, which tells the
    parameters' effect from the batches', runs outside them); the first
    step's loss against the same loss through the plain versions on the
    card; after the first step every parameter leaf's gradient (from its
    first moment, _first_gradients) finite and not all zero; for MoE the
    aux loss and the share of (token, expert) pairs each step drops at
    capacity_factor (_moe_tap, on a no-grad forward of the step's
    microbatches at the step's parameters, outside the step's time); then
    one profiled step.  Whether the loss
    fell is recorded, not held: from the reference's init TRAIN_ARCH's
    first gradient norm is ~6e10 at full depth, so with the clip at 1
    Adam leaves nearly every element in place; for TRAIN_ARCH,
    _init_witness measures that and holds that the same steps from an
    init with the attention projections' fan-in fixed do lower the
    loss.  The archs of FAN_IN_FIXED train from that fixed draw: from the
    reference's own init whisper-large-v3's first gradient norm overflows
    float32 (its first microbatch's is ~1e27 at full depth in float64), so
    the clip scales the gradient by 0; _grad_norms_by_init records the
    first microbatch's norm by depth from both draws."""
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import ops
    from repro_torch.models import get_model, param_count
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.steps import (init_train_state, make_train_step,
                                          n_microbatches)
    cfg = _train_config(arch)
    steps = TRAIN_STEPS[arch]
    opt = _train_opt(cfg, steps)
    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    batches = [torch.as_tensor(stream.batch(s, 0, 1)["tokens"], device=dev)
               for s in range(steps + 1)]
    media = _seeded_media(torch, get_model(cfg), TRAIN_BATCH, dev)

    def batch(s):
        return {"tokens": batches[s]} if media is None else {
            "tokens": batches[s], "media": media}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, 0, opt, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    witness = None
    if arch in FAN_IN_FIXED:      # on the first microbatch, for time
        n = TRAIN_BATCH // n_microbatches(cfg, TRAIN_BATCH)
        witness = _grad_norms_by_init(torch, cfg, state["params"],
                                      batches[0][:n],
                                      None if media is None else media[:n])
    plain_loss = _batch_loss(torch, cfg, state["params"], batches[0],
                             ShardCtx(impl="torch"), media)
    step_fn, _ = make_train_step(cfg, opt)
    losses, secs, norms, fixed, aux, dropped = [], [], [], [], [], []
    launches = dict.fromkeys(ops.KERNELS, 0)
    for s in range(steps):
        fixed.append(_batch_loss(torch, cfg, state["params"], batches[0],
                                 media=media))
        if cfg.family == "moe":     # the step's routing, outside its time
            with _moe_tap(torch, cfg) as counts:
                _batch_loss(torch, cfg, state["params"], batches[s],
                            media=media)
            dropped.append(sum(d for d, _ in counts)
                           / sum(p for _, p in counts))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch(s))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        for k, n in ops.launch_counts().items():
            launches[k] += n
        norms.append(float(m["grad_norm"]))
        aux.append(float(m["aux_loss"]))
        if s == 0:
            grads = _first_gradients(torch, state, norms[0], opt)
    fixed.append(_batch_loss(torch, cfg, state["params"], batches[0],
                             media=media))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _train_launches(cfg, steps)
    check(launches == want, f"train {arch}: launches {launches}, want {want}")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train {arch}: loss or grad norm not finite ({losses}, {norms})")
    check(not grads["not_finite"] and not grads["all_zero"],
          f"train {arch}: gradients not finite in {grads['not_finite']}, "
          f"all zero in {grads['all_zero']}")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    check(rel <= TRAIN_LOSS_RTOL, f"train {arch}: the first step's loss "
          f"{losses[0]} is {rel} from the plain versions' {plain_loss}")
    med = statistics.median(secs[1:] if len(secs) > 1 else secs)
    record = {"phase": TRAIN_PHASE[arch],
              "arch": arch, "n_layers": cfg.n_layers,
              "params": param_count(cfg), "steps": steps,
              "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
              "media": None if media is None else list(media.shape),
              "accum_steps": n_microbatches(cfg, TRAIN_BATCH),
              "remat": cfg.remat, "moment_dtype": opt.moment_dtype,
              "init_s": init_s,
              "state_gb": state_gb, "losses": losses, "grad_norms": norms,
              "aux_losses": aux, "batch0_losses": fixed,
              "loss_fell": losses[-1] < losses[0],
              "plain_first_loss": plain_loss,
              "first_loss_relative_gap": rel, "step_s": secs,
              "median_step_s": med,
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
              "peak_memory_gb": peak_gb, "launches": launches,
              "first_gradients": grads,
              "profiled_step": _train_profile(
                  torch, step_fn, state, batch(steps))}
    if cfg.family == "moe":
        record["moe"] = {"capacity_factor": cfg.moe.capacity_factor,
                         "dropped_share_per_step": dropped}
    if witness is not None:
        record["init"] = "fan_in_d_model"
        record["init_witness"] = witness
    del state
    torch.cuda.empty_cache()
    if arch == TRAIN_ARCH:
        record["init_witness"] = _init_witness(torch, dev, cfg, opt, batches)
    emit(record)
    del batches, media
    torch.cuda.empty_cache()
    return launches, record


def phase_train_vlm(torch, dev) -> dict:
    """TRAIN_VLM smoke-reduced (4 layers: two periods of a self block and
    a cross block), bf16 weights and moments, its gates opened to
    CROSS_GATE, at the full config's accum_steps (one sequence a
    microbatch), on the card: for each media dtype of TRAIN_VLM_MEDIA the
    data stream's batches (16 x 256 tokens, 16 media tokens a sequence,
    normal x 0.02) through make_train_step, 3 steps through the kernels
    and 3 through the plain versions (ctx impl "torch") from the same
    start.  Held: the
    kernel run's launches equal the derived count (float32 media make
    float32 keys, so the cross blocks run the float32 flash kernel on the
    queries cast up), every loss within TRAIN_LOSS_RTOL of the plain run's,
    every gradient leaf of the first step finite and not all zero.  The
    model cannot be trained at full width on one card (one period is
    5.3-6.4 B parameters, over 100 GB inside a step): train_kernels holds
    its full-width attention shapes.  Returns the two kernel runs'
    launches, summed."""
    from repro_torch.configs import get_arch, smoke_reduce
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import ops
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.steps import init_train_state, make_train_step
    full = get_arch(TRAIN_VLM)
    cfg = dataclasses.replace(smoke_reduce(full), dtype=torch.bfloat16,
                              opt_dtype=full.opt_dtype,
                              accum_steps=full.accum_steps)
    steps = 3
    opt = _train_opt(cfg, steps)
    out = {}
    stream = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0,
        media_shape=(cfg.cross_attn.n_media_tokens, cfg.d_model)))

    def batch(s, media_dtype):
        """The stream's batch s, its float32 media cast to media_dtype
        (numpy has no bf16)."""
        b = stream.batch(s, 0, 1)
        b["media"] = torch.as_tensor(b["media"]).to(
            getattr(torch, media_dtype))
        return b
    for media_dtype in TRAIN_VLM_MEDIA:
        start = init_train_state(cfg, 0, opt, device=dev)
        _open_gates(start["params"])
        runs = {}
        for impl in ("cuda", "torch"):
            step_fn, _ = make_train_step(cfg, opt, ShardCtx(impl=impl))
            state = start                  # a step updates nothing in place
            ops.reset_launch_counts()
            losses = []
            for s in range(steps):
                state, m = step_fn(state, batch(s, media_dtype))
                losses.append(float(m["loss"]))
                if s == 0:
                    grads = _first_gradients(torch, state,
                                             float(m["grad_norm"]), opt)
            runs[impl] = {"losses": losses, "launches": ops.launch_counts(),
                          "first_gradients": grads}
        want = _train_launches(cfg, steps)
        check(runs["cuda"]["launches"] == want, f"train_vlm {media_dtype}: "
              f"launches {runs['cuda']['launches']}, want {want}")
        check(not any(runs["torch"]["launches"].values()),
              f"train_vlm {media_dtype}: the plain run launched a kernel")
        gaps = [abs(a - b) / abs(b) for a, b in zip(
            runs["cuda"]["losses"], runs["torch"]["losses"])]
        check(all(np.isfinite(runs["cuda"]["losses"]))
              and max(gaps) <= TRAIN_LOSS_RTOL,
              f"train_vlm {media_dtype}: losses {runs['cuda']['losses']} "
              f"against the plain versions' {runs['torch']['losses']}")
        g = runs["cuda"]["first_gradients"]
        check(not g["not_finite"] and not g["all_zero"],
              f"train_vlm {media_dtype}: gradients not finite in "
              f"{g['not_finite']}, all zero in {g['all_zero']}")
        out[media_dtype] = {**runs, "loss_relative_gaps": gaps}
        del start, state
    torch.cuda.empty_cache()
    emit({"phase": "train_vlm", "arch": cfg.name, "n_layers": cfg.n_layers,
          "accum_steps": cfg.accum_steps, "global_batch": TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "gate": CROSS_GATE, "runs": out})
    return {k: sum(out[d]["cuda"]["launches"][k] for d in TRAIN_VLM_MEDIA)
            for k in out[TRAIN_VLM_MEDIA[0]]["cuda"]["launches"]}


def phase_compression(torch, dev) -> dict:
    """optim/compression.py on the card against the CPU: compress of a
    seeded COMPRESS_NUMEL-element gradient (float32 and bf16) gives
    torch.equal int8 values, float16 scales and residual on both devices;
    decompress likewise; compressed_psum on one process (a world of one)
    equals the dequantised gradient and the float32 residual of
    compressing g in float32.  Times compress and
    decompress by CUDA events (plain torch: the reference has no kernel
    for them)."""
    from repro_torch.optim import compression as cz
    gen = torch.Generator().manual_seed(5)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        g = (3.0 * torch.randn(COMPRESS_NUMEL, generator=gen)).to(dtype)
        g[:cz.BLOCK] = 0                     # an all-zero block
        cpu = cz.compress(g)
        card = cz.compress(g.to(dev))
        for name, a, b in zip(("q", "scale", "resid"), cpu, card):
            check(a.dtype == b.dtype and torch.equal(a, b.cpu()),
                  f"compression {dname}: {name} differs on the card")
        deq = cz.decompress(*card[:2], g.shape)
        check(torch.equal(deq.cpu(), cz.decompress(*cpu[:2], g.shape)),
              f"compression {dname}: decompress differs on the card")
        # compressed_psum quantises g in float32 and keeps a float32
        # residual
        _, _, resid32 = cz.compress(g.to(dev).float())
        summed, resid = cz.compressed_psum(g.to(dev))
        check(torch.equal(summed, deq) and torch.equal(resid, resid32),
              f"compression {dname}: compressed_psum on one process")
        gd = g.to(dev)
        rec[dname] = {
            "numel": COMPRESS_NUMEL,
            "compress_ms": _time_ms(torch, lambda: cz.compress(gd), n=10,
                                    warmup=2),
            "decompress_ms": _time_ms(torch, lambda: cz.decompress(
                *card[:2], g.shape), n=10, warmup=2),
            "max_abs_resid": float(card[2].float().abs().max())}
        del g, cpu, card, deq, summed, resid, resid32, gd
    torch.cuda.empty_cache()
    emit({"phase": "compression", "held": "torch.equal to the CPU", **rec})
    return rec


def phase_train_elastic(torch, dev) -> tuple:
    """repro_torch.launch.train.main on TRAIN_ARCH at full width, its depth
    cut to ELASTIC["layers"] (ATLAS on, the default fail rate) with its
    checkpoints under a temporary
    directory: every save and restore timed (bytes, seconds) through the
    CheckpointManager the trainer uses; the launch counts zeroed just
    before and read just after; at least ELASTIC["steps"] committed steps
    and a finite last loss (whether it is below the first is recorded, see
    phase_train_step); a restore with its digests checked: the
    trainer's own if chaos rolled it back, else the last checkpoint
    restored after the run and held torch.equal to the state it saved."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    saves, restores, last = [], [], {}
    orig_save, orig_restore = CheckpointManager.save, CheckpointManager.restore

    def save(self, step, tree, *, block=False):
        t0 = time.perf_counter()
        orig_save(self, step, tree, block=block)
        self.wait()
        d = self.root / f"step_{step:09d}"
        saves.append({"step": step, "s": time.perf_counter() - t0,
                      "bytes": sum(p.stat().st_size for p in d.iterdir())})
        last.update(root=self.root, step=step, tree=tree)

    def restore(self, step, like_tree, **kw):
        t0 = time.perf_counter()
        out = orig_restore(self, step, like_tree, **kw)
        torch.cuda.synchronize()
        restores.append({"step": step, "s": time.perf_counter() - t0,
                         "verified": kw.get("verify", True)})
        return out

    with tempfile.TemporaryDirectory() as td:
        free_gb = shutil.disk_usage(td).free / 1e9
        argv = ["--arch", TRAIN_ARCH, "--full-config", "--steps",
                str(ELASTIC["steps"]), "--checkpoint-every",
                str(ELASTIC["checkpoint_every"]), "--layers",
                str(ELASTIC["layers"]), "--checkpoint-dir", td]
        CheckpointManager.save, CheckpointManager.restore = save, restore
        try:
            ops.reset_launch_counts()
            with contextlib.redirect_stdout(sys.stderr):
                out = train.main(argv)
            launches = ops.launch_counts()
        finally:
            CheckpointManager.save = orig_save
            CheckpointManager.restore = orig_restore
        from repro_torch.configs import get_arch
        want = _train_launches(dataclasses.replace(
            get_arch(TRAIN_ARCH), n_layers=ELASTIC["layers"]),
            out["committed"])
        check(launches == want, f"train_elastic: launches {launches}, want "
              f"{want}")
        check(out["committed"] >= ELASTIC["steps"]
              and np.isfinite(out["final_loss"]), f"train_elastic: {out}")
        check(bool(saves), "train_elastic: no checkpoint was written")
        after_run = None
        if not restores:
            mgr = CheckpointManager(last["root"], keep=2, async_write=False)
            t0 = time.perf_counter()
            got = mgr.restore(last["step"], last["tree"])
            torch.cuda.synchronize()
            from repro_torch.parallel.axes import tree_leaves
            equal = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(last["tree"])))
            after_run = {"step": last["step"], "s": time.perf_counter() - t0,
                         "verified": True, "equal": equal}
            check(equal, "train_elastic: the restored checkpoint != the "
                  "state the trainer saved")
            del got
        last.clear()
    emit({"phase": "train_elastic", "argv": argv, "result": out,
          "loss_fell": out["final_loss"] < out["first_loss"],
          "disk_free_gb": free_gb,
          "saves": saves, "restores": restores,
          "restore_after_run": after_run, "launches": launches})
    torch.cuda.empty_cache()
    return launches


def _tensor_cores(build: dict, kernel: str):
    """The build phase's SASS counts of ``kernel``'s instantiations."""
    tc = build["tensor_core_instructions"]
    if not isinstance(tc, dict):
        return tc
    return {n: c for n, c in tc.items() if n.startswith(kernel)}


def start_dryrun_grid():
    """Start tracing launch/dryrun.py's pod16x16 grid in DRYRUN_JOBS spawned
    processes (host work on meta tensors); ``phase_dryrun`` collects it.
    Returns (pool, futures by cell, records directory, start time)."""
    import concurrent.futures
    import multiprocessing
    import tempfile
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun
    out = tempfile.TemporaryDirectory(prefix="dryrun_torch_")
    pool = concurrent.futures.ProcessPoolExecutor(
        DRYRUN_JOBS, mp_context=multiprocessing.get_context("spawn"))
    futures = {(a, s): pool.submit(dryrun.run_cell, a, s, force=True,
                                   verbose=False, out_dir=out.name)
               for a in ARCH_IDS for s in SHAPES}
    return pool, futures, out, time.perf_counter()


def phase_dryrun(grid) -> dict:
    """The pod16x16 grid's records: no cell in error and none refused (a
    kernel refusing a shape a step gives it; since both attention kernels
    take stablelm-12b's head_dim 160, every traced cell is ok), the skipped
    cells exactly the long_500k cells of the full-attention archs (the
    reference's split: 32 traced, 8 skipped); each cell's status, trace_s,
    FLOPs and temporaries."""
    from repro_torch.configs import SHAPES, cell_supported, get_arch
    pool, futures, out, t0 = grid
    try:
        recs = {cell: f.result() for cell, f in futures.items()}
    finally:
        pool.shutdown()
        out.cleanup()
    wall = time.perf_counter() - t0
    errors = {f"{a} x {s}": r["error"] for (a, s), r in recs.items()
              if r["status"] == "error"}
    check(not errors, f"dryrun: cells in error: {errors}")
    skipped = {cell for cell, r in recs.items() if r["status"] == "skipped"}
    want = {(a, s) for a, s in recs
            if not cell_supported(get_arch(a), SHAPES[s])[0]}
    check(skipped == want and all(s == "long_500k" for _, s in skipped),
          f"dryrun: skipped {sorted(skipped)}, want {sorted(want)}")
    status = {k: sum(r["status"] == k for r in recs.values())
              for k in ("ok", "refused", "skipped", "error")}
    refused = {f"{a} x {s}": r["refused"] for (a, s), r in recs.items()
               if r["status"] == "refused"}
    check(not refused, f"dryrun: cells refused: {refused}")
    cells = {f"{a} x {s}": {
        "status": r["status"], "trace_s": r.get("trace_s"),
        "flops": r.get("cost", {}).get("flops"),
        "temp_bytes": r.get("memory", {}).get("temp_bytes"),
        "argument_bytes": r.get("memory", {}).get("argument_bytes"),
        "refused": r.get("refused")} for (a, s), r in recs.items()}
    emit({"phase": "dryrun", "mesh": "pod16x16", "jobs": DRYRUN_JOBS,
          "wall_s_from_start": wall, "status": status, "cells": cells})
    return status


def _real_args(torch, arch, shape, dev) -> tuple:
    """A cell's arguments on the card, from seeds: the train state (seeded
    weights, zero moments) and tokens; or the weights and tokens; or the
    weights, a zero cache of seq_len, one token a sequence and pos =
    seq_len - 1 (a full cache)."""
    from repro_torch.models import get_model
    from repro_torch.models.steps import init_train_state
    from repro_torch.optim import adamw
    B, S = shape.global_batch, shape.seq_len
    gen = torch.Generator(device=dev).manual_seed(0)

    def tokens(*dims):
        return torch.randint(0, arch.vocab_size, dims, generator=gen,
                             dtype=torch.int32, device=dev)
    model = get_model(arch)
    if shape.kind == "train":
        opt = adamw.AdamWConfig(
            moment_dtype="bf16" if arch.opt_dtype == "bf16" else "fp32")
        return init_train_state(arch, 0, opt, device=dev), \
            {"tokens": tokens(B, S)}
    params = model.init(0, device=dev)
    if shape.kind == "prefill":
        return params, {"tokens": tokens(B, S)}
    return (params, model.init_cache(B, S, device=dev), tokens(B, 1),
            torch.full((B,), S - 1, dtype=torch.int32, device=dev))


def _fitting_cell(arch, shape, mesh) -> tuple:
    """(shape, cell, counts, cuts): the cell's dry run, whole if its
    arguments plus temporaries fit one card, else at the largest
    power-of-two global batch whose dry run fits (the guess: the
    arguments kept, the temporaries scaled with the batch)."""
    from repro_torch.launch import cost, dryrun
    cuts = []
    cell, counted = dryrun.trace_cell(arch, shape, mesh)
    while True:
        args = cost.tree_bytes(cell["args"])
        need = args + counted["temp_bytes"]
        if need <= cost.HBM_BYTES:
            return shape, cell, counted, cuts
        B = shape.global_batch
        guess = max(1, int(B * (cost.HBM_BYTES - args)
                           / counted["temp_bytes"]))
        new_B = min(B // 2, 1 << (guess.bit_length() - 1))
        check(new_B >= 1, f"dryrun_cells: {arch.name} x {shape.name} does "
              "not fit one card at batch 1")
        cuts.append({"global_batch": B, "bytes": need})
        shape = dataclasses.replace(shape, global_batch=new_B)
        cell, counted = dryrun.trace_cell(arch, shape, mesh)


def phase_dryrun_cells(torch, dev) -> dict:
    """DRYRUN_CELLS on one card: each cell's dry run on meta (h100x1;
    batch cut to fit, every cut listed), then its step on the card under
    the same counting mode, launch counts zeroed just before and read just
    after: launches equal to ops.launch_counts() and to the dry run's, the
    arguments' bytes, FLOPs equal on meta and on the card, the predicted
    peak within DRYRUN_PEAK_TOL of max_memory_allocated (both recorded),
    every output finite; the step's time is that run's (the counting
    mode's host work on every aten op inside it).  Returns {path:
    launches}."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import one_card_mesh
    mesh = one_card_mesh()
    by_path, recs = {}, {}
    torch.cuda.empty_cache()
    for arch_id, shape_id in DRYRUN_CELLS:
        name = f"{arch_id} x {shape_id}"
        arch = get_arch(arch_id)
        t0 = time.perf_counter()
        shape, cell, meta, cuts = _fitting_cell(arch, SHAPES[shape_id], mesh)
        trace_s = time.perf_counter() - t0
        predicted = cost.tree_bytes(cell["args"]) + meta["temp_bytes"]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        args = _real_args(torch, arch, shape, dev)
        arg_bytes = cost.tree_bytes(args)
        check(arg_bytes == cost.tree_bytes(cell["args"]),
              f"dryrun_cells {name}: arguments {arg_bytes} bytes on the "
              f"card, {cost.tree_bytes(cell['args'])} in the dry run")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        real = cost.count(cell["fn"], *args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - before
        outs = [t for t in cost.tensors(real["outputs"])
                if t.is_floating_point()]
        check(all(bool(torch.isfinite(t).all()) for t in outs),
              f"dryrun_cells {name}: an output is not finite")
        del real["outputs"], outs
        for k in ops.KERNELS:
            n_meta = meta["kernels"][k]["launches"]
            n_real = real["kernels"][k]["launches"]
            check(n_meta == n_real == launches[k],
                  f"dryrun_cells {name}: {k} launched {launches[k]} times, "
                  f"counted {n_real} on the card and {n_meta} on meta")
        check(any(launches.values()),
              f"dryrun_cells {name}: no kernel launched")
        check(real["flops"] == meta["flops"],
              f"dryrun_cells {name}: {real['flops']} FLOP on the card, "
              f"{meta['flops']} on meta")
        gap = abs(predicted - peak) / peak
        check(gap <= DRYRUN_PEAK_TOL,
              f"dryrun_cells {name}: predicted peak {predicted} bytes, "
              f"{peak} measured ({gap:.3f} off)")
        del args
        torch.cuda.empty_cache()
        path = f"dryrun_cells/{arch_id}/{shape_id}"
        by_path[path] = launches
        recs[name] = {
            "global_batch": shape.global_batch, "seq_len": shape.seq_len,
            "cuts": cuts, "trace_s": trace_s, "launches": launches,
            "argument_bytes": arg_bytes, "temp_bytes": meta["temp_bytes"],
            "predicted_peak_bytes": predicted, "measured_peak_bytes": peak,
            "peak_gap": gap, "flops": meta["flops"],
            "traffic_bytes": meta["traffic_bytes"],
            "kernel_bound_ms": {k: v["bound_ms"]
                                for k, v in meta["kernels"].items()
                                if v["launches"]},
            "step_s": step_s, "tflop_s": meta["flops"] / step_s / 1e12,
            "left_allocated_bytes": torch.cuda.memory_allocated() - before,
            "refused": {k: v["refused"] for k, v in meta["kernels"].items()
                        if v["refused"]}}
    emit({"phase": "dryrun_cells", "mesh": mesh.name,
          "peak_tol": DRYRUN_PEAK_TOL, "hbm_bytes": cost.HBM_BYTES,
          "cells": recs})
    return by_path


def _merged_slices(torch, q, k, v, kv_len, slices, window, impl):
    """The partial mode (or its plain version) on each of ``slices``
    slices of the cache, merged (ref.merge_partials); and the partials."""
    from repro_torch.kernels import ops, ref
    Smax = k.shape[1]
    bounds = [Smax * r // slices for r in range(slices + 1)]
    parts = [ops.decode_attention_partial(
        q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(), kv_len,
        start=lo, window=window, impl=impl)
        for lo, hi in zip(bounds, bounds[1:])]
    o, m, l = (torch.stack(x) for x in zip(*parts))
    return ref.merge_partials(m, l, o), parts


def phase_sharded_kernels(torch, dev) -> tuple:
    """The decode kernel's partial mode against its plain version and the
    whole-cache kernel (SHARD_DECODE_CASES x SHARD_WINDOWS x
    SHARD_SLICES, bf16): every slice's (o, m, l) (the same slices empty,
    m and l within ATTN_TOL elsewhere), the merged output within ATTN_TOL
    of the plain version's merge and of the whole-cache kernel, finite.
    Timed without a window: one slice's call (CUDA events, device ms under
    torch.profiler, the plain partial's ms, the bound by
    launch/cost.py:decode_partial_work) and the merge.  Returns ({case:
    {slices: timing}}, {case: max abs err})."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import cost
    gen = torch.Generator(device=dev).manual_seed(5)
    tol = ATTN_TOL["bfloat16"]
    errs, timing = {}, {}

    def close(a, b, what):
        err = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        check(bool(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)),
              f"sharded: {what} (max abs err {err})")
        return err

    for case, ((B, Smax, H, Hkv, D), lens) in SHARD_DECODE_CASES.items():
        timing[case], max_err = {}, 0.0
        q = torch.randn(B, 1, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Smax, Hkv, D, generator=gen,
                        device=dev).bfloat16()
        v = torch.randn(B, Smax, Hkv, D, generator=gen,
                        device=dev).bfloat16()
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        for window in SHARD_WINDOWS:
            whole = ops.decode_attention(q, k, v, kv_len, window=window,
                                         impl="cuda")
            for n in SHARD_SLICES:
                what = f"{case} window {window} {n} slices"
                got, parts = _merged_slices(torch, q, k, v, kv_len, n,
                                            window, "cuda")
                want, plain_parts = _merged_slices(torch, q, k, v, kv_len, n,
                                                   window, "torch")
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"sharded: {what}: not finite")
                for r, ((o, m, l), (po, pm, pl)) in enumerate(
                        zip(parts, plain_parts)):
                    empty = torch.isneginf(pm)
                    check(torch.equal(torch.isneginf(m), empty)
                          and torch.equal(l == 0, pl == 0)
                          and bool((o[empty[:, None, :]] == 0).all()),
                          f"sharded: {what}: slice {r}'s empty rows differ")
                    max_err = max(max_err, close(m[~empty], pm[~empty],
                                                 f"{what}: slice {r}'s m"))
                    close(l / pl.clamp(min=1e-30), (~empty).float(),
                          f"{what}: slice {r}'s l")
                max_err = max(max_err, close(got, want, f"{what}: merged"),
                              close(got.bfloat16(), whole,
                                    f"{what}: against the whole cache"))
                if window:
                    continue
                lo, hi = 0, Smax // n
                ks, vs = k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous()

                def kernel():
                    return ops.decode_attention_partial(q, ks, vs, kv_len,
                                                        start=lo,
                                                        impl="cuda")
                o, m, l = (torch.stack(x) for x in zip(*parts))
                timing[case][n] = {
                    "slice_rows": hi - lo, "ms": _time_ms(torch, kernel),
                    "device_ms": _kernel_device_ms(torch, kernel,
                                                   "decode_attention"),
                    "plain_ms": _time_ms(
                        torch, lambda: ops.decode_attention_partial(
                            q, ks, vs, kv_len, start=lo, impl="torch"),
                        n=20),
                    "merge_ms": _time_ms(
                        torch, lambda: ref.merge_partials(m, l, o), n=20),
                    "library_ms": None}
                timing[case][n]["bound_ms"], timing[case][n]["bound_by"] = \
                    cost.bound_ms(*cost.decode_partial_work(
                        B, hi - lo, H, Hkv, D, 0, list(lens), lo,
                        "bfloat16"))
            del whole
        errs[case] = max_err
        del q, k, v
    # zamba2's 4 GB operands leave large cached blocks that a later
    # phase's allocations would fragment
    torch.cuda.empty_cache()
    emit({"phase": "sharded_kernels", "cases": SHARD_DECODE_CASES,
          "windows": SHARD_WINDOWS, "slices": SHARD_SLICES,
          "timing": timing, "max_abs_err": errs})
    return timing, errs


def _leaf(tree, path):
    """tree[path[0]][path[1]]...: one leaf of a nested dict."""
    for key in path:
        tree = tree[key]
    return tree


def _nccl_group(torch):
    """A process group of one over NCCL (tcp on localhost, a free port)."""
    import datetime
    import socket
    import torch.distributed as dist
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    return dist


def phase_sharded_steps(torch, dev) -> dict:
    """SHARD_CELLS through parallel/partition.py:run_cell on h100x1 over
    NCCL, each against the same cell's step unpartitioned on the same
    arguments (a copy of the cache the decode writes into): launch counts
    zeroed just before each run and read just after, equal but for the
    decode, whose partitioned run launches the partial mode where the
    unpartitioned one launches the whole-cache kernel (as often).  Train:
    the loss and the grad norm within TRAIN_LOSS_RTOL, and for
    SHARD_TRAIN_LEAVES the first moment (its largest gap within
    TRAIN_LOSS_RTOL of its largest value) and the updated weights
    (elementwise within TRAIN_LOSS_RTOL, atol TRAIN_PARAM_ATOL).  Prefill
    and decode: next tokens equal, logits within ATTN_TOL, the prefill's
    cache within ATTN_TOL.  Both runs' seconds.  Returns {path: launches
    of the partitioned run}."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import device_mesh, one_card_mesh
    from repro_torch.parallel.partition import gather_tree, run_cell
    dist = _nccl_group(torch)
    mesh = one_card_mesh()
    by_path, recs = {}, {}
    try:
        dm = device_mesh(mesh, dev)
        for arch_id, shape_id, batch in SHARD_CELLS:
            arch = get_arch(arch_id)
            shape = SHAPES[shape_id] if batch is None else \
                dataclasses.replace(SHAPES[shape_id], global_batch=batch)
            cell = specs.build_cell(arch, shape, mesh)
            args = _real_args(torch, arch, shape, dev)

            def fresh():
                """The arguments, with its own copy of a decode's cache."""
                if shape.kind != "decode":
                    return args
                return (args[0], {n: t.clone() for n, t in args[1].items()},
                        *args[2:])
            runs = {}
            for name, run in (
                    ("plain", lambda a: cell["fn"](*a)),
                    ("partitioned",
                     lambda a: gather_tree(run_cell(cell, dm, args=a)))):
                a = fresh()
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                out = run(a)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = ops.launch_counts()
                if shape.kind == "train":
                    keep = {"loss": float(out[1]["loss"]),
                            "grad_norm": float(out[1]["grad_norm"]),
                            "leaves": {"/".join(path): (
                                _leaf(out[0]["params"], path).cpu(),
                                _leaf(out[0]["opt"]["m"], path).cpu())
                                for path in SHARD_TRAIN_LEAVES}}
                elif shape.kind == "prefill":
                    keep = {"next": out[0].argmax(-1).cpu(),
                            "logits": out[0].float(), "cache": out[1]}
                else:
                    keep = {"next": out[0].cpu(), "logits": out[1].float()}
                del out, a
                torch.cuda.empty_cache()
                runs[name] = {"s": seconds, "launches": launches, **keep}
            name = f"{arch_id} x {shape_id}"
            plain, part = runs["plain"]["launches"], \
                runs["partitioned"]["launches"]
            want = dict(plain)
            if shape.kind == "decode":
                want["decode_attention_partial"] = want["decode_attention"]
                want["decode_attention"] = 0
            check(part == want and any(part.values()),
                  f"sharded {name}: launches {part}, unpartitioned {plain}")
            check(shape.kind != "decode" or part["decode_attention_partial"],
                  f"sharded {name}: the partial mode never launched")
            rec = {"global_batch": shape.global_batch,
                   "seq_len": shape.seq_len,
                   **{f"{k}_s": runs[k]["s"] for k in runs},
                   "launches": part}
            if shape.kind == "train":
                got, want = runs["partitioned"], runs["plain"]
                for key in ("loss", "grad_norm"):
                    a, b = got[key], want[key]
                    check(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b),
                          f"sharded {name}: {key} {a}, unpartitioned {b}")
                    rec[key], rec[f"{key}_unpartitioned"] = a, b
                for leaf, (p, m) in got["leaves"].items():
                    wp, wm = want["leaves"][leaf]
                    p, m, wp, wm = (t.to(dev).float() for t in (p, m, wp, wm))
                    m_gap = float((m - wm).abs().max())
                    m_scale = float(wm.abs().max())
                    check(m_gap <= TRAIN_LOSS_RTOL * m_scale,
                          f"sharded {name}: {leaf}'s first moment {m_gap} "
                          f"apart, its largest {m_scale}")
                    check(bool(torch.allclose(p, wp, rtol=TRAIN_LOSS_RTOL,
                                              atol=TRAIN_PARAM_ATOL)),
                          f"sharded {name}: {leaf}'s updated weights differ")
                    rec[f"{leaf}/m_max_abs_gap"] = m_gap
                    rec[f"{leaf}/m_max_abs"] = m_scale
                    rec[f"{leaf}/weights_max_abs_gap"] = float(
                        (p - wp).abs().max())
                    # the share of the weights the step moved
                    rec[f"{leaf}/weights_moved"] = float((wp != _leaf(
                        args[0]["params"], leaf.split("/")).float())
                        .float().mean())
                    del p, m, wp, wm
            else:
                check(torch.equal(runs["partitioned"]["next"],
                                  runs["plain"]["next"]),
                      f"sharded {name}: next tokens differ")
                gap = float((runs["partitioned"]["logits"]
                             - runs["plain"]["logits"]).abs().max())
                check(gap <= ATTN_TOL["bfloat16"],
                      f"sharded {name}: logits {gap} apart")
                rec["logits_max_abs_gap"] = gap
            if shape.kind == "prefill":
                got, want = runs["partitioned"]["cache"], \
                    runs["plain"]["cache"]
                check(got.keys() == want.keys(),
                      f"sharded {name}: cache {sorted(got)}, unpartitioned "
                      f"{sorted(want)}")
                # a layer at a time: the whole cache in float32 would not
                # fit beside the two in bf16
                gaps = {n: max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got[n], want[n]))
                        for n in want}
                check(max(gaps.values()) <= ATTN_TOL["bfloat16"]
                      and all(bool(torch.isfinite(t).all())
                              for t in got.values()),
                      f"sharded {name}: caches apart by {gaps}")
                rec["cache_max_abs_gap"] = gaps
            recs[name] = rec
            by_path[f"sharded/{arch_id}/{shape_id}"] = part
            # the prefill's two caches (25.8 GB) must not outlive the cell
            args = runs = keep = got = want = None
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    emit({"phase": "sharded", "mesh": mesh.name, "backend": "nccl",
          "cells": recs})
    return by_path


def phase_examples() -> dict:
    """EXAMPLES, each ``python examples/<name>.py`` in a process of its
    own on the card, all started together (quickstart's checkpoints in a
    temporary directory): every exit code 0 and the example's own line
    printed; the seconds by which each had ended, and its last lines."""
    import tempfile
    runs, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        t0 = time.perf_counter()
        for name, args in EXAMPLES.items():
            extra = ("--ckpt", tmp) if name == "torch_quickstart" else ()
            cmd = [sys.executable, str(ROOT / "examples" / f"{name}.py"),
                   *args, *extra]
            runs[name] = (subprocess.Popen(cmd, cwd=ROOT, text=True,
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE), cmd)
        try:
            for name, (proc, cmd) in runs.items():
                stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
                lines = stdout.splitlines()
                out[name] = {"argv": cmd[2:], "returncode": proc.returncode,
                             "ended_by_s": time.perf_counter() - t0,
                             "last_lines": lines[-12:]}
                check(proc.returncode == 0,
                      f"examples: {name} exited {proc.returncode}:\n"
                      f"{stderr[-3000:]}")
                check(any(EXAMPLE_MARK[name] in ln for ln in lines),
                      f"examples: {name} did not print "
                      f"{EXAMPLE_MARK[name]!r}")
        finally:                        # no example outlives the phase
            for proc, _ in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    emit({"phase": "examples", "wall_s": time.perf_counter() - t0,
          "runs": out})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every record to this file")
    ap.add_argument("--timing", choices=("forest", "scan", "serve", "decode"),
                    help="only time these kernels (forest_timing at "
                    "TIMED_ROWS, scan_timing, or decode_timing) or "
                    "serving's decode (serve_timing) and print the timing "
                    "as the last JSON line")
    ap.add_argument("--src", type=pathlib.Path, default=SRC,
                    help="with --timing: the src/ tree to import the port "
                    "from, e.g. an older version from git archive")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    src = args.src.resolve() if args.timing else SRC
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    dev = torch.device("cuda")
    if args.timing:
        smi = phase_device(torch)
        if args.timing == "scan":
            timed = scan_timing(torch, dev)
        elif args.timing == "serve":
            timed = serve_timing(torch, dev)
        elif args.timing == "decode":
            timed = decode_timing(torch, dev)
        else:
            _, rf, rows = _forest_fixtures(torch, dev)
            timed = {B: forest_timing(torch, dev, rf, rows[:B])
                     for B in TIMED_ROWS}
        print(json.dumps({"timing": args.timing, "src": str(src),
                          "nvidia_smi": smi, "result": timed}), flush=True)
        return 0
    t_start = time.perf_counter()
    smi = phase_device(torch)
    build = phase_build()
    timing = phase_kernels(torch, dev)
    cfg, base, trained, fit_data = phase_fit(torch, dev)
    launches, flush_rows, slice_result = phase_slice(torch, dev, cfg, base,
                                                     trained)
    for k, rec in phase_flush_kernels(torch, dev, flush_rows).items():
        timing[k][flush_rows] = rec
    main_rows = {"forest_infer": 13, "forest_infer_grouped": flush_rows}
    max_err = FOREST_HELD["max_abs_err"]
    emit({"phase": "kernels", "held": "torch.equal to plain and numpy",
          **FOREST_HELD})
    phase_parity(torch, dev)
    device_us = phase_trace(torch, dev, cfg, trained)
    attn_timing, attn_err = phase_attn_kernels(torch, dev)
    phase_serve_parity(torch, dev)
    serve_launches, serve_device_ms = phase_serve(torch, dev)
    head160_launches, head160_ms = phase_serve_stablelm12b(torch, dev)
    scan_times, scan_err, scan_state_err = phase_scan_kernels(torch, dev)
    phase_recurrent_serve_parity(torch, dev)
    recurrent = {arch: phase_serve_recurrent(torch, dev, arch)
                 for arch in RECURRENT_ARCHS}
    rwkv_launches, rwkv_ms, _ = recurrent["rwkv6-1.6b"]
    zamba_launches, zamba_ms, _ = recurrent["zamba2-1.2b"]
    phase_family_serve_parity(torch, dev)
    family = {FAMILY_PHASE[arch]: phase_serve_family(torch, dev, arch)
              for arch in FAMILY_ARCHS}
    by_path = {"slice": launches}
    by_path["cv"] = phase_cv(torch, dev, smi, fit_data[0])
    by_path.update(phase_sweep(torch, dev, smi))
    by_path["drift"] = phase_drift(torch, dev, smi)
    by_path["search"] = phase_search(torch, dev, smi)
    by_path["serve_async"], serve_async_broker = phase_serve_async(
        torch, dev, smi)
    by_path["obs"] = phase_obs(torch, dev, smi, cfg, slice_result, trained,
                               serve_async_broker)
    by_path["online_bench"] = phase_online_bench(torch, dev, smi)
    grid = start_dryrun_grid()
    try:
        train_timing, train_fwd_err, train_err = phase_train_kernels(torch,
                                                                     dev)
        train_paths = {TRAIN_PHASE[arch]: phase_train_step(torch, dev,
                                                           arch)[0]
                       for arch in TRAIN_ARCHS}
        train_paths["train_vlm"] = phase_train_vlm(torch, dev)
        train_paths["train_elastic"] = phase_train_elastic(torch, dev)
        phase_compression(torch, dev)
        phase_examples()            # while the grid's last cells trace
        phase_dryrun(grid)
    finally:                        # the grid's processes end with the script
        grid[0].shutdown(cancel_futures=True)
    dry_paths = phase_dryrun_cells(torch, dev)
    shard_timing, shard_err = phase_sharded_kernels(torch, dev)
    shard_paths = phase_sharded_steps(torch, dev)

    def train_fields(k):
        """The training paths' launches of kernel k and its train_kernels
        record at each training shape."""
        by = {p: n[k] for p, n in train_paths.items() if n[k]}
        return by, {"train": {key.split("/")[1]: rec
                              for key, rec in train_timing.items()
                              if key.startswith(k + "/")},
                    "train_max_abs_err": train_fwd_err[k],
                    "train_max_relative_grad_err": train_err[k]}
    kernels = []
    for k in FOREST_KERNELS:
        main_t = timing[k][main_rows[k]]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "launches_by_path": {path: n[k] for path, n in by_path.items()},
            "max_abs_err": max_err[k], "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"], "library_ms": None,
            "rows": main_rows[k],
            "device_ms": (None if device_us[k] is None
                          else device_us[k] / 1e3),
            "device_ms_timed": main_t["device_ms"],
            "launch_floor_device_ms": main_t["launch_floor"]["device_ms"],
            "by_rows": {str(b): timing[k][b] for b in sorted(timing[k])},
            "ptxas": {n: u for n, u in build["forest_kernels"].items()
                      if k + "_kernel" in n}})
    timing_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")
    for k in ATTN_KERNELS:
        main_t = attn_timing[k]["main/bfloat16"]
        zamba_t = attn_timing[k]["zamba2/bfloat16"]
        by_train, train_rec = train_fields(k) if k == "flash_attention" \
            else ({}, {})
        by_family = {path: n[k] for path, (n, _, _) in family.items()}
        cases = FAMILY_FLASH_CASES if k == "flash_attention" \
            else FAMILY_DECODE_CASES
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": serve_launches[k] + head160_launches[k]
            + zamba_launches[k] + sum(by_family.values())
            + sum(by_train.values()),
            "launches_by_path": {"serve": serve_launches[k],
                                 "serve_stablelm12b": head160_launches[k],
                                 "serve_zamba2": zamba_launches[k],
                                 **by_family, **by_train},
            "family_cases": {
                case: {key: attn_timing[k][f"{case}/bfloat16"][key]
                       for key in timing_keys}
                for case in cases},
            "head_dim_160": {
                "shape": FLASH_CASES[HEAD160_CASE] if k == "flash_attention"
                else DECODE_CASES[HEAD160_CASE],
                "device_ms_serve_stablelm12b": head160_ms[k],
                **{dname: {key: attn_timing[k][f"{HEAD160_CASE}/{dname}"][key]
                           for key in timing_keys + ("max_abs_err",)}
                   for dname in ("bfloat16", "float32")}},
            "device_ms_by_family_path": {
                path: ms[k] for path, (_, ms, _) in family.items()},
            "max_abs_err": attn_err[k], "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "shape": FLASH_CASES["main"] if k == "flash_attention"
            else DECODE_CASES["main"],
            "device_ms": serve_device_ms[k],
            "device_ms_zamba2": zamba_ms[k],
            "device_ms_attn_kernels": main_t["device_ms"],
            "zamba2": {key: zamba_t[key] for key in timing_keys},
            "ptxas": {n: u for n, u in build["attention_kernels"].items()
                      if n.startswith(k)},
            "tensor_core_instructions": _tensor_cores(build, k),
            **train_rec})
    for k, launches, device_ms, cases in (
            ("rwkv6_scan", rwkv_launches, rwkv_ms, RWKV_CASES),
            ("mamba2_ssd", zamba_launches, zamba_ms, SSD_CASES)):
        main_t = scan_times[k]["main/bfloat16"]
        by_train, train_rec = train_fields(k)
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": launches[k] + sum(by_train.values()),
            "launches_by_path": {SERVE_PATH[k]: launches[k], **by_train},
            "max_abs_err": scan_err[k],
            "state_max_abs_err": scan_state_err[k], "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"], "library_ms": None,
            "shape": cases["main"], "device_ms": device_ms[k],
            "device_ms_timed": main_t["device_ms"],
            "float32": {key: scan_times[k]["main/float32"][key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
            "ptxas": {n: u for n, u in build["scan_kernels"].items()
                      if n.startswith(k)},
            "tensor_core_instructions": _tensor_cores(build, k),
            **train_rec})
    main_case, main_slices = SHARD_MAIN
    main_t = shard_timing[main_case][main_slices]
    main_shape, main_lens = SHARD_DECODE_CASES[main_case]
    kernels.append({
        "name": "decode_attention_partial", "route": "cuda",
        "source": SOURCES["decode_attention_partial"],
        "replaces": REPLACES["decode_attention_partial"], "launches": 0,
        "launches_by_path": {}, "max_abs_err": shard_err[main_case],
        "max_abs_err_by_case": shard_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None, "device_ms": main_t["device_ms"],
        "shape": {"case": main_case, "cache": main_shape,
                  "slices": main_slices, "slice_rows": main_t["slice_rows"],
                  "lens": sorted(set(main_lens))},
        "by_case_and_slices": shard_timing})
    for rec in kernels:             # dryrun_cells' and sharded's real runs
        dry = {p: n[rec["name"]] for p, n in {**dry_paths,
                                               **shard_paths}.items()
               if n[rec["name"]]}
        rec["launches"] += sum(dry.values())
        rec["launches_by_path"].update(dry)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"records": RECORDS, "kernels": kernels},
                                  indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
