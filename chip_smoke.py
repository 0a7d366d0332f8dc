#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--seed N]

from the repository root, on a machine with one CUDA GPU and the CUDA
toolkit. It imports only the port (``src/repro_torch``) and:

1. prints the Python/torch/CUDA versions and the card's name and power
   limit (``nvidia-smi``);
2. builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, in parallel), prints each kernel's registers,
   shared memory and spills (``-Xptxas -v``), and counts the HMMA/HGMMA
   instructions of every kernel in the SASS (``cuobjdump -sass``): each
   tensor-core variant must have some;
3. checks the dispatch of each ``ops.py`` wrapper (CPU tensor: plain
   version, no launch counted; CUDA tensor: the kernel, one launch
   counted; other devices raise);
4. holds each kernel variant, through its wrapper, against its plain
   PyTorch version on the card, and checks through the per-variant launch
   counts that each call took the variant it should. Attention: the
   tensor-core variant (bf16, d 64 and 128) and the CUDA-core one (f32,
   d 16/32/48) at the serving shape and at long/ragged sequences, causal
   + window, GQA, suffix queries, strided q, keys past their length set
   to NaN and fully masked rows, the qwen3-1.7b decode prefill (8,
   16, 64, 128) causal GQA, zamba2-1.2b's shared block (32|8, 32, 64,
   64) causal MHA and phi3.5-moe's attention (32|8, 32/8, 64, 128)
   causal GQA (served and prefilled). Exit confidence: small-head (V =
   2 and 40, grouped), tensor-core (the rwkv6-3b LM head (32, 2560) x (2560,
   65536), the SplitEE-S shape (1024, 2560) x (2560, 65536), the scan
   edge of a 17-row tail (544, 2560) x (2560, 65536), a decode step's
   exits (224 and 28, 2048) x (2048, 151936) and (256, 2560) x (2560,
   65536), V = 151936, zamba2's head (32|1216|304|38, 2048) x (2048,
   32000) and phi3.5-moe's (32|512|128, 4096) x (4096, 32064), whose
   last 128-column tile holds 64 columns (the argmax and exact ties put
   in it, in the last full tile and across the two), a head bias, plain and fused with rms/layer norm and shared/per-row
   parameters) and CUDA-core (f32) variants, conf at an LM head held at a
   tolerance scaled to its size that must reject a halved conf and one
   vocabulary split left out, and exact ties (the lowest index wins)
   within a thread's column pair, across a quad, n8 tiles, warps, column
   tiles and vocabulary splits; qwen2-vl-2b's attention (32|8, 12/2,
   64, 128) causal GQA and head (32|896|224, 1536) x (1536, 151936);
   seamless-m4t-large-v2's encoder attention (1|8, 16, 4096, 64)
   bidirectional, decoder (8, 16, 16, 64) causal, cross-attention (8,
   16, 16|64, 64) against (8, 16, 4096, 64), and its head (8|32|192,
   1024) x (1024, 256206), an even V off 8 that the tensor-core variant
   stages in 4-byte pieces (the argmax and exact ties in the partial
   last 8-column chunk, across the last full tile and across a
   vocabulary split; held at SEAMLESS_CONF_TOL). It times kernel, plain version and one
   PyTorch library call (CUDA-graph replay) at every main-path shape. The
   WKV6 recurrence is held against its plain version at the serving
   shape (bf16 and f32), at dk = dv = 16, T in {1, 17, 100, 300}, dk !=
   dv, a strided view input, w = 0 and a large B*H (the `vec16` variant),
   and on inputs one element off 16 bytes or at a feature stride of 2
   (the `scalar` variant); each WKV6 instantiation's blocks per SM,
   registers and spills are printed (a spill fails), the WKV6 SASS must
   hold no tensor-core instruction, and the kernel is timed at B = 32, at
   a depth bucket of B = 4 and at the decode prefill of B = 8;
5. serves a 512-sample stream with full-width ElasticBERT-12 (bfloat16,
   random weights from a seed) through the batched driver (B=32, plain
   and fused exits, and SplitEE-S) and the sequential driver, then
   through `serve()`: the scan edge phase (plain, fused, SplitEE-S),
   "auto", int8 offloads (bucketed), int4 with sparsity 0.5 (scan), the
   sequential path with int8, a 17-sample tail micro-batch, and an
   `Engine` with the fifo scheduler fed in ragged chunks (its decisions
   must equal the one-shot scan run's; its p50/p99 latency is printed),
   and the sharded runtime (`serve(path="sharded")`) at one replica:
   overlap off, bucketed and scan (each bit for bit the batched path's
   run: arms, exits, preds, rewards, offload bytes, cost, controller
   state), the depth-K offload pipeline at K = 1 and 2 and K = 1 with
   fused exits (all but the last batch overlapped), and an `Engine` (K =
   2) fed in ragged chunks (bit for bit the one-shot run), with samples/s,
   wall and device busy of sync, K = 1 and K = 2; one more replica than
   the visible cards must raise; and, for ElasticBERT-12, the
   distributed runtime (`serve(path="distributed")`): in this process
   over the loopback exchange (sync and K = 1, each bit for bit the
   sharded R = 1 run), then worker processes sharing this card (fresh
   interpreters loading the kernels built here, one intra-op thread
   each): a 3-process fault-tolerant cluster over a FileKV directory
   (host 1 killed at round 2 and respawned: detection within the
   heartbeat timeout plus a slack, exactly its slice of round 2 lost,
   the rejoined worker's mirror equal to the survivors') and a 2-process
   lockstep cluster over the TCPStore (sync, K = 1, K = 1 fused: mirrors
   bit for bit, decisions equal to the one-process run's up to a first
   exit flipped near alpha, each worker's launches those of its own
   slices; then a run seeded with the merged state of the failure
   round, which the survivors equal bit for bit until the rejoin), with
   samples/s of each;
   then the same runs with full-width rwkv6-3b (32 layers, d 2560, vocab
   65536, bfloat16) and zamba2-1.2b at full width and 19 of its 38
   Mamba2 layers (d 2048, one shared attention + MLP block after every
   6th, vocab 32000, bfloat16; alpha its median layer-10 confidence; it
   decodes at all 38 layers below; no sharded runs). Each run has its
   own launch counts, per kernel, per variant and per tensor-core tile,
   reset just before it and read just after: they must equal the
   launches its decisions need (`expected_launches`: bucketed, one edge
   call per distinct split depth of a micro-batch; scan, one masked
   forward through all L layers (a hybrid's attention launches only at
   the layers its shared block follows); "auto", scan for a micro-batch
   of >= 2 distinct arms; one cloud call per distinct depth of its
   offloaded samples), and every launch must
   have taken the variant SERVE_VARIANTS names. A codec run's offload
   bytes must be its offloads times the codec's wire bytes per row. It
   prints samples/s and device busy time (torch.profiler) of scan against
   bucketed at B=32, and how many decisions differ between them. It then
   checks the card against the port's CPU (plain-version) path: full-width
   `forward_exits` and `forward_exits_masked` in float32 (ElasticBERT-12
   at all 12 layers, rwkv6-3b cut to 8, zamba2-1.2b cut to 12: two
   shared blocks; rwkv6-3b at all 32 layers against a float64 CPU
   reading, WITNESS_FACTOR), the offload codec bitwise in every mode,
   and the served decisions of a small float32 model of each family
   (bucketed, scan, auto, int8, sharded K = 1); for zamba2 and an MoE it
   prints the device time inside the plain-PyTorch blocks (Mamba2 and
   its SSD, the MoE dispatch) beside the run's busy time;
6. serves autoregressive decode (``workload="decode"``) with full-width
   qwen3-1.7b, rwkv6-3b and zamba2-1.2b (bfloat16, weights and 64
   prompts of 64 tokens from ``--seed``, 32 new tokens each, alpha the
   median layer-L/2 confidence of a first edge step): bandit,
   forced-final and int8 + error feedback at B = 8, bandit at B = 1 on 4
   prompts, and an `Engine` (fifo) fed in ragged chunks (equal to the
   one-shot run). Each run's launches must be the decode launch model's
   (`decode_expected`: per push one attention or WKV6 launch a layer in
   the prefill; per step exactly one exit launch over the L x B exit
   rows, wgmma above 32 rows, mma.sync else; none in the cloud resume).
   It prints tokens/s, exits/offloads, wire bytes and the device busy
   time of a one-push bandit and forced-final run, checks on the card
   that forced-final serving equals a plain `decode_step` loop bitwise,
   that the bandit ledger replayed from a fresh prefill regenerates its
   tokens, and that an offload at quant "none" re-syncs to the full
   step bitwise, and holds the card against the CPU on the weights cut
   to 4 layers (zamba2: 6, one shared block) in float32 (logits and
   confidences within LM_FORWARD_RTOL, tokens equal but at near-ties);
   then phi3.5-moe at its published widths and 16 of its 32 layers
   (42.1 GB of bf16 weights from ``--seed``; the whole model does not
   fit the card): `serve()` bucketed and scan at B = 32 on 256 samples,
   card vs CPU on its first 2 layers in float32 (its routing too: the
   same dropped entries per MoE call, a top-2 flip printed and allowed
   only at a near-tie), decode bandit and forced-final at B = 8 on 16
   prompts x 16 new tokens with the same pins and agreement, every
   run's launches held as above; then qwen2-vl-2b as published over
   seeded embeds (8 micro-batches of 32 x 64): `EdgeCloudRuntime`'s
   edge at seeded depths with the cloud for the rows under alpha (plain
   and fused exits), `edge_fn_s`, `edge_scan_fn` (its carry == the
   edge's bitwise), decode of 8 embed prompts x 32 greedy tokens
   through `prefill` + `decode_step(all_exits)` and through the masked
   edge + resume, each run's launches held against its depths and
   decisions (`counted_run`), and card vs CPU on 4 layers in float32;
   then seamless-m4t-large-v2 as published (8 x 4096 seeded frames, a
   16-token prefix): its encoder's and prefill's device ms, the
   prefill's 24 bidirectional + 24 causal + 24 cross attention calls and
   no exit, 32 greedy steps with every exit and with the exit at layer
   12 (one exit launch a step, no attention; equal tokens), a step's
   logits pinned to the prefill's over the prefix one token longer, and
   card vs CPU on 2 encoder + 4 decoder layers and 256 frames in
   float32;
7. trains full-width ElasticBERT-12 (12 layers, d 768, the synthetic
   vocabulary of 512, 2 classes, float32) on the card: attention's
   gradient (the kernel's forward and `attention_backward`) against
   autograd of the plain version at the training shape (64, 12, 64, 64)
   f32, at (32, 12, 64, 64) bf16 and causal GQA; `train_classifier` with
   `launch/train.py:main`'s recipe (sst2_like, 8192 samples, batch 64,
   200 steps, lr 3e-4), printing each logged loss, ms a step, tokens/s
   and peak memory, and holding the loss falling and 12 x 200 attention
   launches through `cuda_core`; training card vs CPU (2 layers of the
   full width, the same initial parameters and 3 batches: losses,
   step-0 gradients, parameters); then on the trained weights the
   paper's pipeline: `exit_accuracy` (the last exit must beat the
   majority rate; card conf within FULL_FORWARD_ATOL of the CPU's),
   `calibrate_alpha` (card == CPU), `serve()` card f32 vs CPU f32 (the
   same served confidences up to the first differing decision, which may
   only be an exit flipped at alpha) and card bf16 vs card f32 (decisions
   differing and their distance from alpha), and `run_many` (20 runs,
   SplitEE and SplitEE-S) with regret and the final-exit baseline over
   the trained model's imdb_like confidences and the imdb profile (25000
   x 12), with its host seconds. The trained weights are saturated (no
   confidence near alpha), so the same decision checks run again on the
   recipe's first EARLY_STEPS steps, where at least MIN_NEAR_ALPHA served
   confidences must lie within 1 % of alpha;
8. trains full-width ElasticBERT-12 (the training configuration above)
   under model parallelism (`model_parallel_phase`): 3 steps unbound,
   at TP = 1 on a (1, 1) ("data", "model") mesh over an NCCL world of 1
   and at TP = 2 on a (1, 2) mesh of two ranks sharing the card (threads
   of this process over the threaded process group), `seq_parallel` on
   and off, each held to the unbound run (losses, step-0 gradients,
   parameters) with its attention launches and the kernel's q shape (the
   local head shard, forward and `FlashAttention`'s backward); times the
   kernel and `attention_backward` at the TP = 2 shard; meanwhile runs
   `repro_torch.launch.dryrun` for qwen3-1.7b x train_4k and
   mixtral-8x22b x decode_32k on the fake (16, 16) mesh (two
   subprocesses on the host, started with the phase) and prints their
   per-device numbers;
9. prints one JSON line of per-kernel numbers (``launches`` from the run
   named in MAIN_PATH, ``launches_by_path``, ``launches_by_variant`` and,
   for the exit kernels, ``launches_by_tile`` from every run; attention's
   ``at_training`` entry the training shape, ``at_tp2_train`` the TP = 2
   shard), then the
   final line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero without the final
line. Without CUDA, or without the port beside it, it exits with 2.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# tolerances of kernel vs plain version, in the working dtype
TOL = {"float32": 1e-5, "bfloat16": 2e-2}       # atol = rtol
# (rtol, atol) of exit conf at the 65536-class LM head, where conf is
# about 1/V: scaled to its size, so that a conf halved or a vocabulary
# split left out of the softmax sum fails (checked on every run)
LM_CONF_TOL = {"float32": (1e-4, 1e-9), "bfloat16": (1e-3, 1e-7)}
# the same at seamless-m4t-large-v2's head (V 256206), tighter: its last
# vocabulary split holds 206 columns, 0.08 % of the softmax mass, which
# LM_CONF_TOL's bf16 bound (about 0.13 % at conf 3e-4) would accept left
# out
SEAMLESS_CONF_TOL = (4e-4, 1e-8)
# a pred may differ from the plain version's only on rows whose top-2
# plain logits are closer than this (near-ties the rounding can flip)
PRED_TIE_GAP = {"float32": 1e-4, "bfloat16": 2e-2}

# H100 SXM published peaks (dense), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# card vs CPU, full 12-layer forward in float32 (summation orders differ)
FULL_FORWARD_ATOL = 1e-4
# card vs CPU, rwkv6-3b exits (cut to 8 layers, float32): its confidences are
# max softmax probabilities over 65536 classes, far below 1, so the
# bound is relative
LM_FORWARD_RTOL = 1e-4
# card vs CPU, rwkv6-3b at all its layers in float32, where the error has
# grown past LM_FORWARD_RTOL: the card's distance from a float64 CPU
# reading may be at most this many times the CPU float32's (two float32
# paths that round independently)
WITNESS_FACTOR = 2.0
# WKV6 kernel vs plain version: both f32 outputs, the sums over dk and
# the state over T are taken in different orders (rtol = atol)
WKV6_TOL = 1e-4

# attention's gradient, kernel forward + attention_backward against
# autograd of the plain version: max |err| over max |plain| per tensor
# (bf16: the two forwards round their outputs apart, and rowsum(dO∘O)
# reads them)
ATTN_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# training card vs CPU (2 layers of the full width, float32, 3 steps):
# losses (rtol), step-0 gradients (max |err| over max |CPU| per leaf), and
# the parameters after 3 steps where the step-0 |grad| exceeds GRAD_FLOOR
# (below it a gradient's sign may flip under rounding, and AdamW then
# moves the element by ±lr)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
GRAD_FLOOR = 1e-6
# launch/train.py:main's recipe
TRAIN_SAMPLES = 8192
TRAIN_BATCH = 64
TRAIN_STEPS = 200
# run_many's independent reshuffles (the paper's protocol)
BANDIT_RUNS = 20
# the early checkpoint whose served decisions are compared card vs CPU
# and bf16 vs f32 (the trained weights are saturated: no confidence near
# alpha), and how many of its served confidences must lie within 1 % of
# alpha for those comparisons to be able to fail
EARLY_STEPS = 30
MIN_NEAR_ALPHA = 5

SERVE_SAMPLES = 512
SERVE_BATCH = 32
SEQUENTIAL_SAMPLES = 32
LM = "rwkv6-3b"
# the serve run whose launch count each kernel's JSON entry reports
MAIN_PATH = {"flash_attention": "batched B=32",
             "exit_confidence": "batched B=32",
             "exit_confidence_fused": "batched B=32 fused_exit",
             "wkv6": f"{LM} batched B=32"}
# the __global__ functions of the port's CUDA sources, in profiler names
PORT_KERNEL = re.compile(r"(exit_confidence\w*|exit_norm_rows_kernel|"
                         r"wkv6_kernel|flash_attention\w*)")
# the kernel of every layer, by model family (a hybrid's: of its shared
# attention block, which runs after every k-th layer only)
LAYER_KERNEL = {"dense": "flash_attention", "ssm": "wkv6",
                "hybrid": "flash_attention", "moe": "flash_attention"}
# the variant every launch of a kernel must take in a bf16 serve run, by
# model family: attention at d 64 and the LM head on the tensor cores, the
# 2-class heads on the small-head variant, WKV6 on 16-byte cp.async rows
# the decode phase: prompts drawn from --seed, their length, the micro-
# batch, new tokens per prompt; the card-vs-CPU cut (layers, steps)
DECODE_PROMPTS = 64
DECODE_PROMPT_LEN = 64
DECODE_BATCH = 8
DECODE_TOKENS = 32
# the Engine's ragged chunks (3 pushes, held against the one-shot run's
# first 3) and the profiled runs (one push, this many new tokens: the
# profiler's cost grows with the ~100 launches a layer and step)
DECODE_ENGINE_CHUNKS = (5, 1, 7, 3, 8)
DECODE_PROFILE_TOKENS = 8
DECODE_AGREE_LAYERS = 4
DECODE_AGREE_STEPS = 4
# the hybrid served at full width and HYBRID_SERVE_LAYERS of its 38 layers
# (3 shared-attention occurrences; it decodes at all 38 below): the serve
# runs are host-bound by the layer, and the cut keeps the whole smoke
# inside its time limit now that the VLM and enc-dec phases run too; alpha
# the median confidence of its layer 10; its card-vs-CPU forward cut holds
# two shared attention occurrences
HYBRID = "zamba2-1.2b"
HYBRID_SERVE_LAYERS = 19
HYBRID_ALPHA_LAYER = 10
HYBRID_AGREE_LAYERS = 12
# the decoded archs and the layers of their card-vs-CPU cut (zamba2's must
# hold its shared attention block, which follows the 6th layer)
DECODE_ARCHS = (("qwen3-1.7b", DECODE_AGREE_LAYERS),
                (LM, DECODE_AGREE_LAYERS), (HYBRID, 6))
# the MoE at its published widths and 16 of its 32 layers (the whole
# model, 83.7 GB in bf16, does not fit one 80 GB card): serve() bucketed
# and scan on MOE_SAMPLES samples, decode of MOE_PROMPTS prompts x
# MOE_TOKENS new tokens, and card vs CPU on the first 2 layers
MOE = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 16
MOE_SAMPLES = 256
MOE_PROMPTS = 16
MOE_TOKENS = 16
MOE_AGREE_LAYERS = 2
# the VLM (qwen2-vl-2b, as published) over seeded embeds: micro-batches of
# VLM_BATCH rows of VLM_POSITIONS embeds, alpha the median confidence of
# layer VLM_ALPHA_LAYER; decode of VLM_DECODE_PROMPTS embed prompts x
# VLM_DECODE_TOKENS greedy text tokens; card vs CPU on VLM_AGREE_LAYERS
VLM = "qwen2-vl-2b"
VLM_BATCH = 32
VLM_POSITIONS = 64
VLM_MICRO_BATCHES = 8
VLM_ALPHA_LAYER = 14
VLM_DECODE_PROMPTS = 8
VLM_DECODE_TOKENS = 32
VLM_AGREE_LAYERS = 4
# the enc-dec model (seamless-m4t-large-v2, as published): ENCDEC_BATCH
# rows of seeded frames (its 4096-frame source), a prefix of
# ENCDEC_PREFIX target tokens, ENCDEC_TOKENS greedy steps, the SplitEE
# exit at ENCDEC_SPLIT; card vs CPU on (encoder layers, decoder layers,
# frames) ENCDEC_AGREE over ENCDEC_AGREE_STEPS steps
ENCDEC = "seamless-m4t-large-v2"
ENCDEC_BATCH = 8
ENCDEC_PREFIX = 16
ENCDEC_TOKENS = 32
ENCDEC_SPLIT = 12
ENCDEC_AGREE = (2, 4, 256)
ENCDEC_AGREE_STEPS = 4
# the distributed runtime on one card (`distributed_phase`): worker
# processes of full-width ElasticBERT-12, each with its own CUDA context;
# the fault-tolerant cluster kills host 1 at round DIST_KILL_EPOCH, paces
# every round with a DIST_PACE_S sleep (so the respawned worker rejoins
# before the stream ends), must detect the death within DIST_HB_TIMEOUT +
# DIST_DETECT_SLACK_S, and respawns host 1, which asks to rejoin
# DIST_REJOIN_DELAY_S after its model is up (so that some rounds run on
# the two survivors alone); each cluster launch is cut at
# DIST_CLUSTER_TIMEOUT_S
DIST_HB_TIMEOUT = 3.0
DIST_DETECT_SLACK_S = 2.0
DIST_KILL_EPOCH = 2
DIST_FT_HOSTS = 3
DIST_PACE_S = 1.0
DIST_REJOIN_DELAY_S = 4 * DIST_PACE_S
DIST_CLUSTER_TIMEOUT_S = 150.0
# the variant every launch of a decode run must take: attention at d 128
# and the LM-head exits on the tensor cores, WKV6 on 16-byte rows
DECODE_VARIANTS = {"dense": {"flash_attention": "tensor_core",
                             "exit_confidence": "tensor_core"},
                   "ssm": {"wkv6": "vec16",
                           "exit_confidence": "tensor_core"},
                   "hybrid": {"flash_attention": "tensor_core",
                              "exit_confidence": "tensor_core"},
                   "moe": {"flash_attention": "tensor_core",
                           "exit_confidence": "tensor_core"}}
SERVE_VARIANTS = {
    "dense": {"flash_attention": "tensor_core",
              "exit_confidence": "small_head",
              "exit_confidence_fused": "small_head"},
    "ssm": {"wkv6": "vec16",
            "exit_confidence": "tensor_core",
            "exit_confidence_fused": "tensor_core"},
    # zamba2's shared block (d 64) and phi3.5-moe's attention (d 128) on
    # the tensor cores, as their LM heads
    "hybrid": {"flash_attention": "tensor_core",
               "exit_confidence": "tensor_core",
               "exit_confidence_fused": "tensor_core"},
    "moe": {"flash_attention": "tensor_core",
            "exit_confidence": "tensor_core",
            "exit_confidence_fused": "tensor_core"}}


def fail(msg: str) -> None:
    raise AssertionError(msg)


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's heading, then its wall time once the card is idle."""
    import torch
    print(f"== {name}")
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"  [{name}: {time.perf_counter() - t0:.1f} s wall]")


def device_ms(fn, iters: int = 50, warmup: int = 5, check: bool = False):
    """Device time per call of ``fn``: the summed durations of every
    kernel (and copy) it puts on the card, from a torch.profiler (CUPTI)
    trace over ``iters`` calls, without the host's launch overhead.
    Returns (ms, {kernel name: ms per call}).

    The durations are read from the trace's raw device events:
    ``key_averages()`` builds a Python object per event first, which
    costs tens of seconds of host time for a served rwkv6-3b run. With
    ``check`` the ``key_averages()`` total is computed too, and the two
    must agree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
            per_kernel[ev.name()] = per_kernel.get(ev.name(), 0.0) + \
                ev.duration_ns() / iters / 1e6
    total = sum(per_kernel.values())
    if total <= 0:
        fail("torch.profiler recorded no device time")
    if check:
        averaged = sum(ev.self_device_time_total
                       for ev in prof.key_averages()) / iters / 1e3
        print(f"  device time by raw events {total:.4f} ms, by "
              f"key_averages() {averaged:.4f} ms")
        if abs(total - averaged) > 1e-3 * averaged:
            fail("device time by raw events and by key_averages() differ")
    return total, per_kernel


# the plain-PyTorch blocks of a family (no kernel of the port: the
# reference runs them in plain XLA), wrapped in profiler ranges for one
# profiled run so that their device time can be read beside the kernels';
# a serve run's range profile covers its first RANGE_SAMPLES samples (the
# host-side trace of a whole run takes minutes)
RANGE_SAMPLES = 64
PROFILE_RANGES = {
    "hybrid": (("repro_torch.models.mamba2", "mamba2_forward"),
               ("repro_torch.models.mamba2", "_ssd_chunked")),
    "moe": (("repro_torch.models.mlp", "moe_forward"),
            ("repro_torch.models.mlp", "moe_route"))}


def range_device_ms(fn, family: str):
    """One call of ``fn`` profiled with CPU and CUDA activities while the
    family's PROFILE_RANGES functions run inside
    ``torch.profiler.record_function`` ranges of their names. Returns
    ({range: device ms}, device ms of the whole call): the device time
    of a range is that of the kernels launched by the host ops inside
    it (the CPU-side range event's, not the device-side annotation's,
    whose span would count the idle gaps between its kernels), the
    call's that of every kernel and copy its top-level host ops launch.
    The functions are restored afterwards."""
    import importlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    patched = []
    for mod_name, attr in PROFILE_RANGES[family]:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def wrapped(*a, _orig=orig, _name=attr, **k):
            with record_function(_name):
                return _orig(*a, **k)
        setattr(mod, attr, wrapped)
        patched.append((mod, attr, orig))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, attr, orig in patched:
            setattr(mod, attr, orig)
    names = {attr for _, attr in PROFILE_RANGES[family]}
    out, total = dict.fromkeys(sorted(names), 0.0), 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU:
            continue
        if ev.name in names:
            out[ev.name] += ev.device_time_total / 1e3
        if ev.cpu_parent is None:
            total += ev.device_time_total / 1e3
    return out, total


def print_ranges(name, family, fn):
    """The device time of the family's plain-PyTorch blocks in one
    profiled call of ``fn``, beside the call's whole device time."""
    ranges, total = range_device_ms(fn, family)
    print(f"  {name}: device time inside the plain-PyTorch blocks "
          f"(torch.profiler ranges over one call): " + ", ".join(
              f"{k} {ranges[k]:.3f} ms ({ranges[k] / total:.1%})"
              for _, k in PROFILE_RANGES[family])
          + f" of the call's {total:.3f} ms of device time")


def graph_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the graph replayed back to back and timed with CUDA events, so
    the host's launch overhead is not in the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def record(name, source, replaces, shape, err, kernel_fn, plain_fn,
           library_fn, nbytes, flops, dtype, variant, calls=20, replays=20):
    """One entry of the JSON line: device times per call (CUDA-graph
    replay of ``calls`` calls, ``replays`` times) of kernel (through
    ``variant``), plain version and library call, and the bound from this
    call's bytes and operations."""
    bms, by = bound_ms(nbytes, flops, dtype)
    ms = lambda fn: graph_ms(fn, calls, replays)  # noqa: E731
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "variant": variant,
            "max_abs_err": err,
            "ms": ms(kernel_fn), "plain_ms": ms(plain_fn),
            "bound_ms": bms, "bound_by": by,
            "library_ms": None if library_fn is None else ms(library_fn)}


def bound_ms(nbytes: int, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, dtype):
    import torch
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"{name}: kernel vs plain max |err| {err:.3e} > tol {tol}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    return err


def check_lm_conf(name, conf, want, logits, dtype, d, tol=None):
    """conf at an LM head against the plain version at ``tol`` (rtol,
    atol; default LM_CONF_TOL); the same comparison must reject the plain
    conf halved and the plain conf with the smallest of the kernel's
    vocabulary splits (those of the variant that ran, at feature width
    ``d``) left out of the softmax sum. Returns the max relative error."""
    import torch
    from repro_torch.kernels.exit_confidence.kernel import (exit_variant,
                                                            plan, tile_shape)
    rtol, atol = tol or LM_CONF_TOL[dtype]

    def ok(c):
        return bool(torch.allclose(c.float(), want.float(), rtol=rtol,
                                   atol=atol))
    rel = ((conf.float() - want.float()).abs() / want.float()).max().item()
    if not ok(conf) or not torch.isfinite(conf).all():
        fail(f"{name}: kernel vs plain conf max relative err {rel:.3e} "
             f"(rtol {rtol}, atol {atol})")
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    b, v = e.shape
    sms = torch.cuda.get_device_properties(e.device).multi_processor_count
    variant = exit_variant(getattr(torch, dtype), d, v, True)
    cols = plan(1, b, v, sms, *tile_shape(variant, b)).cols_per_split
    parts = torch.stack([e[:, i:i + cols].sum(-1)
                         for i in range(0, e.shape[-1], cols)], -1)
    drop = int(parts.sum(0).argmin())
    if ok(want * 0.5) or ok(1.0 / (e.sum(-1) - parts[:, drop])):
        fail(f"{name}: LM_CONF_TOL accepts a halved conf or one of "
             f"{parts.shape[-1]} vocabulary splits left out")
    return rel


def check_pred(name, pred, want_pred, logits_fn, dtype):
    """pred equal to the plain argmax except where the plain top-2
    logits (``logits_fn()``, computed only on a mismatch) are within
    PRED_TIE_GAP."""
    import torch
    bad = pred.long() != want_pred.long()
    if bad.any():
        top2 = torch.topk(logits_fn().float(), 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1])[bad]
        if (gap >= PRED_TIE_GAP[dtype]).any():
            fail(f"{name}: pred differs on {int(bad.sum())} rows, top-2 gap "
                 f"up to {gap.max().item():.3e}")
    return int(bad.sum())


def via(kernel: str, variant: str, fn, tile: str | None = None):
    """``fn()``, which must launch ``kernel`` once, through ``variant``
    (and, given ``tile``, through that tile of the variant)."""
    from repro_torch.kernels import tile_launch_counts, variant_launch_counts
    before, tiles_before = variant_launch_counts(), tile_launch_counts()
    out = fn()
    moved = {k: n - before[k] for k, n in variant_launch_counts().items()
             if n != before[k]}
    if moved != {f"{kernel}/{variant}": 1}:
        fail(f"{kernel}: expected one launch through its {variant} variant, "
             f"counted {moved}")
    if tile is not None:
        moved = {k: n - tiles_before[k]
                 for k, n in tile_launch_counts().items()
                 if n != tiles_before[k]}
        if moved != {f"{kernel}/{variant}/{tile}": 1}:
            fail(f"{kernel}: expected one launch through the {tile} tile of "
                 f"{variant}, counted {moved}")
    return out


def _exit_variant(h, w):
    from repro_torch.kernels._build import rows_aligned
    from repro_torch.kernels.exit_confidence.kernel import exit_variant
    return exit_variant(h.dtype, h.shape[-1], w.shape[-1],
                        rows_aligned(h) and w.data_ptr() % 16 == 0)


def sass_tensor_core_counts():
    """{kernel function: count of HMMA/HGMMA instructions} in the built
    libraries, from ``cuobjdump -sass`` of the toolkit that built them."""
    from repro_torch.kernels import SOURCES
    from repro_torch.kernels._build import lib_path, nvcc_path
    tool = Path(nvcc_path()).parent / "cuobjdump"
    counts = {}
    for src in SOURCES:
        sass = subprocess.run([str(tool), "-sass", str(lib_path(Path(src)))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and ("HMMA" in line or "HGMMA" in line):
                counts[fn] += 1
    return counts


# ------------------------------------------------------------ kernel phase

def dispatch_checks(torch, dev):
    """Each ops.py wrapper runs its plain version on a CPU tensor without
    counting, and on a CUDA tensor launches its kernel and adds exactly one
    to its own count."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.exit_confidence.ops import (
        exit_confidence, exit_confidence_fused)
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.wkv6.ops import wkv6

    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, 2, 8, 16), generator=gen)
    h = torch.randn((8, 16), generator=gen)
    w = torch.randn((16, 4), generator=gen)
    scale = torch.ones(16)
    decay = torch.rand((1, 2, 8, 16), generator=gen)
    calls = {
        "flash_attention": lambda d: attention(q.to(d), q.to(d), q.to(d)),
        "exit_confidence": lambda d: exit_confidence(h.to(d), w.to(d)),
        "exit_confidence_fused": lambda d: exit_confidence_fused(
            h.to(d), {"scale": scale.to(d)}, w.to(d), kind="rmsnorm"),
        "wkv6": lambda d: wkv6(q.to(d), q.to(d), q.to(d), decay.to(d),
                               q[0, :, 0].to(d)),
    }
    if sorted(calls) != sorted(launch_counts()):
        fail(f"kernels {sorted(launch_counts())}, checks {sorted(calls)}")
    for name, call in calls.items():
        reset_launch_counts()
        cpu_out = call("cpu")
        if any(launch_counts().values()):
            fail(f"{name} on a CPU tensor counted a launch: {launch_counts()}")
        gpu_out = call(dev)
        torch.cuda.synchronize()
        want = {k: int(k == name) for k in calls}
        if launch_counts() != want:
            fail(f"{name} on a CUDA tensor: counts {launch_counts()} != {want}")
        cpu_out = cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)
        gpu_out = gpu_out if isinstance(gpu_out, tuple) else (gpu_out,)
        if gpu_out[0].device.type != "cuda":
            fail(f"{name}: a CUDA input gave a {gpu_out[0].device} output")
        check_close(f"{name}[dispatch]", gpu_out[0].cpu(), cpu_out[0],
                    "float32")
    for name, call in (("attention", calls["flash_attention"]),
                       ("wkv6", calls["wkv6"])):
        try:
            call("meta")
        except ValueError:
            pass
        else:
            fail(f"{name} on a meta tensor did not raise")
    print(f"  {sorted(calls)}: CPU tensor -> plain version, no count; CUDA "
          f"tensor -> kernel, one count each; other devices raise")


def attention_checks(torch, dev):
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import gqa_ref
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, hq, hkv, sq, skv, d, dtype):
        mk = lambda h, s: torch.randn((b, h, s, d), generator=gen,  # noqa: E731
                                      device=dev).to(dtype)
        return mk(hq, sq), mk(hkv, skv), mk(hkv, skv)

    def run(name, variant, q, k, v, causal, window=0):
        """The kernel through ``variant`` against the plain version."""
        got = via("flash_attention", variant,
                  lambda: attention(q, k, v, causal=causal, window=window))
        want = gqa_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal=causal, window=window)
        torch.cuda.synchronize()
        return got, want

    tc, cc = "tensor_core", "cuda_core"
    cases = [
        # name, variant, b, hq, hkv, sq, skv, d, causal, window, dtype
        ("main_bf16", tc, 32, 12, 12, 64, 64, 64, False, 0, "bfloat16"),
        ("main_f32", cc, 32, 12, 12, 64, 64, 64, False, 0, "float32"),
        ("s512_bf16", tc, 2, 12, 12, 512, 512, 64, False, 0, "bfloat16"),
        ("ragged_s200_bf16", tc, 3, 12, 12, 200, 200, 64, False, 0,
         "bfloat16"),
        ("ragged_s200_f32", cc, 3, 12, 12, 200, 200, 64, False, 0, "float32"),
        ("causal_window_bf16", tc, 2, 8, 8, 300, 300, 64, True, 64,
         "bfloat16"),
        ("causal_window_d128_bf16", tc, 2, 8, 8, 300, 300, 128, True, 100,
         "bfloat16"),
        ("gqa_causal_d128_f32", cc, 2, 8, 2, 130, 130, 128, True, 0,
         "float32"),
        ("gqa_causal_d128_bf16", tc, 2, 8, 2, 130, 130, 128, True, 0,
         "bfloat16"),
        ("gqa_suffix_q_bf16", tc, 2, 8, 2, 7, 90, 64, True, 0, "bfloat16"),
        # the qwen3-1.7b decode prefill: B = 8, 64 tokens, 16 query and 8
        # KV heads of 128, causal
        ("qwen3_prefill_bf16", tc, 8, 16, 8, 64, 64, 128, True, 0,
         "bfloat16"),
        # zamba2-1.2b's shared block (causal MHA, 32 heads of 64) served at
        # B = 32 and in the decode prefill at B = 8; phi3.5-moe's attention
        # (causal GQA 32/8, head dim 128) likewise
        ("zamba2_serve_bf16", tc, 32, 32, 32, 64, 64, 64, True, 0,
         "bfloat16"),
        ("zamba2_prefill_bf16", tc, 8, 32, 32, 64, 64, 64, True, 0,
         "bfloat16"),
        ("phi35_serve_bf16", tc, 32, 32, 8, 64, 64, 128, True, 0,
         "bfloat16"),
        ("phi35_prefill_bf16", tc, 8, 32, 8, 64, 64, 128, True, 0,
         "bfloat16"),
        # qwen2-vl-2b (causal GQA 12/2, head dim 128) served at B = 32 and
        # prefilled at B = 8; seamless-m4t-large-v2 (MHA 16 heads of 64):
        # its encoder over 4096 frames (bidirectional; B = 1 keeps the
        # plain version's f32 logits at 1.07 GB), its decoder's causal
        # self-attention over a 16-token prefix and its cross-attention
        # of 16 or 64 target tokens against 4096 frames (not causal)
        ("qwen2vl_serve_bf16", tc, 32, 12, 2, 64, 64, 128, True, 0,
         "bfloat16"),
        ("qwen2vl_prefill_bf16", tc, 8, 12, 2, 64, 64, 128, True, 0,
         "bfloat16"),
        ("seamless_encoder_bf16", tc, 1, 16, 16, 4096, 4096, 64, False, 0,
         "bfloat16"),
        ("seamless_decoder_bf16", tc, 8, 16, 16, 16, 16, 64, True, 0,
         "bfloat16"),
        ("seamless_cross16_bf16", tc, 8, 16, 16, 16, 4096, 64, False, 0,
         "bfloat16"),
        ("seamless_cross64_bf16", tc, 8, 16, 16, 64, 4096, 64, False, 0,
         "bfloat16"),
        ("suffix_q_f32", cc, 2, 4, 4, 7, 90, 32, True, 0, "float32"),
        ("d16_bf16", cc, 2, 4, 4, 70, 70, 16, False, 0, "bfloat16"),
        ("d48_causal_bf16", cc, 2, 4, 2, 70, 70, 48, True, 0, "bfloat16"),
    ]
    out = {}
    for name, variant, b, hq, hkv, sq, skv, d, causal, window, dt in cases:
        q, k, v = qkv(b, hq, hkv, sq, skv, d, getattr(torch, dt))
        got, want = run(name, variant, q, k, v, causal, window)
        err = check_close(f"flash_attention[{name}]", got, want, dt)
        print(f"  flash_attention[{name}] ({variant}) max|err| {err:.3e} "
              f"(tol {TOL[dt]})")
        out[name] = (q, k, v, err)
    for name, variant, dt in (("main_bf16", tc, "bfloat16"),
                              ("gqa_causal_d128_bf16", tc, "bfloat16"),
                              ("main_f32", cc, "float32")):
        # a strided (B, S, H, d) -> (B, H, S, d) view, as attn_prefill
        # passes
        q, k, v, _ = out[name]
        causal = "causal" in name
        qs = q.transpose(1, 2).contiguous().transpose(1, 2)
        check_close(f"flash_attention[strided {name}]",
                    *run(name, variant, qs, k, v, causal), dt)
    for d, variant, dt in ((32, cc, torch.float32), (64, tc, torch.bfloat16),
                           (128, tc, torch.bfloat16)):
        # keys/values as views into a longer buffer whose tail is NaN: the
        # kernel never reads past the key length (100 keys: a full and a
        # ragged 64-key tile)
        q, kb, vb = qkv(1, 2, 2, 70, 120, d, dt)
        kb[:, :, 100:] = float("nan")
        vb[:, :, 100:] = float("nan")
        name = f"nan_past_skv_d{d}"
        check_close(f"flash_attention[{name}]",
                    *run(name, variant, q, kb[:, :, :100], vb[:, :, :100],
                         False), str(dt).split(".")[1])
    for d, variant, dt in ((16, cc, torch.float32), (64, tc, torch.bfloat16),
                           (128, tc, torch.bfloat16)):
        # causal queries placed before the first key (Sq > Skv) see
        # nothing: exactly 0, as the TPU kernel gives
        q, k, v = qkv(1, 2, 2, 10, 4, d, dt)
        got, want = run(f"sq_gt_skv_d{d}", variant, q, k, v, True)
        if not (got[:, :, :6] == 0).all():
            fail(f"flash_attention ({variant}, d {d}): fully masked rows "
                 f"are not exactly 0")
        check_close(f"flash_attention[sq_gt_skv_d{d}]", got[:, :, 6:],
                    want[:, :, 6:], str(dt).split(".")[1])
    print("  flash_attention, both variants: strided q; never reads past "
          "skv (NaN tail); fully masked rows exactly 0")

    q, k, v, err = out["main_bf16"]
    b, h, s, d = q.shape
    rec = record(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:80",
        f"q/k/v ({b},{h},{s},{d}) bfloat16, bidirectional", err,
        lambda: via("flash_attention", tc,
                    lambda: attention(q, k, v, causal=False)),
        lambda: gqa_ref(q, k, v, causal=False),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4 * q.numel() * q.element_size(), 4.0 * b * h * s * s * d, "bfloat16",
        variant=tc)
    # bytes: q and the output (Hq heads), k and v (Hkv heads); operations:
    # the causal half of the two products
    for key, case in (("at_qwen3_prefill", "qwen3_prefill_bf16"),
                      ("at_zamba2_serve", "zamba2_serve_bf16"),
                      ("at_zamba2_prefill", "zamba2_prefill_bf16"),
                      ("at_phi35_serve", "phi35_serve_bf16"),
                      ("at_phi35_prefill", "phi35_prefill_bf16"),
                      ("at_qwen2vl_serve", "qwen2vl_serve_bf16"),
                      ("at_qwen2vl_prefill", "qwen2vl_prefill_bf16"),
                      ("at_seamless_decoder", "seamless_decoder_bf16")):
        q, k, v, err = out[case]
        b, h, s, d = q.shape
        gqa = k.shape[1] != h
        rec[key] = record(
            "flash_attention",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:80",
            f"q ({b},{h},{s},{d}), k/v ({b},{k.shape[1]},{s},{d}) bfloat16, "
            f"causal {'GQA' if gqa else 'MHA'}", err,
            lambda: via("flash_attention", tc,
                        lambda: attention(q, k, v, causal=True)),
            lambda: gqa_ref(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=gqa),
            2 * (q.numel() + k.numel()) * q.element_size(),
            2.0 * b * h * s * s * d, "bfloat16", variant=tc)
    # not causal, Sq queries against Skv keys: bytes q, out, k, v;
    # operations the two products in full
    for key, case in (("at_seamless_encoder", "seamless_encoder_bf16"),
                      ("at_seamless_cross16", "seamless_cross16_bf16"),
                      ("at_seamless_cross64", "seamless_cross64_bf16")):
        q, k, v, err = out[case]
        rec[key] = not_causal_record(torch, q, k, v, err)
        del out[case]
    # seamless's encoder at the decode phase's B = 8, held and timed (the
    # plain version's f32 logits: 8.6 GB)
    q, k, v = qkv(8, 16, 16, 4096, 4096, 64, torch.bfloat16)
    got, want = run("seamless_encoder_b8_bf16", tc, q, k, v, False)
    err = check_close("flash_attention[seamless_encoder_b8_bf16]", got, want,
                      "bfloat16")
    del got, want
    print(f"  flash_attention[seamless_encoder_b8_bf16] ({tc}) max|err| "
          f"{err:.3e} (tol {TOL['bfloat16']})")
    rec["at_seamless_encoder_b8"] = not_causal_record(torch, q, k, v, err,
                                                      calls=2, replays=2)
    return rec


def not_causal_record(torch, q, k, v, err, **few):
    """The JSON entry of attention at q (B, H, Sq, d) against k/v (B, H,
    Skv, d), not causal, through the tensor-core variant."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import gqa_ref
    b, h, sq, d = q.shape
    skv = k.shape[2]
    tc = "tensor_core"
    return record(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:80",
        f"q ({b},{h},{sq},{d}), k/v ({b},{h},{skv},{d}) bfloat16, "
        f"{'bidirectional' if sq == skv else 'cross-attention'}", err,
        lambda: via("flash_attention", tc,
                    lambda: attention(q, k, v, causal=False)),
        lambda: gqa_ref(q, k, v, causal=False),
        lambda: F.scaled_dot_product_attention(q, k, v),
        2 * (q.numel() + k.numel()) * q.element_size(),
        4.0 * b * h * sq * skv * d, "bfloat16", variant=tc, **few)


def _exit_logits(h, w, bias=None):
    logits = h.float() @ w.float()
    return logits if bias is None else logits + bias.float()


def exit_checks(torch, dev):
    from repro_torch.kernels.exit_confidence.ops import (
        exit_confidence, exit_confidence_fused)
    from repro_torch.kernels.exit_confidence.ref import (
        _norm_for, exit_confidence_fused_ref, exit_confidence_ref)
    from repro_torch.models.common import apply_norm

    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=gen,  # noqa: E731
                                            device=dev) * scale

    def held(name, conf, pred, wc, wp, logits_fn, dt, lm, d):
        """conf and pred against the plain version's; ``lm``: at an LM
        head, conf at LM_CONF_TOL, or at the (rtol, atol) ``lm`` gives."""
        err = (conf.float() - wc.float()).abs().max().item()
        if lm:
            lm_tol = lm if isinstance(lm, tuple) else LM_CONF_TOL[dt]
            rel = check_lm_conf(name, conf, wc, logits_fn(), dt, d, lm_tol)
            tol = f"relative {rel:.3e}, (rtol, atol) {lm_tol}"
        else:
            check_close(name, conf, wc, dt)
            tol = f"tol {TOL[dt]}"
        flips = check_pred(name, pred, wp, logits_fn, dt)
        print(f"  {name} max|err| {err:.3e} ({tol}), pred flips at "
              f"near-ties {flips}")
        return err

    def plain_case(name, h, w, dt, bias=None, lm=False, tile=None):
        conf, pred = via("exit_confidence", _exit_variant(h, w),
                         lambda: exit_confidence(h, w, bias), tile)
        wc, wp = exit_confidence_ref(h, w, bias)
        torch.cuda.synchronize()
        return held(f"exit_confidence[{name}]", conf, pred, wc, wp,
                    lambda: _exit_logits(h, w, bias), dt, lm, h.shape[-1])

    def fused_case(name, x, norm, w, hb, kind, dt, lm=False, tile=None):
        conf, pred = via("exit_confidence_fused", _exit_variant(x, w),
                         lambda: exit_confidence_fused(x, norm, w, hb,
                                                       kind=kind), tile)
        wc, wp = exit_confidence_fused_ref(x, norm, w, hb, kind=kind)
        torch.cuda.synchronize()
        return held(f"exit_confidence_fused[{name}]", conf, pred, wc, wp,
                    lambda: _exit_logits(
                        apply_norm(x, _norm_for(x, norm), kind), w,
                        None if hb is None else hb.unsqueeze(-2)), dt, lm,
                    x.shape[-1])

    bf16, f32 = torch.bfloat16, torch.float32
    b, d, v = 32, 768, 2
    h_main = rnd(b, d).to(bf16)
    w_main = rnd(d, v, scale=d ** -0.5).to(bf16)
    err_main = plain_case("main_bf16", h_main, w_main, "bfloat16")
    plain_case("main_f32", h_main.float(), w_main.float(), "float32")
    # a head bias, added to the logits by the kernel
    plain_case("bias_f32", h_main.float(), w_main.float(), "float32",
               bias=rnd(v))
    plain_case("bias_bf16", h_main, w_main, "bfloat16", bias=rnd(v))
    big_v = 151936
    plain_case("v151936_bf16", rnd(b, d).to(bf16),
               rnd(d, big_v, scale=d ** -0.5).to(bf16), "bfloat16")
    # exact ties (integer values) in different tiles and vocab splits:
    # the lowest index must win
    h_t = torch.ones((b, 64), device=dev)
    w_t = torch.zeros((64, big_v), device=dev)
    cols = torch.tensor([300, 70000, 151000], device=dev)
    w_t[:, cols] = 2.0
    w_t[:, 150999] = 1.0
    for dt in (f32, bf16):
        conf, pred = exit_confidence(h_t.to(dt), w_t.to(dt))
        if not (pred == 300).all():
            fail(f"exit_confidence ties ({dt}): pred {pred.unique().tolist()}"
                 f" != 300")
        check_close("exit_confidence[ties]", conf,
                    exit_confidence_ref(h_t, w_t)[0], "float32")
    w_t2 = torch.zeros((64, big_v), device=dev)
    w_t2[:, [255, 256, 512]] = 3.0              # tie across a 256-column tile
    if not (exit_confidence(h_t, w_t2)[1] == 255).all():
        fail("exit_confidence tie across a column tile: lowest index lost")
    w_t3 = torch.zeros((64, 40), device=dev)    # small head: warp per row
    w_t3[:, [9, 17, 30]] = 1.0
    for dt in (f32, bf16):
        pred = via("exit_confidence", "small_head",
                   lambda: exit_confidence(h_t.to(dt), w_t3.to(dt)))[1]
        if not (pred == 9).all():
            fail(f"exit_confidence tie in a small head ({dt}): lowest index "
                 f"lost")
    print("  exit_confidence ties across tiles/splits: lowest index wins")

    # bf16 exact ties on the tensor-core variant, whose threads hold
    # columns 2t, 2t+1 of each n8 tile: the two columns of one thread,
    # threads of a quad, n8 tiles, warps (mma.sync at M = 32: 32 columns
    # each; wgmma at M = 1024: a thread's n8 tiles span all 128), column
    # tiles and vocabulary splits; plain and fused (rms of a ones row is 1
    # in bf16, so the logits stay exact)
    tie_sets = {"one thread": [4, 5], "quad": [1, 6], "n8 tiles": [7, 8],
                "warps": [10, 40, 70, 100], "column tiles": [100, 228],
                "splits": [300, 40000, 65535]}
    for m in (b, 32 * b):
        h_tie = torch.ones((m, 64), device=dev, dtype=bf16)
        ones = {"scale": torch.ones(64, device=dev, dtype=bf16)}
        for what, tie in tie_sets.items():
            w_tie = torch.zeros((64, 65536), device=dev, dtype=bf16)
            w_tie[:, tie] = 2.0
            want = exit_confidence_ref(h_tie, w_tie)[0]
            for kname, call in (
                    ("exit_confidence",
                     lambda: exit_confidence(h_tie, w_tie)),
                    ("exit_confidence_fused",
                     lambda: exit_confidence_fused(h_tie, ones, w_tie,
                                                   kind="rmsnorm"))):
                conf, pred = via(kname, "tensor_core", call)
                if not (pred == min(tie)).all():
                    fail(f"{kname} tie across {what} at M={m}: pred "
                         f"{pred.unique().tolist()} != {min(tie)}")
                check_close(f"{kname}[tie across {what}, M={m}]", conf, want,
                            "float32")
    print(f"  exit_confidence(+fused) tensor_core, M = {b} and {32 * b}: "
          f"ties across {', '.join(tie_sets)}: lowest index wins")

    errs_fused = {}
    for kind in ("rmsnorm", "layernorm"):
        for per_row in (False, True):
            rows = (b,) if per_row else ()
            norm = {"scale": (rnd(*rows, d, scale=0.1) + 1.0).to(bf16)}
            if kind == "layernorm":
                norm["bias"] = rnd(*rows, d, scale=0.1).to(bf16)
            name = f"{kind}_{'per_row' if per_row else 'shared'}_bf16"
            errs_fused[name] = fused_case(
                name, (rnd(b, d, scale=2.0) + 0.5).to(bf16), norm, w_main,
                None, kind, "bfloat16")
    fused_case("layernorm_grouped_12_f32_bias",
               rnd(12, b, d), {"scale": rnd(12, d, scale=0.1) + 1.0,
                               "bias": rnd(12, d, scale=0.1)},
               rnd(12, d, v, scale=d ** -0.5), rnd(12, v), "layernorm",
               "float32")
    fused_case("rmsnorm_v151936_f32", rnd(b, d),
               {"scale": rnd(d, scale=0.1) + 1.0},
               rnd(d, big_v, scale=d ** -0.5), None, "rmsnorm", "float32")

    # timings at the serving shape (B=32, D=768, V=2, bfloat16)
    src = "src/repro_torch/kernels/exit_confidence/csrc/exit_confidence.cu"
    nbytes = h_main.numel() * 2 + w_main.numel() * 2 + b * 4 + b * 4
    rec_plain = record(
        "exit_confidence", src,
        "src/repro/kernels/exit_confidence/kernel.py:100",
        f"h ({b},{d}) @ w ({d},{v}) bfloat16", err_main,
        lambda: exit_confidence(h_main, w_main),
        lambda: exit_confidence_ref(h_main, w_main),
        lambda: torch.softmax(h_main @ w_main, dim=-1).max(dim=-1),
        nbytes, 2.0 * b * d * v, "bfloat16", "small_head")
    # SplitEE-S on per-layer heads: every exit of the stack in one launch
    h_g = rnd(12, b, d).to(bf16)
    w_g = rnd(12, d, v, scale=d ** -0.5).to(bf16)
    err_g = plain_case("grouped_12x32_bf16", h_g, w_g, "bfloat16")
    rec_plain["at_grouped"] = record(
        "exit_confidence", src,
        "src/repro/kernels/exit_confidence/kernel.py:100",
        f"h (12,{b},{d}) @ w (12,{d},{v}) bfloat16", err_g,
        lambda: exit_confidence(h_g, w_g),
        lambda: exit_confidence_ref(h_g, w_g),
        lambda: torch.softmax(h_g @ w_g, dim=-1).max(dim=-1),
        12 * nbytes, 12 * 2.0 * b * d * v, "bfloat16", "small_head")
    x_f = (rnd(b, d, scale=2.0) + 0.5).to(bf16)
    norm_f = {"scale": (rnd(d, scale=0.1) + 1.0).to(bf16),
              "bias": rnd(d, scale=0.1).to(bf16)}
    rec_fused = record(
        "exit_confidence_fused", src,
        "src/repro/kernels/exit_confidence/kernel.py:186",
        f"layernorm x ({b},{d}), shared (D,) params, w ({d},{v}) bfloat16",
        errs_fused["layernorm_shared_bf16"],
        lambda: exit_confidence_fused(x_f, norm_f, w_main,
                                      kind="layernorm"),
        lambda: exit_confidence_fused_ref(x_f, norm_f, w_main,
                                          kind="layernorm"),
        None,       # no single PyTorch call computes norm + head + max
        nbytes + 2 * d * 2, 2.0 * b * d * v + 8.0 * b * d, "bfloat16",
        "small_head")

    # the rwkv6-3b LM head, shared by all its exits: checked and timed
    # too, as each entry's "at_lm_head"
    d, v = 2560, 65536
    h_lm = rnd(b, d).to(bf16)
    w_lm = rnd(d, v, scale=d ** -0.5).to(bf16)
    x_lm = (rnd(b, d, scale=2.0) + 0.5).to(bf16)
    norm_lm = {"scale": (rnd(d, scale=0.1) + 1.0).to(bf16),
               "bias": rnd(d, scale=0.1).to(bf16)}
    err_lm = plain_case("lm_head_bf16", h_lm, w_lm, "bfloat16", lm=True,
                        tile="mma_sync")
    err_lm_f = fused_case("layernorm_lm_head_bf16", x_lm, norm_lm, w_lm, None,
                          "layernorm", "bfloat16", lm=True, tile="mma_sync")
    plain_case("lm_head_f32", h_lm.float(), w_lm.float(), "float32", lm=True)
    # a head bias, taken natively by the tensor-core epilogue, plain and
    # fused (with per-row norm parameters, as SplitEE-S passes them)
    bias_lm = rnd(v)
    plain_case("lm_head_bias_bf16", h_lm, w_lm, "bfloat16", bias=bias_lm,
               lm=True)
    fused_case("rmsnorm_per_row_lm_head_bias_bf16", x_lm,
               {"scale": (rnd(b, d, scale=0.1) + 1.0).to(bf16)}, w_lm,
               bias_lm, "rmsnorm", "bfloat16", lm=True)
    fused_case("layernorm_lm_head_f32", x_lm.float(),
               {k: t.float() for k, t in norm_lm.items()}, w_lm.float(), None,
               "layernorm", "float32", lm=True)
    nbytes = h_lm.numel() * 2 + w_lm.numel() * 2 + b * 4 + b * 4
    rec_plain["at_lm_head"] = record(
        "exit_confidence", src,
        "src/repro/kernels/exit_confidence/kernel.py:100",
        f"h ({b},{d}) @ w ({d},{v}) bfloat16", err_lm,
        lambda: exit_confidence(h_lm, w_lm),
        lambda: exit_confidence_ref(h_lm, w_lm),
        lambda: torch.softmax(h_lm @ w_lm, dim=-1).max(dim=-1),
        nbytes, 2.0 * b * d * v, "bfloat16", "tensor_core")
    rec_fused["at_lm_head"] = record(
        "exit_confidence_fused", src,
        "src/repro/kernels/exit_confidence/kernel.py:186",
        f"layernorm x ({b},{d}), shared (D,) params, w ({d},{v}) bfloat16",
        err_lm_f,
        lambda: exit_confidence_fused(x_lm, norm_lm, w_lm, kind="layernorm"),
        lambda: exit_confidence_fused_ref(x_lm, norm_lm, w_lm,
                                          kind="layernorm"),
        None, nbytes + 2 * d * 2, 2.0 * b * d * v + 8.0 * b * d, "bfloat16",
        "tensor_core")

    # the SplitEE-S edge pass at rwkv6-3b: every one of the 32 exits of a
    # 32-row micro-batch on the shared head in one launch, M = 1024 rows;
    # the fused form with per-row norm parameters (repeat_interleave)
    m = 32 * b
    h_s = rnd(m, d).to(bf16)
    x_s = (rnd(m, d, scale=2.0) + 0.5).to(bf16)
    norm_s = {"scale": (rnd(m, d, scale=0.1) + 1.0).to(bf16),
              "bias": rnd(m, d, scale=0.1).to(bf16)}
    err_s = plain_case("splitee_s_lm_head_bf16", h_s, w_lm, "bfloat16",
                       lm=True, tile="wgmma")
    err_s_f = fused_case("layernorm_per_row_splitee_s_lm_head_bf16", x_s,
                         norm_s, w_lm, None, "layernorm", "bfloat16", lm=True,
                         tile="wgmma")
    nbytes = h_s.numel() * 2 + w_lm.numel() * 2 + m * 4 + m * 4
    few = dict(variant="tensor_core", calls=5, replays=5)
    rec_plain["at_splitee_s"] = record(
        "exit_confidence", src,
        "src/repro/kernels/exit_confidence/kernel.py:100",
        f"h ({m},{d}) @ w ({d},{v}) bfloat16", err_s,
        lambda: exit_confidence(h_s, w_lm),
        lambda: exit_confidence_ref(h_s, w_lm),
        lambda: torch.softmax(h_s @ w_lm, dim=-1).max(dim=-1),
        nbytes, 2.0 * m * d * v, "bfloat16", **few)
    rec_fused["at_splitee_s"] = record(
        "exit_confidence_fused", src,
        "src/repro/kernels/exit_confidence/kernel.py:186",
        f"layernorm x ({m},{d}), per-row (M,D) params, w ({d},{v}) "
        f"bfloat16", err_s_f,
        lambda: exit_confidence_fused(x_s, norm_s, w_lm, kind="layernorm"),
        lambda: exit_confidence_fused_ref(x_s, norm_s, w_lm,
                                          kind="layernorm"),
        None, nbytes + 2 * m * d * 2, 2.0 * m * d * v + 8.0 * m * d,
        "bfloat16", **few)

    # the scan edge of a 17-row tail micro-batch at rwkv6-3b: 32 exits x
    # 17 rows = 544, not a multiple of the 128-row wgmma tile; plain, and
    # fused with per-row layernorm parameters
    m = 32 * 17
    h_t = rnd(m, d).to(bf16)
    x_t = (rnd(m, d, scale=2.0) + 0.5).to(bf16)
    norm_t = {"scale": (rnd(m, d, scale=0.1) + 1.0).to(bf16),
              "bias": rnd(m, d, scale=0.1).to(bf16)}
    err_t = plain_case("scan_tail_lm_head_bf16", h_t, w_lm, "bfloat16",
                       lm=True, tile="wgmma")
    err_t_f = fused_case("layernorm_per_row_scan_tail_lm_head_bf16", x_t,
                         norm_t, w_lm, None, "layernorm", "bfloat16", lm=True,
                         tile="wgmma")
    nbytes = h_t.numel() * 2 + w_lm.numel() * 2 + m * 4 + m * 4
    rec_plain["at_scan_tail"] = record(
        "exit_confidence", src,
        "src/repro/kernels/exit_confidence/kernel.py:100",
        f"h ({m},{d}) @ w ({d},{v}) bfloat16", err_t,
        lambda: exit_confidence(h_t, w_lm),
        lambda: exit_confidence_ref(h_t, w_lm),
        lambda: torch.softmax(h_t @ w_lm, dim=-1).max(dim=-1),
        nbytes, 2.0 * m * d * v, "bfloat16", **few)
    rec_fused["at_scan_tail"] = record(
        "exit_confidence_fused", src,
        "src/repro/kernels/exit_confidence/kernel.py:186",
        f"layernorm x ({m},{d}), per-row (M,D) params, w ({d},{v}) "
        f"bfloat16", err_t_f,
        lambda: exit_confidence_fused(x_t, norm_t, w_lm, kind="layernorm"),
        lambda: exit_confidence_fused_ref(x_t, norm_t, w_lm,
                                          kind="layernorm"),
        None, nbytes + 2 * m * d * 2, 2.0 * m * d * v + 8.0 * m * d,
        "bfloat16", **few)

    # a decode edge step scores its L x B exit rows at the shared LM head
    # in one launch: qwen3-1.7b (28 layers, D 2048, V 151936) at B = 8
    # (224 rows = 128 + a partial 96: wgmma) and B = 1 (28: mma.sync),
    # rwkv6-3b (32 layers) at B = 8 (256: wgmma); its B = 1 is the
    # (32, 2560) LM head above
    w_q = rnd(2048, 151936, scale=2048 ** -0.5).to(bf16)
    for key, m, w_d, tile in (("at_decode_qwen3_b8", 224, w_q, "wgmma"),
                              ("at_decode_qwen3_b1", 28, w_q, "mma_sync"),
                              ("at_decode_rwkv6_b8", 256, w_lm, "wgmma")):
        d, v = w_d.shape
        h_d = rnd(m, d).to(bf16)
        err_d = plain_case(f"{key[3:]}_bf16", h_d, w_d, "bfloat16", lm=True,
                           tile=tile)
        rec_plain[key] = record(
            "exit_confidence", src,
            "src/repro/kernels/exit_confidence/kernel.py:100",
            f"h ({m},{d}) @ w ({d},{v}) bfloat16 (a decode step)", err_d,
            lambda: exit_confidence(h_d, w_d),
            lambda: exit_confidence_ref(h_d, w_d),
            lambda: torch.softmax(h_d @ w_d, dim=-1).max(dim=-1),
            h_d.numel() * 2 + w_d.numel() * 2 + m * 8, 2.0 * m * d * v,
            "bfloat16", **few)
    del w_q
    new_vocabulary_checks(torch, dev, rnd, plain_case, fused_case, rec_plain,
                          rec_fused, few)
    vlm_encdec_exit_checks(torch, dev, rnd, plain_case, fused_case,
                           rec_plain, rec_fused, few)
    return rec_plain, rec_fused


def new_vocabulary_checks(torch, dev, rnd, plain_case, fused_case, rec_plain,
                          rec_fused, few):
    """The exit at zamba2-1.2b's head (D 2048, V 32000: 250 whole column
    tiles) and phi3.5-moe's (D 4096, V 32064 = 250 x 128 + 64: the first
    vocabulary whose last 128-column tile is partial), at every shape the
    new paths give it: a bucketed edge (32 rows, mma.sync), the scan edge
    of a B = 32 micro-batch (38 x 32 = 1216 and 16 x 32 = 512 rows,
    wgmma), decode steps (38 x 8 = 304 and 38 rows for zamba2, 16 x 8 =
    128 for phi3.5, wgmma), plain and fused (rmsnorm; shared and per-row
    parameters). At V = 32064 the argmax and exact ties are placed in the
    partial last tile, in the last full tile and across their boundary:
    the lowest index must win, through both tiles, plain and fused.
    Every shape is timed against its plain version and one library
    call; its entries are ``at_*`` of the exit records."""
    from repro_torch.kernels.exit_confidence.ops import (
        exit_confidence, exit_confidence_fused)
    from repro_torch.kernels.exit_confidence.ref import (
        exit_confidence_fused_ref, exit_confidence_ref)
    bf16 = torch.bfloat16
    src = "src/repro_torch/kernels/exit_confidence/csrc/exit_confidence.cu"
    heads = {"zamba2": (2048, 32000, 38), "phi35": (4096, 32064, 16)}
    for name, (d, v, layers) in heads.items():
        w = rnd(d, v, scale=d ** -0.5).to(bf16)
        plain_shapes = [(f"at_{name}_lm_head", 32, "mma_sync"),
                        (f"at_{name}_scan", layers * 32, "wgmma"),
                        (f"at_decode_{name}_b8", layers * 8, "wgmma")]
        if layers > 32:
            plain_shapes.append((f"at_decode_{name}_b1", layers, "wgmma"))
        for key, m, tile in plain_shapes:
            h = rnd(m, d).to(bf16)
            err = plain_case(f"{key[3:]}_bf16", h, w, "bfloat16", lm=True,
                             tile=tile)
            rec_plain[key] = record(
                "exit_confidence", src,
                "src/repro/kernels/exit_confidence/kernel.py:100",
                f"h ({m},{d}) @ w ({d},{v}) bfloat16", err,
                lambda: exit_confidence(h, w),
                lambda: exit_confidence_ref(h, w),
                lambda: torch.softmax(h @ w, dim=-1).max(dim=-1),
                h.numel() * 2 + w.numel() * 2 + m * 8, 2.0 * m * d * v,
                "bfloat16", **few)
        for key, m, tile, per_row in (
                (f"at_{name}_lm_head", 32, "mma_sync", False),
                (f"at_{name}_scan", layers * 32, "wgmma", True)):
            x = (rnd(m, d, scale=2.0) + 0.5).to(bf16)
            norm = {"scale": (rnd(*((m,) if per_row else ()), d, scale=0.1)
                              + 1.0).to(bf16)}
            err = fused_case(f"rmsnorm_{key[3:]}_bf16", x, norm, w, None,
                             "rmsnorm", "bfloat16", lm=True, tile=tile)
            rows = f"per-row ({m},{d})" if per_row else "shared (D,)"
            rec_fused[key] = record(
                "exit_confidence_fused", src,
                "src/repro/kernels/exit_confidence/kernel.py:186",
                f"rmsnorm x ({m},{d}), {rows} params, w ({d},{v}) bfloat16",
                err,
                lambda: exit_confidence_fused(x, norm, w, kind="rmsnorm"),
                lambda: exit_confidence_fused_ref(x, norm, w,
                                                  kind="rmsnorm"),
                None, x.numel() * 2 + w.numel() * 2 + m * 8
                + norm["scale"].numel() * 2,
                2.0 * m * d * v + 4.0 * m * d, "bfloat16", **few)
        del w

    # the partial last tile of V = 32064: columns 32000..32063
    d, v = 64, 32064
    ties = {"argmax at the last column": [32063],
            "tie in the partial last tile": [32001, 32063],
            "tie in the last full tile": [31873, 31999],
            "tie across the last two tiles": [31999, 32000]}
    for m in (32, 512):
        h_tie = torch.ones((m, d), device=dev, dtype=bf16)
        ones = {"scale": torch.ones(d, device=dev, dtype=bf16)}
        for what, cols in ties.items():
            w_tie = torch.zeros((d, v), device=dev, dtype=bf16)
            w_tie[:, cols] = 2.0
            want = exit_confidence_ref(h_tie, w_tie)[0]
            for kname, call in (
                    ("exit_confidence",
                     lambda: exit_confidence(h_tie, w_tie)),
                    ("exit_confidence_fused",
                     lambda: exit_confidence_fused(h_tie, ones, w_tie,
                                                   kind="rmsnorm"))):
                conf, pred = via(kname, "tensor_core", call,
                                 "mma_sync" if m <= 32 else "wgmma")
                if not (pred == min(cols)).all():
                    fail(f"{kname} at V = {v}, {what}, M = {m}: pred "
                         f"{pred.unique().tolist()} != {min(cols)}")
                check_close(f"{kname}[V {v}, {what}, M={m}]", conf, want,
                            "float32")
    print(f"  exit_confidence(+fused) at V = {v} (250 x 128 + 64), M = 32 "
          f"(mma.sync) and 512 (wgmma): {', '.join(ties)}: the lowest index "
          f"wins")


def vlm_encdec_exit_checks(torch, dev, rnd, plain_case, fused_case,
                           rec_plain, rec_fused, few):
    """The exit at qwen2-vl-2b's head (D 1536, V 151936) and at
    seamless-m4t-large-v2's (D 1024, V 256206: even, not a multiple of 8,
    so each row of w lies on 4 bytes only and the tensor-core variant
    stages it in 4-byte pieces), at the shapes their phases give it:
    qwen2-vl's bucketed edge (32 rows), its scan edge (28 x 32 = 896) and
    a decode step (28 x 8 = 224), plain and fused (rmsnorm); seamless's
    decode exit at split_layer (8 rows), a 32-row head and a step's
    every exit (24 x 8 = 192), plain and fused (layernorm). At V = 256206
    the argmax and exact ties are placed in the partial last 8-column
    chunk (columns 256200..256205), across the last two chunks, in and
    across the last full 128-column tile, and across a vocabulary split:
    the lowest index must win, plain and fused, through mma.sync and
    wgmma. Every shape is timed against its plain version and one
    library call; its entries are ``at_*`` of the exit records."""
    from repro_torch.kernels.exit_confidence.kernel import plan, tile_shape
    from repro_torch.kernels.exit_confidence.ops import (
        exit_confidence, exit_confidence_fused)
    from repro_torch.kernels.exit_confidence.ref import (
        exit_confidence_fused_ref, exit_confidence_ref)
    bf16 = torch.bfloat16
    src = "src/repro_torch/kernels/exit_confidence/csrc/exit_confidence.cu"
    heads = {
        "qwen2vl": (1536, 151936, "rmsnorm",
                    [("at_qwen2vl_lm_head", 32, False),
                     ("at_qwen2vl_scan", 28 * 32, True),
                     ("at_decode_qwen2vl_b8", 28 * 8, None)]),
        "seamless": (1024, 256206, "layernorm",
                     [("at_seamless_b8", 8, False),
                      ("at_seamless_b32", 32, None),
                      ("at_decode_seamless_b8", 24 * 8, True)])}
    for name, (d, v, kind, shapes) in heads.items():
        w = rnd(d, v, scale=d ** -0.5).to(bf16)
        lm = SEAMLESS_CONF_TOL if name == "seamless" else True
        for key, m, per_row in shapes:
            tile = "mma_sync" if m <= 32 else "wgmma"
            h = rnd(m, d).to(bf16)
            err = plain_case(f"{key[3:]}_bf16", h, w, "bfloat16", lm=lm,
                             tile=tile)
            rec_plain[key] = record(
                "exit_confidence", src,
                "src/repro/kernels/exit_confidence/kernel.py:100",
                f"h ({m},{d}) @ w ({d},{v}) bfloat16", err,
                lambda: exit_confidence(h, w),
                lambda: exit_confidence_ref(h, w),
                lambda: torch.softmax(h @ w, dim=-1).max(dim=-1),
                h.numel() * 2 + w.numel() * 2 + m * 8, 2.0 * m * d * v,
                "bfloat16", **few)
            if per_row is None:
                continue
            x = (rnd(m, d, scale=2.0) + 0.5).to(bf16)
            rows = (m,) if per_row else ()
            norm = {"scale": (rnd(*rows, d, scale=0.1) + 1.0).to(bf16)}
            if kind == "layernorm":
                norm["bias"] = rnd(*rows, d, scale=0.1).to(bf16)
            err = fused_case(f"{kind}_{key[3:]}_bf16", x, norm, w, None, kind,
                             "bfloat16", lm=lm, tile=tile)
            nbytes = sum(t.numel() * 2 for t in norm.values())
            rec_fused[key] = record(
                "exit_confidence_fused", src,
                "src/repro/kernels/exit_confidence/kernel.py:186",
                f"{kind} x ({m},{d}), "
                f"{f'per-row ({m},{d})' if per_row else 'shared (D,)'} "
                f"params, w ({d},{v}) bfloat16", err,
                lambda: exit_confidence_fused(x, norm, w, kind=kind),
                lambda: exit_confidence_fused_ref(x, norm, w, kind=kind),
                None, x.numel() * 2 + w.numel() * 2 + m * 8 + nbytes,
                2.0 * m * d * v + 8.0 * m * d, "bfloat16", **few)
        del w

    d, v = 64, 256206
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in (8, 192):
        split = plan(1, m, v, sms, *tile_shape("tensor_core", m)
                     ).cols_per_split
        ties = {"argmax at the last column": [256205],
                "tie in the partial last 8-column chunk": [256200, 256205],
                "tie across the last two chunks": [256199, 256200],
                "tie in the last full tile": [256000, 256127],
                "tie across the last full and the partial tile":
                    [256127, 256128],
                f"tie across a vocabulary split (at {split})":
                    [split - 1, split],
                "tie across the first and the last column": [0, 256205]}
        h_tie = torch.ones((m, d), device=dev, dtype=bf16)
        ones = {"scale": torch.ones(d, device=dev, dtype=bf16)}
        for what, cols in ties.items():
            w_tie = torch.zeros((d, v), device=dev, dtype=bf16)
            w_tie[:, cols] = 2.0
            want = exit_confidence_ref(h_tie, w_tie)[0]
            for kname, call in (
                    ("exit_confidence",
                     lambda: exit_confidence(h_tie, w_tie)),
                    ("exit_confidence_fused",
                     lambda: exit_confidence_fused(h_tie, ones, w_tie,
                                                   kind="rmsnorm"))):
                conf, pred = via(kname, "tensor_core", call,
                                 "mma_sync" if m <= 32 else "wgmma")
                if not (pred == min(cols)).all():
                    fail(f"{kname} at V = {v}, {what}, M = {m}: pred "
                         f"{pred.unique().tolist()} != {min(cols)}")
                check_close(f"{kname}[V {v}, {what}, M={m}]", conf, want,
                            "float32")
        print(f"  exit_confidence(+fused) at V = {v} (4-byte w pieces), "
              f"M = {m} ({'mma.sync' if m <= 32 else 'wgmma'}): "
              f"{', '.join(ties)}: the lowest index wins")


def wkv6_checks(torch, dev):
    """The WKV6 kernel against its plain version: y and the final state,
    both float32, at rtol = atol = WKV6_TOL, each case through the
    variant it must take (`vec16` on 16-byte rows, `scalar` otherwise).
    Prints each instantiation's residency; times the serving shape at
    B = 32 and at the small depth bucket B = 4."""
    from repro_torch.kernels.wkv6.kernel import VARIANTS, occupancy
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    gen = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32

    for dtype in (bf16, f32):
        for dk in (32, 64):                      # the two instantiations
            for variant in VARIANTS:
                occ = occupancy(dtype, dk, variant)
                print(f"  wkv6 {str(dtype).split('.')[1]} dk<={dk} {variant}:"
                      f" {occ['blocks_per_sm']} blocks/SM of 128 threads, "
                      f"{occ['registers']} registers, {occ['shared_bytes']} "
                      f"B shared, {occ['local_bytes']} B local (spill)")
                if occ["local_bytes"]:
                    fail(f"wkv6 {dtype} dk {dk} {variant} spills")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = occupancy(bf16, 64, "vec16")["blocks_per_sm"] * sms
    print(f"  wkv6 bf16 dk 64 vec16: {resident} blocks resident at once on "
          f"{sms} SMs, of the 1280 of the serving shape")

    def inputs(b, h, t, dk, dv, dtype):
        rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                     device=dev)
        r, k, v = rnd(b, h, t, dk), rnd(b, h, t, dk), rnd(b, h, t, dv)
        # the model's decay, exp(-exp(.)) in (0, 1), in float32
        w = torch.exp(-torch.exp(rnd(b, h, t, dk).clamp(-10.0, 2.0) - 1.0))
        u = rnd(h, dk) * 0.1
        return (r.to(dtype), k.to(dtype), v.to(dtype), w, u.to(dtype))

    def case(name, args, variant="vec16"):
        y, s = via("wkv6", variant, lambda: wkv6(*args))
        wy, ws = wkv6_ref(*args)
        torch.cuda.synchronize()
        errs = []
        for part, got, want in (("y", y, wy), ("state", s, ws)):
            if got.dtype != torch.float32 or got.shape != want.shape:
                fail(f"wkv6[{name}] {part}: {got.dtype} {tuple(got.shape)},"
                     f" want float32 {tuple(want.shape)}")
            err = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=WKV6_TOL, atol=WKV6_TOL) \
                    or not torch.isfinite(got).all():
                fail(f"wkv6[{name}] {part}: kernel vs plain max |err| "
                     f"{err:.3e} > tol {WKV6_TOL}")
            errs.append(err)
        print(f"  wkv6[{name}] ({variant}) max|err| y {errs[0]:.3e}, state "
              f"{errs[1]:.3e} (tol {WKV6_TOL})")
        return max(errs)

    def relaid(args, layout):
        """The same values in another layout: one element into a buffer,
        or every other element of rows twice as long."""
        out = []
        for a in args:
            if a.ndim != 4:
                out.append(a)
            elif layout == "offset1":
                buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
                out.append(buf[1:].view(a.shape).copy_(a))
            else:
                buf = torch.empty((*a.shape[:3], 2 * a.shape[3]),
                                  dtype=a.dtype, device=dev)
                out.append(buf[..., ::2].copy_(a))
        return tuple(out)

    main = inputs(32, 40, 64, 64, 64, bf16)      # the rwkv6-3b serving shape
    err_main = case("main_bf16", main)
    case("main_f32", tuple(a.float() for a in main))
    case("smoke_dk16_f32", inputs(4, 8, 64, 16, 16, f32))
    for t in (1, 17, 100, 300):
        case(f"t{t}_bf16", inputs(2, 4, t, 64, 64, bf16))
    case("dk48_dv40_f32", inputs(2, 3, 33, 48, 40, f32))
    # (B, S, H, hd) -> (B, H, S, hd) views, as time_mix passes them
    case("strided_bf16", tuple(a.transpose(1, 2).contiguous().transpose(1, 2)
                               if a.ndim == 4 else a for a in main))
    # w = 0 wipes the state every step: y_t depends on token t alone
    r, k, v, w, u = inputs(2, 4, 40, 64, 64, f32)
    case("w0_f32", (r, k, v, torch.zeros_like(w), u))
    case("bh10240_bf16", inputs(256, 40, 64, 64, 64, bf16))
    # the element path: rows off 16 bytes, and a feature stride of 2
    small = inputs(4, 40, 37, 64, 64, bf16)
    case("offset1_bf16", relaid(small, "offset1"), "scalar")
    case("feature_stride2_f32", relaid(tuple(a.float() for a in small),
                                       "stride2"), "scalar")

    def timed(args, shape_note):
        r, k, v, w, u = args
        b, h, t, dk = r.shape
        dv = v.shape[-1]
        # bytes: r, k, v, u read in bf16, w in f32; y and the state written
        # in f32. operations: 5 per (step, i, j) — the state update
        # w*S + k*v (3) and the readout r*S summed over i (2)
        nbytes = ((2 * dk + dv) * 2 + dk * 4) * b * h * t + h * dk * 2 \
            + (b * h * t * dv + b * h * dk * dv) * 4
        return record(
            "wkv6", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
            "src/repro/kernels/wkv6/kernel.py:57",
            f"r/k/v ({b},{h},{t},{dk}) bfloat16, w float32, u ({h},{dk})"
            f"{shape_note}", err_main,
            lambda: via("wkv6", "vec16", lambda: wkv6(r, k, v, w, u)),
            lambda: wkv6_ref(r, k, v, w, u),
            None,       # no single PyTorch call computes this recurrence
            nbytes, 5.0 * b * h * t * dk * dv, "float32", "vec16")

    rec = timed(main, "")
    rec["at_b4"] = timed(tuple(a[:4] if a.ndim == 4 else a for a in main),
                         " (a depth bucket of 4)")
    rec["at_b8"] = timed(tuple(a[:8] if a.ndim == 4 else a for a in main),
                         " (the decode prefill of B = 8)")
    return rec


# ------------------------------------------------------------- serve phase

def calibrated_alpha(torch, params, cfg, tokens, layer: int) -> float:
    from repro_torch.models.transformer import forward_exits
    conf = forward_exits(params, cfg, {"tokens": torch.as_tensor(
        tokens, device=params["embed"].device)})["conf"]
    return float(conf[layer - 1].float().median())


def arm_histogram(arms, num_layers):
    import numpy as np
    return np.bincount(np.asarray(arms), minlength=num_layers).tolist()


def layer_launches(cfg, start: int, stop: int) -> int:
    """Launches of the family's layer kernel by layers start..stop-1: one
    a layer, but a hybrid's only after the layers its shared attention
    block follows ((i+1) % k == 0)."""
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        return sum(1 for i in range(start, stop) if (i + 1) % k == 0)
    return stop - start


def expected_launches(arms, exited, batch_size: int, cfg, fused: bool, *,
                      edge_mode: str = "bucketed", side_info: bool = False,
                      lm_head: bool = False):
    """Kernel launches the serving drivers make for these decisions.

    Per micro-batch, the edge: bucketed, one edge call per distinct arm a
    (the layer-kernel launches of layers 0..a, `layer_launches`, and one
    exit launch; SplitEE-S scores every exit in that one launch); scan,
    one masked forward (all L layers' layer-kernel launches and one exit
    launch over every exit); "auto" takes the scan for a micro-batch
    with >= 2 distinct arms, else the bucketed edge. The cloud: one call
    per distinct arm among the offloaded samples (layers a+1..L-1 and the
    final head, never fused). The sequential driver is micro-batches of
    one.

    Returns (launches by kernel, launches by "<kernel>/tensor_core/<tile>"
    at a shared LM head (``lm_head``; else empty), {rows: launches} of
    the wgmma edge exits): the LM head scores L x rows exits of a
    SplitEE-S or scan edge call, pow2-padded bucket rows otherwise."""
    import numpy as np
    from repro_torch.kernels.exit_confidence.kernel import tc_tile
    num_layers, layer_kernel = cfg.num_layers, LAYER_KERNEL[cfg.family]
    arms = np.asarray(arms)
    offloaded = ~np.asarray(exited).astype(bool)
    n = {name: 0 for name in MAIN_PATH}
    tiles, wgmma_rows = {}, {}
    edge_exit = "exit_confidence_fused" if fused else "exit_confidence"

    def pow2(k):
        return 1 << (k - 1).bit_length()

    def exit_launch(kernel, rows, edge):
        n[kernel] += 1
        if lm_head:
            key = f"{kernel}/tensor_core/{tc_tile(rows)}"
            tiles[key] = tiles.get(key, 0) + 1
            if edge and tc_tile(rows) == "wgmma":
                wgmma_rows[rows] = wgmma_rows.get(rows, 0) + 1

    for i in range(0, len(arms), batch_size):
        mb, off = arms[i:i + batch_size], offloaded[i:i + batch_size]
        scan = edge_mode == "scan" or (edge_mode == "auto"
                                       and len(np.unique(mb)) >= 2)
        if scan:
            n[layer_kernel] += layer_launches(cfg, 0, num_layers)
            exit_launch(edge_exit, num_layers * len(mb), True)
        else:
            for a in np.unique(mb):
                cap = pow2(int(np.sum(mb == a)))
                n[layer_kernel] += layer_launches(cfg, 0, int(a) + 1)
                exit_launch(edge_exit, num_layers * cap if side_info else cap,
                            True)
        for a in np.unique(mb[off]):
            n[layer_kernel] += layer_launches(cfg, int(a) + 1, num_layers)
            exit_launch("exit_confidence", pow2(int(np.sum(mb[off] == a))),
                        False)
    return n, tiles, wgmma_rows


class Runs:
    """Per-run launch counts of the serve phases (per kernel, variant and
    tile), each reset just before its run and read just after."""

    def __init__(self):
        self.counts, self.variants, self.tiles = {}, {}, {}

    def run(self, torch, name, fn, cfg, *, batch_size, fused=False,
            edge_mode="bucketed", side_info=False, full=True):
        """``fn()`` serves; its launches must be what its decisions need
        (`expected_launches`), every launch through the variant
        SERVE_VARIANTS names and, at the LM head, the tile its rows take.
        ``full``: a run of the whole stream, which must also pull every
        arm and both exit and offload. Returns (report, wall seconds,
        {rows: wgmma edge launches})."""
        import numpy as np
        from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                         tile_launch_counts,
                                         variant_launch_counts)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        variants = {k: n for k, n in variant_launch_counts().items() if n}
        tiles = {k: n for k, n in tile_launch_counts().items() if n}
        self.counts[name], self.variants[name] = counts, variants
        self.tiles[name] = tiles
        hist = arm_histogram(out["arms"], cfg.num_layers)
        n_exit = int(np.sum(out["exited"]))
        print(f"  {name}: {out['n']} samples in {dt:.3f}s = "
              f"{out['n'] / dt:.1f} samples/s; exits {n_exit}, offloads "
              f"{out['n'] - n_exit}, offload bytes {out['offload_bytes']}, "
              f"cost {out['cost_total']:.3f}, arms {hist}; launches {counts};"
              f" by variant {variants}; by tile {tiles}")
        if not np.isfinite(out["rewards"]).all():
            fail(f"{name}: non-finite rewards")
        if full and not 0 < n_exit < out["n"]:
            fail(f"{name}: exits {n_exit} of {out['n']}: need both exits "
                 f"and offloads")
        if full and min(hist) == 0:
            fail(f"{name}: not every arm was pulled: {hist}")
        layer_kernel = LAYER_KERNEL[cfg.family]
        lm_head = SERVE_VARIANTS[cfg.family]["exit_confidence"] == \
            "tensor_core"
        want, want_tiles, rows = expected_launches(
            out["arms"], out["exited"], batch_size, cfg, fused,
            edge_mode=edge_mode, side_info=side_info, lm_head=lm_head)
        if counts != want:
            fail(f"{name}: kernel launches {counts}, but its decisions "
                 f"need {want}")
        if tiles != want_tiles:
            fail(f"{name}: tensor-core exit launches by tile {tiles}, but "
                 f"its decisions need {want_tiles}")
        for kname in (layer_kernel, "exit_confidence") + \
                (("exit_confidence_fused",) if fused else ()):
            if counts[kname] <= 0:
                fail(f"{name}: kernel {kname} was not launched")
        for kname, variant in SERVE_VARIANTS[cfg.family].items():
            if variants.get(f"{kname}/{variant}", 0) != counts[kname]:
                fail(f"{name}: {counts[kname]} launches of {kname}, but not "
                     f"all through its {variant} variant: {variants}")
        if rows:
            print(f"    wgmma edge exit launches by rows: "
                  f"{dict(sorted(rows.items()))}")
        return out, dt, rows


def model_config(arch: str, layers: int | None = None):
    """``arch`` as published (bf16), cut to its first ``layers`` layers
    when given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def describe_heads(cfg) -> str:
    if cfg.family == "ssm":
        return (f"{cfg.ssm.num_heads or cfg.d_model // cfg.ssm.state_size} "
                f"WKV heads of {cfg.ssm.state_size}")
    heads = f"{cfg.num_heads}/{cfg.num_kv_heads} heads of " \
        f"{cfg.resolved_head_dim}"
    if cfg.family == "hybrid":
        return (f"Mamba2 (N {cfg.ssm.state_size}, expand {cfg.ssm.expand}, "
                f"chunk {cfg.ssm.chunk_size}) + one shared attention block "
                f"({heads}, d_ff {cfg.d_ff}) run after every "
                f"{cfg.hybrid_attn_every} layers")
    if cfg.family == "moe":
        return (f"{heads}, {cfg.moe.num_experts} experts top-"
                f"{cfg.moe.top_k} (capacity factor "
                f"{cfg.moe.capacity_factor})")
    if cfg.encoder is not None:
        e = cfg.encoder
        return (f"decoder {heads} with cross-attention; encoder "
                f"{e.num_layers} layers, d {e.d_model}, {e.num_heads}/"
                f"{e.num_kv_heads} heads, d_ff {e.d_ff}, {e.source_len} "
                f"frames")
    if cfg.mrope:
        return f"{heads}, M-RoPE, QKV bias"
    return heads


def init_full(torch, dev, cfg, seed: int):
    """``cfg``'s parameters from ``seed`` on the card (through the `Model`
    facade: the decoder stack, or an enc-dec model); prints their count,
    bytes and the init time."""
    from repro_torch.models.api import build_model
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"  {cfg.arch_id}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{describe_heads(cfg)}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.num_classes or 'LM'} classes, {cfg.dtype}; {n_params} "
          f"stored parameters = {n_bytes / 1e9:.3f} GB (analytic "
          f"param_count {cfg.param_count()}, without the norms), init "
          f"{time.perf_counter() - t0:.2f}s, device memory allocated "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    return params


def serve_setup(torch, dev, arch: str, alpha_layer: int, *,
                layers: int | None = None, samples: int = SERVE_SAMPLES,
                seed: int = 0, params=None):
    """Full-width ``arch`` (bf16, weights from ``seed``; cut to ``layers``
    when given, or ``params`` already on the card), the ``samples``-long
    imdb_like stream and the cost model with alpha calibrated through
    the kernels."""
    from repro_torch.core import CostModel
    from repro_torch.data import make_dataset

    cfg = model_config(arch, layers)
    if params is None:
        params = init_full(torch, dev, cfg, seed)
    data = make_dataset("imdb_like", samples, seed=1)
    calib = make_dataset("sst2_like", 64, seed=2)["tokens"]
    alpha = calibrated_alpha(torch, params, cfg, calib, layer=alpha_layer)
    cost = CostModel(num_layers=cfg.num_layers, alpha=alpha, offload=3.0)
    print(f"  alpha = median layer-{alpha_layer} confidence of 64 "
          f"calibration samples = {alpha:.6g}")
    return params, cfg, data, cost


def serve_phase(torch, dev, runs: Runs, params, cfg, data, cost,
                prefix: str = ""):
    """Serve the 512-sample stream at full width through the four runs of
    the drivers (batched B=32 plain / fused / SplitEE-S, sequential),
    each with its own launch counts. Run names are ``prefix`` + the run.
    Returns the bucketed B=32 run's report and wall time, its device busy
    time and the report, with a confidence trace, of the profiled run."""
    from repro_torch.data import OnlineStream
    from repro_torch.serving import (EdgeCloudRuntime, _serve_stream_batched,
                                     _serve_stream_sequential)

    # warm-up (cuBLAS handles and heuristics for each bucket shape), so
    # the timed runs below measure steady-state serving
    for fused, side in ((False, False), (True, False), (False, True)):
        _serve_stream_batched(EdgeCloudRuntime(cfg, device=dev, fused_exit=fused),
                              params, OnlineStream(data, seed=0), cost,
                              batch_size=SERVE_BATCH, side_info=side,
                              max_samples=4 * SERVE_BATCH)
    torch.cuda.synchronize()
    out = {}
    for name, side, fused in (("batched B=32", False, False),
                              ("batched B=32 fused_exit", False, True),
                              ("batched B=32 side_info", True, False)):
        rt = EdgeCloudRuntime(cfg, device=dev, fused_exit=fused)
        out[name] = runs.run(
            torch, prefix + name, lambda: _serve_stream_batched(
                rt, params, OnlineStream(data, seed=0), cost,
                batch_size=SERVE_BATCH, side_info=side),
            cfg, batch_size=SERVE_BATCH, fused=fused, side_info=side)
    rt = EdgeCloudRuntime(cfg, device=dev)
    runs.run(torch, prefix + "sequential", lambda: _serve_stream_sequential(
        rt, params, OnlineStream(data, seed=0), cost,
        max_samples=sequential_samples(cfg)), cfg, batch_size=1)

    # where the time goes: the device time of one more batched B=32 run
    # (profiled) against the wall time of the unprofiled run above; this
    # run, untimed, records the confidence trace decision_difference reads
    traced = []
    busy, per_kernel = device_ms(lambda: traced.append(_serve_stream_batched(
        rt, params, OnlineStream(data, seed=0), cost,
        batch_size=SERVE_BATCH, record_trace=True)), iters=1, warmup=0,
        check=cfg.family == "dense")
    report, wall, _ = out["batched B=32"]
    print_busy(f"{prefix}batched B=32", busy, wall * 1e3, per_kernel)
    if cfg.family in PROFILE_RANGES:
        print_ranges(f"{prefix}batched B=32, {RANGE_SAMPLES} samples",
                     cfg.family, lambda: _serve_stream_batched(
                         rt, params, OnlineStream(data, seed=0), cost,
                         batch_size=SERVE_BATCH, max_samples=RANGE_SAMPLES))
    return report, wall, busy, traced[0]


def sequential_samples(cfg) -> int:
    """Samples of a sequential run: enough that every arm is pulled."""
    return max(SEQUENTIAL_SAMPLES, cfg.num_layers)


def print_busy(name, busy, wall_ms, per_kernel):
    """Device busy against wall time, the 8 largest device entries, and
    the profiler total of each of the port's own kernels in the run."""
    print(f"  {name}: device busy {busy:.3f} ms (torch.profiler) of "
          f"{wall_ms:.3f} ms wall = {busy / wall_ms:.1%} busy, "
          f"{1 - busy / wall_ms:.1%} idle")
    for kname, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:9.4f} ms  {kname[:100]}")
    port = {}
    for kname, ms in per_kernel.items():
        m = PORT_KERNEL.search(kname)
        if m:
            port[m.group(1)] = port.get(m.group(1), 0.0) + ms
    print("    port kernels (profiler total in the run): " + ", ".join(
        f"{k} {ms:.4f} ms" for k, ms in sorted(port.items())))


def front_end_phase(torch, dev, runs: Runs, params, cfg, data, cost,
                    bucketed, prefix: str = ""):
    """The port's front door at full width: `serve()` with the scan and
    auto edge phases, the offload codec (bucketed, scan, sequential), a
    17-sample tail micro-batch, and an `Engine` with the fifo scheduler
    fed in ragged chunks, each with its own launch counts. The Engine's
    decisions must equal the one-shot scan run's; prints scan against
    bucketed samples/s, device busy time and decisions."""
    import numpy as np
    from repro_torch.data import OnlineStream
    from repro_torch.serving import (EdgeCloudRuntime, Engine, ServingConfig,
                                     serve)
    from repro_torch.serving.api import _codec_from_config

    B = SERVE_BATCH
    scan = ServingConfig(batch_size=B, edge_mode="scan")
    for fused, side in ((False, False), (True, False), (False, True)):
        serve(EdgeCloudRuntime(cfg, device=dev, fused_exit=fused), params,
              OnlineStream(data, seed=0), cost, scan,
              side_info=side, max_samples=4 * B)          # warm-up
    runs_cfg = [
        # name, config, fused, full stream
        ("scan B=32", scan, False, True),
        ("scan B=32 fused_exit", scan, True, True),
        ("scan B=32 side_info", dataclasses.replace(scan, side_info=True),
         False, True),
        ("auto B=32", ServingConfig(batch_size=B, edge_mode="auto"), False,
         True),
        ("int8 B=32", ServingConfig(batch_size=B, offload_quant="int8"),
         False, True),
        ("int4 sparsity 0.5 scan B=32",
         ServingConfig(batch_size=B, edge_mode="scan", offload_quant="int4",
                       offload_sparsity=0.5), False, True),
        ("sequential int8", ServingConfig(
            offload_quant="int8", max_samples=sequential_samples(cfg)),
         False, True),
        # one ragged micro-batch of 17 rows
        ("scan B=32 tail 17", dataclasses.replace(scan, max_samples=17),
         False, False),
    ]
    out = {}
    s_len = data["tokens"].shape[1]
    for name, config, fused, full in runs_cfg:
        rt = EdgeCloudRuntime(cfg, device=dev, fused_exit=fused)
        rep, dt, _ = out[name] = runs.run(
            torch, prefix + name,
            lambda: serve(rt, params, OnlineStream(data, seed=0), cost,
                          config),
            cfg, batch_size=config.batch_size, fused=fused,
            edge_mode=config.edge_mode, side_info=config.side_info,
            full=full)
        if rep.path != ("sequential" if config.batch_size == 1
                        else "batched"):
            fail(f"{name}: served by the {rep.path} path")
        codec = _codec_from_config(config)
        if codec is not None:
            offloads = int(rep.n - np.sum(rep.exited))
            want = offloads * codec.row_bytes(s_len, cfg.d_model, 2)
            if rep.offload_bytes != want:
                fail(f"{name}: offload bytes {rep.offload_bytes} != "
                     f"{offloads} offloads x {codec.row_bytes(s_len, cfg.d_model, 2)}"
                     f" wire bytes")
            print(f"    {offloads} offloads x "
                  f"{codec.row_bytes(s_len, cfg.d_model, 2)} wire bytes "
                  f"(ratio {codec.cost_ratio(s_len, cfg.d_model, 2):.4f} "
                  f"of bf16) = offload bytes")

    # an Engine with the fifo scheduler, fed in ragged chunks
    engine_cfg = ServingConfig(batch_size=B, edge_mode="scan",
                               scheduler="fifo")
    samples = list(OnlineStream(data, seed=0))
    rt = EdgeCloudRuntime(cfg, device=dev)

    def engine():
        eng = Engine(rt, params, cost, engine_cfg)
        i, chunks = 0, (5, 1, 7, 3, 16, 2, 30, 20, 12, 64, 33)
        while i < len(samples):
            for c in chunks:
                eng.submit(samples[i:i + c])
                i += c
        return eng.close()

    rep, _, _ = runs.run(torch, prefix + "engine fifo scan B=32", engine, cfg,
                         batch_size=B, edge_mode="scan")
    ref = out["scan B=32"][0]
    for key in ("arms", "exited", "preds"):
        if not np.array_equal(rep[key], ref[key]):
            fail(f"engine fifo: {key} differ from one-shot serve() scan")
    lat = rep["scheduler"]["latency_ms"]
    print(f"    engine == one-shot serve() scan (arms, exits, preds); "
          f"scheduler latency ms p50 {lat['p50']:.3f}, p99 {lat['p99']:.3f},"
          f" mean {lat['mean']:.3f}, max {lat['max']:.3f} over "
          f"{lat['count']} requests, {rep['scheduler']['batches']} batches")

    # scan against bucketed at B=32: samples/s, device busy, decisions
    # (the profiled runs, untimed, record the confidence traces)
    rt = EdgeCloudRuntime(cfg, device=dev)
    traced = []
    busy, per_kernel = device_ms(lambda: traced.append(serve(
        rt, params, OnlineStream(data, seed=0), cost,
        dataclasses.replace(scan, record_trace=True))), iters=1, warmup=0)
    rep, wall, _ = out["scan B=32"]
    print_busy(f"{prefix}scan B=32", busy, wall * 1e3, per_kernel)
    if cfg.family in PROFILE_RANGES:
        print_ranges(f"{prefix}scan B=32, {RANGE_SAMPLES} samples",
                     cfg.family, lambda: serve(
                         rt, params, OnlineStream(data, seed=0), cost,
                         dataclasses.replace(scan,
                                             max_samples=RANGE_SAMPLES)))
    b_rep, b_wall, b_busy, b_traced = bucketed
    print(f"  {prefix}B=32 scan vs bucketed: {rep['n'] / wall:.1f} vs "
          f"{b_rep['n'] / b_wall:.1f} samples/s, device busy {busy:.3f} vs "
          f"{b_busy:.3f} ms")
    decision_difference(prefix, b_traced, traced[0], cost.alpha)
    return rep


def same_run(name, got, ref):
    """``got`` equals ``ref`` bit for bit: arms, exits, preds, rewards,
    offload bytes, cost and the controller state."""
    import numpy as np
    for key in ("arms", "exited", "preds", "rewards"):
        if not np.array_equal(np.asarray(got[key]), np.asarray(ref[key])):
            fail(f"{name}: {key} differ")
    for key in ("offload_bytes", "cost_total"):
        if got[key] != ref[key]:
            fail(f"{name}: {key} {got[key]} != {ref[key]}")
    for key, want in ref["state"].items():
        if not np.array_equal(np.asarray(got["state"][key]),
                              np.asarray(want)):
            fail(f"{name}: controller state {key} differs")


def sharded_phase(torch, dev, runs: Runs, params, cfg, data, cost, bucketed,
                  scan, prefix: str = ""):
    """The sharded runtime (`serve(path="sharded")`) at R = 1 on the card:
    overlap off (bucketed and scan, each bitwise the batched path's run:
    ``bucketed`` from `serve_phase`, ``scan`` from `front_end_phase`),
    the depth-K offload pipeline at K = 1 and 2 and K = 1 with fused
    exits, and an `Engine` fed in ragged chunks (bitwise the one-shot
    K = 2 run); each run's launches held against its decisions. Prints
    samples/s, wall and device busy (torch.profiler over one more run) of
    sync, K = 1 and K = 2. R above the visible cards must raise. Returns
    {run name: (report, wall seconds, wgmma rows)} of the five runs."""
    import numpy as np
    from repro_torch.data import OnlineStream
    from repro_torch.serving import (EdgeCloudRuntime, Engine, ServingConfig,
                                     serve)

    B = SERVE_BATCH
    base = ServingConfig(path="sharded", batch_size=B)
    runs_cfg = [
        # name, config, fused, the batched run it must equal bitwise
        ("sharded R=1 sync", dataclasses.replace(base, overlap=False),
         False, bucketed[0]),
        ("sharded R=1 sync scan", dataclasses.replace(
            base, overlap=False, edge_mode="scan"), False, scan),
        ("sharded R=1 K=1", base, False, None),
        ("sharded R=1 K=2", dataclasses.replace(base, overlap_depth=2),
         False, None),
        ("sharded R=1 K=1 fused_exit", base, True, None),
    ]
    out = {}
    for name, config, fused, equal_to in runs_cfg:
        rt = EdgeCloudRuntime(cfg, device=dev, fused_exit=fused)
        rep, dt, _ = out[name] = runs.run(
            torch, prefix + name,
            lambda: serve(rt, params, OnlineStream(data, seed=0), cost,
                          config),
            cfg, batch_size=B, fused=fused, edge_mode=config.edge_mode)
        ov = rep.overlap
        if rep.path != "sharded" or rep.replicas != 1:
            fail(f"{name}: served by {rep.path} with {rep.replicas} "
                 f"replicas")
        want = ov["batches"] - 1 if config.overlap else 0
        if ov["batches_overlapped"] != want:
            fail(f"{name}: {ov['batches_overlapped']} of {ov['batches']} "
                 f"batches overlapped, want {want}")
        print(f"    overlap {ov}")
        if equal_to is not None:
            same_run(prefix + name, rep, equal_to)
            print(f"    == the batched path's {config.edge_mode} run bit "
                  f"for bit (arms, exits, preds, rewards, offload bytes, "
                  f"cost, controller state)")

    samples = list(OnlineStream(data, seed=0))
    rt = EdgeCloudRuntime(cfg, device=dev)

    def engine():
        eng = Engine(rt, params, cost,
                     dataclasses.replace(base, overlap_depth=2))
        i, chunks = 0, (5, 1, 7, 3, 16, 2, 30, 20, 12, 64, 33)
        while i < len(samples):
            for c in chunks:
                eng.submit(samples[i:i + c])
                i += c
        return eng.close()

    rep, _, _ = runs.run(torch, prefix + "sharded engine K=2", engine, cfg,
                         batch_size=B)
    same_run(prefix + "sharded engine K=2", rep, out["sharded R=1 K=2"][0])
    print("    engine == one-shot serve() K=2 bit for bit")

    def timed(config):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = serve(rt, params, OnlineStream(data, seed=0), cost, config)
        torch.cuda.synchronize()
        return rep["n"] / (time.perf_counter() - t0)

    # R = 1 sync against the batched path in turns (batched, sharded,
    # sharded, batched): the host's rate drifts between runs of one call
    sync = runs_cfg[0][1]
    batched = ServingConfig(batch_size=B)
    abba = [timed(c) for c in (batched, sync, sync, batched)]
    print(f"  {prefix}batched vs sharded R=1 sync, in turns: batched "
          f"{abba[0]:.1f}, {abba[3]:.1f}; sharded {abba[1]:.1f}, "
          f"{abba[2]:.1f} samples/s")

    # where the time goes: device busy (torch.profiler) of one more run
    # of each beside the unprofiled run's wall, and the port's launches
    for name in ("sharded R=1 sync", "sharded R=1 K=1", "sharded R=1 K=2"):
        config = next(c for n, c, _, _ in runs_cfg if n == name)
        busy, _ = device_ms(lambda: serve(
            rt, params, OnlineStream(data, seed=0), cost, config),
            iters=1, warmup=0)
        rep, wall, _ = out[name]
        launched = sum(runs.counts[prefix + name].values())
        print(f"  {prefix}{name}: {rep['n'] / wall:.1f} samples/s, wall "
              f"{wall * 1e3:.1f} ms, device busy {busy:.3f} ms "
              f"({busy / (wall * 1e3):.1%}); {launched} launches of the "
              f"port's kernels ({wall * 1e3 / launched:.3f} ms wall a "
              f"launch)")
    b_rep, b_wall, b_busy, _ = bucketed
    print(f"  {prefix}batched B=32 (serve phase): {b_rep['n'] / b_wall:.1f} "
          f"samples/s, busy {b_busy:.3f} ms over 512 samples")

    # no fallback: more replicas than visible cards raise
    over = torch.cuda.device_count() + 1
    try:
        serve(rt, params, OnlineStream(data, seed=0), cost,
              ServingConfig(batch_size=B, replicas=over))
    except ValueError as err:
        if "local device(s) visible" not in str(err):
            raise
        print(f"  replicas={over} on {over - 1} card(s) raises: {err}")
    else:
        fail(f"replicas={over} served on {over - 1} card(s)")
    return out


# one worker of `distributed_phase`'s clusters: a fresh interpreter that
# loads the kernels the parent built, makes full-width ElasticBERT-12 from
# the seed on cuda:0, warms up on its own batched path (no exchange round
# spent) and serves each run of SPLITEE_SMOKE, printing a RESULT line
DIST_WORKER = r'''
import base64, itertools, json, os, time
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.core import CostModel
from repro_torch.core.controller import state_from_bytes, state_to_bytes
from repro_torch.data import OnlineStream, make_dataset
from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                 variant_launch_counts)
from repro_torch.models.api import build_model
from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve
from repro_torch.serving.distributed import (ft_serving_context,
                                             init_distributed_from_env)

spec = json.loads(os.environ["SPLITEE_SMOKE"])
ft = spec["fault_tolerant"]
if not ft:
    init_distributed_from_env()
dev = torch.device("cuda", 0)
cfg = get_config("elasticbert12")
params = build_model(cfg).init(seed=spec["seed"], device=dev)
digest = sum(float(p.double().sum()) for p in params.parameters())
data = make_dataset("imdb_like", spec["samples"], seed=1)
cost = CostModel(num_layers=cfg.num_layers, alpha=spec["alpha"], offload=3.0)
B = spec["batch_size"]
serve(EdgeCloudRuntime(cfg, device=dev), params, OnlineStream(data, seed=0),
      cost, ServingConfig(batch_size=B, max_samples=4 * B))
torch.cuda.synchronize()
exchange, init_state, skip = None, None, 0
if ft:
    # after the model is up: a respawned worker asks to rejoin only once
    # it can serve, so no CUDA start-up stalls its first admitted round;
    # and only after the survivors served some rounds without it
    time.sleep(float(os.environ.get("SPLITEE_SMOKE_REJOIN_DELAY", "0")))
    exchange, init_state, skip = ft_serving_context(
        heartbeat_timeout=spec["heartbeat_timeout"])
for run in spec["runs"]:
    state, offset = init_state, skip
    if "init_state_b64" in run:
        state = state_from_bytes(base64.b64decode(run["init_state_b64"]))
        offset = run["skip"]
    config = ServingConfig(path="distributed", batch_size=B,
                           overlap=run["overlap"], record_states=True,
                           max_samples=spec["samples"] - offset)
    rt = EdgeCloudRuntime(cfg, device=dev, fused_exit=run["fused"])
    stream = itertools.islice(OnlineStream(data, seed=0), offset, None)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = serve(rt, params, stream, cost, config, exchange=exchange,
                init_state=state, stream_offset=offset)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = out["distributed"]
    print("RESULT " + json.dumps({
        "name": run["name"], "host": d["host_id"], "hosts": d["num_hosts"],
        "digest": digest, "n": out["n"], "skip": offset, "wall": wall,
        "arms": out["arms"].tolist(), "exited": out["exited"].tolist(),
        "samples_per_s": out["n"] / wall,
        "preds": out["preds"].tolist(), "rewards": out["rewards"].tolist(),
        "q": out["state"]["q"].tolist(), "n_state": out["state"]["n"].tolist(),
        "t": out["state"]["t"], "offload_bytes": out["offload_bytes"],
        "cost_total": out["cost_total"],
        "states": [base64.b64encode(state_to_bytes(s)).decode()
                   for s in out["states"]],
        "state_walls": [s["wall"] for s in out["states"]],
        "lost": d.get("lost_samples"), "reconf": d.get("reconfigurations"),
        "members_final": d.get("members_final"),
        "launches": launch_counts(),
        "variants": {k: v for k, v in variant_launch_counts().items() if v},
    }), flush=True)
'''


def run_cluster(name, hosts: int, spec, extra_env=None, **supervisor):
    """One launch of `DIST_WORKER` as a ``hosts``-process cluster
    (`run_supervised_cluster`, cut at DIST_CLUSTER_TIMEOUT_S). Returns
    the report, {slot: [RESULT dicts]} of the final incarnations and the
    launch's wall seconds; fails on a worker that exited non-zero."""
    from repro_torch.serving.distributed import run_supervised_cluster
    env = {"PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "SPLITEE_SMOKE": json.dumps(spec)}
    env.update(extra_env or {})
    t0 = time.perf_counter()
    rep = run_supervised_cluster(DIST_WORKER, hosts, env=env, cwd=str(ROOT),
                                 timeout=DIST_CLUSTER_TIMEOUT_S, **supervisor)
    wall = time.perf_counter() - t0
    results = {}
    for slot, proc in enumerate(rep.completed):
        if proc.returncode != 0:
            fail(f"{name}: worker {slot} exited {proc.returncode}:\n"
                 f"{proc.stderr[-4000:]}")
        results[slot] = [json.loads(line[len("RESULT "):])
                         for line in proc.stdout.splitlines()
                         if line.startswith("RESULT ")]
        if len(results[slot]) != len(spec["runs"]):
            fail(f"{name}: worker {slot} printed {len(results[slot])} "
                 f"results for {len(spec['runs'])} runs:\n"
                 f"{proc.stdout[-2000:]}")
    print(f"  {name}: {hosts} processes in {wall:.1f} s wall (start-up, "
          f"model build and warm-up included); incidents "
          f"{[(i.kind, i.slot, i.returncode, i.at) for i in rep.incidents]}")
    return rep, results, wall


def same_mirrors(name, a, b):
    """Two workers' results of one run: the same global result bit for
    bit (every host folds the identical gathered summaries)."""
    for key in ("arms", "exited", "preds", "rewards", "q", "n_state", "t",
                "states", "offload_bytes", "cost_total"):
        if a[key] != b[key]:
            fail(f"{name}: hosts {a['host']} and {b['host']} differ in "
                 f"{key}")


def check_slice_launches(name, res, cfg, fused: bool):
    """A worker's launches equal what its own slices' decisions need
    (`expected_launches` over each micro-batch's slice), all through the
    variants SERVE_VARIANTS names."""
    import numpy as np
    from repro_torch.serving.sharded import _shard_sizes
    want = {k: 0 for k in MAIN_PATH}
    hosts, host = res["hosts"], res["host"]
    for i in range(0, len(res["arms"]), SERVE_BATCH):
        arms = np.asarray(res["arms"][i:i + SERVE_BATCH])
        exited = np.asarray(res["exited"][i:i + SERVE_BATCH])
        sizes = _shard_sizes(len(arms), hosts)
        lo = sum(sizes[:host])
        if not sizes[host]:
            continue
        got, _, _ = expected_launches(arms[lo:lo + sizes[host]],
                                      exited[lo:lo + sizes[host]],
                                      sizes[host], cfg, fused)
        want = {k: want[k] + got[k] for k in want}
    if res["launches"] != want:
        fail(f"{name} host {host}: kernel launches {res['launches']}, but "
             f"its slices' decisions need {want}")
    for kname, variant in SERVE_VARIANTS[cfg.family].items():
        if res["variants"].get(f"{kname}/{variant}", 0) != \
                res["launches"][kname]:
            fail(f"{name} host {host}: {res['launches'][kname]} launches "
                 f"of {kname}, not all through {variant}: "
                 f"{res['variants']}")
    return want


def first_difference(torch, name, got, ref, params, cfg, samples, alpha):
    """``got``'s decisions equal ``ref``'s up to the first differing one,
    which may only be an exit flipped at an unchanged arm, by a sample
    whose confidence there (the card's, served alone) lies within
    PRED_TIE_GAP["bfloat16"] of alpha. Prints how many differ."""
    import numpy as np
    from repro_torch.models.transformer import forward_exits
    arms_a, arms_b = np.asarray(got["arms"]), np.asarray(ref["arms"])
    diff = np.nonzero((arms_a != arms_b) | (np.asarray(got["exited"])
                                            != np.asarray(ref["exited"])))[0]
    msg = (f"    {name}: decisions differing from the one-process run: "
           f"{len(diff)} of {len(arms_b)}")
    if len(diff):
        s = int(diff[0])
        if arms_a[s] != arms_b[s]:
            fail(f"{name}: the first differing decision (sample {s}) is an "
                 f"arm {arms_a[s]} vs {arms_b[s]}, not an exit flip")
        tokens = torch.as_tensor(np.asarray(samples[s]["tokens"])[None],
                                 device=params["embed"].device)
        conf = float(forward_exits(params, cfg, {"tokens": tokens})
                     ["conf"][int(arms_b[s]), 0])
        gap = abs(conf - alpha)
        msg += (f"; the first, sample {s}, an exit flipped at arm "
                f"{int(arms_b[s])}, confidence {conf:.6f}, {gap:.3e} from "
                f"alpha")
        if not gap < PRED_TIE_GAP["bfloat16"]:
            fail(f"{name}: sample {s}'s exit flipped {gap:.3e} from alpha, "
                 f"not within {PRED_TIE_GAP['bfloat16']}")
    print(msg)


def distributed_phase(torch, dev, runs: Runs, params, cfg, data, cost,
                      sharded, seed: int = 0):
    """The distributed runtime (`serve(path="distributed")`) on the card.

    1. One process, loopback exchange, in this process: overlap off and
       K = 1, each bit for bit the sharded R = 1 run of the same config
       (``sharded``, from `sharded_phase`); launches held as every run's.
    2. A fault-tolerant cluster of DIST_FT_HOSTS worker processes over a
       FileKV directory: host 1 killed at round DIST_KILL_EPOCH,
       respawned, rejoining. Detection within DIST_HB_TIMEOUT +
       DIST_DETECT_SLACK_S, exactly host 1's slice of the failure epoch
       lost (pred -1), the survivors' mirrors equal, the joiner's equal
       to theirs from its first round on.
    3. Two worker processes in lockstep over the TCPStore process 0
       serves: sync, K = 1 and K = 1 fused (mirrors bit for bit; the
       one-process run's decisions up to the first, which may only be an
       exit flipped near alpha; each worker's launches those of its own
       slices), then a run seeded with the fault-tolerant cluster's
       merged state at the failure epoch: from the next epoch until the
       rejoin the survivors' per-batch states equal it bit for bit.
    Workers share this card (each its own CUDA context, one intra-op
    thread), load the kernels this process built, and make the weights
    from ``seed``; alpha comes through the environment."""
    import tempfile

    from repro_torch.data import OnlineStream
    from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve
    from repro_torch.serving.faults import FAULT_KILL_EXIT
    from repro_torch.serving.sharded import _shard_sizes

    t_phase = time.perf_counter()
    B, n_samples = SERVE_BATCH, len(data["tokens"])
    digest = sum(float(p.double().sum()) for p in params.parameters())
    samples = list(OnlineStream(data, seed=0))

    # 1. one process, loopback exchange
    base = ServingConfig(path="distributed", batch_size=B)
    local = {}
    for name, config, equal_to in (
            ("distributed H=1 sync", dataclasses.replace(base, overlap=False),
             "sharded R=1 sync"),
            ("distributed H=1 K=1", base, "sharded R=1 K=1")):
        rt = EdgeCloudRuntime(cfg, device=dev)
        rep, _, _ = local[name] = runs.run(
            torch, name, lambda: serve(rt, params, OnlineStream(data, seed=0),
                                       cost, config),
            cfg, batch_size=B)
        if rep.path != "distributed" or rep.distributed != {
                "num_hosts": 1, "host_id": 0, "local_replicas": 1}:
            fail(f"{name}: served by {rep.path}, {rep.distributed}")
        same_run(name, rep, sharded[equal_to][0])
        print(f"    == {equal_to} bit for bit (arms, exits, preds, rewards, "
              f"offload bytes, cost, controller state)")
    sync_rate = n_samples / local["distributed H=1 sync"][1]

    spec = {"seed": seed, "alpha": cost.alpha, "samples": n_samples,
            "batch_size": B, "heartbeat_timeout": DIST_HB_TIMEOUT}

    # 2. fault tolerance: kill host 1 at DIST_KILL_EPOCH, respawn, rejoin
    kv_root = ROOT / "build"
    kv_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="splitee-kv-",
                                     dir=kv_root) as kv_dir:
        rep, res, ft_wall = run_cluster(
            f"fault-tolerant cluster over FileKV, kill:host=1,"
            f"epoch={DIST_KILL_EPOCH}",
            DIST_FT_HOSTS, dict(spec, fault_tolerant=True, runs=[
                {"name": "ft", "overlap": False, "fused": False}]),
            {"SPLITEE_KV_DIR": kv_dir,
             "SPLITEE_FAULTS": f"kill:host=1,epoch={DIST_KILL_EPOCH};"
                               f"sleep:host=*,epoch=*,secs={DIST_PACE_S}"},
            coordinator=False, fail_fast=False, respawn=True,
            max_respawns=1, respawn_env={
                "SPLITEE_SMOKE_REJOIN_DELAY": str(DIST_REJOIN_DELAY_S)})
    kinds = [(i.kind, i.slot, i.returncode) for i in rep.incidents]
    if kinds != [("exit", 1, FAULT_KILL_EXIT), ("respawn", 1,
                                                FAULT_KILL_EXIT)]:
        fail(f"fault-tolerant cluster: incidents {kinds}, want host 1's "
             f"injected exit ({FAULT_KILL_EXIT}) and one respawn")
    a0, joiner, a2 = res[0][0], res[1][0], res[2][0]
    for r in (a0, joiner, a2):
        if r["digest"] != digest:
            fail(f"host {r['host']}'s weights differ from this process's")
    same_mirrors("fault-tolerant survivors", a0, a2)
    removed = [c for c in a0["reconf"] if c["removed"]]
    joined = [c for c in a0["reconf"] if c["joined"]]
    if (len(removed) != 1 or removed[0]["round"] != DIST_KILL_EPOCH
            or removed[0]["removed"] != [1] or len(joined) != 1
            or joined[0]["joined"] != [1]):
        fail(f"fault-tolerant cluster: reconfigurations {a0['reconf']}")
    detect = removed[0]["detect_s"]
    if not detect <= DIST_HB_TIMEOUT + DIST_DETECT_SLACK_S:
        fail(f"detection took {detect} s, over heartbeat_timeout "
             f"{DIST_HB_TIMEOUT} + {DIST_DETECT_SLACK_S} s")
    first = joined[0]["round"] + 1                 # its active_from (sync)
    lo = sum(_shard_sizes(B, DIST_FT_HOSTS)[:1])
    lost_rows = list(range(DIST_KILL_EPOCH * B + lo,
                           DIST_KILL_EPOCH * B + lo
                           + _shard_sizes(B, DIST_FT_HOSTS)[1]))
    if (a0["lost"] != len(lost_rows)
            or [i for i, p in enumerate(a0["preds"]) if p == -1]
            != lost_rows):
        fail(f"lost {a0['lost']} samples, preds -1 at "
             f"{[i for i, p in enumerate(a0['preds']) if p == -1]}; want "
             f"exactly host 1's slice of epoch {DIST_KILL_EPOCH}: "
             f"{lost_rows}")
    if (joiner["skip"] != first * B or joiner["n"] != n_samples - first * B
            or joiner["states"] != a0["states"][first:]
            or joiner["preds"] != a0["preds"][first * B:]
            or any(joiner[k] != a0[k] for k in ("q", "n_state", "t"))
            or a0["members_final"] != [0, 1, 2]):
        fail(f"the respawned host 1 (skip {joiner['skip']}, first round "
             f"{first}) does not mirror the survivors from its first round")
    walls = a0["state_walls"]
    print(f"  fault tolerance ({DIST_FT_HOSTS} processes, B = {B}, pace "
          f"{DIST_PACE_S} s a round, heartbeat_timeout {DIST_HB_TIMEOUT} "
          f"s): host 1 killed at round {DIST_KILL_EPOCH}, detected in "
          f"{detect:.3f} s (bound {DIST_HB_TIMEOUT + DIST_DETECT_SLACK_S}); "
          f"the failure round folded "
          f"{walls[DIST_KILL_EPOCH] - walls[DIST_KILL_EPOCH - 1]:.3f} s after "
          f"the round before; lost {a0['lost']} samples (host 1's slice "
          f"of round {DIST_KILL_EPOCH}); the respawned host 1 rejoined at "
          f"round {first} (skip {joiner['skip']}), its first fold "
          f"{joiner['state_walls'][0] - walls[DIST_KILL_EPOCH]:.3f} s after "
          f"the failure round's, its mirror == the survivors' over "
          f"{len(joiner['states'])} rounds; survivors "
          f"{a0['samples_per_s']:.1f} samples/s (paced)")

    # 3. lockstep over the TCPStore, and the seeded invariant run
    seeded = {"name": "seeded", "overlap": False, "fused": False,
              "init_state_b64": a0["states"][DIST_KILL_EPOCH],
              "skip": (DIST_KILL_EPOCH + 1) * B}
    lock_runs = [{"name": "sync", "overlap": False, "fused": False},
                 {"name": "K=1", "overlap": True, "fused": False},
                 {"name": "K=1 fused_exit", "overlap": True, "fused": True},
                 seeded]
    _, res, lock_wall = run_cluster(
        "lockstep cluster over the TCPStore", 2,
        dict(spec, fault_tolerant=False, runs=lock_runs))
    refs = {"sync": local["distributed H=1 sync"][0],
            "K=1": local["distributed H=1 K=1"][0],
            "K=1 fused_exit": sharded["sharded R=1 K=1 fused_exit"][0]}
    served = 0
    for i, run in enumerate(lock_runs):
        h0, h1 = res[0][i], res[1][i]
        name = f"distributed H=2 {run['name']}"
        for r in (h0, h1):
            if r["digest"] != digest or r["hosts"] != 2:
                fail(f"{name}: host {r['host']} of {r['hosts']}: weights "
                     f"differ or not a 2-host run")
        same_mirrors(name, h0, h1)
        served += h0["n"]
        print(f"  {name}: {h0['n']} samples, host 0 "
              f"{h0['samples_per_s']:.1f} / host 1 {h1['samples_per_s']:.1f}"
              f" samples/s; mirrors "
              f"equal bit for bit; launches host 0 {h0['launches']}, host 1 "
              f"{h1['launches']}")
        if run["name"] == "seeded":
            continue
        for r in (h0, h1):
            check_slice_launches(name, r, cfg, run["fused"])
        print("    each host's launches == its slices' decisions")
        first_difference(torch, name, h0, refs[run["name"]], params, cfg,
                         samples, cost.alpha)

    # the invariant: from the epoch after the failure until the rejoin,
    # the survivors == the 2-process run seeded with the merged state
    inv = res[0][-1]
    rounds = first - (DIST_KILL_EPOCH + 1)
    if rounds < 1:
        fail(f"host 1 rejoined at round {first}: no round between the "
             f"failure and the rejoin to hold the invariant on")
    lo_hist = (DIST_KILL_EPOCH + 1) * B - a0["lost"]
    rows = rounds * B
    if (a0["states"][DIST_KILL_EPOCH + 1:first] != inv["states"][:rounds]
            or any(a0[k][lo_hist:lo_hist + rows] != inv[k][:rows]
                   for k in ("arms", "exited", "rewards"))
            or a0["preds"][(DIST_KILL_EPOCH + 1) * B:first * B]
            != inv["preds"][:rows]):
        fail(f"the survivors' rounds {DIST_KILL_EPOCH + 1}..{first - 1} "
             f"differ from the 2-process run seeded with the merged state "
             f"of round {DIST_KILL_EPOCH}")
    print(f"  invariant: survivors' rounds {DIST_KILL_EPOCH + 1}..{first - 1}"
          f" ({rounds} rounds: per-batch q, n, t, arms, exits, rewards, "
          f"preds) == the 2-process run seeded with round "
          f"{DIST_KILL_EPOCH}'s merged state, bit for bit")
    print(f"  samples/s: one process (loopback) sync {sync_rate:.1f}; "
          f"lockstep cluster {served / lock_wall:.1f} over its launch "
          f"({served} samples of 4 runs in {lock_wall:.1f} s, start-up "
          f"included), workers' own above; fault-tolerant cluster "
          f"{n_samples / ft_wall:.1f} over its launch ({ft_wall:.1f} s)")
    print(f"  distributed phase: {time.perf_counter() - t_phase:.1f} s wall")


def decision_difference(prefix, a, b, alpha, names=("bucketed", "scan")):
    """How many served decisions (arm or exit) differ between run ``a``
    and run ``b`` (both with a confidence trace; ``names`` name them), the
    first differing sample's confidence at its arm relative to alpha, and
    how far from alpha the confidences of the samples whose exit flipped
    at an unchanged arm lie. Returns the index of the first differing
    sample, or None."""
    import numpy as np
    arms_a, arms_b = np.asarray(a["arms"]), np.asarray(b["arms"])
    diff = np.nonzero((arms_a != arms_b)
                      | (np.asarray(a["exited"]) != np.asarray(b["exited"])))[0]
    msg = f"  {prefix}decisions differing {names[1]} vs {names[0]}: " \
          f"{len(diff)} of {a['n']}"

    def rel(run, s):
        return (float(run["trace"]["conf_path"][s][-1]) - alpha) / alpha

    if len(diff):
        s = int(diff[0])
        msg += (f"; first at sample {s} (arms {int(arms_a[s])} / "
                f"{int(arms_b[s])}): conf (conf - alpha) / alpha "
                f"{rel(a, s):+.3%} {names[0]}, {rel(b, s):+.3%} {names[1]}")
        flips = [int(s) for s in diff if arms_a[s] == arms_b[s]]
        if flips:
            far = max(max(abs(rel(a, s)), abs(rel(b, s))) for s in flips)
            msg += (f"; {len(flips)} exits flipped at an unchanged arm, "
                    f"|conf - alpha| / alpha at most {far:.3%}")
    print(msg)
    return int(diff[0]) if len(diff) else None


def agreement_phase(torch, dev, params, cfg, data):
    """The card's kernel path against the port's CPU (plain-version) path:
    full-width exits in float32 (`forward_exits`, and `forward_exits_masked`
    over a depth vector that holds every arm), and the served decisions of
    a small float32 model exactly."""
    from repro_torch.models.transformer import (ParamTree, forward_exits,
                                                forward_exits_masked)

    # the serve phase's weights in float32 on both sides: what differs is
    # only the kernels vs the plain versions and the summation orders
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    n = cfg.num_layers                       # a sample at every arm
    toks = data["tokens"][:n]
    p_gpu = ParamTree(_tree_to(params, dev, torch.float32))
    p_cpu = ParamTree(_tree_to(params, "cpu", torch.float32))
    depths = torch.arange(n)
    for what, call in (
            ("forward_exits", lambda p, d: forward_exits(
                p, cfg32, {"tokens": torch.as_tensor(toks, device=d)})),
            ("forward_exits_masked", lambda p, d: forward_exits_masked(
                p, cfg32, {"tokens": torch.as_tensor(toks, device=d)},
                depths.to(d), window=0))):
        gpu, cpu = call(p_gpu, dev), call(p_cpu, "cpu")
        conf_g, conf_c = gpu["conf"].cpu(), cpu["conf"]
        err = (conf_g - conf_c).abs().max().item()
        if err > FULL_FORWARD_ATOL:
            fail(f"full-width {what}: card vs CPU conf max|err| {err:.3e} > "
                 f"{FULL_FORWARD_ATOL}")
        # two classes: a near-tie of the logits is a confidence near 0.5
        flips = gpu["pred"].cpu() != cpu["pred"]
        if (flips & (conf_c > 0.5 + 1e-3)).any():
            fail(f"full-width {what}: pred differs card vs CPU away from a "
                 f"tie")
        depth_note = f", depths 0..{n - 1}" if "masked" in what else ""
        print(f"  full-width elasticbert12 {what} (float32 weights, {n} "
              f"samples{depth_note}, {cfg.num_layers} exits): card vs CPU "
              f"conf max|err| {err:.3e} (tol {FULL_FORWARD_ATOL}), pred "
              f"differences {int(flips.sum())}")
    small_serve_agreement(torch, dev, "elasticbert12", data)


def lm_depths(torch, layers: int, rows: int = 8):
    """``rows`` exit depths spread over 0..layers-1, both ends included."""
    return torch.linspace(0, layers - 1, rows).round().long()


def lm_exit_runs(torch, tree, cut, inputs, depths, device, dtype):
    """`forward_exits` and `forward_exits_masked` (at ``depths``) of the
    parameter tree ``tree`` cast to ``dtype`` on ``device`` over the batch
    ``inputs`` (``{"tokens": ...}`` or a stub's ``{"embeds": ...}``);
    returns ``{what: {"conf", "pred"} on the CPU}``."""
    from repro_torch.models.transformer import (ParamTree, forward_exits,
                                                forward_exits_masked)
    p = ParamTree(_tree_to(tree, device, dtype))
    batch = {k: torch.as_tensor(v).to(device) for k, v in inputs.items()}
    out = {}
    for what, call in (
            ("forward_exits", lambda: forward_exits(p, cut, batch)),
            ("forward_exits_masked", lambda: forward_exits_masked(
                p, cut, batch, depths.to(device), window=0))):
        got = call()
        out[what] = {k: got[k].cpu() for k in ("conf", "pred")}
    del p
    return out


def lm_cut(params, cfg, layers: int):
    """The first ``layers`` layers of ``params`` and the config cut to them
    in float32."""
    cut = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    tree = {key: (_first_rows(params[key], layers) if key == "layers"
                  else params[key]) for key in params.keys()}
    return cut, tree


@contextlib.contextmanager
def float64_kept(torch):
    """``Tensor.float()`` returns float64 tensors unchanged. The plain
    versions cast to float32 on purpose (the reference's dtype steps);
    inside this context every step of the CPU path runs in float64."""
    orig = torch.Tensor.float

    def keep(self, *a, **k):
        return self if self.dtype == torch.float64 else orig(self, *a, **k)

    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = orig


def lm_depth_witness(torch, dev, params, cfg, data, layers: int,
                     strict: bool = True) -> bool:
    """`forward_exits` and `forward_exits_masked` of the first ``layers``
    layers (8 samples, depths spread over 0..layers-1) three ways: the
    card in float32, the CPU in float32 and the CPU in float64. The card
    must sit at most WITNESS_FACTOR times as far from float64 as the
    CPU's float32 does; a card farther off is a port fault. Prints every
    pair's max relative conf error; returns whether the card held (with
    ``strict``, fails instead)."""
    t0 = time.perf_counter()
    cut, tree = lm_cut(params, cfg, layers)
    toks = data["tokens"][:8]
    depths = lm_depths(torch, layers)
    inputs = {"tokens": toks}
    card = lm_exit_runs(torch, tree, cut, inputs, depths, dev, torch.float32)
    cpu32 = lm_exit_runs(torch, tree, cut, inputs, depths, "cpu",
                         torch.float32)
    with float64_kept(torch):
        cpu64 = lm_exit_runs(torch, tree, cut, inputs, depths, "cpu",
                             torch.float64)
    held = True
    for what in card:
        if cpu64[what]["conf"].dtype != torch.float64:
            fail(f"{what}: the float64 reading came back "
                 f"{cpu64[what]['conf'].dtype}")
        rel = {}
        for name, a, b in (("card f32 vs CPU f32", card, cpu32),
                           ("card f32 vs CPU f64", card, cpu64),
                           ("CPU f32 vs CPU f64", cpu32, cpu64)):
            ca, cb = a[what]["conf"].double(), b[what]["conf"].double()
            rel[name] = ((ca - cb).abs() / cb).max().item()
            rel[name + " pred"] = int((a[what]["pred"].long()
                                       != b[what]["pred"].long()).sum())
        ratio = rel["card f32 vs CPU f64"] / rel["CPU f32 vs CPU f64"]
        held = held and ratio <= WITNESS_FACTOR
        print(f"  full-width {cfg.arch_id} {what}, {layers} layers"
              f"{', depths ' + str(depths.tolist()) if 'masked' in what else ''}"
              f": conf max relative err " + ", ".join(
                  f"{n} {rel[n]:.3e} (pred differences {rel[n + ' pred']})"
                  for n in ("card f32 vs CPU f32", "card f32 vs CPU f64",
                            "CPU f32 vs CPU f64"))
              + f"; card's distance from f64 / CPU f32's {ratio:.3f} "
              f"(bound {WITNESS_FACTOR})")
        if strict and not ratio <= WITNESS_FACTOR:
            fail(f"full-width {cfg.arch_id} {what} at {layers} layers: the "
                 f"card's float32 is {ratio:.3f}x as far from float64 as the "
                 f"CPU's float32 (bound {WITNESS_FACTOR})")
    print(f"  [{cfg.arch_id} {layers}-layer float64 witness: "
          f"{time.perf_counter() - t0:.1f} s wall]", flush=True)
    return held


def lm_agreement_phase(torch, dev, params, cfg, data, layers: int = 8,
                       witness: bool = True, inputs=None):
    """An LM at full width (rwkv6-3b, zamba2-1.2b, phi3.5-moe, qwen2-vl),
    cut to its first ``layers`` layers of the serve phase's weights (over
    8 samples of ``data``, or the batch ``inputs``: a stub's embeds), in
    float32:
    `forward_exits` and `forward_exits_masked` (depths spread over
    0..layers-1) on the card (the layer and exit kernels) against the CPU
    (plain versions), an MoE's routing held by `compare_routes`; then the
    served decisions of the small float32 model of the arch (for a token
    batch). With ``witness``, all layers are held by `lm_depth_witness`,
    against a float64 CPU reading."""
    from repro_torch.models.common import apply_norm
    from repro_torch.models.transformer import (ParamTree, exit_hidden,
                                                _layer_full, _positions,
                                                embed_inputs, layer_params,
                                                pool_hidden)

    t0 = time.perf_counter()
    cut, tree = lm_cut(params, cfg, layers)
    tokens = inputs is None
    if tokens:
        inputs = {"tokens": data["tokens"][:8]}
    depths = lm_depths(torch, layers)
    moe = cfg.family == "moe"
    with route_records(moe) as routes_gpu:
        gpu = lm_exit_runs(torch, tree, cut, inputs, depths, dev,
                           torch.float32)
    with route_records(moe) as routes_cpu:
        cpu = lm_exit_runs(torch, tree, cut, inputs, depths, "cpu",
                           torch.float32)
    if moe:
        compare_routes(f"full-width {cfg.arch_id} cut to {layers} layers",
                       routes_gpu, routes_cpu)
    cpu_p = ParamTree(_tree_to(tree, "cpu", torch.float32))
    batch = {k: torch.as_tensor(v).cpu() for k, v in inputs.items()}

    def masked_logits():
        """The CPU's logits of every masked exit row (for check_pred)."""
        x = embed_inputs(cpu_p, cut, batch)
        pos = _positions(cut, *x.shape[:2])
        rows = []
        for i in range(layers):
            lp = layer_params(cpu_p["layers"], i)
            x = torch.where(i <= depths.reshape(-1, 1, 1),
                            _layer_full(cut, cpu_p, lp, x, pos, i,
                                        window=0)[0], x)
            rows.append(apply_norm(pool_hidden(cut, x), lp["exit_norm"],
                                   cut.norm))
        return _exit_logits(torch.stack(rows), cpu_p["exit_w"])

    logits_fns = {
        "forward_exits": lambda: _exit_logits(
            exit_hidden(cpu_p, cut, batch)[0], cpu_p["exit_w"]),
        "forward_exits_masked": masked_logits}
    for what, logits_fn in logits_fns.items():
        conf_g, conf_c = gpu[what]["conf"], cpu[what]["conf"]
        rel = ((conf_g - conf_c).abs() / conf_c).max().item()
        if not rel <= LM_FORWARD_RTOL:
            fail(f"full-width {cfg.arch_id} {what}: card vs CPU conf max "
                 f"relative err {rel:.3e} > {LM_FORWARD_RTOL}")
        flips = check_pred(f"full-width {cfg.arch_id} {what}",
                           gpu[what]["pred"], cpu[what]["pred"], logits_fn,
                           "float32")
        print(f"  full-width {cfg.arch_id} {what} cut to {layers} layers, "
              f"float32 (d {cfg.d_model}, vocab {cfg.vocab_size}; 8 samples"
              f"{', depths ' + str(depths.tolist()) if 'masked' in what else ''}"
              f"): card vs CPU conf max relative err {rel:.3e} (tol "
              f"{LM_FORWARD_RTOL}), conf max|err| "
              f"{(conf_g - conf_c).abs().max().item():.3e}, pred differences "
              f"at near-ties {flips}")
    print(f"  [{cfg.arch_id} {layers}-layer float32 agreement: "
          f"{time.perf_counter() - t0:.1f} s wall]")
    del cpu_p
    if witness:
        lm_depth_witness(torch, dev, params, cfg, data, cfg.num_layers)
    if tokens:
        small_serve_agreement(torch, dev, cfg.arch_id, data)


@contextlib.contextmanager
def route_records(active: bool = True):
    """While active, every `moe_route` call appends its decisions (top-k
    experts, kept entries and router probabilities, on the CPU) to the
    yielded list; the function is restored afterwards."""
    import repro_torch.models.mlp as mlp
    calls = []
    if not active:
        yield calls
        return
    orig = mlp.moe_route

    def recording(*a, **k):
        r = orig(*a, **k)
        calls.append({key: r[key].detach().cpu()
                      for key in ("top_e", "keep", "probs")})
        return r
    mlp.moe_route = recording
    try:
        yield calls
    finally:
        mlp.moe_route = orig


def compare_routes(name, card, cpu):
    """An MoE's routing on the card against the CPU's, call by call: the
    same number of dropped (over-capacity) entries, and the same top-k
    experts of every token except where the CPU's router probabilities
    of the two experts that swap lie within PRED_TIE_GAP (a near-tie the
    rounding may flip), each of which is printed; a flip away from a tie
    fails."""
    if len(card) != len(cpu):
        fail(f"{name}: {len(card)} MoE calls on the card, {len(cpu)} on the "
             f"CPU")
    drops = [(int((~a["keep"]).sum()), int((~b["keep"]).sum()))
             for a, b in zip(card, cpu)]
    flips = []
    for call, (a, b) in enumerate(zip(card, cpu)):
        for t in (a["top_e"] != b["top_e"]).any(-1).nonzero()[:, 0].tolist():
            ea, eb = a["top_e"][t].tolist(), b["top_e"][t].tolist()
            swapped = sorted(set(ea) ^ set(eb)) or ea
            p = b["probs"][t, swapped]
            gap = float(p.max() - p.min())
            flips.append((call, t, ea, eb, gap))
            print(f"    {name}: MoE call {call}, token {t}: top-k "
                  f"experts {ea} on the card, {eb} on the CPU; CPU router "
                  f"probability gap {gap:.3e}")
            if gap >= PRED_TIE_GAP["float32"]:
                fail(f"{name}: routing flips away from a near-tie (gap "
                     f"{gap:.3e})")
    if any(x != y for x, y in drops):
        fail(f"{name}: dropped entries per MoE call differ card vs CPU: "
             f"{drops}")
    print(f"  {name}: MoE routing card vs CPU over {len(cpu)} calls, "
          f"{sum(int(b['keep'].numel()) for b in cpu)} token-expert "
          f"entries: dropped entries per call equal "
          f"{[x for x, _ in drops]}; top-k flips at near-ties {len(flips)}")


def codec_agreement(torch, dev):
    """The offload codec's decode(encode(rows)) and its payload on the card
    bitwise equal to the CPU's, for every mode, on bf16 and f32 rows
    (rows with exact zeros of both signs and, in bf16, many equal
    magnitudes: the stable top-k order)."""
    from repro_torch.serving.offload_codec import OffloadCodec

    gen = torch.Generator().manual_seed(11)
    modes = [("none", 0.5), ("int8", 0.0), ("int8", 0.25), ("int4", 0.0),
             ("int4", 0.5)]
    checked = 0
    for dt in (torch.bfloat16, torch.float32):
        for k, s_len, d in ((3, 64, 768), (2, 64, 2560), (2, 7, 33)):
            rows = (torch.randn((k, s_len, d), generator=gen) * 3).to(dt)
            rows[0, 0, :8] = 0.0
            rows[0, 1, :8] = -0.0
            for quant, sparsity in modes:
                codec = OffloadCodec(quant=quant, sparsity=sparsity)
                enc_c, enc_g = codec.encode(rows), codec.encode(rows.to(dev))
                for part in ("data", "scale", "zero", "index"):
                    a, b = getattr(enc_c, part), getattr(enc_g, part)
                    if (a is None) != (b is None) or (a is not None and not (
                            a.dtype == b.dtype
                            and torch.equal(_bits(a), _bits(b.cpu())))):
                        fail(f"codec {quant}/{sparsity} {dt} ({k},{s_len},"
                             f"{d}): encoded {part} differs card vs CPU")
                dec_c, dec_g = codec.decode(enc_c), codec.decode(enc_g)
                if enc_g.row_bytes != codec.row_bytes(s_len, d,
                                                      rows.element_size()) \
                        or not torch.equal(_bits(dec_c), _bits(dec_g.cpu())):
                    fail(f"codec {quant}/{sparsity} {dt} ({k},{s_len},{d}): "
                         f"decode differs card vs CPU, or wire bytes")
                res = torch.randn(rows.shape, generator=gen) * 0.01
                fb_c = codec.encode_with_feedback(rows, res)
                fb_g = codec.encode_with_feedback(rows.to(dev), res.to(dev))
                for x, y in zip(fb_c[1:], fb_g[1:]):
                    if not torch.equal(_bits(x), _bits(y.cpu())):
                        fail(f"codec {quant}/{sparsity} {dt}: error feedback "
                             f"differs card vs CPU")
                checked += 1
    print(f"  offload codec: {checked} (mode, dtype, shape) cases, encoded "
          f"payload, decode and error-feedback residual bitwise equal card "
          f"vs CPU; wire bytes = row_bytes")


def _bits(t):
    """A tensor's bits as integers (bf16/f32 compared bit for bit, so
    -0.0 and 0.0 differ)."""
    import torch
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return t.contiguous().view(ints[t.dtype]) if t.dtype in ints else t


def small_serve_agreement(torch, dev, arch: str, data):
    """The small float32 model of ``arch`` served on the card and on the
    CPU (plain exits; fused exits with SplitEE-S; through `serve()` the
    scan and auto edge phases, int8 offloads and the sharded path at
    K = 1): identical decisions and accounting."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import CostModel
    from repro_torch.data import OnlineStream
    from repro_torch.models.transformer import ParamTree, forward_exits, init_params
    from repro_torch.serving import (EdgeCloudRuntime, ServingConfig,
                                     _serve_stream_batched, serve)

    small = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    sp_gpu = init_params(small, seed=5, device=dev)
    sp_cpu = ParamTree(_tree_to(sp_gpu, "cpu"))
    sub = {key: val[:96] for key, val in data.items()}
    conf = np.sort(forward_exits(sp_cpu, small, {"tokens": torch.as_tensor(
        sub["tokens"])})["conf"].numpy().ravel())
    lo, hi = len(conf) // 4, 3 * len(conf) // 4
    k = lo + int(np.argmax(np.diff(conf[lo:hi])))
    alpha = float(conf[k] + conf[k + 1]) / 2
    cost = CostModel(num_layers=small.num_layers, alpha=alpha, offload=3.0)
    runs = [
        ("plain exits", False, lambda rt, p: _serve_stream_batched(
            rt, p, OnlineStream(sub, seed=0), cost, batch_size=8)),
        ("fused exits + SplitEE-S", True, lambda rt, p: _serve_stream_batched(
            rt, p, OnlineStream(sub, seed=0), cost, batch_size=8,
            side_info=True))]
    for mode in ("scan", "auto"):
        runs.append((f"serve() {mode}", False, lambda rt, p, m=mode: serve(
            rt, p, OnlineStream(sub, seed=0), cost,
            ServingConfig(batch_size=8, edge_mode=m))))
    runs.append(("serve() int8", False, lambda rt, p: serve(
        rt, p, OnlineStream(sub, seed=0), cost,
        ServingConfig(batch_size=8, offload_quant="int8"))))
    runs.append(("serve() sharded K=1", False, lambda rt, p: serve(
        rt, p, OnlineStream(sub, seed=0), cost,
        ServingConfig(path="sharded", batch_size=8, overlap_depth=1))))
    for name, fused, call in runs:
        a, b = (call(EdgeCloudRuntime(small, device=d, fused_exit=fused), p)
                for p, d in ((sp_gpu, dev), (sp_cpu, "cpu")))
        for key in ("arms", "exited", "preds"):
            if not np.array_equal(a[key], b[key]):
                fail(f"small f32 {arch} serve ({name}): {key} differ card vs "
                     f"CPU")
        if a["offload_bytes"] != b["offload_bytes"] or \
                abs(a["cost_total"] - b["cost_total"]) > 1e-4:
            fail(f"small f32 {arch} serve ({name}): accounting differs")
        if not 0 < int(np.sum(a["exited"])) < len(a["exited"]):
            fail(f"small f32 {arch} serve ({name}): need both exits and "
                 f"offloads")
    print(f"  small float32 {arch} served on card and CPU ({', '.join(r[0] for r in runs)}; "
          f"96 samples, B=8; alpha {alpha:.5g} in a confidence gap of "
          f"{conf[k + 1] - conf[k]:.2e}): decisions identical")


# ------------------------------------------------------------ decode phase

def decode_expected(cfg, n: int, batch_size: int, tokens: int):
    """Launches a decode run needs, by kernel and by exit tile: a push of
    ``rows`` prompts makes the layer kernel's launches of all L layers in
    its prefill (attention or WKV6 once a layer; a hybrid's shared
    attention once an occurrence), then exactly one exit launch a decode
    step over its L x rows exit rows (mma.sync up to 32 rows, wgmma
    above); the one-token layers and the cloud resume launch no port
    kernel."""
    from repro_torch.kernels.exit_confidence.kernel import tc_tile
    counts = {name: 0 for name in MAIN_PATH}
    tiles = {}
    for start in range(0, n, batch_size):
        rows = min(batch_size, n - start)
        counts[LAYER_KERNEL[cfg.family]] += layer_launches(cfg, 0,
                                                           cfg.num_layers)
        counts["exit_confidence"] += tokens
        key = f"exit_confidence/tensor_core/{tc_tile(cfg.num_layers * rows)}"
        tiles[key] = tiles.get(key, 0) + tokens
    return counts, tiles


def decode_run(torch, runs: Runs, name, fn, cfg, n: int, batch_size: int,
               *, mixed: bool = True, tokens: int = DECODE_TOKENS):
    """``fn()`` serves ``n`` prompts with ``workload="decode"``, ``tokens``
    new tokens each; its launches, reset just before and read just
    after, must be `decode_expected`'s, each through DECODE_VARIANTS.
    ``mixed``: the run must both exit and offload. Returns (report, wall
    seconds)."""
    import numpy as np
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     tile_launch_counts,
                                     variant_launch_counts)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    variants = {k: c for k, c in variant_launch_counts().items() if c}
    tiles = {k: c for k, c in tile_launch_counts().items() if c}
    runs.counts[name], runs.variants[name] = counts, variants
    runs.tiles[name] = tiles
    dec = rep.decode
    exits, offloads = int(dec["exited_steps"].sum()), \
        int(dec["offloaded_steps"].sum())
    toks = dec["tokens"]
    print(f"  {name}: {dec['sequences']} sequences x {tokens} tokens "
          f"in {dt:.3f}s = {toks.size / dt:.1f} tokens/s (session "
          f"{dec['tokens_per_sec']:.1f}); exits {exits}, offloads "
          f"{offloads}, offload wire bytes {rep.offload_bytes}, arms "
          f"{arm_histogram(rep.arms, cfg.num_layers)}; launches {counts}; "
          f"by variant {variants}; by tile {tiles}")
    if rep.path != "decode" or toks.shape != (n, tokens) \
            or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{name}: path {rep.path}, tokens {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    if not np.isfinite(rep.rewards).all() or not np.all(
            dec["exited_steps"] ^ dec["offloaded_steps"]):
        fail(f"{name}: non-finite rewards, or a token both (or neither) "
             f"exited and offloaded")
    if mixed and not (exits and offloads):
        fail(f"{name}: exits {exits}, offloads {offloads}: need both")
    want, want_tiles = decode_expected(cfg, n, batch_size, tokens)
    if counts != want or tiles != want_tiles:
        fail(f"{name}: launches {counts} by tile {tiles}, but the decode "
             f"launch model needs {want} by tile {want_tiles}")
    for kname, variant in DECODE_VARIANTS[cfg.family].items():
        if variants.get(f"{kname}/{variant}", 0) != counts[kname]:
            fail(f"{name}: {counts[kname]} launches of {kname}, not all "
                 f"through its {variant} variant: {variants}")
    return rep, dt


def _trees_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(
            _trees_equal(torch, a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def decode_pins(torch, dev, rt, params, cfg, prompts, final, bandit,
                seed: int, n_tokens: int = DECODE_TOKENS):
    """The card's own pins, on the first push (8 prompts): forced-final
    serving == a plain `decode_step` loop bitwise (tokens, each step's
    logits, the final cache); the bandit run's recorded depths and
    offloads, replayed from a fresh prefill, regenerate its tokens; an
    offload at quant "none" re-syncs to the full-depth step bitwise."""
    import numpy as np
    from repro_torch.models.transformer import decode_step
    B, L = DECODE_BATCH, cfg.num_layers
    first = prompts[:B]
    S = first.shape[1]
    total = S + n_tokens
    lg0, caches = rt.prefill_fn(params, first, total)
    tok, gen_tokens, logits = lg0.argmax(-1), [], []
    with torch.no_grad():
        for t in range(n_tokens):
            lg, _, _, caches = decode_step(params, cfg, caches, tok, S + t,
                                           all_exits=True,
                                           window_seq_len=total)
            tok = lg.argmax(-1)
            gen_tokens.append(tok.cpu().numpy())
            logits.append(lg)
    if not np.array_equal(np.stack(gen_tokens, 1),
                          final.decode["tokens"][:B]):
        fail(f"{cfg.arch_id}: forced-final tokens differ from the plain "
             f"decode_step loop")
    lg0, m_caches = rt.prefill_fn(params, first, total)
    tok = lg0.argmax(-1)
    depths = torch.full((B,), L - 1, device=dev)
    for t in range(n_tokens):
        lg, _, _, _, tok, _, m_caches = rt.edge_fn(params, m_caches, tok,
                                                   S + t, depths, total)
        if not torch.equal(lg, logits[t]):
            fail(f"{cfg.arch_id}: forced-final step {t} logits differ from "
                 f"the plain loop's")
    if not _trees_equal(torch, caches, m_caches):
        fail(f"{cfg.arch_id}: forced-final cache differs from the plain "
             f"loop's")

    dec = bandit.decode
    lg0, caches = rt.prefill_fn(params, first, total)
    tok = lg0.argmax(-1)
    gen = np.zeros((B, n_tokens), np.int64)
    for t in range(n_tokens):
        arms = np.asarray(dec["realized_depths"][:B, t])
        d_dev = torch.as_tensor(arms, device=dev)
        _, _, pred, _, pred_fin, hidden, caches = rt.edge_fn(
            params, caches, tok, S + t, d_dev, total)
        toks = np.where(arms + 1 == L, pred_fin.cpu().numpy(),
                        pred.cpu().numpy()[arms, np.arange(B)])
        off = np.asarray(dec["offloaded_steps"][:B, t], bool)
        if off.any():
            _, _, pred_l, caches = rt.cloud_fn(
                params, caches, hidden, S + t, d_dev,
                torch.as_tensor(off, device=dev), total)
            toks[off] = pred_l.cpu().numpy()[off]
        gen[:, t] = toks
        tok = torch.as_tensor(toks, device=dev)
    if not np.array_equal(gen, dec["tokens"][:B]):
        fail(f"{cfg.arch_id}: the bandit run's ledger replayed from a fresh "
             f"prefill does not regenerate its tokens")

    rng = np.random.default_rng(seed + 1)
    _, caches = rt.prefill_fn(params, first, S + 1)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, B), device=dev)
    depths = torch.as_tensor(rng.integers(0, L - 1, B), device=dev)
    lg_full, *_, c_full = rt.edge_fn(params, caches, tok, S,
                                     torch.full((B,), L - 1, device=dev),
                                     S + 1)
    *_, hidden, c_edge = rt.edge_fn(params, caches, tok, S, depths, S + 1)
    lg_res, _, _, c_res = rt.cloud_fn(params, c_edge, hidden, S, depths,
                                      torch.ones(B, dtype=torch.bool,
                                                 device=dev), S + 1)
    if not (torch.equal(lg_full, lg_res)
            and _trees_equal(torch, c_full, c_res)):
        fail(f"{cfg.arch_id}: edge + resume at quant none differs from the "
             f"full-depth step")
    print(f"  {cfg.arch_id} on the card, first push of {B}: forced-final == "
          f"plain decode_step loop bitwise ({n_tokens} steps of tokens "
          f"and logits, final cache); the bandit ledger replayed from a "
          f"fresh prefill regenerates its tokens "
          f"({int(dec['offloaded_steps'][:B].sum())} offloads); edge at "
          f"depths {depths.tolist()} + resume == the full step bitwise")


def decode_agreement(torch, dev, params, cfg, prompts,
                     layers: int = DECODE_AGREE_LAYERS):
    """The same full-width weights cut to ``layers`` layers in float32,
    B = 2, on the card and on the CPU: a prefill and DECODE_AGREE_STEPS
    edge steps at mixed depths with a cloud resume of the rows below the
    final layer, both sides fed the CPU's tokens. Logits within
    LM_FORWARD_RTOL of the CPU's largest, exit confidences within
    LM_FORWARD_RTOL relative, tokens equal but at near-ties; an MoE's
    routing as `compare_routes` holds it."""
    import numpy as np
    from repro_torch.models.transformer import ParamTree
    from repro_torch.serving import DecodeRuntime
    t0 = time.perf_counter()
    L = layers
    cut, tree = lm_cut(params, cfg, L)
    first = prompts[:2]
    S = first.shape[1]
    total = S + DECODE_AGREE_STEPS
    sched = np.asarray([[L - 1, min(1, L - 1)], [0, L - 1],
                        [max(L - 2, 0), min(2, L - 1)], [L - 1, L - 1]])
    inputs = []                      # the CPU's token of every step
    routes = {}

    def run(device):
        p = ParamTree(_tree_to(tree, device, torch.float32))
        rt = DecodeRuntime(cut, device=device)
        with route_records(cfg.family == "moe") as rec:
            out = steps(p, rt, device)
        routes[str(device)] = rec
        del p
        return out

    def steps(p, rt, device):
        lg, caches = rt.prefill_fn(p, first, total)
        out = {"logits": [lg.cpu()], "conf": [], "tok_logits": []}
        tok = lg.argmax(-1)
        for t in range(DECODE_AGREE_STEPS):
            if device == "cpu":
                inputs.append(tok.numpy())
            tok = torch.as_tensor(inputs[t], device=device)
            d = torch.as_tensor(sched[t], device=device)
            lg, conf, _, _, _, hidden, caches = rt.edge_fn(
                p, caches, tok, S + t, d, total)
            active = torch.as_tensor(sched[t] < L - 1, device=device)
            lg_c, _, _, caches = rt.cloud_fn(p, caches, hidden, S + t, d,
                                             active, total)
            final = torch.where(active[:, None], lg_c, lg)
            out["logits"] += [lg.cpu(), lg_c.cpu()]
            out["conf"].append(conf.cpu())
            out["tok_logits"].append(final.cpu())
            tok = final.argmax(-1)
        return out

    cpu = run("cpu")
    card = run(dev)
    if cfg.family == "moe":
        compare_routes(f"{cfg.arch_id} decode, {L} layers",
                       routes[str(dev)], routes["cpu"])
    lg_err = max(((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(card["logits"], cpu["logits"]))
    conf_err = max(((a - b).abs() / b).max().item()
                   for a, b in zip(card["conf"], cpu["conf"]))
    if not (lg_err <= LM_FORWARD_RTOL and conf_err <= LM_FORWARD_RTOL):
        fail(f"{cfg.arch_id} decode card vs CPU ({L} layers f32): logits "
             f"{lg_err:.3e}, conf {conf_err:.3e} > {LM_FORWARD_RTOL}")
    flips = sum(check_pred(f"{cfg.arch_id} decode token step {t}",
                           a.argmax(-1), b.argmax(-1), lambda b=b: b,
                           "float32")
                for t, (a, b) in enumerate(zip(card["tok_logits"],
                                               cpu["tok_logits"])))
    print(f"  full-width {cfg.arch_id} cut to {L} layers, float32, B = 2, a "
          f"{S}-token prefill and {DECODE_AGREE_STEPS} steps at depths "
          f"{sched.tolist()} with a cloud resume: card vs CPU logits max|err|"
          f" / max|logit| {lg_err:.3e}, exit conf max relative err "
          f"{conf_err:.3e} (tol {LM_FORWARD_RTOL}), tokens differing at "
          f"near-ties {flips} [{time.perf_counter() - t0:.1f} s wall]")


def decode_phase(torch, dev, runs: Runs, arch: str, seed: int, *,
                 layers: int | None = None, params=None,
                 n_prompts: int = DECODE_PROMPTS,
                 tokens: int = DECODE_TOKENS, full: bool = True,
                 agree_layers: int = DECODE_AGREE_LAYERS):
    """Full-width ``arch`` (bf16, weights from ``seed``, or ``params``
    already on the card; cut to ``layers`` when given) served with
    ``workload="decode"``: ``n_prompts`` prompts of DECODE_PROMPT_LEN
    tokens drawn from ``seed``, ``tokens`` new tokens each. Runs, each
    with its own launch counts held against `decode_expected`: bandit and
    forced-final at B = DECODE_BATCH and, with ``full``, int8 + error
    feedback at B = DECODE_BATCH, bandit at B = 1 on 4 prompts, and an
    `Engine` (fifo) fed the first 24 prompts in ragged chunks, whose
    tokens and decisions must equal those of the one-shot bandit run's
    first 3 pushes. Prints tokens/s, exits/offloads and wire bytes of
    each run, and the device busy time of a one-push bandit and
    forced-final run (torch.profiler; for a hybrid or MoE also the time
    inside its plain-PyTorch blocks); then `decode_pins` and
    `decode_agreement` at ``agree_layers`` layers."""
    import numpy as np
    from repro_torch.core import CostModel
    from repro_torch.serving import DecodeRuntime, ServingConfig, serve
    from repro_torch.serving.kvcache import hidden_raw_bytes, step_slice_bytes

    cfg = model_config(arch, layers)
    L = cfg.num_layers
    if params is None:
        params = init_full(torch, dev, cfg, seed)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n_prompts, DECODE_PROMPT_LEN)).astype(np.int32)
    samples = [{"tokens": row} for row in prompts]
    rt = DecodeRuntime(cfg, device=dev)
    S, B = DECODE_PROMPT_LEN, DECODE_BATCH
    lg, caches = rt.prefill_fn(params, prompts[:B], S + tokens)
    conf = rt.edge_fn(params, caches, lg.argmax(-1), S,
                      torch.full((B,), L - 1, device=dev), S + tokens)[1]
    alpha = float(conf[L // 2 - 1].float().median())
    del lg, caches, conf
    cost = CostModel(num_layers=L, alpha=alpha, offload=3.0)
    print(f"  alpha = median layer-{L // 2} confidence of the first edge "
          f"step (8 prompts, through the kernels) = {alpha:.6g}; per-step "
          f"cache slice at the deepest split {step_slice_bytes(cfg, L - 1)} "
          f"B, hidden {hidden_raw_bytes(cfg)} B")
    base = ServingConfig(batch_size=B, workload="decode",
                         max_new_tokens=tokens)
    serve(rt, params, iter(samples[:B]), cost,
          dataclasses.replace(base, max_new_tokens=2))       # warm-up
    n = n_prompts
    plan = [("bandit", base, n, True),
            ("final", dataclasses.replace(base, split_policy="final"), n,
             False)]
    if full:
        plan += [("int8 feedback", dataclasses.replace(
                     base, offload_quant="int8",
                     offload_error_feedback=True), n, True),
                 ("bandit B=1", dataclasses.replace(
                     base, batch_size=1, max_samples=4), 4, False)]
    out = {}
    for name, config, count, mixed in plan:
        out[name] = decode_run(
            torch, runs, f"{arch} decode {name}",
            lambda c=config: serve(rt, params, iter(samples), cost, c),
            cfg, count, config.batch_size, mixed=mixed, tokens=tokens)
    if full:
        rep, _ = out["int8 feedback"]
        wire = rep.decode["wire_bytes_per_sequence"].sum()
        if rep.offload_bytes != wire:
            fail(f"{arch} decode int8: offload bytes {rep.offload_bytes} != "
                 f"the per-sequence ledger's {wire}")
        decode_engine(torch, runs, rt, params, cost, cfg, samples, base,
                      out["bandit"][0], tokens)

    for policy in ("bandit", "final"):
        config = dataclasses.replace(base, split_policy=policy,
                                     max_new_tokens=DECODE_PROFILE_TOKENS)
        call = lambda c=config: serve(rt, params, iter(samples[:B]),  # noqa
                                      cost, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy, per_kernel = device_ms(call, iters=1, warmup=0)
        label = (f"{arch} decode {policy} (one push of {B}, "
                 f"{DECODE_PROFILE_TOKENS} new tokens)")
        print_busy(label, busy, wall * 1e3, per_kernel)
        if cfg.family in PROFILE_RANGES:
            print_ranges(label, cfg.family, call)
    decode_pins(torch, dev, rt, params, cfg, prompts, out["final"][0],
                out["bandit"][0], seed, tokens)
    decode_agreement(torch, dev, params, cfg, prompts, agree_layers)
    del params
    torch.cuda.empty_cache()


def decode_engine(torch, runs, rt, params, cost, cfg, samples, base, ref,
                  tokens: int):
    """An `Engine` (fifo) fed the first prompts in DECODE_ENGINE_CHUNKS:
    its launches as `decode_run` holds them, its tokens and decisions
    equal to the one-shot run ``ref``'s first pushes."""
    import numpy as np
    from repro_torch.serving import Engine
    engine_cfg = dataclasses.replace(base, scheduler="fifo")
    n_eng = sum(DECODE_ENGINE_CHUNKS)
    arch = cfg.arch_id

    def engine():
        eng = Engine(rt, params, cost, engine_cfg)
        i = 0
        for c in DECODE_ENGINE_CHUNKS:
            eng.submit(samples[i:i + c])
            i += c
        return eng.close()

    rep, _ = decode_run(torch, runs, f"{arch} decode engine fifo", engine,
                        cfg, n_eng, base.batch_size, tokens=tokens)
    # the controller folds a push's rounds step-major: the first n_eng
    # prompts' rounds lead the one-shot run's history
    rounds = n_eng * tokens
    for key in ("arms", "exited", "preds"):
        if not np.array_equal(rep[key], np.asarray(ref[key])[:rounds]):
            fail(f"{arch} decode engine: {key} differ from one-shot serve()")
    if not np.array_equal(rep.decode["tokens"],
                          ref.decode["tokens"][:n_eng]):
        fail(f"{arch} decode engine: tokens differ from one-shot serve()")
    lat = rep["scheduler"]["latency_ms"]
    print(f"    engine == one-shot serve()'s first {n_eng} prompts (tokens, "
          f"arms, exits, preds); request latency ms p50 {lat['p50']:.1f}, "
          f"p99 {lat['p99']:.1f}")


def moe_phase(torch, dev, runs: Runs, seed: int):
    """phi3.5-moe at its published widths and MOE_LAYERS layers (bf16,
    weights from ``seed``, 42.1 GB): `serve()` bucketed and scan at B = 32
    on MOE_SAMPLES imdb_like samples, each run's launches held against its
    decisions, and the device time of the scan run inside the MoE blocks;
    card vs CPU on the first MOE_AGREE_LAYERS layers in float32 (routing,
    drops, exits); then the decode runs (bandit and forced-final at B = 8
    on MOE_PROMPTS prompts, MOE_TOKENS new tokens) with their pins and
    agreement. The weights are freed at the end."""
    from repro_torch.data import OnlineStream
    from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve

    cfg = model_config(MOE, MOE_LAYERS)
    params = init_full(torch, dev, cfg, seed)
    params, cfg, data, cost = serve_setup(
        torch, dev, MOE, MOE_LAYERS // 2, layers=MOE_LAYERS,
        samples=MOE_SAMPLES, params=params)
    prefix = f"{MOE} {MOE_LAYERS}L "
    B = SERVE_BATCH
    rt = EdgeCloudRuntime(cfg, device=dev)
    configs = {"bucketed B=32": ServingConfig(batch_size=B),
               "scan B=32": ServingConfig(batch_size=B, edge_mode="scan")}
    for config in configs.values():                    # warm-up
        serve(rt, params, OnlineStream(data, seed=0), cost,
              dataclasses.replace(config, max_samples=2 * B))
    out = {}
    for name, config in configs.items():
        out[name] = runs.run(
            torch, prefix + name,
            lambda c=config: serve(rt, params, OnlineStream(data, seed=0),
                                   cost, c),
            cfg, batch_size=B, edge_mode=config.edge_mode)
    call = lambda: serve(rt, params, OnlineStream(data, seed=0), cost,  # noqa
                         configs["scan B=32"])
    busy, per_kernel = device_ms(call, iters=1, warmup=0)
    print_busy(f"{prefix}scan B=32", busy, out["scan B=32"][1] * 1e3,
               per_kernel)
    print_ranges(f"{prefix}scan B=32, {RANGE_SAMPLES} samples", cfg.family,
                 lambda: serve(rt, params, OnlineStream(data, seed=0), cost,
                               dataclasses.replace(configs["scan B=32"],
                                                   max_samples=RANGE_SAMPLES)))
    (b_rep, b_wall, _), (s_rep, s_wall, _) = out["bucketed B=32"], \
        out["scan B=32"]
    print(f"  {prefix}B=32 scan vs bucketed: {s_rep['n'] / s_wall:.1f} vs "
          f"{b_rep['n'] / b_wall:.1f} samples/s")
    lm_agreement_phase(torch, dev, params, cfg, data,
                       layers=MOE_AGREE_LAYERS, witness=False)
    decode_phase(torch, dev, runs, MOE, seed, layers=MOE_LAYERS,
                 params=params, n_prompts=MOE_PROMPTS, tokens=MOE_TOKENS,
                 full=False, agree_layers=MOE_AGREE_LAYERS)
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------ VLM and enc-dec

def counted_run(torch, runs: Runs, name, fn):
    """``fn()``, with every launch count set to 0 just before it and read
    just after; ``fn`` returns (out, launches by kernel, launches by exit
    tile) that its own decisions need. The counts must equal them, and
    every launch must have taken its kernel's tensor-core variant.
    Records the counts under ``name``. Returns (out, wall seconds)."""
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     tile_launch_counts,
                                     variant_launch_counts)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, want, want_tiles = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    variants = {k: n for k, n in variant_launch_counts().items() if n}
    tiles = {k: n for k, n in tile_launch_counts().items() if n}
    runs.counts[name], runs.variants[name] = counts, variants
    runs.tiles[name] = tiles
    want = {k: want.get(k, 0) for k in counts}
    print(f"  {name}: {dt:.3f}s wall; launches {counts}; by variant "
          f"{variants}; by tile {tiles}")
    if counts != want or tiles != want_tiles:
        fail(f"{name}: launches {counts} by tile {tiles}, but its decisions "
             f"need {want} by tile {want_tiles}")
    for kname, n in counts.items():
        if variants.get(f"{kname}/tensor_core", 0) != n:
            fail(f"{name}: {n} launches of {kname}, not all through its "
                 f"tensor_core variant: {variants}")
    return out, dt


def _exit_launch(want, tiles, kernel, rows):
    """Tally one tensor-core exit launch over ``rows`` rows."""
    from repro_torch.kernels.exit_confidence.kernel import tc_tile
    want[kernel] = want.get(kernel, 0) + 1
    key = f"{kernel}/tensor_core/{tc_tile(rows)}"
    tiles[key] = tiles.get(key, 0) + 1


def vlm_phase(torch, dev, runs: Runs, seed: int):
    """qwen2-vl-2b as published (bf16, weights from ``seed``) over seeded
    embeds: `EdgeCloudRuntime` with each micro-batch's edge at a seeded
    depth and `cloud_fn` for its rows under alpha (plain and fused exits),
    `edge_fn_s` and `edge_scan_fn` at per-row depths, each run's
    attention and exit launches held against its depths and decisions;
    samples/s of the halves and device busy. Then decode: embed prompts
    through `prefill` and greedy `decode_step(all_exits=True)`, and
    through `decode_step_masked` / `decode_step_resume` at seeded
    depths (28 attention launches a push; one exit launch a step, none
    in a resume), with tokens/s and busy; card vs CPU in float32 on a
    VLM_AGREE_LAYERS-layer cut."""
    import numpy as np
    from repro_torch.models import transformer as tf
    from repro_torch.serving import EdgeCloudRuntime

    cfg = model_config(VLM)
    L, B, S = cfg.num_layers, VLM_BATCH, VLM_POSITIONS
    params = init_full(torch, dev, cfg, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    embeds = [torch.randn((B, S, cfg.d_model), generator=gen,
                          device=dev).to(torch.bfloat16)
              for _ in range(VLM_MICRO_BATCHES)]
    conf0 = tf.forward_exits(params, cfg, {"embeds": embeds[0]})["conf"]
    alpha = float(conf0[VLM_ALPHA_LAYER - 1].float().median())
    rng = np.random.default_rng(seed)
    depths = rng.integers(0, L, VLM_MICRO_BATCHES)
    row_depths = rng.integers(0, L, (VLM_MICRO_BATCHES, B))
    n = B * VLM_MICRO_BATCHES
    print(f"  {n} seeded embed rows of {S} x {cfg.d_model} in "
          f"{VLM_MICRO_BATCHES} micro-batches of {B}; alpha = median "
          f"layer-{VLM_ALPHA_LAYER} confidence = {alpha:.6g}; edge depths "
          f"{depths.tolist()}")

    def halves(rt, fused):
        want, tiles = {"flash_attention": 0}, {}
        edge_s = cloud_s = 0.0
        offloads = 0
        for e, d in zip(embeds, depths.tolist()):
            t0 = time.perf_counter()
            conf, _, hidden = rt.edge_fn(params, {"embeds": e}, d)
            low = torch.nonzero(conf < alpha).flatten()
            n_low = int(low.numel())
            edge_s += time.perf_counter() - t0
            want["flash_attention"] += d + 1
            _exit_launch(want, tiles, "exit_confidence_fused" if fused
                         else "exit_confidence", B)
            if n_low:
                t0 = time.perf_counter()
                conf_l, _ = rt.cloud_fn(params, hidden[low], d)
                if not torch.isfinite(conf_l).all():
                    fail(f"{VLM} cloud_fn: non-finite confidences")
                cloud_s += time.perf_counter() - t0
                offloads += n_low
                want["flash_attention"] += L - d - 1
                _exit_launch(want, tiles, "exit_confidence", n_low)
        return (offloads, edge_s, cloud_s), want, tiles

    rt = {fused: EdgeCloudRuntime(cfg, device=dev, fused_exit=fused)
          for fused in (False, True)}
    halves(rt[False], False)                                  # warm-up
    walls = {}
    for fused in (False, True):
        name = f"{VLM} edge/cloud{' fused_exit' if fused else ''}"
        (offloads, edge_s, cloud_s), wall = counted_run(
            torch, runs, name, lambda f=fused: halves(rt[f], f))
        walls[fused] = wall
        print(f"    {n - offloads} exits, {offloads} offloads; edge half "
              f"{n / edge_s:.1f} samples/s, cloud half "
              f"{offloads / max(cloud_s, 1e-9):.1f} samples/s, "
              f"{n / wall:.1f} samples/s end to end")
        if not 0 < offloads < n:
            fail(f"{name}: {offloads} offloads of {n}: need both")
    busy, per_kernel = device_ms(lambda: halves(rt[False], False), iters=1,
                                 warmup=0)
    print_busy(f"{VLM} edge/cloud", busy, walls[False] * 1e3, per_kernel)

    def side():
        want, tiles = {"flash_attention": 0}, {}
        for e, d in zip(embeds, depths.tolist()):
            conf, _, _ = rt[False].edge_fn_s(params, {"embeds": e}, d)
            if tuple(conf.shape) != (L, B):
                fail(f"{VLM} edge_fn_s: conf {tuple(conf.shape)}")
            want["flash_attention"] += d + 1
            _exit_launch(want, tiles, "exit_confidence", L * B)
        return None, want, tiles

    def scan():
        want, tiles, hidden = {"flash_attention": 0}, {}, []
        for e, dd in zip(embeds, row_depths):
            _, _, h = rt[False].edge_scan_fn(params, {"embeds": e}, dd)
            hidden.append(h)
            want["flash_attention"] += L
            _exit_launch(want, tiles, "exit_confidence", L * B)
        return hidden, want, tiles

    _, wall = counted_run(torch, runs, f"{VLM} edge_fn_s", side)
    print(f"    edge_fn_s: {n / wall:.1f} samples/s")
    hidden, wall = counted_run(torch, runs, f"{VLM} edge_scan_fn", scan)
    print(f"    edge_scan_fn: {n / wall:.1f} samples/s")
    for d in np.unique(row_depths[0]).tolist():
        rows = torch.as_tensor(np.nonzero(row_depths[0] == d)[0],
                               device=dev)
        h = rt[False].edge_fn(params, {"embeds": embeds[0]}, d)[2]
        if not torch.equal(hidden[0][rows], h[rows]):
            fail(f"{VLM}: edge_scan_fn's carry at depth {d} differs from "
                 f"edge_fn's")
    print("    edge_scan_fn's per-row carry == edge_fn's at each row's "
          "depth, bitwise (first micro-batch)")
    vlm_decode(torch, dev, runs, params, cfg, embeds[0][:VLM_DECODE_PROMPTS],
               seed)
    lm_agreement_phase(torch, dev, params, cfg, None, layers=VLM_AGREE_LAYERS,
                       witness=False, inputs={"embeds": embeds[0][:8]})
    del params, embeds
    torch.cuda.empty_cache()


def vlm_decode(torch, dev, runs: Runs, params, cfg, prompts, seed: int):
    """Embed prompts decoded greedily through `prefill` and
    `decode_step(all_exits=True)`, then at seeded depths through
    `decode_step_masked` with `decode_step_resume` for the rows under
    alpha (the median layer-L/2 confidence of the first step)."""
    import numpy as np
    from repro_torch.models import transformer as tf
    L, b = cfg.num_layers, prompts.shape[0]
    P, T = prompts.shape[1], VLM_DECODE_TOKENS
    total = P + T
    rows = torch.arange(b, device=dev)
    first = {}

    def greedy():
        lg, caches = tf.prefill(params, cfg, {"embeds": prompts},
                                cache_seq_len=total)
        tok, out = lg.argmax(-1), []
        for t in range(T):
            lg, conf, _, caches = tf.decode_step(
                params, cfg, caches, tok, P + t, all_exits=True,
                window_seq_len=total)
            first.setdefault("conf", conf)
            tok = lg.argmax(-1)
            out.append(tok)
        want, tiles = {"flash_attention": L}, {}
        for _ in range(T):
            _exit_launch(want, tiles, "exit_confidence", L * b)
        return torch.stack(out, 1).cpu(), want, tiles

    def masked():
        lg, caches = tf.prefill(params, cfg, {"embeds": prompts},
                                cache_seq_len=total)
        tok, offloads = lg.argmax(-1), 0
        drng = np.random.default_rng(seed + 2)
        for t in range(T):
            d = torch.as_tensor(drng.integers(0, L, b), device=dev)
            lg, conf, pred, hidden, caches = tf.decode_step_masked(
                params, cfg, caches, tok, P + t, d, window_seq_len=total)
            active = (conf[d, rows] < alpha) & (d < L - 1)
            nxt = torch.where(d == L - 1, lg.argmax(-1), pred[d, rows].long())
            if bool(active.any()):
                lg_c, caches = tf.decode_step_resume(
                    params, cfg, caches, hidden, P + t, d, active,
                    window_seq_len=total)
                nxt = torch.where(active, lg_c.argmax(-1), nxt)
                offloads += int(active.sum())
            tok = nxt
        want, tiles = {"flash_attention": L}, {}
        for _ in range(T):
            _exit_launch(want, tiles, "exit_confidence", L * b)
        return offloads, want, tiles

    greedy()                                                  # warm-up
    toks, wall = counted_run(torch, runs, f"{VLM} decode all_exits", greedy)
    if toks.shape != (b, T) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        fail(f"{VLM} decode: tokens {tuple(toks.shape)}")
    busy, per_kernel = device_ms(greedy, iters=1, warmup=0)
    print(f"    {b} embed prompts of {P} x {T} greedy tokens: "
          f"{b * T / wall:.1f} tokens/s")
    print_busy(f"{VLM} decode all_exits", busy, wall * 1e3, per_kernel)
    alpha = float(first["conf"][L // 2 - 1].float().median())
    offloads, wall = counted_run(torch, runs, f"{VLM} decode masked+resume",
                                 masked)
    print(f"    masked edge + resume at seeded depths (alpha = median "
          f"layer-{L // 2} confidence of the first step = {alpha:.6g}): "
          f"{offloads} of {b * T} token steps offloaded, "
          f"{b * T / wall:.1f} tokens/s")
    if not 0 < offloads < b * T:
        fail(f"{VLM} decode masked: {offloads} offloads: need exits and "
             f"offloads")


@contextlib.contextmanager
def attention_calls():
    """Records (causal, Sq, Skv) of every block-attention call the models
    make (the name `models.attention` calls), passing each on."""
    from repro_torch.models import attention as attn_mod
    orig = attn_mod.flash_attention
    seen = []

    def wrapped(q, k, v, *, causal=True, window=0):
        seen.append((bool(causal), q.shape[2], k.shape[2]))
        return orig(q, k, v, causal=causal, window=window)
    attn_mod.flash_attention = wrapped
    try:
        yield seen
    finally:
        attn_mod.flash_attention = orig


def encdec_phase(torch, dev, runs: Runs, seed: int):
    """seamless-m4t-large-v2 as published (bf16, weights from ``seed``):
    seeded frames (ENCDEC_BATCH x 4096 x 1024), a prefix of
    ENCDEC_PREFIX target tokens, then ENCDEC_TOKENS greedy steps with
    every exit (`all_exits`) and with the exit at ENCDEC_SPLIT. A prefill
    launches attention 24 times bidirectional (encoder), 24 causal
    (decoder) and 24 as cross-attention, and no exit; a step one exit
    and no attention. Prints the encoder's, the prefill's and a step's
    device ms, tokens/s and busy; pins a step's logits to `prefill`'s
    over the prefix one token longer; card vs CPU in float32 on a cut."""
    from collections import Counter
    from repro_torch.models import encdec as ed
    from repro_torch.models.api import build_model

    cfg = model_config(ENCDEC)
    e = cfg.encoder
    L, B, P, T = cfg.num_layers, ENCDEC_BATCH, ENCDEC_PREFIX, ENCDEC_TOKENS
    model = build_model(cfg)
    params = init_full(torch, dev, cfg, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randn((B, e.source_len, e.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    prefix = torch.randint(0, cfg.vocab_size, (B, P + 1), generator=gen,
                           device=dev)
    batch = {"frames": frames, "tokens": prefix[:, :P]}
    total = P + T
    model.prefill(params, batch, cache_seq_len=total)         # warm-up
    enc_ms, _ = device_ms(lambda: ed.encode(params, cfg, frames), iters=3,
                          warmup=1)
    pre_ms, _ = device_ms(lambda: model.prefill(params, batch,
                                                cache_seq_len=total),
                          iters=3, warmup=0)

    def prefill_run():
        with attention_calls() as calls:
            out = model.prefill(params, batch, cache_seq_len=total)
            torch.cuda.synchronize()
        kinds = Counter(calls)
        want_kinds = {(False, e.source_len, e.source_len): e.num_layers,
                      (True, P, P): L, (False, P, e.source_len): L}
        if kinds != want_kinds:
            fail(f"{ENCDEC} prefill: attention calls {dict(kinds)}, want "
                 f"{want_kinds}")
        return out, {"flash_attention": e.num_layers + 2 * L}, {}

    (lg0, caches), wall_pre = counted_run(torch, runs, f"{ENCDEC} prefill",
                                          prefill_run)
    print(f"    encoder {enc_ms:.3f} ms, prefill {pre_ms:.3f} ms of device "
          f"time (torch.profiler); the prefill's attention calls: "
          f"{e.num_layers} bidirectional ({e.source_len} frames), {L} "
          f"causal ({P} tokens), {L} cross ({P} x {e.source_len})")
    ckv = {"cross_kv": caches["cross_kv"]}

    def steps(all_exits, split_layer):
        def run():
            c, tok, out = {"self": caches["self"]}, lg0.argmax(-1), []
            for t in range(T):
                lg, conf, _, c = model.decode_step(
                    params, c, tok, P + t, extras=ckv, all_exits=all_exits,
                    split_layer=split_layer, window_seq_len=total)
                tok = lg.argmax(-1)
                out.append(tok)
            want, tiles = {}, {}
            for _ in range(T):
                _exit_launch(want, tiles, "exit_confidence",
                             L * B if all_exits else B)
            return (torch.stack(out, 1).cpu(), conf), want, tiles
        return run

    steps(True, None)()                                       # warm-up
    (toks, conf), wall = counted_run(torch, runs,
                                     f"{ENCDEC} decode all_exits",
                                     steps(True, None))
    if tuple(conf.shape) != (L, B) or not torch.isfinite(conf).all():
        fail(f"{ENCDEC} decode all_exits: conf {tuple(conf.shape)}")
    (toks_s, conf_s), wall_s = counted_run(
        torch, runs, f"{ENCDEC} decode split_layer={ENCDEC_SPLIT}",
        steps(False, ENCDEC_SPLIT))
    if tuple(conf_s.shape) != (B,) or not torch.equal(toks, toks_s):
        fail(f"{ENCDEC}: the split_layer run's tokens differ from the "
             f"all_exits run's (the exits do not feed the stream)")
    busy, per_kernel = device_ms(steps(True, None), iters=1, warmup=0)
    step_ms, _ = device_ms(lambda: model.decode_step(
        params, {"self": caches["self"]}, lg0.argmax(-1), P, extras=ckv,
        all_exits=True, window_seq_len=total), iters=5, warmup=1)
    print(f"    {B} sequences x {T} greedy tokens: all_exits "
          f"{B * T / wall:.1f} tokens/s, split_layer={ENCDEC_SPLIT} "
          f"{B * T / wall_s:.1f} tokens/s (tokens equal); a step "
          f"{step_ms:.3f} ms of device time")
    print_busy(f"{ENCDEC} decode all_exits", busy, wall * 1e3, per_kernel)

    want_lg, _ = model.prefill(params, {"frames": frames, "tokens": prefix},
                               cache_seq_len=P + 1)
    _, c1 = model.prefill(params, batch, cache_seq_len=P + 1)
    got_lg = model.decode_step(params, {"self": c1["self"]}, prefix[:, P], P,
                               extras={"cross_kv": c1["cross_kv"]},
                               window_seq_len=P + 1)[0]
    err = ((got_lg.float() - want_lg.float()).abs().max()
           / want_lg.float().abs().max()).item()
    if not err <= TOL["bfloat16"]:
        fail(f"{ENCDEC}: a step's logits vs prefill's over the longer prefix"
             f" max|err| / max|logit| {err:.3e} > {TOL['bfloat16']}")
    flips = check_pred(f"{ENCDEC} step vs prefill", got_lg.argmax(-1),
                       want_lg.argmax(-1), lambda: want_lg, "bfloat16")
    print(f"    pin: a decode step's logits vs prefill's last position over "
          f"the prefix one token longer (bf16: flash kernel vs the step's "
          f"f32 einsums): max|err| / max|logit| {err:.3e} (tol "
          f"{TOL['bfloat16']}), argmax differing at near-ties {flips}")
    del caches, ckv, want_lg, c1
    encdec_agreement(torch, dev, params, cfg, frames, prefix)
    del params, frames
    torch.cuda.empty_cache()


def encdec_agreement(torch, dev, params, cfg, frames, prefix):
    """The full-width weights cut to ENCDEC_AGREE (encoder layers, decoder
    layers, frames) in float32, B = 2, on the card and on the CPU: a
    prefill and ENCDEC_AGREE_STEPS steps with every exit, both sides fed
    the CPU's tokens. Logits within LM_FORWARD_RTOL of the CPU's largest,
    exit confidences within LM_FORWARD_RTOL relative, tokens equal but at
    near-ties. On the card, the phase's pin in float32: the first step's
    logits within TOL["float32"] of the card's own prefill over the
    prefix one token longer."""
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import ParamTree
    t0 = time.perf_counter()
    ne, nd, src = ENCDEC_AGREE
    P, n_steps = ENCDEC_PREFIX, ENCDEC_AGREE_STEPS
    cut = dataclasses.replace(
        cfg, num_layers=nd, dtype="float32",
        encoder=dataclasses.replace(cfg.encoder, num_layers=ne,
                                    source_len=src))
    rows = {"enc_layers": ne, "dec_layers": nd}
    tree = {key: (_first_rows(params[key], rows[key]) if key in rows
                  else params[key]) for key in params.keys()}
    batch = {"frames": frames[:2, :src], "tokens": prefix[:2, :P]}
    total = P + n_steps
    inputs = []

    def run(device):
        p = ParamTree(_tree_to(tree, device, torch.float32))
        m = build_model(cut)
        lg, c = m.prefill(p, {k: t.to(device) for k, t in batch.items()},
                          cache_seq_len=total)
        out = {"logits": [lg.cpu()], "conf": []}
        tok = lg.argmax(-1)
        for t in range(n_steps):
            if device == "cpu":
                inputs.append(tok)
            lg, conf, _, new = m.decode_step(
                p, {"self": c["self"]}, inputs[t].to(device), P + t,
                extras={"cross_kv": c["cross_kv"]}, all_exits=True,
                window_seq_len=total)
            c = {"self": new["self"], "cross_kv": c["cross_kv"]}
            out["logits"].append(lg.cpu())
            out["conf"].append(conf.cpu())
            tok = lg.argmax(-1)
        if device != "cpu":
            longer = torch.cat([batch["tokens"].cpu(), inputs[0][:, None]], 1)
            out["pin"] = m.prefill(p, {"frames": batch["frames"].to(device),
                                       "tokens": longer.to(device)},
                                   cache_seq_len=P + 1)[0].cpu()
        del p
        return out

    cpu = run("cpu")
    card = run(dev)
    lg_err = max(((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(card["logits"], cpu["logits"]))
    conf_err = max(((a - b).abs() / b).max().item()
                   for a, b in zip(card["conf"], cpu["conf"]))
    if not (lg_err <= LM_FORWARD_RTOL and conf_err <= LM_FORWARD_RTOL):
        fail(f"{cfg.arch_id} card vs CPU ({ne}+{nd} layers, {src} frames, "
             f"f32): logits {lg_err:.3e}, conf {conf_err:.3e} > "
             f"{LM_FORWARD_RTOL}")
    flips = sum(check_pred(f"{cfg.arch_id} token step {t}", a.argmax(-1),
                           b.argmax(-1), lambda b=b: b, "float32")
                for t, (a, b) in enumerate(zip(card["logits"],
                                               cpu["logits"])))
    step, pin = card["logits"][1], card["pin"]
    pin_err = ((step - pin).abs().max() / pin.abs().max()).item()
    if not pin_err <= TOL["float32"]:
        fail(f"{cfg.arch_id} f32 cut: a step's logits vs prefill's over the "
             f"longer prefix max|err| / max|logit| {pin_err:.3e} > "
             f"{TOL['float32']}")
    print(f"  full-width {cfg.arch_id} cut to {ne} encoder + {nd} decoder "
          f"layers and {src} frames, float32, B = 2, a {P}-token prefill "
          f"and {n_steps} steps with every exit: card vs CPU logits "
          f"max|err| / max|logit| {lg_err:.3e}, exit conf max relative err "
          f"{conf_err:.3e} (tol {LM_FORWARD_RTOL}), tokens differing at "
          f"near-ties {flips}; pin on the card: step vs prefill over the "
          f"longer prefix max|err| / max|logit| {pin_err:.3e} (tol "
          f"{TOL['float32']}) [{time.perf_counter() - t0:.1f} s wall]")


# ------------------------------------------------------------- train phase

def attention_grad_checks(torch, dev):
    """Attention's gradient on the card: `FlashAttention` (the kernel's
    forward, `attention_backward`) against autograd through the plain
    version, dq, dk and dv at ATTN_GRAD_RTOL (max |err| over max |plain|,
    per tensor); each forward one launch through its variant. Returns the
    training shape's record (kernel forward, plain, SDPA, bound) with the
    time of `attention_backward` per call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_backward)
    from repro_torch.kernels.flash_attention.ref import gqa_ref

    gen = torch.Generator(device=dev).manual_seed(21)
    cases = [
        # name, variant, b, hq, hkv, s, d, causal, dtype
        ("train_f32", "cuda_core", TRAIN_BATCH, 12, 12, 64, 64, False,
         "float32"),
        ("bf16", "tensor_core", 32, 12, 12, 64, 64, False, "bfloat16"),
        ("gqa_causal_f32", "cuda_core", 2, 8, 2, 130, 64, True, "float32"),
        ("gqa_causal_d128_bf16", "tensor_core", 2, 8, 2, 130, 128, True,
         "bfloat16"),
    ]
    saved = {}
    for name, variant, b, hq, hkv, s, d, causal, dt in cases:
        dtype = getattr(torch, dt)
        mk = lambda h: torch.randn((b, h, s, d), generator=gen,  # noqa: E731
                                   device=dev).to(dtype)
        q, k, v = mk(hq), mk(hkv), mk(hkv)
        dout = mk(hq)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = via("flash_attention", variant,
                  lambda: attention(*leaves, causal=causal))
        if out.grad_fn is None:
            fail(f"attention[{name}]: no autograd graph through the kernel")
        got = torch.autograd.grad(out, leaves, dout)
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want_out = gqa_ref(*plain, causal=causal)
        want = torch.autograd.grad(want_out, plain, dout)
        torch.cuda.synchronize()
        check_close(f"attention[{name}] forward", out.detach(),
                    want_out.detach(), dt)
        errs = []
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            rel = ((g.float() - w.float()).abs().max()
                   / w.float().abs().max()).item()
            if not (rel <= ATTN_GRAD_RTOL[dt] and torch.isfinite(g).all()):
                fail(f"attention[{name}] {what}: kernel + attention_backward "
                     f"vs autograd of the plain version, max relative err "
                     f"{rel:.3e} > {ATTN_GRAD_RTOL[dt]}")
            errs.append(rel)
        print(f"  attention gradient [{name}] ({variant}, ({b},{hq}/{hkv},"
              f"{s},{d}) {dt}{', causal' if causal else ''}): dq/dk/dv max "
              f"relative err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
              f"{ATTN_GRAD_RTOL[dt]})")
        saved[name] = (q, k, v, dout, out.detach(), max(errs))

    q, k, v, dout, out, err = saved["train_f32"]
    b, h, s, d = q.shape
    rec = record(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:80",
        f"q/k/v ({b},{h},{s},{d}) float32, bidirectional (training)", err,
        lambda: via("flash_attention", "cuda_core",
                    lambda: attention(q, k, v, causal=False)),
        lambda: gqa_ref(q, k, v, causal=False),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4 * q.numel() * q.element_size(), 4.0 * b * h * s * s * d, "float32",
        variant="cuda_core")
    rec["backward_ms"] = graph_ms(lambda: attention_backward(
        q, k, v, out, dout, causal=False, window=0, scale=d ** -0.5))
    return rec


def train_config():
    """`launch/train.py:main`'s configuration: full-width ElasticBERT-12 with
    the synthetic vocabulary and sst2_like's classes, in float32."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DOMAINS, VOCAB
    return dataclasses.replace(get_config("elasticbert12"), vocab_size=VOCAB,
                               num_classes=DOMAINS["sst2_like"].num_classes,
                               dtype="float32")


def training_run(torch, dev, runs: Runs, cfg, data):
    """`train_classifier` with `launch/train.py:main`'s recipe, counted as
    its own run. Returns the trained params, the model and the log."""
    import math
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_launch_counts)
    from repro_torch.launch.train import train_classifier

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    params, model, log = train_classifier(cfg, data, steps=TRAIN_STEPS,
                                          batch_size=TRAIN_BATCH, lr=3e-4,
                                          remat=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = launch_counts(), variant_launch_counts()
    name = f"train elasticbert12 {TRAIN_STEPS} steps"
    runs.counts[name] = counts
    runs.variants[name] = {k: n for k, n in variants.items() if n}
    runs.tiles[name] = {}
    for row in log:
        print(f"    step {row['step']:4d} loss {row['loss']:.6f} "
              f"t {row['time']:.3f}s")
    first, last = log[0], log[-1]
    ms_step = (last["time"] - first["time"]) / (last["step"] - first["step"]) \
        * 1e3
    tokens = TRAIN_BATCH * data["tokens"].shape[1]
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  {name}: {wall:.3f} s wall; {ms_step:.3f} ms a step (steps "
          f"{first['step'] + 1}..{last['step']}, synchronised at each logged "
          f"loss) = {tokens / ms_step * 1e3:.0f} tokens/s; peak device memory "
          f"{peak / 1e9:.3f} GB (max_memory_allocated); launches {counts}, by "
          f"variant {runs.variants[name]}")
    if not all(math.isfinite(row["loss"]) for row in log):
        fail(f"{name}: non-finite loss in {log}")
    if not last["loss"] < first["loss"]:
        fail(f"{name}: loss did not fall ({first['loss']} -> {last['loss']})")
    want = cfg.num_layers * TRAIN_STEPS
    if counts["flash_attention"] != want or \
            variants["flash_attention/cuda_core"] != want:
        fail(f"{name}: attention launches {counts['flash_attention']} (by "
             f"variant {variants}), want {want} through cuda_core")
    if any(n for k, n in counts.items() if k != "flash_attention"):
        fail(f"{name}: launched {counts} (the loss reads no exit kernel)")
    return params, model, {"launches": counts["flash_attention"],
                           "ms_per_step": ms_step,
                           "tokens_per_s": tokens / ms_step * 1e3,
                           "peak_bytes": peak, "wall_s": wall}


def train_agreement(torch, dev, cfg, data):
    """Training on the card against the CPU: full width cut to 2 layers,
    the same initial parameters (copied card -> CPU) and the same 3
    batches through `make_train_step`. Losses at TRAIN_LOSS_RTOL, step-0
    gradients at TRAIN_GRAD_RTOL (max |err| over max |CPU| per leaf), and
    after 3 steps the parameters whose step-0 |grad| > GRAD_FLOOR within
    TRAIN_PARAM_ATOL."""
    import itertools
    from repro_torch.data import batch_iterator
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import ParamTree, init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig

    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, num_layers=2)
    p_gpu = init_params(cut, seed=7, device=dev)
    p_cpu = ParamTree(_tree_to(p_gpu, "cpu"))
    model = build_model(cut)
    trees, states = (p_gpu, p_cpu), (adamw_init(p_gpu), adamw_init(p_cpu))
    for p in trees:
        p.requires_grad_(True)
    step = make_train_step(model, AdamWConfig(lr=3e-4), total_steps=TRAIN_STEPS,
                           remat=False)
    batches = list(itertools.islice(
        batch_iterator(data, TRAIN_BATCH, seed=0, epochs=1), 3))
    grad0 = None
    for i, b in enumerate(batches):
        losses = []
        for p, st, d in zip(trees, states, (dev, "cpu")):
            _, _, info = step(p, st, {k: torch.as_tensor(v, device=d)
                                      for k, v in b.items()})
            losses.append(float(info["loss"]))
        if abs(losses[0] - losses[1]) > TRAIN_LOSS_RTOL * abs(losses[1]):
            fail(f"training card vs CPU, step {i}: loss {losses[0]!r} vs "
                 f"{losses[1]!r} (rtol {TRAIN_LOSS_RTOL})")
        print(f"    step {i}: loss card {losses[0]:.7f}, CPU {losses[1]:.7f}")
        if i == 0:
            grad0, worst = {}, 0.0
            for (name, a), (_, c) in zip(p_gpu.named_parameters(),
                                         p_cpu.named_parameters()):
                ga, gc = a.grad.cpu(), c.grad
                rel = ((ga - gc).abs().max() / gc.abs().max()).item()
                if not rel <= TRAIN_GRAD_RTOL:
                    fail(f"training card vs CPU, step-0 gradient of {name}: "
                         f"max relative err {rel:.3e} > {TRAIN_GRAD_RTOL}")
                worst = max(worst, rel)
                grad0[name] = gc.abs()
            print(f"    step-0 gradients of {len(grad0)} leaves: max relative "
                  f"err {worst:.3e} (tol {TRAIN_GRAD_RTOL})")
    held = flipped = total = 0
    worst = 0.0
    for (name, a), (_, c) in zip(p_gpu.named_parameters(),
                                 p_cpu.named_parameters()):
        diff = (a.detach().cpu() - c.detach()).abs()
        big = grad0[name] > GRAD_FLOOR
        if big.any():
            worst = max(worst, diff[big].max().item())
        held += int(big.sum())
        flipped += int((diff[~big] > TRAIN_PARAM_ATOL).sum())
        total += diff.numel()
    if not worst <= TRAIN_PARAM_ATOL:
        fail(f"training card vs CPU: after 3 steps a parameter with step-0 "
             f"|grad| > {GRAD_FLOOR} differs by {worst:.3e} > "
             f"{TRAIN_PARAM_ATOL}")
    print(f"  card vs CPU, elasticbert12 full width cut to 2 layers, 3 "
          f"steps: parameters after 3 steps max|err| {worst:.3e} over the "
          f"{held} of {total} elements with step-0 |grad| > {GRAD_FLOOR} "
          f"(tol {TRAIN_PARAM_ATOL}); {flipped} elements with smaller "
          f"gradients differ by more (a near-zero gradient's sign, moved "
          f"by ±lr) [{time.perf_counter() - t0:.1f} s wall]")


def decisions_phase(torch, dev, cfg, params, model, label, *,
                    min_near: int = 0):
    """The paper's pipeline up to the served decisions, on one set of
    weights: per-exit accuracy (card conf held to the CPU's at
    FULL_FORWARD_ATOL), calibrate_alpha (card conf == CPU conf's alpha),
    serve() card f32 vs CPU f32 and card bf16 vs card f32. Card f32 and
    CPU f32 serve the same confidences to FULL_FORWARD_ATOL up to their
    first differing decision, and that one may only be an exit flipped at
    an unchanged arm by a confidence within FULL_FORWARD_ATOL of alpha.
    At least ``min_near`` served confidences must lie within 1 % of alpha,
    so that a wrong exit path would move decisions. Returns (cost with
    alpha, accuracy by exit, majority rate)."""
    import numpy as np
    from repro_torch.core import CostModel, calibrate_alpha
    from repro_torch.data import OnlineStream, make_dataset
    from repro_torch.launch.train import exit_accuracy
    from repro_torch.models.transformer import ParamTree
    from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve

    val = make_dataset("sst2_like", 1024, seed=2)        # as build_testbed
    conf_g, _, corr_g = exit_accuracy(model, params, val)
    p_cpu = ParamTree(_tree_to(params, "cpu"))
    conf_c, _, corr_c = exit_accuracy(model, p_cpu, val)
    acc = corr_g.mean(0)
    majority = max(np.mean(val["labels"] == c) for c in range(cfg.num_classes))
    err = float(np.abs(conf_g - conf_c).max())
    print(f"  {label}: exit_accuracy, 1024 sst2_like validation samples "
          "(seed 2), card:\n    accuracy by exit " + " ".join(
              f"{a:.4f}" for a in acc)
          + "\n    mean conf by exit " + " ".join(
              f"{c:.4f}" for c in conf_g.mean(0))
          + f"\n    majority-class rate {majority:.4f}; card vs CPU conf "
          f"max|err| {err:.3e} (tol {FULL_FORWARD_ATOL}), correct differing "
          f"{int((corr_g != corr_c).sum())}")
    if not err <= FULL_FORWARD_ATOL:
        fail(f"{label}: exit_accuracy conf card vs CPU max|err| {err:.3e} > "
             f"{FULL_FORWARD_ATOL}")
    base = CostModel(num_layers=cfg.num_layers)
    alpha_g = calibrate_alpha(conf_g, base, corr_g)
    alpha_c = calibrate_alpha(conf_c, base, corr_c)
    print(f"  {label}: calibrate_alpha (offload {base.offload}, labels): "
          f"card conf {alpha_g!r}, CPU conf {alpha_c!r}")
    if alpha_g != alpha_c:
        fail(f"{label}: calibrate_alpha differs card {alpha_g} vs CPU "
             f"{alpha_c}")
    cost = dataclasses.replace(base, alpha=alpha_g)

    data = make_dataset("imdb_like", SERVE_SAMPLES, seed=1)
    config = ServingConfig(batch_size=SERVE_BATCH, record_trace=True)
    p_bf16 = ParamTree(_tree_to(params, dev, torch.bfloat16))
    cfg_bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    reps = {}
    for name, c, p, d in (("card f32", cfg, params, dev),
                          ("CPU f32", cfg, p_cpu, "cpu"),
                          ("card bf16", cfg_bf16, p_bf16, dev)):
        t1 = time.perf_counter()
        rep = reps[name] = serve(EdgeCloudRuntime(c, device=d), p,
                                 OnlineStream(data, seed=0), cost, config)
        print(f"  {label}: serve() {name}, B={SERVE_BATCH}: {rep['n']} "
              f"samples, exits {int(np.sum(rep['exited']))}, cost "
              f"{rep['cost_total']:.3f}, arms "
              f"{arm_histogram(rep['arms'], cfg.num_layers)} "
              f"[{time.perf_counter() - t1:.1f} s wall]")
    del p_bf16

    def served(name):
        return np.array([c[-1] for c in reps[name]["trace"]["conf_path"]])

    conf_f, conf_c = served("card f32"), served("CPU f32")
    # at alpha = 1 / classes every confidence exits: none can flip
    near = int(np.sum(np.abs(conf_f - cost.alpha) < 0.01 * cost.alpha)) \
        if cost.alpha > 1 / cfg.num_classes else 0
    print(f"  {label}: card f32 served confidences at the arm, quantiles "
          "0/10/50/90/100 %: " + " ".join(
              f"{q:.6f}" for q in np.quantile(conf_f, [0, .1, .5, .9, 1]))
          + f"; {near} of {len(conf_f)} within 1 % of alpha {cost.alpha}")
    if near < min_near:
        fail(f"{label}: {near} served confidences within 1 % of alpha, want "
             f">= {min_near} (else no decision can move)")
    for a, b in (("card f32", "CPU f32"), ("card bf16", "card f32")):
        same = all(np.array_equal(reps[a][k], reps[b][k])
                   for k in ("arms", "exited", "preds"))
        preds = int(np.sum(np.asarray(reps[a]["preds"])
                           != np.asarray(reps[b]["preds"])))
        print(f"  {label}: {a} vs {b}: arms, exits and preds "
              f"{'identical' if same else 'differ'}; preds differing {preds}")
        first = decision_difference(f"{label}: ", reps[b], reps[a],
                                    cost.alpha, (b, a))
        if b != "CPU f32":
            continue
        upto = len(conf_f) if first is None else first
        gap = float(np.abs(conf_f[:upto] - conf_c[:upto]).max(initial=0.0))
        print(f"  {label}: served confidences card f32 vs CPU f32 up to the "
              f"first differing decision: max|err| {gap:.3e} (tol "
              f"{FULL_FORWARD_ATOL})")
        if not gap <= FULL_FORWARD_ATOL:
            fail(f"{label}: served conf card vs CPU max|err| {gap:.3e} > "
                 f"{FULL_FORWARD_ATOL}")
        if first is None:
            continue
        far = max(abs(conf_f[first] - cost.alpha),
                  abs(conf_c[first] - cost.alpha))
        if reps[a]["arms"][first] != reps[b]["arms"][first] \
                or not far <= FULL_FORWARD_ATOL:
            fail(f"{label}: card f32 vs CPU f32 first differ at sample "
                 f"{first} (arms {reps[a]['arms'][first]} / "
                 f"{reps[b]['arms'][first]}, confidence {far:.3e} from "
                 f"alpha), not an exit flipped within {FULL_FORWARD_ATOL} "
                 f"of alpha")
    return cost, acc, majority


def bandit_phase(cfg, params, model, cost):
    """run_many with regret and the final-exit baseline over the trained
    model's imdb_like conf and the imdb profile."""
    import numpy as np
    from repro_torch.core import (CostModel, calibrate_alpha,
                                  cumulative_regret, final_exit, run_many)
    from repro_torch.data import (PROFILE_DATASETS, make_dataset,
                                  simulate_exit_profiles)
    from repro_torch.launch.train import exit_accuracy

    t0 = time.perf_counter()
    evald = make_dataset("imdb_like", 4096, seed=1)      # build_testbed's eval
    conf_e, _, corr_e = exit_accuracy(model, params, evald)
    prof = simulate_exit_profiles(PROFILE_DATASETS["imdb"], seed=0)
    n_val = min(4096, len(prof["conf"]) // 10)            # as benchmarks/common
    p_cost = CostModel(num_layers=12, offload=5.0)
    p_cost = dataclasses.replace(p_cost, alpha=calibrate_alpha(
        prof["conf"][:n_val], p_cost, prof["correct"][:n_val]))
    for label, conf, corr, c in (
            ("trained elasticbert12, 4096 imdb_like", conf_e, corr_e, cost),
            ("imdb profile (25000 x 12)", prof["conf"], prof["correct"],
             p_cost)):
        final_acc, final_cost = (x.sum() for x in final_exit(conf, corr, c))
        for side_info in (False, True):
            t1 = time.perf_counter()
            out = run_many(conf, np.random.default_rng(0), cost=c,
                           side_info=side_info, num_runs=BANDIT_RUNS)
            host_s = time.perf_counter() - t1
            perm, arms = out["perm"], out["arm"]
            corr_p = corr[perm]                             # (R, N, L)
            acc_r = np.where(out["exited"], np.take_along_axis(
                corr_p, arms[..., None], 2)[..., 0], corr_p[..., -1]).mean(1)
            regret = np.mean([cumulative_regret(
                conf[perm[r]], arms[r], c, side_info=side_info)[-1]
                for r in range(BANDIT_RUNS)])
            cost_r = out["cost"].sum(1).mean()
            n = len(conf)
            print(f"  run_many {label}, alpha {c.alpha:.4g}, "
                  f"{'SplitEE-S' if side_info else 'SplitEE'}, "
                  f"{BANDIT_RUNS} runs: final cumulative regret "
                  f"{regret:.3f}; cost {cost_r:.1f} vs final exit "
                  f"{final_cost:.1f} ({1 - cost_r / final_cost:.2%} cut); "
                  f"accuracy {acc_r.mean():.4f} vs final exit "
                  f"{final_acc / n:.4f} (drop {final_acc / n - acc_r.mean():+.4f}"
                  f"); {host_s:.3f} s on the chip machine's CPU (host, not "
                  f"device time)")
            if not np.isfinite(out["reward"]).all():
                fail(f"run_many {label}: non-finite rewards")
    print(f"  [run_many and regret: {time.perf_counter() - t0:.1f} s wall]")


def training_profile(torch, dev, cfg, data, params):
    """Where a training step's time goes: 5 more steps of the trained
    model on one batch, their wall time and, over 5 more, the device time
    by kernel (torch.profiler). Returns (busy ms, wall ms) a step."""
    from repro_torch.data import batch_iterator
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig

    params.requires_grad_(True)
    state = adamw_init(params)
    step = make_train_step(build_model(cfg), AdamWConfig(lr=3e-4),
                           total_steps=TRAIN_STEPS, remat=False)
    b = next(batch_iterator(data, TRAIN_BATCH, seed=1))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    step(params, state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(params, state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    busy, per_kernel = device_ms(lambda: step(params, state, batch), iters=5,
                                 warmup=0)
    print_busy("train step (elasticbert12 f32, batch 64 x 64)", busy, wall,
               per_kernel)
    params.zero_grad(set_to_none=True)
    params.requires_grad_(False)
    return busy, wall


def train_phase(torch, dev, runs: Runs):
    """Full-width ElasticBERT-12 trained on the card, then the paper's
    pipeline on its weights and the served decisions on an early
    checkpoint of the same recipe. Returns the attention record at the training
    shape, with the run's launches and timings."""
    from repro_torch.data import make_dataset
    from repro_torch.launch.train import train_classifier

    rec = attention_grad_checks(torch, dev)
    cfg = train_config()
    data = make_dataset("sst2_like", TRAIN_SAMPLES, seed=0)
    params, model, stats = training_run(torch, dev, runs, cfg, data)
    train_agreement(torch, dev, cfg, data)
    t0 = time.perf_counter()
    label = f"trained ({TRAIN_STEPS} steps)"
    cost, acc, majority = decisions_phase(torch, dev, cfg, params, model,
                                          label)
    if not acc[-1] > majority:
        fail(f"{label}: last exit accuracy {acc[-1]:.4f} does not beat the "
             f"majority rate {majority:.4f}")
    bandit_phase(cfg, params, model, cost)
    # the first EARLY_STEPS steps of the same recipe (the schedule is still
    # in its warmup, so they are the 200-step run's): weights that are not
    # saturated, where served confidences lie near alpha
    early, _, log = train_classifier(cfg, data, steps=EARLY_STEPS,
                                     batch_size=TRAIN_BATCH, lr=3e-4,
                                     remat=False, device=dev)
    print(f"  early checkpoint: {EARLY_STEPS} steps, losses " + ", ".join(
        f"step {row['step']} {row['loss']:.6f}" for row in log))
    decisions_phase(torch, dev, cfg, early, model,
                    f"early ({EARLY_STEPS} steps)", min_near=MIN_NEAR_ALPHA)
    del early
    print(f"  [pipeline on the trained and early weights: "
          f"{time.perf_counter() - t0:.1f} s wall]")
    stats["step_busy_ms"], stats["step_wall_ms"] = training_profile(
        torch, dev, cfg, data, params)
    rec.update(stats)
    print(f"  flash_attention at {rec['shape']} (cuda_core): device ms per "
          f"call (CUDA graph): kernel {rec['ms']:.5f}, plain "
          f"{rec['plain_ms']:.5f}, SDPA {rec['library_ms']:.5f}, bound "
          f"{rec['bound_ms']:.6f} ({rec['bound_by']}); attention_backward "
          f"{rec['backward_ms']:.5f}; {rec['launches']} launches in the "
          f"training run")
    return rec


# ------------------------------------------------------ model parallelism

MP_STEPS = 3                # train steps of each model-parallel run
MP_TP2 = 2                  # ranks of the threaded run sharing the card
MP_DRYRUN = (("qwen3-1.7b", "train_4k"), ("mixtral-8x22b", "decode_32k"))
MP_DRYRUN_TIMEOUT_S = 300
# model-parallel vs unbound, f32 round-off of other reduction orders:
# losses at MP_LOSS_RTOL, step-0 gradients at MP_GRAD_RTOL (max |err|
# over max |unbound| per leaf), the parameters after MP_STEPS steps
# within TRAIN_PARAM_ATOL where the step-0 |grad| > GRAD_FLOOR
MP_LOSS_RTOL = 1e-5
MP_GRAD_RTOL = 1e-4
MP_STEP_MS = []             # each `mp_steps` call's ms a step (read by mp_counted)


def mp_steps(torch, dev, cfg, params0, batches, mesh=None, seq_parallel=True):
    """MP_STEPS `make_train_step` steps of ``cfg`` from a copy of
    ``params0`` (a parameter tree on ``dev``): unbound, or as ``DTensor``s
    placed on ``mesh`` by `param_shardings` under `mesh_rules`, with
    ``seq_parallel`` as given. Appends its ms a step to MP_STEP_MS.
    Returns (losses, step-0 gradients, final parameters), the last two
    whole on every rank."""
    from repro_torch.launch.mesh import AXIS_MAP_SINGLE
    from repro_torch.launch.shardings import (batch_shardings,
                                              distribute_tree,
                                              param_shardings)
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import ParamTree
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.shards import is_dtensor
    from repro_torch.sharding.rules import mesh_rules

    def whole(t):
        return (t.full_tensor() if is_dtensor(t) else t).detach().clone()

    # a copy: the steps update their parameters in place
    tree = _tree_to(params0, dev, clone=True)
    if mesh is not None:
        tree = distribute_tree(mesh, tree, param_shardings(mesh, tree))
    params = ParamTree(tree).requires_grad_(True)
    opt = adamw_init(params)
    step = make_train_step(_SeqParallel(build_model(cfg), seq_parallel),
                           AdamWConfig(lr=3e-4), total_steps=TRAIN_STEPS,
                           remat=False)
    losses, grad0, step_ms = [], None, []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        if mesh is None:
            _, _, info = step(params, opt, batch)
        else:
            batch = distribute_tree(mesh, batch,
                                    batch_shardings(mesh, batch, False))
            with mesh_rules(mesh, AXIS_MAP_SINGLE):
                _, _, info = step(params, opt, batch)
        losses.append(float(info["loss"]))      # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grad0 = {n: whole(p.grad) for n, p in params.named_parameters()}
    MP_STEP_MS.append(step_ms)
    return losses, grad0, {n: whole(p) for n, p in params.named_parameters()}


class _SeqParallel:
    """A model whose `train_loss` takes ``seq_parallel`` as given (the
    train step calls it with the default)."""

    def __init__(self, model, on: bool):
        self.model, self.on = model, on

    def train_loss(self, params, batch, *, remat: bool = True):
        return self.model.train_loss(params, batch, remat=remat,
                                     seq_parallel=self.on)


def mp_compare(name, got, want):
    """A model-parallel run (losses, step-0 grads, final params) against
    the unbound one."""
    (gl, gg, gp), (wl, wg, wp) = got, want
    for i, (a, b) in enumerate(zip(gl, wl)):
        if not abs(a - b) <= MP_LOSS_RTOL * abs(b):
            fail(f"{name} step {i}: loss {a!r} vs unbound {b!r} (rtol "
                 f"{MP_LOSS_RTOL})")
    worst_g = worst_p = 0.0
    for n in wg:
        rel = ((gg[n] - wg[n]).abs().max() / wg[n].abs().max()).item()
        if not rel <= MP_GRAD_RTOL:
            fail(f"{name}: step-0 gradient of {n}: max relative err "
                 f"{rel:.3e} > {MP_GRAD_RTOL}")
        worst_g = max(worst_g, rel)
        big = wg[n].abs() > GRAD_FLOOR
        if big.any():
            err = (gp[n] - wp[n]).abs()[big].max().item()
            if not err <= TRAIN_PARAM_ATOL:
                fail(f"{name}: {n} after {MP_STEPS} steps off by {err:.3e} "
                     f"> {TRAIN_PARAM_ATOL}")
            worst_p = max(worst_p, err)
    print(f"    {name}: losses {[f'{x:.7f}' for x in gl]}, max |loss err| "
          f"{max(abs(a - b) for a, b in zip(gl, wl)):.3e}; step-0 gradients "
          f"max relative err {worst_g:.3e} (tol {MP_GRAD_RTOL}); params "
          f"after {MP_STEPS} steps max |err| {worst_p:.3e} (tol "
          f"{TRAIN_PARAM_ATOL})")


@contextlib.contextmanager
def attention_shapes(shapes):
    """Record the q shape of every attention kernel launch."""
    from repro_torch.kernels.flash_attention import ops
    orig = ops.flash_attention_cuda

    def recording(q, *a, **k):
        shapes.append(tuple(q.shape))
        return orig(q, *a, **k)

    ops.flash_attention_cuda = recording
    try:
        yield
    finally:
        ops.flash_attention_cuda = orig


def mp_counted(torch, runs: Runs, name, fn, want_launches, want_shape):
    """``fn()`` as its own counted run: exactly ``want_launches`` attention
    launches, every one through ``cuda_core`` at q shape ``want_shape``
    (the local head shard), and no other kernel. Returns fn's result and
    its wall seconds."""
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_launch_counts)
    shapes = []
    MP_STEP_MS.clear()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with attention_shapes(shapes):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = launch_counts(), variant_launch_counts()
    runs.counts[name] = counts
    runs.variants[name] = {k: n for k, n in variants.items() if n}
    runs.tiles[name] = {}
    if counts["flash_attention"] != want_launches or \
            variants["flash_attention/cuda_core"] != want_launches:
        fail(f"{name}: attention launches {counts['flash_attention']} (by "
             f"variant {runs.variants[name]}), want {want_launches} through "
             f"cuda_core")
    if any(n for k, n in counts.items() if k != "flash_attention"):
        fail(f"{name}: launched {counts} (the loss reads no exit kernel)")
    if set(shapes) != {want_shape}:
        fail(f"{name}: attention kernel q shapes {sorted(set(shapes))}, want "
             f"the local head shard {want_shape}")
    print(f"  {name}: {wall:.3f} s wall for {MP_STEPS} steps; ms a step "
          f"(first, then later; per rank) {[[round(t, 1) for t in r] for r in MP_STEP_MS]}"
          f"; launches {counts}, by variant {runs.variants[name]}; kernel q "
          f"shape {want_shape}")
    return out


def mp_threaded(torch, dev, cfg, params0, batches, tp: int, seq_parallel):
    """The model-parallel steps on a (1, tp) mesh of ``tp`` ranks sharing
    ``dev``, one thread each over the threaded process group
    (``torch.testing._internal.distributed.multi_threaded_pg``: its
    collectives are tensor ops of this process, so they take CUDA
    tensors). Returns rank 0's result."""
    import threading
    import torch.distributed as dist
    from torch.testing._internal.distributed.multi_threaded_pg import (
        _install_threaded_pg, _uninstall_threaded_pg)
    from repro_torch.launch.mesh import make_mesh
    results = {}

    def worker(rank, store):
        # the thread's group goes with the threaded world when it is
        # uninstalled (torch 2.11's destroy_process_group cannot take it)
        try:
            dist.init_process_group("threaded", rank=rank, world_size=tp,
                                    store=store)
            mesh = make_mesh((1, tp), ("data", "model"), device=dev.type)
            results[rank] = mp_steps(torch, dev, cfg, params0, batches, mesh,
                                     seq_parallel)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            results[rank] = e

    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    try:
        store = dist.HashStore()
        threads = [threading.Thread(target=worker, args=(r, store))
                   for r in range(tp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    for r in range(tp):
        if isinstance(results.get(r), BaseException):
            raise results[r]
    return results[0]


@contextlib.contextmanager
def mp_dry_runs():
    """`python -m repro_torch.launch.dryrun` for MP_DRYRUN on the fake
    (16, 16) mesh, each in a subprocess started on entry (they run on the
    host's cores while the block uses the card) and awaited on a clean
    exit: prints its per-device argument and temp GB, flops and
    collective counts. Every subprocess is killed on the way out."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out_dir = ROOT / "chiprun_out" / "dryrun"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out_dir)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for arch, shape in MP_DRYRUN]          # the two at once
    try:
        yield
        outs = [p.communicate(timeout=MP_DRYRUN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for (arch, shape), p, (stdout, stderr) in zip(MP_DRYRUN, procs, outs):
        if p.returncode != 0 or "ran in" not in stdout:
            fail(f"dry run {arch} x {shape}: exit {p.returncode}\n"
                 f"{stdout[-2000:]}\n{stderr[-3000:]}")
        rec = json.loads((out_dir / f"{arch}_{shape}_single_pod_16x16.json"
                          ).read_text())
        print(f"  dry run {arch} x {shape} on the fake (16, 16) mesh "
              f"({rec['compile_s']} s its step, {time.perf_counter() - t0:.1f}"
              f" s wall for both with start-up, beside the card runs): per "
              f"device "
              f"arguments {rec['memory']['argument_bytes'] / 1e9:.3f} GB, "
              f"temp {rec['memory']['temp_bytes'] / 1e9:.3f} GB, flops "
              f"{rec['flops']:.4e}, bytes accessed "
              f"{rec['bytes_accessed']:.4e}, collectives " + ", ".join(
                  f"{k} {v['count']} ({v['bytes']} B)"
                  for k, v in rec["collectives"].items()
                  if isinstance(v, dict) and v["count"]))


def model_parallel_phase(torch, dev, runs: Runs):
    """Tensor-parallel training of full-width ElasticBERT-12 (f32, the
    training recipe's batch 64 x 64) on the card: MP_STEPS steps unbound,
    then on a (1, 1) ("data", "model") mesh over an NCCL world of 1 with
    seq_parallel on and off (each equal to the unbound run within f32
    round-off, with the unbound run's attention launches), then TP =
    MP_TP2 on a (1, 2) mesh of ranks sharing the card over the threaded
    process group (the attention kernel on each rank's 6-head shard,
    forward and backward; equal to the unbound run). The dry runs of
    MP_DRYRUN run beside them, on the host. Returns the attention record
    at the TP = 2 shard shape."""
    with mp_dry_runs():
        return mp_card_runs(torch, dev, runs)


def mp_card_runs(torch, dev, runs: Runs):
    """`model_parallel_phase`'s runs on the card; the record of the
    kernel's forward at the TP = 2 shard, with `attention_backward`'s
    time there."""
    import itertools
    import logging
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.data import batch_iterator, make_dataset
    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_backward)
    from repro_torch.kernels.flash_attention.ref import gqa_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.distributed import _free_port

    # DTensor warns at every two-axis all-reduce of a (1, n) mesh
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    cfg = train_config()
    data = make_dataset("sst2_like", TRAIN_SAMPLES, seed=0)
    batches = list(itertools.islice(
        batch_iterator(data, TRAIN_BATCH, seed=0, epochs=1), MP_STEPS))
    params0 = init_params(cfg, seed=11, device=dev)
    seq = data["tokens"].shape[1]
    heads, hd = cfg.num_heads, cfg.resolved_head_dim
    per_run = cfg.num_layers * MP_STEPS
    full = (TRAIN_BATCH, heads, seq, hd)
    unbound = mp_counted(
        torch, runs, "mp unbound", lambda: mp_steps(
            torch, dev, cfg, params0, batches), per_run, full)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        for sp in (True, False):
            name = f"mp TP=1 seq_parallel={sp}"
            got = mp_counted(torch, runs, name, lambda: mp_steps(
                torch, dev, cfg, params0, batches, mesh, sp), per_run, full)
            mp_compare(name, got, unbound)
    finally:
        dist.destroy_process_group()

    shard = (TRAIN_BATCH, heads // MP_TP2, seq, hd)
    for sp in (True, False):
        name = f"mp TP={MP_TP2} seq_parallel={sp} (threaded ranks)"
        got = mp_counted(torch, runs, name, lambda: mp_threaded(
            torch, dev, cfg, params0, batches, MP_TP2, sp),
            MP_TP2 * per_run, shard)
        mp_compare(name, got, unbound)

    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v, dout = (torch.randn(shard, generator=gen, device=dev)
                     for _ in range(4))
    rec = record(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:80",
        f"q/k/v {shard} float32, bidirectional (a TP = {MP_TP2} rank's "
        f"head shard of the training step)",
        (via("flash_attention", "cuda_core", lambda: attention(
            q, k, v, causal=False)) - gqa_ref(q, k, v, causal=False)
         ).abs().max().item(),
        lambda: via("flash_attention", "cuda_core",
                    lambda: attention(q, k, v, causal=False)),
        lambda: gqa_ref(q, k, v, causal=False),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4 * q.numel() * q.element_size(), 4.0 * q.numel() * seq, "float32",
        variant="cuda_core")
    out = attention(q, k, v, causal=False)
    rec["backward_ms"] = graph_ms(lambda: attention_backward(
        q, k, v, out, dout, causal=False, window=0, scale=hd ** -0.5))
    rec["launches"] = runs.counts[f"mp TP={MP_TP2} seq_parallel=True "
                                  f"(threaded ranks)"]["flash_attention"]
    print(f"  flash_attention at {rec['shape']} (cuda_core): device ms per "
          f"call (CUDA graph): kernel {rec['ms']:.5f}, plain "
          f"{rec['plain_ms']:.5f}, SDPA {rec['library_ms']:.5f}, bound "
          f"{rec['bound_ms']:.6f} ({rec['bound_by']}); attention_backward "
          f"{rec['backward_ms']:.5f}; {rec['launches']} launches in the "
          f"TP = {MP_TP2} seq_parallel=True run")
    return rec


def _first_rows(tree, n: int):
    """The first ``n`` rows of every leaf: the first n layers of a
    stacked-layer tree."""
    return {key: _first_rows(val, n) if hasattr(val, "items") else val[:n]
            for key, val in tree.items()}


def _tree_to(tree, device, dtype=None, clone=False):
    """A parameter tree as a nested dict on ``device`` (leaves already
    there are shared unless ``clone``)."""
    return {key: _tree_to(val, device, dtype, clone) if hasattr(val, "items")
            else val.detach().to(device=device, dtype=dtype or val.dtype,
                                 copy=clone)
            for key, val in tree.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one CUDA GPU.")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the decode phase's weights and prompts")
    seed = parser.parse_args(argv).seed
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this runs "
              "on a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print("== environment")
    print(f"  python {platform.python_version()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card)

    t_start = time.perf_counter()
    with phase("build"):
        from repro_torch.kernels import build_all
        logs = build_all()
        print(f"  built {sorted(logs)}")
        for stem, log in logs.items():
            for line in log.splitlines():
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    print(f"  {stem}: {line.strip()}")

    with phase("tensor cores in the SASS"):
        hmma = sass_tensor_core_counts()
        tc_fns = {fn: n for fn, n in hmma.items()
                  if "_tc_kernel" in fn or "_wgmma_kernel" in fn}
        for fn, n in sorted(hmma.items()):
            print(f"  {n:5d} HMMA/HGMMA  {fn}")
        # exit: mma.sync (M <= 32) and wgmma (M > 32), each with w in
        # 16-byte and in 4-byte pieces; attention: d 64, 128
        if len(tc_fns) != 6 or min(tc_fns.values()) == 0:
            fail(f"tensor-core kernels without HMMA/HGMMA in their SASS: "
                 f"{tc_fns}")
        # the WKV6 recurrence stays on the CUDA cores (exact rank-1 steps)
        wkv6_tc = {fn: n for fn, n in hmma.items() if "wkv6" in fn and n}
        if wkv6_tc or not any("wkv6" in fn for fn in hmma):
            fail(f"WKV6 kernels missing or with tensor-core instructions: "
                 f"{wkv6_tc}")

    with phase("dispatch and launch counts"):
        dispatch_checks(torch, dev)

    with phase("kernels vs plain versions"):
        rec_attn = attention_checks(torch, dev)
        rec_exit, rec_fused = exit_checks(torch, dev)
        rec_wkv6 = wkv6_checks(torch, dev)

    runs = Runs()
    for arch, layers, alpha_layer, prefix, agree in (
            ("elasticbert12", None, 6, "", agreement_phase),
            (LM, None, 16, f"{LM} ", lm_agreement_phase),
            (HYBRID, HYBRID_SERVE_LAYERS, HYBRID_ALPHA_LAYER,
             f"{HYBRID} {HYBRID_SERVE_LAYERS}L ",
             lambda *a: lm_agreement_phase(*a, layers=HYBRID_AGREE_LAYERS,
                                           witness=False))):
        with phase(f"serve: {arch} (full width"
                   f"{f', {layers} layers' if layers else ''}) on the card"):
            params, cfg, data, cost = serve_setup(torch, dev, arch,
                                                  alpha_layer, layers=layers)
            bucketed = serve_phase(torch, dev, runs, params, cfg, data, cost,
                                   prefix)
        with phase(f"serve(): {arch} scan, auto, offload codec, Engine"):
            scan = front_end_phase(torch, dev, runs, params, cfg, data,
                                   cost, bucketed, prefix)
        if arch != HYBRID:
            with phase(f"sharded: {arch} serve(path='sharded') at R=1, "
                       f"sync and overlap K=1/2, Engine"):
                sharded = sharded_phase(torch, dev, runs, params, cfg, data,
                                        cost, bucketed, scan, prefix)
        if arch == "elasticbert12":
            with phase(f"distributed: {arch} serve(path='distributed'), one "
                       f"process and worker-process clusters on this card"):
                distributed_phase(torch, dev, runs, params, cfg, data, cost,
                                  sharded)
        with phase(f"agreement: {arch}, card kernel path vs CPU plain "
                   f"path"):
            agree(torch, dev, params, cfg, data)
        del params
        torch.cuda.empty_cache()

    for arch, agree_layers in DECODE_ARCHS:
        with phase(f"decode: {arch} (full width) on the card"):
            decode_phase(torch, dev, runs, arch, seed,
                         agree_layers=agree_layers)

    with phase(f"{MOE}: full width, {MOE_LAYERS} of 32 layers, on the "
               f"card"):
        moe_phase(torch, dev, runs, seed)

    with phase(f"{VLM}: full width on the card, over seeded embeds"):
        vlm_phase(torch, dev, runs, seed)

    with phase(f"{ENCDEC}: full width on the card (encoder, "
               f"cross-attention, decode)"):
        encdec_phase(torch, dev, runs, seed)

    with phase("agreement: offload codec, card vs CPU"):
        codec_agreement(torch, dev)

    with phase("train: elasticbert12 (full width) on the card"):
        rec_attn["at_training"] = train_phase(torch, dev, runs)

    with phase("model parallelism: elasticbert12 TP training on the card, "
               "the dry run"):
        rec_attn["at_tp2_train"] = model_parallel_phase(torch, dev, runs)

    kernels = []
    for rec in (rec_attn, rec_exit, rec_fused, rec_wkv6):
        path = MAIN_PATH[rec["name"]]
        rec["main_path"] = path
        rec["launches"] = runs.counts[path][rec["name"]]
        rec["launches_by_path"] = {p: c[rec["name"]]
                                   for p, c in runs.counts.items()}
        rec["launches_by_variant"] = {
            p: {k.split("/")[1]: n for k, n in c.items()
                if k.split("/")[0] == rec["name"]}
            for p, c in runs.variants.items()}
        if rec["name"].startswith("exit_confidence"):
            rec["launches_by_tile"] = {
                p: {k.split("/")[2]: n for k, n in c.items()
                    if k.split("/")[0] == rec["name"]}
                for p, c in runs.tiles.items()}
        kernels.append(rec)
        lib = rec["library_ms"]
        print(f"  {rec['name']} at {rec['shape']} "
              f"({rec['variant'] or 'one variant'}): device "
              f"ms per call (CUDA graph): kernel {rec['ms']:.5f}, plain "
              f"{rec['plain_ms']:.5f}, "
              f"library {'none' if lib is None else f'{lib:.5f}'}, bound "
              f"{rec['bound_ms']:.6f} ({rec['bound_by']}); {rec['launches']} "
              f"launches in the {path} run")
        for at in (val for key, val in rec.items()
                   if key.startswith("at_")):
            lib = at["library_ms"]
            print(f"    at {at['shape']} ({at['variant']}): kernel "
                  f"{at['ms']:.5f}, plain "
                  f"{at['plain_ms']:.5f}, library "
                  f"{'none' if lib is None else f'{lib:.5f}'}, bound "
                  f"{at['bound_ms']:.6f} ({at['bound_by']})")
    print(f"  whole smoke: {time.perf_counter() - t_start:.1f} s wall")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
