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
   a depth bucket of B = 4 and at the decode prefill of B = 8. The WKV6
   backward kernel (`WKV6`'s gradient) is held against the plain backward
   (all five gradients, WKV6_GRAD_RTOL) at the training shape (16, 40,
   64, 64) as time_mix hands it over (bf16 views) and in f32, T = 37 with
   a final-state cotangent, dk = dv = 32, dk 48 / dv 40 and rows off 16
   bytes (``scalar``), covering both checkpoint chunks; two launches
   must be bitwise equal; at (1, 4, 4096, 64) f32 its distance from a
   float64 run of the plain backward may be at most
   WKV6_GRAD_WITNESS_FACTOR times the plain float32 backward's; its
   instantiations' residency, registers and spills are printed and it is
   timed at the training shape beside the forward. Attention's gradient
   (`FlashAttention`: the kernel's forward, which saves each row's
   log-sum-exp, and the backward kernel `flash_attention_backward`) is
   held against autograd of the plain version (per sample where its own
   memory needs it) at ElasticBERT's training shape and in bf16 at each
   family's training shape (TRAIN_ATTENTION: qwen3, zamba2's shared
   block, phi3.5-moe and qwen2-vl causal at 16 x 64, seamless's encoder
   at 8 x 4096 and its cross-attention 32 x 4096), and at a sliding
   window, rows without keys (Sq > Skv, causal), d = 32 f32 and bf16
   rows off 16 bytes (`cuda_core`), each backward through the tile
   `attention_backward_tile` picks (mma_sync and wgmma both); the saved
   log-sum-exp against `attention_lse_ref`, two backward launches bitwise
   equal (seamless's encoder and cross-attention among them); each
   training shape timed (the forward: kernel, plain, SDPA, bound; the
   backward kernel: kernel, plain `attention_backward`, SDPA's forward +
   backward, bound) with the backward's peak memory beyond its inputs
   held within dq + dk + dv + delta + the dQ key splits' partials + 1 MiB
   (`backward_peak_bound`);
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
   reading, WITNESS_FACTOR, in a subprocess beside the card phases that
   follow, awaited before the MoE phase), the offload codec bitwise in
   every mode,
   and the served decisions of a small float32 model of each family
   (bucketed, scan, auto, int8, sharded K = 1); for zamba2 and an MoE it
   prints the device time inside the plain-PyTorch blocks (Mamba2 and
   its SSD, the MoE dispatch) beside the run's busy time;
6. serves autoregressive decode (``workload="decode"``) with full-width
   qwen3-1.7b, rwkv6-3b and zamba2-1.2b, each in a subprocess of its own
   and the three at once (their times taken under that overlap; their
   launch counts join the kernels line) (bfloat16, weights and 64
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
   gradient (the kernel's forward and the backward kernel) against
   autograd of the plain version at the training shape (64, 12, 64, 64)
   f32, at (32, 12, 64, 64) bf16 and causal GQA; `train_classifier` with
   `launch/train.py:main`'s recipe (sst2_like, 8192 samples, batch 64,
   200 steps, lr 3e-4), printing each logged loss, ms a step, tokens/s
   and peak memory, and holding the loss falling and 12 x 200 attention
   and 12 x 200 backward-kernel launches through `cuda_core`; training
   card vs CPU (2 layers of the full width, the same initial parameters
   and 3 batches: losses, step-0 gradients, parameters); then on the
   trained weights the paper's pipeline: `exit_accuracy` (the last exit
   must beat the majority rate; card conf within FULL_FORWARD_ATOL of
   the CPU's),
   `calibrate_alpha` (card == CPU), `serve()` card f32 vs CPU f32 (the
   same served confidences up to the first differing decision, which may
   only be an exit flipped at alpha) and card bf16 vs card f32 (decisions
   differing and their distance from alpha), and `run_many` (20 runs,
   SplitEE and SplitEE-S) with regret and the final-exit baseline over
   the trained model's imdb_like confidences and the imdb profile (25000
   x 12), with its host seconds. The trained weights are saturated (no
   confidence near alpha), so the same decision checks run again on the
   recipe's first EARLY_STEPS steps, where at least MIN_NEAR_ALPHA served
   confidences must lie within 1 % of alpha; then full-width rwkv6-3b
   (LM_TRAIN_LAYERS layers, bf16) trained by `make_train_step` with remat
   for LM_TRAIN_STEPS steps on one repeated batch of 16 x 64 tokens (the
   loss finite and falling; ms a step, tokens/s, peak memory, busy
   share; WKV6 launches exactly 2L forward + L backward a step, no exit
   or attention launch); then qwen3-1.7b (28 layers), zamba2-1.2b (38),
   phi3.5-moe (FAMILY_MOE_LAYERS of 32), qwen2-vl-2b (28, over seeded
   embeds) and seamless-m4t-large-v2 (24 + 24 on 8 x 4096 seeded frames
   and 32 target tokens) trained the same way at their published widths,
   each run's attention launches exactly `train_attention_launches` a
   step through the variant its bf16 shape picks and no exit or WKV6
   launch; and card vs CPU training of each of these six archs cut to a
   few layers (LM_AGREE_CUTS) in float32 (3 steps; both halves in one
   subprocess, the card halves first, the CPU halves beside the phases
   that follow and awaited at the end);
8. trains full-width ElasticBERT-12 (the training configuration above)
   under model parallelism (`model_parallel_phase`): 3 steps unbound,
   at TP = 1 on a (1, 1) ("data", "model") mesh over an NCCL world of 1
   and at TP = 2 on a (1, 2) mesh of two ranks sharing the card (threads
   of this process over the threaded process group), `seq_parallel` on
   and off, each held to the unbound run (losses, step-0 gradients,
   parameters) with its attention launches and the kernel's q shape (the
   local head shard, forward and `FlashAttention`'s backward); times the
   kernel and the backward kernel (beside the plain
   `attention_backward`) at the TP = 2 shard; then prints the
   runs of `repro_torch.launch.dryrun` for qwen3-1.7b x train_4k and
   mixtral-8x22b x decode_32k on the fake (16, 16) mesh (two
   subprocesses on the host, started before the MoE phase, with the
   CLI's default depth fit): their per-device numbers, each depth fit's
   points and its extrapolation against the full-depth walk (held: flops
   and every collective equal, bytes accessed within a relative 1e-5;
   both archs are uniform in depth), and the one `--refit` over their
   records that followed them, held the same way;
9. drives the front doors (`front_doors_phase`): the 200-step weights
   trained in 7. saved with `checkpoint.save_pytree` under ``build/`` (bytes and
   seconds printed) and read back with `load_pytree` against the card
   tree, against `abstract_params()` with ``device=`` the card and onto
   the CPU, every leaf bitwise, and served from the loaded tree (B = 32,
   bucketed, 512 samples) bit for bit as from memory, its launches held
   against its decisions; the serve CLI through
   `repro_torch.launch.serve.main(argv)` at the reference's testbed
   geometry: classify with ``--dump-config`` and again from that
   ``--config`` (equal decisions where the testbed's training repeats
   bit for bit, and equal resolved configs), ``--fused-exit --edge-mode
   scan``, and decode of qwen3-1.7b's smoke config (one exit launch a
   step); and, as subprocesses started with the phase and awaited at
   its end, the CLI's driver mode (``--distributed``: a lockstep pair
   and a fault-tolerant trio with host 1 killed at round 2, respawned
   and rejoined; workers on this card) and the examples
   ``train_multiexit_torch.py --full`` (its checkpoint read back here
   must reprint its per-exit accuracy and confidence lines),
   ``serve_engine_torch.py`` and ``lm_decode_splitee_torch.py`` (WKV6),
   and ``python -m repro_torch.launch.train --arch rwkv6-3b --smoke``
   (two loss lines; WKV6 and its backward once a layer a step), with
   their launch counts;
10. prints one JSON line of per-kernel numbers (``launches`` from the run
   named in MAIN_PATH, ``launches_by_path``, ``launches_by_variant`` and,
   for the exit kernels and attention's backward, ``launches_by_tile``
   from every run; attention's
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
# the witness runs in a subprocess (`witness_background`) with this many
# intra-op threads beside the card phases after rwkv6-3b's agreement (its
# CPU readings take ~70 s on 8 threads), cut WITNESS_TIMEOUT_S after it
# starts
WITNESS_THREADS = 4
WITNESS_TIMEOUT_S = 600
# WKV6 kernel vs plain version: both f32 outputs, the sums over dk and
# the state over T are taken in different orders (rtol = atol)
WKV6_TOL = 1e-4
# the WKV6 backward kernel vs the plain backward, max |err| over max
# |plain| per gradient: float32 sums in other orders; with bf16 inputs dr,
# dk and dv are each rounded once to bfloat16 from float32 values that
# agree to about 1e-6, so they differ by at most one bfloat16 ulp (2^-7
# of the value); dw and du stay float32
WKV6_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2 ** -7}
# its float64 witness at T = 4096: the kernel's normwise distance from a
# float64 run of the plain backward (|x - x64|_2 / |x64|_2, per gradient)
# at most this many times the plain float32 backward's (a max over 1M
# elements of errors near one float32 ulp is too noisy a distance: its
# ratio swings by 2x with the inputs; both are printed)
WKV6_GRAD_WITNESS_FACTOR = 2.0

# attention's gradient, the forward and the backward kernel against
# autograd of the plain version: max |err| over max |plain| per tensor
# (bf16: the two forwards round their outputs apart, and rowsum(dO∘O)
# reads them; the backward kernel rounds P and dS to bf16 as operands of
# its tensor-core products)
ATTN_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# attention at each family's bf16 training shape (`family_train_phase`):
# key: (b, hq, hkv, sq, skv, d, causal); the plain version's autograd runs
# ATTN_GRAD_PLAIN_ROWS samples at a time where its (Sq, Skv) f32
# temporaries need it (seamless's encoder: 1.07 GB a sample each)
TRAIN_ATTENTION = {
    "at_train_qwen3": (16, 16, 8, 64, 64, 128, True),
    "at_train_zamba2": (16, 32, 32, 64, 64, 64, True),
    "at_train_phi35": (16, 32, 8, 64, 64, 128, True),
    "at_train_qwen2vl": (16, 12, 2, 64, 64, 128, True),
    "at_train_seamless_encoder": (8, 16, 16, 4096, 4096, 64, False),
    "at_train_seamless_cross": (8, 16, 16, 32, 4096, 64, False),
}
ATTN_GRAD_PLAIN_ROWS = {"at_train_seamless_encoder": 1}
# the training shape whose backward record heads the backward kernel's
# JSON entry (the one MAIN_PATH's run launches most, 24 a step)
MAIN_TRAIN_ATTENTION = "at_train_seamless_encoder"
# the forward's row log-sum-exp against `attention_lse_ref` (rtol = atol):
# float32 sums of the same products in other orders, a few units of 1e-6
# on values of a few units
ATTN_LSE_TOL = 1e-4
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
             "wkv6": f"{LM} batched B=32",
             "exit_confidence_combine": "model mesh TP=2 sync",
             "wkv6_backward": f"train {LM} full width",
             "flash_attention_backward": "train seamless-m4t-large-v2"}
# the __global__ functions of the port's CUDA sources, in profiler names
PORT_KERNEL = re.compile(r"(exit_confidence\w*|exit_norm_rows_kernel|"
                         r"wkv6_kernel|wkv6_backward_kernel|wkv6_du_kernel|"
                         r"flash_attention\w*|attention_delta_kernel|"
                         r"attention_dkdv\w*|attention_dq\w*)")
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
# the three decode phases are host-bound (10-20 % device busy): each runs
# in a subprocess of its own (`decode_child`, DECODE_THREADS intra-op
# threads), all three at once, their times taken under that overlap
DECODE_THREADS = 2
DECODE_TIMEOUT_S = 600
DECODE_CHILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.decode_child(*sys.argv[2:])
'''
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
# DIST_CLUSTER_TIMEOUT_S. The respawn's start-up (a fresh interpreter,
# CUDA, the model, a warm-up) takes ~9 s of the 16-round stream: at a 1 s
# pace and a 4 s delay it rejoined at round 13-14 of 16 and once not at
# all (a cluster that ends first never acks it), hence a 1.5 s pace and
# a one-round delay
DIST_HB_TIMEOUT = 3.0
DIST_DETECT_SLACK_S = 2.0
DIST_KILL_EPOCH = 2
DIST_FT_HOSTS = 3
DIST_PACE_S = 1.5
DIST_REJOIN_DELAY_S = DIST_PACE_S
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
        exit_combine, exit_confidence, exit_confidence_fused)
    from repro_torch.kernels.exit_confidence.ref import exit_partials_ref
    from repro_torch.kernels.flash_attention.ops import (
        attention, flash_attention_backward)
    from repro_torch.kernels.wkv6.ops import wkv6

    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, 2, 8, 16), generator=gen)
    h = torch.randn((8, 16), generator=gen)
    w = torch.randn((16, 4), generator=gen)
    scale = torch.ones(16)
    decay = torch.rand((1, 2, 8, 16), generator=gen)

    def wkv6_grad(d):
        """dr of sum(y): on the card through `WKV6` (the forward and the
        backward kernel), on the CPU autograd of the plain version."""
        leaves = [x.to(d).clone().requires_grad_(True)
                  for x in (q, q, q, decay, q[0, :, 0])]
        return torch.autograd.grad(wkv6(*leaves)[0].sum(), leaves)[0]

    def attention_grad(d):
        """dq of sum(out): on the card through `FlashAttention` (the
        forward and the backward kernel), on the CPU autograd of the
        plain version."""
        leaves = [x.to(d).clone().requires_grad_(True) for x in (q, q, q)]
        return torch.autograd.grad(attention(*leaves).sum(), leaves)[0]
    calls = {
        "flash_attention": lambda d: attention(q.to(d), q.to(d), q.to(d)),
        "exit_confidence": lambda d: exit_confidence(h.to(d), w.to(d)),
        "exit_confidence_fused": lambda d: exit_confidence_fused(
            h.to(d), {"scale": scale.to(d)}, w.to(d), kind="rmsnorm"),
        "wkv6": lambda d: wkv6(q.to(d), q.to(d), q.to(d), decay.to(d),
                               q[0, :, 0].to(d)),
        # two vocabulary shards' triples, gathered: (2, 8) each
        "exit_confidence_combine": lambda d: exit_combine(*(
            torch.cat(pair, dim=0).to(d) for pair in zip(
                exit_partials_ref(h, w[:, :2], col0=0),
                exit_partials_ref(h, w[:, 2:], col0=2)))),
        "wkv6_backward": wkv6_grad,
        "flash_attention_backward": attention_grad,
    }
    # a gradient through WKV6 or attention launches the forward kernel too
    also = {"wkv6_backward": "wkv6",
            "flash_attention_backward": "flash_attention"}
    if sorted(calls) != sorted(launch_counts()):
        fail(f"kernels {sorted(launch_counts())}, checks {sorted(calls)}")
    for name, call in calls.items():
        reset_launch_counts()
        cpu_out = call("cpu")
        if any(launch_counts().values()):
            fail(f"{name} on a CPU tensor counted a launch: {launch_counts()}")
        gpu_out = call(dev)
        torch.cuda.synchronize()
        want = {k: int(k in (name, also.get(name))) for k in calls}
        if launch_counts() != want:
            fail(f"{name} on a CUDA tensor: counts {launch_counts()} != {want}")
        cpu_out = cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)
        gpu_out = gpu_out if isinstance(gpu_out, tuple) else (gpu_out,)
        if gpu_out[0].device.type != "cuda":
            fail(f"{name}: a CUDA input gave a {gpu_out[0].device} output")
        check_close(f"{name}[dispatch]", gpu_out[0].cpu(), cpu_out[0],
                    "float32")
    meta = q.to("meta")
    for name, call in (("attention", calls["flash_attention"]),
                       ("wkv6", calls["wkv6"]),
                       ("flash_attention_backward", lambda d: (
                           flash_attention_backward(
                               meta, meta, meta, meta, meta[..., 0], meta,
                               causal=True, window=0, scale=0.25)))):
        try:
            call("meta")
        except ValueError:
            pass
        else:
            fail(f"{name} on a meta tensor did not raise")
    print(f"  {sorted(calls)}: CPU tensor -> plain version, no count; CUDA "
          f"tensor -> kernel, one count each (a WKV6 or attention gradient: "
          f"the forward and the backward kernel); other devices raise")


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
        # a TP = 2 rank's head shard of ElasticBERT-12 served at B = 32
        # (6 of its 12 heads)
        ("tp2_serve_bf16", tc, 32, 6, 6, 64, 64, 64, False, 0, "bfloat16"),
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
                      ("at_seamless_cross64", "seamless_cross64_bf16"),
                      ("at_tp2_serve", "tp2_serve_bf16")):
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


def front_door_records(torch, dev, rec_attn, rec_plain, rec_fused,
                       rec_wkv6):
    """Each kernel held against its plain version and timed at the float32
    shapes the front doors launch it at (`front_doors_phase`): the
    full-width checkpoint served (attention (32,12,64,64), the (768, 2)
    head), the CLI's testbed (6 layers, d 128, 4 heads of 32: attention
    (32,4,64,32), the (128, 2) head, the fused scan edge's 6 x 32 rows with
    per-row layernorm parameters), the decode smoke config's step (2
    layers x 8 prompts, (128, 512) head) and the example's rwkv6-3b smoke
    prefill (8 prompts of 6 tokens, 2 heads of 64). Adds the
    ``at_front_doors*`` entries."""
    import torch.nn.functional as F
    from repro_torch.kernels.exit_confidence.ops import (
        exit_confidence, exit_confidence_fused)
    from repro_torch.kernels.exit_confidence.ref import (
        exit_confidence_fused_ref, exit_confidence_ref)
    from repro_torch.kernels.flash_attention.kernel import attention_variant
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import gqa_ref
    from repro_torch.kernels.wkv6.kernel import wkv6_variant
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    gen = torch.Generator(device=dev).manual_seed(9)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=gen,  # noqa: E731
                                            device=dev) * scale
    f32 = "float32"
    attn_src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    exit_src = "src/repro_torch/kernels/exit_confidence/csrc/exit_confidence.cu"
    for key, shape, note in (
            ("at_front_doors", (32, 12, 64, 64), "the checkpoint served"),
            ("at_front_doors_testbed", (32, 4, 64, 32), "the CLI testbed")):
        q, k, v = (rnd(*shape) for _ in range(3))
        variant = attention_variant(q.dtype, shape[-1], True)
        got = via("flash_attention", variant,
                  lambda: attention(q, k, v, causal=False))
        err = check_close(f"flash_attention[{key[3:]}]", got,
                          gqa_ref(q, k, v, causal=False), f32)
        b, h, s_, d = shape
        rec_attn[key] = record(
            "flash_attention", attn_src,
            "src/repro/kernels/flash_attention/kernel.py:80",
            f"q/k/v {shape} float32, bidirectional ({note})", err,
            lambda: attention(q, k, v, causal=False),
            lambda: gqa_ref(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(q, k, v),
            4 * q.numel() * 4, 4.0 * b * h * s_ * s_ * d, f32, variant)
    for key, (m, d, v), note in (
            ("at_front_doors", (32, 768, 2), "the checkpoint served"),
            ("at_front_doors_testbed", (32, 128, 2), "the CLI testbed"),
            ("at_front_doors_decode", (16, 128, 512),
             "a decode step of the smoke config, 2 layers x 8 prompts")):
        h, w = rnd(m, d), rnd(d, v, scale=d ** -0.5)
        variant = _exit_variant(h, w)
        conf, pred = via("exit_confidence", variant,
                         lambda: exit_confidence(h, w))
        wc, wp = exit_confidence_ref(h, w)
        err = check_close(f"exit_confidence[{key[3:]}]", conf, wc, f32)
        check_pred(f"exit_confidence[{key[3:]}]", pred, wp,
                   lambda: _exit_logits(h, w), f32)
        rec_plain[key] = record(
            "exit_confidence", exit_src,
            "src/repro/kernels/exit_confidence/kernel.py:100",
            f"h ({m},{d}) @ w ({d},{v}) float32 ({note})", err,
            lambda: exit_confidence(h, w), lambda: exit_confidence_ref(h, w),
            lambda: torch.softmax(h @ w, dim=-1).max(dim=-1),
            (m * d + d * v) * 4 + m * 8, 2.0 * m * d * v, f32, variant)
    m, d, v = 6 * 32, 128, 2
    x, w = rnd(m, d, scale=2.0) + 0.5, rnd(d, v, scale=d ** -0.5)
    norm = {"scale": rnd(m, d, scale=0.1) + 1.0, "bias": rnd(m, d, scale=0.1)}
    variant = _exit_variant(x, w)
    conf, pred = via("exit_confidence_fused", variant,
                     lambda: exit_confidence_fused(x, norm, w,
                                                   kind="layernorm"))
    err = check_close("exit_confidence_fused[front_doors_testbed_scan]", conf,
                      exit_confidence_fused_ref(x, norm, w,
                                                kind="layernorm")[0], f32)
    rec_fused["at_front_doors_testbed_scan"] = record(
        "exit_confidence_fused", exit_src,
        "src/repro/kernels/exit_confidence/kernel.py:186",
        f"layernorm x ({m},{d}), per-row (M,D) params, w ({d},{v}) float32 "
        f"(the CLI testbed's fused scan edge)", err,
        lambda: exit_confidence_fused(x, norm, w, kind="layernorm"),
        lambda: exit_confidence_fused_ref(x, norm, w, kind="layernorm"),
        None, (3 * m * d + d * v) * 4 + m * 8, 2.0 * m * d * v + 8.0 * m * d,
        f32, variant)
    b, h, t, dk = 8, 2, 6, 64
    r, k, v_ = (rnd(b, h, t, dk) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(b, h, t, dk).clamp(-10.0, 2.0) - 1.0))
    u = rnd(h, dk) * 0.1
    variant = wkv6_variant(r, k, v_, w)
    y, st = via("wkv6", variant, lambda: wkv6(r, k, v_, w, u))
    wy, ws = wkv6_ref(r, k, v_, w, u)
    err = max((y - wy).abs().max().item(), (st - ws).abs().max().item())
    if not (torch.allclose(y, wy, rtol=WKV6_TOL, atol=WKV6_TOL)
            and torch.allclose(st, ws, rtol=WKV6_TOL, atol=WKV6_TOL)):
        fail(f"wkv6[front_doors_example]: kernel vs plain max |err| "
             f"{err:.3e} > tol {WKV6_TOL}")
    rec_wkv6["at_front_doors_example"] = record(
        "wkv6", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "src/repro/kernels/wkv6/kernel.py:57",
        f"r/k/v ({b},{h},{t},{dk}) float32, w float32, u ({h},{dk}) (the "
        f"lm_decode example's rwkv6-3b smoke prefill)", err,
        lambda: wkv6(r, k, v_, w, u), lambda: wkv6_ref(r, k, v_, w, u), None,
        4 * 4 * b * h * t * dk + h * dk * 4 + (b * h * t * dk
                                               + b * h * dk * dk) * 4,
        5.0 * b * h * t * dk * dk, f32, variant)
    print("  front-door shapes (float32): attention, exit, fused exit and "
          "WKV6 held to their plain versions and timed")


def launched_once(kernel: str, fn):
    """``fn()``, which must launch ``kernel`` once and no other kernel."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    out = fn()
    moved = {k: n - before[k] for k, n in launch_counts().items()
             if n != before[k]}
    if moved != {kernel: 1}:
        fail(f"{kernel}: expected one launch, counted {moved}")
    return out


def exit_shard_checks(torch, dev, rec_plain, rec_fused):
    """The exit over a vocabulary split in two, as the ranks of a TP = 2
    mesh serve it: each half of the head scored by the kernel in its
    partials mode (global columns), the two ranks' triples gathered and
    combined by the combine kernel, held against the whole-row plain
    version, plain and fused (shared layernorm), at ElasticBERT-12's
    (768, 2) head (1 column a rank: small_head) and rwkv6-3b's (2560,
    65536) LM head (32768 columns a rank: tensor_core); exact ties across
    the shard boundary go to the lowest global column; the combine kernel
    against `combine_partials_ref` on the same triples. Adds the
    ``at_tp2_serve`` (ElasticBERT-12) and ``at_tp2_serve_lm`` (rwkv6-3b)
    entries of a rank's partials launch at its shard, and returns the
    combine kernel's JSON entry (rwkv6-3b's gathered triples, ElasticBERT's
    as its ``at_tp2_serve``)."""
    from repro_torch.kernels.exit_confidence.ops import (
        exit_combine, exit_partials, exit_partials_fused)
    from repro_torch.kernels.exit_confidence.ref import (
        combine_partials_ref, exit_confidence_fused_ref, exit_confidence_ref,
        exit_partials_fused_ref, exit_partials_ref)
    from repro_torch.models.common import apply_norm

    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=gen,  # noqa: E731
                                            device=dev) * scale
    bf16, b, tp = torch.bfloat16, SERVE_BATCH, 2
    src = "src/repro_torch/kernels/exit_confidence/csrc/exit_confidence.cu"

    def shards(w):
        v = w.shape[-1] // tp
        return [(r * v, w[..., r * v:(r + 1) * v].contiguous())
                for r in range(tp)]

    def split_exit(kname, h, w, norm=None, tile=None):
        """Every rank's partials launch, the triples gathered in rank
        order, one combine launch: (conf, pred, triples)."""
        parts = []
        for col0, ws in shards(w):
            call = (lambda: exit_partials(h, ws, col0=col0)) if norm is None \
                else (lambda: exit_partials_fused(h, norm, ws,
                                                  kind="layernorm",
                                                  col0=col0))
            parts.append(via(kname, _exit_variant(h, ws), call, tile))
        tri = tuple(torch.cat([p[i] for p in parts], dim=-2)
                    for i in range(3))
        conf, pred = launched_once("exit_confidence_combine",
                                   lambda: exit_combine(*tri))
        want = combine_partials_ref(*tri)
        torch.cuda.synchronize()
        check_close(f"exit_confidence_combine[{kname}]", conf, want[0],
                    "float32")
        if not torch.equal(pred, want[1]):
            fail(f"exit_confidence_combine[{kname}]: pred differs from "
                 f"combine_partials_ref's on the same triples")
        return conf, pred, tri

    def held(name, kname, h, w, norm=None, tile=None, lm=False):
        conf, pred, tri = split_exit(kname, h, w, norm, tile)
        hn = h if norm is None else apply_norm(h, norm, "layernorm")
        wc, wp = (exit_confidence_ref(h, w) if norm is None
                  else exit_confidence_fused_ref(h, norm, w, kind="layernorm"))
        err = (conf - wc).abs().max().item()
        if lm:
            check_lm_conf(name, conf, wc, _exit_logits(hn, w), "bfloat16",
                          h.shape[-1])
        else:
            check_close(name, conf, wc, "bfloat16")
        flips = check_pred(name, pred, wp, lambda: _exit_logits(hn, w),
                           "bfloat16")
        print(f"  {name}: {tp} vocabulary shards' partials + combine vs the "
              f"whole-row plain version: max|err| {err:.3e}, pred flips at "
              f"near-ties {flips}")
        return err, tri

    def rank_record(kname, replaces, h, w, err, norm=None):
        """The JSON entry of rank 0's partials launch at its shard."""
        _, ws = shards(w)[0]
        bsz, d = h.shape
        v = ws.shape[-1]
        splits = exit_partials(h, ws, col0=0)[0].shape[-2]
        nbytes = h.numel() * 2 + ws.numel() * 2 + 3 * splits * bsz * 4
        if norm is None:
            return record(
                kname, src, replaces,
                f"h ({bsz},{d}) @ w ({d},{v}) bfloat16, a TP = {tp} rank's "
                f"vocabulary shard (partials mode)", err,
                lambda: exit_partials(h, ws, col0=0),
                lambda: exit_partials_ref(h, ws),
                lambda: torch.softmax(h @ ws, dim=-1).max(dim=-1),
                nbytes, 2.0 * bsz * d * v, "bfloat16", _exit_variant(h, ws))
        return record(
            kname, src, replaces,
            f"layernorm x ({bsz},{d}), shared (D,) params, w ({d},{v}) "
            f"bfloat16, a TP = {tp} rank's vocabulary shard (partials mode)",
            err, lambda: exit_partials_fused(h, norm, ws, kind="layernorm"),
            lambda: exit_partials_fused_ref(h, norm, ws, kind="layernorm"),
            None, nbytes + 2 * d * 2, 2.0 * bsz * d * v + 8.0 * bsz * d,
            "bfloat16", _exit_variant(h, ws))

    def combine_record(tri, err, note):
        g = 1 if tri[0].ndim == 2 else tri[0].shape[0]
        p, bsz = tri[0].shape[-2:]
        return record(
            "exit_confidence_combine", src,
            "src/repro/kernels/exit_confidence/kernel.py:100",
            f"triples ({p},{bsz}) of {tp} ranks' vocabulary splits{note}",
            err, lambda: exit_combine(*tri),
            lambda: combine_partials_ref(*tri),
            None,       # no single PyTorch call combines split softmaxes
            3 * g * p * bsz * 4 + 2 * g * bsz * 4, 6.0 * g * p * bsz,
            "float32", None)

    main, lm_head = (768, 2), (2560, 65536)
    out = {}
    for key, (d, v), lm, tile in (("at_tp2_serve", main, False, None),
                                  ("at_tp2_serve_lm", lm_head, True,
                                   "mma_sync")):
        h = rnd(b, d).to(bf16)
        w = rnd(d, v, scale=d ** -0.5).to(bf16)
        x = (rnd(b, d, scale=2.0) + 0.5).to(bf16)
        norm = {"scale": (rnd(d, scale=0.1) + 1.0).to(bf16),
                "bias": rnd(d, scale=0.1).to(bf16)}
        err, tri = held(f"exit_confidence[{key[3:]}]", "exit_confidence", h,
                        w, tile=tile, lm=lm)
        err_f, _ = held(f"exit_confidence_fused[{key[3:]}]",
                        "exit_confidence_fused", x, w, norm, tile=tile, lm=lm)
        rec_plain[key] = rank_record(
            "exit_confidence", "src/repro/kernels/exit_confidence/kernel.py:100",
            h, w, err)
        rec_fused[key] = rank_record(
            "exit_confidence_fused",
            "src/repro/kernels/exit_confidence/kernel.py:186", x, w, err_f,
            norm)
        err_c = (exit_combine(*tri)[0] - combine_partials_ref(*tri)[0]
                 ).abs().max().item()
        out[key] = combine_record(
            tri, err_c, " (rwkv6-3b's LM head)" if lm else
            " (ElasticBERT-12's head)")
    # exact ties across the shard boundary: the lowest global column wins
    h_t = torch.ones((b, 64), device=dev, dtype=bf16)
    for cols in ((300, 40000), (32767, 32768), (40000, 65535)):
        w_t = torch.zeros((64, 65536), device=dev, dtype=bf16)
        w_t[:, list(cols)] = 2.0
        pred = split_exit("exit_confidence", h_t, w_t)[1]
        if not (pred == min(cols)).all():
            fail(f"exit over {tp} vocabulary shards: tie at columns {cols}, "
                 f"pred {pred.unique().tolist()}")
    pred = split_exit("exit_confidence", h_t, torch.ones(
        (64, 2), device=dev, dtype=bf16))[1]
    if not (pred == 0).all():
        fail("exit over 2 one-column shards: a tie did not go to column 0")
    print(f"  exit over {tp} vocabulary shards: ties across the shard "
          f"boundary go to the lowest global column")
    rec = out["at_tp2_serve_lm"]
    rec["at_tp2_serve"] = out["at_tp2_serve"]
    return rec


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

    def timed(args, shape_note, err=err_main):
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
            f"{shape_note}", err,
            lambda: via("wkv6", "vec16", lambda: wkv6(r, k, v, w, u)),
            lambda: wkv6_ref(r, k, v, w, u),
            None,       # no single PyTorch call computes this recurrence
            nbytes, 5.0 * b * h * t * dk * dv, "float32", "vec16")

    rec = timed(main, "")
    rec["at_b4"] = timed(tuple(a[:4] if a.ndim == 4 else a for a in main),
                         " (a depth bucket of 4)")
    rec["at_b8"] = timed(tuple(a[:8] if a.ndim == 4 else a for a in main),
                         " (the decode prefill of B = 8)")
    # a TP = 2 rank's head shard of rwkv6-3b served at B = 32 (20 of its
    # 40 heads, u sliced to them)
    shard = inputs(32, 20, 64, 64, 64, bf16)
    rec["at_tp2_serve"] = timed(shard, " (a TP = 2 rank's 20-head shard)",
                                case("tp2_shard_bf16", shard))
    return rec


def wkv6_backward_checks(torch, dev):
    """The WKV6 backward kernel against the plain backward: all five
    gradients at WKV6_GRAD_RTOL, each case one launch through the variant
    it must take (`wkv6_backward_variant`): the training shape (16, 40, 64, 64) as time_mix hands it
    over (bf16 (B, T, H, hd) views, dy in y's layout) and in f32, T = 37
    with a nonzero final-state cotangent, dk = dv = 32, rows off 16 bytes
    (``scalar``); two launches bitwise equal; at (1, 4, 4096, 64) f32 the
    float64 witness (WKV6_GRAD_WITNESS_FACTOR). Prints every backward
    instantiation's residency, registers and spills. Returns the training
    shape's record (kernel, plain, bound; the forward's ms beside it)."""
    from repro_torch.kernels.wkv6.kernel import (VARIANTS,
                                                 backward_occupancy,
                                                 wkv6_backward_cuda,
                                                 wkv6_backward_variant,
                                                 wkv6_cuda)
    from repro_torch.kernels.wkv6.ref import wkv6_backward_ref

    gen = torch.Generator(device=dev).manual_seed(28)
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        for variant in VARIANTS:
            occ = backward_occupancy(dtype, variant)
            print(f"  wkv6_backward {str(dtype).split('.')[1]} {variant}: "
                  f"{occ['blocks_per_sm']} blocks/SM of 128 threads, "
                  f"{occ['registers']} registers, {occ['shared_bytes']} B "
                  f"shared, {occ['local_bytes']} B local (stack and spills)")

    def inputs(b, h, t, dk, dv, dtype, layout="heads_last", state=False):
        """r, k, v, w, u and the cotangents: (B, T, H, d) memory seen as
        (B, H, T, d) as time_mix passes it ("heads_last"), contiguous, or
        one element off 16 bytes; w as `_decay` draws it, down to
        exp(-e^2)."""
        def rnd(d, scale=1.0, dt=f32):
            if layout == "heads_last":
                x = torch.randn((b, t, h, d), generator=gen, device=dev)
                return (x * scale).to(dt).transpose(1, 2)
            x = (torch.randn((b, h, t, d), generator=gen, device=dev)
                 * scale).to(dt)
            if layout == "offset1":
                buf = torch.empty(x.numel() + 1, dtype=dt, device=dev)
                x = buf[1:].view(x.shape).copy_(x)
            return x
        r, k, v = rnd(dk, dt=dtype), rnd(dk, dt=dtype), rnd(dv, dt=dtype)
        w = torch.exp(-torch.exp((rnd(dk) * 2.0).clamp(-10.0, 2.0)))
        u = torch.randn((h, dk), generator=gen, device=dev) * 0.5
        dy = rnd(dv)
        ds = torch.randn((b, h, dk, dv), generator=gen, device=dev) \
            if state else None
        return r, k, v, w, u, dy, ds

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-300)).item()

    names = ("dr", "dk", "dv", "dw", "du")

    def case(name, args):
        r, k, v, w, u, dy, ds = args
        variant = wkv6_backward_variant(r, k, v, w, dy)
        got = via("wkv6_backward", variant,
                  lambda: wkv6_backward_cuda(r, k, v, w, u, dy, ds))
        want = wkv6_backward_ref(r, k, v, w, u, dy, ds)
        torch.cuda.synchronize()
        errs, abs_err = [], 0.0
        for part, g, wt in zip(names, got, want):
            if g.dtype != wt.dtype or g.shape != wt.shape:
                fail(f"wkv6_backward[{name}] {part}: {g.dtype} "
                     f"{tuple(g.shape)}, want {wt.dtype} {tuple(wt.shape)}")
            tol = WKV6_GRAD_RTOL[str(g.dtype).split(".")[1]]
            err = rel(g, wt)
            if not (err <= tol and torch.isfinite(g).all()):
                fail(f"wkv6_backward[{name}] {part}: kernel vs plain max "
                     f"|err| / max |plain| {err:.3e} > {tol}")
            errs.append(err)
            abs_err = max(abs_err, (g.double() - wt.double()).abs().max()
                          .item())
        print(f"  wkv6_backward[{name}] ({variant}) max |err| / "
              f"max |plain|: " + ", ".join(
                  f"{n} {e:.3e}" for n, e in zip(names, errs))
              + f" (tol {WKV6_GRAD_RTOL}); max |err| {abs_err:.3e}")
        return got, abs_err

    def bitwise(name, args, got):
        again = wkv6_backward_cuda(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"wkv6_backward[{name}]: two launches differ")
        print(f"  wkv6_backward[{name}]: a second launch bitwise equal")

    train = inputs(16, 40, 64, 64, 64, bf16)
    got, err_train = case("train_bf16", train)
    bitwise("train_bf16", train, got)
    case("train_f32", inputs(16, 40, 64, 64, 64, f32))
    case("t37_state_f32", inputs(4, 40, 37, 64, 64, f32, "contiguous",
                                 state=True))
    case("t37_state_bf16", inputs(2, 4, 37, 64, 64, bf16, state=True))
    case("dk32_dv32_f32", inputs(2, 8, 50, 32, 32, f32, state=True))
    case("dk48_dv40_f32", inputs(2, 3, 33, 48, 40, f32, "contiguous"))
    case("offset1_bf16", inputs(2, 4, 21, 64, 64, bf16, "offset1",
                                state=True))

    # the float64 witness at T = 4096
    long = inputs(1, 4, 4096, 64, 64, f32, "contiguous", state=True)
    got, _ = case("t4096_f32", long)
    bitwise("t4096_f32", long, got)
    plain = wkv6_backward_ref(*long)
    f64 = wkv6_backward_ref(*(None if x is None else x.double()
                              for x in long))

    def dist(a, b):
        return ((a.double() - b).norm() / b.norm()).item()
    for part, g, p32, p64 in zip(names, got, plain, f64):
        card, cpu = dist(g, p64), dist(p32, p64)
        ratio = card / cpu
        print(f"  wkv6_backward[t4096_f32] {part}: distance from float64 "
              f"(normwise) kernel {card:.3e}, plain float32 {cpu:.3e}: "
              f"{ratio:.3f}x (bound {WKV6_GRAD_WITNESS_FACTOR}); max |err| "
              f"/ max kernel {rel(g, p64):.3e}, plain {rel(p32, p64):.3e}")
        if not ratio <= WKV6_GRAD_WITNESS_FACTOR:
            fail(f"wkv6_backward[t4096_f32] {part}: {ratio:.3f}x the plain "
                 f"float32 backward's distance from float64")
    del long, plain, f64

    r, k, v, w, u, dy, ds = train
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    variant = wkv6_backward_variant(r, k, v, w, dy)
    # bytes: r, k, v read in bf16, w and dy in f32, u; dr, dk, dv written
    # in bf16, dw and du in f32. operations: 14 per (step, i, j): the
    # recomputed state update 3, G's update 3, dr, dk, dv and dw 2 each
    nbytes = ((2 * dk + dv) * 2 + (dk + dv) * 4) * b * h * t + h * dk * 4 \
        + ((2 * dk + dv) * 2 + dk * 4) * b * h * t + h * dk * 4
    rec = record(
        "wkv6_backward", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "src/repro/kernels/wkv6/kernel.py:57",
        f"r/k/v ({b},{h},{t},{dk}) bfloat16 (B, T, H, hd) views, w and dy "
        f"float32, u ({h},{dk}), no final-state cotangent (training)",
        err_train,
        lambda: via("wkv6_backward", variant,
                    lambda: wkv6_backward_cuda(r, k, v, w, u, dy, ds)),
        lambda: wkv6_backward_ref(r, k, v, w, u, dy, ds),
        None,       # no single PyTorch call computes this gradient
        nbytes, 14.0 * b * h * t * dk * dv, "float32", variant)
    rec["gradient_of"] = "wkv6_pallas (the reference differentiates its " \
        "plain scan with XLA; no backward kernel)"
    rec["forward_ms"] = graph_ms(lambda: wkv6_cuda(r, k, v, w, u))
    print(f"  wkv6_backward at {rec['shape']} ({variant}): device "
          f"ms per call (CUDA graph): kernel {rec['ms']:.5f}, plain "
          f"{rec['plain_ms']:.5f}, bound {rec['bound_ms']:.6f} "
          f"({rec['bound_by']}); the forward kernel at the same shape "
          f"{rec['forward_ms']:.5f}")
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


def train_attention_launches(cfg, remat: bool) -> int:
    """Attention launches of one `train_loss` step (`make_train_step`): one
    a layer of a pass through the decoder stack (a hybrid's at its shared
    block's occurrences, `layer_launches`) and, for an enc-dec model, the
    encoder's layers and each decoder layer's self- and cross-attention.
    ``remat`` recomputes each checkpointed decoder layer in the backward,
    which launches its attention again; the encoder is not checkpointed;
    an ssm stack has no attention. No exit kernel runs: `train_loss` reads
    plain logits."""
    if cfg.family == "ssm":
        return 0
    passes = 2 if remat else 1
    if cfg.encoder is not None:
        return cfg.encoder.num_layers + passes * 2 * cfg.num_layers
    return passes * layer_launches(cfg, 0, cfg.num_layers)


def train_backward_launches(cfg) -> int:
    """Launches of attention's backward kernel in one `train_loss` step:
    one for each attention call under a gradient, with or without remat
    (remat's first pass runs without a graph, its recompute is the call
    the backward differentiates)."""
    return train_attention_launches(cfg, remat=False)


def train_backward_tiles(cfg, positions: int) -> dict:
    """Backward-kernel launches of one bf16 `train_loss` step by tile of
    its tensor_core variant ({tile: n}, as `attention_backward_tile`
    picks it for each call's shape): each decoder layer's self-attention
    over ``positions`` keys (a hybrid's at its shared block's uses, as
    `layer_launches` counts them) and, for an enc-dec model, each
    encoder layer over its source frames and each decoder layer's
    cross-attention of ``positions`` queries over them. An ssm stack has
    none."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        attention_backward_tile
    out = {}

    def add(sq, skv, n):
        tile = attention_backward_tile(torch.bfloat16,
                                       cfg.resolved_head_dim, True, sq, skv)
        out[tile] = out.get(tile, 0) + n
    if cfg.family == "ssm":
        return out
    if cfg.encoder is not None:
        src = cfg.encoder.source_len
        add(src, src, cfg.encoder.num_layers)
        add(positions, src, cfg.num_layers)
        add(positions, positions, cfg.num_layers)
    else:
        add(positions, positions, layer_launches(cfg, 0, cfg.num_layers))
    return out


def expected_launches(arms, exited, batch_size: int, cfg, fused: bool, *,
                      edge_mode: str = "bucketed", side_info: bool = False,
                      lm_head: bool = False, combine: bool = False):
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
    SplitEE-S or scan edge call, pow2-padded bucket rows otherwise.
    ``combine``: a head split over a "model" mesh axis, where each exit
    call is a launch in partials mode (counted as the exit kernel) and
    one of the combine kernel."""
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
        n["exit_confidence_combine"] += int(combine)
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
            edge_mode="bucketed", side_info=False, full=True, ranks=1,
            combine=False):
        """``fn()`` serves; its launches must be what its decisions need
        (`expected_launches`), every launch through the variant
        SERVE_VARIANTS names (a float32 ``cfg``'s attention and LM head
        through `cuda_core`) and, at a bf16 LM head, the tile its rows
        take.
        ``full``: a run of the whole stream, which must also pull every
        arm and both exit and offload. ``ranks``: ranks on threads of this
        process, each serving the whole stream and counting its launches
        into the same counts (each must make what the decisions need);
        ``combine``: the head split over a "model" axis (each exit a
        partial and a combine launch). Returns (report, wall seconds,
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
        # a float32 model runs attention and an LM head on the CUDA cores
        f32 = cfg.dtype == "float32"
        lm_head = SERVE_VARIANTS[cfg.family]["exit_confidence"] == \
            "tensor_core" and not f32
        want, want_tiles, rows = expected_launches(
            out["arms"], out["exited"], batch_size, cfg, fused,
            edge_mode=edge_mode, side_info=side_info, lm_head=lm_head,
            combine=combine)
        want = {k: ranks * n for k, n in want.items()}
        want_tiles = {k: ranks * n for k, n in want_tiles.items()}
        if counts != want:
            fail(f"{name}: kernel launches {counts}, but its decisions "
                 f"need {want}")
        if tiles != want_tiles:
            fail(f"{name}: tensor-core exit launches by tile {tiles}, but "
                 f"its decisions need {want_tiles}")
        for kname in (layer_kernel, "exit_confidence") + \
                (("exit_confidence_fused",) if fused else ()) + \
                (("exit_confidence_combine",) if combine else ()):
            if counts[kname] <= 0:
                fail(f"{name}: kernel {kname} was not launched")
        for kname, variant in SERVE_VARIANTS[cfg.family].items():
            if f32 and variant == "tensor_core":
                variant = "cuda_core"
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
                  scan, prefix: str = "", timed_runs: bool = True):
    """The sharded runtime (`serve(path="sharded")`) at R = 1 on the card:
    overlap off (bucketed and scan, each bitwise the batched path's run:
    ``bucketed`` from `serve_phase`, ``scan`` from `front_end_phase`),
    the depth-K offload pipeline at K = 1 and 2 and K = 1 with fused
    exits, and an `Engine` fed in ragged chunks (bitwise the one-shot
    K = 2 run); each run's launches held against its decisions. With
    ``timed_runs``, prints samples/s, wall and device busy (torch.profiler
    over one more run) of sync, K = 1 and K = 2, and sync against the
    batched path in turns. R above the visible cards must raise. Returns
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

    if timed_runs:
        sharded_timing(torch, rt, params, cfg, data, cost, runs, runs_cfg,
                       out, bucketed, prefix)

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


def sharded_timing(torch, rt, params, cfg, data, cost, runs, runs_cfg, out,
                   bucketed, prefix):
    """`sharded_phase`'s timings: R = 1 sync against the batched path in
    turns, and samples/s, wall and device busy of sync, K = 1 and K = 2."""
    from repro_torch.data import OnlineStream
    from repro_torch.serving import ServingConfig, serve

    def timed(config):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = serve(rt, params, OnlineStream(data, seed=0), cost, config)
        torch.cuda.synchronize()
        return rep["n"] / (time.perf_counter() - t0)

    # R = 1 sync against the batched path in turns (batched, sharded,
    # sharded, batched): the host's rate drifts between runs of one call
    B = SERVE_BATCH
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


# model-parallel serving (`model_serving_phase`): the ranks of a
# ("data", "model") mesh of TP_RANKS sharing the card as threads; rwkv6-3b
# at TP = 2 on the first TP_LM_SAMPLES samples of the stream (two
# micro-batches)
TP_RANKS = 2
TP_LM_SAMPLES = 64
# rwkv6-3b's float32 cut served at TP = TP_RANKS, held to its unbound run
# within LM_FORWARD_RTOL (relative: its confidences are of the order of
# 1 / V)
TP_LM_CUT_LAYERS = 8
# rwkv6-3b in bfloat16 at all its layers, served at TP = TP_RANKS: random
# weights turn a last-bit change into a confidence change that grows with
# depth to more than 100 %, so its bound is read in the same call, exit by
# exit (`bf16_noise`): the unbound bfloat16 forward's largest relative
# distance from the float32 forward at that exit over the served samples,
# times TP_NOISE_FACTOR (two bfloat16 paths, each within that distance of
# float32, are within twice it of each other); a served confidence is
# held to the bound of its arm's exit
TP_NOISE_FACTOR = 2.0
# ElasticBERT-12's float32 run at TP = TP_RANKS serves the stream's first
# 128 samples (4 micro-batches), for the 1200 s limit
TP_F32_SAMPLES = 128
# bfloat16 served confidences of TP > 1 against the unbound run: each
# rank's share of a row-parallel product rounds to bfloat16 before the
# shares are summed, where the unbound product rounds once (about 6e-3 at
# full-width ElasticBERT-12); the float32 run holds FULL_FORWARD_ATOL
TP_BF16_ATOL = TOL["bfloat16"]


def served_confidences(rep):
    """Each sample's served confidence (at its arm), from the trace."""
    import numpy as np
    return np.array([c[-1] for c in rep["trace"]["conf_path"]])


def bf16_noise(torch, dev, params, cfg, tokens):
    """Exit by exit, the largest relative distance of the bfloat16
    forward's confidences (``params``, on the card) from the float32
    forward's of the same weights over the rows of ``tokens`` (in
    micro-batches of SERVE_BATCH): the rounding noise of the unbound
    bfloat16 path, read on the card in this call. A numpy array (L,)."""
    from repro_torch.models.transformer import ParamTree, forward_exits
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32 = ParamTree(_tree_to(params, dev, torch.float32))
    worst = torch.zeros(cfg.num_layers, dtype=torch.float64)
    for lo in range(0, len(tokens), SERVE_BATCH):
        batch = {"tokens": torch.as_tensor(tokens[lo:lo + SERVE_BATCH])
                 .to(dev)}
        bf16 = forward_exits(params, cfg, batch)["conf"].double()
        ref = forward_exits(f32, f32_cfg, batch)["conf"].double()
        worst = torch.maximum(worst, ((bf16 - ref).abs() / ref)
                              .amax(dim=1).cpu())
    del f32
    torch.cuda.empty_cache()
    return worst.numpy()


def held_to_unbound(name, got, ref, alpha, tol, *, relative=False):
    """``got``'s served confidences agree with ``ref``'s within ``tol`` up
    to their first differing decision, and that one may only be an exit
    flipped at an unchanged arm by confidences within ``tol`` of alpha
    (as `decisions_phase` holds the card to the CPU); ``relative``: both
    as a share of the confidence (an LM head's confidences are of the
    order of 1 / V). ``tol`` is one number, or an array of one per arm
    (a sample is held to its arm's)."""
    import numpy as np
    first = decision_difference("", ref, got, alpha, ("unbound", name))
    conf_g, conf_r = served_confidences(got), served_confidences(ref)
    arms = np.asarray(ref["arms"])
    tols = np.broadcast_to(np.asarray(tol)[arms] if np.ndim(tol)
                           else tol, conf_r.shape)
    upto = len(conf_r) if first is None else first
    err = np.abs(conf_g[:upto] - conf_r[:upto])
    if relative:
        err = err / conf_r[:upto]
    what = "relative " if relative else ""
    if np.ndim(tol):
        worst = int(np.argmax(err / tols[:upto])) if upto else 0
        print(f"    {name} vs unbound: served confidences up to the first "
              f"differing decision max {what}|err| "
              f"{float(err.max(initial=0.0)):.3e}; nearest its arm's bound: "
              f"sample {worst} (arm {int(arms[worst])}) {what}|err| "
              f"{float(err[worst]) if upto else 0.0:.3e} (tol "
              f"{float(tols[worst]):.3e})")
    else:
        print(f"    {name} vs unbound: served confidences up to the first "
              f"differing decision max {what}|err| "
              f"{float(err.max(initial=0.0)):.3e} (tol {tol})")
    over = np.nonzero(~(err <= tols[:upto]))[0]
    if len(over):
        s = int(over[0])
        fail(f"{name}: served conf vs the unbound run at sample {s} (arm "
             f"{int(arms[s])}) {what}|err| {float(err[s]):.3e} > "
             f"{float(tols[s]):.3e}")
    if first is not None:
        far = max(abs(conf_g[first] - alpha), abs(conf_r[first] - alpha))
        far = far / alpha if relative else far
        if got["arms"][first] != ref["arms"][first] \
                or not far <= tols[first]:
            fail(f"{name}: first differs from the unbound run at sample "
                 f"{first}, not an exit flipped within {what}"
                 f"{float(tols[first]):.3e} of alpha")


def model_serving_phase(torch, dev, runs: Runs, params, cfg, data, cost,
                        prefix: str = ""):
    """`serve(path="sharded", mesh=)` over a ("data", "model") `DeviceMesh`
    on the card, Megatron-split by `param_shardings`: every rank runs the
    serving loop on its shards (attention and WKV6 on its head shard, the
    exit's partials on its vocabulary shard and the combine across the
    ranks) and reads whole confidences.

    ElasticBERT-12, the whole stream: TP = 1 on a (1, 1) mesh over an NCCL
    world of 1 (sync, K = 1, and an `Engine(mesh=)` push-session == the
    one-shot K = 1 run bit for bit), then TP = TP_RANKS on a (1, TP_RANKS)
    mesh of threaded ranks sharing the card (sync and K = 1; host dispatch
    takes some 10 s a run there). Each run is held to the unbound sharded
    R = 1 run of its config (`held_to_unbound`): at TP = 1 within
    FULL_FORWARD_ATOL (no product is split), above it within TP_BF16_ATOL,
    since each rank's share of a row-parallel product rounds to bfloat16
    before the shares are summed, where the unbound product rounds once;
    so it also serves in float32 at TP = TP_RANKS (the first
    TP_F32_SAMPLES samples), held within FULL_FORWARD_ATOL.

    rwkv6-3b, its first TP_LM_SAMPLES samples at TP = TP_RANKS through the
    scan edge (one masked forward a micro-batch, where the first
    micro-batch's 32 arms would make 32 bucketed edge calls): bf16 at full
    depth, held within TP_NOISE_FACTOR times the unbound bf16 forward's
    own relative distance from float32 (`bf16_noise`), and a float32 cut
    to TP_LM_CUT_LAYERS layers held within LM_FORWARD_RTOL.

    Every run's launches are held to its decisions on every rank (a
    partials and a combine launch for each exit call), every attention or
    WKV6 launch to the rank's head shard, and every rank's decisions to
    rank 0's."""
    import logging
    import torch.distributed as dist
    from repro_torch.data import OnlineStream
    from repro_torch.launch.mesh import make_mesh, make_model_serving_mesh
    from repro_torch.models.transformer import ParamTree, _ssm_heads
    from repro_torch.serving import (EdgeCloudRuntime, Engine, ServingConfig,
                                     serve)
    from repro_torch.serving.distributed import _free_port

    # DTensor warns at every two-axis all-reduce of a (1, n) mesh
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    lm = cfg.family == "ssm"
    n = TP_LM_SAMPLES if lm else SERVE_SAMPLES
    data = {k: v[:n] for k, v in data.items()}
    base = ServingConfig(path="sharded", batch_size=SERVE_BATCH,
                         record_trace=True)
    sync, k1 = dataclasses.replace(base, overlap=False), base
    heads = LAYER_KERNEL[cfg.family], (_ssm_heads(cfg) if lm
                                       else cfg.num_heads)

    def one_shot(config, mesh=None, tree=params, c=cfg):
        return serve(EdgeCloudRuntime(c, device=dev), tree,
                     OnlineStream(data, seed=0), cost, config, mesh=mesh)

    def engine(mesh):
        eng = Engine(EdgeCloudRuntime(cfg, device=dev), params, cost, k1,
                     mesh=mesh)
        samples, i = list(OnlineStream(data, seed=0)), 0
        while i < len(samples):
            for c in (5, 1, 7, 3, 16, 2, 30, 20, 12, 64, 33):
                eng.submit(samples[i:i + c])
                i += c
        return eng.close()

    def on_mesh(tp, fn):
        """``fn(mesh)`` on every rank of a (1, tp) mesh; every rank's
        decisions equal rank 0's; returns rank 0's report."""
        if tp == 1:
            dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                    f"{_free_port()}", rank=0, world_size=1)
            try:
                return fn(make_model_serving_mesh(1, 1, device="cuda"))
            finally:
                dist.destroy_process_group()
        reps = on_threaded_ranks(torch, tp, lambda rank: fn(
            make_mesh((1, tp), ("data", "model"), device="cuda")))
        for r in range(1, tp):
            same_run(f"rank {r} vs rank 0", reps[r], reps[0])
        return reps[0]

    def tp_run(name, tp, fn, ref, c=cfg, edge_mode="bucketed", rtol=None):
        shapes = {}
        with launch_shapes(shapes):
            rep, wall, _ = runs.run(
                torch, prefix + name, lambda: on_mesh(tp, fn), c,
                batch_size=SERVE_BATCH, full=not lm, ranks=tp, combine=True,
                edge_mode=edge_mode)
        kernel, h = heads
        got = {s[1] for s in shapes[kernel]}
        if got != {h // tp}:
            fail(f"{prefix}{name}: {kernel} launched on {sorted(got)} heads, "
                 f"want each rank's {h // tp} of {h}")
        print(f"    {kernel} on {h // tp} of {h} heads a rank (shapes "
              f"{sorted(set(shapes[kernel]))})")
        if lm:
            held_to_unbound(prefix + name, rep, ref, c_cost.alpha, rtol,
                            relative=True)
        elif ref is not None:
            atol = FULL_FORWARD_ATOL if tp == 1 or c.dtype == "float32" \
                else TP_BF16_ATOL
            held_to_unbound(prefix + name, rep, ref, cost.alpha, atol)
        return rep

    if lm:
        scan = dataclasses.replace(sync, edge_mode="scan")
        c_cost = cost
        noise = bf16_noise(torch, dev, params, cfg, data["tokens"])
        print(f"  {cfg.arch_id} unbound bf16 vs float32 forward_exits over "
              f"the {n} samples, conf max relative distance exit by exit "
              f"(the TP={TP_RANKS} bound is {TP_NOISE_FACTOR} x each): "
              + " ".join(f"{x:.3e}" for x in noise))
        tp_run(f"model mesh TP={TP_RANKS} sync scan", TP_RANKS,
               lambda mesh: one_shot(scan, mesh), one_shot(scan),
               edge_mode="scan", rtol=TP_NOISE_FACTOR * noise)
        cut_cfg, cut = lm_cut(params, cfg, TP_LM_CUT_LAYERS)
        cut = ParamTree(_tree_to(cut, dev, torch.float32))
        c_cost = dataclasses.replace(cost, num_layers=TP_LM_CUT_LAYERS,
                                     alpha=calibrated_alpha(
                                         torch, cut, cut_cfg, data["tokens"],
                                         TP_LM_CUT_LAYERS // 2))
        one_cut = lambda mesh=None: serve(  # noqa: E731
            EdgeCloudRuntime(cut_cfg, device=dev), cut,
            OnlineStream(data, seed=0), c_cost, scan, mesh=mesh)
        tp_run(f"model mesh TP={TP_RANKS} sync scan float32 "
               f"{TP_LM_CUT_LAYERS}L", TP_RANKS, one_cut, one_cut(),
               cut_cfg, edge_mode="scan", rtol=LM_FORWARD_RTOL)
        return
    unbound = {"sync": one_shot(sync)}
    unbound["K=1"] = one_shot(k1)
    tp_run("model mesh TP=1 sync", 1, lambda mesh: one_shot(sync, mesh),
           unbound["sync"])
    once = tp_run("model mesh TP=1 K=1", 1, lambda mesh: one_shot(k1, mesh),
                  unbound["K=1"])
    pushed = tp_run("model mesh TP=1 engine K=1", 1, engine, None)
    same_run("model mesh TP=1 engine K=1", pushed, once)
    print("    engine over the mesh == one-shot serve(mesh=) K=1 bit for "
          "bit")
    tp_run(f"model mesh TP={TP_RANKS} sync", TP_RANKS,
           lambda mesh: one_shot(sync, mesh), unbound["sync"])
    tp_run(f"model mesh TP={TP_RANKS} K=1", TP_RANKS,
           lambda mesh: one_shot(k1, mesh), unbound["K=1"])
    # float32 on the stream's first TP_F32_SAMPLES samples
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32 = ParamTree(_tree_to(params, dev, torch.float32))
    data = {k: v[:TP_F32_SAMPLES] for k, v in data.items()}
    tp_run(f"model mesh TP={TP_RANKS} sync float32", TP_RANKS,
           lambda mesh: one_shot(sync, mesh, f32, f32_cfg),
           one_shot(sync, tree=f32, c=f32_cfg), f32_cfg)
    del f32


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
    torch.cuda.empty_cache()             # the CPU readings need no card
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


# the float64 witness's subprocess: this file imported from its directory
WITNESS_CHILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.witness_child()
'''


def weights_digest(torch, params) -> int:
    """The sum of every parameter's bytes: the same weights give the
    same number on any device."""
    return sum(int(p.detach().contiguous().view(torch.uint8).sum(
        dtype=torch.int64)) for p in params.parameters())


def witness_child():
    """`Witness`'s subprocess: rwkv6-3b's weights from the serve phase's
    seed on the card (their digest printed), moved to the CPU, then
    `lm_depth_witness` at all its layers on the serve phase's tokens, the
    CPU readings over WITNESS_THREADS threads."""
    import torch
    from repro_torch.data import make_dataset
    torch.set_num_threads(WITNESS_THREADS)
    dev = torch.device("cuda", 0)
    cfg = model_config(LM)
    params = init_full(torch, dev, cfg, 0)
    print(f"DIGEST {weights_digest(torch, params)}", flush=True)
    params = _tree_to(params, "cpu")
    torch.cuda.empty_cache()
    lm_depth_witness(torch, dev, params, cfg,
                     make_dataset("imdb_like", SERVE_SAMPLES, seed=1),
                     cfg.num_layers)


class Witness:
    """rwkv6-3b at all its layers against a float64 CPU reading
    (`lm_depth_witness`), in a subprocess (`witness_child`) started here,
    beside the card phases that follow, and awaited by `wait`. Its weights
    are the serve phase's: their digest must equal ``params``'. Killed at
    exit if still running."""

    def __init__(self, torch, params, cfg):
        import atexit
        import tempfile
        self.digest = weights_digest(torch, params)
        self.out, self.err = tempfile.TemporaryFile("w+"), \
            tempfile.TemporaryFile("w+")
        env = dict(os.environ, PYTHONPATH=str(SRC),
                   OMP_NUM_THREADS=str(WITNESS_THREADS))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", WITNESS_CHILD, str(ROOT)], cwd=ROOT,
            env=env, stdout=self.out, stderr=self.err)
        atexit.register(self.kill)
        print(f"  {LM} {cfg.num_layers}-layer float64 witness started in a "
              f"subprocess ({WITNESS_THREADS} threads), beside the phases "
              f"that follow", flush=True)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def wait(self):
        """Waits for the subprocess (WITNESS_TIMEOUT_S from its start) and
        prints its lines; fails on a non-zero exit or other weights."""
        try:
            self.proc.wait(timeout=max(1.0, self.t0 + WITNESS_TIMEOUT_S
                                       - time.perf_counter()))
        except subprocess.TimeoutExpired:
            self.kill()
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        if self.proc.returncode != 0:
            fail(f"{LM} float64 witness: exit {self.proc.returncode} "
                 f"({time.perf_counter() - self.t0:.1f} s after its start)"
                 f"\n{out[-3000:]}\n{err[-4000:]}")
        digest = re.search(r"^DIGEST (\d+)$", out, re.M)
        if digest is None or int(digest.group(1)) != self.digest:
            fail(f"{LM} float64 witness: other weights than the serve "
                 f"phase's ({digest and digest.group(1)} vs {self.digest})")
        for line in out.splitlines():
            if not line.startswith("DIGEST "):
                print(line)
        print(f"  the witness's weights are the serve phase's (byte sum "
              f"{self.digest}); done {time.perf_counter() - self.t0:.1f} s "
              f"after its start")


def lm_agreement_phase(torch, dev, params, cfg, data, layers: int = 8,
                       inputs=None):
    """An LM at full width (rwkv6-3b, zamba2-1.2b, phi3.5-moe, qwen2-vl),
    cut to its first ``layers`` layers of the serve phase's weights (over
    8 samples of ``data``, or the batch ``inputs``: a stub's embeds), in
    float32:
    `forward_exits` and `forward_exits_masked` (depths spread over
    0..layers-1) on the card (the layer and exit kernels) against the CPU
    (plain versions), an MoE's routing held by `compare_routes`; then the
    served decisions of the small float32 model of the arch (for a token
    batch)."""
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


def decode_child(arch: str, seed: str, agree_layers: str, out: str):
    """One decode phase in a subprocess (`decode_phases`): `decode_phase`
    of ``arch`` on the card, then its runs' launch counts written to
    ``out`` (JSON) for the parent's kernels line."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(DECODE_THREADS)
    runs = Runs()
    decode_phase(torch, torch.device("cuda", 0), runs, arch, int(seed),
                 agree_layers=int(agree_layers))
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps({"counts": runs.counts,
                                     "variants": runs.variants,
                                     "tiles": runs.tiles}))


def decode_phases(torch, runs: Runs, seed: int):
    """The decode phases of DECODE_ARCHS, each in a subprocess
    (`decode_child`), all started at once and awaited: each one's output
    is printed under its own heading with its wall, and its runs' launch
    counts join ``runs``. Fails on any non-zero exit."""
    import tempfile
    out_dir = ROOT / "build" / "decode"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC),
               OMP_NUM_THREADS=str(DECODE_THREADS))
    procs = []
    t0 = time.perf_counter()
    for arch, agree_layers in DECODE_ARCHS:
        log = tempfile.TemporaryFile("w+")
        counts = out_dir / f"{arch}.json"
        counts.unlink(missing_ok=True)
        procs.append((arch, log, counts, subprocess.Popen(
            [sys.executable, "-c", DECODE_CHILD, str(ROOT), arch,
             str(seed), str(agree_layers), str(counts)], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT)))
    walls = {}
    while len(walls) < len(procs):
        for arch, _, _, proc in procs:
            if arch not in walls and (proc.poll() is not None or
                                      time.perf_counter() - t0 >
                                      DECODE_TIMEOUT_S):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                walls[arch] = time.perf_counter() - t0
        time.sleep(0.2)
    failed = [arch for arch, _, _, proc in procs if proc.returncode != 0]
    for arch, log, counts, proc in procs:
        log.seek(0)
        print(f"== decode: {arch} (full width) on the card, in a subprocess "
              f"beside the other decode phases (its times were taken under "
              f"that overlap)")
        print(log.read().rstrip())
        print(f"  [decode {arch}: exit {proc.returncode}, ended "
              f"{walls[arch]:.1f} s after the three started]")
        if proc.returncode == 0:
            got = json.loads(counts.read_text())
            for key in ("counts", "variants", "tiles"):
                getattr(runs, key).update(got[key])
    if failed:
        fail(f"decode phases failed: {failed}")


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
                       layers=MOE_AGREE_LAYERS)
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
                       inputs={"embeds": embeds[0][:8]})
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
    forward, which saves each row's log-sum-exp, and the backward kernel)
    against autograd through the plain version, dq, dk and dv at
    ATTN_GRAD_RTOL (max |err| over max |plain|, per tensor); each forward
    one launch through its variant, each backward one launch of the
    backward kernel through `attention_backward_variant`'s variant and
    `attention_backward_tile`'s tile (both tiles at least once). Cases: the
    training shapes, causal GQA at d 64 and 128, a sliding window (d 64,
    and 128 in bf16 and f32), rows
    without keys (Sq > Skv, causal), d = 32 f32 and bf16 rows off 16 bytes
    (`cuda_core`). The plain version's autograd runs over slices of
    ATTN_GRAD_PLAIN_ROWS samples where its own (Sq, Skv) temporaries need
    it. The forward's lse is held against `attention_lse_ref`
    (ATTN_LSE_TOL), two backward launches must be bitwise equal, and the
    backward's peak memory beyond its inputs must stay within
    `backward_peak_bound`.

    Returns the forward's record at ElasticBERT's training shape (kernel,
    plain, SDPA, bound, the backward kernel's ms), {"at_train_<family>":
    record} of the forward at each family's training shape
    (TRAIN_ATTENTION) with the backward kernel's and SDPA's forward +
    backward ms, and the backward kernel's record at seamless's encoder
    (kernel, plain `attention_backward`, SDPA's forward + backward,
    bound) with an ``at_train_<family>`` entry for every other training
    shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        attention_backward_tile, attention_backward_variant,
        flash_attention_backward_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import (attention_backward,
                                                         attention_lse_ref,
                                                         attention_mask,
                                                         gqa_ref)
    from repro_torch.kernels._build import rows_aligned

    gen = torch.Generator(device=dev).manual_seed(21)
    tc, cc = "tensor_core", "cuda_core"
    cases = [
        # name, variant, b, hq, hkv, sq, skv, d, causal, window, dtype,
        # rows one element off 16 bytes
        ("train_f32", cc, TRAIN_BATCH, 12, 12, 64, 64, 64, False, 0,
         "float32", False),
        ("bf16", tc, 32, 12, 12, 64, 64, 64, False, 0, "bfloat16", False),
        ("gqa_causal_f32", cc, 2, 8, 2, 130, 130, 64, True, 0, "float32",
         False),
        ("gqa_causal_d128_bf16", tc, 2, 8, 2, 130, 130, 128, True, 0,
         "bfloat16", False),
        ("window_bf16", tc, 2, 8, 4, 300, 300, 64, True, 48, "bfloat16",
         False),
        ("window_d128_f32", cc, 1, 4, 2, 200, 200, 128, True, 70, "float32",
         False),
        ("window_d128_bf16", tc, 2, 4, 2, 300, 300, 128, True, 48,
         "bfloat16", False),
        ("no_key_rows_bf16", tc, 2, 8, 2, 150, 40, 128, True, 0, "bfloat16",
         False),
        ("no_key_rows_f32", cc, 2, 4, 4, 100, 33, 64, True, 0, "float32",
         False),
        ("d32_f32", cc, 4, 4, 4, 64, 64, 32, False, 0, "float32", False),
        ("suffix_d32_f32", cc, 2, 4, 2, 20, 90, 32, True, 0, "float32",
         False),
        ("unaligned_bf16", cc, 2, 6, 3, 70, 70, 64, True, 0, "bfloat16",
         True),
    ] + [(key, tc, *shape, 0, "bfloat16", False)
         for key, shape in TRAIN_ATTENTION.items()]
    saved = {}
    tiles_seen = set()
    for name, variant, b, hq, hkv, sq, skv, d, causal, window, dt, off \
            in cases:
        dtype = getattr(torch, dt)
        tile = attention_backward_tile(dtype, d, not off, sq, skv)
        tiles_seen.add(tile)

        def mk(h, s):
            x = torch.randn((b, h, s, d), generator=gen, device=dev
                            ).to(dtype)
            if off:
                buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
                x = buf[1:].view(x.shape).copy_(x)
            return x
        q, k, v = mk(hq, sq), mk(hkv, skv), mk(hkv, skv)
        dout = mk(hq, sq)
        kw = dict(causal=causal, window=window)
        # a clone is aligned: the unaligned case keeps its rows
        leaves = [(t.detach() if off else t.clone()).requires_grad_(True)
                  for t in (q, k, v)]
        out = via("flash_attention", variant,
                  lambda: attention(*leaves, **kw))
        if out.grad_fn is None:
            fail(f"attention[{name}]: no autograd graph through the kernel")
        got = via("flash_attention_backward", variant,
                  lambda: torch.autograd.grad(out, leaves, dout), tile)
        del leaves
        want_out, want = plain_attention_grads(
            torch, q, k, v, dout, causal, window,
            ATTN_GRAD_PLAIN_ROWS.get(name))
        torch.cuda.synchronize()
        check_close(f"attention[{name}] forward", out.detach(), want_out, dt)
        errs = []
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            rel = ((g.float() - w.float()).abs().max()
                   / w.float().abs().max()).item()
            if not (rel <= ATTN_GRAD_RTOL[dt] and torch.isfinite(g).all()
                    and g.dtype == w.dtype and g.shape == w.shape):
                fail(f"attention[{name}] {what}: the backward kernel vs "
                     f"autograd of the plain version, max relative err "
                     f"{rel:.3e} > {ATTN_GRAD_RTOL[dt]} ({g.dtype} "
                     f"{tuple(g.shape)}, want {w.dtype} {tuple(w.shape)})")
            errs.append(rel)
        if sq > skv and causal and bool(got[0][:, :, :sq - skv].any()):
            fail(f"attention[{name}]: a row without keys got a gradient")
        lse_err = ""
        if b * hq * sq * skv <= 1 << 26:   # the plain lse's f32 logits
            _, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            want_lse = attention_lse_ref(q, k, **kw)
            inf = torch.isinf(want_lse)
            if not (torch.equal(inf, torch.isinf(lse))
                    and (lse[inf] > 0).all() and torch.allclose(
                        lse[~inf], want_lse[~inf], rtol=ATTN_LSE_TOL,
                        atol=ATTN_LSE_TOL)):
                fail(f"attention[{name}]: the forward's lse vs "
                     f"attention_lse_ref: max |err| "
                     f"{(lse[~inf] - want_lse[~inf]).abs().max():.3e}, "
                     f"+inf rows {int(torch.isinf(lse).sum())} vs "
                     f"{int(inf.sum())}")
            lse_err = (f"; lse max |err| "
                       f"{(lse[~inf] - want_lse[~inf]).abs().max():.3e} (tol "
                       f"{ATTN_LSE_TOL}), {int(inf.sum())} rows +inf")
        print(f"  attention gradient [{name}] ({variant}"
              f"{f' {tile}' if tile else ''}, ({b},{hq}/{hkv},"
              f"{sq}{'' if sq == skv else f'x{skv}'},{d}) {dt}"
              f"{', causal' if causal else ''}"
              f"{f', window {window}' if window else ''}"
              f"{', rows off 16 B' if off else ''}): dq/dk/dv max relative "
              f"err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
              f"{ATTN_GRAD_RTOL[dt]}){lse_err}")
        saved[name] = (q, k, v, dout, out.detach(), max(errs), got)
        del want, want_out, out
    if not {"mma_sync", "wgmma"} <= tiles_seen:
        fail(f"attention gradient: the cases picked the backward tiles "
             f"{tiles_seen}, want both mma_sync and wgmma")

    # bitwise repeats, on the lse and output the forward saves
    for name in ("bf16", "gqa_causal_f32", "window_bf16", "no_key_rows_bf16",
                 "unaligned_bf16", "at_train_seamless_encoder",
                 "at_train_seamless_cross"):
        q, k, v, dout, out, _, got = saved[name]
        shape = next(c for c in cases if c[0] == name)
        kw = dict(causal=shape[8], window=shape[9])
        _, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        runs = [flash_attention_backward_cuda(
            q, k, v, out, lse, dout, scale=q.shape[-1] ** -0.5, **kw)
            for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"flash_attention_backward[{name}]: two launches differ")
        if not all(torch.equal(a, b) for a, b in zip(runs[0], got)):
            fail(f"flash_attention_backward[{name}]: a launch differs from "
                 f"the one autograd made")
    print("  flash_attention_backward: two launches bitwise equal (and "
          "equal to autograd's) at bf16, gqa_causal_f32, window_bf16, "
          "no_key_rows_bf16, unaligned_bf16, at_train_seamless_encoder, "
          "at_train_seamless_cross")

    def backward_record(key, q, k, v, dout, out, causal, err, few):
        """The backward kernel at one shape: kernel, plain
        `attention_backward` (with the saved lse), SDPA's forward +
        backward, the bound; the peak memory beyond its inputs held
        within `backward_peak_bound`."""
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        gqa = hq != hkv
        dt = str(q.dtype).split(".")[1]
        kw = dict(causal=causal, window=0, scale=d ** -0.5)
        _, lse = flash_attention_cuda(q, k, v, causal=causal,
                                      return_lse=True)
        aligned = rows_aligned(q, k, v, out, dout)
        variant = attention_backward_variant(q.dtype, d, aligned)
        tile = attention_backward_tile(q.dtype, d, aligned, sq, skv)
        lib = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        es = q.element_size()
        # bytes: q, o, dO and dq (Hq heads), k, v, dk and dv (Hkv heads),
        # lse and delta; operations: the five products over the visible
        # (query, key) pairs
        pairs = int(attention_mask(sq, skv, causal, 0, "cpu").sum())
        kind = "causal" if causal else "bidirectional" if sq == skv \
            else "cross-attention"
        r = record(
            "flash_attention_backward",
            "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention_backward.cu",
            "src/repro/kernels/flash_attention/kernel.py:80",
            f"q ({b},{hq},{sq},{d}), k/v ({b},{hkv},{skv},{d}) {dt}, "
            f"{kind}{' GQA' if gqa else ''} (training)", err,
            lambda: via("flash_attention_backward", variant,
                        lambda: flash_attention_backward_cuda(
                            q, k, v, out, lse, dout, **kw), tile),
            lambda: attention_backward(q, k, v, out, dout, lse=lse, **kw),
            lambda: torch.autograd.grad(F.scaled_dot_product_attention(
                *lib, is_causal=causal, enable_gqa=gqa), lib, dout),
            4 * (q.numel() + k.numel()) * es + 2 * b * hq * sq * 4,
            10.0 * b * hq * pairs * d, dt, variant, **few)
        r["tile"] = tile
        r["gradient_of"] = "flash_attention_pallas (the reference " \
            "differentiates its plain attention with XLA; no backward kernel)"
        del lib
        # the bytes the call asks of the allocator (its requested bytes:
        # a block the allocator grants whole, cached segment and all, is
        # not the kernel's)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        key_now = "requested_bytes.all.current"
        before = torch.cuda.memory_stats(dev)[key_now]
        torch.cuda.reset_peak_memory_stats(dev)
        grads = flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        extra = torch.cuda.memory_stats(dev)["requested_bytes.all.peak"] \
            - before
        bound = backward_peak_bound(q, k, tile)
        r["peak_bytes"] = extra
        print(f"  flash_attention_backward at {key} ({variant}"
              f"{f' {tile}' if tile else ''}): peak "
              f"{extra / 1e6:.3f} MB requested beyond its inputs; bound "
              f"{bound / 1e6:.3f} MB (dq, dk, dv, delta, the dQ key splits' "
              f"partials and 1 MiB)")
        if extra > bound:
            fail(f"flash_attention_backward at {key}: {extra} bytes beyond "
                 f"its inputs > {bound}")
        del grads
        return r

    q, k, v, dout, out, err, _ = saved.pop("train_f32")
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
    bwd = {"at_train_elasticbert": join_forward(backward_record(
        "at_train_elasticbert", q, k, v, dout, out, False, err, {}), rec)}

    family = {}
    for key, (b, hq, hkv, sq, skv, d, causal) in TRAIN_ATTENTION.items():
        q, k, v, dout, out, err, _ = saved.pop(key)
        gqa = hq != hkv
        few = {"calls": 2, "replays": 2} if sq * skv > 1 << 20 else {}
        kind = "causal" if causal else "bidirectional" if sq == skv \
            else "cross-attention"
        # bytes: q and the output (Hq heads), k and v (Hkv heads);
        # operations: the two products (their causal half)
        r = record(
            "flash_attention",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:80",
            f"q ({b},{hq},{sq},{d}), k/v ({b},{hkv},{skv},{d}) bfloat16, "
            f"{kind}{' GQA' if gqa else ''} (training)", err,
            lambda: via("flash_attention", "tensor_core",
                        lambda: attention(q, k, v, causal=causal)),
            lambda: gqa_ref(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=gqa),
            2 * (q.numel() + k.numel()) * q.element_size(),
            (2.0 if causal else 4.0) * b * hq * sq * skv * d, "bfloat16",
            variant="tensor_core", **few)
        rb = join_forward(
            backward_record(key, q, k, v, dout, out, causal, err, few), r)
        print(f"  flash_attention_backward at {key}: kernel {rb['ms']:.5f} "
              f"ms, plain attention_backward {rb['plain_ms']:.5f}, bound "
              f"{rb['bound_ms']:.6f} ({rb['bound_by']}); SDPA forward + "
              f"backward {rb['library_ms']:.5f} (the backward alone "
              f"{rb['library_backward_ms']:.5f}); the forward kernel "
              f"{r['ms']:.5f}")
        family[key] = r
        bwd[key] = rb
    rec_bwd = bwd.pop(MAIN_TRAIN_ATTENTION)
    rec_bwd.update(bwd)
    return rec, family, rec_bwd


def join_forward(rb, r):
    """The backward kernel's record ``rb`` and the forward's ``r`` at one
    shape, each given the other's times: the forward kernel's and SDPA's
    forward ms beside the backward, and SDPA's backward alone (its
    forward + backward less its forward); the backward kernel's ms and
    SDPA's forward + backward beside the forward. Returns ``rb``."""
    rb["forward_ms"] = r["ms"]
    rb["library_forward_ms"] = r["library_ms"]
    rb["library_backward_ms"] = rb["library_ms"] - r["library_ms"]
    r["backward_ms"] = rb["ms"]
    r["library_grad_ms"] = rb["library_ms"]
    return rb


def backward_peak_bound(q, k, tile=None) -> int:
    """The bytes the backward kernel may hold beyond its inputs: dq, dk
    and dv in the inputs' dtype, the float32 (B, Hq, Sq) rowsum(dO∘O),
    the float32 dQ partials of ``tile``'s key splits where it has more
    than one (`backward_workspace_bytes`, 0 elsewhere) and 1 MiB of
    slack. Nothing of size (Sq, Skv)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        backward_workspace_bytes
    b, hq, sq, d = q.shape
    grads = (q.numel() + 2 * k.numel()) * q.element_size()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return grads + b * hq * sq * 4 + backward_workspace_bytes(
        b, hq, sq, d, tile, k.shape[2], sms) + (1 << 20)


def plain_attention_grads(torch, q, k, v, dout, causal, window=0, rows=None):
    """(out, (dq, dk, dv)) by autograd of the plain version (`gqa_ref`),
    over slices of ``rows`` samples (default all), whose (Sq, Skv)
    temporaries then stay within what one slice needs. Causal rows with
    no key to attend (the first Sq - Skv when Sq > Skv) get the kernel's
    output 0 and no gradient; the plain version runs on the rest."""
    from repro_torch.kernels.flash_attention.ref import gqa_ref
    b, sq = q.shape[0], q.shape[2]
    nk = max(0, sq - k.shape[2]) if causal else 0
    rows = rows or b
    out = torch.zeros_like(q)
    grads = [torch.zeros_like(t) for t in (q, k, v)]
    for i in range(0, b, rows):
        s = slice(i, i + rows)
        leaves = [t[s].clone().requires_grad_(True)
                  for t in (q[:, :, nk:], k, v)]
        o = gqa_ref(*leaves, causal=causal, window=window)
        for g, w in zip((grads[0][:, :, nk:], *grads[1:]),
                        torch.autograd.grad(o, leaves, dout[s, :, nk:])):
            g[s] = w
        out[s, :, nk:] = o.detach()
    return out, grads


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
                                     tile_launch_counts,
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
    tiles = tile_launch_counts()
    name = f"train elasticbert12 {TRAIN_STEPS} steps"
    runs.counts[name] = counts
    runs.variants[name] = {k: n for k, n in variants.items() if n}
    runs.tiles[name] = {k: n for k, n in tiles.items() if n}
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
    want = train_attention_launches(cfg, remat=False) * TRAIN_STEPS
    hold_attention_launches(name, counts, variants, tiles, want, want,
                            "cuda_core")
    return params, model, {"launches": counts["flash_attention"],
                           "ms_per_step": ms_step,
                           "tokens_per_s": tokens / ms_step * 1e3,
                           "peak_bytes": peak, "wall_s": wall}


def hold_attention_launches(name, counts, variants, tiles, forward: int,
                            backward: int, variant: str):
    """A training run's launches: exactly ``forward`` attention and
    ``backward`` backward-kernel launches, every one through ``variant``
    (``cuda_core``, so no backward launch counted under a tile of
    tensor_core), and no other kernel (the loss reads no exit kernel)."""
    for kernel, n in (("flash_attention", forward),
                      ("flash_attention_backward", backward)):
        if counts[kernel] != n or variants[f"{kernel}/{variant}"] != n:
            fail(f"{name}: {kernel} launches {counts[kernel]} (by variant "
                 f"{ {k: c for k, c in variants.items() if c} }), want {n} "
                 f"through {variant}")
    moved = {k: c for k, c in tiles.items()
             if c and k.startswith("flash_attention_backward/")}
    if variant == "cuda_core" and moved:
        fail(f"{name}: backward launches counted under tiles {moved}, want "
             f"none ({variant})")
    if any(n for k, n in counts.items()
           if k not in ("flash_attention", "flash_attention_backward")):
        fail(f"{name}: launched {counts} (the loss reads no exit kernel)")


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


def decisions_phase(torch, dev, cfg, params, model, label):
    """The paper's pipeline up to the served decisions on one set of
    weights, the card's readings: per-exit accuracy on the validation set,
    calibrate_alpha on the card's confidences, serve() card f32 and card
    bf16 at that alpha. The CPU's readings of the same weights come from
    `CpuDecisions` and are held to these by `decisions_check`. Returns
    the readings (with the cost at alpha, accuracy by exit and the
    majority rate)."""
    import numpy as np
    from repro_torch.core import CostModel, calibrate_alpha
    from repro_torch.data import OnlineStream, make_dataset
    from repro_torch.launch.train import exit_accuracy
    from repro_torch.models.transformer import ParamTree
    from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve

    val = make_dataset("sst2_like", 1024, seed=2)        # as build_testbed
    conf_g, _, corr_g = exit_accuracy(model, params, val)
    acc = corr_g.mean(0)
    majority = max(np.mean(val["labels"] == c) for c in range(cfg.num_classes))
    print(f"  {label}: exit_accuracy, 1024 sst2_like validation samples "
          "(seed 2), card:\n    accuracy by exit " + " ".join(
              f"{a:.4f}" for a in acc)
          + "\n    mean conf by exit " + " ".join(
              f"{c:.4f}" for c in conf_g.mean(0))
          + f"\n    majority-class rate {majority:.4f}")
    base = CostModel(num_layers=cfg.num_layers)
    alpha_g = calibrate_alpha(conf_g, base, corr_g)
    print(f"  {label}: calibrate_alpha (offload {base.offload}, labels): "
          f"card conf {alpha_g!r}")
    cost = dataclasses.replace(base, alpha=alpha_g)

    data = make_dataset("imdb_like", SERVE_SAMPLES, seed=1)
    config = ServingConfig(batch_size=SERVE_BATCH, record_trace=True)
    p_bf16 = ParamTree(_tree_to(params, dev, torch.bfloat16))
    cfg_bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    reps = {}
    for name, c, p in (("card f32", cfg, params),
                       ("card bf16", cfg_bf16, p_bf16)):
        t1 = time.perf_counter()
        rep = reps[name] = serve(EdgeCloudRuntime(c, device=dev), p,
                                 OnlineStream(data, seed=0), cost, config)
        print(f"  {label}: serve() {name}, B={SERVE_BATCH}: {rep['n']} "
              f"samples, exits {int(np.sum(rep['exited']))}, cost "
              f"{rep['cost_total']:.3f}, arms "
              f"{arm_histogram(rep['arms'], cfg.num_layers)} "
              f"[{time.perf_counter() - t1:.1f} s wall]")
    del p_bf16
    return {"label": label, "conf": conf_g, "correct": corr_g, "acc": acc,
            "majority": majority, "base": base, "cost": cost,
            "reps": reps}


def decisions_check(cfg, card, cpu, *, min_near: int = 0):
    """`decisions_phase`'s card readings against the CPU's of the same
    weights (`CpuDecisions`): per-exit confidences within FULL_FORWARD_ATOL,
    calibrate_alpha card == CPU, serve() card f32 vs CPU f32 and card bf16
    vs card f32. Card f32 and CPU f32 serve the same confidences to
    FULL_FORWARD_ATOL up to their first differing decision, and that one
    may only be an exit flipped at an unchanged arm by a confidence within
    FULL_FORWARD_ATOL of alpha. At least ``min_near`` served confidences
    must lie within 1 % of alpha, so that a wrong exit path would move
    decisions."""
    import numpy as np
    from repro_torch.core import calibrate_alpha
    label, cost = card["label"], card["cost"]
    err = float(np.abs(card["conf"] - cpu["conf"]).max())
    print(f"  {label}: exit_accuracy card vs CPU conf max|err| {err:.3e} "
          f"(tol {FULL_FORWARD_ATOL}), correct differing "
          f"{int((card['correct'] != cpu['correct']).sum())} [the CPU's "
          f"readings {cpu['walls'][0]:.1f} s in the subprocess]")
    if not err <= FULL_FORWARD_ATOL:
        fail(f"{label}: exit_accuracy conf card vs CPU max|err| {err:.3e} > "
             f"{FULL_FORWARD_ATOL}")
    alpha_c = calibrate_alpha(cpu["conf"], card["base"], cpu["correct"])
    print(f"  {label}: calibrate_alpha: card conf {cost.alpha!r}, CPU conf "
          f"{alpha_c!r}")
    if cost.alpha != alpha_c:
        fail(f"{label}: calibrate_alpha differs card {cost.alpha} vs CPU "
             f"{alpha_c}")
    reps = dict(card["reps"])
    reps["CPU f32"] = {
        "n": int(len(cpu["arms"])), "arms": cpu["arms"],
        "exited": cpu["exited"], "preds": cpu["preds"],
        "trace": {"conf_path": [[c] for c in cpu["served"]]}}
    print(f"  {label}: serve() CPU f32, B={SERVE_BATCH}: {reps['CPU f32']['n']}"
          f" samples, exits {int(np.sum(cpu['exited']))}, cost "
          f"{float(cpu['cost_total']):.3f}, arms "
          f"{arm_histogram(cpu['arms'], cfg.num_layers)} [{cpu['walls'][1]:.1f}"
          f" s in the subprocess]")
    conf_f, conf_c = served_confidences(reps["card f32"]), cpu["served"]
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


DECISIONS_DIR = ROOT / "build" / "decisions"
DECISIONS_THREADS = 2
DECISIONS_TIMEOUT_S = 900
DECISIONS_CHILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.decisions_child(sys.argv[2])
'''


def decisions_child(spec_path):
    """`CpuDecisions`'s subprocess: for each job of the spec (weights file,
    the card's alpha), `decisions_phase`'s CPU readings, on
    DECISIONS_THREADS threads: exit_accuracy on the validation set and
    serve() CPU f32 at that alpha, written as .npz."""
    import numpy as np
    import torch
    from repro_torch.core import CostModel
    from repro_torch.data import OnlineStream, make_dataset
    from repro_torch.launch.train import exit_accuracy
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import ParamTree
    from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve
    torch.set_num_threads(DECISIONS_THREADS)
    cfg = train_config()
    model = build_model(cfg)
    val = make_dataset("sst2_like", 1024, seed=2)
    data = make_dataset("imdb_like", SERVE_SAMPLES, seed=1)
    for job in json.loads(Path(spec_path).read_text()):
        params = ParamTree(torch.load(job["weights"]))
        t0 = time.perf_counter()
        conf, _, correct = exit_accuracy(model, params, val)
        t1 = time.perf_counter()
        cost = dataclasses.replace(CostModel(num_layers=cfg.num_layers),
                                   alpha=job["alpha"])
        rep = serve(EdgeCloudRuntime(cfg, device="cpu"), params,
                    OnlineStream(data, seed=0), cost,
                    ServingConfig(batch_size=SERVE_BATCH, record_trace=True))
        np.savez(job["out"], conf=conf, correct=correct, arms=rep["arms"],
                 exited=rep["exited"], preds=rep["preds"],
                 served=served_confidences(rep), cost_total=rep["cost_total"],
                 walls=[t1 - t0, time.perf_counter() - t1])
        print(f"DONE {job['label']}", flush=True)


class CpuDecisions:
    """`decisions_phase`'s CPU readings of each weight set in a subprocess
    (`decisions_child`), started here beside the card phases that follow:
    the weights are saved under DECISIONS_DIR and read back on the CPU.
    `results` waits for it (DECISIONS_TIMEOUT_S from its start); killed at
    exit if still running."""

    def __init__(self, torch, jobs):
        """``jobs``: (label, parameters, the card's alpha) per weight set."""
        import atexit
        import tempfile
        DECISIONS_DIR.mkdir(parents=True, exist_ok=True)
        self.spec = []
        for i, (label, params, alpha) in enumerate(jobs):
            path = DECISIONS_DIR / f"weights{i}.pt"
            torch.save(_tree_to(params, "cpu"), path)
            self.spec.append({"label": label, "weights": str(path),
                              "alpha": float(alpha),
                              "out": str(DECISIONS_DIR / f"cpu{i}.npz")})
        spec = DECISIONS_DIR / "spec.json"
        spec.write_text(json.dumps(self.spec))
        self.out, self.err = tempfile.TemporaryFile("w+"), \
            tempfile.TemporaryFile("w+")
        env = dict(os.environ, PYTHONPATH=str(SRC),
                   OMP_NUM_THREADS=str(DECISIONS_THREADS))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", DECISIONS_CHILD, str(ROOT), str(spec)],
            cwd=ROOT, env=env, stdout=self.out, stderr=self.err)
        atexit.register(self.kill)
        print(f"  the CPU readings of {[j['label'] for j in self.spec]} "
              f"started in a subprocess ({DECISIONS_THREADS} threads), "
              f"beside the phases that follow", flush=True)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def results(self):
        """{label: the CPU's readings}; fails on a non-zero exit."""
        import numpy as np
        try:
            self.proc.wait(timeout=max(1.0, self.t0 + DECISIONS_TIMEOUT_S
                                       - time.perf_counter()))
        except subprocess.TimeoutExpired:
            self.kill()
        self.out.seek(0)
        self.err.seek(0)
        if self.proc.returncode != 0:
            fail(f"decisions' CPU readings: exit {self.proc.returncode} "
                 f"({time.perf_counter() - self.t0:.1f} s after its start)"
                 f"\n{self.out.read()[-3000:]}\n{self.err.read()[-4000:]}")
        print(f"  the CPU readings done {time.perf_counter() - self.t0:.1f} s "
              f"after their start")
        return {j["label"]: dict(np.load(j["out"])) for j in self.spec}


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


def train_phase(torch, dev, runs: Runs, rec):
    """Full-width ElasticBERT-12 trained on the card, then the paper's
    pipeline on its weights and the served decisions on an early
    checkpoint of the same recipe. Returns the attention record at the
    training shape (``rec``, `attention_grad_checks`'), with the run's
    launches and timings added, and (params, model, cost with the
    calibrated alpha) of the trained weights."""
    from repro_torch.data import make_dataset
    from repro_torch.launch.train import train_classifier

    cfg = train_config()
    data = make_dataset("sst2_like", TRAIN_SAMPLES, seed=0)
    params, model, stats = training_run(torch, dev, runs, cfg, data)
    train_agreement(torch, dev, cfg, data)
    t0 = time.perf_counter()
    label = f"trained ({TRAIN_STEPS} steps)"
    trained = decisions_phase(torch, dev, cfg, params, model, label)
    acc, majority = trained["acc"], trained["majority"]
    if not acc[-1] > majority:
        fail(f"{label}: last exit accuracy {acc[-1]:.4f} does not beat the "
             f"majority rate {majority:.4f}")
    # the first EARLY_STEPS steps of the same recipe (the schedule is still
    # in its warmup, so they are the 200-step run's): weights that are not
    # saturated, where served confidences lie near alpha
    early, _, log = train_classifier(cfg, data, steps=EARLY_STEPS,
                                     batch_size=TRAIN_BATCH, lr=3e-4,
                                     remat=False, device=dev)
    print(f"  early checkpoint: {EARLY_STEPS} steps, losses " + ", ".join(
        f"step {row['step']} {row['loss']:.6f}" for row in log))
    early_card = decisions_phase(torch, dev, cfg, early, model,
                                 f"early ({EARLY_STEPS} steps)")
    # the CPU's readings of both weight sets, beside the phases that follow
    cpu = CpuDecisions(torch, [
        (label, params, trained["cost"].alpha),
        (early_card["label"], early, early_card["cost"].alpha)])
    del early
    cost = trained["cost"]
    bandit_phase(cfg, params, model, cost)
    print(f"  [pipeline on the trained and early weights, the card's part: "
          f"{time.perf_counter() - t0:.1f} s wall]")
    stats["step_busy_ms"], stats["step_wall_ms"] = training_profile(
        torch, dev, cfg, data, params)
    rec.update(stats)
    print(f"  flash_attention at {rec['shape']} (cuda_core): device ms per "
          f"call (CUDA graph): kernel {rec['ms']:.5f}, plain "
          f"{rec['plain_ms']:.5f}, SDPA {rec['library_ms']:.5f}, bound "
          f"{rec['bound_ms']:.6f} ({rec['bound_by']}); the backward kernel "
          f"{rec['backward_ms']:.5f}; {rec['launches']} launches in the "
          f"training run")
    checks = [(trained, 0), (early_card, MIN_NEAR_ALPHA)]
    return rec, (params, model, cost), (cfg, cpu, checks)


def decisions_wait(pending):
    """The CPU's readings of the trained and early weights (`CpuDecisions`,
    started in the training phase), held to the card's by
    `decisions_check`."""
    cfg, cpu, checks = pending
    results = cpu.results()
    for card, min_near in checks:
        decisions_check(cfg, card, results[card["label"]],
                        min_near=min_near)


# ---------------------------------------------- training the LM families

# full-width LMs trained on the card through `make_train_step` with remat
# (the reference's default), bf16, LM_TRAIN_STEPS steps on one repeated
# batch, AdamW at LM_TRAIN_LR from the first step (no warmup), each on an
# otherwise empty card. rwkv6-3b (`lm_train_phase`): LM_TRAIN_BATCH
# sequences x 64 tokens of the synthetic stream (next-token loss, labels
# the tokens) at LM_TRAIN_LAYERS of its 32 layers, the deepest that fits
# the card's 80 GB: its bf16 weights, their gradients, the clip's copies
# and AdamW's f32 moments hold 14 bytes a parameter, and the update's f32
# temporaries come on top; tools/wkv6_training_costs.py's depth probe
# finds 31 and 32 layers out of memory in the optimizer step and 30
# fitting
LM_TRAIN_LAYERS = 30
LM_TRAIN_BATCH = 16
LM_TRAIN_STEPS = 5
LM_TRAIN_LR = 3e-4
# the other families (`family_train_phase`), as published: (arch, layers,
# None for all of them, the TRAIN_ATTENTION entry its record joins). The
# LMs train on LM_TRAIN_BATCH x 64 positions (qwen2-vl on seeded embeds,
# labels seeded tokens), seamless on ENCDEC_TRAIN_BATCH x its 4096 frames
# with ENCDEC_TRAIN_TOKENS target tokens: its encoder is not rematted (as
# the reference's); at the serving phase's 8 samples a step peaks at
# 82.557 of the card's 85.017 GB with the ~1.5 GB earlier phases hold
# (attention's backward kernel holds no (Sq, Skv) temporaries; through the
# plain products 8 samples peaked at 81.558 on an empty card).
# phi3.5-moe at FAMILY_MOE_LAYERS of its 32 layers, the deepest whose step
# fits an otherwise empty card (`tools/wkv6_training_costs.py --arch
# phi3.5-moe-42b-a6.6b`: 4 and 3 run out of memory in the optimizer step,
# asking 6.25 / 4.69 GiB)
FAMILY_MOE_LAYERS = 2
FAMILY_TRAIN = (("qwen3-1.7b", None, "at_train_qwen3"),
                (HYBRID, None, "at_train_zamba2"),
                (MOE, FAMILY_MOE_LAYERS, "at_train_phi35"),
                (VLM, None, "at_train_qwen2vl"),
                (ENCDEC, None, "at_train_seamless_encoder"))
ENCDEC_TRAIN_BATCH = 8
ENCDEC_TRAIN_TOKENS = 32
# card vs CPU training (`TrainAgreement`): each arch's published widths
# cut to (arch, layers, enc-dec source frames), float32, LM_AGREE_STEPS
# steps (no remat) of LM_AGREE_BATCH sequences (64 positions; the enc-dec
# model ENCDEC_TRAIN_TOKENS target tokens), from LM_AGREE_SEED; zamba2
# at 6 layers holds a shared-block occurrence, phi3.5-moe at 1 is 1.56 G
# parameters. Both halves run in one subprocess, started before the
# training of the families so that its start-up overlaps it: the card
# halves first (this process waits), then the CPU halves on
# LM_AGREE_THREADS threads, one after another (the largest first) beside
# the phases that follow, each held to its card half as it ends (on the
# CPU: the card is the phases'); the card halves' readings
# wait under LM_AGREE_DIR meanwhile.
# Awaited at the end of the smoke. The CPU halves are AdamW-bound and
# host-memory-bound: phi3.5's f32 weights, gradients, clip copies,
# moments, the update's temporaries and the readings peak near 60 GB.
LM_AGREE_CUTS = ((MOE, 1, None), ("qwen3-1.7b", 2, None), (VLM, 2, None),
                 (ENCDEC, 2, 256), (LM, 2, None), (HYBRID, 6, None))
LM_AGREE_STEPS = 3
LM_AGREE_BATCH = 4
LM_AGREE_SEED = 7
LM_AGREE_THREADS = 3
LM_AGREE_CARD_TIMEOUT_S = 300
LM_AGREE_TIMEOUT_S = 1100
LM_AGREE_DIR = ROOT / "build" / "train_agree"
LM_AGREE_CHILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.train_agree_child()
'''


def lm_train_batches(torch, batch: int, n: int, device):
    """``n`` batches of ``batch`` sequences of the synthetic stream
    (imdb_like, 64 tokens), labels the tokens (next-token targets)."""
    from repro_torch.data import make_dataset
    tokens = make_dataset("imdb_like", batch * n, seed=5)["tokens"]
    return [{"tokens": torch.as_tensor(t, device=device),
             "labels": torch.as_tensor(t, device=device).long()}
            for t in tokens.reshape(n, batch, -1)]


def train_batches(torch, cfg, rows: int, n: int, device, *,
                  tokens: int = ENCDEC_TRAIN_TOKENS):
    """``n`` training batches of ``rows`` sequences for ``cfg``'s family,
    equal on every device: token LMs `lm_train_batches`; the VLM seeded
    embeds (rows, 64, d) with seeded labels; the enc-dec model seeded
    frames (rows, source_len, d) and ``tokens`` seeded target tokens,
    labels the tokens."""
    import numpy as np
    if cfg.family != "vlm" and cfg.encoder is None:
        return lm_train_batches(torch, rows, n, device)
    rng = np.random.default_rng(9)
    out = []
    for _ in range(n):
        seq = 64 if cfg.encoder is None else tokens
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows, seq)),
                                 device=device)
        if cfg.encoder is None:
            x = {"embeds": rng.standard_normal((rows, seq, cfg.d_model),
                                               dtype=np.float32)}
        else:
            e = cfg.encoder
            x = {"frames": rng.standard_normal((rows, e.source_len,
                                                e.d_model), dtype=np.float32),
                 "tokens": labels}
        out.append({"labels": labels, **{k: torch.as_tensor(v, device=device)
                                         for k, v in x.items()}})
    return out


def lm_train_steps(torch, cfg, params, batches, *, remat: bool,
                   grad0=None, masks=None):
    """`make_train_step` over ``batches`` from ``params`` (trainable, in
    place; AdamW at LM_TRAIN_LR, no warmup). Returns (losses, wall s of
    each step, synchronised, and a call of one more step on the same
    optimizer state). Given a dict ``grad0``, fills it with the step-0
    gradients {name: a copy, or None for a leaf the loss never reads}.
    Given a dict ``masks``, fills ``masks["held"]``
    with {name: the elements whose gradient at every step exceeds
    GRAD_FLOOR and TRAIN_GRAD_RTOL of its leaf's largest at that step} and
    ``masks["zero"]`` with {name: the elements whose gradient is 0 at
    every step (all of a leaf the loss never reads)}."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    params.requires_grad_(True)
    state = adamw_init(params)
    step = make_train_step(build_model(cfg), AdamWConfig(lr=LM_TRAIN_LR),
                           total_steps=len(batches), warmup=0, remat=remat)
    losses, walls = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        _, _, info = step(params, state, b)
        losses.append(float(info["loss"]))       # a sync
        walls.append(time.perf_counter() - t0)
        if i == 0 and grad0 is not None:
            grad0.update((n, None if p.grad is None else
                          p.grad.detach().clone())
                         for n, p in params.named_parameters())
        if masks is not None:
            held = masks.setdefault("held", {})
            zero = masks.setdefault("zero", {})
            for n, p in params.named_parameters():
                g = torch.zeros_like(p) if p.grad is None \
                    else p.grad.detach().abs()
                big = g > max(GRAD_FLOOR, TRAIN_GRAD_RTOL * g.max().item())
                held[n] = big if i == 0 else held[n] & big
                zero[n] = (g == 0) if i == 0 else zero[n] & (g == 0)
    return losses, walls, lambda b: step(params, state, b)


def train_card_run(torch, dev, runs: Runs, name, cfg, params, batch, want,
                   before: int):
    """LM_TRAIN_STEPS training steps of ``params`` (on the card) on one
    repeated ``batch``, with remat, counted as run ``name``: the loss
    finite and falling, the launches exactly ``want`` (per kernel; every
    attention launch, forward and backward, through the variant the
    picker names for the bf16 shape; the backward's by tile as
    `train_backward_tiles` says), ms a step after the first,
    positions/s, peak device memory (and its share above ``before``, what
    earlier phases held), then one more step profiled for its busy share
    and top kernels. Returns the training record."""
    import math
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     tile_launch_counts,
                                     variant_launch_counts)
    from repro_torch.kernels.flash_attention.kernel import attention_variant
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    losses, walls, again = lm_train_steps(
        torch, cfg, params, [batch] * LM_TRAIN_STEPS, remat=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = launch_counts(), variant_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    runs.counts[name] = counts
    runs.variants[name] = {k: n for k, n in variants.items() if n}
    runs.tiles[name] = {k: n for k, n in tile_launch_counts().items() if n}
    positions = batch["labels"].numel()
    ms_step = sum(walls[1:]) / len(walls[1:]) * 1e3
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    print(f"  {name}: {cfg.num_layers} layers, {LM_TRAIN_STEPS} steps on one "
          f"batch {shapes}, remat: losses "
          + ", ".join(f"{x:.6f}" for x in losses)
          + f"; step walls (s) " + ", ".join(f"{x:.3f}" for x in walls)
          + f"; {ms_step:.3f} ms a step after the first = "
          f"{positions / ms_step * 1e3:.1f} target positions/s; peak device "
          f"memory {peak / 1e9:.3f} GB (max_memory_allocated) of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.3f}, "
          f"of which {before / 1e9:.3f} GB earlier phases held before the "
          f"model was built: the training's own {(peak - before) / 1e9:.3f} "
          f"GB; {wall:.3f} s wall; launches {counts}, by variant "
          f"{runs.variants[name]}, by tile {runs.tiles[name]}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: loss did not fall ({losses[0]} -> {losses[-1]})")
    if counts != want:
        fail(f"{name}: launches {counts}, want {want}")
    want_tiles = {f"flash_attention_backward/tensor_core/{t}":
                  n * LM_TRAIN_STEPS for t, n in train_backward_tiles(
                      cfg, batch["labels"].shape[1]).items()}
    if runs.tiles[name] != want_tiles:
        fail(f"{name}: backward launches by tile {runs.tiles[name]}, want "
             f"{want_tiles} (train_backward_tiles)")
    picked = attention_variant(torch.bfloat16, cfg.resolved_head_dim,
                               True) if counts["flash_attention"] else None
    for kernel in ("flash_attention", "flash_attention_backward"):
        if counts[kernel] and variants[f"{kernel}/{picked}"] != counts[kernel]:
            fail(f"{name}: {kernel} launches not all through {picked}: "
                 f"{runs.variants[name]}")
    busy, per_kernel = device_ms(lambda: again(batch), iters=1, warmup=0)
    print_busy(f"train step ({name}, {shapes})", busy, ms_step, per_kernel)
    return {"layers": cfg.num_layers, "steps": LM_TRAIN_STEPS,
            "losses": losses, "ms_per_step": ms_step,
            "positions_per_s": positions / ms_step * 1e3, "peak_bytes": peak,
            "own_peak_bytes": peak - before, "busy_ms": busy,
            "launches": counts}


def train_want(cfg, steps: int):
    """Kernel launches of ``steps`` training steps with remat: attention as
    `train_attention_launches` says and its backward kernel as
    `train_backward_launches` says, and for an ssm stack WKV6 2L a step
    (the forward and remat's recompute) and its backward L; no exit."""
    from repro_torch.kernels import launch_counts
    want = {k: 0 for k in launch_counts()}
    want["flash_attention"] = train_attention_launches(cfg, True) * steps
    want["flash_attention_backward"] = train_backward_launches(cfg) * steps
    if cfg.family == "ssm":
        want["wkv6"] = 2 * cfg.num_layers * steps
        want["wkv6_backward"] = cfg.num_layers * steps
    return want


def lm_train_phase(torch, dev, runs: Runs):
    """Full-width rwkv6-3b (bf16, LM_TRAIN_LAYERS layers) trained on the
    card (`train_card_run`): WKV6 2L a step (forward and remat's
    recompute) and its backward kernel L a step, no exit or attention
    launch. Returns the training record."""
    from repro_torch.configs import get_config
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)   # what earlier phases hold
    cfg = dataclasses.replace(get_config(LM), num_layers=LM_TRAIN_LAYERS)
    params = init_full(torch, dev, cfg, seed=28)
    batch = lm_train_batches(torch, LM_TRAIN_BATCH, 1, dev)[0]
    rec = train_card_run(torch, dev, runs, MAIN_PATH["wkv6_backward"], cfg,
                         params, batch, train_want(cfg, LM_TRAIN_STEPS),
                         before)
    del params
    torch.cuda.empty_cache()
    return rec


def family_train_phase(torch, dev, runs: Runs):
    """Each of FAMILY_TRAIN trained on the card at its published widths
    (`train_card_run`): its attention launches exactly
    `train_attention_launches` a step, through the variant its bf16 shape
    picks, and no exit or WKV6 launch. Each model is freed before the
    next. Returns {TRAIN_ATTENTION key: training record}."""
    out = {}
    for arch, layers, key in FAMILY_TRAIN:
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        cfg = model_config(arch, layers)
        params = init_full(torch, dev, cfg, seed=29)
        rows = ENCDEC_TRAIN_BATCH if cfg.encoder is not None \
            else LM_TRAIN_BATCH
        batch = train_batches(torch, cfg, rows, 1, dev)[0]
        out[key] = train_card_run(
            torch, dev, runs, f"train {arch}", cfg, params, batch,
            train_want(cfg, LM_TRAIN_STEPS), before)
        del params, batch
        torch.cuda.empty_cache()
    return out


def agree_cut(arch: str, layers: int, frames: int | None):
    """``arch``'s published widths in float32, cut to ``layers`` layers
    (an enc-dec model: as many encoder layers, ``frames`` source frames)."""
    cfg = dataclasses.replace(model_config(arch, layers), dtype="float32")
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, num_layers=layers, source_len=frames))
    return cfg


def agree_half(torch, dev, cut, device):
    """One half of an arch's training agreement on ``device``: the cut's
    parameters from LM_AGREE_SEED (drawn on the card, so both halves
    start equal), LM_AGREE_STEPS steps without remat on the same batches,
    the MoE routes of every step. Returns its readings: losses, step-0
    gradients and parameters after the steps on the CPU, routes, and on
    the CPU also the `lm_train_steps` masks and each step's wall s."""
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import ParamTree
    params = build_model(cut).init(seed=LM_AGREE_SEED, device=dev)
    if device == "cpu":
        params = ParamTree(_tree_to(params, "cpu"))
        torch.cuda.empty_cache()
    batches = train_batches(torch, cut, LM_AGREE_BATCH, LM_AGREE_STEPS,
                            device)
    grad0, masks = {}, {} if device == "cpu" else None
    with route_records(cut.family == "moe") as routes:
        losses, walls, _ = lm_train_steps(torch, cut, params, batches,
                                          remat=False, grad0=grad0,
                                          masks=masks)
    out = {"losses": losses, "routes": routes,
           "grad0": {n: None if g is None else g.cpu()
                     for n, g in grad0.items()},
           "final": {n: x.detach().cpu() for n, x in
                     params.named_parameters()}}
    if masks is not None:
        out.update(walls=walls, held=masks["held"], zero=masks["zero"])
    return out


def train_agree_child():
    """`TrainAgreement`'s subprocess: once LM_AGREE_DIR/go exists, the
    card half of every cut of LM_AGREE_CUTS (its readings kept, then
    written under LM_AGREE_DIR once "CARD HALVES DONE" is printed), then
    the CPU halves in order, each held to its card half by
    `hold_train_agreement` as it ends."""
    import torch
    t0 = time.perf_counter()

    def stage(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(LM_AGREE_THREADS)
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)                      # the CUDA context
    stage("started")
    while not (LM_AGREE_DIR / "go").exists():
        time.sleep(0.1)
    card = {}
    for arch, layers, frames in LM_AGREE_CUTS:
        card[arch] = agree_half(torch, dev, agree_cut(arch, layers, frames),
                                dev)
        torch.cuda.empty_cache()
        stage(f"card half of {arch} ({layers} layers)")
    print("CARD HALVES DONE", flush=True)
    for arch in card:
        torch.save(card[arch], LM_AGREE_DIR / f"{arch}.pt")
        card[arch] = None
    stage("card readings saved")
    for arch, layers, frames in LM_AGREE_CUTS:
        cut = agree_cut(arch, layers, frames)
        cpu = agree_half(torch, dev, cut, "cpu")
        stage(f"CPU half of {arch}")
        path = LM_AGREE_DIR / f"{arch}.pt"
        hold_train_agreement(cut, torch.load(path, mmap=True), cpu)
        del cpu
        path.unlink()


class TrainAgreement:
    """Card vs CPU training of each of LM_AGREE_CUTS in a subprocess
    (`train_agree_child`), started here; `card_halves` lets it run its
    card halves and waits for them (the card otherwise idle), then its
    CPU halves run beside the phases that follow; `wait` reads its
    verdicts. Killed at exit if still running."""

    def __init__(self):
        import atexit
        import shutil
        import tempfile
        shutil.rmtree(LM_AGREE_DIR, ignore_errors=True)
        LM_AGREE_DIR.mkdir(parents=True)
        self.out, self.err = tempfile.TemporaryFile("w+"), \
            tempfile.TemporaryFile("w+")
        env = dict(os.environ, PYTHONPATH=str(SRC),
                   OMP_NUM_THREADS=str(LM_AGREE_THREADS))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", LM_AGREE_CHILD, str(ROOT)], cwd=ROOT,
            env=env, stdout=self.out, stderr=self.err)
        atexit.register(self.kill)

    def card_halves(self):
        """Lets the subprocess run its card halves and waits until they
        are done (LM_AGREE_CARD_TIMEOUT_S)."""
        t0 = time.perf_counter()
        (LM_AGREE_DIR / "go").touch()
        while "CARD HALVES DONE" not in self._read()[0]:
            if self.proc.poll() is not None or time.perf_counter() - \
                    t0 > LM_AGREE_CARD_TIMEOUT_S:
                self.kill()
                out, err = self._read()
                fail(f"training agreement: the card halves did not end "
                     f"(exit {self.proc.returncode})\n{out[-3000:]}\n"
                     f"{err[-4000:]}")
            time.sleep(0.2)
        print(f"  training agreement (card vs CPU, float32, "
              f"{LM_AGREE_STEPS} steps of {LM_AGREE_BATCH} sequences) of "
              + ", ".join(f"{a} cut to {n} layers"
                          + (f" and {f} frames" if f else "")
                          for a, n, f in LM_AGREE_CUTS)
              + f": the card halves done in a subprocess in "
              f"{time.perf_counter() - t0:.1f} s; its CPU halves "
              f"({LM_AGREE_THREADS} threads) run beside the phases that "
              f"follow", flush=True)

    def _read(self):
        self.out.seek(0)
        self.err.seek(0)
        return self.out.read(), self.err.read()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def wait(self):
        """Waits for the subprocess (LM_AGREE_TIMEOUT_S from its start) and
        prints its lines; fails on a non-zero exit."""
        try:
            self.proc.wait(timeout=max(1.0, self.t0 + LM_AGREE_TIMEOUT_S
                                       - time.perf_counter()))
        except subprocess.TimeoutExpired:
            self.kill()
        out, err = self._read()
        print(out.rstrip())
        if self.proc.returncode != 0:
            fail(f"training agreement: exit {self.proc.returncode} "
                 f"({time.perf_counter() - self.t0:.1f} s after its start)\n"
                 f"{err[-4000:]}")
        print(f"  the CPU halves ended {time.perf_counter() - self.t0:.1f} s "
              f"after the subprocess started")


def adamw_drift_bound(cfg, lr_scales) -> float:
    """The most two AdamW runs from equal parameters can part at one
    element after len(``lr_scales``) steps, whatever their gradients.
    Step t (from 1) moves an element by lr_t (m_hat / (sqrt(v_hat) + eps)
    + wd p), the decay term only shrinks a difference, and by
    Cauchy-Schwarz |m_hat| / sqrt(v_hat) <= (1 - b1) / (1 - b1^t)
    * sqrt((1 - b2^t) / (1 - b2) * sum_{j<t} (b1^2 / b2)^j) (1 at t = 1):
    each step adds at most 2 lr_t times that."""
    import math
    total = 0.0
    for t, scale in enumerate(lr_scales, 1):
        ratio = sum((cfg.b1 ** 2 / cfg.b2) ** j for j in range(t))
        most = (1 - cfg.b1) / (1 - cfg.b1 ** t) * math.sqrt(
            (1 - cfg.b2 ** t) / (1 - cfg.b2) * ratio)
        total += 2 * cfg.lr * float(scale) * most
    return total


def hold_train_agreement(cut, card, cpu):
    """One cut's card half against its CPU half: losses at
    TRAIN_LOSS_RTOL, step-0 gradients at TRAIN_GRAD_RTOL (max |err| over
    max |CPU| per leaf; a leaf the loss never reads has none on either
    side), an MoE's routes as `compare_routes` holds them, and after the
    steps every parameter element, by what its CPU gradients were at
    every step:
    - above GRAD_FLOOR and TRAIN_GRAD_RTOL of its leaf's largest: within
      TRAIN_PARAM_ATOL;
    - 0 (only the weight decay moves it, the same arithmetic on both
      sides): within one float32 rounding a step, LM_AGREE_STEPS * 2^-23
      of its value;
    - the rest: within `adamw_drift_bound` + TRAIN_PARAM_ATOL, the most
      AdamW lets two runs part whatever their gradients.
    (`train_agreement` holds the elements above GRAD_FLOOR at step 0
    only. Here a gradient within the precision the gradients are held to
    at a later step moves AdamW's moments as a step-0 sign flip does:
    after a step the card's and the CPU's gradients part by a small share
    of their leaf's largest, and at a vocabulary-wide head that share is
    above GRAD_FLOOR.)"""
    name = f"{cut.arch_id} cut to {cut.num_layers} layers"
    for i, (a, c) in enumerate(zip(card["losses"], cpu["losses"])):
        print(f"    {name}, step {i}: loss card {a:.7f}, CPU {c:.7f}")
        if abs(a - c) > TRAIN_LOSS_RTOL * abs(c):
            fail(f"{name} training card vs CPU, step {i}: loss {a!r} vs "
                 f"{c!r} (rtol {TRAIN_LOSS_RTOL})")
    if cut.family == "moe":
        compare_routes(f"{name} training, {LM_AGREE_STEPS} steps",
                       card["routes"], cpu["routes"])
    worst, unread = 0.0, []
    for leaf, gc in cpu["grad0"].items():
        ga = card["grad0"][leaf]
        if ga is None or gc is None:
            if (ga is None) != (gc is None):
                fail(f"{name} training: step-0 gradient of {leaf} on one "
                     f"side only")
            unread.append(leaf)
            continue
        scale = gc.abs().max().item()
        if scale:
            rel = (ga - gc).abs().max().item() / scale
        else:               # a zero gradient on the CPU must be zero here
            rel = float("inf") if ga.abs().max().item() else 0.0
        if not rel <= TRAIN_GRAD_RTOL:
            fail(f"{name} training card vs CPU, step-0 gradient of {leaf}: "
                 f"max relative err {rel:.3e} > {TRAIN_GRAD_RTOL}")
        worst = max(worst, rel)
    print(f"    {name}, step-0 gradients of "
          f"{len(cpu['grad0']) - len(unread)} leaves: max relative err "
          f"{worst:.3e} (tol {TRAIN_GRAD_RTOL}); no gradient on either side "
          f"for the {len(unread)} leaves the loss never reads "
          f"({', '.join(unread)})")
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import cosine_schedule
    drift = adamw_drift_bound(AdamWConfig(lr=LM_TRAIN_LR), [
        cosine_schedule(i, LM_AGREE_STEPS, 0) for i in range(LM_AGREE_STEPS)])
    groups = {"held": [0, 0.0], "zero": [0, 0.0], "rest": [0, 0.0]}
    zero_worst = total = 0
    for leaf, c in cpu["final"].items():
        diff = (card["final"][leaf] - c).abs()
        held, zero = cpu["held"][leaf], cpu["zero"][leaf]
        total += diff.numel()
        for group, mask in (("held", held), ("zero", zero),
                            ("rest", ~(held | zero))):
            if mask.any():
                groups[group][0] += int(mask.sum())
                groups[group][1] = max(groups[group][1],
                                       diff[mask].max().item())
        if zero.any():      # in units of 2^-23 of the CPU's value
            zero_worst = max(zero_worst, (diff[zero] / (
                c[zero].abs() * 2.0 ** -23).clamp_min(1e-45)).max().item())
    bounds = {"held": TRAIN_PARAM_ATOL, "rest": drift + TRAIN_PARAM_ATOL}
    for group, bound in bounds.items():
        if not groups[group][1] <= bound:
            fail(f"{name} training card vs CPU: after {LM_AGREE_STEPS} steps "
                 f"a parameter of the '{group}' elements differs by "
                 f"{groups[group][1]:.3e} > {bound:.3e}")
    if not zero_worst <= LM_AGREE_STEPS:
        fail(f"{name} training card vs CPU: a parameter whose gradient was 0 "
             f"at every step differs by {zero_worst:.3g} x 2^-23 of its value "
             f"(more than one rounding a step)")
    print(f"  card vs CPU, {name}, {LM_AGREE_STEPS} steps, parameters after "
          f"the steps ({total} elements): the {groups['held'][0]} whose "
          f"|grad| exceeded {GRAD_FLOOR} and {TRAIN_GRAD_RTOL} of its leaf's "
          f"largest at every step max|err| {groups['held'][1]:.3e} (tol "
          f"{TRAIN_PARAM_ATOL}); the {groups['zero'][0]} whose gradient was 0 "
          f"at every step max|err| {groups['zero'][1]:.3e} = "
          f"{zero_worst:.3g} x 2^-23 of its value (tol {LM_AGREE_STEPS}); the "
          f"other {groups['rest'][0]} max|err| {groups['rest'][1]:.3e} (tol "
          f"{drift + TRAIN_PARAM_ATOL:.3e}: AdamW's most in {LM_AGREE_STEPS} "
          f"steps, {drift:.3e}, + {TRAIN_PARAM_ATOL}); the CPU's steps took "
          + ", ".join(f"{w:.1f}" for w in cpu["walls"]) + " s", flush=True)


# ------------------------------------------------------ model parallelism

MP_STEPS = 3                # train steps of each model-parallel run
MP_TP2 = 2                  # ranks of the threaded run sharing the card
MP_DRYRUN = (("qwen3-1.7b", "train_4k"), ("mixtral-8x22b", "decode_32k"))
MP_DRYRUN_TIMEOUT_S = 300
MP_REFIT_TIMEOUT_S = 120
# the depth fit of a uniform arch vs its full-depth walk: flops and
# collectives are linear in depth and must be equal; bytes accessed
# within a relative MP_FIT_BYTES_RTOL (a train step's too: each stacked
# (L, ...) leaf is read through one unbind, whose backward is one stack)
MP_FIT_BYTES_RTOL = 1e-5
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
def launch_shapes(shapes):
    """Record the q shape of every attention kernel launch under
    ``shapes["flash_attention"]`` and the r shape of every WKV6 launch
    under ``shapes["wkv6"]`` (lists; ranks on threads append to them
    alike)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    patched = ((attn_ops, "flash_attention_cuda", "flash_attention"),
               (wkv6_ops, "wkv6_cuda", "wkv6"))
    origs = []
    for mod, attr, key in patched:
        orig = getattr(mod, attr)
        shapes.setdefault(key, [])

        def recording(x, *a, _orig=orig, _key=key, **k):
            shapes[_key].append(tuple(x.shape))
            return _orig(x, *a, **k)
        setattr(mod, attr, recording)
        origs.append((mod, attr, orig))
    try:
        yield
    finally:
        for mod, attr, orig in origs:
            setattr(mod, attr, orig)


def mp_counted(torch, runs: Runs, name, fn, want_launches, want_shape):
    """``fn()`` as its own counted run: exactly ``want_launches`` attention
    launches, every one through ``cuda_core`` at q shape ``want_shape``
    (the local head shard), and no other kernel. Returns fn's result and
    its wall seconds."""
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     tile_launch_counts,
                                     variant_launch_counts)
    shapes = {}
    MP_STEP_MS.clear()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with launch_shapes(shapes):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = launch_counts(), variant_launch_counts()
    tiles = tile_launch_counts()
    runs.counts[name] = counts
    runs.variants[name] = {k: n for k, n in variants.items() if n}
    runs.tiles[name] = {k: n for k, n in tiles.items() if n}
    hold_attention_launches(name, counts, variants, tiles, want_launches,
                            want_launches, "cuda_core")
    if set(shapes["flash_attention"]) != {want_shape}:
        fail(f"{name}: attention kernel q shapes "
             f"{sorted(set(shapes['flash_attention']))}, want the local head "
             f"shard {want_shape}")
    print(f"  {name}: {wall:.3f} s wall for {MP_STEPS} steps; ms a step "
          f"(first, then later; per rank) {[[round(t, 1) for t in r] for r in MP_STEP_MS]}"
          f"; launches {counts}, by variant {runs.variants[name]}; kernel q "
          f"shape {want_shape}")
    return out


def mp_threaded(torch, dev, cfg, params0, batches, tp: int, seq_parallel):
    """The model-parallel steps on a (1, tp) mesh of ``tp`` ranks sharing
    ``dev`` (`on_threaded_ranks`). Returns rank 0's result."""
    from repro_torch.launch.mesh import make_mesh
    return on_threaded_ranks(torch, tp, lambda rank: mp_steps(
        torch, dev, cfg, params0, batches,
        make_mesh((1, tp), ("data", "model"), device=dev.type),
        seq_parallel))[0]


def on_threaded_ranks(torch, tp: int, fn):
    """``fn(rank)`` on ``tp`` ranks sharing the card, one thread each over
    the threaded process group
    (``torch.testing._internal.distributed.multi_threaded_pg``: its
    collectives are tensor ops of this process, so they take CUDA
    tensors). Returns {rank: result}; a rank's error is raised."""
    import threading
    import torch.distributed as dist
    from torch.testing._internal.distributed.multi_threaded_pg import (
        _install_threaded_pg, _uninstall_threaded_pg)
    results = {}

    def worker(rank, store):
        # the thread's group goes with the threaded world when it is
        # uninstalled (torch 2.11's destroy_process_group cannot take it)
        try:
            dist.init_process_group("threaded", rank=rank, world_size=tp,
                                    store=store)
            results[rank] = fn(rank)
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
    return results


def hold_depth_fit(label: str, rec: dict) -> None:
    """Print a dry-run record's depth fit (its points, and
    ``extrapolated`` against the full-depth walk's top-level terms) and
    fail unless the fit's flops and every collective equal the walk's and
    its bytes accessed lie within MP_FIT_BYTES_RTOL."""
    fit, pts = rec["extrapolated"], rec["extrapolated"]["fit_points"]
    rel = (fit["bytes_accessed"] - rec["bytes_accessed"]) / \
        rec["bytes_accessed"]
    print(f"  {label}: fit points L = {pts['l1']}, {pts['l2']} (flops "
          f"{pts['flops']}, bytes {pts['bytes']}, collective bytes "
          f"{pts['coll_bytes']}); fit / walk: flops {fit['flops']:.6e} / "
          f"{rec['flops']:.6e}, bytes accessed {fit['bytes_accessed']:.6e} "
          f"/ {rec['bytes_accessed']:.6e} (relative {rel:+.3e}), "
          f"collectives " + ", ".join(
              f"{k} {v['count']} / {rec['collectives'][k]['count']} "
              f"({v['bytes']} / {rec['collectives'][k]['bytes']} B)"
              for k, v in fit["collectives"].items()
              if isinstance(v, dict) and (v["count"] or v["bytes"])))
    if fit["flops"] != rec["flops"] or \
            fit["collectives"] != rec["collectives"] or \
            not abs(rel) <= MP_FIT_BYTES_RTOL:
        fail(f"{label}: the depth fit differs from the full-depth walk")


class DryRuns:
    """`python -m repro_torch.launch.dryrun` for MP_DRYRUN on the fake
    (16, 16) mesh, each in a subprocess, the two started here at once on
    the host's cores beside the card phases that follow; `refit` awaits
    them and starts one ``--refit`` over their records; `hold` awaits it,
    prints each record's per-device argument and temp GB, flops and
    collective counts, and holds its depth fit and its refit
    (`hold_depth_fit`). Every subprocess is killed at exit."""

    def __init__(self):
        import atexit
        self.env = dict(os.environ, PYTHONPATH=str(SRC))
        self.out_dir = ROOT / "chiprun_out" / "dryrun"
        self.t0 = time.perf_counter()
        self.procs = [self._start("--arch", arch, "--shape", shape)
                      for arch, shape in MP_DRYRUN]
        self.refit_proc = None
        atexit.register(self.kill)

    def _start(self, *args):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(self.out_dir)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=self.env, cwd=ROOT)

    def kill(self):
        for p in self.procs + [self.refit_proc]:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    def refit(self):
        """Await the dry runs; if both ended well, keep their records as
        they wrote them (the refit rewrites them) and start the refit."""
        self.outs = [p.communicate(timeout=MP_DRYRUN_TIMEOUT_S)
                     for p in self.procs]
        if any(p.returncode for p in self.procs):
            return
        self.records = [json.loads(self._record(*c).read_text())
                        for c in MP_DRYRUN]
        self.refit_t0 = time.perf_counter()
        self.refit_proc = self._start("--refit")

    def _record(self, arch, shape):
        return self.out_dir / f"{arch}_{shape}_single_pod_16x16.json"

    def hold(self):
        for (arch, shape), p, (stdout, stderr) in zip(MP_DRYRUN, self.procs,
                                                      self.outs):
            if p.returncode != 0 or "ran in" not in stdout:
                fail(f"dry run {arch} x {shape}: exit {p.returncode}\n"
                     f"{stdout[-2000:]}\n{stderr[-3000:]}")
        stdout, stderr = self.refit_proc.communicate(
            timeout=MP_REFIT_TIMEOUT_S)
        print(f"  the dry runs and the refit ran beside the card phases since "
              f"{time.perf_counter() - self.t0:.1f} s ago (the refit since "
              f"{time.perf_counter() - self.refit_t0:.1f} s ago)")
        for (arch, shape), rec in zip(MP_DRYRUN, self.records):
            print(f"  dry run {arch} x {shape} on the fake (16, 16) mesh "
                  f"({rec['compile_s']} s its step): per device arguments "
                  f"{rec['memory']['argument_bytes'] / 1e9:.3f} GB, temp "
                  f"{rec['memory']['temp_bytes'] / 1e9:.3f} GB, flops "
                  f"{rec['flops']:.4e}, bytes accessed "
                  f"{rec['bytes_accessed']:.4e}, collectives " + ", ".join(
                      f"{k} {v['count']} ({v['bytes']} B)"
                      for k, v in rec["collectives"].items()
                      if isinstance(v, dict) and v["count"]))
            hold_depth_fit(f"depth fit {arch} x {shape}", rec)
        code = self.refit_proc.returncode
        for arch, shape in MP_DRYRUN:
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith(f"[refit] {arch} x {shape}:")]
            if code != 0 or len(line) != 1:
                fail(f"--refit {arch} x {shape}: exit {code}\n"
                     f"{stdout[-2000:]}\n{stderr[-3000:]}")
            print(f"  {line[0]}")
            hold_depth_fit(f"refit {arch} x {shape}", json.loads(
                self._record(arch, shape).read_text()))


def model_parallel_phase(torch, dev, runs: Runs, dry_runs: DryRuns):
    """Tensor-parallel training of full-width ElasticBERT-12 (f32, the
    training recipe's batch 64 x 64) on the card: MP_STEPS steps unbound,
    then on a (1, 1) ("data", "model") mesh over an NCCL world of 1 with
    seq_parallel on and off (each equal to the unbound run within f32
    round-off, with the unbound run's attention launches), then TP =
    MP_TP2 on a (1, 2) mesh of ranks sharing the card over the threaded
    process group (the attention kernel on each rank's 6-head shard,
    forward and backward; equal to the unbound run). Then holds
    ``dry_runs`` (`DryRuns`, on the host since the MoE phase). Returns the
    attention records, forward and backward kernel, at the TP = 2 shard
    shape."""
    recs = mp_card_runs(torch, dev, runs)
    dry_runs.hold()
    return recs


def mp_card_runs(torch, dev, runs: Runs):
    """`model_parallel_phase`'s runs on the card; the records of the
    kernel's forward and of the backward kernel at the TP = 2 shard (the
    backward beside the plain `attention_backward`)."""
    import itertools
    import logging
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.data import batch_iterator, make_dataset
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_backward_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import (attention_backward,
                                                         gqa_ref)
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
    out, lse = flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    kw = dict(causal=False, window=0, scale=hd ** -0.5)
    grads = flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw)
    plain = attention_backward(q, k, v, out, dout, lse=lse, **kw)
    lib = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b, h, s, d = shard
    # bytes: q, o, dO, dq, k, v, dk, dv and lse, delta; operations: the
    # five products
    bwd = record(
        "flash_attention_backward",
        "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_backward.cu",
        "src/repro/kernels/flash_attention/kernel.py:80",
        f"q/k/v {shard} float32, bidirectional (a TP = {MP_TP2} rank's "
        f"head shard of the training step)",
        max((g - p).abs().max().item() for g, p in zip(grads, plain)),
        lambda: via("flash_attention_backward", "cuda_core",
                    lambda: flash_attention_backward_cuda(
                        q, k, v, out, lse, dout, **kw)),
        lambda: attention_backward(q, k, v, out, dout, lse=lse, **kw),
        lambda: torch.autograd.grad(F.scaled_dot_product_attention(*lib),
                                    lib, dout),
        8 * q.numel() * q.element_size() + 2 * b * h * s * 4,
        10.0 * b * h * s * s * d, "float32", variant="cuda_core")
    del lib
    run = f"mp TP={MP_TP2} seq_parallel=True (threaded ranks)"
    join_forward(bwd, rec)
    rec["launches"] = runs.counts[run]["flash_attention"]
    bwd["launches"] = runs.counts[run]["flash_attention_backward"]
    print(f"  flash_attention at {rec['shape']} (cuda_core): device ms per "
          f"call (CUDA graph): kernel {rec['ms']:.5f}, plain "
          f"{rec['plain_ms']:.5f}, SDPA {rec['library_ms']:.5f}, bound "
          f"{rec['bound_ms']:.6f} ({rec['bound_by']}); the backward kernel "
          f"{bwd['ms']:.5f}, plain attention_backward {bwd['plain_ms']:.5f}, "
          f"SDPA forward + backward {bwd['library_ms']:.5f}, bound "
          f"{bwd['bound_ms']:.6f} ({bwd['bound_by']}), max |err| "
          f"{bwd['max_abs_err']:.3e}; {rec['launches']} / {bwd['launches']} "
          f"launches in the TP = {MP_TP2} seq_parallel=True run")
    return rec, bwd


# ------------------------------------------------------------ front doors

# the front doors (`front_doors_phase`): the trained full-width checkpoint
# and the examples' outputs under FD_DIR; the serve CLI in this process
# (classify at the reference's testbed geometry, decode at qwen3-1.7b's
# smoke geometry) and as subprocesses in driver mode; three examples as
# subprocesses. The subprocesses start with the phase, run on this card
# beside its in-process runs (one intra-op thread each) and are awaited
# at its end, each cut at FD_PROC_TIMEOUT_S.
FD_DIR = ROOT / "build" / "front_doors"
FD_PROC_TIMEOUT_S = 300
# the classify runs train the testbed 100 of its default 300 steps: at
# 300 the card's testbed is saturated and serves no offload at all (so
# the cloud half would go unrun), and training is most of each run's time
FD_CLASSIFY = ["--samples", "512", "--batch-size", "32", "--steps", "100"]
FD_DECODE = ["--workload", "decode", "--decode-arch", "qwen3-1.7b",
             "--samples", "16", "--batch-size", "8", "--max-new-tokens",
             "16"]
FD_FULL_STEPS = 20
FD_TRAIN_STEPS = 20
# the fault-tolerant trio: a respawned worker on the card asks to rejoin
# only once it has imported the port and made its exchange, which under
# the phase's load may take longer than the default 5 s detection window;
# the cluster detects the kill within FD_HB_TIMEOUT (the respawn then
# joins at the kill's round) and paces every round by FD_PACE_S, so a
# later respawn still joins before the survivors end the stream (a
# cluster that finishes first never acks it)
FD_HB_TIMEOUT = 8.0
FD_PACE_S = 0.5
FD_CLI = [sys.executable, "-m", "repro_torch.launch.serve"]
# name -> (argv, extra environment); the examples run under FD_EXAMPLE
FD_BACKGROUND = {
    "CLI lockstep pair": (FD_CLI + [
        "--distributed", "--num-processes", "2", "--batch-size", "16",
        "--samples", "101", "--layers", "3", "--steps", "30",
        "--overlap-depth", "2"], {}),
    "CLI fault-tolerant trio": (FD_CLI + [
        "--distributed", "--num-processes", "3", "--fault-tolerant",
        "--batch-size", "8", "--samples", "80", "--steps", "20",
        "--layers", "3", "--heartbeat-timeout", str(FD_HB_TIMEOUT)],
        {"SPLITEE_FAULTS": f"kill:host=1,epoch=2;sleep:host=*,epoch=*,"
                           f"secs={FD_PACE_S}"}),
    "train_multiexit_torch --full": (
        ["examples/train_multiexit_torch.py", "--full", "--steps",
         str(FD_FULL_STEPS), "--save", str(FD_DIR / "train_multiexit")], {}),
    "serve_engine_torch": (
        ["examples/serve_engine_torch.py", "--samples", "96", "--layers",
         "2", "--steps", "10", "--batch-size", "8"], {}),
    "lm_decode_splitee_torch": (
        ["examples/lm_decode_splitee_torch.py"], {}),
    # the training CLI on an LM arch: rwkv6-3b's smoke config through the
    # WKV6 kernels and their gradient
    "CLI train rwkv6-3b --smoke": (
        ["-m", "repro_torch.launch.train", "--arch", "rwkv6-3b", "--smoke",
         "--steps", str(FD_TRAIN_STEPS)], {}),
}
# runs an example (or ``-m MODULE``) as its user would (``python
# examples/X.py FLAGS``), then prints the launch counts of this process
# (the kernels are the ones the smoke built: the same content hash)
FD_EXAMPLE = r'''
import json, runpy, sys
import torch
sys.argv = json.loads(sys.argv[1])
if sys.argv[0] == "-m":
    sys.argv = sys.argv[1:]
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
else:
    runpy.run_path(sys.argv[0], run_name="__main__")
torch.cuda.synchronize()
from repro_torch.kernels import launch_counts, variant_launch_counts
print("LAUNCHES " + json.dumps({"counts": launch_counts(), "variants": {
    k: v for k, v in variant_launch_counts().items() if v}}))
'''
SUMMARY_LINE = re.compile(r"^(?P<path>[^:\n]*): n=(?P<n>\d+) acc=(?P<acc>\S+) "
                          r"cost=(?P<cost>\S+)λ offload_frac=(?P<frac>\S+) "
                          r"offloaded=(?P<mb>\S+)MB \((?P<rate>\S+) "
                          r"samples/s\)$", re.M)


@contextlib.contextmanager
def fd_background():
    """FD_BACKGROUND's commands started on entry, each in a session of
    its own (so its cluster workers go with it) with its output in files
    under FD_DIR; yields {name: Popen}. Every session still running on
    the way out is killed."""
    import signal
    logs = FD_DIR / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name, (argv, extra) in FD_BACKGROUND.items():
            env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                       **extra)
            if argv[0] != sys.executable:
                argv = [sys.executable, "-c", FD_EXAMPLE, json.dumps(argv)]
            stem = re.sub(r"\W+", "_", name)
            with open(logs / f"{stem}.out", "w") as out, \
                    open(logs / f"{stem}.err", "w") as err:
                procs[name] = subprocess.Popen(
                    argv, cwd=ROOT, env=env, stdout=out, stderr=err,
                    start_new_session=True)
            procs[name].logs = (logs / f"{stem}.out", logs / f"{stem}.err")
        yield procs
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def fd_await(procs, t0: float):
    """Wait for every background command (FD_PROC_TIMEOUT_S from the
    phase's start); fails on a non-zero exit with its stderr's tail.
    Returns {name: (stdout, stderr, wall s from the phase's start)}."""
    outs = {}
    for name, p in procs.items():
        try:
            p.wait(timeout=max(1.0, t0 + FD_PROC_TIMEOUT_S
                               - time.perf_counter()))
            status = f"exit {p.returncode}"
        except subprocess.TimeoutExpired:
            status = f"still running {FD_PROC_TIMEOUT_S} s after the phase " \
                f"began"
        stdout, stderr = (path.read_text() for path in p.logs)
        outs[name] = (stdout, stderr, time.perf_counter() - t0)
        if p.returncode != 0:
            fail(f"{name}: {status}\n{stdout[-2000:]}\n{stderr[-4000:]}")
    return outs


def fd_checkpoint(torch, dev, runs: Runs, trained):
    """The training phase's full-width weights saved with `save_pytree`,
    read back against the card tree, against `abstract_params()` with
    ``device=`` the card and onto the CPU (every leaf bitwise), then
    served from the loaded tree: bit for bit the in-memory tree's run."""
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.data import OnlineStream, make_dataset
    from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve

    params, model, cost = trained
    cfg = train_config()
    path = FD_DIR / "elasticbert12"
    t0 = time.perf_counter()
    save_pytree(str(path), params)
    secs = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    print(f"  save_pytree: {len(list(params.parameters()))} leaves, "
          f"{nbytes} bytes on disk in {secs:.3f} s "
          f"({nbytes / secs / 1e9:.3f} GB/s)")
    loaded = {}
    for name, like, device in (("card tree", params, None),
                               ("abstract_params() to the card",
                                model.abstract_params(), dev),
                               ("the card tree to the CPU", params, "cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = load_pytree(str(path), like, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        want = dict(params.named_parameters())
        got = dict(tree.named_parameters())
        where = {p.device.type for p in got.values()}
        same = list(got) == list(want) and all(
            not p.requires_grad and torch.equal(
                _bits(p), _bits(want[n].to(p.device)))
            for n, p in got.items())
        print(f"  load_pytree ({name}): {secs:.3f} s, on {sorted(where)}, "
              f"every leaf bitwise the trained tree's: {same}")
        if not same or where != {"cpu" if device == "cpu" else "cuda"}:
            fail(f"load_pytree ({name}): leaves differ or on {where}")
        loaded[name] = tree
    data = make_dataset("imdb_like", SERVE_SAMPLES, seed=1)
    reps = {}
    for name, tree in (("in memory", params),
                       ("from the checkpoint",
                        loaded["abstract_params() to the card"])):
        reps[name], _, _ = runs.run(
            torch, f"checkpoint f32 B=32 {name}",
            lambda tree=tree: serve(
                EdgeCloudRuntime(cfg, device=dev), tree,
                OnlineStream(data, seed=0), cost,
                ServingConfig(batch_size=SERVE_BATCH)),
            cfg, batch_size=SERVE_BATCH, full=False)
    same_run("checkpoint f32 B=32 from the checkpoint",
             reps["from the checkpoint"], reps["in memory"])
    print("  served from the checkpoint == in memory: arms, exits, preds, "
          "rewards, offload bytes, cost and controller state bit for bit")


def fd_cli(torch, runs: Runs, name, argv):
    """`repro_torch.launch.serve.main(argv)` in this process, its launch
    counts set to 0 just before and read just after; returns (its
    printed output, counts)."""
    import io
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_launch_counts)
    from repro_torch.launch import serve as cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    runs.counts[name] = counts
    runs.variants[name] = {k: n for k, n in variant_launch_counts().items()
                           if n}
    runs.tiles[name] = {}
    print(f"  {name} ({wall:.2f} s wall): main({' '.join(argv)})")
    for line in buf.getvalue().splitlines():
        print(f"    | {line}")
    print(f"    launches {counts}; by variant {runs.variants[name]}")
    return buf.getvalue(), counts


def fd_summary(name, out):
    """The summary line's fields of a CLI run; fails without one."""
    m = SUMMARY_LINE.search(out)
    if m is None:
        fail(f"{name}: no summary line in\n{out[-2000:]}")
    return m.groupdict()


def fd_cli_runs(torch, runs: Runs):
    """The CLI in this process: classify with ``--dump-config`` and again
    from that ``--config`` (the same decisions when the testbed's training
    repeats bit for bit; else the difference printed and the two resolved
    configs held equal), a fused scan run, and decode."""
    from repro_torch.configs import get_smoke_config
    first, second = FD_DIR / "serve.json", FD_DIR / "serve_again.json"
    out1, c1 = fd_cli(torch, runs, "CLI classify --dump-config",
                      FD_CLASSIFY + ["--dump-config", str(first)])
    out2, c2 = fd_cli(torch, runs, "CLI classify --config",
                      ["--config", str(first), "--batch-size", "32",
                       "--steps", "100", "--dump-config", str(second)])
    out3, c3 = fd_cli(torch, runs, "CLI classify --fused-exit scan",
                      FD_CLASSIFY + ["--fused-exit", "--edge-mode", "scan"])
    # the testbed trains 6 layers (the CLI's default) for --steps steps:
    # one backward-kernel launch a layer a step, all through cuda_core (f32)
    testbed = 6 * 100
    for name, counts, fused in (("--dump-config", c1, False),
                                ("--config", c2, False),
                                ("--fused-exit scan", c3, True)):
        if not (counts["flash_attention"] and counts["exit_confidence"]) or \
                bool(counts["exit_confidence_fused"]) != fused or \
                counts["flash_attention_backward"] != testbed or \
                runs.variants[f"CLI classify {name}"].get(
                    "flash_attention_backward/cuda_core") != testbed:
            fail(f"CLI classify {name}: launches {counts} (by variant "
                 f"{runs.variants[f'CLI classify {name}']}), the testbed's "
                 f"training {testbed} backward-kernel launches")
    s1, s2, s3 = (fd_summary(n, o) for n, o in (("--dump-config", out1),
                                                ("--config", out2),
                                                ("--fused-exit", out3)))
    if first.read_text() != second.read_text():
        fail(f"CLI --config: resolved configs differ:\n{first.read_text()}\n"
             f"{second.read_text()}")
    loss = [re.search(r"final loss (\S+)", o).group(1) for o in (out1, out2)]
    fields = ("path", "n", "acc", "cost", "frac", "mb")
    decisions = [tuple(s[k] for k in fields) for s in (s1, s2)]
    print(f"  CLI classify --dump-config vs --config: resolved configs "
          f"equal; testbed final loss {loss[0]} vs {loss[1]}; decision "
          f"fields {'equal' if decisions[0] == decisions[1] else 'differ'}"
          f": {decisions[0]} vs {decisions[1]}; the fused scan run "
          f"{tuple(s3[k] for k in fields)}")
    if loss[0] == loss[1] and decisions[0] != decisions[1]:
        fail("CLI classify: the same testbed served other decisions from "
             "the same config")
    for s in (s1, s2, s3):
        if s["n"] != "512":
            fail(f"CLI classify: served {s['n']} of 512")

    out4, c4 = fd_cli(torch, runs, "CLI decode qwen3-1.7b smoke", FD_DECODE)
    cfg = get_smoke_config("qwen3-1.7b")
    n, b, tokens = 16, 8, 16
    want, _ = decode_expected(cfg, n, b, tokens)
    want["flash_attention"] += layer_launches(cfg, 0, cfg.num_layers)
    want["exit_confidence"] += tokens          # the alpha probe's steps
    if c4 != want:
        fail(f"CLI decode: launches {c4}, but one exit launch a step (the "
             f"probe's {tokens} and the served {n // b} x {tokens}) and "
             f"the prefills need {want}")
    if f"tokens={n * tokens} " not in out4:
        fail(f"CLI decode: not {n * tokens} tokens:\n{out4}")


def fd_check_background(torch, dev, runs: Runs, outs):
    """What the background commands printed: the clusters' host-0
    summaries (and the fault-tolerant kill, respawn and rejoin), the
    examples' lines and launches, and train_multiexit_torch's checkpoint
    reproducing its own per-exit lines."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_dataset
    from repro_torch.launch.train import exit_accuracy
    from repro_torch.models.api import build_model

    for name, (stdout, stderr, wall) in outs.items():
        print(f"  {name}: exit 0 at {wall:.1f} s of the phase")
        for line in stdout.splitlines():
            if not line.startswith("LAUNCHES "):
                print(f"    | {line}")
    pair = fd_summary("CLI lockstep pair", outs["CLI lockstep pair"][0])
    if pair["path"] != "SplitEE (distributed H=2 R=1/host B=16 overlap=K=2)" \
            or pair["n"] != "101":
        fail(f"CLI lockstep pair: {pair}")
    trio_out = outs["CLI fault-tolerant trio"][0]
    trio = fd_summary("CLI fault-tolerant trio", trio_out)
    reconf = re.findall(r"^\[fault-tolerant\] round (\d+): removed=(\S+) "
                        r"joined=(\S+) ", trio_out, re.M)
    joined = [int(r) for r, _, j in reconf if j == "[1]"]
    print(f"  CLI fault-tolerant trio: host 1 removed at round "
          f"{reconf[0][0] if reconf else None}, rejoined at round "
          f"{joined[0] if joined else None}")
    if not reconf or reconf[0][:2] != ("2", "[1]") or not joined \
            or trio["n"] != "80" or "final-exit: " not in trio_out \
            or trio["path"] != ("SplitEE (distributed H=3 R=1/host B=8 "
                                "overlap=K=1 FT)"):
        fail(f"CLI fault-tolerant trio: no kill at round 2, respawn and "
             f"rejoin, or not the whole stream:\n{trio_out}")

    for name in ("serve_engine_torch", "lm_decode_splitee_torch"):
        line = [ln for ln in outs[name][0].splitlines()
                if ln.startswith("LAUNCHES ")]
        rec = json.loads(line[-1][len("LAUNCHES "):])
        runs.counts[f"example {name}"] = rec["counts"]
        runs.variants[f"example {name}"] = rec["variants"]
        runs.tiles[f"example {name}"] = {}
        print(f"  example {name}: launches {rec['counts']}; by variant "
              f"{rec['variants']}")
        if name == "serve_engine_torch":
            if "push-session == one-shot serve(): arms, preds, and bandit " \
                    "state are bit-identical" not in outs[name][0] or \
                    not (rec["counts"]["flash_attention"]
                         and rec["counts"]["exit_confidence"]):
                fail(f"example {name}: {outs[name][0][-1500:]}")
        else:
            cfg = get_smoke_config("rwkv6-3b")
            want, _ = decode_expected(cfg, 8, 8, 16)
            if rec["counts"] != want:
                fail(f"example {name}: launches {rec['counts']}, the "
                     f"decode launch model needs {want}")

    name = "CLI train rwkv6-3b --smoke"
    out = outs[name][0]
    rec = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("LAUNCHES ")][-1][len("LAUNCHES "):])
    runs.counts[name], runs.variants[name] = rec["counts"], rec["variants"]
    runs.tiles[name] = {}
    losses = [float(m) for m in re.findall(r"^step\s+\d+ loss (\S+)", out,
                                           re.M)]
    layers = get_smoke_config("rwkv6-3b").num_layers
    # train_classifier trains without remat: WKV6 and its backward once a
    # layer a step
    want = {k: 0 for k in rec["counts"]}
    want["wkv6"] = want["wkv6_backward"] = layers * FD_TRAIN_STEPS
    print(f"  {name}: losses {losses}; launches {rec['counts']}; by variant "
          f"{rec['variants']}")
    if len(losses) != 2 or not all(x == x and abs(x) < float("inf")
                                   for x in losses) \
            or rec["counts"] != want:
        fail(f"{name}: want two finite loss lines and launches {want}:\n"
             f"{out[-2000:]}")

    # the --full run's checkpoint, read back here, reprints its lines
    cfg = train_config()
    model = build_model(cfg)
    params = load_pytree(str(FD_DIR / "train_multiexit"),
                         model.abstract_params(), device=dev)
    lines = outs["train_multiexit_torch --full"][0].splitlines()
    for domain in ("sst2_like", "imdb_like"):
        conf, _, correct = exit_accuracy(model, params,
                                         make_dataset(domain, 2048, seed=9))
        acc = f"{domain:14s} per-exit acc : " + " ".join(
            f"{a:.2f}" for a in correct.mean(0))
        confs = f"{'':14s} per-exit conf: " + " ".join(
            f"{c:.2f}" for c in conf.mean(0))
        if acc not in lines or lines[lines.index(acc) + 1] != confs:
            fail(f"train_multiexit_torch --full: its checkpoint gives\n"
                 f"{acc}\n{confs}\nnot in what it printed")
    print(f"  train_multiexit_torch --full: its checkpoint "
          f"({FD_FULL_STEPS} steps, {cfg.num_layers} layers, d "
          f"{cfg.d_model}, f32) read back with load_pytree reprints its "
          f"per-exit accuracy and confidence lines on both domains")


def front_doors_phase(torch, dev, runs: Runs, trained):
    """The front doors on the card: the training phase's full-width
    checkpoint (`fd_checkpoint`), the serve CLI through ``main(argv)``
    (`fd_cli_runs`), and as subprocesses started with the phase (`
    FD_BACKGROUND`): the CLI's driver mode (a lockstep pair and a
    fault-tolerant trio with host 1 killed at round 2, respawned and
    rejoined; workers on this card) and three examples, awaited and
    checked at its end (`fd_check_background`)."""
    t0 = time.perf_counter()
    with fd_background() as procs:
        fd_checkpoint(torch, dev, runs, trained)
        fd_cli_runs(torch, runs)
        print(f"  [in-process runs: {time.perf_counter() - t0:.1f} s wall]")
        outs = fd_await(procs, t0)
    fd_check_background(torch, dev, runs, outs)


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
        # 16-byte and in 4-byte pieces; attention: d 64, 128, each with
        # and without the saved lse; its backward's dK/dV and dQ passes:
        # mma.sync at d 64, 128; wgmma dK/dV at d 64 (64- and 32-row query
        # tiles) and 128, dQ at d 64 and 128
        if len(tc_fns) != 17 or min(tc_fns.values()) == 0:
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
        rec_combine = exit_shard_checks(torch, dev, rec_exit, rec_fused)
        rec_wkv6 = wkv6_checks(torch, dev)
        rec_wkv6_bwd = wkv6_backward_checks(torch, dev)
        front_door_records(torch, dev, rec_attn, rec_exit, rec_fused,
                           rec_wkv6)
        rec_train_attn, rec_family_attn, rec_attn_bwd = \
            attention_grad_checks(torch, dev)
        rec_attn.update(rec_family_attn)

    runs = Runs()
    # first, so that the CPU's readings of its decisions (a subprocess)
    # run beside the phases that follow
    with phase("train: elasticbert12 (full width) on the card"):
        rec_attn["at_training"], trained, decisions = train_phase(
            torch, dev, runs, rec_train_attn)
        rec_attn_bwd["at_train_elasticbert"]["launches"] = \
            rec_attn["at_training"]["launches"]
    # before the serve phases: each step needs the card to itself
    with phase(f"train: {LM} (full width) on the card, through WKV6's "
               f"gradient"):
        rec_wkv6_bwd["lm_training"] = lm_train_phase(torch, dev, runs)
    train_agree = TrainAgreement()
    with phase("train: " + ", ".join(
            f"{a}{f' ({n} layers)' if n else ''}" for a, n, _ in FAMILY_TRAIN)
            + " (full width) on the card, through attention's gradient"):
        for key, rec in family_train_phase(torch, dev, runs).items():
            rec_attn[key]["training"] = rec
            (rec_attn_bwd if key == MAIN_TRAIN_ATTENTION
             else rec_attn_bwd[key])["training"] = rec
    with phase("training agreement: the card halves (a subprocess, whose "
               "CPU halves then run beside the phases that follow)"):
        train_agree.card_halves()

    for arch, layers, alpha_layer, prefix, agree in (
            ("elasticbert12", None, 6, "", agreement_phase),
            (LM, None, 16, f"{LM} ", lm_agreement_phase),
            (HYBRID, HYBRID_SERVE_LAYERS, HYBRID_ALPHA_LAYER,
             f"{HYBRID} {HYBRID_SERVE_LAYERS}L ",
             lambda *a: lm_agreement_phase(*a, layers=HYBRID_AGREE_LAYERS))):
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
                # rwkv6-3b's in-turns timing and busy profiles are left out
                # for the 1200 s limit
                sharded = sharded_phase(torch, dev, runs, params, cfg, data,
                                        cost, bucketed, scan, prefix,
                                        timed_runs=arch != LM)
            with phase(f"model mesh: {arch} serve(path='sharded', mesh=) "
                       f"over a ('data', 'model') mesh"):
                model_serving_phase(torch, dev, runs, params, cfg, data,
                                    cost, prefix)
        if arch == "elasticbert12":
            with phase(f"distributed: {arch} serve(path='distributed'), one "
                       f"process and worker-process clusters on this card"):
                distributed_phase(torch, dev, runs, params, cfg, data, cost,
                                  sharded)
        with phase(f"agreement: {arch}, card kernel path vs CPU plain "
                   f"path"):
            if arch == LM:
                witness = Witness(torch, params, cfg)
            agree(torch, dev, params, cfg, data)
        del params
        torch.cuda.empty_cache()

    with phase("decode: " + ", ".join(a for a, _ in DECODE_ARCHS)
               + " (full width) on the card, a subprocess each, all at once"):
        decode_phases(torch, runs, seed)

    with phase(f"agreement: {LM} at all its layers against float64 (a "
               f"subprocess since its agreement phase)"):
        witness.wait()
    # the dry runs (then their refit, from the end of the MoE phase), on
    # the host beside the phases up to the model-parallel one, which holds
    # them
    dry_runs = DryRuns()

    with phase(f"{MOE}: full width, {MOE_LAYERS} of 32 layers, on the "
               f"card"):
        moe_phase(torch, dev, runs, seed)
    dry_runs.refit()

    with phase(f"{VLM}: full width on the card, over seeded embeds"):
        vlm_phase(torch, dev, runs, seed)

    with phase(f"{ENCDEC}: full width on the card (encoder, "
               f"cross-attention, decode)"):
        encdec_phase(torch, dev, runs, seed)

    with phase("agreement: offload codec, card vs CPU"):
        codec_agreement(torch, dev)

    with phase("model parallelism: elasticbert12 TP training on the card, "
               "the dry run"):
        rec_attn["at_tp2_train"], rec_attn_bwd["at_tp2_train"] = \
            model_parallel_phase(torch, dev, runs, dry_runs)

    with phase("front doors: the full-width checkpoint, the serve CLI "
               "(in process and its driver mode), the examples"):
        front_doors_phase(torch, dev, runs, trained)
    del trained

    with phase("decisions: the CPU's readings of the trained and early "
               "weights (a subprocess since the training phase) against the "
               "card's"):
        decisions_wait(decisions)

    with phase("training agreement: the CPU halves (a subprocess since the "
               "training phases) against the card halves"):
        train_agree.wait()

    kernels = []
    for rec in (rec_attn, rec_exit, rec_fused, rec_wkv6, rec_combine,
                rec_wkv6_bwd, rec_attn_bwd):
        path = MAIN_PATH[rec["name"]]
        rec["main_path"] = path
        rec["launches"] = runs.counts[path][rec["name"]]
        rec["launches_by_path"] = {p: c[rec["name"]]
                                   for p, c in runs.counts.items()}
        rec["launches_by_variant"] = {
            p: {k.split("/")[1]: n for k, n in c.items()
                if k.split("/")[0] == rec["name"]}
            for p, c in runs.variants.items()}
        if rec["name"].startswith("exit_confidence") \
                or rec["name"] == "flash_attention_backward":
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
                  f"{at['bound_ms']:.6f} ({at['bound_by']})"
                  + (f"; the backward kernel {at['backward_ms']:.5f}"
                     if "backward_ms" in at else "")
                  + (f", SDPA forward + backward {at['library_grad_ms']:.5f}"
                     if "library_grad_ms" in at else "")
                  + (f"; trained {at['training']['ms_per_step']:.3f} ms a "
                     f"step, {at['training']['launches'][rec['name']]}"
                     f" launches in {at['training']['steps']} steps"
                     if "training" in at else ""))
    print(f"  whole smoke: {time.perf_counter() - t_start:.1f} s wall")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
