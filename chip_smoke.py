#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mdt_policy_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Drives the port's paths at the production widths (`MDTVConfig()` and
`MDTConfig()`, seeded random weights): the MDT-V and the MDT closed-loop
replans through `MDTVPolicy` (alias `MDTPolicy`), CALVIN's chain evaluation
on the fake env through `evaluate_policy` and `evaluate_policy_batched`
for both, the dual-modality train step of both families through
`train_step` at B=128 per stream, the MDT validation step, checkpoints of
both families' train states through `Checkpointer`, a reference-format
Lightning checkpoint of MDT-V converted by `utils/from_reference.py`, the
evaluate CLI (`mdt_policy_tpu_torch.evaluate.main`) on MDT's run directory
and on the converted MDT-V one, the
frozen-tower embedding extraction through `extract_embeddings` and
`extract_lang_goals` over a synthetic split, and the cache-mode train step
from the rows it wrote, `train()` and the extraction CLI over an on-disk
split, `train()` with its training-time rollouts, rollout videos, the
train step in an NCCL process group, the language annotator CLI with both
in-repo embedders, every other module of the JAX package, the loader
benchmark and the steps' FLOPs. Prints one JSON line per phase:

  1. device   card name and power limit (nvidia-smi); TF32 off for f32
              matmuls and convolutions.
  2. build    nvcc of every kernel source, all started together, in seconds.
  3. kernel   B1, B3 and B2 against their plain PyTorch versions on the card
              at the paths' shapes, bf16 and f32, with CUDA-event times of
              the kernel, the plain version and the PyTorch library call,
              the kernel's device time from the profiler (`device_ms`), and
              the least time the card could take (`bound_ms`); each B1 row
              names the body it ran (`sm90`, the tensor cores, for bf16;
              `mha_core` for f32) and carries the wrapper's host microseconds
              a call (`host_us`, no synchronise: 1000 calls, 100 above B=64);
              B2 at the replans' shapes at B=1 and B=32 and the four of the JAX
              package's ops/bench_pallas.py, then at edge cases (T=1, T=32,
              D=128, D off the vector width, several rows a block;
              contiguous, strided and misaligned inputs), f32 also against
              float64; B2 and B3 rows carry the wrapper's host microseconds
              a call (`host_us`, 1000 calls, no synchronise). B3's rows
              carry its launch plan (lanes a row, vectors a lane, blocks,
              warps a block, the path of few or many rows) and three device
              readings each, warm and with a cold L2 (a rotation of input
              copies whose calls between two uses of one move twice the
              L2's 50 MB), of the kernel, PR 7's body
              (`csrc/baseline/fused_norm_pr7.cu`), the library call and a
              copy of x, and the cold reading's share of the bound. B6 (the
              denoiser's few-row blocks) at each of its launches of a B=1
              replan of both families against its plain version, with the
              plain version's (the per-op route's) and cuBLAS's (`F.linear`
              over the same layers) event and device ms, and each launch's
              count a replan with the sums a replan. Then B4 and
              B5 (the attention and MLP half-blocks) at the extraction's six shapes against
              their plain versions in bf16 and in float64, with the kernel,
              device, plain and unfused route (B3 + F.linear + B1 or the
              activation + F.linear) times and each device kernel's time;
              device kernels per call must be 4 (B4: norm pass, qkv GEMM,
              attention core, projection GEMM) and 3 (B5: norm pass, W1
              and W2 GEMMs). After each, its norm pass and GEMMs alone
              (`ops/halfblock_gemm.py`) against their plain versions, with
              F.linear (or the norm) as the library call and each one's
              share of the call's device time.
  4. replan   MDT-V: reset() and 20 step() calls at B=1 on the eager policy
              (`cuda_graph=False`); per replan B1 24 then 12, B3 50 then 25,
              B2 44 and 44 (4 encoder blocks + 4 decoder blocks x 10 DDIM
              steps), B6 266 and 266 (4 a block of the encoder, and at each
              DDIM step 1 for the decoder's AdaLN and 6 a block).
     graph    30 steps on the graph policy: the same counts per replan (a
              captured kernel counts at each replay, not at the capture);
              the two replays with the goal cached launch those kernels by
              name in the profiler too (their device µs by name beside the
              counts); the graph and the eager policy from
              one seed give the same chunks bit for bit for a text goal and
              a goal image over two replans with other frames.
  5. e2e      the same replan through the kernels and through the plain
              versions: the (1, 10, 7) chunks must agree.
  6. timing   replan p50/p90 at B=1 and B=32 of the graph and the eager
              policy in turns (graph, eager, eager, graph), the capture's ms
              and reserved memory, goal-encode time; then 5 replans of each
              under the profiler (device events, busy share, and the device
              µs a replan of B1, B3 LayerNorm, B3 RMSNorm and B2).
  7. b2_ab    MDT-V replan p50/p90 at B=1 and B=32 with B2 and with B2
              swapped alone for `sdpa`, in turns (B2, sdpa, sdpa, B2).
     b6_ab    the B=1 and B=3 graph replan with B6's route and with the per-op
              route (captured with the route off), in turns, p50/p90, the
              actions' gap, device ms and events a replan (after timing, for
              each family).
  8. replan, e2e, timing  the same three for MDT: B1 12 then 0, B3 25 then
              0, B2 64 and 64 (4 + 6 x 10), B6 386 and 386 (16 + 37 x 10)
              per replan.
  9. rollout  per family, on the graph policy, `evaluate_policy` over 4
              chains (200 px static, 84 px gripper frames, episodes of 360
              steps) through
              `make_rollout_policy`, a scripted oracle solving every task at
              25 steps but one that never solves: results, env steps and
              replans per chain must follow from that rule, actions finite;
              env steps/s and replans/s. Then `evaluate_policy_batched`
              over 32 fake envs and 32 chains, one B=32 replan per policy
              call: results and policy calls by the same rule. Per family,
              B2 and B3 RMSNorm launch a replan's worth per replan and per
              warm-up call before a capture, B1 and B3 LayerNorm at least
              that.
 10. train    3 train steps at B=128 per stream: finite losses and
              grad_norm, trainables and EMA moved, frozen towers not; per
              step 60 B1, 157 B3 and 0 B2 launches (dropout is on).
 11. train_e2e  one step from the same state and draws through the kernels
              and through the plain versions: losses and grad_norm agree.
 12. train_timing  step ms p50/p90 over 6 steps after 3 warm-up steps,
              chunks/s, peak memory; then a profiled window of 2 steps.
 13. mdt_train, mdt_train_e2e, mdt_train_timing, mdt_validation  the same
              three for MDT (224 px static, 84 px gripper, 112 px
              foresight frames, the JAX data path's sizes): every trainable
              network moved, both ResNets among them, the CLIP towers not;
              per step 36 B1, 77 B3 LayerNorm, 26 B3 RMSNorm and 0 B2; then
              one validation step from the train batch, 36 B1, 77 and 26 B3
              and 128 B2 (4 + 6 x 10 a scope) asserted, and the same step
              through the plain versions: its metrics agree.
 14. checkpoint  the MDT-V and MDT train states saved by `Checkpointer` into
              a temporary run directory each (config.yaml from `RunConfig`,
              the step as best.json's metric), restored into fresh states
              on the card: every tensor bit-equal, optimizer moments and
              steps included; one more step from each side with the same
              draws, metrics within CHECKPOINT_STEP_REL_TOL.
 15. evaluate_cli  `evaluate.main(["--train-folder", run, "--fake-env",
              "--num-sequences", "4", ...])` in this process per family,
              MDT-V's run the one reference_ckpt converted: results.json
              is the never-solving scripted oracle's, env steps and replans
              follow from it (1,440 and 144), the policy's weights are the
              checkpoint's EMA, and the B1, B2 and B3 launches are the graph
              phase's per replan run plus the text tower's per goal; a graph
              replan of the converted MDT-V net is bit-equal to the same
              replan of the net the file was written from.
 16. extract  512 synthetic frames (200 px static, 84 px gripper) at batch
              64 with one shift variant, and 512 annotation sentences,
              through the B4/B5 route: file layout, the bit-exact
              self-check, B4/B5 and B3 launches, the first batch against
              the B1 + B3 route; frames/s of both routes in turns, the
              route `extract_embeddings` takes by default and whether it
              was the faster in both pairs of turns.
 17. cache_train  3 train steps at B=128 per stream from the written cache:
              no tower kernel, B3 only at the decoder and the MAP head; one
              step kernels vs plain; one validation step; step times and a
              profiled window.
 18. attn_variants  (runs right after the kernel checks of 3) the
              attention-variant microbench: `run()` of
              `mdt_policy_tpu_torch.tools.attn_kernel_experiment` (V1 at
              block_b 16, 20, 24) and `attn_kernel_round3` (V3 under the 8
              option sets of the JAX tool) at (1024, 196, 1152) H=6 and
              (512, 197, 2304) H=12, 12-layer chains, B1 as the production
              baseline; every chain must launch its kernel 12 times. Then
              each V1/V3 variant against its plain version on the card at
              the same shapes (bound 2e-2 x max(1, max|ref|)), one line per
              (variant, shape): max |delta|, the kernel's event and device ms,
              its chain ms per layer, bound_ms (bytes-bound, ~0.184 ms), the
              plain version's, SDPA's and B1's ms, TFLOP/s, launches per chain,
              and the registers and local-memory bytes (spills) a thread of
              the kernel's instantiation. V1 and V3 run B1's tensor-core
              body (`csrc/attention_sm90.cuh`).

 19. train_cli  per family, `train()` (the training CLI's function) at the
              production config over a synthetic on-disk split at CALVIN's
              frame sizes (`write_calvin_split`: 200 px static, 84 px
              gripper frames, extracted with `data.extract`), B=128 per
              stream, one decode thread: 2 epochs of 3 steps, the same run
              directory resumed to epoch 3, and a run of 3 epochs never
              interrupted; every trainable and EMA tensor of the resumed
              run within RESUME_REL_TOL of the straight one (bit-equality
              printed); launches per train step and per validation step
              asserted; the loop's chunks/s from metrics.csv beside the
              bare step's, the busy share of a `trainer.profile_steps`
              window, the recon grid and system_info.json (TF32 off, cuDNN
              deterministic).
 20. extract_cli  the extraction CLI (`data.extract_embeddings.main`) with
              the MDT-V run directory's towers over both splits (launches
              asserted), then 3 cache-mode `train()` steps from its files:
              no tower kernel, 30 B3 RMSNorms a step.
 21. tf32     MDT with cuDNN's TF32 on and off from the same weights,
              frames and draws: the B=1 replan chunk, one train step's 9
              losses, the two ResNets' f32 outputs against float64, the
              step's device ms (and with cuDNN free to choose algorithms).
              The B3 and B2 rows of 3, V1/V3's rows of 18 and the norm
              pass's and GEMMs' rows of 3 also carry the library call's
              device ms (`library_device_ms`).
 22. train_rollout  (runs before tf32, on train_cli's split) `train()` of
              MDT-V at B=128 per stream, 2 epochs of 3 steps, with both
              training-time rollouts after epoch 2: the chain rollout (4
              chains of 360-step episodes on the fake env at CALVIN's
              camera sizes; the port's `make_calvin_env` and
              `make_task_oracle` patched to it and to the rollout phase's
              scripted oracle) and the task rollout (this script's
              `make_task_env` and `make_task_oracle`); the rollout's env
              steps/s and replans inside `train()`, the `eval_lh/*` and
              `tasks/*` rows of metrics.csv, the step `best.json` names; the
              first rollout chunk bit-equal to an eager `MDTVPolicy`'s on
              the EMA weights from the rollout's generator; B2 and B3
              RMSNorm launches exactly the steps', validations' and
              replans' worth; the final trainables and EMA bit-equal to the
              same run with both rollouts off.
 23. video    `RolloutVideo` over 40 fake-env frames, then `evaluate.main`
              with `--num-videos 1` on that run directory: with PIL the GIFs'
              frame counts, without it the ImportError that names PIL from
              each call that needs it (`"pil": false`).
 24. ddp      (after tf32) in a child process (`--ddp-child`), per family
              at B=128 per stream: the plain train step and the same step
              in an NCCL group of one rank, from one state and generator:
              metrics, gradients, trainables and EMA bit-equal; the
              all-reduce's bytes and ms, the all-gather's, the step's ms
              without and with the group. With two cards, `train()` on 2
              NCCL ranks (`--ddp-rank` children) for 3 steps: the ranks'
              trainables bit-identical after every step, the first step's
              losses within 1e-5 of one process's at the global batch;
              with one, `"ranks_2": "not run: 1 device"`.
 25. flops    (after each train timing) one train step of each family under
              `FlopCounterMode`, B1's call sites tallying 4 B T^2 C a call
              (asserted equal to `utils/flops.py`'s formula, which the
              counter cannot see): the counter's FLOPs, B1's, their sum over
              the timing's p50 step as TFLOP/s, `mfu` (the bf16 dense peak,
              989 TFLOP/s) and the f32 peak's share (67; the steps are f32).
 26. annotator  (after video, on its split) `lang_annotator.main` with
              `--scripted-oracle open_drawer --validation`, `--embedder clip`
              (the random-init `MDTVConfig()` text tower, bf16) and
              `minilm:<dir>` (seeded MiniLM-L3 weights, written as
              `pytorch_model.bin` and as `model.safetensors`, bit-equal):
              file shapes, finite values, B1 / B3 launches a sentence,
              card vs plain route, sentences/s over the 389-sentence table.
 27. misc_modules  every module of the JAX package off the agents' paths
              (rotary, xpos and masked attention; the block stacks at
              MDT-V's denoiser width in f32 and bf16; the other six encoders
              and decoders; every `ClipStyleProjection` style; position
              biases; time embeddings; `VoltronMAPEncoder`,
              `CLIPVisionTokens` and `VisionClipHead` of both families at 224
              px, B=32, bf16 towers), each against its plain route.
 28. loader_bench  `data/bench_loader.py` at its CLI's defaults over a
              1,000-frame synthetic split: frames path, shard scaling at 1,
              2 and 4 processes, `DevicePrefetcher` over the loader (pinned
              copies and `train_batch` on the card), embedding cache.
 29. reference_ckpt  (between checkpoint and evaluate_cli) a reference-format
              Lightning `.ckpt` (~1.75 GB, f32) written from a seeded
              `MDTVConfig()` net: its weights under the reference's module
              prefixes as the EMA callback's list, a perturbed copy as the
              raw `state_dict`, keys no converter reads, a `proprio_emb`
              head, `hyper_parameters` of a class whose module is gone when
              the file is read; `from_reference.main([ckpt, out])` in this
              process: seconds, the file's and the run's bytes, the
              report's counts (every key of the net read, the stand-ins
              ignored, `proprio_emb` dropped, nothing missing). The file is
              removed after, and the run's raw trainables are moved off
              its EMA, which evaluate_cli must restore. Fails past
              REFERENCE_LIMIT_S.

Then the kernel summary line, and last `{"ok": true, "device": ...}`. The
summary holds each kernel at its main shape, with its launches on every
path (B2 is on no annotator path: MiniLM's masked attention runs `sdpa`);
V1 (`attn_pair_grid`, main row Voltron bB=16) and V3 (`attn_pair_v3`,
main row Voltron bB=16 +mxu_sum +exp2) belong to the `attn_variants` path,
and the script fails if either was not launched there. Any failure raises
and exits non-zero; without a CUDA device it exits 1.

    python3 chip_smoke.py --replan-ab build/pr1 . . build/pr1

times the MDT-V B=1 eager replan of several trees of the port in turns on
one card instead: each argument is the root of a tree that holds an
`mdt_policy_tpu_torch` package (an older commit unpacked with `git archive`
into a directory that git ignores, or `.`), run in its own process in the
order given, since the packages share a name. Each builds the tree's
kernels and its `MDTVAgentNet(MDTVConfig())` with seeded random weights,
caches a text goal, times REPLANS_TREE_AB replans as `timing` does, and
profiles 5: device ms and events a replan, and the host operators with the
most self time. One JSON line a tree, then a summary line.

    python3 chip_smoke.py --halfblock-ab build/parent . . build/parent

does the same for B4 and B5: each tree's wrappers at HALFBLOCK_SHAPES
(event ms a call, each device kernel's ms and launches a call from the
profiler), F.linear at each of the call's GEMM shapes, and B1's device ms
at its two step shapes; one line a (kernel, shape), then a summary line.

    python3 chip_smoke.py --variants-ab build/parent . . build/parent

does the same for the microbench's kernels: each tree's V1 and V3 variants
(`tools.attn_kernel_experiment.variants`, `attn_kernel_round3.variants`) and
B1 at VARIANT_BATCHES' Voltron and CLIP vision shapes (event ms a call,
device ms from the profiler), and B1's device ms at its two step shapes;
one line a (tree, kernel, shape), then a summary line of the device ms.

    python3 chip_smoke.py --ddp-only

runs the device and build phases and then the ddp phase alone: on a
machine with two or more cards, 2 NCCL ranks of `train()` besides the
world-size-1 check, with each rank's step ms and the collectives' ms at 2
ranks.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import inspect
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, FLOP/s by dtype
# (f32 outside the tensor cores: no TF32 here)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# B1 (name, B, T, C, H, causal): the replan's shapes, the train step's at
# B=128 per stream (Voltron 256 images, CLIP vision 128, CLIP text 128
# goals), the training batch of the JAX package's benchmark, and the text
# tower over extraction's 512 sentences
KERNEL_SHAPES = (
    ("voltron", 2, 196, 384, 6, False),
    ("voltron_train", 256, 196, 384, 6, False),
    ("voltron_batch", 1024, 196, 384, 6, False),
    ("clip_text", 1, 77, 512, 8, True),
    ("clip_text_train", 128, 77, 512, 8, True),
    ("clip_text_extract", 512, 77, 512, 8, True),
    ("clip_vision", 2, 197, 768, 12, False),
    ("clip_vision_train", 128, 197, 768, 12, False),
)
# |kernel - plain| bounds. f32: both accumulate in f32 and differ only in
# summation order (~1e-6). bf16: the output is rounded to bf16 (8 significant
# bits, 3.9e-3 relative on values of order 1), and a probability can round
# to the neighbouring bf16 value when the two f32 scores differ in the last bit.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# B3 (function, name, rows, D): at one replan Voltron's RMSNorms and its
# encoder_norm (2 images), the CLIP text tower (one goal) and the CLIP vision
# tower (one goal image); Voltron's at the batched evaluation's B=32 replan
# (64 images); at one train scope Voltron (256 images), CLIP vision (128
# images x 197), CLIP text (128 goals x 77), the foresight decoder (128 x (4
# context + 98 patch tokens))
NORM_SHAPES = (
    ("rms", "voltron", 392, 384),
    ("ln", "voltron_encoder_norm", 392, 384),
    ("ln", "clip_text", 77, 512),
    ("ln", "clip_vision", 197, 768),
    ("rms", "voltron_b32", 12544, 384),
    ("ln", "voltron_encoder_norm_b32", 12544, 384),
    ("rms", "voltron_train", 50176, 384),
    ("ln", "clip_vision_train", 25216, 768),
    ("ln", "clip_text_train", 9856, 512),
    ("rms", "decoder_train", 13056, 192),
)
# B3 bounds relative to max(1, max|ref|): f32 summation order (~1e-6); bf16
# one rounding of the output (3.9e-3) and its neighbour when the f32 results
# differ in the last bit
NORM_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# B3's device times: readings of the kernel, PR 7's body and the library
# call in turns (and of a copy of x), each with warm inputs and with a cold
# L2 (a rotation of input copies whose calls between two uses of a copy
# move 2 x the H100's 50 MB of L2), calls a reading
NORM_READINGS, NORM_CALLS = 3, 20
L2_BYTES = 50e6
# Bound on the replan chunk, kernel path vs plain path, relative to
# max(1, max|chunk|): the towers are bf16, so a one-ulp difference in a token
# (3.9e-3 relative) can propagate through the perceiver (MDT-V) or the goal
# embedding (both families) into the f32 denoiser, whose B2 differs from its
# plain version by summation order only.
E2E_REL_TOL = 2e-2
# Bound on the train step's losses and grad_norm, kernel path vs plain path,
# relative to max(1, |value|): the same bf16 one-ulp differences in the
# frozen towers' outputs, averaged over 128 samples per scope.
TRAIN_E2E_REL_TOL = 2e-2
# per turn (4 turns) of the graph / eager timing and of the B2 / sdpa A/B, kept
# small so that the whole script stays well inside its time limit
REPLANS_TIMED = 30
REPLANS_AB = 10
REPLANS_TREE_AB = 100  # per tree of --replan-ab
# host-clock calls of a wrapper, with no synchronise, for its host cost
HOST_CALLS = 1000
# B2 (name, B, H, T, D, causal): the denoisers' self-attention at the
# replan's B=1 (MDT-V: 4-token encoder, 10-token causal decoder, D=48; MDT:
# 3-token encoder, causal decoder, D=64), the same at the batched rollout's
# B=32 and at the MDT validation step's B=128 (TRAIN_BATCH a scope; the
# encoder's 1024 rows of T=3 take the several-rows-a-block route), the
# sigma-token encoders' (the sigma token leads the sequence: T=5 for MDT-V,
# T=4 for MDT, once a denoiser call) at B=1 and B=32, and the four shapes of
# the JAX package's ops/bench_pallas.py
SMALL_SEQ_SHAPES = (
    ("mdtv_enc", 1, 8, 4, 48, False), ("mdtv_dec", 1, 8, 10, 48, True),
    ("mdt_enc", 1, 8, 3, 64, False), ("mdt_dec", 1, 8, 10, 64, True),
    ("mdtv_enc_b32", 32, 8, 4, 48, False), ("mdtv_dec_b32", 32, 8, 10, 48, True),
    ("mdt_enc_b32", 32, 8, 3, 64, False), ("mdt_dec_b32", 32, 8, 10, 64, True),
    ("mdt_enc_val", 128, 8, 3, 64, False), ("mdt_dec_val", 128, 8, 10, 64, True),
    ("mdtv_enc_sigma", 1, 8, 5, 48, False), ("mdt_enc_sigma", 1, 8, 4, 64, False),
    ("mdtv_enc_sigma_b32", 32, 8, 5, 48, False), ("mdt_enc_sigma_b32", 32, 8, 4, 64, False),
    ("bench_dec_T10", 1024, 8, 10, 48, True), ("bench_enc_T4", 1024, 8, 4, 48, False),
    ("bench_enc_T23", 1024, 8, 23, 48, False), ("bench_dec_T10_B4096", 4096, 8, 10, 48, True),
)
# B2 edge cases (name, B, H, T, D, causal, layout): one token; several rows
# a block (T <= 4 at many rows); the largest T and D; D not a multiple of
# the 16-byte vector (36: a vector of f32 but not of bf16; 50: of neither);
# inputs as the denoiser's (B, T, H, D) views ("bthd"), contiguous, with a
# last stride of 2 ("strided") or a base one element off 16 bytes
# ("misaligned"): the last two take the element-wise staging path
SMALL_SEQ_EDGES = (
    ("T1", 4, 8, 1, 48, True, "bthd"), ("T1_rows8", 512, 8, 1, 48, False, "contiguous"),
    ("T2_rows4", 200, 8, 2, 64, True, "bthd"),
    ("T32_D128", 3, 3, 32, 128, False, "contiguous"),
    ("T32_D128_causal", 2, 8, 32, 128, True, "bthd"),
    ("D128", 4, 8, 10, 128, True, "bthd"), ("D36", 4, 8, 10, 36, False, "bthd"),
    ("D50", 4, 8, 7, 50, True, "contiguous"),
    ("strided", 4, 8, 10, 48, True, "strided"),
    ("misaligned", 4, 8, 10, 48, False, "misaligned"),
    ("misaligned_T3", 64, 8, 3, 64, False, "misaligned"),
)
# |f32 B2 - float64 of its plain version| relative to max(1, max|ref|): f32
# rounding of q*scale, of a D-term sum, of exp and of a T-term sum, ~1e-6
SMALL_SEQ_F64_TOL = 1e-5
# rollout phase: CALVIN's camera sizes, chains and episode length, and the
# scripted oracle's step at which every task but one solves
ROLLOUT_CHAINS, ROLLOUT_EP_LEN, ROLLOUT_SOLVE_AT = 4, 360, 25
BATCHED_ENVS = 32
TRAIN_BATCH = 128  # per stream (configs/mdtv_calvin_d.yaml: batch_size)
TRAIN_STEPS_TIMED = 6
# Bound on the metrics of one more train step from a state and from its
# restored copy, relative to max(1, |value|). The two states are bit-equal
# and take the same draws, so the losses agree bit for bit; cuDNN's
# convolution backward and the backward's scatter-adds may sum in another
# order (f32 atomics), which moves grad_norm and the new parameters' norm by
# f32 roundings (~1e-7 relative), 1000x under this bound.
CHECKPOINT_STEP_REL_TOL = 1e-4
EVAL_CHAINS = 4  # evaluate_cli: chains of the fake-env evaluation a family
REFERENCE_SEED = 16  # reference_ckpt: the seed of the net its file is written from
REFERENCE_LIMIT_S = 40  # reference_ckpt: its bound on the phase's seconds
# the module of the reference file's pickled `hyper_parameters` class: it is
# registered only while the file is written, as Lightning is on no machine here
REFERENCE_HPARAMS_MODULE = "reference_lightning_hparams"
# B4/B5 (kernel, tower, B, T, C, heads or hidden width): extraction at batch
# 64 (Voltron 128 images: both cameras in one call; CLIP vision 64) and the
# text tower over 512 annotation sentences
HALFBLOCK_SHAPES = (
    ("b4", "voltron", 128, 196, 384, 6), ("b5", "voltron", 128, 196, 384, 1536),
    ("b4", "clip_vision", 64, 197, 768, 12), ("b5", "clip_vision", 64, 197, 768, 3072),
    ("b4", "clip_text", 512, 77, 512, 8), ("b5", "clip_text", 512, 77, 512, 2048),
)
# (norm, eps, LayerScale, causal, activation) of each tower's blocks
TOWER_BLOCKS = {"voltron": ("rms", 1e-8, True, False, "swishglu"),
                "clip_vision": ("ln", 1e-5, False, False, "quickgelu"),
                "clip_text": ("ln", 1e-5, False, True, "quickgelu")}
# device kernels per half-block call: B4 norm pass, qkv GEMM, attention core,
# projection GEMM; B5 norm pass, W1 GEMM, W2 GEMM
HALFBLOCK_KERNELS_PER_CALL = {"b4": 4, "b5": 3}
PROFILE_TRIES = 3  # profiler windows before a kernel count that comes up short fails
# B4/B5 bounds relative to max(1, max|ref|). Against the plain version in
# bf16, which rounds at the same points: two bf16 ulps (7.8e-3 each at the
# top of a binade: the output's own rounding and a flip of the branch before
# the residual add). Against float64 of the plain version from the same bf16
# inputs: the chain of bf16 roundings, 6.3e-3 at worst when the plain bf16
# version is held against float64 on the CPU at these widths, with 3x margin.
HALFBLOCK_TOL = {"plain": 1.6e-2, "float64": 2e-2}
EXTRACT_FRAMES = 512
EXTRACT_BATCH = 64  # extract_embeddings' default
EXTRACT_SENTENCES = 512
# Bound on the cached tokens and goal embeddings (B4 + B5 route) against the
# B1 + B3 route on the same frames, relative to max(1, max|ref|): the routes
# round at other points (B4/B5 divide by the RMS norm and multiply g in
# bf16, B3 rounds once; B4/B5 add the bias after rounding the product,
# cuBLAS before), a few bf16 ulps (3.9e-3 relative each) through 12 blocks;
# the bf16 tower bound of the port's CPU tests (5e-2).
EXTRACT_ROUTE_TOL = 5e-2
# train_cli / extract_cli: a synthetic split of CALVIN_EPISODES episodes of
# CALVIN_EPISODE_LEN frames (237 windows of 21 frames: one batch of 128 a
# loader epoch), CLI_STEPS_PER_EPOCH steps an epoch; the bound on every
# trainable and EMA tensor of a run resumed at epoch 2 against one never
# interrupted, relative to the tensor's max |value|
CALVIN_EPISODES, CALVIN_EPISODE_LEN = 3, 100
CLI_STEPS_PER_EPOCH = 3
RESUME_REL_TOL = 1e-4
# attention-variant microbench (V1, V3): the JAX tools' default batches
# (Voltron images, CLIP vision images) and chain depth
VARIANT_BATCHES = (1024, 512)
VARIANT_LAYERS = 12
# |V1/V3 - plain| bound relative to max(1, max|ref|): both round the
# probabilities (or e) and the output to bf16 at the same points; one bf16
# ulp of an O(1) output (3.9e-3) plus a flipped probability, the CPU tests'
# bound against the Pallas kernels
VARIANT_TOL = 2e-2


def small_seq_bound(dtype_name: str, ref, v) -> float:
    """|B2 - plain| bound. f32: summation order only, 1e-5 relative to
    max(1, max|ref|). bf16: one bf16 ulp of the largest output (2^-7
    relative at the top of its binade) plus one flipped rounding of a
    probability (2^-8) times the largest |v|."""
    amax = max(1.0, ref.float().abs().max().item())
    if dtype_name == "float32":
        return 1e-5 * amax
    return 2.0 ** -7 * amax + 2.0 ** -8 * v.float().abs().max().item()


def small_seq_inputs(torch, B, H, T, D, layout, dtype, gen, device):
    """q, k, v (B, H, T, D) in one of SMALL_SEQ_EDGES' layouts."""
    def one():
        if layout == "bthd":
            return torch.randn((B, T, H, D), generator=gen, device=device).to(dtype) \
                .transpose(1, 2)
        if layout == "strided":
            return torch.randn((B, H, T, 2 * D), generator=gen, device=device).to(dtype) \
                [..., ::2]
        if layout == "misaligned":
            flat = torch.randn((B * H * T * D + 1,), generator=gen, device=device).to(dtype)
            return flat[1:].view(B, H, T, D)
        return torch.randn((B, H, T, D), generator=gen, device=device).to(dtype)
    return one(), one(), one()


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's row also carries the script's elapsed
    seconds, so that each phase's share of the run's time limit shows."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def event_ms(fn, iters: int, torch) -> float:
    """Mean milliseconds per call of `fn` on the card, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, torch, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of `fn` over `calls` calls with no
    synchronise between them: what a launch costs the host, where the
    device's time per call is the shorter (else the full launch queue
    holds the host back and this reads the device's pace)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def device_ms(fn, kernel_name: str, iters: int, torch):
    """Mean device time per launch of the kernels whose name holds
    `kernel_name`, from torch.profiler over `iters` calls: the kernel's own
    time, which the event times above hide where the host's per-call cost
    is the larger. None when the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in _device_events(torch, prof)
             if kernel_name in e.name]
    return sum(times) / len(times) / 1e3 if times else None


def call_device_ms(fn, iters: int, torch):
    """Mean device time per call of `fn`: every kernel, copy and set it runs
    on the card, from torch.profiler over `iters` calls (a library call may
    launch several kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in _device_events(torch, prof)) / iters / 1e3


def bound_ms(n_bytes: float, flops: float, dtype_name: str):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    traffic over HBM bandwidth and the operations over the dtype's peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    print(smi, flush=True)
    # f32 matmuls and the f32 patch conv must run in full f32, not TF32,
    # or the f32 checks drift by TF32 rounding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    """One nvcc per source, all started together."""
    from mdt_policy_tpu_torch.ops import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))

    def build(name):
        t0 = time.perf_counter()
        _build.load_library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        seconds = dict(zip(names, pool.map(build, names)))
    total = time.perf_counter() - t0
    emit({"phase": "build", "kernels": seconds, "seconds": total})
    return total


def _sdpa_views(qkv, H, torch):
    """q, k, v of the packed (B, T, 3C) qkv as contiguous (B, H, T, dh)."""
    B, T, C3 = qkv.shape
    q, k, v = qkv.view(B, T, 3, H, C3 // (3 * H)).permute(2, 0, 3, 1, 4)
    return q.contiguous(), k.contiguous(), v.contiguous()


def phase_kernel_b1(torch, device):
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import (
        _sm90_body, fused_qkv_attention, fused_qkv_attention_reference)
    gen = torch.Generator(device).manual_seed(0)
    rows = []
    for name, B, T, C, H, causal in KERNEL_SHAPES:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            qkv = torch.randn((B, T, 3 * C), generator=gen, device=device).to(dtype)
            out = fused_qkv_attention(qkv, H, causal)
            ref = fused_qkv_attention_reference(qkv, H, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            iters = 20 if B > 64 else 200
            ms = event_ms(lambda: fused_qkv_attention(qkv, H, causal), iters, torch)
            plain_ms = event_ms(lambda: fused_qkv_attention_reference(qkv, H, causal),
                                iters, torch)

            def library():  # the same function from the same packed input
                y = F.scaled_dot_product_attention(*_sdpa_views(qkv, H, torch),
                                                   is_causal=causal)
                return y.transpose(1, 2).reshape(B, T, C)
            views = _sdpa_views(qkv, H, torch)
            library_ms = event_ms(library, iters, torch)
            sdpa_only_ms = event_ms(lambda: F.scaled_dot_product_attention(
                *views, is_causal=causal), iters, torch)
            pairs = T * (T + 1) // 2 if causal else T * T
            bms, by = bound_ms(qkv.numel() * qkv.element_size() * 4 / 3,
                               4 * B * H * pairs * (C // H), dtype_name)
            row = {"phase": "kernel", "kernel": "fused_qkv_attention",
                   "shape": name, "qkv": [B, T, 3 * C], "heads": H,
                   "causal": causal, "dtype": dtype_name,
                   "body": "sm90" if _sm90_body(dtype, T, C, H) else "mha_core",
                   "max_abs_err": err,
                   "tol": KERNEL_TOL[dtype_name], "ms": ms,
                   "host_us": host_us(lambda: fused_qkv_attention(qkv, H, causal), torch,
                                      HOST_CALLS if B <= 64 else 100),
                   "device_ms": device_ms(lambda: fused_qkv_attention(qkv, H, causal),
                                          "fused_qkv_attention_kernel", 10, torch),
                   "plain_ms": plain_ms,
                   "library_ms": library_ms, "sdpa_only_ms": sdpa_only_ms,
                   "bound_ms": bms, "bound_by": by}
            emit(row)
            if not err <= KERNEL_TOL[dtype_name]:
                raise AssertionError(f"B1 disagrees with its plain version: {row}")
            rows.append(row)
    return rows


def pr7_norm():
    """The C functions (LayerNorm, RMSNorm) of B3's body as PR 7 left it
    (`csrc/baseline/fused_norm_pr7.cu`: one warp a row, the weights loaded
    after the reduction, a division an element), for the B3 phase's A/B."""
    import ctypes
    from mdt_policy_tpu_torch.ops import _build
    lib = _build.load_library("fused_norm_pr7", _build.CSRC / "baseline")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mdt_fused_layer_norm.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong, i, f, i, ptr]
    lib.mdt_fused_rms_norm.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, i, f, i, ptr]
    return lib.mdt_fused_layer_norm, lib.mdt_fused_rms_norm


def raw_norm(torch, fns, x, w, b, eps, out=None):
    """One launch of a B3 body's C function (`fns`: LayerNorm, RMSNorm; b
    None for RMSNorm) on (rows, D) x, without the wrapper's checks or launch
    count: `out`, or a new output."""
    from mdt_policy_tpu_torch.ops import _build
    out = torch.empty_like(x) if out is None else out
    tail = (x.shape[0], x.shape[1], eps, int(x.dtype is torch.bfloat16),
            _build.current_stream(x))
    rc = fns[1](x.data_ptr(), w.data_ptr(), out.data_ptr(), *tail) if b is None \
        else fns[0](x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"a B3 body's launch failed with error {rc}")
    return out


def norm_device_readings(torch, calls, copies: int):
    """Device ms a call of each of `calls` ({label: (call(i) on input copy i,
    device kernel name or None for the library call)}), NORM_READINGS
    readings of each, warm (copy 0 every call) and cold (the copies in
    turn, one rotation shared by every label, so that a call's copy was last
    read `copies` - 1 calls before); the labels run in turns, NORM_CALLS
    calls a label, in one profiler window a reading. A label with a kernel
    name reads the mean duration of its kernels; the library call, every
    other device event over its calls. Each output is kept until its copy
    comes round again, so the writes rotate too."""
    from torch.profiler import ProfilerActivity, profile
    outs, turn = [None] * copies, [0]

    def run(call, cold):
        if cold:
            turn[0] = (turn[0] + 1) % copies
        i = turn[0] if cold else 0
        outs[i] = call(i)

    labels = list(calls)
    for label in labels:  # warm-up
        run(calls[label][0], False)
    readings = {(label, cold): [] for label in labels for cold in (False, True)}
    for k in range(NORM_READINGS):
        for cold in (False, True):
            order = labels if k % 2 == 0 else labels[::-1]
            names = [calls[label][1] for label in labels if calls[label][1]]
            for _ in range(PROFILE_TRIES):  # a window that lost a kernel's events
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for label in order:
                        for _ in range(NORM_CALLS):
                            run(calls[label][0], cold)
                    torch.cuda.synchronize()
                events = _device_events(torch, prof)
                if all(any(n in e.name for e in events) for n in names):
                    break
            for label in labels:
                name = calls[label][1]
                if name:
                    mine = [e.time_range.elapsed_us() for e in events if name in e.name]
                    ms = sum(mine) / len(mine) / 1e3 if mine else None
                else:
                    rest = [e.time_range.elapsed_us() for e in events
                            if not any(n in e.name for n in names)]
                    ms = sum(rest) / NORM_CALLS / 1e3
                readings[(label, cold)].append(ms)
    return readings


def phase_kernel_b3(torch, device):
    """B3 against its plain version at NORM_SHAPES in bf16 and f32, and
    PR 7's body beside it; the launch plan of each shape; event ms of the
    kernel, the plain version and the library call (F.layer_norm,
    F.rms_norm), the wrapper's host µs, and the device ms of the kernel, PR
    7's body, the library call and a copy of x (`x.clone()`: the same bytes,
    no arithmetic) from `norm_device_readings`, warm and cold, with the cold
    reading's share of the bound; and the host's µs a launch of either body
    through its C function alone (`raw_host_us`, `pr7_raw_host_us`)."""
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.ops import fused_norm
    from mdt_policy_tpu_torch.ops.fused_norm import (
        fused_layer_norm, fused_layer_norm_reference, fused_rms_norm,
        fused_rms_norm_reference, launch_plan)
    bodies = {"": fused_norm._kernels()[:2], "pr7_": pr7_norm()}
    gen = torch.Generator(device).manual_seed(1)
    rows = []
    for kind, name, n, D in NORM_SHAPES:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            n_weights = 2 if kind == "ln" else 1
            call_bytes = (2 * n + n_weights) * D * dtype.itemsize
            copies = int(np.ceil(2 * L2_BYTES / call_bytes)) + 1
            xs = (torch.randn((copies, n, D), generator=gen, device=device) * 3).to(dtype)
            ws = torch.randn((copies, D), generator=gen, device=device).to(dtype)
            bs = torch.randn((copies, D), generator=gen, device=device).to(dtype)
            x, w, b = xs[0], ws[0], bs[0]
            eps = 1e-5 if kind == "ln" else 1e-8
            if kind == "ln":
                fn = "fused_layer_norm"
                kernel = lambda i: fused_layer_norm(xs[i], ws[i], bs[i], eps)
                plain = lambda: fused_layer_norm_reference(x, w, b, eps)
                library = lambda i: F.layer_norm(xs[i], (D,), ws[i], bs[i], eps)
            else:
                fn = "fused_rms_norm"
                kernel = lambda i: fused_rms_norm(xs[i], ws[i], eps)
                plain = lambda: fused_rms_norm_reference(x, w, eps)
                # eps sits inside the square root there: the same work, not
                # quite the same function
                library = lambda i: F.rms_norm(xs[i], (D,), ws[i], eps)
            b_or_none = (lambda i: bs[i]) if kind == "ln" else (lambda i: None)
            old = lambda i: raw_norm(torch, bodies["pr7_"], xs[i], ws[i], b_or_none(i), eps)
            # the host's cost of a launch of either body alone, in turns
            raw = {label: (lambda fns=fns, out=torch.empty_like(x):
                           raw_norm(torch, fns, x, w, b_or_none(0), eps, out))
                   for label, fns in bodies.items()}
            raw_us = {label: [] for label in raw}
            for label in ("", "pr7_", "pr7_", ""):
                raw_us[label].append(host_us(raw[label], torch))
            out, ref = kernel(0), plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            bound = NORM_TOL[dtype_name] * max(1.0, ref.float().abs().max().item())
            iters = 200
            bms, by = bound_ms(call_bytes, 8 * n * D, dtype_name)
            readings = norm_device_readings(
                torch, {"": (kernel, "fused_norm_kernel"), "pr7_": (old, "fused_norm_pr7_kernel"),
                        "library_": (library, None)}, copies)
            # a copy of x moves the same bytes and computes nothing
            readings.update(norm_device_readings(
                torch, {"copy_": (lambda i: xs[i].clone(), None)}, copies))
            timed = {}
            for (label, cold), values in readings.items():
                key = f"{label}device_ms{'_cold' if cold else ''}"
                timed[key] = float(np.median(values)) if None not in values else None
                timed[f"{key}_readings"] = values
            row = {"phase": "kernel", "kernel": fn, "shape": name, "x": [n, D],
                   "dtype": dtype_name, "plan": launch_plan(n, D, dtype),
                   "max_abs_err": err, "bound": bound,
                   "pr7_max_abs_err": (old(0).float() - ref.float()).abs().max().item(),
                   "ms": event_ms(lambda: kernel(0), iters, torch),
                   "host_us": host_us(lambda: kernel(0), torch),
                   **{f"{label}raw_host_us": float(np.mean(us)) for label, us in raw_us.items()},
                   **timed,
                   "plain_ms": event_ms(plain, iters, torch),
                   "library_ms": event_ms(lambda: library(0), iters, torch),
                   "cold_copies": copies, "bound_ms": bms, "bound_by": by,
                   "bound_share_cold": (bms / timed["device_ms_cold"]
                                        if timed["device_ms_cold"] else None),
                   "pr7_bound_share_cold": (bms / timed["pr7_device_ms_cold"]
                                            if timed["pr7_device_ms_cold"] else None),
                   "copy_bound_share_cold": bms / timed["copy_device_ms_cold"]}
            emit(row)
            if not err <= bound:
                raise AssertionError(f"B3 disagrees with its plain version: {row}")
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


def phase_kernel_b2(torch, device):
    """B2 against its plain version on the transposed (B, T, H, D) views the
    denoisers pass, at SMALL_SEQ_SHAPES in f32 and bf16 (f32 also against
    the plain version in float64), with the times of the kernel, its device
    kernel, the plain version and F.scaled_dot_product_attention."""
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha, small_seq_mha_reference
    gen = torch.Generator(device).manual_seed(2)
    rows = []
    for name, B, H, T, D, causal in SMALL_SEQ_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q, k, v = (torch.randn((B, T, H, D), generator=gen, device=device).to(dtype)
                       .transpose(1, 2) for _ in range(3))
            out = small_seq_mha(q, k, v, causal)
            ref = small_seq_mha_reference(q, k, v, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            bound = small_seq_bound(dtype_name, ref, v)
            iters = 50 if B >= 1024 else 200
            pairs = T * (T + 1) // 2 if causal else T * T
            bms, by = bound_ms(4 * q.numel() * q.element_size(), 4 * B * H * pairs * D,
                               dtype_name)
            row = {"phase": "kernel", "kernel": "small_seq_mha", "shape": name,
                   "q": [B, H, T, D], "causal": causal, "dtype": dtype_name,
                   "max_abs_err": err, "bound": bound,
                   "ms": event_ms(lambda: small_seq_mha(q, k, v, causal), iters, torch),
                   "host_us": host_us(lambda: small_seq_mha(q, k, v, causal), torch),
                   "device_ms": device_ms(lambda: small_seq_mha(q, k, v, causal),
                                          "small_seq_mha_kernel", 20, torch),
                   "plain_ms": event_ms(lambda: small_seq_mha_reference(q, k, v, causal),
                                        iters, torch),
                   "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal), iters, torch),
                   "library_device_ms": call_device_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal), 20, torch),
                   "bound_ms": bms, "bound_by": by}
            if dtype_name == "float32":
                f64 = small_seq_mha_reference(q.double(), k.double(), v.double(), causal)
                row["max_abs_err_float64"] = (out.double() - f64).abs().max().item()
                row["bound_float64"] = SMALL_SEQ_F64_TOL * max(1.0, f64.abs().max().item())
            emit(row)
            if not (err <= bound and
                    row.get("max_abs_err_float64", 0.0) <= row.get("bound_float64", 0.0)):
                raise AssertionError(f"B2 disagrees with its plain version: {row}")
            rows.append(row)
    return rows


# B6 at a B=1 replan of each family: width, heads, decoder blocks, context
# tokens (MDT-V: the goal and 3 perceiver latents; MDT: the goal and 2
# cameras); its bound against the plain version relative to max(1, max|ref|)
# (f32 sums of up to 2,048 products in another order), and each launch's
# count a DDIM-10 replan (call: once a denoiser call; block: once a decoder
# block and call; enc: once an encoder block, 4 in both families)
B6_FAMILIES = {"mdtv": (384, 8, 4, 4), "mdt": (512, 8, 6, 3)}
B6_TOL = 1e-5
B6_USES = {"adaln": "call", "qkv_kv": "block", "proj_gate": "block",
                 "cross_q": "block", "cross_attend_proj": "block", "fc_gelu": "block",
                 "mlp_proj_gate": "block", "enc_qkv": "enc", "enc_proj": "enc",
                 "enc_fc": "enc", "enc_mlp_proj": "enc"}
B6_ITERS = 200


def b6_cases(torch, C, H, L, tk, device, gen):
    """One of each B6 launch of a B=1 replan at width C (10 action tokens
    over tk context tokens, the encoder's tk rows), as (name, gemms)."""
    import torch.nn as nn
    from mdt_policy_tpu_torch.ops.few_row_linear import Attend, Gemm, Norm
    draw = lambda *shape: torch.randn(shape, generator=gen, device=device)

    def lin(N, K, bias=True):
        layer = nn.Linear(K, N, bias=bias, device=device).requires_grad_(False)
        layer.weight.copy_(draw(N, K) * K ** -0.5)
        if bias:
            layer.bias.copy_(draw(N) * 0.1)
        return layer
    T = 10
    x, c, ctx, y, h, e = draw(T, C), draw(1, C), draw(tk, C), draw(T, C), draw(T, 4 * C), \
        draw(tk, C)
    mod = draw(1, 6 * C)
    shift, scale, gate = mod[:, :C], mod[:, C:2 * C], mod[:, 2 * C:3 * C]
    ln = Norm(1 + 0.1 * draw(C), None, 1e-5, shift, scale)
    ln3 = Norm(1 + 0.1 * draw(C), 0.1 * draw(C), 1e-6)
    plain_ln = Norm(ln.weight, None, 1e-5)
    qkv = lambda: (lin(C, C), lin(C, C), lin(C, C))
    return [
        ("adaln", [Gemm(c, (lin(6 * C, C),), "silu") for _ in range(L)]),
        ("qkv_kv", [Gemm(x, qkv(), ln, per=T), Gemm(ctx, (lin(C, C), lin(C, C)))]),
        ("proj_gate", [Gemm(y, (lin(C, C, False),), residual=x, gate=gate, per=T)]),
        ("cross_q", [Gemm(x, (lin(C, C),), ln3)]),
        ("cross_attend_proj", [Gemm(None, (lin(C, C, False),),
                                    Attend(y, draw(tk, 2 * C), H, 1, True), residual=x)]),
        ("fc_gelu", [Gemm(x, (lin(4 * C, C, False),), ln, gelu=True, per=T)]),
        ("mlp_proj_gate", [Gemm(h, (lin(C, 4 * C, False),), residual=x, gate=gate, per=T)]),
        ("enc_qkv", [Gemm(e, qkv(), plain_ln)]),
        ("enc_proj", [Gemm(e, (lin(C, C, False),), residual=e)]),
        ("enc_fc", [Gemm(e, (lin(4 * C, C, False),), plain_ln, gelu=True)]),
        ("enc_mlp_proj", [Gemm(draw(tk, 4 * C), (lin(C, 4 * C, False),), residual=e)])]


def b6_bytes_flops(gemms):
    """Bytes each B6 launch must move (weights, biases, input rows and their
    norm and modulation rows, outputs, residuals and gates, each once) and
    its FLOPs (2 M N K, and the attention's 4 M tk C)."""
    n_bytes, flops = 0, 0
    for g in gemms:
        pro = g.prologue
        x = pro.q if g.x is None else g.x
        M, K = x.shape
        N = sum(layer.weight.shape[0] for layer in g.layers)
        n_bytes += 4 * (N * K + M * K + M * N)
        n_bytes += sum(4 * layer.bias.numel() for layer in g.layers if layer.bias is not None)
        for t in (g.residual, g.gate, getattr(pro, "kv", None), getattr(pro, "shift", None),
                  getattr(pro, "scale", None), getattr(pro, "weight", None),
                  getattr(pro, "bias", None)):
            n_bytes += 0 if t is None else 4 * t.numel()
        flops += 2 * M * N * K
        if g.x is None:
            flops += 4 * M * (pro.kv.shape[0] // pro.batch) * K
    return n_bytes, flops


def phase_kernel_b6(torch, device):
    """B6 at each of its launches of a B=1 replan of both families
    (`b6_cases`) against its plain version, with the CUDA-event ms of the
    kernel, of the plain version (the per-op route: the norm, modulation,
    GEMM, activation and residual operators the blocks ran before) and of
    cuBLAS alone over the same layers (`F.linear`), each one's device ms
    from the profiler, the wrapper's host µs a call, the bound, and the
    launch's count a replan."""
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.ops.few_row_linear import few_row_linear, few_row_linear_reference
    gen = torch.Generator(device).manual_seed(6)
    rows = []
    for family, (C, H, L, tk) in B6_FAMILIES.items():
        per_use = {"call": 10, "block": 10 * L, "enc": 4}
        with torch.no_grad():
            for name, gemms in b6_cases(torch, C, H, L, tk, device, gen):
                kernel = lambda: few_row_linear(*gemms)
                plain = lambda: few_row_linear_reference(*gemms)
                library = lambda: [F.linear(g.x if g.x is not None else g.prologue.q,
                                            layer.weight, layer.bias)
                                   for g in gemms for layer in g.layers]
                before = few_row_linear.launches
                outs = kernel()
                torch.cuda.synchronize()
                launched = few_row_linear.launches - before
                refs = plain()
                err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
                bound = B6_TOL * max(1.0, max(r.abs().max().item() for r in refs))
                n_bytes, flops = b6_bytes_flops(gemms)
                bms, by = bound_ms(n_bytes, flops, "float32")
                g0 = gemms[0]
                row = {"phase": "kernel", "kernel": "few_row_linear", "family": family,
                       "shape": f"{family}_{name}", "dtype": "float32",
                       "rows": [(g.x if g.x is not None else g.prologue.q).shape[0]
                                for g in gemms],
                       "k": (g0.x if g0.x is not None else g0.prologue.q).shape[1],
                       "n": [sum(layer.weight.shape[0] for layer in g.layers) for g in gemms],
                       "max_abs_err": err, "bound": bound,
                       "ms": event_ms(kernel, B6_ITERS, torch),
                       "host_us": host_us(kernel, torch),
                       "device_ms": next(filter(None, (
                           device_ms(kernel, "few_row_linear_kernel", 20, torch)
                           for _ in range(PROFILE_TRIES))), None),
                       "plain_ms": event_ms(plain, B6_ITERS, torch),
                       "plain_device_ms": call_device_ms(plain, 20, torch),
                       "library_ms": event_ms(library, B6_ITERS, torch),
                       "library_device_ms": call_device_ms(library, 20, torch),
                       "bound_ms": bms, "bound_by": by, "launches_per_call": launched,
                       "per_replan": per_use[B6_USES[name]]}
                emit(row)
                if not (err <= bound and launched == 1):
                    raise AssertionError(f"B6 disagrees with its plain version: {row}")
                rows.append(row)
    for family in B6_FAMILIES:
        mine = [r for r in rows if r["family"] == family]
        emit({"phase": "kernel_b6_replan", "family": family,
              "launches": sum(r["per_replan"] for r in mine),
              **{f"{k}_per_replan": sum(r["per_replan"] * (r[k] or 0.0) for r in mine)
                 for k in ("device_ms", "plain_device_ms", "library_device_ms")}})
    return rows


def phase_b6_ab(torch, net, device, smi, family: str, batch: int = 1):
    """The graph replan at `batch` envs with B6's route and with the per-op
    route (the graph captured under a patch that turns the route off), in
    turns (B6, per-op, per-op, B6) of REPLANS_TIMED replans each, from one
    seed: the two actions' largest relative gap, p50/p90, and 5 replans of
    each under the profiler (device ms and events a replan, the costliest
    kernels)."""
    from mdt_policy_tpu_torch.models import blocks
    from mdt_policy_tpu_torch.ops.few_row_linear import few_row_linear
    with mock.patch.object(blocks, "_few_rows", lambda *a, **k: False):
        per_op, _, _ = replanner(torch, net, batch, device, seed=24)
    b6, _, _ = replanner(torch, net, batch, device, seed=24)
    gaps = []
    for _ in range(3):
        a, b = per_op(), b6()
        gaps.append(((a - b).abs().max() / a.abs().max()).item())
    before = few_row_linear.launches
    b6()
    per_replan = few_row_linear.launches - before
    routes = {"b6": b6, "per_op": per_op}
    times = {"b6": [], "per_op": []}
    for route in ("b6", "per_op", "per_op", "b6"):
        times[route] += event_times(torch, routes[route], REPLANS_TIMED)
    prof = {r: profile_calls(torch, fn, 5) for r, fn in routes.items()}
    row = {"phase": "b6_ab", "family": family, "batch": batch,
           "replans_per_route": len(times["b6"]), "action_rel_gap": gaps,
           "b6_launches_per_replan": per_replan,
           **{f"replan_ms_p50_{r}": float(np.percentile(t, 50)) for r, t in times.items()},
           **{f"replan_ms_p90_{r}": float(np.percentile(t, 90)) for r, t in times.items()},
           **{f"device_ms_per_replan_{r}": p["device_ms_per_call"] for r, p in prof.items()},
           **{f"device_events_per_replan_{r}": p["device_events_per_call"]
              for r, p in prof.items()},
           "top_kernels_b6": prof["b6"]["top_kernels_ms_per_call"],
           "top_kernels_per_op": prof["per_op"]["top_kernels_ms_per_call"], "card": smi}
    emit(row)
    return row


def phase_kernel_b2_edges(torch, device):
    """B2 against its plain version at SMALL_SEQ_EDGES in f32 and bf16, and
    the f32 kernel against the plain version in float64."""
    from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha, small_seq_mha_reference
    gen = torch.Generator(device).manual_seed(5)
    rows = []
    for name, B, H, T, D, causal, layout in SMALL_SEQ_EDGES:
        for dtype_name in ("float32", "bfloat16"):
            q, k, v = small_seq_inputs(torch, B, H, T, D, layout, getattr(torch, dtype_name),
                                       gen, device)
            out = small_seq_mha(q, k, v, causal)
            ref = small_seq_mha_reference(q, k, v, causal)
            torch.cuda.synchronize()
            row = {"phase": "kernel_edges", "kernel": "small_seq_mha", "shape": name,
                   "q": [B, H, T, D], "causal": causal, "layout": layout,
                   "dtype": dtype_name,
                   "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                   "bound": small_seq_bound(dtype_name, ref, v),
                   "out_layout_bthd": out.transpose(1, 2).is_contiguous()}
            if dtype_name == "float32":
                f64 = small_seq_mha_reference(q.double(), k.double(), v.double(), causal)
                row["max_abs_err_float64"] = (out.double() - f64).abs().max().item()
                row["bound_float64"] = SMALL_SEQ_F64_TOL * max(1.0, f64.abs().max().item())
            emit(row)
            if not (row["max_abs_err"] <= row["bound"] and row["out_layout_bthd"]
                    and row.get("max_abs_err_float64", 0.0) <= row.get("bound_float64", 0.0)):
                raise AssertionError(f"B2 disagrees with its plain version: {row}")
            rows.append(row)
    return rows


def phase_attn_variants(torch, device, launches: Launches, smi):
    """The attention-variant microbench: `run()` of both port tools
    (`tools/attn_kernel_experiment.py`, V1, and `tools/attn_kernel_round3.py`,
    V3) at their default batches, 12-layer chains per variant, counting the
    launches of that run; every chain must launch its kernel once a layer.
    Then each V1/V3 variant against its plain version on the card at the
    same shapes, with its kernel, device, plain and SDPA times beside the
    chain's per-layer time and B1's, its bytes bound, and the registers and
    local-memory bytes (spills) a thread of its instantiation. One JSON line
    per (variant, shape)."""
    from mdt_policy_tpu_torch.ops.pair_attention import kernel_attributes
    from mdt_policy_tpu_torch.tools import attn_kernel_experiment, attn_kernel_round3, perf_probe
    tools = (attn_kernel_experiment, attn_kernel_round3)
    launches.reset()
    runs = [r for tool in tools for r in tool.run(*VARIANT_BATCHES, device=device,
                                                  n_layers=VARIANT_LAYERS)]
    torch.cuda.synchronize()
    counts = launches.read()
    short = [(r["tool"], r["case"], r["variant"], r["launches_per_chain"]) for r in runs
             if r["launches_per_chain"] != VARIANT_LAYERS]
    if short:
        raise AssertionError(f"microbench chains without one launch a layer: {short}")
    by_key = {(r["tool"], r["case"], r["variant"]): r for r in runs}
    b1 = {(r["tool"], r["case"]): r["ms_per_layer"] for r in runs
          if r["kernel"] == "fused_qkv_attention"}
    name_of = {fn: name for name, fn in launches.fns.items()}
    gen = torch.Generator(device).manual_seed(3)
    rows = []
    for case, shape, H in perf_probe.cases(*VARIANT_BATCHES):
        B, T, C3 = shape
        C = C3 // 3
        qkv = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        library_ms = event_ms(lambda: perf_probe.sdpa_packed(qkv, H), 20, torch)
        library_device = call_device_ms(lambda: perf_probe.sdpa_packed(qkv, H), 10, torch)
        bms, by = bound_ms(4 * B * T * C * qkv.element_size(), 4.0 * B * T * T * C,
                           "bfloat16")
        for tool in tools:
            for v in tool.variants(H):
                kernel = name_of[v.fn.kernel]
                if kernel == "fused_qkv_attention":  # B1 is checked in its own phase
                    continue
                run = by_key[(tool.__name__.rsplit(".", 1)[-1], case, v.name)]
                options = {k: getattr(v.fn, "options", {}).get(k, False)
                           for k in ("exp2", "mxu_sum", "no_max", "bf16_softmax")}
                out, ref = v.fn(qkv), v.fn.plain(qkv)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                row = {"phase": "attn_variants", "kernel": kernel, "tool": run["tool"],
                       "case": case, "variant": v.name, "shape": f"{case}: {v.name}",
                       "qkv": list(shape), "heads": H, "dtype": "bfloat16",
                       "max_abs_err": err,
                       "bound": VARIANT_TOL * max(1.0, ref.float().abs().max().item()),
                       "err_vs_einsum": run["err_vs_einsum"],
                       "ms": event_ms(lambda: v.fn(qkv), 20, torch),
                       "ms_per_layer": run["ms_per_layer"],
                       "device_ms": device_ms(lambda: v.fn(qkv), f"{kernel}_kernel", 10, torch),
                       "bound_ms": bms, "bound_by": by,
                       "plain_ms": event_ms(lambda: v.fn.plain(qkv), 5, torch),
                       "library_ms": library_ms, "library_device_ms": library_device,
                       "sdpa_ms_per_layer": run["sdpa_ms_per_layer"],
                       "b1_ms_per_layer": b1[(run["tool"], case)],
                       "tflops": run["tflops"], "vs_b1": run["vs_production"],
                       "launches_per_chain": run["launches_per_chain"],
                       **kernel_attributes(v.fn.kernel, T, **options), "card": smi}
                emit(row)
                if not (bool(torch.isfinite(out).all()) and err <= row["bound"]):
                    raise AssertionError(f"{kernel} disagrees with its plain version: {row}")
                rows.append(row)
    return rows, counts


def make_inputs(torch, cfg, batch: int, seed: int, device):
    """Camera frames (B, 1, H, W, 3) and a 77-token goal whose EOT id is its
    largest, drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    static = torch.randn((batch, 1, cfg.img_size, cfg.img_size, 3), generator=gen)
    gripper = torch.randn((batch, 1, 84, 84, 3), generator=gen)
    obs = {"rgb_static": static.to(device), "rgb_gripper": gripper.to(device)}
    return obs, {"lang_tokens": make_tokens(torch, cfg, batch, gen).to(device)}


def make_tokens(torch, cfg, batch: int, gen):
    tokens = torch.zeros((batch, cfg.clip_context_length), dtype=torch.long)
    tokens[:, 0] = cfg.clip_vocab_size - 2  # start-of-text
    tokens[:, 1:9] = torch.randint(1, cfg.clip_vocab_size - 2, (batch, 8), generator=gen)
    tokens[:, 9] = cfg.clip_vocab_size - 1  # end-of-text, the largest id
    return tokens


def build_net(torch, cfg, device, seed: int = 0):
    """The agent of `cfg`'s family (MDTConfig: MDT, else MDT-V) with seeded
    random weights."""
    from mdt_policy_tpu_torch.agents import init_random_, make_agent_net
    return init_random_(make_agent_net(cfg, device=device),
                        torch.Generator().manual_seed(seed))


class Launches:
    """The kernels' launch counters: reset, read."""

    def __init__(self):
        from mdt_policy_tpu_torch.ops.attention_halfblock import attention_halfblock
        from mdt_policy_tpu_torch.ops.few_row_linear import few_row_linear
        from mdt_policy_tpu_torch.ops.fused_norm import fused_layer_norm, fused_rms_norm
        from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
        from mdt_policy_tpu_torch.ops.mlp_halfblock import mlp_halfblock
        from mdt_policy_tpu_torch.ops.pair_attention import (pair_attention,
                                                             pair_grid_attention)
        from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha
        self.fns = {"fused_qkv_attention": fused_qkv_attention,
                    "fused_layer_norm": fused_layer_norm,
                    "fused_rms_norm": fused_rms_norm,
                    "attention_halfblock": attention_halfblock,
                    "mlp_halfblock": mlp_halfblock,
                    "small_seq_mha": small_seq_mha,
                    "few_row_linear": few_row_linear,
                    "attn_pair_grid": pair_grid_attention,
                    "attn_pair_v3": pair_attention}

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self):
        return {name: fn.launches for name, fn in self.fns.items()}


def b2_per_replan(cfg, evaluations=None):
    """Self-attentions of one replan: each decoder block at every denoiser
    call (the sampler's `denoiser_evaluations` over the schedule, or
    `evaluations` where the data decides them), each encoder block once
    where the config hoists the context, else at every call too."""
    from mdt_policy_tpu_torch.agents.mdtv_agent import hoists_context, sampling_schedule
    from mdt_policy_tpu_torch.diffusion.samplers import denoiser_evaluations
    calls = evaluations if evaluations is not None else \
        denoiser_evaluations(cfg.sampler_type, sampling_schedule(cfg))
    return cfg.n_enc_layers * (1 if hoists_context(cfg) else calls) + cfg.n_dec_layers * calls


def b6_per_replan(cfg, evaluations=None):
    """B6 launches of one B=1 replan (the few-row route of the f32
    denoiser): 4 an encoder block (where the config hoists the context once,
    else at every denoiser call), and at each denoiser call one for the
    AdaLN decoder's modulations and 6 a block, or 6 a block of the
    sigma-token decoder; the noise-encoder decoder and a bf16 denoiser keep
    the per-op path. No B6 at B=32 (320 decoder rows)."""
    from mdt_policy_tpu_torch.agents.mdtv_agent import hoists_context, sampling_schedule
    from mdt_policy_tpu_torch.diffusion.samplers import denoiser_evaluations
    if cfg.denoiser_compute_dtype != "float32":
        return 0
    calls = evaluations if evaluations is not None else \
        denoiser_evaluations(cfg.sampler_type, sampling_schedule(cfg))
    decoder = 6 * cfg.n_dec_layers + 1 if not cfg.use_noise_encoder else 0
    if not cfg.use_ada_conditioning:
        decoder = 6 * cfg.n_dec_layers
    return 4 * cfg.n_enc_layers * (1 if hoists_context(cfg) else calls) + decoder * calls


def expected_replan_launches(cfg, family: str, batch: int = 1):
    """Launches of the first replan (the text goal encoded) and of a later
    one (the goal cached) at `batch` envs. B1 one per Voltron block (MDT-V)
    and per causal text block; B3 two RMSNorms per Voltron block and its
    encoder_norm (MDT-V), two LayerNorms per text block and ln_final; B2 at
    every self-attention of the denoiser; B6 `b6_per_replan` at B=1. MDT's
    ResNets and GroupNorms run no kernel of the port."""
    camera = {"fused_qkv_attention": cfg.vit_depth, "fused_layer_norm": 1,
              "fused_rms_norm": 2 * cfg.vit_depth} if family == "mdtv" else \
        {"fused_qkv_attention": 0, "fused_layer_norm": 0, "fused_rms_norm": 0}
    text = {"fused_qkv_attention": cfg.clip_text_layers,
            "fused_layer_norm": 2 * cfg.clip_text_layers + 1, "fused_rms_norm": 0}
    rest = {**NO_HALFBLOCKS, **NO_VARIANTS, "small_seq_mha": b2_per_replan(cfg),
            "few_row_linear": b6_per_replan(cfg) if batch == 1 else 0}
    return [{**{k: camera[k] + text[k] for k in camera}, **rest}, {**camera, **rest}]


def phase_replan(torch, net, device, launches: Launches, family: str):
    """reset() and 20 step() calls at B=1, counting launches per replan."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    cfg = net.cfg
    obs, goal = make_inputs(torch, cfg, 1, seed=1, device=device)
    # eager here; phase_graph holds the graph policy to the same counts
    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(1),
                        cuda_graph=False)
    policy.reset()
    launches.reset()
    per_replan, actions = [], []
    for step in range(20):
        before = launches.read()
        action = policy.step(obs, goal)
        if step % cfg.multistep == 0:
            after = launches.read()
            per_replan.append({k: after[k] - before[k] for k in after})
        actions.append(action)
    torch.cuda.synchronize()
    total = launches.read()
    acts = torch.stack(actions)
    ok = all(tuple(a.shape) == (1, cfg.action_dim) for a in actions) \
        and bool(torch.isfinite(acts).all())
    b3 = [r["fused_layer_norm"] + r["fused_rms_norm"] for r in per_replan]
    expected = expected_replan_launches(cfg, family)
    emit({"phase": "replan", "family": family, "steps": 20,
          "launches_per_replan": per_replan, "expected_per_replan": expected,
          "b1_per_replan": [r["fused_qkv_attention"] for r in per_replan],
          "b3_per_replan": b3, "b2_per_replan": [r["small_seq_mha"] for r in per_replan],
          "b6_per_replan": [r["few_row_linear"] for r in per_replan],
          "launches": total, "actions_finite_and_shaped": ok,
          "first_action": actions[0].tolist()})
    if not ok:
        raise AssertionError("replan produced non-finite or misshaped actions")
    if per_replan != expected:
        raise AssertionError(f"{family} launches per replan {per_replan}, expected {expected}")
    return total


NO_HALFBLOCKS = {"attention_halfblock": 0, "mlp_halfblock": 0}
NO_DENOISER = {"small_seq_mha": 0, "few_row_linear": 0}
NO_VARIANTS = {"attn_pair_grid": 0, "attn_pair_v3": 0}  # the microbench's kernels only


def plain_kernels():
    """Patches every kernel call site with the kernel's plain version."""
    from mdt_policy_tpu_torch.models import blocks, clip, voltron_vit
    from mdt_policy_tpu_torch.ops.few_row_linear import few_row_linear_reference
    from mdt_policy_tpu_torch.ops.fused_norm import (fused_layer_norm_reference,
                                                     fused_rms_norm_reference)
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_reference)
    from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha_reference
    patches = [mock.patch.object(blocks, "small_seq_mha", small_seq_mha_reference),
               mock.patch.object(blocks, "few_row_linear", few_row_linear_reference),
               mock.patch.object(voltron_vit, "fused_qkv_attention",
                                 fused_qkv_attention_reference),
               mock.patch.object(clip, "fused_qkv_attention",
                                 fused_qkv_attention_reference),
               mock.patch.object(blocks, "fused_layer_norm", fused_layer_norm_reference),
               mock.patch.object(blocks, "fused_rms_norm", fused_rms_norm_reference)]
    stack = contextlib.ExitStack()
    for p in patches:
        stack.enter_context(p)
    return stack


def b2_as_sdpa():
    """Swaps kernel B2 alone for the plain `sdpa` route the denoisers took
    before it (the route of the A/B timing)."""
    from mdt_policy_tpu_torch.models import blocks
    return mock.patch.object(blocks, "small_seq_mha",
                             lambda q, k, v, causal=False: blocks.sdpa(q, k, v, causal=causal))


def phase_e2e(torch, net, device, launches: Launches, family: str):
    """One replan through the kernels and through the plain versions."""
    from mdt_policy_tpu_torch.agents import denoise_actions
    obs, goal = make_inputs(torch, net.cfg, 1, seed=2, device=device)
    noise = torch.randn((1, net.cfg.act_window_size, net.cfg.action_dim),
                        generator=torch.Generator().manual_seed(3)).to(device)

    def chunk():
        with torch.no_grad():
            emb = net.perceive(obs["rgb_static"], obs["rgb_gripper"])
            lang = net.encode_language_goal(goal["lang_tokens"])
            return denoise_actions(net, emb, lang, noise=noise)

    kernel_chunk = chunk()
    before = launches.read()
    with plain_kernels():
        plain_chunk = chunk()
    if launches.read() != before:
        raise AssertionError("the plain path launched a kernel")
    err = (kernel_chunk - plain_chunk).abs().max().item()
    scale = max(1.0, plain_chunk.abs().max().item())
    row = {"phase": "e2e", "family": family, "chunk_shape": list(kernel_chunk.shape),
           "max_abs_err": err, "max_abs_chunk": plain_chunk.abs().max().item(),
           "bound": E2E_REL_TOL * scale,
           "finite": bool(torch.isfinite(kernel_chunk).all())}
    emit(row)
    if not (row["finite"] and err <= row["bound"]):
        raise AssertionError(f"kernel path and plain path disagree: {row}")
    return err


def replanner(torch, net, batch: int, device, seed: int = 4, **policy_kwargs):
    """A policy at `batch` parallel envs whose goal is encoded and cached
    (and, unless `cuda_graph=False` is among `policy_kwargs`, whose replan
    is captured), a function that runs one replan and fetches the action to
    the host, the goal, and the first step's host ms and reserved device
    memory (the capture's, with a graph)."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    obs, goal = make_inputs(torch, net.cfg, batch, seed=seed, device=device)
    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(seed + 1),
                        **policy_kwargs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # what stays reserved after the step is what it holds
    reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
    policy.step(obs, goal)  # encodes and caches the goal
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    first = {"first_step_ms": seconds * 1e3,
             "first_step_reserved_bytes": torch.cuda.memory_reserved() - reserved}

    def replan():
        policy.rollout_step_counter = 0  # the next step replans
        return policy.step(obs, goal).cpu()
    return replan, goal, first


def event_times(torch, fn, n: int, warmup: int = 3):
    """CUDA-event milliseconds of each of `n` calls of `fn`, after warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return times


def phase_timing(torch, net, device, smi, family: str):
    """Replan latency at B=1 and B=32 (goal cached) of the graph policy and
    the eager one in turns (graph, eager, eager, graph), REPLANS_TIMED
    replans a turn: CUDA events around policy.step() with the action
    fetched to the host; the capture's host ms and memory; the goal encode;
    then 5 replans of each under torch.profiler."""
    rows = {}
    for batch in (1, 32):
        torch.cuda.reset_peak_memory_stats()
        routes = {"graph": replanner(torch, net, batch, device, cuda_graph=True),
                  "eager": replanner(torch, net, batch, device, cuda_graph=False)}
        times = {"graph": [], "eager": []}
        for route in ("graph", "eager", "eager", "graph"):
            times[route] += event_times(torch, routes[route][0], REPLANS_TIMED)
        goal = routes["eager"][1]
        encode_ms = event_ms(lambda: net.encode_language_goal(goal["lang_tokens"]), 20, torch)
        row = {"phase": "timing", "family": family, "batch": batch,
               "replans_per_route": len(times["graph"]),
               **{f"replan_ms_{q}_{r}": float(np.percentile(t, p))
                  for r, t in times.items() for q, p in (("p50", 50), ("p90", 90))},
               **{f"replan_ms_min_{r}": min(t) for r, t in times.items()},
               **{f"replan_ms_max_{r}": max(t) for r, t in times.items()},
               "capture_ms": routes["graph"][2]["first_step_ms"],
               "capture_reserved_bytes": routes["graph"][2]["first_step_reserved_bytes"],
               "eager_first_step_ms": routes["eager"][2]["first_step_ms"],
               "goal_encode_ms": encode_ms,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": smi}
        emit(row)
        for route, (replan, _, _) in routes.items():
            emit({"phase": "replan_profile", "family": family, "batch": batch,
                  "route": route, **profile_calls(torch, replan, 5), "card": smi})
        rows[batch] = row
        del routes
        torch.cuda.empty_cache()
    return rows


# the replan's kernels by device kernel name: B1, B3 LayerNorm (`kRms`, its
# first template argument, false), B3 RMSNorm (true), B2, B6
REPLAY_KERNELS = {
    "fused_qkv_attention": lambda n: "fused_qkv_attention_kernel" in n,
    "fused_layer_norm": lambda n: "fused_norm_kernel<false" in n,
    "fused_rms_norm": lambda n: "fused_norm_kernel<true" in n,
    "small_seq_mha": lambda n: "small_seq_mha_kernel" in n,
    "few_row_linear": lambda n: "few_row_linear_kernel" in n}


def replay_counts(torch, prof):
    """Launches of the replan's kernels in a profile, counted from the
    device's own record by kernel name, their device µs by name, and the
    distinct names matched."""
    events = _device_events(torch, prof)
    counts = {k: sum(match(e.name) for e in events) for k, match in REPLAY_KERNELS.items()}
    us = {k: sum(e.time_range.elapsed_us() for e in events if match(e.name))
          for k, match in REPLAY_KERNELS.items()}
    return counts, us, sorted({e.name[:80] for e in events
                               if any(m(e.name) for m in REPLAY_KERNELS.values())})


def phase_graph(torch, net, device, launches: Launches, smi, family: str):
    """The graph policy against the eager one: per replan of 30 steps (a
    text goal), the launch counts (the goal's eager encode, then the
    replay's kernels, counted at each replay) must be the eager policy's;
    the replays of the two replans with the goal cached, whose only kernels
    are the graph's, must launch the same kernels by name in the profiler;
    from the same seed, both policies give the same chunks bit for bit for
    a text goal and a goal image, over two replans with other frames each
    (a replay sees its new inputs, not the first ones)."""
    from torch.profiler import ProfilerActivity, profile
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    cfg = net.cfg
    obs, goal = make_inputs(torch, cfg, 1, seed=1, device=device)
    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(1))
    policy.step(obs, goal)  # captures the replan
    first, cached = expected_replan_launches(cfg, family)
    expected = [first, cached, cached]
    by_name = {k: cached[k] for k in REPLAY_KERNELS}
    policy.reset()  # forgets the goal: the first replan encodes it again
    launches.reset()
    per_replan, profiled, profiled_us, names = [], [], [], set()
    for step in range(3 * cfg.multistep):
        if step % cfg.multistep:
            policy.step(obs, goal)
            continue
        before = launches.read()
        if step == 0:
            policy.step(obs, goal)
        else:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                warm = torch.zeros(1024, device=device)  # kernels of no interest first
                for _ in range(8):
                    warm.add_(1.0)
                torch.cuda.synchronize()
                policy.step(obs, goal)
                torch.cuda.synchronize()
            counts, us, seen = replay_counts(torch, prof)
            profiled.append(counts)
            profiled_us.append(us)
            names.update(seen)
        after = launches.read()
        per_replan.append({k: after[k] - before[k] for k in after})

    chunks = {}
    for modality in ("lang", "vis"):
        frames = [make_inputs(torch, cfg, 1, seed=s, device=device) for s in (40, 41)]
        for route in ("graph", "eager"):
            p = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(42),
                           cuda_graph=route == "graph")
            chunks[(modality, route)] = [
                p.plan(o, g if modality == "lang" else {"rgb_static_goal": o["rgb_static"][:, 0]})
                for o, g in frames]
    errs = {m: max((a - b).abs().max().item() for a, b in
                   zip(chunks[(m, "graph")], chunks[(m, "eager")])) for m in ("lang", "vis")}
    equal = {m: all(torch.equal(a, b) for a, b in
                    zip(chunks[(m, "graph")], chunks[(m, "eager")])) for m in ("lang", "vis")}
    # a replay that kept the first call's inputs would repeat its chunk
    fresh = all(not torch.equal(*chunks[(m, "graph")]) for m in ("lang", "vis"))
    row = {"phase": "graph", "family": family, "launches_per_replan": per_replan,
           "expected_per_replan": expected, "replay_kernels_by_name": profiled,
           "expected_by_name": by_name, "replay_kernels_us": profiled_us,
           "kernel_names": sorted(names),
           "max_abs_err_graph_vs_eager": errs, "bit_equal": equal,
           "second_replay_differs": fresh, "card": smi}
    emit(row)
    if per_replan != expected:
        raise AssertionError(f"{family} graph policy launches {per_replan}, "
                             f"expected {expected}")
    if profiled != [by_name, by_name]:
        raise AssertionError(f"{family} graph replays launched {profiled} by kernel "
                             f"name, expected {by_name}")
    # the same kernels on the same inputs: no bound but equality
    if not (all(equal.values()) and fresh):
        raise AssertionError(f"{family} graph and eager replans disagree: {row}")
    return row


def phase_b2_ab(torch, net, device, smi):
    """MDT-V replan p50 with B2 routed and with B2 swapped alone for `sdpa`,
    in turns (B2, sdpa, sdpa, B2) of REPLANS_AB replans each, at B=1 and
    B=32; device events per replan of both routes from the profiler."""
    rows = []
    for batch in (1, 32):
        # eager: a patch of the module does not reach a captured graph
        replan, _, _ = replanner(torch, net, batch, device, seed=20, cuda_graph=False)
        times = {"b2": [], "sdpa": []}
        for route in ("b2", "sdpa", "sdpa", "b2"):
            with b2_as_sdpa() if route == "sdpa" else contextlib.nullcontext():
                times[route] += event_times(torch, replan, REPLANS_AB)
        with b2_as_sdpa():
            sdpa_prof = profile_calls(torch, replan, 3)
        b2_prof = profile_calls(torch, replan, 3)
        row = {"phase": "b2_ab", "family": "mdtv", "batch": batch,
               "replans_per_route": len(times["b2"]),
               **{f"replan_ms_p50_{r}": float(np.percentile(t, 50)) for r, t in times.items()},
               **{f"replan_ms_p90_{r}": float(np.percentile(t, 90)) for r, t in times.items()},
               "device_events_per_replan_b2": b2_prof["device_events_per_call"],
               "device_events_per_replan_sdpa": sdpa_prof["device_events_per_call"],
               "device_ms_per_replan_b2": b2_prof["device_ms_per_call"],
               "device_ms_per_replan_sdpa": sdpa_prof["device_ms_per_call"],
               "card": smi}
        emit(row)
        rows.append(row)
    return rows

# samplers: replans timed a (sampler, batch), the batches, and the
# log-likelihood's kernel-vs-plain bound relative to max(1, |ll|): both
# routes run f32 with B2 and its plain version apart by summation order (~1e-6 relative a call), over an adaptive integration whose
# accept decisions may differ near the threshold (rtol 1e-4)
SAMPLER_REPLANS = 10
SAMPLER_BATCHES = (1, 32)
LL_REL_TOL = 1e-3
# configs: each value the port once refused, on the production width (the
# ResNet goal tower as CLIP's RN50: clip_embed_dim and goal_dim 1024)
CONFIG_CASES = (
    ("sigma_token", {"use_ada_conditioning": False}),
    ("noise_encoder", {"use_noise_encoder": True}),
    ("no_modality_encoder", {"use_modality_encoder": False}),
    ("linear_goal", {"use_mlp_goal": False}),
    ("bf16_denoiser", {"denoiser_compute_dtype": "bfloat16"}),
    ("resnet_goal", {"clip_vision_family": "resnet", "clip_embed_dim": 1024,
                     "goal_dim": 1024}),
    ("trainable_img_encoder", {"freeze_img_encoder": False}),
    ("lognormal", {"sigma_sample_density_type": "lognormal"}),
    ("embed_pdrob", {"embed_pdrob": 0.1}),
    ("goal_drop", {"goal_drop": 0.1}),
)
MDT_CONFIG_CASES = ("sigma_token", "noise_encoder", "bf16_denoiser")
CONFIG_REPLANS = 10  # per turn of the bf16 / f32 denoiser timing (4 turns)
TOWER_BATCHES = (1, TRAIN_BATCH)


def _diff(before, after):
    return {k: after[k] - before[k] for k in after}


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def sampler_chunks(torch, net, obs, goal, device, seed, routes):
    """The first replan's chunk of a fresh policy for each route from one
    seed: "graph" (captured, with the first plan's host ms, the capture
    included) and "eager", and "plain" (eager through every kernel's plain
    version)."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    out, first_ms = {}, None
    for route in routes:
        policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(seed),
                            cuda_graph=route == "graph")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_kernels() if route == "plain" else contextlib.nullcontext():
            out[route] = policy.plan(obs, goal)
        torch.cuda.synchronize()
        if route == "graph":
            first_ms, out["policy"] = (time.perf_counter() - t0) * 1e3, policy
    return out, first_ms


def phase_samplers(torch, net, device, launches: Launches, smi):
    """Every sampler of the suite through MDT-V's policy at the production
    width, at B=1 and B=32 (text goal): the graph replan against the eager
    one from one seed (the same kernels on the same inputs: bit-equal), the
    kernel route against the plain versions on the chunk (E2E_REL_TOL), the
    denoiser calls and B2's launches a replan against the formula
    (`denoiser_evaluations`), p50/p90 over SAMPLER_REPLANS replans and the
    first plan's ms with the capture. dpm_adaptive runs eagerly (a graph
    cannot replay host decisions): its steps and calls from `stats`, B2 by
    the same formula at the calls it made. Then `log_likelihood` of a chunk
    with the kernels and with B2 routed to its plain version: their
    forward-mode products go through the plain version either way."""
    from mdt_policy_tpu_torch.agents import denoise_actions
    from mdt_policy_tpu_torch.agents.mdtv_agent import sampling_schedule
    from mdt_policy_tpu_torch.diffusion import precond_denoise
    from mdt_policy_tpu_torch.diffusion.samplers import (SAMPLER_NAMES, denoiser_evaluations,
                                                         log_likelihood)
    from mdt_policy_tpu_torch.models import blocks
    from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha_reference
    base, total, rows = net.cfg, {}, []
    try:
        for name in SAMPLER_NAMES:
            net.cfg = cfg = dataclasses.replace(base, sampler_type=name)
            adaptive = name == "dpm_adaptive"
            for batch in SAMPLER_BATCHES:
                obs, goal = make_inputs(torch, cfg, batch, seed=60, device=device)
                launches.reset()
                chunks, first_ms = sampler_chunks(
                    torch, net, obs, goal, device, 61,
                    ("eager", "plain") if adaptive else ("graph", "eager", "plain"))
                policy = chunks.pop("policy", None)
                if policy is None:  # dpm_adaptive: the eager policy, steps counted
                    from mdt_policy_tpu_torch.agents import MDTVPolicy
                    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(62))
                plan = lambda: policy.plan(obs, goal).cpu()
                plan()  # the goal encoded and cached
                before = launches.read()
                plan()
                per_replan = _diff(before, launches.read())
                stats = {}
                if adaptive:
                    with torch.no_grad():
                        emb = net.perceive(obs["rgb_static"], obs["rgb_gripper"])
                        lang = net.encode_language_goal(goal["lang_tokens"])
                        before = launches.read()
                        denoise_actions(net, emb, lang, stats=stats,
                                        generator=torch.Generator(device).manual_seed(63))
                        per_call = _diff(before, launches.read())
                    calls = stats["evaluations"]
                    b2_ok = per_call["small_seq_mha"] == b2_per_replan(cfg, calls) and \
                        per_call["few_row_linear"] == (b6_per_replan(cfg, calls)
                                                       if batch == 1 else 0)
                else:
                    calls = denoiser_evaluations(name, sampling_schedule(cfg))
                    b2_ok = per_replan["small_seq_mha"] == b2_per_replan(cfg) and \
                        per_replan["few_row_linear"] == (b6_per_replan(cfg) if batch == 1
                                                         else 0)
                times = event_times(torch, plan, SAMPLER_REPLANS)
                _add(total, launches.read())
                ref = chunks["plain"]
                err = (chunks["eager"] - ref).abs().max().item()
                row = {"phase": "samplers", "sampler": name, "batch": batch,
                       "route": "eager" if adaptive else "graph",
                       "denoiser_calls": calls, "b2_per_replan": per_replan["small_seq_mha"],
                       "b2_expected": b2_per_replan(cfg, calls if adaptive else None),
                       "b6_expected": b6_per_replan(cfg, calls if adaptive else None)
                       if batch == 1 else 0,
                       "b2_ok": b2_ok, "launches_per_replan": per_replan,
                       "max_abs_err_kernel_vs_plain": err,
                       "bound": E2E_REL_TOL * max(1.0, ref.abs().max().item()),
                       "finite": bool(torch.isfinite(chunks["eager"]).all()),
                       "replans": len(times),
                       "replan_ms_p50": float(np.percentile(times, 50)),
                       "replan_ms_p90": float(np.percentile(times, 90)),
                       "first_plan_ms_with_capture": first_ms, "card": smi}
                if adaptive:
                    row.update(steps=stats["steps"], accepted=stats["accepted"])
                else:
                    row["graph_equals_eager"] = bool(torch.equal(chunks["graph"],
                                                                 chunks["eager"]))
                emit(row)
                rows.append(row)
                del policy, chunks
                if not (row["finite"] and err <= row["bound"] and b2_ok
                        and row.get("graph_equals_eager", True)):
                    raise AssertionError(f"sampler {name} at B={batch} failed: {row}")
            torch.cuda.empty_cache()
    finally:
        net.cfg = base
    # log_likelihood of a DDIM chunk, kernel route against B2's plain version
    obs, goal = make_inputs(torch, base, 1, seed=64, device=device)
    with torch.no_grad():
        emb = net.perceive(obs["rgb_static"], obs["rgb_gripper"])
        lang = net.encode_language_goal(goal["lang_tokens"])
        x = denoise_actions(net, emb, lang, generator=torch.Generator(device).manual_seed(65))
        context = net.encode_context(emb, lang[:, None], modality="lang")

    def denoise(xx, sigma):
        sb = torch.full((1,), float(sigma), device=device)
        return precond_denoise(lambda xin, s: net.decode_actions(context, xin, s), xx, sb,
                               base.sigma_data)

    lls, ll_stats = {}, {}
    for route in ("kernel", "plain"):
        ll_stats[route] = {}
        before = launches.read()
        with mock.patch.object(blocks, "small_seq_mha", small_seq_mha_reference) \
                if route == "plain" else contextlib.nullcontext():
            t0 = time.perf_counter()
            lls[route] = log_likelihood(
                denoise, x, base.sigma_min, base.sigma_max, stats=ll_stats[route],
                generator=torch.Generator(device).manual_seed(66))
            torch.cuda.synchronize()
            ll_stats[route]["seconds"] = time.perf_counter() - t0
        ll_stats[route]["b2_launches"] = _diff(before, launches.read())["small_seq_mha"]
    _add(total, {"small_seq_mha": ll_stats["kernel"]["b2_launches"]})
    ll_err = (lls["kernel"] - lls["plain"]).abs().max().item()
    row = {"phase": "samplers_log_likelihood", "ll_kernel": lls["kernel"].tolist(),
           "ll_plain": lls["plain"].tolist(), "max_abs_err": ll_err,
           "bound": LL_REL_TOL * max(1.0, lls["plain"].abs().max().item()),
           "stats": ll_stats, "card": smi}
    emit(row)
    if not (torch.isfinite(lls["kernel"]).all() and ll_err <= row["bound"]
            and ll_stats["kernel"]["b2_launches"] > 0 and ll_stats["plain"]["b2_launches"] == 0):
        raise AssertionError(f"log_likelihood kernel and plain routes disagree: {row}")
    return total, rows


def _config(family, over):
    from mdt_policy_tpu_torch.agents import MDTConfig, MDTVConfig
    return (MDTVConfig if family == "mdtv" else MDTConfig)(**over)


def phase_configs(torch, device, launches: Launches, smi, base_nets):
    """Each config value the port once refused (CONFIG_CASES), one at a time
    on the production MDT-V config, and the sigma-token, noise-encoder and
    bf16 denoisers on MDT's: a net of seeded random weights; a graph replan
    at B=1 and B=32 with the goal cached, its launches against the formula
    (the sigma-token and noise-encoder configs encode at every denoiser
    call: MDT-V's B2 80 a DDIM-10 replan), the B=1 graph chunk bit-equal to
    the eager one; for the ResNet goal tower also a goal-image replan and
    the tower's device ms at TOWER_BATCHES; one train step at B=128 per
    stream with finite losses and its launches; for the bf16 denoiser the
    replan's p50 and device ms beside the f32 denoiser's (`base_nets`) in
    turns (f32, bf16, bf16, f32) at B=1 and B=32. Returns the launches of
    the phase and of its bf16 denoiser replans."""
    from mdt_policy_tpu_torch.agents import init_train_state, train_step
    total, bf16_total, rows = {}, {}, []
    cases = [("mdtv", c, o) for c, o in CONFIG_CASES] + \
        [("mdt", c, o) for c, o in CONFIG_CASES if c in MDT_CONFIG_CASES]
    batches = {}
    for family, case, over in cases:
        cfg = _config(family, over)
        net = build_net(torch, cfg, device)
        row = {"phase": "configs", "family": family, "case": case, "overrides": over,
               "card": smi}
        launches.reset()
        for batch in (1, 32):
            obs, goal = make_inputs(torch, cfg, batch, seed=70, device=device)
            chunks, first_ms = sampler_chunks(torch, net, obs, goal, device, 71,
                                              ("graph", "eager") if batch == 1 else ("graph",))
            policy = chunks.pop("policy")
            policy.plan(obs, goal)
            before = launches.read()
            chunk = policy.plan(obs, goal)
            row[f"launches_b{batch}"] = _diff(before, launches.read())
            row[f"first_plan_ms_with_capture_b{batch}"] = first_ms
            row[f"finite_b{batch}"] = bool(torch.isfinite(chunk).all())
            if batch == 1:
                row["graph_equals_eager"] = bool(torch.equal(chunks["graph"], chunks["eager"]))
            if case == "resnet_goal":
                image = {"rgb_static_goal": obs["rgb_static"][:, 0]}
                policy.plan(obs, image)
                before = launches.read()
                vis = policy.plan(obs, image)
                row[f"goal_image_launches_b{batch}"] = _diff(before, launches.read())
                row[f"goal_image_finite_b{batch}"] = bool(torch.isfinite(vis).all())
            del policy, chunks
        expected = {b: expected_replan_launches(cfg, family, b)[1] for b in (1, 32)}
        row["expected_per_replan"] = expected
        ok = all(row[f"launches_b{b}"] == expected[b] for b in (1, 32)) \
            and row["finite_b1"] and row["finite_b32"] and row["graph_equals_eager"]
        if case == "resnet_goal":
            ok = ok and all(row[f"goal_image_launches_b{b}"] == expected[b]
                            and row[f"goal_image_finite_b{b}"] for b in (1, 32))
            gen = torch.Generator(device).manual_seed(72)
            for b in TOWER_BATCHES:
                img = torch.randn((b, cfg.img_size, cfg.img_size, 3), generator=gen,
                                  device=device)
                row[f"tower_ms_b{b}"] = event_ms(lambda: net.encode_visual_goal(img), 10, torch)
                row[f"tower_device_ms_b{b}"] = call_device_ms(
                    lambda: net.encode_visual_goal(img), 5, torch)
            row["tower_dtype"] = str(net.visual_goal.conv1.weight.dtype)
        _add(total, launches.read())
        if case == "bf16_denoiser":
            _add(bf16_total, launches.read())
            row["timing"] = bf16_timing(torch, base_nets[family], net, device)
        # one train step at B=128 per stream
        if family not in batches:
            batches[family] = make_train_batch(torch, cfg, TRAIN_BATCH, device)
        state = init_train_state(net)
        launches.reset()
        metrics = train_step(state, batches[family], generator=torch.Generator(device)
                             .manual_seed(73))
        torch.cuda.synchronize()
        row["train_launches"] = launches.read()
        _add(total, row["train_launches"])
        row["train_metrics"] = {k: float(v) for k, v in metrics.items()}
        row["train_expected"] = (expected_train_launches if family == "mdtv"
                                 else expected_mdt_train_launches)(cfg)
        ok = ok and all(np.isfinite(v) for v in row["train_metrics"].values()) \
            and row["train_launches"] == row["train_expected"]
        row["ok"] = bool(ok)
        emit(row)
        rows.append(row)
        del net, state
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"config {family}/{case} failed: {row}")
    return total, bf16_total, rows


def bf16_timing(torch, f32_net, bf16_net, device):
    """The graph replan's p50/p90 of the f32 and the bf16 denoiser in turns
    (f32, bf16, bf16, f32), CONFIG_REPLANS a turn, and each one's device ms
    and B2 device µs a replan from the profiler, at B=1 and B=32."""
    out = {}
    for batch in (1, 32):
        routes = {"f32": replanner(torch, f32_net, batch, device, seed=74)[0],
                  "bf16": replanner(torch, bf16_net, batch, device, seed=74)[0]}
        times = {"f32": [], "bf16": []}
        for route in ("f32", "bf16", "bf16", "f32"):
            times[route] += event_times(torch, routes[route], CONFIG_REPLANS)
        for route, fn in routes.items():
            prof = profile_calls(torch, fn, 5)
            out[f"b{batch}_{route}"] = {
                "replan_ms_p50": float(np.percentile(times[route], 50)),
                "replan_ms_p90": float(np.percentile(times[route], 90)),
                "device_ms_per_replan": prof["device_ms_per_call"],
                "b2_device_us_per_replan":
                    prof["replay_kernels_us_per_call"]["small_seq_mha"],
                "busy_share": prof["busy_share"]}
        del routes
    return out


def oracle_results(seqs, never):
    """Chain scores under the scripted oracle: every task solves
    ROLLOUT_SOLVE_AT steps into its rollout except `never`, so a chain
    scores the tasks before its first `never`."""
    return [next((j for j, t in enumerate(chain) if t == never), 5) for _, chain in seqs]


def expected_rollout(results, multistep: int):
    """Env steps and replans of each chain under that oracle: a solved task
    takes ROLLOUT_SOLVE_AT steps, the failed one the whole episode; a replan
    every `multistep` steps."""
    replans = lambda steps: -(-steps // multistep)
    steps = [ROLLOUT_SOLVE_AT * r + (ROLLOUT_EP_LEN if r < 5 else 0) for r in results]
    plans = [replans(ROLLOUT_SOLVE_AT) * r + (replans(ROLLOUT_EP_LEN) if r < 5 else 0)
             for r in results]
    return steps, plans


def expected_batched_replans(results, multistep: int):
    """Policy calls of one wave of the batched loop: per subtask position,
    the wave runs until its slowest live env is done."""
    calls = 0
    for j in range(5):
        live = [r for r in results if r >= j]
        if not live:
            break
        ticks = ROLLOUT_EP_LEN if any(r == j for r in live) else ROLLOUT_SOLVE_AT
        calls += -(-ticks // multistep)
    return calls


class WatchedPolicy:
    """A rollout policy that counts its steps and checks that every action
    is finite and (1, action_dim)."""

    def __init__(self, policy, action_dim: int):
        self.policy, self.action_dim = policy, action_dim
        self.steps, self.ok = 0, True

    def reset(self):
        self.policy.reset()

    def step(self, obs, goal):
        action = self.policy.step(obs, goal)
        self.steps += 1
        self.ok &= action.shape == (1, self.action_dim) and bool(np.isfinite(action).all())
        return action


def phase_rollout(torch, nets, device, launches: Launches, smi):
    """CALVIN's chain evaluation on the fake env at CALVIN's camera sizes
    (200 px static, 84 px gripper) for each agent family: `evaluate_policy`
    over ROLLOUT_CHAINS chains through `make_rollout_policy`, one chain at a
    time, then `evaluate_policy_batched` over BATCHED_ENVS envs and as many
    chains, one B=BATCHED_ENVS replan per policy call. The scripted oracle
    solves every task at ROLLOUT_SOLVE_AT steps except the third task of the
    first chain, which never solves; results, env steps and replans must be
    the ones that rule gives. The policies replay captured graphs, whose
    kernels count at each replay: B2 and B3 RMSNorm, which only the graph
    runs, must launch a replan's worth per replan and per warm-up call
    before a capture; B1 and B3 LayerNorm at least that (the text tower
    adds its eager encodes)."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    from mdt_policy_tpu_torch.evaluation import (BatchedPolicyAdapter, FakeEnv,
                                                 ScriptedOracle, TASKS, evaluate_policy,
                                                 evaluate_policy_batched, get_sequences,
                                                 make_batched_predict, make_rollout_policy)
    from mdt_policy_tpu_torch.evaluation.annotations import make_goal_fn
    never = get_sequences(ROLLOUT_CHAINS)[0][1][2]
    oracle = ScriptedOracle({t: ROLLOUT_SOLVE_AT for t in TASKS if t != never})
    launches.reset()
    rows = []
    for family, net in nets.items():
        cfg = net.cfg
        before = launches.read()
        capture = mock.patch.object(MDTVPolicy, "_capture", autospec=True,
                                    side_effect=MDTVPolicy._capture)
        captures = capture.start()
        goal_fn = make_goal_fn(cfg.clip_context_length)
        env = FakeEnv(img_hw=200, gripper_hw=84, seed=0)
        policy = make_rollout_policy(net, generator=torch.Generator(device).manual_seed(30))
        watched = WatchedPolicy(policy, cfg.action_dim)
        want = oracle_results(get_sequences(ROLLOUT_CHAINS), never)
        want_steps, want_plans = expected_rollout(want, cfg.multistep)
        results, steps, plans = [], [], []
        t0 = time.perf_counter()
        with mock.patch.object(policy.inner, "plan", wraps=policy.inner.plan) as plan:
            for i in range(ROLLOUT_CHAINS):
                before_steps, before_plans = watched.steps, plan.call_count
                results += evaluate_policy(watched, env, oracle, goal_fn,
                                           num_sequences=ROLLOUT_CHAINS, ep_len=ROLLOUT_EP_LEN,
                                           sequence_indices=[i], progress=False)
                steps.append(watched.steps - before_steps)
                plans.append(plan.call_count - before_plans)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        serial = {"phase": "rollout", "family": family, "loop": "serial",
                  "chains": ROLLOUT_CHAINS, "ep_len": ROLLOUT_EP_LEN, "never_solves": never,
                  "results": results, "expected": want, "env_steps": steps,
                  "expected_env_steps": want_steps, "replans": plans,
                  "expected_replans": want_plans, "actions_ok": watched.ok,
                  "seconds": seconds, "env_steps_per_s": sum(steps) / seconds,
                  "replans_per_s": sum(plans) / seconds, "card": smi}
        emit(serial)
        if not (results == want and steps == want_steps and plans == want_plans
                and watched.ok):
            raise AssertionError(f"serial rollout disagrees with the oracle's rule: {serial}")

        calls = []
        predict = make_batched_predict(net, generator=torch.Generator(device).manual_seed(31))

        def counted(obs_batch, goals):
            chunks = predict(obs_batch, goals)
            calls.append(bool(np.isfinite(chunks).all()) and chunks.shape == (
                len(goals), cfg.act_window_size, cfg.action_dim))
            return chunks
        envs = [FakeEnv(img_hw=200, gripper_hw=84, seed=i) for i in range(BATCHED_ENVS)]
        want = oracle_results(get_sequences(BATCHED_ENVS), never)
        t0 = time.perf_counter()
        results = evaluate_policy_batched(
            BatchedPolicyAdapter(counted, multistep=cfg.multistep), envs, oracle, goal_fn,
            num_sequences=BATCHED_ENVS, ep_len=ROLLOUT_EP_LEN, progress=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        env_steps = sum(expected_rollout(want, cfg.multistep)[0])
        batched = {"phase": "rollout", "family": family, "loop": "batched",
                   "envs": BATCHED_ENVS, "chains": BATCHED_ENVS, "ep_len": ROLLOUT_EP_LEN,
                   "results": results, "expected": want, "policy_calls": len(calls),
                   "expected_policy_calls": expected_batched_replans(want, cfg.multistep),
                   "chunks_ok": all(calls), "env_steps": env_steps, "seconds": seconds,
                   "env_steps_per_s": env_steps / seconds,
                   "replans_per_s": BATCHED_ENVS * len(calls) / seconds, "card": smi}
        emit(batched)
        if not (results == want and batched["chunks_ok"]
                and len(calls) == batched["expected_policy_calls"]):
            raise AssertionError(f"batched rollout disagrees with the oracle's rule: {batched}")
        capture.stop()
        after = launches.read()
        got = {k: after[k] - before[k] for k in after}
        runs = sum(plans) + len(calls) + MDTVPolicy.WARMUP_CALLS * captures.call_count
        per_run = expected_replan_launches(cfg, family)[1]
        # B6 runs at the serial loop's B=1 replans alone (its own captures')
        serial_runs = sum(plans) + MDTVPolicy.WARMUP_CALLS * sum(
            c.args[0] is policy.inner for c in captures.call_args_list)
        counts = {"phase": "rollout", "family": family, "loop": "launches",
                  "launches": got, "captures": captures.call_count,
                  "replan_runs": runs, "serial_replan_runs": serial_runs,
                  "per_replan_run": per_run}
        emit(counts)
        exact = ("small_seq_mha", "fused_rms_norm")
        if any(got[k] != runs * per_run[k] for k in exact) or any(
                got[k] < runs * per_run[k] for k in per_run if k != "few_row_linear") or \
                got["few_row_linear"] != serial_runs * per_run["few_row_linear"]:
            raise AssertionError(f"{family} rollout launches disagree with its replans: "
                                 f"{counts}")
        rows += [serial, batched]
    return launches.read(), rows


def make_train_batch(torch, cfg, batch: int, device):
    """A synthetic, already-normalized dual-scope batch on the card: static
    frames at 224 px and gripper frames at 84 px (T+1 = 2: observation and
    goal frame), foresight frames at 112 px, (B, 10, 7) actions, 77-token
    goals."""
    gen = torch.Generator(device).manual_seed(6)
    cpu_gen = torch.Generator().manual_seed(6)
    g = cfg.gen_img_res

    def scope():
        return {
            "rgb_static": torch.randn((batch, 2, cfg.img_size, cfg.img_size, 3),
                                      generator=gen, device=device),
            "rgb_gripper": torch.randn((batch, 2, 84, 84, 3), generator=gen, device=device),
            "gen_static": torch.randn((batch, g, g, 3), generator=gen, device=device),
            "gen_gripper": torch.randn((batch, g, g, 3), generator=gen, device=device),
            "actions": torch.randn((batch, cfg.act_window_size, cfg.action_dim),
                                   generator=gen, device=device),
            "lang_tokens": make_tokens(torch, cfg, batch, cpu_gen).to(device),
        }
    return {"vis": scope(), "lang": scope()}


def expected_train_launches(cfg):
    """Per train step (both scopes): B1 in every Voltron and CLIP vision
    block (each scope) and every CLIP text block (lang scope); B3 LayerNorm
    in Voltron's encoder_norm and CLIP vision's ln_pre, ln_1/ln_2, ln_post
    (each scope) and CLIP text's ln_1/ln_2, ln_final (lang scope); B3 RMSNorm
    in the Voltron and foresight-decoder blocks and decoder_norm (each
    scope) and the MAP head's two norms (twice, lang scope). The ResNet
    goal tower runs none of the port's kernels."""
    vision = cfg.clip_vision_layers if cfg.clip_vision_family == "vit" else None
    return {"fused_qkv_attention": 2 * cfg.vit_depth + 2 * (vision or 0)
            + cfg.clip_text_layers,
            "fused_layer_norm": 2 * (1 + (2 * vision + 2 if vision else 0))
            + 2 * cfg.clip_text_layers + 1,
            "fused_rms_norm": 2 * 2 * cfg.vit_depth
            + 2 * (2 * cfg.gen_decoder_depth + 1) + 2 * 2, **NO_HALFBLOCKS, **NO_DENOISER,
            **NO_VARIANTS}


def expected_mdt_train_launches(cfg):
    """Per MDT train step (both scopes): B1 in every CLIP vision block (each
    scope: the goal frame is always encoded) and CLIP text block (lang
    scope); B3 LayerNorm in CLIP vision's ln_pre, ln_1/ln_2, ln_post (each
    scope) and CLIP text's ln_1/ln_2, ln_final (lang scope); B3 RMSNorm in
    the foresight decoder's blocks and decoder_norm (each scope). No MAP
    head, no B2 (dropout is on); the ResNets and their GroupNorms run no
    kernel of the port."""
    vision = cfg.clip_vision_layers if cfg.clip_vision_family == "vit" else 0
    return {"fused_qkv_attention": 2 * vision + cfg.clip_text_layers,
            "fused_layer_norm": 2 * (2 * vision + 2 if vision else 0)
            + 2 * cfg.clip_text_layers + 1,
            "fused_rms_norm": 2 * (2 * cfg.gen_decoder_depth + 1), **NO_HALFBLOCKS,
            **NO_DENOISER, **NO_VARIANTS}


def expected_mdt_validation_launches(cfg):
    """Per MDT validation step: the train step's tower and decoder kernels,
    and B2 at every self-attention of the DDIM-10 denoiser in each scope
    (no dropout in validation)."""
    return {**expected_mdt_train_launches(cfg), "small_seq_mha": 2 * b2_per_replan(cfg)}


def _frozen_and_trainable(torch, net):
    frozen = {n: p.detach().clone() for n, p in net.named_parameters()
              if n.split(".", 1)[0] in net.frozen_prefixes}
    trainable = {n: p.detach().clone() for n, p in net.trainable_parameters()}
    return frozen, trainable


def _train_checks(torch, net, state, metrics, frozen0, trainable0):
    """Finite metrics; every trainable network (top-level name) and the EMA
    moved; the frozen towers did not."""
    frozen1, trainable1 = _frozen_and_trainable(torch, net)
    moved = {}
    for k in trainable0:
        top = k.split(".", 1)[0]
        moved[top] = moved.get(top, False) or not torch.equal(trainable0[k], trainable1[k])
    return {
        "finite": all(np.isfinite(v) for m in metrics for v in m.values()),
        "trainables_moved": sum(not torch.equal(trainable0[k], trainable1[k])
                                for k in trainable0),
        "n_trainables": len(trainable0),
        "networks_moved": moved,
        "ema_moved": sum(not torch.equal(trainable0[k], state.ema[k]) for k in state.ema),
        "frozen_unchanged": all(torch.equal(frozen0[k], frozen1[k]) for k in frozen0),
    }


def phase_train(torch, net, device, launches: Launches, family: str = "mdtv"):
    """3 train steps at B=128 per stream, counting launches per step."""
    from mdt_policy_tpu_torch.agents import init_train_state, train_step
    cfg = net.cfg
    batch = make_train_batch(torch, cfg, TRAIN_BATCH, device)
    state = init_train_state(net)
    gen = torch.Generator(device).manual_seed(7)
    frozen0, trainable0 = _frozen_and_trainable(torch, net)
    launches.reset()
    per_step, metrics = [], []
    for _ in range(3):
        before = launches.read()
        m = train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        after = launches.read()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics.append({k: float(v) for k, v in m.items()})
    total = launches.read()
    checks = _train_checks(torch, net, state, metrics, frozen0, trainable0)
    expected = (expected_train_launches if family == "mdtv" else expected_mdt_train_launches)(cfg)
    phase = "train" if family == "mdtv" else f"{family}_train"
    emit({"phase": phase, "family": family, "batch_per_stream": TRAIN_BATCH, "steps": 3,
          "frames": {k: list(v.shape[-3:]) for k, v in batch["lang"].items()
                     if k.startswith(("rgb", "gen"))},
          "metrics": metrics, "launches_per_step": per_step,
          "expected_per_step": expected, "launches": total, **checks})
    if not (checks["finite"] and all(checks["networks_moved"].values())
            and checks["ema_moved"] > 0 and checks["frozen_unchanged"]):
        raise AssertionError(f"{family} train steps failed their checks: {checks}")
    if family == "mdt" and not {"static_resnet", "gripper_resnet"} <= set(checks["networks_moved"]):
        raise AssertionError(f"the MDT optimizer left out a ResNet: {checks}")
    if any(step != expected for step in per_step):
        raise AssertionError(f"{family} launches per train step {per_step}, expected {expected}")
    return state, batch, total


def phase_validation(torch, net, batch, device, launches: Launches, phase: str):
    """One validation step from the train batch, counting its launches; then
    the same step with the same draws through the plain versions, its
    metrics within TRAIN_E2E_REL_TOL of the kernels'."""
    from mdt_policy_tpu_torch.agents import validation_step

    def step():
        return {k: float(v) for k, v in validation_step(
            net, batch, generator=torch.Generator(device).manual_seed(13)).items()}

    launches.reset()
    val = step()
    torch.cuda.synchronize()
    got = launches.read()
    with plain_kernels():
        plain = step()
    if launches.read() != got:
        raise AssertionError("the plain validation step launched a kernel")
    rel = {k: abs(val[k] - plain[k]) / max(1.0, abs(plain[k])) for k in val}
    expected = expected_mdt_validation_launches(net.cfg)
    emit({"phase": phase, "metrics": val, "plain": plain, "max_rel_err": max(rel.values()),
          "worst": max(rel, key=rel.get), "bound": TRAIN_E2E_REL_TOL,
          "launches": got, "expected": expected})
    if not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"{phase} not finite: {val}")
    if got != expected:
        raise AssertionError(f"{phase} launches {got}, expected {expected}")
    if not max(rel.values()) <= TRAIN_E2E_REL_TOL:
        raise AssertionError(f"kernel and plain validation steps disagree: {rel}")
    return got


def phase_train_e2e(torch, state, batch, device, launches: Launches,
                    phase: str = "train_e2e"):
    """One step from the same state and draws, kernels vs plain versions."""
    from mdt_policy_tpu_torch.agents import make_draws, train_step
    twin = copy.deepcopy(state)
    cfg = state.net.cfg

    def step(s):
        gen = torch.Generator(device).manual_seed(8)
        draws = {k: make_draws(cfg, TRAIN_BATCH, gen) for k in sorted(batch)}
        m = train_step(s, batch, draws=draws)
        return {k: float(v) for k, v in m.items()}

    kernel = step(state)
    before = launches.read()
    with plain_kernels():
        plain = step(twin)
    if launches.read() != before:
        raise AssertionError("the plain train step launched a kernel")
    keys = [k for k in kernel if k.endswith("_loss") or k == "train/grad_norm"]
    rel = {k: abs(kernel[k] - plain[k]) / max(1.0, abs(plain[k])) for k in keys}
    row = {"phase": phase, "kernel": {k: kernel[k] for k in keys},
           "plain": {k: plain[k] for k in keys}, "max_rel_err": max(rel.values()),
           "worst": max(rel, key=rel.get), "bound": TRAIN_E2E_REL_TOL}
    emit(row)
    del twin
    if not row["max_rel_err"] <= TRAIN_E2E_REL_TOL:
        raise AssertionError(f"kernel and plain train steps disagree: {row}")
    return row


def _device_events(torch, prof):
    """Work on the card: kernels, copies and sets, without the ranges that
    `record_function` annotations (such as Optimizer.step) mirror there."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def profile_calls(torch, fn, n: int, host_top: int = 0):
    """`n` calls of `fn` under torch.profiler: wall and device ms per call,
    device events (kernels, copies, sets) per call, the device's busy share,
    the kernels' shares of the device time, the costliest kernels, and with
    `host_top` that many host operators with the most self time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(torch, prof)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    share = lambda key: sum(v for k, v in by_name.items() if key in k) / max(device_ms, 1e-9)
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:host_top]
    return {"calls": n, "wall_ms_per_call": wall_ms / n,
            "device_ms_per_call": device_ms / n,
            "device_events_per_call": len(events) / n,
            "busy_share": device_ms / wall_ms,
            "b1_share": share("fused_qkv_attention_kernel"),
            "b3_share": share("fused_norm_kernel"),
            "b4_b5_share": share("halfblock_"),
            "b2_share": share("small_seq_mha_kernel"),
            "b6_share": share("few_row_linear_kernel"),
            # the replan's kernels' device µs a call, by name
            "replay_kernels_us_per_call": {
                k: sum(v for name, v in by_name.items() if match(name)) * 1e3 / n
                for k, match in REPLAY_KERNELS.items()},
            "top_kernels_ms_per_call": [[k[:90], v / n] for k, v in top],
            **({"host_top_self_us_per_call": [[a.key[:60], a.count / n,
                                               a.self_cpu_time_total / n] for a in host]}
               if host_top else {})}


def phase_train_timing(torch, state, batch, device, smi, phase: str = "train_timing"):
    """Step time on the host clock (each step ends in a synchronize), after
    3 warm-up steps; then 2 steps under torch.profiler."""
    from mdt_policy_tpu_torch.agents import train_step
    gen = torch.Generator(device).manual_seed(9)
    for _ in range(3):
        train_step(state, batch, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS_TIMED):
        t0 = time.perf_counter()
        train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.percentile(times, 50))
    row = {"phase": phase, "batch_per_stream": TRAIN_BATCH,
           "steps": len(times), "step_ms_p50": p50,
           "step_ms_p90": float(np.percentile(times, 90)),
           "step_ms_min": min(times), "step_ms_max": max(times),
           "chunks_per_s": 2 * TRAIN_BATCH / (p50 / 1e3),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": smi}
    emit(row)
    prof = profile_calls(torch, lambda: train_step(state, batch, generator=gen), 2)
    emit({"phase": phase.replace("timing", "profile"), **prof, "card": smi})
    return row


def _state_tensors(state):
    """Every tensor of a train state by name: the net's state_dict, the EMA,
    the optimizer's per-parameter state (step and moments)."""
    out = {f"params/{k}": v for k, v in state.net.state_dict().items()}
    out.update({f"ema/{k}": v for k, v in state.ema.items()})
    names = {id(p): n for n, p in state.net.trainable_parameters()}
    for p, s in state.optimizer.state.items():
        out.update({f"opt/{names[id(p)]}/{k}": v for k, v in s.items()})
    return out


def phase_checkpoint(torch, states, device, smi, root):
    """Per family, the train phase's state saved by `Checkpointer` into a
    run directory under `root` (a `config.yaml` from `RunConfig`, the step
    as the metric of `best.json`), restored into a fresh state on the card
    (every tensor bit-equal, optimizer moments and step included), then one
    more train step from the original and from the restored state with the
    same draws (max relative |delta| of the metrics). Returns {family:
    (run directory, host copies of the saved EMA and parameters)}."""
    import yaml
    from mdt_policy_tpu_torch.agents import (init_train_state, make_agent_net, make_draws,
                                             train_step)
    from mdt_policy_tpu_torch.training import RunConfig
    from mdt_policy_tpu_torch.utils.checkpoint import STATE_FILE, Checkpointer
    runs = {}
    for family, state in states.items():
        cfg = state.net.cfg
        run = os.path.join(root, family)
        os.makedirs(run)
        default = type(cfg)()  # the snapshot names the fields that differ
        overrides = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                     if getattr(cfg, f.name) != getattr(default, f.name)}
        with open(os.path.join(run, "config.yaml"), "w") as f:
            f.write(yaml.safe_dump(dataclasses.asdict(
                RunConfig(agent=family, agent_overrides=overrides))))
        ck = Checkpointer(os.path.join(run, "checkpoints"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ck.save(state, metric=float(state.step), wait=True)
        save_s = time.perf_counter() - t0
        saved_step = state.step
        host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}
        saved = {"ema": host(state.ema), "params": host(state.net.state_dict())}
        fresh = init_train_state(make_agent_net(cfg, device=device))
        t0 = time.perf_counter()
        ck.restore(fresh, step=ck.best_step())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        steps_equal = fresh.step == saved_step
        a, b = _state_tensors(state), _state_tensors(fresh)
        unequal = sorted(set(a) ^ set(b)) + [
            k for k in sorted(set(a) & set(b))
            if not (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]))]
        groups_equal = state.optimizer.state_dict()["param_groups"] == \
            fresh.optimizer.state_dict()["param_groups"]
        batch = make_train_batch(torch, cfg, TRAIN_BATCH, device)

        def step(s):
            gen = torch.Generator(device).manual_seed(21)
            draws = {k: make_draws(cfg, TRAIN_BATCH, gen) for k in sorted(batch)}
            return {k: float(v) for k, v in train_step(s, batch, draws=draws).items()}
        m_orig, m_restored = step(state), step(fresh)
        rel = {k: abs(m_orig[k] - m_restored[k]) / max(1.0, abs(m_orig[k])) for k in m_orig}
        row = {"phase": "checkpoint", "family": family, "step": saved_step,
               "tensors": len(a), "unequal": unequal[:8], "param_groups_equal": groups_equal,
               "file_bytes": os.path.getsize(os.path.join(path, STATE_FILE)),
               "save_s": save_s, "restore_s": restore_s,
               "best_step": ck.best_step(),
               "next_step_max_rel_err": max(rel.values()), "worst": max(rel, key=rel.get),
               "bit_equal_metrics": sorted(k for k in rel if rel[k] == 0.0),
               "bound": CHECKPOINT_STEP_REL_TOL, "card": smi}
        emit(row)
        if unequal or not groups_equal or not steps_equal:
            raise AssertionError(f"{family} restore is not bit-equal: {row}")
        if not row["next_step_max_rel_err"] <= CHECKPOINT_STEP_REL_TOL:
            raise AssertionError(f"{family} step after restore disagrees: {row}")
        runs[family] = (run, saved)
        del fresh, batch, a, b
        torch.cuda.empty_cache()
    return runs


def eval_results(chains: int):
    """results.json of `evaluate --fake-env`: its scripted oracle never
    solves, so every chain fails its first task (print_and_save's layout)."""
    from mdt_policy_tpu_torch.evaluation import get_sequences
    firsts = [chain[0] for _, chain in get_sequences(chains)]
    return {"0": {"avg_seq_len": 0.0, "chain_sr": {str(i): 0.0 for i in range(1, 6)},
                  "task_info": {t: {"success": 0, "total": firsts.count(t)} for t in firsts}}}


def reference_key(port_key: str, ref_prefix) -> str:
    """The reference file's key of a port key (`from_reference.REF_PREFIX`
    read backwards)."""
    for ref, port in ref_prefix.items():
        if port_key.startswith(port):
            return ref + port_key[len(port):]
    raise KeyError(port_key)


def phase_reference_ckpt(torch, device, smi, root):
    """The published-checkpoint path: a reference-format Lightning `.ckpt`
    written from a seeded `MDTVConfig()` net (its `state_dict` renamed back
    through `REF_PREFIX` as the EMA callback's weight list, float32; a
    perturbed copy as the raw `state_dict`; stand-ins for keys no converter
    reads and the `proprio_emb` head between them; `hyper_parameters` of a
    class whose module is gone when the file is read), converted by
    `from_reference.main([ckpt, out])` in this process; the file is removed
    after. Checks the report: every key of the net read, the stand-ins
    ignored, `proprio_emb` dropped (the config has no proprio), nothing kept
    at its init. The run's raw trainables are then moved by 1, so that
    only its EMA is the source net's. Returns the source net and (the run
    directory, host copies of the weights it must restore), for
    evaluate_cli."""
    import collections
    import types
    from mdt_policy_tpu_torch.agents import MDTVConfig
    from mdt_policy_tpu_torch.utils import from_reference
    from mdt_policy_tpu_torch.utils.checkpoint import STATE_FILE
    t_phase = time.perf_counter()
    cfg = MDTVConfig()
    source = build_net(torch, cfg, device, seed=REFERENCE_SEED)
    own = source.state_dict()
    gen = torch.Generator().manual_seed(REFERENCE_SEED)
    stand_ins = {"language_goal.clip_rn50.visual.conv1.weight": (64, 3, 3, 3),
                 "gen_img.decoder_pe": (1, 196, cfg.gen_decoder_dim),
                 "img_encoder.vcond.encoder_pe": (1, 196, cfg.perceiver_dim),
                 "model.inner_model.proprio_emb.0.weight": (cfg.embed_dim, cfg.proprio_dim),
                 "model.inner_model.proprio_emb.0.bias": (cfg.embed_dim,),
                 "model.inner_model.proprio_emb.2.weight": (cfg.embed_dim, cfg.embed_dim),
                 "model.inner_model.proprio_emb.2.bias": (cfg.embed_dim,)}
    ema = collections.OrderedDict()
    for key, value in own.items():
        ref = reference_key(key, from_reference.REF_PREFIX)
        ema[ref] = value.detach().to("cpu", torch.float32, copy=True)
        for extra, shape in stand_ins.items():  # each after its network's first key
            if extra.startswith(ref.split(".")[0] + ".") and extra not in ema:
                ema[extra] = torch.randn(shape, generator=gen)
    hparams = types.ModuleType(REFERENCE_HPARAMS_MODULE)
    hparams.AttributeDict = type("AttributeDict", (dict,),
                                 {"__module__": REFERENCE_HPARAMS_MODULE})
    path = os.path.join(root, "mdtv_reference.ckpt")
    sys.modules[REFERENCE_HPARAMS_MODULE] = hparams
    t0 = time.perf_counter()
    try:
        torch.save({"epoch": 19, "global_step": 24000, "state_dict": collections.OrderedDict(
                        (k, v + 0.5) for k, v in ema.items()),
                    "callbacks": {"EMA": {"ema_weights": list(ema.values())}},
                    "optimizer_states": [], "hparams_name": "kwargs",
                    "hyper_parameters": hparams.AttributeDict(lr=1e-4, seed=REFERENCE_SEED)},
                   path)
    finally:
        del sys.modules[REFERENCE_HPARAMS_MODULE]
    write_s = time.perf_counter() - t0
    file_bytes = os.path.getsize(path)
    proprio = [k for k in stand_ins if ".proprio_emb." in k]
    read = sorted([reference_key(k, from_reference.REF_PREFIX) for k in own] + proprio)
    ignored = sorted(set(stand_ins) - set(proprio))
    dropped = sorted(k.replace("model.inner_model.", "inner.") for k in proprio)
    del ema
    out = os.path.join(root, "mdtv_converted")
    t0 = time.perf_counter()
    report = from_reference.main([path, out])
    convert_s = time.perf_counter() - t0
    os.remove(path)
    # at step 0 the EMA is the raw weights: move the raw trainables so that
    # evaluate_cli's weight check tells which of the two the run restores
    state_path = os.path.join(out, "checkpoints", "0", STATE_FILE)
    state = torch.load(state_path, weights_only=True)
    for name in state["ema"]:
        state["params"][name] += 1.0
    torch.save(state, state_path)
    del state
    saved = {"ema": {n: p.detach().to("cpu", copy=True) for n, p in source.trainable_parameters()},
             "params": {k: v.detach().to("cpu", copy=True) for k, v in own.items()}}
    row = {"phase": "reference_ckpt", "params": sum(v.numel() for v in own.values()),
           "file_bytes": file_bytes, "write_s": write_s, "convert_s": convert_s,
           "run_bytes": os.path.getsize(state_path),
           "report": report.counts(), "dropped": report.dropped, "ignored": report.ignored,
           "seconds": time.perf_counter() - t_phase, "limit_s": REFERENCE_LIMIT_S,
           "card": smi}
    emit(row)
    if not (sorted(report.ignored) == ignored and sorted(report.dropped) == dropped
            and report.missing == [] and sorted(report.read) == read):
        raise AssertionError(f"the reference checkpoint's conversion disagrees: {row}")
    if row["seconds"] > REFERENCE_LIMIT_S:
        raise AssertionError(f"reference_ckpt took over {REFERENCE_LIMIT_S} s: {row}")
    return source, (out, saved)


def phase_evaluate_cli(torch, runs, device, launches: Launches, smi, sources):
    """`evaluate.main([--train-folder RUN, --fake-env, --num-sequences 4])`
    in this process on each family's run directory: results.json is the
    scripted oracle's (every chain fails its first task after a whole
    episode), env steps and replans follow from that rule, the policy's
    weights are the checkpoint's EMA (and the frozen towers' own), and the
    kernels launched are the graph phase's per replan run (each replan and
    each warm-up call before the capture) plus the text tower's per goal
    encode. A family in `sources` (a run directory converted from another
    net) also holds a graph replan of the CLI's net bit-equal to the same
    replan of the source net, from the same draws; its launches are not the
    path's."""
    from mdt_policy_tpu_torch import evaluate
    from mdt_policy_tpu_torch.agents import MDTAgentNet, MDTVAgentNet, MDTVPolicy
    from mdt_policy_tpu_torch.evaluation import FakeEnv
    launches.reset()
    total = {}
    for family, (run, saved) in runs.items():
        before = launches.read()
        built, printed = [], io.StringIO()

        def build(*args, _real=evaluate.build_policy, **kwargs):
            built.append(_real(*args, **kwargs))
            return built[-1]
        net_cls = MDTAgentNet if family == "mdt" else MDTVAgentNet
        watched = [mock.patch.object(cls, name, autospec=True, side_effect=getattr(cls, name))
                   for cls, name in ((MDTVPolicy, "plan"), (MDTVPolicy, "_capture"),
                                     (net_cls, "encode_language_goal"), (FakeEnv, "step"))]
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(evaluate, "build_policy", build))
            plan, capture, encode, env_step = [stack.enter_context(w) for w in watched]
            stack.enter_context(contextlib.redirect_stdout(printed))
            t0 = time.perf_counter()
            evaluate.main(["--train-folder", run, "--fake-env", "--num-sequences",
                           str(EVAL_CHAINS), "--device", str(device)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        after = launches.read()
        got = {k: after[k] - before[k] for k in after}
        total = {k: total.get(k, 0) + v for k, v in got.items()}
        policy, cfg, _ = built[0]
        net = policy.inner.net
        weights_equal = all(torch.equal(v.cpu(), saved["ema"].get(k, saved["params"][k]))
                            for k, v in net.state_dict().items())
        replan_equal = None
        if family in sources:
            obs, goal = make_inputs(torch, cfg, 1, seed=43, device=device)
            chunks = [MDTVPolicy(n, generator=torch.Generator(device).manual_seed(44)).plan(
                obs, goal) for n in (net, sources[family])]
            replan_equal = torch.equal(*chunks) and bool(torch.isfinite(chunks[0]).all())
        with open(os.path.join(run, "evaluation", "results.json")) as f:
            results = json.load(f)
        want_steps, want_plans = expected_rollout([0] * EVAL_CHAINS, cfg.multistep)
        first, cached = expected_replan_launches(cfg, family)
        replan_runs = plan.call_count + MDTVPolicy.WARMUP_CALLS * capture.call_count
        want = {k: replan_runs * cached[k] + encode.call_count * (first[k] - cached[k])
                for k in cached}
        row = {"phase": "evaluate_cli", "family": family, "chains": EVAL_CHAINS,
               "results": results, "printed": json.loads(printed.getvalue()),
               "env_steps": env_step.call_count, "replans": plan.call_count,
               "captures": capture.call_count, "goal_encodes": encode.call_count,
               "cuda_graph": policy.inner.cuda_graph, "ema_weights": weights_equal,
               "converted_from_reference": family in sources,
               "graph_replan_equals_source": replan_equal,
               "launches": got, "expected_launches": want,
               "per_replan_run": cached, "seconds": seconds,
               "env_steps_per_s": env_step.call_count / seconds,
               "replans_per_s": plan.call_count / seconds, "card": smi}
        emit(row)
        if not (results == eval_results(EVAL_CHAINS)
                and row["printed"] == {"avg_seq_len": 0.0,
                                       "chain_sr": results["0"]["chain_sr"]}
                and env_step.call_count == sum(want_steps)
                and plan.call_count == sum(want_plans)
                and encode.call_count == EVAL_CHAINS and weights_equal
                and replan_equal is not False):
            raise AssertionError(f"{family} evaluate CLI disagrees with the oracle's rule "
                                 f"or the checkpoint: {row}")
        if got != want:
            raise AssertionError(f"{family} evaluate CLI launches {got}, expected {want}")
        del built, policy, net
        torch.cuda.empty_cache()
    return total


def halfblock_inputs(torch, kernel, tower, B, T, C, n, device, seed=0):
    """bf16 inputs of one B4 or B5 call: x ~ N(0, 1), gains near 1, weights
    N(0, 1/fan_in), so that every stage is O(1); the weights are torch
    Linear weights (out, in). Returns (tensors, keyword arguments)."""
    norm, eps, has_gamma, causal, act = TOWER_BLOCKS[tower]
    gen = torch.Generator(device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).bfloat16()
    x, g = r(B, T, C), (1 + r(C, scale=0.1).float()).bfloat16()
    b = r(C, scale=0.1) if norm == "ln" else None
    gamma = r(C, scale=0.5) if has_gamma else None
    if kernel == "b4":
        return (x, g, b, r(3 * C, C, scale=C ** -0.5), r(3 * C, scale=0.02),
                r(C, C, scale=C ** -0.5), r(C, scale=0.02), gamma), \
            dict(n_heads=n, norm=norm, eps=eps, causal=causal)
    n1 = 2 * n if act == "swishglu" else n
    return (x, g, b, r(n1, C, scale=C ** -0.5), r(n1, scale=0.02),
            r(C, n, scale=n ** -0.5), r(C, scale=0.02), gamma), \
        dict(act=act, norm=norm, eps=eps)


def unfused_halfblock(torch, kernel, tensors, kw):
    """The port's B1 + B3 route for the same half-block: the B3 norm,
    F.linear, B1 or the activation, F.linear, * gamma, + x."""
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.models.clip import quick_gelu
    from mdt_policy_tpu_torch.ops.fused_norm import fused_layer_norm, fused_rms_norm
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
    x, g, b, w1, b1, w2, b2, gamma = tensors
    xn = fused_rms_norm(x, g, kw["eps"]) if kw["norm"] == "rms" \
        else fused_layer_norm(x, g, b, kw["eps"])
    h = F.linear(xn, w1, b1)
    if kernel == "b4":
        h = fused_qkv_attention(h, kw["n_heads"], kw["causal"])
    elif kw["act"] == "swishglu":
        proj, gate = h.chunk(2, dim=-1)
        h = proj * F.silu(gate)
    else:
        h = quick_gelu(h)
    y = F.linear(h, w2, b2)
    return x + (y * gamma if gamma is not None else y)


def linear_ms(torch, M, K, N, device, iters: int = 20) -> float:
    """Event ms of F.linear (cuBLAS) on bf16 (M, K) x (N, K)^T + bias."""
    import torch.nn.functional as F
    gen = torch.Generator(device).manual_seed(7)
    a = torch.randn((M, K), generator=gen, device=device).bfloat16()
    w = (torch.randn((N, K), generator=gen, device=device) * K ** -0.5).bfloat16()
    bias = torch.randn((N,), generator=gen, device=device).bfloat16()
    return event_ms(lambda: F.linear(a, w, bias), iters, torch)


def kernels_by_name(torch, fn, iters: int):
    """{device kernel name: [ms a call, launches a call]} over `iters`
    calls of `fn` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in _device_events(torch, prof):
        ms, n = split.get(e.name[:90], (0.0, 0))
        split[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {k: [ms / iters, n / iters] for k, (ms, n) in split.items()}


def halfblock_cost(kernel, tensors, kw):
    """(bytes, FLOP) of one call: every input read once and the output
    written once; B4 8*T*C^2 per image in its products plus 4*C per
    attended (query, key) pair (half the pairs when causal); B5
    2*T*C*(rows of W1 + H) per image."""
    x, w1, w2 = tensors[0], tensors[3], tensors[5]
    B, T, C = x.shape
    n_bytes = sum(t.numel() * t.element_size() for t in tensors if t is not None) \
        + x.numel() * x.element_size()
    if kernel == "b4":
        pairs = T * (T + 1) // 2 if kw["causal"] else T * T
        return n_bytes, 8 * B * T * C * C + 4 * B * pairs * C
    return n_bytes, 2 * B * T * C * (w1.shape[0] + w2.shape[1])


def halfblock_parts(kernel, tensors, kw):
    """The norm pass and the GEMMs of one B4 or B5 call, in launch order:
    (label, epilogue or norm, weight or gain, bias, residual, gamma)."""
    x, g, b, w1, b1, w2, b2, gamma = tensors
    return (("norm", kw["norm"], g, b, None, None),
            ("qkv" if kernel == "b4" else "w1", "bias" if kernel == "b4" else kw["act"],
             w1, b1, None, None),
            ("proj" if kernel == "b4" else "w2", "residual", w2, b2, x, gamma))


def halfblock_part_rows(torch, tower, kernel, tensors, kw, split, device):
    """The norm pass and each GEMM of one B4 or B5 call alone
    (`ops/halfblock_gemm.py`) against its plain version on the same inputs
    (the GEMMs on a seeded N(0, 1) A), with its event, device, plain and
    library ms (F.linear; F.layer_norm or F.rms_norm*; event and device),
    its bound, and its share of the call's device time (`split`, by kernel
    name)."""
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.ops.halfblock_gemm import (
        EPILOGUES, halfblock_gemm, halfblock_gemm_reference, halfblock_norm,
        halfblock_norm_reference)
    gen = torch.Generator(device).manual_seed(3)
    x = tensors[0]
    B, T, C = x.shape
    M = B * T
    call_ms = sum(ms for name, (ms, _) in split.items() if "halfblock_" in name)
    rows = []
    for label, op, w, bias, res, gamma in halfblock_parts(kernel, tensors, kw):
        if label == "norm":
            args = (x, w, bias, op, kw["eps"])
            fn, ref = halfblock_norm, halfblock_norm_reference
            lib = (lambda: F.layer_norm(x, (C,), w, bias, kw["eps"])) if op == "ln" \
                else (lambda: F.rms_norm(x, (C,), w, kw["eps"]))
            name, n_bytes, flops = "halfblock_norm_kernel", 4 * M * C, 0
            shape = {"M": M, "C": C, "norm": op}
        else:
            a = torch.randn((M, w.shape[1]), generator=gen, device=device).bfloat16()
            args = (a, w, bias, op, None if res is None else res.view(M, C), gamma)
            fn, ref = halfblock_gemm, halfblock_gemm_reference
            lib = lambda: F.linear(a, w, bias)  # noqa: E731
            n_out = w.shape[0] // 2 if op == "swishglu" else w.shape[0]
            name = "halfblock_gemm_kernel"
            n_bytes = sum(t.numel() * 2 for t in args if isinstance(t, torch.Tensor)) \
                + M * n_out * 2
            flops = 2 * M * w.shape[1] * w.shape[0]
            shape = {"M": M, "K": w.shape[1], "N": n_out, "epilogue": op}
        out = fn(*args)
        plain = ref(*args)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        bound = HALFBLOCK_TOL["plain"] * max(1.0, plain.float().abs().max().item())
        del out, plain
        bms, by = bound_ms(n_bytes, flops, "bfloat16")
        mine = [ms for n, (ms, _) in split.items() if name in n
                and (label == "norm" or f"<{EPILOGUES.index(op)}>" in n)]  # its template id
        row = {"phase": "kernel", "kernel": fn.__name__, "shape": f"{tower}:{label}",
               "half_block": kernel, **shape, "dtype": "bfloat16", "max_abs_err": err,
               "bound": bound, "ms": event_ms(lambda: fn(*args), 20, torch),
               "device_ms": device_ms(lambda: fn(*args), name, 5, torch),
               "plain_ms": event_ms(lambda: ref(*args), 20, torch),
               "library_ms": event_ms(lib, 20, torch),
               "library_device_ms": call_device_ms(lib, 5, torch),
               "bound_ms": bms, "bound_by": by,
               "share_of_call": sum(mine) / max(call_ms, 1e-9)}
        emit(row)
        if not err <= bound:
            raise AssertionError(f"{fn.__name__} disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def phase_kernel_halfblocks(torch, device):
    """B4 and B5 against their plain versions (bf16) and float64 of the plain
    versions, at the extraction's shapes; times of the kernel, its device
    kernels, the plain version and the unfused B1 + B3 route; then each
    part of the call alone (`halfblock_part_rows`)."""
    from mdt_policy_tpu_torch.ops.attention_halfblock import (
        attention_halfblock, attention_halfblock_reference)
    from mdt_policy_tpu_torch.ops.mlp_halfblock import mlp_halfblock, mlp_halfblock_reference
    rows = []
    for kernel, tower, B, T, C, n in HALFBLOCK_SHAPES:
        tensors, kw = halfblock_inputs(torch, kernel, tower, B, T, C, n, device)
        fn, ref = (attention_halfblock, attention_halfblock_reference) if kernel == "b4" \
            else (mlp_halfblock, mlp_halfblock_reference)
        out = fn(*tensors, **kw)
        plain = ref(*tensors, **kw)
        f64 = ref(*(None if t is None else t.double() for t in tensors), **kw)
        torch.cuda.synchronize()
        errs, bounds = {}, {}
        for label, r in (("plain", plain), ("float64", f64)):
            errs[label] = (out.double() - r.double()).abs().max().item()
            bounds[label] = HALFBLOCK_TOL[label] * max(1.0, r.abs().max().item())
        del plain, f64
        iters = 20
        # the profiler on the card's machine (torch 2.11) has lost device
        # events of a window; a window that shows fewer kernels a call than
        # the call launches is profiled again, up to PROFILE_TRIES windows:
        # the check still needs one complete window with exactly the
        # expected kernels
        for _ in range(PROFILE_TRIES):
            split = kernels_by_name(torch, lambda: fn(*tensors, **kw), 5)
            ours = [v for name, v in split.items() if "halfblock_" in name]
            per_call = sum(n for _, n in ours)
            if per_call >= HALFBLOCK_KERNELS_PER_CALL[kernel]:
                break
        n_bytes, flops = halfblock_cost(kernel, tensors, kw)
        bms, by = bound_ms(n_bytes, flops, "bfloat16")
        row = {"phase": "kernel", "kernel": fn.__name__, "shape": tower,
               "x": [B, T, C], "width": n, **{k: v for k, v in kw.items() if k != "eps"},
               "dtype": "bfloat16", "max_abs_err": errs["plain"], "bound": bounds["plain"],
               "max_abs_err_float64": errs["float64"], "bound_float64": bounds["float64"],
               "ms": event_ms(lambda: fn(*tensors, **kw), iters, torch),
               "device_ms": sum(ms for ms, _ in ours), "device_kernels_per_call": per_call,
               "device_kernels": split,
               "plain_ms": event_ms(lambda: ref(*tensors, **kw), iters, torch),
               "unfused_ms": event_ms(lambda: unfused_halfblock(torch, kernel, tensors, kw),
                                      iters, torch),
               "library_ms": None, "bound_ms": bms, "bound_by": by,
               "flop": flops, "bytes": n_bytes}
        emit(row)
        if not (errs["plain"] <= bounds["plain"] and errs["float64"] <= bounds["float64"]):
            raise AssertionError(f"{fn.__name__} disagrees with its plain version: {row}")
        if per_call != HALFBLOCK_KERNELS_PER_CALL[kernel]:
            raise AssertionError(f"{fn.__name__} ran {per_call} device kernels per call, "
                                 f"expected {HALFBLOCK_KERNELS_PER_CALL[kernel]}")
        rows.append(row)
        rows += halfblock_part_rows(torch, tower, kernel, tensors, kw, split, device)
    return rows


def write_split(root, seed: int = 10):
    """A synthetic split at CALVIN's frame sizes: extracted uint8 frame
    arrays (200 px static, 84 px gripper), their row names, and annotation
    sentences, all from a seeded generator."""
    rng = np.random.default_rng(seed)
    ex = os.path.join(root, "extracted")
    os.makedirs(ex)
    np.save(os.path.join(ex, "ep_rgb_static.npy"),
            rng.integers(0, 256, (EXTRACT_FRAMES, 200, 200, 3), dtype=np.uint8))
    np.save(os.path.join(ex, "ep_rgb_gripper.npy"),
            rng.integers(0, 256, (EXTRACT_FRAMES, 84, 84, 3), dtype=np.uint8))
    with open(os.path.join(ex, "ep_npz_names.list"), "w") as f:
        f.write("".join(f"{i}\n" for i in range(EXTRACT_FRAMES)))
    verbs = ("open", "close", "push", "lift", "rotate", "slide", "place", "stack",
             "turn on", "turn off")
    things = ("the drawer", "the red block", "the blue block", "the pink block",
              "the switch", "the led light", "the door", "the light bulb")
    where = ("to the left", "to the right", "in the slider", "on top", "", "gently")
    texts = [" ".join(w for w in (verbs[rng.integers(len(verbs))],
                                  things[rng.integers(len(things))],
                                  where[rng.integers(len(where))]) if w)
             for _ in range(EXTRACT_SENTENCES)]
    lang = os.path.join(root, "lang_clip_resnet50")
    os.makedirs(lang)
    np.save(os.path.join(lang, "auto_lang_ann.npy"), {"language": {"ann": texts}},
            allow_pickle=True)
    return texts


def extract_forwards():
    """Tower forwards of one extraction run (extract_embeddings with one
    shift variant and its self-check of 2 batches): the clean and the
    augmented pass over every batch, and the recomputed batches."""
    n_batches = -(-EXTRACT_FRAMES // EXTRACT_BATCH)
    return 2 * n_batches + 2 * min(2, n_batches)


def phase_extract(torch, net, device, launches: Launches, smi, root):
    """extract_embeddings and extract_lang_goals at the production config:
    layout, self-check, launches, the B1 + B3 route on the first batch, and
    frames/s of both routes."""
    from mdt_policy_tpu_torch.data.extract_embeddings import (
        extract_embeddings, extract_lang_goals, load_embeddings, make_fwd)
    from mdt_policy_tpu_torch.utils.clip_tokenizer import tokenize
    cfg = net.cfg
    texts = write_split(root)
    out = os.path.join(root, "extracted")
    launches.reset()
    t0 = time.perf_counter()
    extract_embeddings(root, net, batch_size=EXTRACT_BATCH, aug_variants=1, halfblocks=True)
    extract_lang_goals(root, net, context_length=cfg.clip_context_length)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = launches.read()

    # the text tower encodes every sentence in one call
    fwd_calls = extract_forwards()
    per_batch = cfg.vit_depth + cfg.clip_vision_layers
    expected = {"fused_qkv_attention": 0, "fused_rms_norm": 0,
                # Voltron's encoder_norm, CLIP's ln_pre and ln_post; ln_final
                "fused_layer_norm": 3 * fwd_calls + 1,
                "attention_halfblock": per_batch * fwd_calls + cfg.clip_text_layers,
                "mlp_halfblock": per_batch * fwd_calls + cfg.clip_text_layers,
                **NO_DENOISER, **NO_VARIANTS}
    n_tokens = 2 * (cfg.img_size // cfg.vit_patch) ** 2
    shapes = {"ep_voltron_tokens.npy": ((EXTRACT_FRAMES, n_tokens, cfg.perceiver_dim), "uint16"),
              "ep_clip_img_emb.npy": ((EXTRACT_FRAMES, cfg.clip_embed_dim), "float32"),
              "ep_voltron_tokens_aug.npy": ((EXTRACT_FRAMES, 1, n_tokens, cfg.perceiver_dim),
                                            "uint16"),
              "ep_clip_img_emb_aug.npy": ((EXTRACT_FRAMES, 1, cfg.clip_embed_dim), "float32"),
              "ep_lang_goal_emb.npy": ((EXTRACT_SENTENCES, cfg.clip_embed_dim), "float32")}
    files = {}
    for name, (shape, dtype) in shapes.items():
        a = np.load(os.path.join(out, name), mmap_mode="r")
        files[name] = {"shape": list(a.shape), "dtype": str(a.dtype),
                       "ok": tuple(a.shape) == shape and str(a.dtype) == dtype}
    tensors, meta = load_embeddings(out)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in tensors.values())

    # the first batch through the B1 + B3 route, against the cache rows
    static = np.load(os.path.join(out, "ep_rgb_static.npy"), mmap_mode="r")
    gripper = np.load(os.path.join(out, "ep_rgb_gripper.npy"), mmap_mode="r")
    first = slice(0, EXTRACT_BATCH)
    before = launches.read()
    sizes = dict(static_size=cfg.img_size, gripper_size=min(84, cfg.img_size))
    tok, emb = make_fwd(net, **sizes, halfblocks=False)(static[first], gripper[first])
    lang = net.encode_language_goal(torch.from_numpy(
        tokenize(texts[:EXTRACT_BATCH], cfg.clip_context_length)).long().to(device))
    torch.cuda.synchronize()
    if launches.read()["attention_halfblock"] != before["attention_halfblock"]:
        raise AssertionError("the B1 + B3 route launched a half-block")
    route = {}
    for key, mine, ref in (("voltron_tokens", tensors["voltron_tokens"][first], tok),
                           ("image_latent_goal", tensors["image_latent_goal"][first], emb),
                           ("lang_latent_goal", tensors["lang_latent_goal"][first], lang)):
        err = (mine.to(device).float() - ref.float()).abs().max().item()
        bound = EXTRACT_ROUTE_TOL * max(1.0, ref.float().abs().max().item())
        route[key] = {"max_abs_err": err, "bound": bound}

    # frames/s of both routes on the same frames: clean pass only, no
    # self-check, in turns (B4/B5, B1/B3, B1/B3, B4/B5)
    timed = {"halfblocks": [], "b1_b3": []}
    for halfblocks in (True, False, False, True):
        t1 = time.perf_counter()
        extract_embeddings(root, net, batch_size=EXTRACT_BATCH, self_check=0,
                           out_dir=os.path.join(root, "timed"), halfblocks=halfblocks)
        torch.cuda.synchronize()
        timed["halfblocks" if halfblocks else "b1_b3"].append(
            EXTRACT_FRAMES / (time.perf_counter() - t1))
    # the default is the route that was faster in both pairs of turns
    default = "halfblocks" if inspect.signature(extract_embeddings).parameters[
        "halfblocks"].default else "b1_b3"
    faster = ["halfblocks" if hb > b1 else "b1_b3"
              for hb, b1 in zip(timed["halfblocks"], timed["b1_b3"])]
    profiles = {}
    for name, halfblocks in (("halfblocks", True), ("b1_b3", False)):
        fwd = make_fwd(net, **sizes, halfblocks=halfblocks)
        profiles[name] = profile_calls(torch, lambda: fwd(static[first], gripper[first]), 2)
    row = {"phase": "extract", "frames": EXTRACT_FRAMES, "batch": EXTRACT_BATCH,
           "sentences": EXTRACT_SENTENCES, "aug_variants": 1, "seconds": seconds,
           "tower_forwards": fwd_calls, "launches": total, "expected": expected,
           "files": files, "meta_keys": sorted(meta), "finite": finite,
           "route_vs_b1_b3": route,
           "frames_per_s": {k: v for k, v in timed.items()},
           "frames_per_s_mean": {k: float(np.mean(v)) for k, v in timed.items()},
           "default_route": default, "faster_route_by_pair": faster,
           "default_faster_in_both_pairs": faster == [default, default], "card": smi}
    emit(row)
    for name, prof in profiles.items():
        emit({"phase": "extract_profile", "route": name, "batch": EXTRACT_BATCH, **prof,
              "card": smi})
    if total != expected:
        raise AssertionError(f"extraction launches {total}, expected {expected}")
    if not (finite and all(f["ok"] for f in files.values())):
        raise AssertionError(f"extraction wrote a bad cache: {files}, finite={finite}")
    if any(r["max_abs_err"] > r["bound"] for r in route.values()):
        raise AssertionError(f"the cache disagrees with the B1 + B3 route: {route}")
    return total


def make_cache_batch(torch, cfg, batch: int, out, device):
    """A dual-scope cache batch from the written cache: the vis scope takes
    frame rows [0, B), the lang scope [B, 2B) and annotation rows [0, B);
    foresight frames and actions are synthetic."""
    from mdt_policy_tpu_torch.data.extract_embeddings import load_embeddings
    gen = torch.Generator(device).manual_seed(11)
    g = cfg.gen_img_res

    def scope(lo):
        tensors, _ = load_embeddings(out, rows=np.arange(lo, lo + batch))
        return {"voltron_tokens": tensors["voltron_tokens"].to(device),
                "image_latent_goal": tensors["image_latent_goal"].to(device),
                "lang_latent_goal": tensors["lang_latent_goal"][:batch].to(device),
                "gen_static": torch.randn((batch, g, g, 3), generator=gen, device=device),
                "gen_gripper": torch.randn((batch, g, g, 3), generator=gen, device=device),
                "actions": torch.randn((batch, cfg.act_window_size, cfg.action_dim),
                                       generator=gen, device=device)}
    return {"vis": scope(0), "lang": scope(batch)}


def expected_cache_train_launches(cfg):
    """Per cache-mode step: no tower kernel; B3 RMSNorm in the foresight
    decoder's blocks and decoder_norm (each scope) and the MAP head's two
    norms (twice, lang scope)."""
    return {"fused_qkv_attention": 0, "fused_layer_norm": 0,
            "fused_rms_norm": 2 * (2 * cfg.gen_decoder_depth + 1) + 2 * 2, **NO_HALFBLOCKS,
            **NO_DENOISER, **NO_VARIANTS}


def phase_cache_train(torch, net, device, launches: Launches, smi, out):
    """3 cache-mode train steps at B=128 per stream, counting launches per
    step; then kernels vs plain, a validation step, and the step's times."""
    from mdt_policy_tpu_torch.agents import init_train_state, train_step, validation_step
    cfg = net.cfg
    batch = make_cache_batch(torch, cfg, TRAIN_BATCH, out, device)
    state = init_train_state(net)
    gen = torch.Generator(device).manual_seed(12)
    frozen0, trainable0 = _frozen_and_trainable(torch, net)
    launches.reset()
    per_step, metrics = [], []
    for _ in range(3):
        before = launches.read()
        m = train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        after = launches.read()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics.append({k: float(v) for k, v in m.items()})
    total = launches.read()
    checks = _train_checks(torch, net, state, metrics, frozen0, trainable0)
    expected = expected_cache_train_launches(cfg)
    emit({"phase": "cache_train", "batch_per_stream": TRAIN_BATCH, "steps": 3,
          "metrics": metrics, "launches_per_step": per_step,
          "expected_per_step": expected, "launches": total, **checks})
    if not (checks["finite"] and all(checks["networks_moved"].values())
            and checks["ema_moved"] > 0 and checks["frozen_unchanged"]):
        raise AssertionError(f"cache-mode steps failed their checks: {checks}")
    if any(step != expected for step in per_step):
        raise AssertionError(f"launches per cache-mode step {per_step}, expected {expected}")
    phase_train_e2e(torch, state, batch, device, launches, phase="cache_train_e2e")
    val = {k: float(v) for k, v in validation_step(
        net, batch, generator=torch.Generator(device).manual_seed(13)).items()}
    emit({"phase": "cache_validation", "metrics": val})
    if not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"cache-mode validation step not finite: {val}")
    phase_train_timing(torch, state, batch, device, smi, phase="cache_train_timing")
    return total


def write_calvin_split(root, seed: int):
    """A synthetic CALVIN split at CALVIN's frame sizes (200 px static, 84 px
    gripper): CALVIN_EPISODES episodes of CALVIN_EPISODE_LEN per-frame npz
    files, ep_start_end_ids.npy, one annotation an episode, and the
    extracted actions and frames (`data.extract`), from a seeded generator."""
    from mdt_policy_tpu_torch.data.extract import extract_by_key, extract_frames
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    n = CALVIN_EPISODES * CALVIN_EPISODE_LEN
    for i in range(n):
        np.savez(os.path.join(root, f"episode_{i:07d}.npz"),
                 rgb_static=rng.integers(0, 256, (200, 200, 3), dtype=np.uint8),
                 rgb_gripper=rng.integers(0, 256, (84, 84, 3), dtype=np.uint8),
                 robot_obs=rng.normal(size=15).astype(np.float32),
                 scene_obs=rng.normal(size=24).astype(np.float32),
                 rel_actions=rng.uniform(-1, 1, 7).astype(np.float32))
    bounds = [(e * CALVIN_EPISODE_LEN, (e + 1) * CALVIN_EPISODE_LEN - 1)
              for e in range(CALVIN_EPISODES)]
    np.save(os.path.join(root, "ep_start_end_ids.npy"), np.asarray(bounds, np.int64))
    texts = ["open the drawer", "push the red block to the left", "turn on the led light"]
    lang = {"info": {"indx": bounds},
            "language": {"ann": [texts[e % len(texts)] for e in range(CALVIN_EPISODES)],
                         "emb": rng.normal(size=(CALVIN_EPISODES, 1, 384)).astype(np.float32)}}
    os.makedirs(os.path.join(root, "lang_clip_resnet50"))
    np.save(os.path.join(root, "lang_clip_resnet50", "auto_lang_ann.npy"), lang,
            allow_pickle=True)
    extract_by_key(root, "rel_actions")
    extract_frames(root)


def expected_validation_launches(cfg, family: str):
    """Per validation step (both scopes, no dropout): MDT's as
    `expected_mdt_validation_launches`; MDT-V's the train step's tower and
    decoder kernels without the MAP head's four RMSNorms (no contrastive
    loss), and B2 at every self-attention of the DDIM-10 denoiser."""
    if family == "mdt":
        return expected_mdt_validation_launches(cfg)
    train = expected_train_launches(cfg)
    return {**train, "fused_rms_norm": train["fused_rms_norm"] - 2 * 2,
            "small_seq_mha": 2 * b2_per_replan(cfg)}


@contextlib.contextmanager
def counting_steps(launches: Launches):
    """`agents.train_step` and `agents.validation_step`, which `train()`
    looks up at each run, wrapped to record the launches of each call."""
    from mdt_policy_tpu_torch import agents
    calls = {"train_step": [], "validation_step": []}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            before = launches.read()
            out = fn(*args, **kwargs)
            after = launches.read()
            calls[name].append({k: after[k] - before[k] for k in after})
            return out
        return wrapper
    with mock.patch.object(agents, "train_step", counted("train_step", agents.train_step)), \
            mock.patch.object(agents, "validation_step",
                              counted("validation_step", agents.validation_step)):
        yield calls


def _metrics_rows(path):
    """metrics.csv as {column: float} rows (the header repeats when the
    columns grow)."""
    import csv
    rows, header = [], None
    with open(path) as f:
        for row in csv.reader(f):
            if row[0] == "step":
                header = row
            else:
                rows.append({k: float(v) for k, v in zip(header, row) if v != ""})
    return rows


def _run_config(family, log_dir, name, data_root, epochs, **trainer):
    from mdt_policy_tpu_torch.training import DataConfig, RunConfig, TrainerConfig
    trainer = {"batch_size": TRAIN_BATCH, "max_epochs": epochs,
               "steps_per_epoch": CLI_STEPS_PER_EPOCH, "limit_val_batches": 1,
               "seed": 5, "log_every": 1, "keep_checkpoints": 1, **trainer}
    return RunConfig(agent=family, log_dir=log_dir, run_name=name,
                     data=DataConfig(root_data_dir=data_root, num_workers=1),
                     trainer=TrainerConfig(**trainer))


def phase_train_cli(torch, family, device, launches: Launches, smi, root, bare):
    """`train()` at the production config of `family` over the synthetic
    split under `root`: 2 epochs of CLI_STEPS_PER_EPOCH steps, then the same
    run directory resumed to epoch 3, against a run of 3 epochs never
    interrupted (every trainable and EMA tensor within RESUME_REL_TOL
    relative; bit-equality reported). Launches asserted per train and
    validation step; the loop's chunks/s from metrics.csv beside the bare
    step's (`bare`, the train timing phase's row); the busy share of a
    profiled window; whether the recon grid was written."""
    from mdt_policy_tpu_torch.training import train
    log_dir = os.path.join(root, "runs")
    cfg = lambda name, epochs, **kw: _run_config(family, log_dir, name, root, epochs, **kw)
    profile = f"{CLI_STEPS_PER_EPOCH + 1}:{CLI_STEPS_PER_EPOCH + 3}"
    launches.reset()
    t0 = time.perf_counter()
    with counting_steps(launches) as calls:
        first = train(cfg(f"{family}_resumed", 2), device=device)
        first_step = first.step
        del first
        torch.cuda.empty_cache()
        resumed = train(cfg(f"{family}_resumed", 3), device=device)
        straight = train(cfg(f"{family}_straight", 3, profile_steps=profile), device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = launches.read()
    worst, bit_equal, n_tensors = 0.0, True, 0
    for kind, a, b in (("params", dict(resumed.net.trainable_parameters()),
                        dict(straight.net.trainable_parameters())),
                       ("ema", resumed.ema, straight.ema)):
        for k in b:
            x, y = a[k].detach().float(), b[k].detach().float()
            rel = ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
            worst = max(worst, rel)
            bit_equal = bit_equal and torch.equal(a[k], b[k])
            n_tensors += 1
    run = os.path.join(log_dir, f"{family}_straight")
    rows = [r for r in _metrics_rows(os.path.join(run, "metrics.csv")) if "perf/chunks_per_sec" in r]
    # steps that follow no epoch end (validation and save) and lie outside
    # the profiled window
    skip = {1 + e * CLI_STEPS_PER_EPOCH for e in range(3)} | \
        {CLI_STEPS_PER_EPOCH + 2, CLI_STEPS_PER_EPOCH + 3}
    loop = [r["perf/chunks_per_sec"] for r in rows if int(r["step"]) not in skip]
    with open(os.path.join(run, "profile", "summary.json")) as f:
        prof = json.load(f)
    with open(os.path.join(run, "system_info.json")) as f:
        info = json.load(f)
    media = os.path.join(run, "media")
    expected_train = (expected_train_launches if family == "mdtv"
                      else expected_mdt_train_launches)(straight.net.cfg)
    expected_val = expected_validation_launches(straight.net.cfg, family)
    losses = [r["train/total_loss"] for r in rows]
    row = {"phase": "train_cli", "family": family, "batch_per_stream": TRAIN_BATCH,
           "steps": {"first_run": first_step, "resumed": resumed.step, "straight": straight.step},
           "train_steps_counted": len(calls["train_step"]),
           "validation_steps_counted": len(calls["validation_step"]),
           "launches_per_step": calls["train_step"][0], "expected_per_step": expected_train,
           "launches_per_validation": calls["validation_step"][0],
           "expected_per_validation": expected_val, "launches": total,
           "resume_max_rel_err": worst, "resume_bound": RESUME_REL_TOL,
           "resume_bit_equal": bit_equal, "tensors_compared": n_tensors,
           "losses": losses, "finite": bool(np.all(np.isfinite(losses))),
           "loop_chunks_per_s": loop, "loop_chunks_per_s_median": float(np.median(loop)),
           "bare_step_chunks_per_s": bare["chunks_per_s"],
           "bare_step_ms_p50": bare["step_ms_p50"],
           "profiled_window": profile, "profile": prof,
           "recon_png_written": sorted(os.listdir(media)) if os.path.isdir(media) else [],
           "system_info": info,
           "seconds": seconds, "card": smi}
    emit(row)
    n_steps = 2 * CLI_STEPS_PER_EPOCH + CLI_STEPS_PER_EPOCH + 3 * CLI_STEPS_PER_EPOCH
    if not (row["finite"] and first_step == 2 * CLI_STEPS_PER_EPOCH
            and resumed.step == straight.step == 3 * CLI_STEPS_PER_EPOCH
            and len(calls["train_step"]) == n_steps and len(calls["validation_step"]) == 6):
        raise AssertionError(f"{family} train() runs went wrong: {row}")
    if any(c != expected_train for c in calls["train_step"]):
        raise AssertionError(f"{family} train() launches per step {calls['train_step']}, "
                             f"expected {expected_train}")
    if any(c != expected_val for c in calls["validation_step"]):
        raise AssertionError(f"{family} train() launches per validation "
                             f"{calls['validation_step']}, expected {expected_val}")
    if not worst <= RESUME_REL_TOL:
        raise AssertionError(f"{family} resumed run drifted from the straight one: {row}")
    if (row["system_info"]["cudnn_allow_tf32"] or row["system_info"]["matmul_allow_tf32"]
            or not row["system_info"]["cudnn_deterministic"]):
        raise AssertionError(f"train() left TF32 on or cuDNN free: {row['system_info']}")
    del resumed, straight
    shutil.rmtree(run)  # its checkpoint: disk space
    torch.cuda.empty_cache()
    return total, os.path.join(log_dir, f"{family}_resumed")


def phase_extract_cli(torch, device, launches: Launches, smi, root, run):
    """The extraction CLI (`data.extract_embeddings.main`) with the MDT-V run
    directory's towers over both splits under `root`; then `train()` in cache
    mode from what it wrote, CLI_STEPS_PER_EPOCH steps: no tower kernel a
    step, 30 B3 RMSNorms."""
    from mdt_policy_tpu_torch.data import extract_embeddings
    from mdt_policy_tpu_torch.evaluate import load_run_config
    from mdt_policy_tpu_torch.training import _make_agent, train
    cfg = _make_agent(load_run_config(run))
    launches.reset()
    seconds = {}
    for split in ("training", "validation"):
        t0 = time.perf_counter()
        extract_embeddings.main(["-i", os.path.join(root, split), "--train-folder", run,
                                 "--device", str(device)])
        torch.cuda.synchronize()
        seconds[split] = time.perf_counter() - t0
    extracted = launches.read()
    frames = CALVIN_EPISODES * CALVIN_EPISODE_LEN
    n_batches = -(-frames // EXTRACT_BATCH)
    fwd = n_batches + min(2, n_batches)  # the clean pass and the self-check
    per_batch = cfg.vit_depth + cfg.clip_vision_layers
    want = {"fused_qkv_attention": 0, "fused_rms_norm": 0,
            "fused_layer_norm": 2 * (3 * fwd + 1),
            "attention_halfblock": 2 * (per_batch * fwd + cfg.clip_text_layers),
            "mlp_halfblock": 2 * (per_batch * fwd + cfg.clip_text_layers),
            **NO_DENOISER, **NO_VARIANTS}
    log_dir = os.path.join(root, "runs")
    run_cfg = _run_config("mdtv", log_dir, "mdtv_cache", root, 1, log_recon_images=False)
    run_cfg.data.use_extracted_embeddings = True
    with counting_steps(launches) as calls:
        state = train(run_cfg, device=device)
    torch.cuda.synchronize()
    total = launches.read()
    expected = expected_cache_train_launches(cfg)
    rows = [r for r in _metrics_rows(os.path.join(log_dir, "mdtv_cache", "metrics.csv"))
            if "train/total_loss" in r]
    row = {"phase": "extract_cli", "frames_per_split": frames, "seconds": seconds,
           "frames_per_s": {k: frames / v for k, v in seconds.items()},
           "extraction_launches": extracted, "expected_extraction": want,
           "cache_steps": state.step, "cache_launches_per_step": calls["train_step"],
           "expected_per_step": expected,
           "cache_losses": [r["train/total_loss"] for r in rows],
           "cache_chunks_per_s": [r["perf/chunks_per_sec"] for r in rows],
           "launches": total, "card": smi}
    emit(row)
    if extracted != want:
        raise AssertionError(f"extraction CLI launches {extracted}, expected {want}")
    if not (state.step == CLI_STEPS_PER_EPOCH
            and all(c == expected for c in calls["train_step"])
            and all(np.isfinite(row["cache_losses"]))):
        raise AssertionError(f"cache-mode train() went wrong: {row}")
    del state
    torch.cuda.empty_cache()
    return total


def phase_tf32(torch, device, smi):
    """ROADMAP queue C: MDT with cuDNN's TF32 on and off from the same weights,
    frames and draws: the B=1 replan chunk, one train step's 9 losses, the
    two ResNets' f32 outputs against float64, and the train step's device
    ms, all with cuDNN's deterministic algorithms as `train()` runs them;
    then the step's device ms with TF32 off and cuDNN free to choose.
    Restores both TF32 flags (off) and the determinism flag afterwards."""
    from mdt_policy_tpu_torch.agents import (MDTConfig, denoise_actions, init_train_state,
                                             make_draws, train_step)
    cudnn = torch.backends.cudnn
    net = build_net(torch, MDTConfig(), device)
    cfg = net.cfg
    obs, goal = make_inputs(torch, cfg, 1, seed=2, device=device)
    noise = torch.randn((1, cfg.act_window_size, cfg.action_dim),
                        generator=torch.Generator().manual_seed(3)).to(device)
    batch = make_train_batch(torch, cfg, TRAIN_BATCH, device)
    state = init_train_state(net)

    def chunk():
        with torch.no_grad():
            emb = net.perceive(obs["rgb_static"], obs["rgb_gripper"])
            return denoise_actions(net, emb, net.encode_language_goal(goal["lang_tokens"]),
                                   noise=noise)

    def losses():
        twin = copy.deepcopy(state)
        gen = torch.Generator(device).manual_seed(8)
        draws = {k: make_draws(cfg, TRAIN_BATCH, gen) for k in sorted(batch)}
        m = train_step(twin, batch, draws=draws)
        out = {k: float(v) for k, v in m.items() if k.endswith("_loss")}
        del twin
        return out

    gen = torch.Generator(device).manual_seed(14)
    frames = {"static": torch.randn((8, 1, cfg.img_size, cfg.img_size, 3), generator=gen,
                                    device=device),
              "gripper": torch.randn((8, 1, 84, 84, 3), generator=gen, device=device)}
    f64 = {}
    with torch.no_grad():
        for cam in ("static", "gripper"):
            res = getattr(net, f"{cam}_resnet")
            f64[cam] = copy.deepcopy(res).double()(frames[cam].double())
    out = {}
    deterministic = cudnn.deterministic
    cudnn.deterministic = True
    for on in (False, True):
        cudnn.allow_tf32 = on
        with torch.no_grad():
            resnets = {cam: getattr(net, f"{cam}_resnet")(frames[cam]) for cam in frames}
        out[on] = {"chunk": chunk(), "losses": losses(), "resnets": resnets}
        twin = copy.deepcopy(state)
        step_gen = torch.Generator(device).manual_seed(9)
        out[on]["profile"] = profile_calls(torch, lambda: train_step(twin, batch,
                                                                     generator=step_gen), 2)
        del twin
    cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.deterministic = False
    twin = copy.deepcopy(state)
    step_gen = torch.Generator(device).manual_seed(9)
    free = profile_calls(torch, lambda: train_step(twin, batch, generator=step_gen), 2)
    del twin
    cudnn.deterministic = deterministic
    rel = lambda a, b: ((a.double() - b.double()).abs().max() /
                        b.double().abs().max().clamp_min(1e-30)).item()
    row = {"phase": "tf32", "family": "mdt", "flag": "torch.backends.cudnn.allow_tf32",
           "matmul_allow_tf32": False,
           "chunk_max_abs_diff_on_vs_off": (out[True]["chunk"] - out[False]["chunk"]
                                            ).abs().max().item(),
           "chunk_max_abs": out[False]["chunk"].abs().max().item(),
           "losses_off": out[False]["losses"], "losses_on": out[True]["losses"],
           "losses_max_rel_diff": max(abs(out[True]["losses"][k] - v) / max(abs(v), 1e-30)
                                      for k, v in out[False]["losses"].items()),
           "resnet_rel_err_vs_float64": {
               cam: {"tf32_off": rel(out[False]["resnets"][cam], f64[cam]),
                     "tf32_on": rel(out[True]["resnets"][cam], f64[cam])} for cam in frames},
           "step_device_ms": {"tf32_off": out[False]["profile"]["device_ms_per_call"],
                              "tf32_on": out[True]["profile"]["device_ms_per_call"]},
           "step_wall_ms": {"tf32_off": out[False]["profile"]["wall_ms_per_call"],
                            "tf32_on": out[True]["profile"]["wall_ms_per_call"]},
           "cudnn_deterministic": True,
           "step_device_ms_tf32_off_cudnn_free": free["device_ms_per_call"],
           "card": smi}
    emit(row)
    if not all(np.isfinite(v) for o in out.values() for v in o["losses"].values()):
        raise AssertionError(f"tf32 phase: a loss is not finite: {row}")
    del net, state, batch, out
    torch.cuda.empty_cache()
    return row


# train_rollout: the training-time rollouts once, after epoch 2 of 2
TRAIN_ROLLOUT_EPOCHS = 2
# the task rollout: demos discovered among these tasks, each solved this many
# env steps into its rollout, episodes of TASK_EP_LEN
TASK_DEMO_TASKS = ("open_drawer", "turn_on_led", "push_red_block_left")
TASK_SOLVE_AT, TASK_EP_LEN = 15, 60
VIDEO_FRAMES, VIDEO_EP_LEN = 40, 30  # RolloutVideo alone; the evaluate CLI's episode
DDP_TIMED_STEPS = 5  # a route of the ddp phase's step timing
DDP_CHILD_TIMEOUT_S = 600
TWO_RANK_LOSS_REL_TOL = 1e-5


class TaskOracle:
    """The task rollout's oracle: demo discovery gives each demo one of
    TASK_DEMO_TASKS, read off its end state's first scene value; a rollout
    solves its task TASK_SOLVE_AT env steps in."""

    def get_task_info(self, start_info, end_info):
        return {TASK_DEMO_TASKS[int(abs(end_info["scene_obs"][0]) * 10) % len(TASK_DEMO_TASKS)]}

    def get_task_info_for_set(self, start_info, current_info, subtasks):
        return set(subtasks) if current_info["t"] - start_info["t"] >= TASK_SOLVE_AT else set()


def make_task_env(dataset_path=None):
    """`task_rollout.env_target` of the train_rollout phase: the fake env at
    CALVIN's camera sizes."""
    from mdt_policy_tpu_torch.evaluation import FakeEnv
    return FakeEnv(img_hw=200, gripper_hw=84, seed=7)


def make_task_oracle():
    """`task_rollout.oracle_target` of the train_rollout phase."""
    return TaskOracle()


def _phase_calls(torch, name, fn, log, plans, captures):
    """`fn` wrapped to log, per call that returns metrics, its seconds and
    the policy replans and graph captures it made."""
    def wrapper(*args, **kwargs):
        p0, c0, t0 = plans.call_count, captures.call_count, time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        if out is not None:
            log[name] = {"seconds": time.perf_counter() - t0, "replans": plans.call_count - p0,
                         "captures": captures.call_count - c0, "metrics": out}
        return out
    return wrapper


def phase_train_rollout(torch, device, launches: Launches, smi, root):
    """`train()` of MDT-V at the production config over the synthetic split
    under `root` (B=128 per stream), 2 epochs of CLI_STEPS_PER_EPOCH steps,
    with both training-time rollouts after epoch 2: the chain rollout
    (ROLLOUT_CHAINS chains of ROLLOUT_EP_LEN-step episodes; the port's
    `make_calvin_env` and `make_task_oracle` patched to the fake env at
    CALVIN's camera sizes and phase_rollout's scripted oracle) and the task
    rollout (this script's `make_task_env` and `make_task_oracle`). Checks:
    the rollout's results, env steps and replans follow the oracle's rule;
    `best.json` names the epoch's step; the first rollout chunk equals, bit
    for bit, an eager `MDTVPolicy`'s on the EMA weights from the rollout's
    generator; B2 and B3 RMSNorm launch exactly the steps', validations'
    and replans' (warm-ups included) worth; and the run's final trainables
    and EMA (every tensor of the train state: parameters, EMA, Adam's
    moments and steps) equal, bit for bit, those of the same run with both
    rollouts off."""
    from mdt_policy_tpu_torch import training
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    from mdt_policy_tpu_torch.evaluation import (FakeEnv, ScriptedOracle, TASKS, annotations,
                                                 env_adapter, get_sequences)
    from mdt_policy_tpu_torch.training import (RolloutConfig, TaskRolloutConfig, ema_weights,
                                               stream_generator, train)
    log_dir = os.path.join(root, "runs")
    cfg = lambda name: _run_config("mdtv", log_dir, name, root, TRAIN_ROLLOUT_EPOCHS,
                                   log_recon_images=False)
    on, off = cfg("rollout_on"), cfg("rollout_off")
    on.rollout = RolloutConfig(enabled=True, num_sequences=ROLLOUT_CHAINS,
                               ep_len=ROLLOUT_EP_LEN, rollout_freq=1, skip_epochs=1)
    on.task_rollout = TaskRolloutConfig(
        enabled=True, skip_epochs=1, rollout_freq=1, rollouts_per_task=1, ep_len=TASK_EP_LEN,
        discovery_batches=1, id_selection_strategy="select_first",
        env_target=f"{__name__}.make_task_env", oracle_target=f"{__name__}.make_task_oracle")
    never = get_sequences(ROLLOUT_CHAINS)[0][1][2]
    oracle = ScriptedOracle({t: ROLLOUT_SOLVE_AT for t in TASKS if t != never})
    first = {}
    real_plan = MDTVPolicy.plan

    def plan(self, obs, goal):
        out = real_plan(self, obs, goal)
        if not first:  # the chain rollout's first replan
            first.update(obs={k: v.clone() for k, v in obs.items()}, goal=copy.deepcopy(goal),
                         chunk=out.clone())
        return out
    log = {}
    launches.reset()
    with contextlib.ExitStack() as stack:
        enter = lambda *a, **k: stack.enter_context(mock.patch.object(*a, **k))
        enter(env_adapter, "make_calvin_env",
              lambda path: FakeEnv(img_hw=200, gripper_hw=84, seed=0))
        enter(annotations, "make_task_oracle", lambda: oracle)
        plans = enter(MDTVPolicy, "plan", autospec=True, side_effect=plan)
        captures = enter(MDTVPolicy, "_capture", autospec=True, side_effect=MDTVPolicy._capture)
        for name in ("_maybe_rollout", "_maybe_task_rollout"):
            enter(training, name, _phase_calls(torch, name, getattr(training, name), log,
                                               plans, captures))
        calls = stack.enter_context(counting_steps(launches))
        t0 = time.perf_counter()
        state = train(on, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    total = launches.read()
    net_cfg = state.net.cfg
    with ema_weights(state):
        eager = MDTVPolicy(state.net, generator=stream_generator(5, "rollout", 2, device),
                           cuda_graph=False)
        chunk = eager.plan(first["obs"], first["goal"])
    first_bit_equal = bool(torch.equal(chunk, first["chunk"]))
    on_tensors = {k: v.detach().clone() for k, v in _state_tensors(state).items()}
    run = os.path.join(log_dir, "rollout_on")
    rows = _metrics_rows(os.path.join(run, "metrics.csv"))
    with open(os.path.join(run, "checkpoints", "best.json")) as f:
        best = json.load(f)
    del state, eager
    torch.cuda.empty_cache()
    off_state = train(off, device=device)
    off_tensors = _state_tensors(off_state)
    mismatched = sorted(set(on_tensors) ^ set(off_tensors)) + [
        k for k, v in on_tensors.items() if k in off_tensors and not torch.equal(v, off_tensors[k])]
    del off_state, on_tensors, off_tensors
    torch.cuda.empty_cache()

    want = oracle_results(get_sequences(ROLLOUT_CHAINS), never)
    want_steps, want_plans = expected_rollout(want, net_cfg.multistep)
    lh, tasks = log["_maybe_rollout"], log["_maybe_task_rollout"]
    lh_rows = [{k: v for k, v in r.items() if k.startswith("eval_lh/") or k == "step"}
               for r in rows if "eval_lh/avg_seq_len" in r]
    task_rows = [{k: v for k, v in r.items() if k.startswith("tasks/") or k == "step"}
                 for r in rows if "tasks/average_sr" in r]
    n_tasks = len([k for k in tasks["metrics"] if k.endswith("_vis_sr") and "average" not in k])
    task_steps = n_tasks * 2 * TASK_SOLVE_AT  # one rollout a task a modality
    per_run = expected_replan_launches(net_cfg, "mdtv")[1]
    runs = plans.call_count + MDTVPolicy.WARMUP_CALLS * captures.call_count
    exact = {"small_seq_mha": sum(c["small_seq_mha"] for c in calls["validation_step"])
             + runs * per_run["small_seq_mha"],
             "fused_rms_norm": sum(c["fused_rms_norm"] for c in calls["train_step"])
             + sum(c["fused_rms_norm"] for c in calls["validation_step"])
             + runs * per_run["fused_rms_norm"],
             "few_row_linear": runs * per_run["few_row_linear"]}
    row = {"phase": "train_rollout", "family": "mdtv", "batch_per_stream": TRAIN_BATCH,
           "epochs": TRAIN_ROLLOUT_EPOCHS, "steps_per_epoch": CLI_STEPS_PER_EPOCH,
           "chains": ROLLOUT_CHAINS, "ep_len": ROLLOUT_EP_LEN, "never_solves": never,
           "rollout_seconds": lh["seconds"], "rollout_replans": lh["replans"],
           "expected_replans": sum(want_plans), "rollout_env_steps": sum(want_steps),
           "rollout_env_steps_per_s": sum(want_steps) / lh["seconds"],
           "rollout_captures": lh["captures"], "eval_lh": lh_rows,
           "expected_avg_seq_len": float(np.mean(want)),
           "task_rollout_seconds": tasks["seconds"], "task_rollout_replans": tasks["replans"],
           "task_rollout_env_steps": task_steps,
           "task_rollout_env_steps_per_s": task_steps / tasks["seconds"],
           "task_rollout_captures": tasks["captures"], "tasks": task_rows,
           "best_json": best, "first_chunk_bit_equal_eager_on_ema": first_bit_equal,
           "rollouts_off_bit_equal": not mismatched, "tensors_mismatched": mismatched[:5],
           "train_steps_counted": len(calls["train_step"]),
           "validations_counted": len(calls["validation_step"]),
           "replan_runs": runs, "launches": total, "exact_expected": exact,
           "seconds": seconds, "card": smi}
    emit(row)
    steps = TRAIN_ROLLOUT_EPOCHS * CLI_STEPS_PER_EPOCH
    if not (lh_rows and lh_rows[-1]["eval_lh/avg_seq_len"] == float(np.mean(want))
            and [r["step"] for r in lh_rows] == [steps] and lh["replans"] == sum(want_plans)
            and best["step"] == steps and best["metric"] == float(np.mean(want))):
        raise AssertionError(f"the chain rollout inside train() went wrong: {row}")
    if not (n_tasks > 0 and [r["step"] for r in task_rows] == [steps]
            and task_rows[0]["tasks/average_sr"] == 1.0):
        raise AssertionError(f"the task rollout inside train() went wrong: {row}")
    if not (first_bit_equal and not mismatched):
        raise AssertionError(f"a rollout was not the EMA's, or it moved the run: {row}")
    if any(total[k] != v for k, v in exact.items()) or total["fused_qkv_attention"] < runs * \
            per_run["fused_qkv_attention"]:
        raise AssertionError(f"train_rollout launches disagree with its steps and replans: {row}")
    if len(calls["train_step"]) != steps or len(calls["validation_step"]) != TRAIN_ROLLOUT_EPOCHS:
        raise AssertionError(f"train_rollout ran other steps than asked: {row}")
    return total, run


def _gif_frames(path):
    from PIL import Image
    with Image.open(path) as im:
        return im.n_frames


def phase_video(torch, device, launches: Launches, smi, run):
    """`RolloutVideo` over VIDEO_FRAMES frames of a fake-env chain at
    CALVIN's static camera size (a success border, a caption), then
    `evaluate.main([... "--num-videos", "1"])` on the train_rollout run
    directory (one chain, VIDEO_EP_LEN-step episodes, the CLI's
    never-solving oracle). With PIL the GIFs are written and their frames
    counted; without it each call that needs PIL must raise an ImportError
    that names PIL ("pil": false), never skip the video."""
    from mdt_policy_tpu_torch import evaluate
    from mdt_policy_tpu_torch.evaluation import FakeEnv
    from mdt_policy_tpu_torch.evaluation.video import RolloutVideo
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    env = FakeEnv(img_hw=200, gripper_hw=84, seed=3)
    env.reset()
    rv = RolloutVideo(os.path.join(run, "video_phase"))
    rv.new_video("chain_0", caption="smoke")
    rv.new_subtask()
    for _ in range(VIDEO_FRAMES):
        rv.update(env.step(np.zeros(7, np.float32))[0]["rgb_obs"]["rgb_static"])
    rv.draw_outcome(True)
    args = ["--train-folder", run, "--fake-env", "--num-sequences", "1", "--device", str(device),
            "--ep-len", str(VIDEO_EP_LEN), "--num-videos", "1"]
    launches.reset()
    raised = []
    with contextlib.redirect_stdout(io.StringIO()):
        for call in (lambda: rv.add_language_instruction("open the drawer"), rv.write,
                     lambda: evaluate.main(args)):
            try:
                call()
            except ImportError as e:
                raised.append(str(e))
    torch.cuda.synchronize()
    total = launches.read()
    gif = os.path.join(run, "evaluation", "videos", "lh-sequence_0.gif")
    frames = (_gif_frames(os.path.join(run, "video_phase", "chain_0.gif")), _gif_frames(gif)) \
        if pil and not raised else None
    row = {"phase": "video", "pil": pil, "gif_frames": frames,
           "expected_frames": [VIDEO_FRAMES, VIDEO_EP_LEN], "import_errors": raised,
           "launches": total, "card": smi}
    emit(row)
    if pil and (raised or list(frames) != [VIDEO_FRAMES, VIDEO_EP_LEN]):
        raise AssertionError(f"video phase: the GIFs are not what was recorded: {row}")
    if not pil and not (len(raised) == 3 and all("PIL" in e for e in raised)):
        raise AssertionError(f"video phase: without PIL every video call must raise: {row}")
    return total


def _flat(torch, tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def ddp_child(device_type: str = "cuda", configs=None) -> int:
    """`--ddp-child`: the world-size-1 NCCL check of the ddp phase, in its own
    process (the group lives and dies here). Per family at the production
    config, B=128 per stream: one plain train step, then, in a group of one
    rank, the same step from the same state and generator; metrics,
    gradients, trainables and EMA must be bit-equal. Then the all-reduce's
    bytes and ms (CUDA events), the all-gather's forward and backward at the
    contrastive features' shape, and the step's ms without and with the
    group. One JSON line a family and one with the group steps' launches.
    (`device_type` "cpu" and small `configs`, {family: config}, rehearse it
    over gloo.)"""
    import torch
    sys.path.insert(0, REPO)
    from mdt_policy_tpu_torch import parallel
    from mdt_policy_tpu_torch.agents import MDTConfig, MDTVConfig, init_train_state, train_step
    from mdt_policy_tpu_torch.training import DistributedConfig
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # as train() runs: free to choose, cuDNN's convolution algorithms give
    # MDT's ResNet gradients other last bits from one step to the next
    torch.backends.cudnn.deterministic = True
    launches, group_launches = Launches(), None
    configs = configs or {"mdtv": MDTVConfig(), "mdt": MDTConfig()}
    for family, cfg in configs.items():
        batch = make_train_batch(torch, cfg, TRAIN_BATCH, device)
        out = {}
        for route in ("plain", "group"):
            if route == "group":
                parallel.init_distributed(DistributedConfig(
                    enabled=True, coordinator_address=f"localhost:{parallel.free_port()}",
                    num_processes=1, process_id=0), device)
                backend = torch.distributed.get_backend()
                before = launches.read()
            state = init_train_state(build_net(torch, cfg, device))
            metrics = {k: float(v) for k, v in train_step(
                state, batch, generator=torch.Generator(device).manual_seed(7)).items()}
            torch.cuda.synchronize()
            if route == "group":
                after = launches.read()
                delta = {k: after[k] - before[k] for k in after}
                group_launches = delta if group_launches is None else \
                    {k: group_launches[k] + delta[k] for k in delta}
            trainable = [p for _, p in state.net.trainable_parameters()]
            out[route] = {"metrics": metrics, "grads": _flat(torch, [p.grad for p in trainable]),
                          "params": _flat(torch, trainable),
                          "ema": _flat(torch, state.ema.values())}
            gen = torch.Generator(device).manual_seed(8)
            times = event_times(torch, lambda: train_step(state, batch, generator=gen),
                                DDP_TIMED_STEPS, warmup=1)
            out[route]["step_ms"] = times
            if route == "group":
                n_bytes = sum(p.grad.numel() * p.grad.element_size() for p in trainable)
                reduce_ms = event_ms(lambda: parallel.all_reduce_gradients(trainable), 10, torch)
                feats = torch.randn((TRAIN_BATCH, 1, cfg.latent_dim), device=device,
                                    requires_grad=True)
                gathered_ms = event_ms(lambda: parallel.all_gather_with_grad(feats), 10, torch)
                back = torch.randn((TRAIN_BATCH, 1, cfg.latent_dim), device=device)
                gather_bwd_ms = event_ms(
                    lambda: parallel.all_gather_with_grad(feats).backward(back), 10, torch)
                parallel.shutdown()
            del state
            torch.cuda.empty_cache()
        plain, group = out["plain"], out["group"]
        equal = {k: bool(torch.equal(plain[k], group[k])) for k in ("grads", "params", "ema")}
        equal["metrics"] = plain["metrics"] == group["metrics"]
        emit({"phase": "ddp", "family": family, "world_size": 1, "backend": backend,
              "batch_per_stream": TRAIN_BATCH, "bit_equal": equal,
              "losses": {k: v for k, v in group["metrics"].items() if k.endswith("loss")},
              "all_reduce_bytes": n_bytes, "all_reduce_ms": reduce_ms,
              "all_gather_shape": [TRAIN_BATCH, 1, cfg.latent_dim],
              "all_gather_fwd_ms": gathered_ms, "all_gather_fwd_bwd_ms": gather_bwd_ms,
              "step_ms_plain_p50": float(np.percentile(plain["step_ms"], 50)),
              "step_ms_group_p50": float(np.percentile(group["step_ms"], 50)),
              "step_ms_plain": plain["step_ms"], "step_ms_group": group["step_ms"]})
        if not all(equal.values()):
            raise AssertionError(f"{family}: the world-size-1 NCCL step differs from the "
                                 f"plain one: {equal}")
    emit({"phase": "ddp", "launches": group_launches})
    return 0


def _run_children(cmds, timeout: int):
    """Run the commands at once, each in a session of its own; kill every
    one's process group when all have ended or at the deadline. Returns
    their stdouts; raises on a timeout or a non-zero exit."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for cmd in cmds]
    deadline = time.perf_counter() + timeout
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=max(1.0, deadline - time.perf_counter())))
    finally:
        for proc in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, 9)
    for proc, (out, err) in zip(procs, outs):
        if proc.returncode != 0:
            print(out[-4000:], err[-4000:], file=sys.stderr)
            raise AssertionError(f"{proc.args} exited with {proc.returncode}")
    return [out for out, _ in outs]


def ddp_rank(rank: int, world: int, port: int, out: str) -> int:
    """`--ddp-rank`: one rank of the ddp phase's multi-rank `train()`, joined
    through torchrun's variables. After every step the trainables' bits are
    held against every other rank's (their int32 words all-reduced by MAX
    and by MIN must agree); the steps' averaged metrics and host ms (ending
    in a synchronize), the first step's batch, and after the last step the
    all-reduce's and the all-gather's ms on the card (CUDA events; the
    gradients are then equal on every rank, so averaging them again
    changes none) go to `out.<rank>`."""
    import pickle
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from mdt_policy_tpu_torch import agents, parallel
    from mdt_policy_tpu_torch.training import train
    with open(out + ".cfg", "rb") as f:
        cfg, device_type = pickle.load(f)
    real, records = agents.train_step, []

    cuda = device_type == "cuda"

    def step(state, batch, **kwargs):
        t0 = time.perf_counter()
        metrics = real(state, batch, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        trainable = [p for _, p in state.net.trainable_parameters()]
        words = torch.cat([p.detach().reshape(-1).view(torch.int32) for p in trainable])
        most, least = words.clone(), words.clone()
        dist.all_reduce(most, op=dist.ReduceOp.MAX)
        dist.all_reduce(least, op=dist.ReduceOp.MIN)
        record = {"identical": bool(torch.equal(most, least)), "step_ms": step_ms,
                  "metrics": parallel.reduce_metrics(metrics)}
        if not records:
            record["batch"] = {s: {k: v.cpu() for k, v in b.items()} for s, b in batch.items()}
        if len(records) == 2 and cuda:
            record["all_reduce_ms"] = event_ms(
                lambda: parallel.all_reduce_gradients(trainable), 10, torch)
            feats = torch.randn((TRAIN_BATCH, 1, state.net.cfg.latent_dim),
                                device=trainable[0].device)
            record["all_gather_fwd_ms"] = event_ms(
                lambda: parallel.all_gather_with_grad(feats), 10, torch)
        records.append(record)
        return metrics
    with mock.patch.object(agents, "train_step", step):
        train(cfg, device=device_type)
    torch.save(records, f"{out}.{rank}")
    return 0


def two_rank_train(torch, device_type: str, root, data=None, overrides=None):
    """`train()` on 2 ranks (NCCL on CUDA, gloo on the CPU), synthetic
    batches of TRAIN_BATCH a rank and stream, 3 steps, dropout off: the
    ranks' trainables bit-identical after every step, and the first step's
    losses (averaged over the ranks) within TWO_RANK_LOSS_REL_TOL of one
    process's step at the global batch (the ranks' batches, rank order)
    from the same initial weights and step generator."""
    import pickle

    from mdt_policy_tpu_torch import parallel
    from mdt_policy_tpu_torch.agents import (init_random_, init_train_state, make_agent_net,
                                             train_step)
    from mdt_policy_tpu_torch.training import DataConfig, _make_agent, stream_generator
    cfg = _run_config("mdtv", os.path.join(root, "runs"), "two_ranks", None, 1,
                      steps_per_epoch=3, keep_checkpoints=0, log_recon_images=False)
    cfg.data = data or DataConfig(root_data_dir=None)
    cfg.agent_overrides = {"attn_pdrop": 0.0, "resid_pdrop": 0.0, "mlp_pdrop": 0.0,
                           **(overrides or {})}
    out = os.path.join(root, "two_ranks")
    with open(out + ".cfg", "wb") as f:
        pickle.dump((cfg, device_type), f)
    port = parallel.free_port()
    t0 = time.perf_counter()
    _run_children([[sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r), "2",
                    str(port), out] for r in range(2)], DDP_CHILD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    records = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    net = init_random_(make_agent_net(_make_agent(cfg), device=device),
                       stream_generator(cfg.trainer.seed, "init", 0, "cpu"))
    batch = {s: {k: torch.cat([r[0]["batch"][s][k] for r in records]).to(device)
                 for k in records[0][0]["batch"][s]} for s in records[0][0]["batch"]}
    one = {k: float(v) for k, v in train_step(
        init_train_state(net), batch,
        generator=stream_generator(cfg.trainer.seed, "step", 0, device)).items()}
    losses = [k for k in one if k.endswith("loss")]
    rel = {k: abs(records[0][0]["metrics"][k] - one[k]) / max(abs(one[k]), 1e-30)
           for k in losses}
    row = {"ranks": 2, "steps": len(records[0]), "device": device_type,
           "batch_per_stream_a_rank": cfg.trainer.batch_size,
           "identical_after_each_step": [r["identical"] for r in records[0]],
           "step_ms": [[r["step_ms"] for r in rec] for rec in records],
           **{k: records[0][-1][k] for k in ("all_reduce_ms", "all_gather_fwd_ms")
              if k in records[0][-1]},
           "losses_step1": {k: records[0][0]["metrics"][k] for k in losses},
           "losses_one_process": {k: one[k] for k in losses}, "max_rel_err": max(rel.values()),
           "bound": TWO_RANK_LOSS_REL_TOL, "seconds": seconds}
    if not (len(records[0]) == 3 and all(r["identical"] for rec in records for r in rec)
            and row["max_rel_err"] <= TWO_RANK_LOSS_REL_TOL):
        raise AssertionError(f"2-rank train() went wrong: {row}")
    return row


def ddp_only() -> int:
    """`--ddp-only`: the device and build phases, then the ddp phase alone
    (on a machine with two or more cards, the 2-rank `train()` too)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = phase_device(torch)
    phase_build()
    with tempfile.TemporaryDirectory() as root:
        emit({"phase": "ddp", "launches": phase_ddp(torch, device, smi, root)})
    return 0


def phase_ddp(torch, device, smi, root):
    """The world-size-1 NCCL step against the plain one, in a child process
    (`ddp_child`), its lines passed on; where the machine has two cards,
    `two_rank_train` on NCCL too. Returns the group steps' launches."""
    out = _run_children([[sys.executable, os.path.abspath(__file__), "--ddp-child"]],
                        DDP_CHILD_TIMEOUT_S)[0]
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for row in rows:
        emit({**row, "card": smi})
    ranks_2 = two_rank_train(torch, "cuda", root) if torch.cuda.device_count() >= 2 \
        else "not run: 1 device"
    emit({"phase": "ddp", "ranks_2": ranks_2, "card": smi})
    return next(r["launches"] for r in rows if "launches" in r)


# --- the rest of the JAX package: annotator, misc modules, loader, FLOPs ---

ANNOTATOR_TASK = "open_drawer"  # the scripted oracle's task (train table)
ANNOTATOR_PLAIN = 16  # sentences of the table held against the plain route
# |card - plain| / max(1, max |plain|): the CLIP text tower in bf16 (12
# layers of B1 and B3 in bf16), MiniLM in f32 (B3 f32 only)
ANNOTATOR_TOL = {"clip": 5e-2, "minilm": 1e-4}
MINILM_VOCAB_PIECES = ["##s", "##ed", "##ing", "##er", "##ly"] + [
    f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz"]
MISC_BATCH = 32
MISC_WIDTH, MISC_HEADS, MISC_LAYERS, MISC_T, MISC_CTX = 384, 8, 4, 10, 4  # MDT-V's denoiser
MISC_TOL = {"float32": 1e-4, "bfloat16": 6e-2}  # |card - plain| / max(1, max |plain|)
# bench_loader's CLI defaults (batch 128, 50 batches) over 1,000 frames, not its
# 2,000: writing 2,000 took the phase past a minute on a slow host
LOADER_FRAMES, LOADER_BATCH, LOADER_STEPS = 1000, 128, 50
LOADER_SHARDS, LOADER_SHARD_STEPS, PREFETCH_STEPS = (1, 2, 4), 20, 20


def write_minilm_folder(torch, root, weights: str):
    """A MiniLM-L3 folder as `minilm_embed_fn` reads it: config.json (HF
    keys), vocab.txt (the special tokens, every word of both annotation
    tables, `##` pieces, `[unusedN]` filler up to 30,522) and
    `MINILM_L3_CONFIG` weights from a seeded generator in HF's key layout,
    written as `pytorch_model.bin` (`weights` "bin") or
    `model.safetensors` by the port's writer."""
    import re

    from mdt_policy_tpu_torch.agents import init_random_
    from mdt_policy_tpu_torch.evaluation.annotations import (train_annotations,
                                                             validation_annotations)
    from mdt_policy_tpu_torch.models.minilm import MINILM_L3_CONFIG, MiniLMEncoder
    from mdt_policy_tpu_torch.utils.safetensors_io import save_safetensors
    c = MINILM_L3_CONFIG
    os.makedirs(root)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"vocab_size": c["vocab_size"], "hidden_size": c["hidden_size"],
                   "num_hidden_layers": c["num_layers"], "num_attention_heads": c["num_heads"],
                   "intermediate_size": c["intermediate_size"],
                   "max_position_embeddings": c["max_position_embeddings"],
                   "type_vocab_size": c["type_vocab_size"],
                   "layer_norm_eps": c["layer_norm_eps"]}, f)
    sentences = [s for table in (train_annotations(), validation_annotations())
                 for v in table.values() for s in v]
    words = sorted({w for s in sentences for w in re.findall(r"\w+|[^\w\s]", s.lower())})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + MINILM_VOCAB_PIECES
    vocab += [f"[unused{i}]" for i in range(c["vocab_size"] - len(vocab))]
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    enc = init_random_(MiniLMEncoder(**c), torch.Generator().manual_seed(15))
    sd = enc.state_dict()
    if weights == "bin":
        torch.save(sd, os.path.join(root, "pytorch_model.bin"))
    else:
        save_safetensors({k: v.numpy() for k, v in sd.items()},
                         os.path.join(root, "model.safetensors"))
    return root


def phase_annotator(torch, device, launches: Launches, smi, split, root):
    """`lang_annotator.main` over the split at CALVIN's frame sizes with
    `--scripted-oracle ANNOTATOR_TASK --validation`, once with `--embedder
    clip` (the random-init `MDTVConfig()` text tower, bf16, B1 and B3) and
    once with `minilm:<dir>` (a seeded MiniLM-L3 folder, f32, B3): the
    files' shapes ((N, 1, 512), (N, 1, 384); 34 goals) and finite values,
    each sentence's launches (B1 12 and B3 25 a CLIP sentence, B3 7 a MiniLM
    one), the file's rows equal to the embedder's, ANNOTATOR_PLAIN table
    sentences on the card against the plain route, sentences/s over the
    389-sentence table one sentence a call, as the CLI embeds; the MiniLM
    folder written as `pytorch_model.bin` and as `model.safetensors`, the
    two files' tensors and embeddings bit-equal."""
    from pathlib import Path

    from mdt_policy_tpu_torch.data import lang_annotator
    from mdt_policy_tpu_torch.evaluation.annotations import train_annotations
    from mdt_policy_tpu_torch.models.minilm import _load_state_dict
    dirs = {w: write_minilm_folder(torch, os.path.join(root, f"minilm_{w}"), w)
            for w in ("bin", "safetensors")}
    a, b = (_load_state_dict(Path(d)) for d in dirs.values())
    files_equal = a.keys() == b.keys() and all(
        torch.equal(a[k], torch.from_numpy(b[k])) for k in a)
    table = [s for v in train_annotations().values() for s in v]
    per_sentence = {"clip": {"fused_qkv_attention": 12, "fused_layer_norm": 25},
                    "minilm": {"fused_layer_norm": 7}}
    built = {}
    make = lang_annotator.make_embed_fn

    def capture(spec, *args, **kwargs):
        built[spec] = make(spec, *args, **kwargs)
        return built[spec]

    total = {k: 0 for k in launches.read()}
    rows = []
    for name, spec, width in (("clip", "clip", 512),
                              ("minilm", f"minilm:{dirs['bin']}", 384)):
        out = os.path.join(root, f"lang_{name}")
        launches.reset()
        t0 = time.perf_counter()
        with mock.patch.object(lang_annotator, "make_embed_fn", capture):
            lang_annotator.main(["--root", split, "--out", out, "--embedder", spec,
                                 "--scripted-oracle", ANNOTATOR_TASK, "--validation",
                                 "--device", str(device)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli = launches.read()
        ann = np.load(os.path.join(out, "auto_lang_ann.npy"), allow_pickle=True).item()
        goals = np.load(os.path.join(out, "embeddings.npy"), allow_pickle=True).item()
        emb, sentences = ann["language"]["emb"], ann["language"]["ann"]
        n = len(sentences) + len(goals)
        embed = built.pop(spec)
        t0 = time.perf_counter()
        for s in table:
            embed(s)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        card = np.stack([embed(s) for s in table[:ANNOTATOR_PLAIN]])
        rows_again = np.stack([embed(s) for s in sentences])
        with plain_kernels():
            plain = np.stack([embed(s) for s in table[:ANNOTATOR_PLAIN]])
        timed = launches.read()
        for k in total:
            total[k] += timed[k]
        expected = {k: per_sentence[name].get(k, 0) * n for k in ("fused_qkv_attention",
                                                                 "fused_layer_norm",
                                                                 "small_seq_mha")}
        err = float(np.abs(card - plain).max())
        row = {"phase": "annotator", "embedder": name, "windows": len(sentences),
               "goals": len(goals), "emb_shape": list(emb.shape),
               "finite": bool(np.isfinite(emb).all()
                              and all(np.isfinite(g["emb"]).all() for g in goals.values())),
               "cli_s": cli_s, "cli_launches": {k: cli[k] for k in expected},
               "expected_cli_launches": expected,
               "sentences_per_s": len(table) / seconds, "timed_sentences": len(table),
               "max_abs_err": err, "tol": ANNOTATOR_TOL[name] * max(1.0, float(np.abs(plain).max())),
               "file_rows_err": float(np.abs(rows_again - emb[:, 0]).max()), "card": smi}
        if name == "minilm":
            other = lang_annotator.make_embed_fn(f"minilm:{dirs['safetensors']}", device=device)
            row["weight_files_bit_equal"] = files_equal and all(
                np.array_equal(other(s), embed(s)) for s in table[:ANNOTATOR_PLAIN])
        emit(row)
        rows.append(row)
        del embed
        torch.cuda.empty_cache()
        if not (row["finite"] and emb.shape == (len(sentences), 1, width) and sentences
                and len(goals) == 34 and all(g["emb"].shape == (width,) for g in goals.values())
                and row["cli_launches"] == expected and err <= row["tol"]
                and row["file_rows_err"] <= row["tol"]
                and row.get("weight_files_bit_equal", True)):
            raise AssertionError(f"annotator ({name}) failed its checks: {row}")
    return total


def _misc_cases(torch, device):
    """(name, dtype name, module, args, kwargs) of every module the JAX
    package holds beyond the agents' paths, at MDT-V's denoiser width (and
    the towers at 224 px, B=32, bf16), seeded random weights."""
    from mdt_policy_tpu_torch.agents import init_random_
    from mdt_policy_tpu_torch.models import blocks as pb
    from mdt_policy_tpu_torch.models import encoders_misc as enc
    from mdt_policy_tpu_torch.models import position_embeddings as pe
    gen = torch.Generator().manual_seed(16)
    D, H, L, T = MISC_WIDTH, MISC_HEADS, MISC_LAYERS, MISC_T

    def build(module, tower_bf16=None):
        module = init_random_(module, gen).to(device).eval()
        if tower_bf16 is not None:
            getattr(module, tower_bf16).to(torch.bfloat16)
        return module

    draw = lambda *shape: torch.randn(shape, generator=gen).to(device)
    x, ctx, ctx_t, c = (draw(MISC_BATCH, T, D), draw(MISC_BATCH, MISC_CTX, D),
                        draw(MISC_BATCH, T, D), draw(MISC_BATCH, 1, D))
    mask = (torch.rand((T, T), generator=gen) > 0.3).fill_diagonal_(True).to(device)
    conds = [draw(MISC_BATCH, MISC_CTX, D) for _ in range(L)]
    cases = []
    for dt in ("float32", "bfloat16"):
        kw = {"dtype": getattr(torch, dt)}
        cases += [
            ("attention_rotary", dt, build(pb.Attention(D, H, use_rot_embed=True, **kw)),
             (x,), {}),
            ("attention_rotary_xpos_causal", dt, build(pb.Attention(
                D, H, causal=True, use_rot_embed=True, rotary_xpos=True, **kw)), (x,), {}),
            ("attention_rotary_xpos_masked", dt, build(pb.Attention(
                D, H, use_rot_embed=True, rotary_xpos=True, **kw)), (x,),
             {"custom_attn_mask": mask}),
            ("encoder", dt, build(pb.TransformerEncoder(D, H, L, **kw)), (x,), {}),
            ("encoder_masked", dt, build(pb.TransformerEncoder(D, H, L, bias=True, **kw)),
             (x,), {"custom_attn_mask": mask}),
            ("decoder", dt, build(pb.TransformerDecoder(D, H, L, **kw)), (x, ctx), {}),
            ("film_decoder", dt, build(pb.TransformerFiLMDecoder(D, H, L, **kw)),
             (x, c, ctx), {}),
            ("noise_decoder", dt, build(pb.TransformerFiLMDecoder(
                D, H, L, use_noise_encoder=True, **kw)), (x, c, ctx), {}),
            ("film_decoder_masked", dt, build(pb.TransformerFiLMDecoder(D, H, L, **kw)),
             (x, c, ctx_t), {"custom_attn_mask": mask})]
    cases += [
        ("encoder_interleaved", "float32", build(pb.TransformerEncoderInterleaved(D, H, L)),
         (x,), {}),
        ("film_encoder", "float32", build(pb.TransformerFiLMEncoder(D, H, L, D)), (x, c), {}),
        ("cross_attention_encoder", "float32",
         build(pb.TransformerCrossAttentionEncoder(D, H, L)), (x, ctx), {}),
        ("cross_attention_only_encoder", "float32",
         build(pb.TransformerCrossAttentionOnlyEncoder(D, H, L)), (x, ctx), {}),
        ("siamnese_decoder", "float32", build(pb.SiamneseDecoder(D, H, L)), (x, ctx), {}),
        ("film_decoder_interleaved", "float32",
         build(pb.TransformerFiLMDecoderInterleaved(D, H, L, D)), (x, c, conds), {}),
        ("noise_decoder_interleaved", "float32", build(pb.TransformerFiLMDecoderInterleaved(
            D, H, L, D, use_noise_encoder=True)), (x, c, conds), {})]
    cases += [(f"clip_proj_{style}", "float32",
               build(pb.ClipStyleProjection(style, token_dim=D, num_token=MISC_CTX)), (ctx,), {})
              for style in pb.CLIP_STYLES]
    sigma = draw(MISC_BATCH).exp()
    cases += [("relative_position_bias", "float32", build(pe.RelativePositionBias(heads=H)),
               (T, T), {}),
              ("dynamic_position_bias", "float32", build(pe.DynamicPositionBias(64, heads=H)),
               (T, T), {}),
              ("gaussian_fourier", "float32", build(enc.GaussianFourierEmbedding(D)), (sigma,), {}),
              ("fourier_features", "float32", build(enc.FourierFeatures(D)), (sigma,), {}),
              ("sinusoidal_time", "float32", build(enc.SinusoidalTimeEmbedding(D)), (sigma,), {})]
    images = torch.randn((MISC_BATCH, 224, 224, 3), generator=gen).to(device, torch.bfloat16)
    cases += [
        ("voltron_map_encoder", "bfloat16", build(enc.VoltronMAPEncoder(), "vcond"),
         (images,), {}),
        ("clip_vision_tokens", "bfloat16", build(enc.CLIPVisionTokens()).to(torch.bfloat16),
         (images,), {}),
        ("vision_clip_head_vit", "bfloat16", build(enc.VisionClipHead(), "clip"), (images,), {}),
        ("vision_clip_head_rn50", "bfloat16",
         build(enc.VisionClipHead(clip_embed_dim=1024, family="resnet"), "clip"), (images,), {})]
    return cases


def phase_misc_modules(torch, device, launches: Launches, smi):
    """Every module of the JAX package outside the agents' paths, once on
    the card (`_misc_cases`): the rotary, xpos and masked attention, the
    block stacks at MDT-V's denoiser width in f32 and bf16, the other six
    encoders and decoders, every `ClipStyleProjection` style, the position
    biases and time embeddings, and the perceptual encoders at 224 px,
    B=32, bf16 towers; each against its plain route on the card (MISC_TOL
    relative to max(1, max |plain|)), B1, B2 and B3 launches counted."""
    from mdt_policy_tpu_torch.models import NoEncoder
    rows = []
    launches.reset()
    for name, dt, module, args, kwargs in _misc_cases(torch, device):
        with torch.no_grad():
            before = launches.read()
            out = module(*args, **kwargs)
            torch.cuda.synchronize()
            after = launches.read()
            with plain_kernels():
                ref = module(*args, **kwargs)
        outs, refs = (o if isinstance(o, list) else [o] for o in (out, ref))
        err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs))
        scale = max(1.0, max(float(r.float().abs().max()) for r in refs))
        rows.append({"module": name, "dtype": dt, "shape": list(outs[-1].shape),
                     "max_abs_err": err, "tol": MISC_TOL[dt] * scale,
                     "finite": all(bool(torch.isfinite(o).all()) for o in outs),
                     "launches": {k: after[k] - before[k] for k in
                                  ("fused_qkv_attention", "small_seq_mha", "fused_layer_norm",
                                   "fused_rms_norm", "few_row_linear") if after[k] > before[k]}})
        del module, out, ref
    total = launches.read()
    probe = torch.ones(1)
    row = {"phase": "misc_modules", "modules": rows, "launches": total,
           "no_encoder_identity": NoEncoder()(probe) is probe, "card": smi}
    emit(row)
    torch.cuda.empty_cache()
    bad = [r for r in rows if not (r["finite"] and r["max_abs_err"] <= r["tol"])]
    if bad or not row["no_encoder_identity"]:
        raise AssertionError(f"misc_modules: modules off their plain route: {bad}")
    return total


def phase_loader_bench(torch, device, smi, root):
    """`data/bench_loader.py` at its CLI's defaults (LOADER_FRAMES frames at
    CALVIN's 200 / 84 px, batch 128, 50 batches): the frames path, the
    shard scaling at LOADER_SHARDS shards (LOADER_SHARD_STEPS batches a
    shard process, `CUDA_VISIBLE_DEVICES=""`), `DevicePrefetcher` over the
    frames loader (pinned copies and `train_batch` on the card), and the
    embedding-cache path over a production-shape fabricated cache; with
    the seconds to write the split and the cache."""
    from pathlib import Path

    from mdt_policy_tpu_torch.data import bench_loader
    from mdt_policy_tpu_torch.data.extract import extract_by_key, extract_frames
    t0 = time.perf_counter()
    split = bench_loader.generate_dataset(Path(root) / "training", LOADER_FRAMES)
    extract_by_key(split)
    extract_frames(split)
    write_s = time.perf_counter() - t0
    frames = bench_loader.bench(split, batch_size=LOADER_BATCH, steps=LOADER_STEPS)
    scaling = [bench_loader.scaling_bench(split, n, batch_size=LOADER_BATCH,
                                          steps=LOADER_SHARD_STEPS) for n in LOADER_SHARDS]
    prefetch = bench_loader.bench_prefetcher(split, device=device, batch_size=LOADER_BATCH,
                                             steps=PREFETCH_STEPS)
    t0 = time.perf_counter()
    bench_loader.fabricate_embedding_cache(split)
    cache_s = time.perf_counter() - t0
    cache = bench_loader.bench_embeddings(split, batch_size=LOADER_BATCH, steps=LOADER_STEPS)
    row = {"phase": "loader_bench", "frames": LOADER_FRAMES, "write_split_s": write_s,
           "frames_path": frames, "scaling": scaling, "prefetcher": prefetch,
           "write_cache_s": cache_s, "embedding_cache": cache, "card": smi}
    emit(row)
    counts = [s["chunks"] for s in scaling]
    if not (frames["extracted_frames"] and counts == [n * LOADER_SHARD_STEPS * LOADER_BATCH
                                                      for n in LOADER_SHARDS]
            and min(frames["chunks_per_sec"], prefetch["chunks_per_sec"],
                    cache["chunks_per_sec"]) > 0):
        raise AssertionError(f"loader_bench failed its checks: {row}")
    return row


def phase_flops(torch, state, batch, device, smi, family: str, timing):
    """One train step under `FlopCounterMode` (the aten ops' FLOPs; B1's
    launches dispatch none) with B1's call sites tallying 4 B T^2 C a call,
    which must equal `utils/flops.py`'s formula; their sum over the timing
    phase's p50 step time, as a share of the bf16 dense peak (989 TFLOP/s,
    `mfu`) and of the f32 peak (67 TFLOP/s; the steps are f32)."""
    from torch.utils.flop_counter import FlopCounterMode

    from mdt_policy_tpu_torch.agents import train_step
    from mdt_policy_tpu_torch.models import clip, voltron_vit
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
    from mdt_policy_tpu_torch.utils import flops
    tally = []

    def counted(qkv, n_heads, causal=False):
        tally.append(flops.attention_matmul_flops(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))
        return fused_qkv_attention(qkv, n_heads, causal)

    gen = torch.Generator(device).manual_seed(10)
    with mock.patch.object(clip, "fused_qkv_attention", counted), \
            mock.patch.object(voltron_vit, "fused_qkv_attention", counted), \
            FlopCounterMode(display=False) as counter:
        train_step(state, batch, generator=gen)
    torch.cuda.synchronize()
    formula = (flops.tower_custom_call_flops if family == "mdtv"
               else flops.mdt_tower_custom_call_flops)(state.net.cfg, TRAIN_BATCH, device)
    counted_flops = counter.get_total_flops()
    total = counted_flops + formula
    step_s = timing["step_ms_p50"] / 1e3
    row = {"phase": "flops", "family": family, "batch_per_stream": TRAIN_BATCH,
           "flop_counter": counted_flops, "b1_flops": formula, "b1_tally": sum(tally),
           "total_flops": total, "step_ms_p50": timing["step_ms_p50"],
           "tflops_per_s": total / step_s / 1e12,
           "mfu": total / step_s / PEAK_FLOPS["bfloat16"],
           "f32_peak_share": total / step_s / PEAK_FLOPS["float32"], "card": smi}
    emit(row)
    if sum(tally) != formula or formula <= 0 or counted_flops <= 0:
        raise AssertionError(f"flops: B1's tally is not the formula's: {row}")
    return row


def kernel_entry(name, source, replaces, launches, rows, main):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "dtype": main["dtype"],
            **({"library_device_ms": main["library_device_ms"]}
               if "library_device_ms" in main else {})}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mdt_policy_tpu_torch.agents import MDTConfig, MDTVConfig
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = phase_device(torch)
    phase_build()
    rows = {"b1": phase_kernel_b1(torch, device), "b3": phase_kernel_b3(torch, device),
            "b2": phase_kernel_b2(torch, device) + phase_kernel_b2_edges(torch, device),
            "b6": phase_kernel_b6(torch, device),
            "hb": phase_kernel_halfblocks(torch, device)}
    launches = Launches()
    rows["var"], variant_launches = phase_attn_variants(torch, device, launches, smi)
    torch.cuda.empty_cache()
    net = build_net(torch, MDTVConfig(), device)
    paths = {"replan": phase_replan(torch, net, device, launches, "mdtv")}
    phase_graph(torch, net, device, launches, smi, "mdtv")
    phase_e2e(torch, net, device, launches, "mdtv")
    phase_timing(torch, net, device, smi, "mdtv")
    phase_b2_ab(torch, net, device, smi)
    for batch in (1, 3):  # 10 and 30 rows: B6's route from its fewest rows to near MAX_ROWS
        phase_b6_ab(torch, net, device, smi, "mdtv", batch)
    mdt = build_net(torch, MDTConfig(), device)
    paths["mdt_replan"] = phase_replan(torch, mdt, device, launches, "mdt")
    phase_graph(torch, mdt, device, launches, smi, "mdt")
    phase_e2e(torch, mdt, device, launches, "mdt")
    phase_timing(torch, mdt, device, smi, "mdt")
    for batch in (1, 3):
        phase_b6_ab(torch, mdt, device, smi, "mdt", batch)
    paths["samplers"], _ = phase_samplers(torch, net, device, launches, smi)
    paths["configs"], paths["configs_bf16"], _ = phase_configs(
        torch, device, launches, smi, {"mdtv": net, "mdt": mdt})
    torch.cuda.empty_cache()
    paths["rollout"], _ = phase_rollout(torch, {"mdtv": net, "mdt": mdt}, device,
                                        launches, smi)
    torch.cuda.empty_cache()
    state, batch, paths["train"] = phase_train(torch, net, device, launches)
    phase_train_e2e(torch, state, batch, device, launches)
    bare = {"mdtv": phase_train_timing(torch, state, batch, device, smi)}
    phase_flops(torch, state, batch, device, smi, "mdtv", bare["mdtv"])
    del batch
    torch.cuda.empty_cache()
    mdt_state, batch, paths["mdt_train"] = phase_train(torch, mdt, device, launches, "mdt")
    phase_train_e2e(torch, mdt_state, batch, device, launches, phase="mdt_train_e2e")
    bare["mdt"] = phase_train_timing(torch, mdt_state, batch, device, smi,
                                     phase="mdt_train_timing")
    phase_flops(torch, mdt_state, batch, device, smi, "mdt", bare["mdt"])
    paths["mdt_validation"] = phase_validation(torch, mdt, batch, device, launches,
                                               "mdt_validation")
    del batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        runs = phase_checkpoint(torch, {"mdtv": state, "mdt": mdt_state}, device, smi, root)
        del state, mdt_state, mdt
        torch.cuda.empty_cache()
        # MDT-V's evaluation takes the run converted from a reference file
        source, runs["mdtv"] = phase_reference_ckpt(torch, device, smi, root)
        paths["evaluate_cli"] = phase_evaluate_cli(torch, runs, device, launches, smi,
                                                   sources={"mdtv": source})
    del runs, source
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        paths["extract"] = phase_extract(torch, net, device, launches, smi, root)
        paths["cache_train"] = phase_cache_train(torch, net, device, launches, smi,
                                                 os.path.join(root, "extracted"))
    del net
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        for split, seed in (("training", 20), ("validation", 21)):
            write_calvin_split(os.path.join(root, split), seed)
        paths["train_cli"], run = phase_train_cli(torch, "mdtv", device, launches, smi,
                                                  root, bare["mdtv"])
        mdt_cli, mdt_run = phase_train_cli(torch, "mdt", device, launches, smi, root,
                                           bare["mdt"])
        shutil.rmtree(mdt_run)
        paths["train_cli"] = {k: v + mdt_cli[k] for k, v in paths["train_cli"].items()}
        paths["extract_cli"] = phase_extract_cli(torch, device, launches, smi, root, run)
        shutil.rmtree(run)  # its checkpoint: disk space
        paths["train_rollout"], run = phase_train_rollout(torch, device, launches, smi, root)
        paths["video"] = phase_video(torch, device, launches, smi, run)
        paths["annotator"] = phase_annotator(torch, device, launches, smi,
                                             os.path.join(root, "training"), root)
    torch.cuda.empty_cache()
    paths["misc_modules"] = phase_misc_modules(torch, device, launches, smi)
    with tempfile.TemporaryDirectory() as root:
        phase_loader_bench(torch, device, smi, root)
    phase_tf32(torch, device, smi)
    with tempfile.TemporaryDirectory() as root:
        paths["ddp"] = phase_ddp(torch, device, smi, root)
    paths["attn_variants"] = variant_launches
    emit(summary(rows, paths))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def summary(rows, paths):
    """The kernels line: each kernel at its main shape (bf16 for the towers'
    kernels and the microbench's V1 and V3, f32 for B2, whose path is the
    f32 denoiser), with its launches on each path; fails if a kernel was not
    launched on one of the paths it belongs to."""
    replans = ("replan", "mdt_replan", "rollout", "evaluate_cli", "train_cli", "train_rollout",
               "video", "samplers", "configs")
    entries = []
    for name, source, replaces, kind, shape, dtype, own in (
            ("fused_qkv_attention", "fused_qkv_attention.cu",
             "mdt_policy_tpu/ops/fused_qkv_attention.py:124", "b1", "voltron_train",
             "bfloat16", replans + ("train", "mdt_train", "mdt_validation", "ddp", "annotator",
                                    "misc_modules")),
            ("fused_layer_norm", "fused_norm.cu", "mdt_policy_tpu/ops/fused_norm.py:134",
             "b3", "clip_vision_train", "bfloat16",
             replans + ("train", "mdt_train", "mdt_validation", "extract", "extract_cli",
                        "ddp", "annotator", "misc_modules")),
            ("fused_rms_norm", "fused_norm.cu", "mdt_policy_tpu/ops/fused_norm.py:159",
             "b3", "voltron_train", "bfloat16", ("replan", "rollout", "evaluate_cli", "train",
                                                 "mdt_train", "mdt_validation", "cache_train",
                                                 "train_cli", "extract_cli", "train_rollout",
                                                 "video", "ddp", "samplers", "configs",
                                                 "misc_modules")),
            ("small_seq_mha", "small_seq_mha.cu",
             "mdt_policy_tpu/ops/pallas_attention.py:77", "b2", "mdtv_dec_b32", "float32",
             replans + ("mdt_validation", "extract_cli", "configs_bf16", "misc_modules")),
            ("few_row_linear", "few_row_linear.cu", "none (XLA's dense layers)", "b6",
             "mdtv_qkv_kv", "float32", ("replan", "mdt_replan", "rollout", "evaluate_cli",
                                        "train_rollout", "video", "samplers", "configs")),
            ("attention_halfblock", "attention_halfblock.cu",
             "mdt_policy_tpu/ops/attention_halfblock.py:145", "hb", "voltron", "bfloat16",
             ("extract", "extract_cli")),
            ("mlp_halfblock", "halfblock_gemm.cu", "mdt_policy_tpu/ops/mlp_halfblock.py:94",
             "hb", "voltron", "bfloat16", ("extract", "extract_cli")),
            ("attn_pair_grid", "attn_pair_grid.cu", "tools/attn_kernel_experiment.py:31",
             "var", "voltron: pair-grid bB=16", "bfloat16", ("attn_variants",)),
            ("attn_pair_v3", "attn_pair_v3.cu", "tools/attn_kernel_round3.py:52", "var",
             "voltron: pair bB=16 +mxusum+exp2", "bfloat16", ("attn_variants",))):
        mine = [r for r in rows[kind] if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == shape and r["dtype"] == dtype)
        entry = kernel_entry(name, f"mdt_policy_tpu_torch/csrc/{source}", replaces,
                             sum(p[name] for p in paths.values()), mine, main)
        for key in ("unfused_ms", "host_us", "device_ms_cold", "bound_share_cold",
                    "pr7_device_ms", "pr7_device_ms_cold"):
            if key in main:
                entry[key] = main[key]
        entry["paths"] = list(own)
        for path, counts in paths.items():
            entry[f"launches_{path}"] = counts[name]
        if any(entry[f"launches_{path}"] == 0 for path in own):
            raise AssertionError(f"{name} was not launched on one of its paths: {entry}")
        entries.append(entry)
    return {"kernels": entries}


def _tree_device(root: str):
    """Imports the port from `root` (first on the path) for a `--*-tree`
    turn; (torch, device, card) or None without a CUDA device."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return None
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return torch, device, phase_device(torch)


def replan_tree(root: str) -> int:
    """`--replan-tree ROOT`: one tree's turn of `--replan-ab`, in this
    process."""
    found = _tree_device(root)
    if found is None:
        return 1
    torch, device, smi = found
    from mdt_policy_tpu_torch.agents import MDTVAgentNet, MDTVConfig, MDTVPolicy, init_random_
    build_s = phase_build()
    net = MDTVAgentNet(MDTVConfig(), device=device)
    init_random_(net, torch.Generator().manual_seed(0))
    # eager; a tree older than the graph flag has only the eager policy
    eager = {"cuda_graph": False} \
        if "cuda_graph" in inspect.signature(MDTVPolicy).parameters else {}
    replan, _, _ = replanner(torch, net, 1, device, **eager)
    times = event_times(torch, replan, REPLANS_TREE_AB)
    emit({"phase": "replan_tree", "root": root, "replans": len(times),
          "replan_ms_p50": float(np.percentile(times, 50)),
          "replan_ms_p90": float(np.percentile(times, 90)),
          "replan_ms_min": min(times), "replan_ms_max": max(times),
          **profile_calls(torch, replan, 5, host_top=15),
          "build_s": build_s, "torch": torch.__version__, "card": smi})
    return 0


def halfblock_tree(root: str) -> int:
    """`--halfblock-tree ROOT`: one tree's turn of `--halfblock-ab`: B4 and
    B5 at HALFBLOCK_SHAPES (event ms a call, and each device kernel's ms
    and launches a call from the profiler), F.linear at each of the call's
    GEMM shapes, and B1's device ms at its step shapes."""
    found = _tree_device(root)
    if found is None:
        return 1
    torch, device, smi = found
    from mdt_policy_tpu_torch.ops.attention_halfblock import attention_halfblock
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
    from mdt_policy_tpu_torch.ops.mlp_halfblock import mlp_halfblock
    phase_build()
    for kernel, tower, B, T, C, n in HALFBLOCK_SHAPES:
        tensors, kw = halfblock_inputs(torch, kernel, tower, B, T, C, n, device)
        fn = attention_halfblock if kernel == "b4" else mlp_halfblock
        emit({"phase": "halfblock_tree", "root": root, "kernel": fn.__name__,
              "shape": tower, "x": [B, T, C], "width": n,
              "ms": event_ms(lambda: fn(*tensors, **kw), 20, torch),
              "device_kernels": kernels_by_name(torch, lambda: fn(*tensors, **kw), 5),
              "linear_ms": {label: linear_ms(torch, B * T, w.shape[1], w.shape[0], device)
                            for label, _, w, _, _, _ in halfblock_parts(kernel, tensors, kw)
                            if label != "norm"},
              "card": smi})
    gen = torch.Generator(device).manual_seed(0)
    for name, B, T, C, H, causal in KERNEL_SHAPES:
        if name in ("voltron_train", "clip_vision_train"):
            qkv = torch.randn((B, T, 3 * C), generator=gen, device=device).bfloat16()
            emit({"phase": "halfblock_tree", "root": root, "kernel": "fused_qkv_attention",
                  "shape": name, "device_ms": device_ms(
                      lambda: fused_qkv_attention(qkv, H, causal),
                      "fused_qkv_attention_kernel", 10, torch), "card": smi})
    return 0


def variants_tree(root: str) -> int:
    """`--variants-tree ROOT`: one tree's turn of `--variants-ab`: each V1
    and V3 variant of the microbench tools and B1 at VARIANT_BATCHES' two
    shapes (event ms a call, device ms from the profiler), and B1's device
    ms at its step shapes."""
    found = _tree_device(root)
    if found is None:
        return 1
    torch, device, smi = found
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
    from mdt_policy_tpu_torch.tools import attn_kernel_experiment, attn_kernel_round3, perf_probe
    phase_build()
    names = {"pair_grid_attention": "attn_pair_grid", "pair_attention": "attn_pair_v3",
             "fused_qkv_attention": "fused_qkv_attention"}
    gen = torch.Generator(device).manual_seed(3)
    for case, shape, H in perf_probe.cases(*VARIANT_BATCHES):
        qkv = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        for tool in (attn_kernel_experiment, attn_kernel_round3):
            for v in tool.variants(H):
                kernel = names[v.fn.kernel.__name__]
                if kernel == "fused_qkv_attention" and tool is attn_kernel_round3:
                    continue  # B1 once a shape
                emit({"phase": "variants_tree", "root": root, "kernel": kernel,
                      "shape": f"{case}: {v.name}", "qkv": list(shape),
                      "ms": event_ms(lambda: v.fn(qkv), 20, torch),
                      "device_ms": device_ms(lambda: v.fn(qkv), f"{kernel}_kernel", 10, torch),
                      "card": smi})
    for name, B, T, C, H, causal in KERNEL_SHAPES:
        if name in ("voltron_train", "clip_vision_train"):
            qkv = torch.randn((B, T, 3 * C), generator=gen, device=device).bfloat16()
            emit({"phase": "variants_tree", "root": root, "kernel": "fused_qkv_attention",
                  "shape": name, "device_ms": device_ms(
                      lambda: fused_qkv_attention(qkv, H, causal),
                      "fused_qkv_attention_kernel", 10, torch), "card": smi})
    return 0


def trees_ab(flag: str, roots, value: str) -> int:
    """`--replan-ab`, `--halfblock-ab` or `--variants-ab ROOT...`: `--<flag>-tree` of each
    root in its own process, in the order given (the trees' packages share
    a name); each tree's lines, then a summary line: `value` (else
    `device_ms`) of each (kernel, shape) row, or of the replan row, by
    root."""
    rows = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               f"--{flag}-tree", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            if row.get("root") == root:
                emit(row)
                rows.append(row)
    summary = {}
    for row in rows:
        label = f"{row['kernel']}:{row['shape']}" if "kernel" in row else value
        summary.setdefault(row["root"], {}).setdefault(label, []).append(
            row.get(value, row.get("device_ms")))
    emit({"summary": summary})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 1:
        sys.exit(main())
    parser = argparse.ArgumentParser(description="the port's smoke run on one GPU; "
                                     "with --replan-ab, the replan of trees in turns")
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--replan-ab", nargs="+", metavar="ROOT",
                      help="time the MDT-V B=1 eager replan of each tree, in this order")
    mode.add_argument("--halfblock-ab", nargs="+", metavar="ROOT",
                      help="time B4, B5 and their device kernels of each tree, in this order")
    mode.add_argument("--variants-ab", nargs="+", metavar="ROOT",
                      help="time V1, V3 and B1 at the microbench's shapes of each tree, "
                           "in this order")
    mode.add_argument("--replan-tree", metavar="ROOT", help=argparse.SUPPRESS)
    mode.add_argument("--halfblock-tree", metavar="ROOT", help=argparse.SUPPRESS)
    mode.add_argument("--variants-tree", metavar="ROOT", help=argparse.SUPPRESS)
    mode.add_argument("--ddp-only", action="store_true",
                      help="the ddp phase alone (2 NCCL ranks of train() with two cards)")
    mode.add_argument("--ddp-child", action="store_true", help=argparse.SUPPRESS)
    mode.add_argument("--ddp-rank", nargs=4, metavar=("RANK", "WORLD", "PORT", "OUT"),
                      help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.ddp_only:
        sys.exit(ddp_only())
    if args.ddp_child:
        sys.exit(ddp_child())
    if args.ddp_rank:
        rank, world, port, out = args.ddp_rank
        sys.exit(ddp_rank(int(rank), int(world), int(port), out))
    if args.replan_ab:
        sys.exit(trees_ab("replan", args.replan_ab, "replan_ms_p50"))
    if args.halfblock_ab:
        sys.exit(trees_ab("halfblock", args.halfblock_ab, "ms"))
    if args.variants_ab:
        sys.exit(trees_ab("variants", args.variants_ab, "device_ms"))
    if args.replan_tree:
        sys.exit(replan_tree(args.replan_tree))
    sys.exit(halfblock_tree(args.halfblock_tree) if args.halfblock_tree
             else variants_tree(args.variants_tree))
